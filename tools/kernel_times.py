#!/usr/bin/env python3
"""Time the port's kernels in the checkout this is run from, to compare two
checkouts on one card.

    cd <checkout> && python3 <path>/tools/kernel_times.py [--label NAME] [--out FILE] [--caps]

It imports ``ray_rust_tpu_torch`` from the working directory, not from
beside this script, so one copy times any checkout of the port, older ones
too; it times with ``chip_smoke.cuda_ms`` from beside this script's folder
(CUDA events, 3 warm-ups, 10 calls each). On the default scene it times
the trace kernel (K1) per 1920x1080 frame, the trace backward (K2) and the
re-trace oracle (K5) per 1920x1080 cotangent, and the march kernel (K3)
and the march backward (K4) at 1280x720 with glow 1.0, through their
public wrappers; both march kernels also with ``march_floor_skip`` off
where the checkout's config has it, and both on the default scene with
the goldens' noise as ``bar.png`` in Nearest and in Bilinear, with the
textured march step (Bilinear): a checkout whose march kernel names
textures in its refusal records ``"refused: <reason>"`` for them. K1, K2
and K5 are also timed alone on what their wrappers pack, packed once: the
pack kernel's words (``render_words_kernel``, ``launch_words``), or on a
checkout without the pack kernel the tables of ``pack_scene`` (``render_tables_kernel``,
``render_grads_tables``); K2 both ways also on the default scene textured
with the goldens' noise as ``bar.png`` in Bilinear. K1 is also timed as
``K1 launches 1920x1080``: 50 launches of its C launcher back to back on
prepared arguments, per launch, where the wrapper's Python (~0.08 ms a
call) no longer paces a frame that takes as long (checkouts with the pack
kernel). Last, the 1920x1080 training step of
``chip_smoke.training_step`` (render, MSE, the gradient of every float
leaf): by CUDA events; by the host's clock around enqueueing the same 10
steps (``host``); and from a ``torch.profiler`` trace of the card alone
over 10 steps, ``busy`` (the union of its kernels, copies and sets) and
``span`` (the first one's start to the last one's end), each per step, and
the card's ``idle share`` 1 - busy / span; under ``counts`` the same
trace's kernels, copies and sets a step, and of them the pack kernel's and
the pull-back's launches. Also the textured frame (K1
through its wrapper on the default scene with ``bar.png`` in Nearest) and
the packing (``pack_times``: what K1's wrapper packs, the plain packs and
the pull-back of a backward block to the leaves), by CUDA events and by
the host's clock around 100 enqueued calls.

``--march`` times the march kernels alone (``march_times``): K3 and K4 at
1280x720, and K4 alone in turns with its buffer instance forced on that
config; its line also gives the first 16 hex digits of the SHA-256 of K3's
image and of K4's image (``sha256``), so two checkouts' images compare bit
for bit.

``--caps`` first times K2 alone at 1920x1080 at each record cap it is built
for (``SITE_CAPS``, in turns up and down), before any other launch, with
the device memory each cap's first launch takes outside the caching
allocator (the local memory CUDA reserves for the threads' stacks) and the
largest difference of each cap's cotangent from the smallest cap's, over
the largest entry of the smallest cap's (per table).

Prints one JSON line with the card's name and power limit, and appends it
to ``--out`` if given. Run two checkouts in turns (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the timing loop and the training step of chip_smoke.py beside this
# script's folder
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def cap_times(torch, kb, kp, build, scene, cfg, g) -> dict:
    """K2 alone at each of ``kb.SITE_CAPS`` on ``scene`` under ``cfg``
    (whatever the config's own cap): the device memory each cap's first
    launch takes outside the caching allocator (MiB), the largest difference
    of its cotangent from the smallest cap's relative to the latter's
    largest entry (per table), and its time in turns up and down. Needs a
    checkout with the pack kernel."""
    lib = build.load_cuda_library("trace_bwd")
    n = scene.objects.count
    words = kp.launch_pack(scene)
    ptrs, meta = kp.word_pointers(words, n)
    tex = kp.texture_pointers(scene, meta)

    def launch(cap):
        block, _ = kb.launch_block(lib, lib.rt_trace_bwd, ptrs, n, words.device, cfg,
                                   kb.kernel_args(cfg) + [cap] + tex, g, True)
        return kb.split_block(block, n)

    out, first = {}, None
    for cap in kb.SITE_CAPS:
        torch.cuda.synchronize()
        free, held = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        grads = launch(cap)
        torch.cuda.synchronize()
        taken = free - torch.cuda.mem_get_info()[0] - (torch.cuda.memory_reserved() - held)
        out[f"K2 cap {cap} first launch MiB"] = taken / 2**20
        first = first or grads
        out[f"K2 cap {cap} max rel diff"] = max(float((a - b).abs().max() / b.abs().max())
                                                for a, b in zip(grads, first))
    for k, cap in enumerate(kb.SITE_CAPS + kb.SITE_CAPS[::-1]):
        out[f"K2 cap {cap} alone 1920x1080 turn {k}"] = chip_smoke.cuda_ms(
            torch, lambda cap=cap: launch(cap))
    return out


def k1_launches(torch, kt, kp, build, scene, cfg, reps=50) -> float:
    """K1's C launcher called ``reps`` times back to back on the pack
    kernel's words of ``scene``, by CUDA events: ms a launch."""
    from ray_rust_tpu_torch.ops.rays import fov_scales

    n = scene.objects.count
    words = kp.launch_pack(scene)
    ptrs, meta = kp.word_pointers(words, n)
    lib = build.load_cuda_library(kt.library("trace_fwd", n, kt.SHARED_TABLE_MAX))
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=words.device)
    plane = 4 * cfg.xres * cfg.yres
    args = (*ptrs, n, cfg.xres, cfg.yres, *kt.window(cfg), *fov_scales(cfg),
            *kt.kernel_args(cfg), *kp.texture_pointers(scene, meta), int(kt.cull_on(cfg, n)),
            out.data_ptr(), out.data_ptr() + plane, out.data_ptr() + 2 * plane,
            words.device.index, torch.cuda.current_stream(words.device).cuda_stream)

    def launches():
        for _ in range(reps):
            lib.rt_trace_fwd(*args)

    return chip_smoke.cuda_ms(torch, launches) / reps


def pack_times(torch, kt, kb, kp, scene, textured, ms) -> dict:
    """The packing around K1's launch, untextured and textured (Nearest),
    by CUDA events and by the host's clock: what the checkout's K1 wrapper
    packs (``kernel_pack.launch_pack`` and the cached atlas's arguments
    where the checkout has the pack kernel, else ``pack_scene`` and
    ``pack_textures``), ``pack_scene`` and
    ``pack_textures`` alone (the plain packs), and the pull-back of a
    backward kernel's block to the scene's float leaves
    (``kernel_pack.pack_scene_vjp``, else autograd of ``pack_scene``);
    ``kp`` is the checkout's ``kernel_pack``, or None."""
    n = scene.objects.count
    block = torch.randn((n + 1, kb.GRAD_COLS), device=scene.device)
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    wrt = [t for t in leaves if t.requires_grad]

    if kp is not None:
        def wrapper_pack(s):
            words = kp.launch_pack(s)
            return kp.texture_pointers(s, kp.word_pointers(words, s.objects.count)[1])

        def pull_back():
            return kp.pack_scene_vjp(scene, block)
    else:
        def wrapper_pack(s):
            return kt.pack_scene(s), kt.pack_textures(s)

        def pull_back():
            f32t, _, cam, light = kt.pack_scene(scene.with_tensors(leaves))
            return torch.autograd.grad((f32t, cam, light), wrt, kb.split_block(block, n),
                                       allow_unused=True)

    out = {}
    fns = {"packing": lambda: wrapper_pack(scene),
           "packing textured": lambda: wrapper_pack(textured),
           "pack_scene": lambda: kt.pack_scene(scene),
           "pack_textures": lambda: kt.pack_textures(textured),
           "pull-back": pull_back}
    for name, fn in fns.items():
        out[name] = ms(fn)
        out[f"{name} host"] = chip_smoke.host_ms(torch, fn)
    return out


def emit(args, line: str) -> None:
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


def march_times(torch, rtt, _build, km, kmb, kp, kb, kt, args, card) -> int:
    """``--march``: K3 and K4 (with the image) at 1280x720 with glow 1.0 on
    the default scene through their wrappers, and K4 alone on packed words
    in turns with its buffer instance forced on the same config (local,
    buffer, buffer, local; checkouts with ``march_bwd_buf``)."""
    _build.prebuild(["march_fwd", "march_bwd", "march_bwd_buf", "pack_scene"])
    scene = rtt.default_scene(device="cuda")[0]
    mcfg = rtt.RenderConfig(xres=1280, yres=720, use_raymarching=True, glow_effect=1.0)
    g = rtt.Color(*(torch.from_numpy(np.random.default_rng(0).standard_normal((720, 1280))
                                     .astype(np.float32)).cuda() for _ in range(3)))
    words = kp.launch_pack(scene)
    n = scene.objects.count
    ptrs, meta = kp.word_pointers(words, n)
    lib = _build.load_cuda_library("march_bwd_buf")
    cap = kmb.count_sites(mcfg)
    fns = {"K4 alone": lambda: kmb.launch_words(scene, words, mcfg, g, True),
           "K4 buffer forced": lambda: kb.launch_buffered(
               lib, lib.rt_march_bwd_buf, ptrs, n, torch.device("cuda", 0), mcfg,
               kmb.kernel_args(mcfg) + kp.texture_pointers(scene, meta), g, True,
               cap_words=kmb.RECORD_WORDS * cap, extra=(cap,))}
    times = {}
    with torch.no_grad():
        image = torch.stack(list(km.render_color_kernel(scene, mcfg)))
        prim = torch.stack(list(kmb.render_grads_kernel(scene, mcfg, g, return_primal=True)[1]))
        times["K3 1280x720"] = chip_smoke.cuda_ms(torch, lambda: km.render_color_kernel(scene,
                                                                                     mcfg))
    times["K4 1280x720"] = chip_smoke.cuda_ms(torch, lambda: kmb.render_grads_kernel(
        scene, mcfg, g, return_primal=True))
    for k in ("K4 alone", "K4 buffer forced", "K4 buffer forced", "K4 alone"):
        times.setdefault(k, []).append(chip_smoke.cuda_ms(torch, fns[k]))
    digests = {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
               for k, t in (("K3 image", image), ("K4 image", prim))}
    emit(args, json.dumps({"label": args.label, "card": card, "ms": times,
                           "sha256": digests}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--out", help="a JSON-lines file to append the line to")
    ap.add_argument("--caps", action="store_true",
                    help="first time K2 at each record cap, with the device memory it takes")
    ap.add_argument("--march", action="store_true",
                    help="time only the march kernels: K3 and K4 at 1280x720 and K4's buffer "
                         "instance forced on that config, in turns with K4")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
    from ray_rust_tpu_torch.utils.image import save_png

    try:
        from ray_rust_tpu_torch.ops import kernel_pack as kp
    except ImportError:  # checkouts up to 45346a9 have no pack kernel
        kp = None

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    if args.march:
        return march_times(torch, rtt, _build, km, kmb, kp, kb, kt, args, card)
    # checkouts up to 45346a9 have no pack kernel
    _build.prebuild([s for s in ("trace_fwd", "march_fwd", "trace_bwd", "march_bwd",
                                 "trace_retrace", "pack_scene") if s in _build._CUDA_FNS])
    scene = rtt.default_scene(device="cuda")[0]
    with tempfile.TemporaryDirectory() as tex_dir:
        save_png(os.path.join(tex_dir, "bar.png"), np.random.default_rng(101).integers(
            0, 256, (256, 256, 3)).astype(np.uint8))
        textured = rtt.default_scene(texture_dir=tex_dir, texture_filter=1, device="cuda")[0]
        textured_n = rtt.default_scene(texture_dir=tex_dir, device="cuda")[0]
    cfg = rtt.RenderConfig(xres=1920, yres=1080)
    mcfg = rtt.RenderConfig(xres=1280, yres=720, use_raymarching=True, glow_effect=1.0)
    rng = np.random.default_rng(0)

    def planes(c):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((c.yres, c.xres))
                                            .astype(np.float32)).cuda() for _ in range(3)))

    def ms(fn):
        return chip_smoke.cuda_ms(torch, fn)

    g, gm = planes(cfg), planes(mcfg)

    if kp is not None:
        def alone(s):
            """K1, K2 and K5 on the pack kernel's words of ``s``, packed once."""
            words = kp.launch_pack(s)
            return (lambda: kt.render_words_kernel(s, words, cfg),
                    lambda: kb.launch_words(s, words, cfg, g, True),
                    lambda: kr.launch_words(s, words, cfg, g, True))
    else:
        # checkouts up to 945f329 call the re-trace kernel on packed tables ``_launch``
        k5_tables = getattr(kr, "render_grads_tables", None) or kr._launch

        def alone(s):
            """K1, K2 and K5 on the tables of ``pack_scene``, packed once."""
            tables, tex = tuple(t.detach() for t in kt.pack_scene(s)), kt.pack_textures(s)
            return (lambda: kt.render_tables_kernel(tables, cfg, tex),
                    lambda: kb.render_grads_tables(tables, tex, cfg, g, True),
                    lambda: k5_tables(tables, cfg, g, True))

    times = cap_times(torch, kb, kp, _build, scene, cfg, g) if args.caps else {}
    march = [("", mcfg)]
    if hasattr(mcfg, "march_floor_skip"):
        march.append((" floor tail off", mcfg.with_(march_floor_skip=False)))
    with torch.no_grad():
        times["K1 1920x1080"] = ms(lambda: kt.render_color_kernel(scene, cfg))
        times["K1 alone 1920x1080"] = ms(alone(scene)[0])
        if kp is not None:
            times["K1 launches 1920x1080"] = k1_launches(torch, kt, kp, _build, scene, cfg)
        for tag, c in march:
            times[f"K3 1280x720{tag}"] = ms(lambda c=c: km.render_color_kernel(scene, c))
    for tag, s in (("", scene), (" Bilinear", textured)):
        times[f"K2 1920x1080{tag}"] = ms(lambda s=s: kb.render_grads_kernel(s, cfg, g,
                                                                            return_primal=True))
        times[f"K2 alone 1920x1080{tag}"] = ms(alone(s)[1])
    times["K5 1920x1080"] = ms(lambda: kr.render_grads_retrace(scene, cfg, g, return_primal=True))
    times["K5 alone 1920x1080"] = ms(alone(scene)[2])
    for tag, c in march:
        times[f"K4 1280x720{tag}"] = ms(lambda c=c: kmb.render_grads_kernel(scene, c, gm,
                                                                            return_primal=True))
    def refused_or_ms(s, fn):
        """``fn``'s time, or the reason of a checkout whose march kernel
        refuses textures for ``s``; any other failure propagates."""
        reason = km.unsupported_reason(s, mcfg)
        if reason is not None and "textur" in reason:
            return f"refused: {reason}"
        return ms(fn)

    for tag, s in ((" Nearest", textured_n), (" Bilinear", textured)):
        with torch.no_grad():
            times[f"K3 1280x720{tag}"] = refused_or_ms(
                s, lambda s=s: km.render_color_kernel(s, mcfg))
        times[f"K4 1280x720{tag}"] = refused_or_ms(
            s, lambda s=s: kmb.render_grads_kernel(s, mcfg, gm, return_primal=True))
    times["march step 1280x720 Bilinear"] = refused_or_ms(
        textured, chip_smoke.training_step(torch, rtt.render_color, mcfg, textured))
    times.update(pack_times(torch, kt, kb, kp, scene, textured_n, ms))
    with torch.no_grad():
        times["K1 1920x1080 Nearest"] = ms(lambda: kt.render_color_kernel(textured_n, cfg))
    step = chip_smoke.training_step(torch, rtt.render_color, cfg, scene)
    times["step 1920x1080"] = ms(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    times["step 1920x1080 host"] = (time.perf_counter() - t0) * 100.0  # ms per step
    torch.cuda.synchronize()
    busy, span, names = chip_smoke.device_busy(torch, step)
    if span:
        times["step 1920x1080 busy"], times["step 1920x1080 span"] = busy, span
        times["step 1920x1080 idle share"] = 1.0 - busy / span
    # the step's kernels, copies and sets from the same trace, a step
    counts = {"step 1920x1080 launches": sum(names.values()),
              "step 1920x1080 pack launches": sum(
                  c for k, c in names.items() if "pack_scene_kernel(" in k),
              "step 1920x1080 pull-back launches": sum(
                  c for k, c in names.items() if "pack_scene_vjp_kernel(" in k)}
    emit(args, json.dumps({"label": args.label, "card": card, "ms": times, "counts": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
