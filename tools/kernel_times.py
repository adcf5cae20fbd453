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
where the checkout's config has it. K1, K2 and K5 are also timed alone on
tables packed once (``render_tables_kernel``, ``render_grads_tables``),
K2 both ways also on the default scene textured with the goldens' noise as
``bar.png`` in Bilinear. Last, the 1920x1080 training step of
``chip_smoke.training_step`` (render, MSE, the gradient of every float
leaf): by CUDA events; by the host's clock around enqueueing the same 10
steps (``host``); and from a ``torch.profiler`` trace of the card alone
over 10 steps, ``busy`` (the union of its kernels, copies and sets) and
``span`` (the first one's start to the last one's end), each per step, and
the card's ``idle share`` 1 - busy / span.

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


def cap_times(torch, kb, build, scene, cfg, g) -> dict:
    """K2 alone at each of ``kb.SITE_CAPS`` on ``scene`` under ``cfg``
    (whatever the config's own cap): the device memory each cap's first
    launch takes outside the caching allocator (MiB), the largest difference
    of its cotangent from the smallest cap's relative to the latter's
    largest entry (per table), and its time in turns up and down."""
    lib = build.load_cuda_library("trace_bwd")
    tables = tuple(t.detach() for t in kb.pack_scene(scene))
    args = kb.launch_args(cfg, None, tables[0].device)
    at = len(kb.kernel_args(cfg))  # the record cap's place in the arguments

    def launch(cap):
        return kb.launch_grads(lib, lib.rt_trace_bwd, tables, cfg,
                               args[:at] + [cap] + args[at + 1:], g, True)

    out, first = {}, None
    for cap in kb.SITE_CAPS:
        torch.cuda.synchronize()
        free, held = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        grads = launch(cap)[0]
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


def device_busy(torch, fn, reps=10):
    """The card's busy time and span per call of ``fn`` over ``reps`` calls
    after 3 warm-ups, in ms, from a ``torch.profiler`` trace of the card
    alone: busy is the union of its kernels, copies and sets, the span runs
    from the first one's start to the last one's end. (0, 0) where the
    trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, spans[0][0]
    for a, b in spans:  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / reps, (end - spans[0][0]) / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--out", help="a JSON-lines file to append the line to")
    ap.add_argument("--caps", action="store_true",
                    help="first time K2 at each record cap, with the device memory it takes")
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    _build.prebuild(["trace_fwd", "march_fwd", "trace_bwd", "march_bwd", "trace_retrace"])
    scene = rtt.default_scene(device="cuda")[0]
    with tempfile.TemporaryDirectory() as tex_dir:
        save_png(os.path.join(tex_dir, "bar.png"), np.random.default_rng(101).integers(
            0, 256, (256, 256, 3)).astype(np.uint8))
        textured = rtt.default_scene(texture_dir=tex_dir, texture_filter=1, device="cuda")[0]
    # checkouts up to 945f329 call the re-trace kernel on packed tables ``_launch``
    k5_alone = getattr(kr, "render_grads_tables", None) or kr._launch
    cfg = rtt.RenderConfig(xres=1920, yres=1080)
    mcfg = rtt.RenderConfig(xres=1280, yres=720, use_raymarching=True, glow_effect=1.0)
    rng = np.random.default_rng(0)

    def planes(c):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((c.yres, c.xres))
                                            .astype(np.float32)).cuda() for _ in range(3)))

    def ms(fn):
        return chip_smoke.cuda_ms(torch, fn)

    g, gm = planes(cfg), planes(mcfg)
    times = cap_times(torch, kb, _build, scene, cfg, g) if args.caps else {}
    march = [("", mcfg)]
    if hasattr(mcfg, "march_floor_skip"):
        march.append((" floor tail off", mcfg.with_(march_floor_skip=False)))
    with torch.no_grad():
        times["K1 1920x1080"] = ms(lambda: kt.render_color_kernel(scene, cfg))
        tables = tuple(t.detach() for t in kt.pack_scene(scene))
        times["K1 alone 1920x1080"] = ms(lambda: kt.render_tables_kernel(tables, cfg))
        for tag, c in march:
            times[f"K3 1280x720{tag}"] = ms(lambda c=c: km.render_color_kernel(scene, c))
    for tag, s in (("", scene), (" Bilinear", textured)):
        tables, tex = tuple(t.detach() for t in kt.pack_scene(s)), kt.pack_textures(s)
        times[f"K2 1920x1080{tag}"] = ms(lambda s=s: kb.render_grads_kernel(s, cfg, g,
                                                                            return_primal=True))
        times[f"K2 alone 1920x1080{tag}"] = ms(
            lambda tables=tables, tex=tex: kb.render_grads_tables(tables, tex, cfg, g, True))
    times["K5 1920x1080"] = ms(lambda: kr.render_grads_retrace(scene, cfg, g, return_primal=True))
    tables = tuple(t.detach() for t in kt.pack_scene(scene))
    times["K5 alone 1920x1080"] = ms(lambda: k5_alone(tables, cfg, g, True))
    for tag, c in march:
        times[f"K4 1280x720{tag}"] = ms(lambda c=c: kmb.render_grads_kernel(scene, c, gm,
                                                                            return_primal=True))
    step = chip_smoke.training_step(torch, rtt.render_color, cfg, scene)
    times["step 1920x1080"] = ms(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    times["step 1920x1080 host"] = (time.perf_counter() - t0) * 100.0  # ms per step
    torch.cuda.synchronize()
    busy, span = device_busy(torch, step)
    if span:
        times["step 1920x1080 busy"], times["step 1920x1080 span"] = busy, span
        times["step 1920x1080 idle share"] = 1.0 - busy / span
    line = json.dumps({"label": args.label, "card": card, "ms": times})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
