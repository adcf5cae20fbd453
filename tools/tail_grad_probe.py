#!/usr/bin/env python3
"""How much the march's closed-form floor tail moves the march backward's
cotangents, on the CPU through the host builds of K3 and K4; and, with
``--objects``, where K4 leaves autograd of the plain march on a many-object
scene.

    python3 tools/tail_grad_probe.py [--size W H]
    python3 tools/tail_grad_probe.py --objects N [--size W H] [--steps S] [--bands B]

On the default scene, untextured and with the goldens' 256x256 noise as
``bar.png`` in Nearest, with glow 1.0 and without glow (``march_max_iter``
2000), it renders with the tail on and off, keeps the pixels where the two
images agree within 1e-4, pulls one cotangent (numpy seed 0) back through
K4's host build with the tail on and off, and prints per case the leaf
whose cotangents differ most (relative L2 against the tail-off one) and,
for ``camera.rotation.z``, the L2 of the difference and of the tail-off
cotangent. Needs g++; builds into a temporary directory.

With ``--objects N`` (needs a card): on ``chip_smoke.spheres_scene``'s
seeded field of a floor and N - 1 spheres (seed 11, the first material
glowing) with glow 1.0 and ``march_max_iter`` S (default 2000), as
chip_smoke.py's 1 024-object check: the cotangent planes (numpy seed 0)
zeroed where the march kernel's image leaves the plain march's by more than
1e-4, then K4's cotangents held per scene leaf against one call of
autograd of the plain march on the card (relative L2 with chip_smoke's
norm floor 1e-2): its host build on the CPU with the tail on and off, and
on the card the build its wrapper launches and its shared-table build.
With ``--bands B`` > 0, the image's rows cut into B bands, each band's
share of the worst leaf's cotangent from the host build (tail on) and
from autograd of the plain march (one call a band).
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_rust_tpu_torch as rtt  # noqa: E402
from ray_rust_tpu_torch.ops import _build  # noqa: E402
from ray_rust_tpu_torch.ops import kernel_march as km  # noqa: E402
from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb  # noqa: E402
from ray_rust_tpu_torch.ops import kernel_pack as kp  # noqa: E402
from ray_rust_tpu_torch.ops import kernel_trace as kt  # noqa: E402
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb  # noqa: E402
from ray_rust_tpu_torch.ops.rays import fov_scales  # noqa: E402
from ray_rust_tpu_torch.utils.image import save_png  # noqa: E402

CPU = torch.device("cpu")
LEAF = "camera.rotation.z"


def render(lib, scene, cfg):
    """K3's host build: the image, (H, W, 3)."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    out = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_host(*(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
                      *kt.window(cfg), sx, sy, *km.launch_args(cfg, tex, CPU),
                      *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def leaf_grads(lib, scene, cfg, g):
    """K4's host build: the cotangent of each scene leaf."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    n = scene.objects.count
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres,
                          *kt.window(cfg), sx, sy,
                          *kmb.launch_args(cfg, tex, CPU), *(c.data_ptr() for c in g),
                          block.data_ptr(), *(p.data_ptr() for p in prim), None)
    return {k: v.numpy() for k, v in kb.leaf_grads(scene, kb.split_block(block, n)).items()}


def rel_l2(a, b):
    """chip_smoke.leaf_err's relative L2: norm floor 1e-2."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2))


def many_objects(n_objects, w, h, steps, bands) -> None:
    """The ``--objects`` probe (see the module's docstring)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    dev = torch.device("cuda", 0)
    scene = chip_smoke.spheres_scene(rtt, 11, n_objects - 1, glow_dist=3.0).to(dev)
    host_scene = scene.to(CPU)
    cfg = rtt.RenderConfig(xres=w, yres=h, use_raymarching=True, glow_effect=1.0,
                           march_max_iter=steps)
    n = scene.objects.count
    img = chip_smoke.img
    agree = np.abs(img(km.render_color_kernel(scene, cfg))
                   - img(km.render_color_plain(scene, cfg))).max(-1) < 1e-4
    rng = np.random.default_rng(0)
    planes = [rng.standard_normal((h, w)).astype(np.float32) * agree for _ in range(3)]

    def card(p):
        return rtt.Color(*(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in p))

    def plain(p):
        grads = kmb.render_grads_plain(scene, cfg, card(p))
        return {k: v.detach().cpu().numpy() for k, v in kb.leaf_grads(scene, grads).items()}

    def on_card(grads):
        return {k: v.detach().cpu().numpy() for k, v in kb.leaf_grads(scene, grads).items()}

    with tempfile.TemporaryDirectory() as td:
        march_bwd = _build.build_host_library(td, "march_bwd")
        want = plain(planes)
        staged_lib = _build.load_cuda_library("march_bwd")
        words = kp.launch_pack(scene)
        ptrs, meta = kp.word_pointers(words, n)
        block, _ = kb.launch_block(staged_lib, staged_lib.rt_march_bwd, ptrs, n, dev, cfg,
                                   kmb.kernel_args(cfg) + kp.texture_pointers(scene, meta),
                                   card(planes), False)
        got = {"host build, tail on": leaf_grads(march_bwd, host_scene, cfg,
                                                 rtt.Color(*map(torch.from_numpy, planes))),
               "host build, tail off": leaf_grads(march_bwd, host_scene,
                                                  cfg.with_(march_floor_skip=False),
                                                  rtt.Color(*map(torch.from_numpy, planes))),
               "card, the wrapper's build": on_card(kmb.render_grads_kernel(scene, cfg,
                                                                            card(planes))),
               "card, tables staged": on_card(kb.split_block(block, n))}
        print(f"{n} objects {w}x{h} march_max_iter={steps}: {int((~agree).sum())} pixels masked")
        worst_leaf = None
        for name, g in got.items():
            rel = {k: rel_l2(g[k], want[k]) for k in want if "pattern_scale" not in k}
            worst = max(rel, key=rel.get)
            worst_leaf = worst_leaf or worst
            print(f"  {name}: largest relative L2 {rel[worst]:.4g} ({worst}); "
                  f"{worst_leaf} {rel[worst_leaf]:.4g}", flush=True)
        for b in range(bands):
            r0, r1 = b * h // bands, (b + 1) * h // bands
            rows = np.zeros((h, 1), np.float32)
            rows[r0:r1] = 1.0
            part = [c * rows for c in planes]
            k = leaf_grads(march_bwd, host_scene, cfg, rtt.Color(*map(torch.from_numpy, part)))
            p = plain(part)
            print(f"  rows {r0}-{r1 - 1}: {worst_leaf} host build {k[worst_leaf].ravel()[:2]}, "
                  f"plain {p[worst_leaf].ravel()[:2]}, |difference| "
                  f"{np.linalg.norm(k[worst_leaf] - p[worst_leaf]):.4g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=(160, 120), metavar=("W", "H"))
    ap.add_argument("--objects", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--bands", type=int, default=0)
    args = ap.parse_args()
    w, h = args.size
    if args.objects:
        many_objects(args.objects, w, h, args.steps, args.bands)
        return 0
    with tempfile.TemporaryDirectory() as td:
        save_png(os.path.join(td, "bar.png"),
                 np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8))
        march = _build.build_host_library(os.path.join(td, "march"), "march")
        march_bwd = _build.build_host_library(os.path.join(td, "march_bwd"), "march_bwd")
        scenes = {"untextured": rtt.default_scene(device="cpu")[0],
                  "Nearest": rtt.default_scene(texture_dir=td, texture_filter=0, device="cpu")[0]}
    rng = np.random.default_rng(0)
    planes = [rng.standard_normal((h, w)).astype(np.float32) for _ in range(3)]
    for glow in (1.0, 0.0):
        cfg = rtt.RenderConfig(xres=w, yres=h, use_raymarching=True, glow_effect=glow,
                               march_max_iter=2000)
        off_cfg = cfg.with_(march_floor_skip=False)
        for name, scene in scenes.items():
            agree = np.abs(render(march, scene, cfg) - render(march, scene, off_cfg)).max(-1) < 1e-4
            g = rtt.Color(*(torch.from_numpy(p * agree) for p in planes))
            on, off = leaf_grads(march_bwd, scene, cfg, g), leaf_grads(march_bwd, scene, off_cfg, g)
            rel = {k: np.linalg.norm(on[k] - off[k]) / max(np.linalg.norm(off[k]), 1e-30)
                   for k in off}
            worst = max(rel, key=rel.get)
            print(f"glow {glow} {name} {w}x{h}: {int((~agree).sum())} pixels masked; largest "
                  f"relative L2 {rel[worst]:.3g} ({worst}); {LEAF}: |on - off| "
                  f"{np.linalg.norm(on[LEAF] - off[LEAF]):.4g}, |off| "
                  f"{np.linalg.norm(off[LEAF]):.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
