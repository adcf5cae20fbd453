#!/usr/bin/env python3
"""How much the march's closed-form floor tail moves the march backward's
cotangents, on the CPU through the host builds of K3 and K4.

    python3 tools/tail_grad_probe.py [--size W H]

On the default scene, untextured and with the goldens' 256x256 noise as
``bar.png`` in Nearest, with glow 1.0 and without glow (``march_max_iter``
2000), it renders with the tail on and off, keeps the pixels where the two
images agree within 1e-4, pulls one cotangent (numpy seed 0) back through
K4's host build with the tail on and off, and prints per case the leaf
whose cotangents differ most (relative L2 against the tail-off one) and,
for ``camera.rotation.z``, the L2 of the difference and of the tail-off
cotangent. Needs g++; builds into a temporary directory.
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
                      sx, sy, *km.launch_args(cfg, tex, CPU), *(p.data_ptr() for p in out), None)
    return out.permute(1, 2, 0).numpy()


def leaf_grads(lib, scene, cfg, g):
    """K4's host build: the cotangent of each scene leaf."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    n = scene.objects.count
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.empty((3, cfg.yres, cfg.xres))
    sx, sy = fov_scales(cfg)
    lib.rt_march_bwd_host(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, sx, sy,
                          *kmb.launch_args(cfg, tex, CPU), *(c.data_ptr() for c in g),
                          block.data_ptr(), *(p.data_ptr() for p in prim), None)
    return {k: v.numpy() for k, v in kb.leaf_grads(scene, kb.split_block(block, n)).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=(160, 120), metavar=("W", "H"))
    args = ap.parse_args()
    w, h = args.size
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
