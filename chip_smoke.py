#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_rust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the build of the CUDA trace kernel from ray_rust_tpu_torch/csrc;
3. the kernel against its plain PyTorch version on the card, and against the
   full-depth golden image, each within the JAX package's golden budget:
   at most 2% of pixels off by more than 1e-3, mean difference at most 0.01;
4. the main path: the CLI renders the default scene at 1920x1080 to a PNG,
   then ``render_u8`` renders three camera poses, as three viewer requests;
   the kernel's launch count must rise by one per render;
5. times of the 1920x1080 forward, kernel and plain version in turns, with
   CUDA events (3 warm-ups, 10 timed renders each).

The last two lines are JSON: the kernel table, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGET = dict(frac=0.02, mean=0.01, tol=1e-3)  # tests/test_parity.py:152-161
W, H = 1920, 1080


def compare(name, ref, got):
    """Hold ``got`` against ``ref`` ((H, W, 3) arrays) within BUDGET."""
    diff = np.abs(got - ref)
    frac = float((diff.max(-1) > BUDGET["tol"]).mean())
    mean, mx = float(diff.mean()), float(diff.max())
    ok = np.isfinite(got).all() and frac <= BUDGET["frac"] and mean <= BUDGET["mean"]
    print(f"  {name}: {frac:.4%} pixels > {BUDGET['tol']}, mean {mean:.3g}, "
          f"max {mx:.3g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside the budget {BUDGET}")
    return mx


def img(col):
    return np.stack([c.detach().cpu().numpy() for c in col], -1)


def spheres_scene(rtt, seed, n_spheres):
    """tests/test_parity.py:75-102's seeded sphere field (seed 7, 39
    spheres + floor), or another seed and count."""
    rng = np.random.default_rng(seed)
    mats = [
        rtt.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3), pn=8),
        rtt.MaterialSpec(name="m1", diffuse=(0.1, 0.5, 0.9), specular=(0.0, 0.0, 0.0), pn=0),
    ]
    objs = [rtt.FloorSpec("m0", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0))]
    for _ in range(n_spheres):
        c = rng.uniform(-300, 300, 3)
        c[2] = rng.uniform(100, 600)
        r = rng.uniform(10, 50)
        m = int(rng.integers(0, 2))
        objs.append(rtt.SphereSpec(f"m{m}", float(r), tuple(float(v) for v in c)))
    scene, _ = rtt.build_scene(mats, objs, (0.0, 0.0, -400.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0))
    return scene


def cuda_ms(torch, fn, warm=3, reps=10):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch import cli
    from ray_rust_tpu_torch.models.scene import Camera
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.utils.image import load_png

    # 2. the build
    t0 = time.time()
    _build.load_trace_library()
    print(f"build: trace_fwd.cu with nvcc in {time.time() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("  " + line.strip())

    dev = torch.device("cuda", 0)

    def both(scene, cfg):
        scene = scene.to(dev)
        got = img(kt.render_color_kernel(scene, cfg))
        torch.cuda.synchronize()
        return got, img(kt.render_color_plain(scene, cfg))

    # 3. kernel vs plain on the card, and vs the golden
    print("kernel vs plain version:")
    default, _ = rtt.default_scene()
    cases = [
        ("default 320x240", default, rtt.RenderConfig(xres=320, yres=240)),
        ("default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)),
        ("40 objects 320x240", spheres_scene(rtt, 7, 39),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1)),
        ("101 objects 160x120", spheres_scene(rtt, 11, 100),
         rtt.RenderConfig(xres=160, yres=120)),
    ]
    for name, scene, cfg in cases:
        got, ref = both(scene, cfg)
        compare(name, ref, got)
    golden = np.load(os.path.join(HERE, "tests", "goldens", "default_trace_320x240.npz"))["img"]
    got = img(kt.render_color_kernel(default.to(dev),
                                     rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)))
    compare("kernel vs golden default_trace_320x240", golden, got)
    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    got, ref = both(default, cfg_main)
    max_abs_err = compare(f"default {W}x{H} (the main path's shape)", ref, got)

    # 4. the main path
    poses = [((0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2)),
             ((120.0, -120.0, -320.0), (0.0, -np.pi / 2 + 0.2, -np.pi / 2)),
             ((-80.0, -60.0, -280.0), (-0.15, -np.pi / 2 - 0.1, -np.pi / 2))]
    scene_dev = default.to(dev)
    # each request's camera is built on the host, as the viewer parses it
    views = [default._replace(camera=Camera.from_pyr(rtt.v3(*p), rtt.v3(*a))).to(dev)
             for p, a in poses]
    with tempfile.TemporaryDirectory() as td:
        png_path = os.path.join(td, "out.png")
        kt.LAUNCHES = 0
        t0 = time.time()
        if cli.main([str(W), str(H), "-o", png_path]) != 0:
            raise SystemExit("chip_smoke: the CLI failed")
        frames = [rtt.render_u8(v, cfg_main) for v in views]
        torch.cuda.synchronize()
        main_s = time.time() - t0
        launches = kt.LAUNCHES
        png = load_png(png_path)
    print(f"main path: CLI {W}x{H} + 3 render_u8 in {main_s:.2f} s, "
          f"{launches} trace kernel launches")
    if launches != 4:
        raise SystemExit(f"chip_smoke: want 4 kernel launches on the main path, got {launches}")
    if png.shape != (H, W, 3):
        raise SystemExit(f"chip_smoke: PNG decodes to {png.shape}")
    if not np.array_equal(png, frames[0]):
        raise SystemExit("chip_smoke: the CLI's PNG differs from render_u8 of the same view")
    for i, f in enumerate(frames):
        if f.shape != (H, W, 3) or f.std() < 10:
            raise SystemExit(f"chip_smoke: view {i} looks empty ({f.shape}, std {f.std():.2f})")
    if np.array_equal(frames[0], frames[1]) or np.array_equal(frames[1], frames[2]):
        raise SystemExit("chip_smoke: different camera poses gave the same image")

    # 5. times at the main path's shape, in turns
    plain = lambda: kt.render_color_plain(scene_dev, cfg_main)  # noqa: E731
    kernel = lambda: kt.render_color_kernel(scene_dev, cfg_main)  # noqa: E731
    with torch.no_grad():
        runs = [("plain", cuda_ms(torch, plain)), ("kernel", cuda_ms(torch, kernel)),
                ("kernel", cuda_ms(torch, kernel)), ("plain", cuda_ms(torch, plain))]
    print(f"forward {W}x{H}, default scene, default cfg ({card}):")
    for name, ms in runs:
        print(f"  {name}: {ms:.3f} ms/frame, {W * H / ms / 1e3:.1f} Mrays/s primary")
    k_ms = float(np.mean([ms for n, ms in runs if n == "kernel"]))
    p_ms = float(np.mean([ms for n, ms in runs if n == "plain"]))

    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "trace_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1275",
        "launches": launches, "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
