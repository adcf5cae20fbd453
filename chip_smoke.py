#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_rust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the builds of the CUDA kernels from ray_rust_tpu_torch/csrc, all at once:
   the trace kernel (K1) and the march kernel (K3); ptxas registers, stack
   and spills; the march kernel must be one function (ptxas reports no
   device function beside it: its refraction levels are all inlined);
3. each kernel against its plain PyTorch version on the card, and against
   its full-depth golden image, each within the JAX package's golden budget:
   at most 2% of pixels off by more than 1e-3, mean difference at most 0.01;
   also at the shape of its main path;
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: trace mode, the CLI at 1920x1080 then ``render_u8`` at
   three camera poses (three viewer requests), one trace kernel launch per
   render; march mode with glow, the CLI at 1280x720 ``-m -g 1.0`` then
   three ``render_u8`` requests, one march kernel launch per render;
5. times with CUDA events: the trace forward at 1920x1080, kernel and plain
   version in turns (3 warm-ups, 10 timed renders each); the march kernel at
   1280x720, 1920x1080 and 320x240 (3 warm-ups, 10 timed renders each), the
   plain march once at 320x240 and once at 1280x720 (the comparison of phase
   3: a plain frame takes tens of seconds at any size); each kernel's
   roofline bound from the operation count of its main path's frame, which
   the kernel's body built for the host with -DRT_COUNT_OPS counts on the
   CPU while phases 3 and 4 run (the same body, bit for bit, as the card
   runs).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGET = dict(frac=0.02, mean=0.01, tol=1e-3)  # tests/test_parity.py:152-161
W, H = 1920, 1080  # the trace main path
MW, MH = 1280, 720  # the march main path
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM rate
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def spheres_scene(rtt, seed, n_spheres, glow_dist=0.0):
    """tests/test_parity.py:75-102's seeded sphere field (seed 7, 39
    spheres + floor), or another seed and count; ``glow_dist`` makes the
    first material glow in march mode."""
    rng = np.random.default_rng(seed)
    mats = [
        rtt.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3), pn=8,
                         glow_dist=glow_dist),
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


def roofline(ops, nbytes):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``ops`` f32 operations and ``nbytes`` bytes moved once."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def io_bytes(scene, cfg):
    """Bytes a render must move: the packed tables read once (f32 and i32
    rows of 19 and 4 words, camera and light), the three f32 planes
    written once."""
    return 4 * (scene.objects.count * (19 + 4) + 8 + 4) + 3 * 4 * cfg.xres * cfg.yres


def count_ops(name, mod, cfg):
    """The f32 operations kernel ``name``'s body (``"trace"`` or
    ``"march"``) takes on the default scene under ``cfg``: its host build
    with -DRT_COUNT_OPS, run on the CPU."""
    import torch

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops.kernel_trace import pack_scene
    from ray_rust_tpu_torch.ops.rays import fov_scales

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    scene, _ = rtt.default_scene(device="cpu")
    tables = pack_scene(scene)  # held until the call returns
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    ops = torch.zeros(1, dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    getattr(lib, f"rt_{name}_host")(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
        sx, sy, *mod.kernel_args(cfg), *(plane.data_ptr() for plane in out), ops.data_ptr())
    return int(ops)


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
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.utils.image import load_png

    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    glow = dict(use_raymarching=True, glow_effect=1.0)
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, **glow)
    # the main paths' operation counts, on the host while the card works
    counting = ThreadPoolExecutor(max_workers=2)
    ops_futures = {"trace_fwd": counting.submit(count_ops, "trace", kt, cfg_main),
                   "march_fwd": counting.submit(count_ops, "march", km, cfg_march)}

    # 2. the builds, one nvcc each, all started together
    t0 = time.time()
    _build.prebuild(["trace_fwd", "march_fwd"])
    print(f"build: trace_fwd.cu and march_fwd.cu with nvcc in {time.time() - t0:.1f} s")
    for stem in ("trace_fwd", "march_fwd"):
        print(f"  ptxas, {stem}:")
        for line in _build.build_logs[stem].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("    " + line.strip())
    calls = _build.called_functions(_build.build_logs["march_fwd"])
    if calls:
        raise SystemExit(f"chip_smoke: march_fwd.cu left device functions as calls: {calls}")

    dev = torch.device("cuda", 0)

    def both(scene, cfg, mod=kt):
        """Kernel and plain images of one render, and the plain one's ms."""
        scene = scene.to(dev)
        got = img(mod.render_color_kernel(scene, cfg))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = mod.render_color_plain(scene, cfg)
        end.record()
        torch.cuda.synchronize()
        return got, img(ref), start.elapsed_time(end)

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
        got, ref, _ = both(scene, cfg)
        compare(name, ref, got)
    golden = np.load(os.path.join(HERE, "tests", "goldens", "default_trace_320x240.npz"))["img"]
    got = img(kt.render_color_kernel(default.to(dev),
                                     rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)))
    compare("kernel vs golden default_trace_320x240", golden, got)
    got, ref, _ = both(default, cfg_main)
    max_abs_err = compare(f"default {W}x{H} (the main path's shape)", ref, got)

    print("march kernel vs plain version:")
    cases = [
        ("march default 320x240", default, rtt.RenderConfig(xres=320, yres=240, **glow)),
        ("march default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None, **glow)),
        ("march 40 objects 320x240", spheres_scene(rtt, 7, 39, glow_dist=3.0),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1, **glow)),
        ("march 101 objects 160x120", spheres_scene(rtt, 11, 100, glow_dist=3.0),
         rtt.RenderConfig(xres=160, yres=120, **glow)),
    ]
    for name, scene, cfg in cases:
        got, ref, _ = both(scene, cfg, km)
        compare(name, ref, got)
    golden = np.load(os.path.join(HERE, "tests", "goldens", "default_march_glow_160x120.npz"))["img"]
    got = img(km.render_color_kernel(default.to(dev), rtt.RenderConfig(
        xres=160, yres=120, refraction_unroll=None, **glow)))
    compare("march kernel vs golden default_march_glow_160x120", golden, got)
    got, ref, march_plain_ms = both(default, cfg_march, km)
    march_max_abs_err = compare(f"march default {MW}x{MH} (the main path's shape)", ref, got)

    # 4. the main paths
    poses = [((0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2)),
             ((120.0, -120.0, -320.0), (0.0, -np.pi / 2 + 0.2, -np.pi / 2)),
             ((-80.0, -60.0, -280.0), (-0.15, -np.pi / 2 - 0.1, -np.pi / 2))]
    scene_dev = default.to(dev)
    # each request's camera is built on the host, as the viewer parses it
    views = [default._replace(camera=Camera.from_pyr(rtt.v3(*p), rtt.v3(*a))).to(dev)
             for p, a in poses]

    def main_path(name, argv, cfg, mod, other):
        """The CLI then three viewer requests; ``mod``'s kernel must launch
        once per render and ``other``'s not at all. Returns the launches."""
        with tempfile.TemporaryDirectory() as td:
            png_path = os.path.join(td, "out.png")
            kt.LAUNCHES = km.LAUNCHES = 0
            t0 = time.time()
            if cli.main(argv + ["-o", png_path]) != 0:
                raise SystemExit("chip_smoke: the CLI failed")
            frames = [rtt.render_u8(v, cfg) for v in views]
            torch.cuda.synchronize()
            main_s = time.time() - t0
            launches, stray = mod.LAUNCHES, other.LAUNCHES
            png = load_png(png_path)
        print(f"main path, {name}: CLI {cfg.xres}x{cfg.yres} + 3 render_u8 in {main_s:.2f} s, "
              f"{launches} kernel launches")
        if launches != 4 or stray != 0:
            raise SystemExit(f"chip_smoke: want 4 launches of the {name} kernel and 0 of the "
                             f"other on its main path, got {launches} and {stray}")
        if png.shape != (cfg.yres, cfg.xres, 3):
            raise SystemExit(f"chip_smoke: PNG decodes to {png.shape}")
        if not np.array_equal(png, frames[0]):
            raise SystemExit("chip_smoke: the CLI's PNG differs from render_u8 of the same view")
        for i, f in enumerate(frames):
            if f.shape != (cfg.yres, cfg.xres, 3) or f.std() < 10:
                raise SystemExit(f"chip_smoke: view {i} looks empty ({f.shape}, std {f.std():.2f})")
        if np.array_equal(frames[0], frames[1]) or np.array_equal(frames[1], frames[2]):
            raise SystemExit("chip_smoke: different camera poses gave the same image")
        return launches

    launches = main_path("trace", [str(W), str(H)], cfg_main, kt, km)
    march_launches = main_path("march", [str(MW), str(MH), "-m", "-g", "1.0"], cfg_march, km, kt)

    # 5. times at the main path's shape, in turns, once the host is free
    ops = {name: f.result() for name, f in ops_futures.items()}
    counting.shutdown()
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

    print(f"march + glow forward, default scene, default cfg ({card}):")
    with torch.no_grad():
        march_ms = {}
        for w, h in ((MW, MH), (W, H), (320, 240)):
            c = cfg_march.with_(xres=w, yres=h)
            march_ms[(w, h)] = cuda_ms(torch, lambda c=c: km.render_color_kernel(scene_dev, c))
            print(f"  kernel {w}x{h}: {march_ms[(w, h)]:.3f} ms/frame")
        c = cfg_march.with_(xres=320, yres=240)
        plain_320 = cuda_ms(torch, lambda: km.render_color_plain(scene_dev, c), warm=0, reps=1)
    print(f"  plain 320x240: {plain_320:.1f} ms (one frame)")
    print(f"  plain {MW}x{MH}: {march_plain_ms:.1f} ms (one frame, phase 3)")

    # roofline bounds from the operation counts of the main paths' frames
    bounds = {}
    for name, cfg in (("trace_fwd", cfg_main), ("march_fwd", cfg_march)):
        nbytes = io_bytes(scene_dev, cfg)
        bounds[name] = roofline(ops[name], nbytes)
        print(f"  bound, {name} {cfg.xres}x{cfg.yres}: {ops[name]} f32 operations, "
              f"{nbytes} bytes -> {bounds[name][0]:.4f} ms ({bounds[name][1]})")

    if "jax" in sys.modules or "ray_rust_tpu" in sys.modules:
        raise SystemExit("chip_smoke: the port imported jax or the JAX package")
    print(json.dumps({"kernels": [{
        "name": "trace_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1275",
        "launches": launches, "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bounds["trace_fwd"][0], "bound_by": bounds["trace_fwd"][1],
        "library_ms": None,
    }, {
        "name": "march_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_march.py:814",
        "launches": march_launches, "max_abs_err": march_max_abs_err,
        "ms": march_ms[(MW, MH)], "plain_ms": march_plain_ms,
        "bound_ms": bounds["march_fwd"][0], "bound_by": bounds["march_fwd"][1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
