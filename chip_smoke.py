#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_rust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the builds of the CUDA kernels from ray_rust_tpu_torch/csrc, all at once:
   the trace kernel (K1), the march kernel (K3), the trace backward (K2),
   the march backward (K4) and the re-trace gradient oracle (K5); ptxas
   registers, stack and spills (the trace backward is built for three record
   caps, one kernel each), and the march backward and the re-trace oracle
   must keep theirs (PINNED_PTXAS); each kernel must be one function (ptxas
   reports no device function beside the kernel: everything is inlined, the
   texture fetch too);
3. each kernel against its plain PyTorch version on the card, and against
   its full-depth golden image, each within the JAX package's golden budget:
   at most 2% of pixels off by more than 1e-3, mean difference at most 0.01;
   also at the shape of its main path; the trace kernel with image textures
   (K1a: the default scene with the goldens' 256x256 noise texture as
   ``bar.png``) against its plain version at 1920x1080 in Nearest and in
   Bilinear, and against the two textured goldens (mean at most 0.015,
   tests/test_parity.py:192-214); the trace backward against torch
   autograd of the plain trace, per scene leaf within relative L2 0.01 (the
   JAX package's budget, tests/test_pallas_bwd.py:84-96), at six small
   cases (among them a 70-sphere field, where the lanes of a warp hit
   different objects, and 4 reflections at refraction_unroll=None, 63 sites
   a pixel at most) and at the training main path's shape, and with textures (K2's
   textured sites) at two small cases and at 1920x1080 in Bilinear, its
   image bit-equal to the trace kernel's; the march backward against
   torch autograd of the plain march (its implicit VJP), per scene leaf
   within relative L2 0.02 (tests/test_pallas_bwd.py:306-321) on the pixels
   where its image agrees with the plain version's within 1e-4 (each other
   pixel on a decision boundary, tests/test_pallas_bwd.py:29-72), at four
   small cases and at the march training path's shape, its image the march
   kernel's bit for bit; the march kernel with the floor tail off
   (``march_floor_skip=False``) bit-equal to its plain version at 1280x720,
   and with it on against it off at 1280x720 and on the JAX package's two
   floor-tail scenes (tests/test_pallas.py:264-322), knife-edge pixels only
   (at most 0.5% of pixels off by more than 1e-3, each on a decision
   boundary: tests/test_pallas.py:238-261); the re-trace gradient
   oracle against torch autograd of the plain trace, per scene leaf within
   relative L2 0.01, at 320x240 (its image bit-equal to the trace kernel's)
   and, beside the trace backward against the same plain call, at the
   gradient oracle's main path's shape and cotangent planes;
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: trace mode, the CLI at 1920x1080 then ``render_u8`` at
   three camera poses (three viewer requests), one trace kernel launch per
   render; march mode with glow, the CLI at 1280x720 ``-m -g 1.0`` then
   three ``render_u8`` requests, one march kernel launch per render;
   textured trace, the CLI at 1920x1080 in a directory holding ``bar.png``
   (its floor must differ from the untextured one) then a Bilinear
   ``render_u8``, one trace kernel launch each; training, five
   ``sgd_train_step``s at 1920x1080 on the default scene against a target
   whose red material is 0.1 redder, one trace and one backward kernel
   launch per step, the loss falling; the same on the Bilinear textured
   scene, the loss falling at every step; march training with glow, five
   ``sgd_train_step``s at 1280x720 ``-m -g 1.0`` against the same
   kind of target, one march and one march backward launch per step, the
   loss falling at every step; the gradient oracle, ``render_grads_retrace``
   at 1920x1080 on the default scene with cotangent planes from numpy seed
   0, ceil(105 / lanes) re-trace launches, its cotangent against the trace
   backward's per scene leaf within relative L2 0.01 (the JAX oracle test's
   budget, tests/test_pallas_bwd.py:250-260) and its image bit-equal to the
   trace kernel's on every pixel;
5. times with CUDA events: the trace forward at 1920x1080, kernel and plain
   version in turns (3 warm-ups, 10 timed renders each); the forward and
   backward step at 1920x1080 through the kernels and through plain autograd
   in turns, the backward kernel through its wrapper and alone (on tables
   packed once) in turns, beside the host counts of its accumulator's adds,
   their distinct (warp, entry) pairs and the sites, and its plain version
   (3 warm-ups, 10 timed calls each; the plain versions one call each with
   no warm-up, ~32 s a call at 1080p); the march forward and backward step at 1280x720
   through the march kernels (3 warm-ups, 10 timed calls) and once through
   plain autograd, the march backward alone (3 warm-ups, 10 timed calls),
   its plain version once (phase 3's call at 1280x720); the march kernel at
   1280x720, 1920x1080 and 320x240 (3 warm-ups, 10 timed renders each), the
   plain march once at 1280x720 (the comparison of phase 3: a plain frame
   takes tens of seconds at any size); the textured trace
   kernel at 1920x1080 in both filters, the textured training step and the
   backward kernel through its wrapper and alone on the Bilinear scene (3
   warm-ups, 10 timed calls;
   their plain versions once, in phase 3); the re-trace oracle and the trace
   backward at 1920x1080 in turns (3 warm-ups, 10 timed calls each; their
   plain version is the trace backward's, timed above); each kernel's
   roofline bound from the operation count of its main path's frame, which
   the kernel's body built for the host with -DRT_COUNT_OPS counts on the
   CPU while phases 3 and 4 run (the same body, bit for bit, as the card
   runs); the re-trace oracle's bound is the trace backward's, since it
   computes the same function on the same inputs (its forward-mode
   operations over every launch, counted the same way, are printed beside
   it as a diagnostic); the floor tail on and off in turns (on, off, off,
   on) at 1280x720: the march kernel, the march backward and the march
   training step (3 warm-ups, 10 calls each), beside the longest pixel's
   operations and object passes from the counting builds, on and off (the
   march bounds are the tail's counts; the step-by-step ones are printed as
   a diagnostic).

The last two lines are JSON: the kernel table, then
``{"ok": true, "device": {...}}``. Each kernel's ``ms`` is its time through
its public wrapper (for K1 and K2 packing included); the trace backward's
two entries also give ``alone_ms``, the kernel alone on tables packed once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGET = dict(frac=0.02, mean=0.01, tol=1e-3)  # tests/test_parity.py:152-161
W, H = 1920, 1080  # the trace and training main paths
MW, MH = 1280, 720  # the march main path and the march training path
GRAD_BUDGET = 0.01  # per scene leaf, relative L2 (tests/test_pallas_bwd.py:84-96)
MARCH_GRAD_BUDGET = 0.02  # the march's (tests/test_pallas_bwd.py:306-321)
# The training main path's learning rate on the material colours; at 30 the
# five steps bring the red back from 0.8 to ~0.9 (tests/test_torch_grad.py).
TRAIN_LR = 30.0
# March mode with glow renders about twice as bright; at 10 the five steps
# bring the red from 0.8 to ~0.9 with the loss falling at every step (the
# plain path at 64x36 on the CPU).
MARCH_TRAIN_LR = 10.0
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM rate
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# The floor tail's contract against the step-by-step march
# (tests/test_pallas.py:238-261): pixels off by more than 1e-3 at most 0.5%,
# each with a local contrast above 0.05 in the step-by-step image.
KNIFE_EDGE = dict(frac=0.005, tol=1e-3, contrast=0.05)
# ptxas figures the march backward and the re-trace oracle keep while the
# trace backward, which shares their frame (csrc/bwd_kernel.cuh), changes:
# registers, stack frame, spill stores and spill loads in bytes (PERF.md §6)
PINNED_PTXAS = {"march_bwd": (128, 8168, 4188, 5512), "trace_retrace": (127, 1984, 0, 0)}


def compare(name, ref, got, mean_budget=BUDGET["mean"]):
    """Hold ``got`` against ``ref`` ((H, W, 3) arrays) within BUDGET, with
    ``mean_budget`` for the mean difference."""
    diff = np.abs(got - ref)
    frac = float((diff.max(-1) > BUDGET["tol"]).mean())
    mean, mx = float(diff.mean()), float(diff.max())
    same = float((got == ref).all(-1).mean())
    ok = np.isfinite(got).all() and frac <= BUDGET["frac"] and mean <= mean_budget
    print(f"  {name}: {frac:.4%} pixels > {BUDGET['tol']}, mean {mean:.3g}, "
          f"max {mx:.3g}, {same:.4%} bit-equal -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside the budget {BUDGET}, mean {mean_budget}")
    return mx


def off_boundary(ref, bad):
    """How many of the pixels ``bad`` lie off a decision boundary: local
    contrast at most KNIFE_EDGE's in the 3x3 neighbourhood of ``ref``."""
    lum = ref.mean(-1)
    pad = np.pad(lum, 1, mode="edge")
    h, w = lum.shape
    win = np.stack([pad[r:r + h, c:c + w] for r in range(3) for c in range(3)])
    return int((bad & (win.max(0) - win.min(0) <= KNIFE_EDGE["contrast"])).sum())


def knife_edge_only(name, on, off):
    """Hold image ``on`` against ``off`` ((H, W, 3) arrays) to KNIFE_EDGE:
    few pixels differ, each on a decision boundary of ``off``."""
    diff = np.abs(on - off).max(-1)
    bad = diff > KNIFE_EDGE["tol"]
    flat = off_boundary(off, bad)
    ok = np.isfinite(on).all() and bad.mean() <= KNIFE_EDGE["frac"] and flat == 0
    print(f"  {name}: {bad.mean():.4%} pixels > {KNIFE_EDGE['tol']} (max {diff.max():.3g}), "
          f"{flat} of them off a decision boundary -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} is not knife-edge-only ({KNIFE_EDGE})")


def floor_tail_scenes(rtt):
    """tests/test_pallas.py:264-322's two floor-tail scenes with their
    configs: the branch matrix and the escape-glow regression."""
    down = (0.0, -np.pi / 2, -np.pi / 2)
    mats = [rtt.MaterialSpec(name="glowfloor", diffuse=(0.8, 0.8, 0.2), glow_dist=3.0),
            rtt.MaterialSpec(name="glowball", diffuse=(0.8, 0.2, 0.2), glow_dist=4.0),
            rtt.MaterialSpec(name="dull", diffuse=(0.3, 0.3, 0.6))]
    objs = [rtt.FloorSpec("glowfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            rtt.SphereSpec("glowball", 80.0, (400.0, -100.0, 600.0)),
            rtt.SphereSpec("dull", 60.0, (0.0, -180.0, 1500.0))]
    matrix = rtt.build_scene(mats, objs, (0.0, -295.0, -300.0), down, (50.0, 60.0, -50.0))[0]
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.9, 0.9, 0.3)),
            rtt.MaterialSpec(name="glow", diffuse=(0.9, 0.1, 0.1), glow_dist=1.0)]
    objs = [rtt.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            rtt.SphereSpec("glow", 100.0, (0.0, -150.0, 2000.0))]
    escape = rtt.build_scene(mats, objs, (0.0, -295.0, -300.0), down, (50.0, 60.0, -50.0))[0]
    march = dict(xres=64, yres=48, use_raymarching=True, max_refractions=1)
    return [("branch matrix 64x48", matrix,
             rtt.RenderConfig(glow_effect=1.5, march_max_iter=600, **march)),
            ("escape-glow regression 64x48", escape,
             rtt.RenderConfig(glow_effect=2.0, march_max_iter=2000, **march))]


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


def ptxas_figures(log):
    """Each kernel's (registers, stack frame, spill stores, spill loads)
    in a ``ptxas -v`` log, in the log's order."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    regs = re.findall(r"Used (\d+) registers", log)
    return [(int(r), *map(int, f)) for r, f in zip(regs, frames)]


def roofline(ops, nbytes):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``ops`` f32 operations and ``nbytes`` bytes moved once."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def io_bytes(scene, cfg):
    """Bytes a render must move: the packed tables read once (f32 and i32
    rows of 19 and 4 words, camera and light), the three f32 planes
    written once; with textures, the atlas's meta rows."""
    meta = 0 if scene.textures is None else 4 * 4 * scene.textures.data.shape[0]
    return 4 * (scene.objects.count * (19 + 4) + 8 + 4) + 3 * 4 * cfg.xres * cfg.yres + meta


def texel_bytes(scene, fetched):
    """Atlas bytes a frame must read: 16 B for each texture fetch its
    traversal makes (``fetched``, counted by the host build), but no more
    than the whole atlas, read once."""
    if scene.textures is None:
        return 0
    return min(fetched, 16 * scene.textures.data[..., 0].numel())


def _host_scene(texture_dir, texture_filter):
    import ray_rust_tpu_torch as rtt

    return rtt.default_scene(texture_dir=texture_dir, texture_filter=texture_filter,
                             device="cpu")[0]


def count_ops(name, mod, cfg, texture_dir=".", texture_filter=0):
    """The f32 operations kernel ``name``'s body (``"trace"`` or
    ``"march"``) takes on the default scene under ``cfg``, textured from
    ``texture_dir``, and the texel bytes its texture fetches read: its host
    build with -DRT_COUNT_OPS, run on the CPU. A march body also gives the
    most operations of one pixel, the object passes and the most passes of
    one pixel and the marches the never-converges test ended
    (``kernel_march.OPS_SLOTS`` counts in all)."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops.rays import fov_scales

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    scene = _host_scene(texture_dir, texture_filter)
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)  # held until the call returns
    tex_args = kt.texture_args(tex, torch.device("cpu")) if name == "trace" else []
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    getattr(lib, f"rt_{name}_host")(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
        sx, sy, *mod.kernel_args(cfg), *tex_args, *(plane.data_ptr() for plane in out),
        ops.data_ptr())
    return tuple(int(v) for v in ops)


def count_bwd_ops(name, mod, cfg, texture_dir=".", texture_filter=0):
    """The f32 operations of backward kernel ``name``'s record pass
    (``"trace_bwd"``: its raycasts; ``"march_bwd"``: its SDF steps) on the
    default scene under ``cfg``, textured from ``texture_dir``, and the texel
    bytes the record pass's texture fetches read: its host build with
    -DRT_COUNT_OPS (all ``kernel_march.OPS_SLOTS`` counts, as
    :func:`count_ops`; the trace backward's slots 2-5 are its accumulator's
    adds, their distinct (warp, entry) pairs, the sites and the most sites of
    one pixel, csrc/trace_bwd_host.cpp, for cotangent 1 on every pixel)."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops.rays import fov_scales

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    scene = _host_scene(texture_dir, texture_filter)
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    trace = name == "trace_bwd"
    args = kb.launch_args(cfg, tex, torch.device("cpu")) if trace else mod.kernel_args(cfg)
    g = (torch.ones if trace else torch.zeros)((3, cfg.yres, cfg.xres), dtype=torch.float32)
    block = torch.zeros((scene.objects.count + 1, kb.GRAD_COLS), dtype=torch.float32)
    ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    getattr(lib, f"rt_{name}_host")(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres, sx, sy,
        *args, *(plane.data_ptr() for plane in g), block.data_ptr(), None, None, None,
        ops.data_ptr())
    return tuple(int(v) for v in ops)


def count_retrace_ops(cfg):
    """The f32 operations of every launch of the re-trace oracle's
    cotangent on the default scene under ``cfg``: its host build with
    -DRT_COUNT_OPS (the value scans' object tests, and every forward-mode
    operation with its tangents). A diagnostic: the oracle's bound is the
    trace backward's, whose function it computes."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    lib = _build.build_host_library(_build.BUILD_DIR, "trace_retrace", count_ops=True)
    scene = _host_scene(".", 0)
    g = [torch.zeros((cfg.yres, cfg.xres), dtype=torch.float32) for _ in range(3)]
    ops = torch.zeros(2, dtype=torch.int64)
    kr.launch_all(lib.rt_trace_retrace_host, lib.rt_trace_retrace_lanes(), kt.pack_scene(scene),
                  cfg, g, False, (ops.data_ptr(),))
    return int(ops[0]), 0


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


def training_step(torch, render, cfg, base):
    """The training step without the update, as a function of no arguments:
    render ``base`` with ``render`` under ``cfg``, MSE against a target 0.05
    brighter, the gradient of every float leaf (the texture atlas is u8: a
    constant)."""
    target = torch.full((cfg.yres, cfg.xres, 3), 0.05, device=base.device)
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in base.tensors()]
    params = [t for t in leaves if t.requires_grad]
    s_grad = base.with_tensors(leaves)

    def go():
        loss = (torch.stack(list(render(s_grad, cfg)), -1) - target).square().mean()
        torch.autograd.grad(loss, params, allow_unused=True)
    return go


def textured_bwd_scene(rtt):
    """tests/test_pallas_bwd.py:116-138's scene: a 12x20 noise texture on the
    floor (Bilinear), seen directly, in a mirror and through glass."""
    tex = np.random.default_rng(5).integers(0, 256, (12, 20, 3)).astype(np.uint8)
    mats = [
        rtt.MaterialSpec(name="texfloor", diffuse=(1.0, 1.0, 0.0), pattern=2,
                         pattern_scale=300.0, pattern_angle_scale=0.2, texture_filter=1,
                         texture=tex),
        rtt.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24),
        rtt.MaterialSpec(name="glass", transparency=1.0, refraction=1.5),
    ]
    objs = [rtt.FloorSpec("texfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            rtt.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
            rtt.SphereSpec("glass", 100.0, (70.0, -200.0, 150.0))]
    scene, _ = rtt.build_scene(mats, objs, (0.37, -150.3, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0))
    return scene


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the textured phases' bar.png lives here
    with tempfile.TemporaryDirectory() as tex_dir:
        return run(torch, tex_dir)


def run(torch, tex_dir) -> int:
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
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
    from ray_rust_tpu_torch.parallel import sgd_train_step
    from ray_rust_tpu_torch.utils.image import load_png, save_png

    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    glow = dict(use_raymarching=True, glow_effect=1.0)
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, **glow)
    cfg_march_off = cfg_march.with_(march_floor_skip=False)  # the step-by-step march
    # bar.png: the textured goldens' 256x256 noise (tests/goldens/gen_textured.py)
    save_png(os.path.join(tex_dir, "bar.png"),
             np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8))
    # the main paths' operation counts, on the host while the card works
    counting = ThreadPoolExecutor(max_workers=6)
    ops_futures = {"trace_fwd": counting.submit(count_ops, "trace", kt, cfg_main),
                   "march_fwd": counting.submit(count_ops, "march", km, cfg_march),
                   "trace_bwd": counting.submit(count_bwd_ops, "trace_bwd", kb, cfg_main),
                   "march_bwd": counting.submit(count_bwd_ops, "march_bwd", kmb, cfg_march),
                   "march_fwd_off": counting.submit(count_ops, "march", km, cfg_march_off),
                   "march_bwd_off": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                    cfg_march_off),
                   "trace_fwd_textured": counting.submit(count_ops, "trace", kt, cfg_main,
                                                         tex_dir, 0),
                   "trace_bwd_textured": counting.submit(count_bwd_ops, "trace_bwd", kb,
                                                         cfg_main, tex_dir, 1),
                   "trace_retrace": counting.submit(count_retrace_ops, cfg_main)}

    # 2. the builds, one nvcc each, all started together
    t0 = time.time()
    stems = ("trace_fwd", "march_fwd", "trace_bwd", "march_bwd", "trace_retrace")
    _build.prebuild(stems)
    print(f"build: {', '.join(f'{stem}.cu' for stem in stems)} with nvcc in "
          f"{time.time() - t0:.1f} s")
    for stem in stems:
        print(f"  ptxas, {stem}:")
        for line in _build.build_logs[stem].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("    " + line.strip())
    for stem in stems:
        calls = _build.called_functions(_build.build_logs[stem])
        if calls:
            raise SystemExit(f"chip_smoke: {stem}.cu left device functions as calls: {calls}")
    for stem, want in PINNED_PTXAS.items():
        got = ptxas_figures(_build.build_logs[stem])
        print(f"  {stem}: (registers, stack, spill stores, spill loads) {got}, pinned {want}")
        if got != [want]:
            raise SystemExit(f"chip_smoke: {stem}.cu left its ptxas figures {want}: {got}")

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

    print("textured trace kernel (K1 with K1a) vs plain version and golden:")
    tex_scenes = {f: rtt.default_scene(texture_dir=tex_dir, texture_filter=f)[0] for f in (0, 1)}
    if any(s.textures is None for s in tex_scenes.values()):
        raise SystemExit("chip_smoke: default_scene did not load bar.png")
    tex_err, tex_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        got, ref, tex_plain_ms[f] = both(tex_scenes[f], cfg_main)
        tex_err[f] = compare(f"textured {fname} {W}x{H} (the main path's shape)", ref, got)
    for gname, f in (("default_textured_nearest_320x240", 0),
                     ("default_textured_bilinear_160x120", 1)):
        golden = np.load(os.path.join(HERE, "tests", "goldens", f"{gname}.npz"))["img"]
        gh, gw = golden.shape[:2]
        got = img(kt.render_color_kernel(tex_scenes[f], rtt.RenderConfig(
            xres=gw, yres=gh, refraction_unroll=None)))
        compare(f"textured kernel vs golden {gname}", golden, got, mean_budget=0.015)

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
    print("march kernel, floor tail off vs plain version, and on vs off:")
    off = img(km.render_color_kernel(default.to(dev), cfg_march_off))
    same = float((off == ref).all(-1).mean())
    print(f"  tail off, default {MW}x{MH}: bit-equal to the plain version on {same:.4%} of pixels "
          f"-> {'ok' if same == 1.0 else 'FAIL'}")
    if same < 1.0:
        raise SystemExit("chip_smoke: the march kernel with the tail off is not its plain version")
    knife_edge_only(f"tail on vs off, default {MW}x{MH}", got, off)
    for name, scene, cfg in floor_tail_scenes(rtt):
        scene = scene.to(dev)
        knife_edge_only(f"tail on vs off, {name}", img(km.render_color_kernel(scene, cfg)),
                        img(km.render_color_kernel(scene, cfg.with_(march_floor_skip=False))))

    print("backward kernel vs torch autograd of the plain version:")

    def leaf_err(name, scene, got, want):
        """The largest relative L2 (norm floor 1e-2) of table cotangents
        ``got`` against ``want`` over the scene's leaves, and its leaf; every
        leaf of ``got`` must be finite (``pattern_scale`` is checked finite
        only)."""
        got, want = kb.leaf_grads(scene, got), kb.leaf_grads(scene, want)
        worst, worst_leaf = 0.0, None
        for path, w in want.items():
            a = got[path].detach().cpu().numpy().astype(np.float64)
            if not np.isfinite(a).all():
                raise SystemExit(f"chip_smoke: {name}: {path} cotangent not finite")
            if "pattern_scale" in path:
                continue
            b = w.detach().cpu().numpy().astype(np.float64)
            rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2))
            if rel >= worst:
                worst, worst_leaf = rel, path
        return worst, worst_leaf

    def grad_case(name, scene, cfg, seed=0, bwd=kb, fwd=kt.render_color_plain,
                  budget=GRAD_BUDGET, bit_equal=False, kernels=None, agree_with=None):
        """The table cotangents of each kernel wrapper in ``kernels`` (by
        default ``[bwd.render_grads_kernel]``) against one call of autograd
        of the plain version ``bwd.render_grads_plain`` on the same inputs,
        mapped to the scene's leaves, and each one's image against ``fwd``'s
        (on every pixel when ``bit_equal``); returns each kernel's largest
        relative L2 and the plain version's ms (one call, CUDA events).
        With ``agree_with`` (a function giving the plain version's image),
        the JAX package's two steps (tests/test_pallas_bwd.py:29-72,
        306-321): ``fwd``'s image agrees with it within 1e-4 on more than
        90% of pixels, each other pixel on a decision boundary, and the
        cotangent planes are zero there."""
        scene = scene.to(dev)
        rng = np.random.default_rng(seed)
        g = rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                         .astype(np.float32)).to(dev) for _ in range(3)))
        if agree_with is not None:
            ref_img = img(agree_with(scene, cfg))
            agree = np.abs(img(fwd(scene, cfg)) - ref_img).max(-1) < 1e-4
            flat = off_boundary(ref_img, ~agree)
            print(f"  {name}: forwards agree on {agree.mean():.4%} of pixels, "
                  f"{int((~agree).sum())} masked, {flat} of them off a decision boundary")
            if not agree.mean() > 0.9 or flat:
                raise SystemExit(f"chip_smoke: {name}: the forwards disagree off the boundaries")
            g = rtt.Color(*(c * torch.from_numpy(agree).to(dev) for c in g))
        kernels = kernels or [bwd.render_grads_kernel]
        outs = [k(scene, cfg, g, return_primal=True) for k in kernels]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = bwd.render_grads_plain(scene, cfg, g)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        ref = img(fwd(scene, cfg))
        errs = []
        for k, (got, prim) in zip(kernels, outs):
            label = name if len(kernels) == 1 else f"{name}, {k.__name__}"
            agree = float((img(prim) == ref).all(-1).mean())
            worst, worst_leaf = leaf_err(label, scene, got, want)
            ok = worst <= budget
            print(f"  {label}: image bit-equal to {fwd.__module__}.{fwd.__name__}'s on "
                  f"{agree:.4%} of pixels, largest leaf relative L2 {worst:.3g} ({worst_leaf}), "
                  f"plain autograd {plain_ms:.1f} ms, peak {peak / 2**30:.2f} GiB -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {label}: {worst_leaf} off by relative L2 "
                                 f"{worst:.3g}")
            if bit_equal and agree < 1.0:
                raise SystemExit(f"chip_smoke: {label}: the image is not {fwd.__name__}'s")
            errs.append(worst)
        return errs, plain_ms

    for name, scene, cfg in [
        ("default 320x240", default, rtt.RenderConfig(xres=320, yres=240)),
        ("default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)),
        ("40 objects 320x240", spheres_scene(rtt, 7, 39),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1)),
        ("101 objects 160x120", spheres_scene(rtt, 11, 100), rtt.RenderConfig(xres=160, yres=120)),
        # lanes of a warp that hit different objects (the scatter's groups)
        ("70 spheres 160x120", spheres_scene(rtt, 3, 70), rtt.RenderConfig(xres=160, yres=120)),
        # 63 sites a pixel at most: the trace backward's 64-site records
        ("default 160x120 4 reflections refraction_unroll=None", default,
         rtt.RenderConfig(xres=160, yres=120, max_reflections=4, refraction_unroll=None)),
    ]:
        grad_case(name, scene, cfg)
    # the main path's shape, or the largest whose plain autograd graph fits;
    # the trace backward and the re-trace oracle (the gradient oracle's main
    # path: the same cotangent planes) against one plain call
    for pw, ph in ((W, H), (1280, 720), (960, 540)):
        try:
            (bwd_max_err, retrace_max_err), _ = grad_case(
                f"default {pw}x{ph}", default, cfg_main.with_(xres=pw, yres=ph),
                kernels=[kb.render_grads_kernel, kr.render_grads_retrace])
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"  default {pw}x{ph}: the plain autograd graph does not fit the card: {e}")
            torch.cuda.empty_cache()
    else:
        raise SystemExit("chip_smoke: the plain autograd graph fits at no shape tried")
    cfg_plain = cfg_main.with_(xres=pw, yres=ph)  # where the plain versions are timed

    print("textured backward kernel (K2's textured sites) vs torch autograd of the plain "
          "version, its image vs the trace kernel's:")
    tex_grad = dict(fwd=kt.render_color_kernel, bit_equal=True)
    grad_case("textured Bilinear 32x16 (tests/test_pallas_bwd.py:140)", textured_bwd_scene(rtt),
              rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1,
                               grad_distance_cutoff=2e3), **tex_grad)
    grad_case("textured Nearest 320x240", tex_scenes[0], rtt.RenderConfig(xres=320, yres=240),
              **tex_grad)
    (tex_bwd_err,), tex_bwd_plain_ms = grad_case(f"textured Bilinear {pw}x{ph}", tex_scenes[1],
                                              cfg_plain, **tex_grad)

    print("march backward kernel vs torch autograd of the plain march (implicit VJP), its "
          "image vs the march kernel's:")
    # K4's image against K3's bit for bit; the floor tail flips knife-edge
    # pixels against the plain march, so the cotangent covers the pixels
    # where K3's image agrees with the plain version's
    mgrad = dict(bwd=kmb, fwd=km.render_color_kernel, budget=MARCH_GRAD_BUDGET, bit_equal=True,
                 agree_with=km.render_color_plain)
    glowing40 = spheres_scene(rtt, 7, 39, glow_dist=3.0)
    for name, scene, cfg in [
        ("march default 320x240", default, rtt.RenderConfig(xres=320, yres=240, **glow)),
        ("march default 320x240 no glow", default,
         rtt.RenderConfig(xres=320, yres=240, use_raymarching=True)),
        ("march default 160x120 refraction_unroll=None", default,
         rtt.RenderConfig(xres=160, yres=120, refraction_unroll=None, **glow)),
        ("march 40 objects 160x120", glowing40,
         rtt.RenderConfig(xres=160, yres=120, max_refractions=1, **glow)),
    ]:
        grad_case(name, scene, cfg, **mgrad)
    # the march training path's shape, or the largest whose plain graph fits
    for pw_m, ph_m in ((MW, MH), (960, 540), (640, 360)):
        try:
            # at the main path's frame the plain image is the march kernel's
            # with the tail off (bit for bit on this frame, phase 3), a
            # thousandth of the plain march's time
            main_frame = (pw_m, ph_m) == (MW, MH)
            (march_bwd_max_err,), march_bwd_plain_ms = grad_case(
                f"march default {pw_m}x{ph_m}", default, cfg_march.with_(xres=pw_m, yres=ph_m),
                **{**mgrad, "agree_with": (
                    (lambda s, c: km.render_color_kernel(s, c.with_(march_floor_skip=False)))
                    if main_frame else km.render_color_plain)})
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"  march default {pw_m}x{ph_m}: the plain autograd graph does not fit the "
                  f"card: {e}")
            torch.cuda.empty_cache()
    else:
        raise SystemExit("chip_smoke: the plain march autograd graph fits at no shape tried")
    cfg_march_plain = cfg_march.with_(xres=pw_m, yres=ph_m)

    print("re-trace gradient oracle (K5) vs torch autograd of the plain trace, its image vs "
          "the trace kernel's:")
    grad_case("retrace default 320x240", default, rtt.RenderConfig(xres=320, yres=240), bwd=kr,
              kernels=[kr.render_grads_retrace], fwd=kt.render_color_kernel, bit_equal=True)

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

    # textured trace: the CLI where bar.png lies (the reference's Nearest),
    # then one Bilinear request
    png_path = os.path.join(tex_dir, "out.png")
    cwd = os.getcwd()
    kt.LAUNCHES = km.LAUNCHES = 0
    t0 = time.time()
    os.chdir(tex_dir)
    try:
        rc = cli.main([str(W), str(H), "-o", png_path])
    finally:
        os.chdir(cwd)
    frame_bi = rtt.render_u8(tex_scenes[1], cfg_main)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    tex_launches, stray = kt.LAUNCHES, km.LAUNCHES
    png = load_png(png_path)
    print(f"main path, textured trace: CLI {W}x{H} with bar.png + 1 Bilinear render_u8 in "
          f"{main_s:.2f} s, {tex_launches} kernel launches")
    if rc != 0 or tex_launches != 2 or stray != 0:
        raise SystemExit(f"chip_smoke: the textured main path: CLI exit {rc}, want 2 trace and "
                         f"0 march launches, got {tex_launches} and {stray}")
    if not np.array_equal(png, rtt.render_u8(tex_scenes[0], cfg_main)):
        raise SystemExit("chip_smoke: the CLI's PNG with bar.png is not the textured render")
    floor = slice(3 * H // 4, H)  # rows of floor below the spheres
    if np.array_equal(png[floor], rtt.render_u8(scene_dev, cfg_main)[floor]):
        raise SystemExit("chip_smoke: the CLI did not texture the floor with bar.png")
    if np.array_equal(png, frame_bi):
        raise SystemExit("chip_smoke: Nearest and Bilinear gave the same image")

    # training: the red material 0.1 redder in the target; the material
    # colours train (the camera and the geometry sit on knife edges of this
    # scene, the x = 0 plane and the horizon, where any step flips pixels)
    m = scene_dev.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = rtt.render_color(scene_dev._replace(
            materials=m._replace(diffuse=m.diffuse._replace(r=red))), cfg_main).to_array()

    def colours(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    def train(name, cfg, target, lr, want, base=scene_dev):
        """Five sgd_train_step on the material colours of ``base`` against
        ``target``; the launches (K1, K2, K3, K4) must be ``want``. Returns
        the losses and the launches."""
        bm = base.materials
        s = base._replace(materials=bm._replace(diffuse=colours(bm.diffuse),
                                                specular=colours(bm.specular)))
        kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = 0
        t0 = time.time()
        losses = []
        for _ in range(5):
            s, loss = sgd_train_step(s, cfg, target, lr=lr)
            losses.append(float(loss))
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = (kt.LAUNCHES, kb.LAUNCHES, km.LAUNCHES, kmb.LAUNCHES)
        print(f"main path, {name}: 5 sgd_train_step at {cfg.xres}x{cfg.yres} in {train_s:.2f} s, "
              f"launches (K1 trace, K2 trace backward, K3 march, K4 march backward) {launches}, "
              f"losses " + ", ".join(f"{v:.6g}" for v in losses)
              + f"; red {float(s.materials.diffuse.r[2].detach()):.4f} (target 0.9, start 0.8)")
        if launches != want:
            raise SystemExit(f"chip_smoke: want launches {want} in {name}, got {launches}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"chip_smoke: the {name} loss did not fall: {losses}")
        return losses, launches

    _, train_launches = train("training", cfg_main, target, TRAIN_LR, (5, 5, 0, 0))
    tex_bi = tex_scenes[1]
    with torch.no_grad():
        tex_target = rtt.render_color(tex_bi._replace(materials=tex_bi.materials._replace(
            diffuse=tex_bi.materials.diffuse._replace(r=red))), cfg_main).to_array()
    tex_losses, tex_train_launches = train("textured training (Bilinear)", cfg_main, tex_target,
                                           TRAIN_LR, (5, 5, 0, 0), base=tex_bi)
    if not all(b < a for a, b in zip(tex_losses, tex_losses[1:])):
        raise SystemExit(f"chip_smoke: the textured training loss did not fall at every step: "
                         f"{tex_losses}")
    with torch.no_grad():
        march_target = rtt.render_color(scene_dev._replace(
            materials=m._replace(diffuse=m.diffuse._replace(r=red))), cfg_march).to_array()
    march_losses, march_train_launches = train("march training", cfg_march, march_target,
                                               MARCH_TRAIN_LR, (0, 0, 5, 5))
    if not all(b < a for a, b in zip(march_losses, march_losses[1:])):
        raise SystemExit(f"chip_smoke: the march training loss did not fall at every step: "
                         f"{march_losses}")

    # the gradient oracle at the trace main path's shape, held against K2
    rng = np.random.default_rng(0)
    g_oracle = rtt.Color(*(torch.from_numpy(rng.standard_normal((H, W)).astype(np.float32))
                           .to(dev) for _ in range(3)))
    kr.LAUNCHES = 0
    t0 = time.time()
    oracle, oracle_img = kr.render_grads_retrace(scene_dev, cfg_main, g_oracle,
                                                 return_primal=True)
    torch.cuda.synchronize()
    oracle_s = time.time() - t0
    retrace_launches = kr.LAUNCHES
    lanes = _build.load_cuda_library("trace_retrace").rt_trace_retrace_lanes()
    want_launches = -(-kr.n_out(scene_dev.objects.count) // lanes)
    # the oracle's use: the trace backward held against it (each was held
    # against plain autograd on these inputs in phase 3)
    retrace_err, retrace_leaf = leaf_err(
        "the gradient oracle", scene_dev, oracle,
        kb.render_grads_kernel(scene_dev, cfg_main, g_oracle))
    oracle_same = float((img(oracle_img) == img(kt.render_color_kernel(scene_dev, cfg_main)))
                        .all(-1).mean())
    print(f"main path, gradient oracle: render_grads_retrace {W}x{H} in {oracle_s:.2f} s, "
          f"{retrace_launches} re-trace launches ({lanes} lanes), largest leaf relative L2 "
          f"against the trace backward {retrace_err:.3g} ({retrace_leaf}), image bit-equal to "
          f"the trace kernel's on {oracle_same:.4%} of pixels")
    if retrace_launches != want_launches:
        raise SystemExit(f"chip_smoke: want {want_launches} re-trace launches, got "
                         f"{retrace_launches}")
    if not retrace_err <= GRAD_BUDGET:
        raise SystemExit(f"chip_smoke: the oracle and the trace backward differ in "
                         f"{retrace_leaf} by relative L2 {retrace_err:.3g}")
    if oracle_same < 1.0:
        raise SystemExit("chip_smoke: the oracle's image is not the trace kernel's")

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

    print(f"forward + backward {W}x{H}, default scene, default cfg ({card}):")
    def step(render, cfg, base=scene_dev):
        return training_step(torch, render, cfg, base)

    kernel_step = step(rtt.render_color, cfg_main)
    plain_step = step(kt.render_color_plain, cfg_plain)
    plain_reps = dict(warm=0, reps=1)
    step_runs = [("plain", cuda_ms(torch, plain_step, **plain_reps)),
                 ("kernel", cuda_ms(torch, kernel_step)), ("kernel", cuda_ms(torch, kernel_step)),
                 ("plain", cuda_ms(torch, plain_step, **plain_reps))]
    for name, ms in step_runs:
        c = cfg_main if name == "kernel" else cfg_plain
        print(f"  step ({name} at {c.xres}x{c.yres}: render, MSE, gradient of every float "
              f"leaf): {ms:.3f} ms")
    rng = np.random.default_rng(0)

    def planes(cfg):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                            .astype(np.float32)).to(dev) for _ in range(3)))

    g_main, g_plain = planes(cfg_main), planes(cfg_plain)

    def bwd_times(scene, name):
        """The backward kernel at the main path's shape, with the image, in
        turns through its wrapper (packing included) and alone on tables
        packed once; returns the means (wrapper, alone)."""
        tables = tuple(t.detach() for t in kt.pack_scene(scene))
        tex = kt.pack_textures(scene)
        fns = {"wrapper": lambda: kb.render_grads_kernel(scene, cfg_main, g_main,
                                                         return_primal=True),
               "alone": lambda: kb.render_grads_tables(tables, tex, cfg_main, g_main, True)}
        runs = [(k, cuda_ms(torch, fns[k])) for k in ("wrapper", "alone", "alone", "wrapper")]
        for k, ms in runs:
            print(f"  backward kernel, {name} {W}x{H} with the image, "
                  f"{'through its wrapper' if k == 'wrapper' else 'alone on packed tables'}: "
                  f"{ms:.3f} ms")
        return tuple(float(np.mean([ms for kind, ms in runs if kind == k])) for k in fns)

    bwd_ms, bwd_alone_ms = bwd_times(scene_dev, "untextured")
    _, _, adds, pairs, sites, most = ops["trace_bwd"]
    print(f"  host counts, {W}x{H}, cotangent 1 on every pixel: {adds} accumulator adds lane "
          f"by lane, {pairs} distinct (warp of 32 pixels, entry) pairs, {sites} sites "
          f"({sites / (W * H):.3f} a pixel, at most {most})")
    bwd_plain_ms = cuda_ms(torch, lambda: kb.render_grads_plain(scene_dev, cfg_plain, g_plain),
                           **plain_reps)
    print(f"  its plain version (autograd of the plain trace) at {pw}x{ph}: {bwd_plain_ms:.3f} ms")

    print(f"textured forward and training step {W}x{H}, default scene with bar.png ({card}):")
    with torch.no_grad():
        tex_runs = [(f, cuda_ms(torch, lambda f=f: kt.render_color_kernel(tex_scenes[f], cfg_main)))
                    for f in (0, 1, 1, 0)]
    tex_k_ms = {f: float(np.mean([ms for g, ms in tex_runs if g == f])) for f in (0, 1)}
    for f, ms in tex_runs:
        print(f"  kernel, {('Nearest', 'Bilinear')[f]}: {ms:.3f} ms/frame (plain "
              f"{tex_plain_ms[f]:.1f} ms, one frame, phase 3)")
    tex_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_main, base=tex_bi))
    print(f"  step through the kernels, Bilinear (render, MSE, gradient of every float leaf): "
          f"{tex_step_ms:.3f} ms")
    tex_bwd_ms, tex_bwd_alone_ms = bwd_times(tex_bi, "Bilinear")
    print(f"  its plain version at {pw}x{ph}: {tex_bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"gradient oracle {W}x{H}, default scene, default cfg ({card}):")
    oracle_fn = lambda: kr.render_grads_retrace(scene_dev, cfg_main, g_main,  # noqa: E731
                                                 return_primal=True)
    bwd_fn = lambda: kb.render_grads_kernel(scene_dev, cfg_main, g_main,  # noqa: E731
                                            return_primal=True)
    oracle_runs = [("oracle", cuda_ms(torch, oracle_fn)), ("backward", cuda_ms(torch, bwd_fn)),
                   ("backward", cuda_ms(torch, bwd_fn)), ("oracle", cuda_ms(torch, oracle_fn))]
    for name, ms in oracle_runs:
        print(f"  {name} kernel (wrapper, with the image): {ms:.3f} ms per cotangent")
    retrace_ms = float(np.mean([ms for n, ms in oracle_runs if n == "oracle"]))
    print(f"  their plain version (autograd of the plain trace) at {pw}x{ph}: "
          f"{bwd_plain_ms:.3f} ms (one call, above)")

    print(f"march + glow forward, default scene, default cfg ({card}):")
    with torch.no_grad():
        march_ms = {}
        for w, h in ((MW, MH), (W, H), (320, 240)):
            c = cfg_march.with_(xres=w, yres=h)
            march_ms[(w, h)] = cuda_ms(torch, lambda c=c: km.render_color_kernel(scene_dev, c))
            print(f"  kernel {w}x{h}: {march_ms[(w, h)]:.3f} ms/frame")
    print(f"  plain {MW}x{MH}: {march_plain_ms:.1f} ms (one frame, phase 3)")

    print(f"march + glow forward + backward {MW}x{MH}, default scene, default cfg ({card}):")
    march_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_march))
    march_plain_step_ms = cuda_ms(torch, step(km.render_color_plain, cfg_march_plain),
                                  **plain_reps)
    print(f"  step (march kernel + march backward kernel at {MW}x{MH}: render, MSE, gradient "
          f"of every float leaf): {march_step_ms:.3f} ms")
    print(f"  step (plain autograd with the implicit VJP at {pw_m}x{ph_m}, one call): "
          f"{march_plain_step_ms:.3f} ms")
    g_march = planes(cfg_march)
    march_bwd_ms = cuda_ms(torch, lambda: kmb.render_grads_kernel(scene_dev, cfg_march, g_march,
                                                                  return_primal=True))
    print(f"  march backward kernel alone at {MW}x{MH} (wrapper, with the image): "
          f"{march_bwd_ms:.3f} ms; its plain version at {pw_m}x{ph_m}: "
          f"{march_bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"floor tail on and off in turns, {MW}x{MH}, default scene, -m -g 1.0 ({card}):")
    tail_runs = []
    for tag, c in (("on", cfg_march), ("off", cfg_march_off), ("off", cfg_march_off),
                   ("on", cfg_march)):
        with torch.no_grad():
            k3_ms = cuda_ms(torch, lambda c=c: km.render_color_kernel(scene_dev, c))
        k4_ms = cuda_ms(torch, lambda c=c: kmb.render_grads_kernel(scene_dev, c, g_march,
                                                                   return_primal=True))
        step_ms = cuda_ms(torch, step(rtt.render_color, c))
        tail_runs.append((tag, k3_ms, k4_ms, step_ms))
        print(f"  tail {tag}: march kernel {k3_ms:.3f} ms/frame, march backward {k4_ms:.3f} ms "
              f"(with the image), march training step {step_ms:.3f} ms")
    for name in ("march_fwd", "march_bwd"):
        for tag, key in (("on", name), ("off", f"{name}_off")):
            n_ops, _, px_ops, passes, px_passes, never = ops[key]
            print(f"  counts, {name} {MW}x{MH}, tail {tag}: {n_ops} f32 operations, "
                  f"{passes} object passes, {never} marches ended by the never-converges "
                  f"test; the longest pixel {px_ops} operations, {px_passes} object passes")

    # roofline bounds from the operation counts of the main paths' frames
    bounds = {}
    for name, cfg, scene in (("trace_fwd", cfg_main, scene_dev),
                             ("march_fwd", cfg_march, scene_dev),
                             ("trace_bwd", cfg_main, scene_dev),
                             ("march_bwd", cfg_march, scene_dev),
                             ("trace_fwd_textured", cfg_main, tex_scenes[0]),
                             ("trace_bwd_textured", cfg_main, tex_bi)):
        n_ops, fetched = ops[name][:2]
        nbytes = io_bytes(scene, cfg) + texel_bytes(scene, fetched)
        if "_bwd" in name:
            # + the cotangent planes read, the block written
            nbytes += 3 * 4 * cfg.xres * cfg.yres + 4 * (scene.objects.count + 1) * kb.GRAD_COLS
        bounds[name] = roofline(n_ops, nbytes)
        print(f"  bound, {name} {cfg.xres}x{cfg.yres}: {n_ops} f32 operations, {nbytes} bytes "
              f"({fetched} B of texel fetches) -> {bounds[name][0]:.4f} ms ({bounds[name][1]})")
        if name.startswith("march"):  # the step-by-step march's work, a diagnostic
            off_ops = ops[f"{name}_off"][0]
            print(f"    with the floor tail off (diagnostic, not the bound): {off_ops} f32 "
                  f"operations -> {roofline(off_ops, nbytes)[0]:.4f} ms")
    # the re-trace oracle computes the trace backward's function on the same
    # inputs, so the least time for its work is the trace backward's bound;
    # its forward-mode operations over every launch are only a diagnostic
    bounds["trace_retrace"] = bounds["trace_bwd"]
    dual_ops = ops["trace_retrace"][0]
    print(f"  bound, trace_retrace {W}x{H}: the trace backward's, {bounds['trace_retrace'][0]:.4f} "
          f"ms ({bounds['trace_retrace'][1]}); its forward-mode operations over "
          f"{retrace_launches} launches (diagnostic, not the bound): {dual_ops} -> "
          f"{roofline(dual_ops, 0)[0]:.4f} ms")

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
        "name": "trace_fwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:618",
        "launches": tex_launches, "max_abs_err": max(tex_err.values()), "ms": tex_k_ms[0],
        "plain_ms": tex_plain_ms[0],
        "bound_ms": bounds["trace_fwd_textured"][0],
        "bound_by": bounds["trace_fwd_textured"][1],
        "library_ms": None,
    }, {
        "name": "march_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_march.py:814",
        "launches": march_launches, "max_abs_err": march_max_abs_err,
        "ms": march_ms[(MW, MH)], "plain_ms": march_plain_ms,
        "bound_ms": bounds["march_fwd"][0], "bound_by": bounds["march_fwd"][1],
        "library_ms": None,
    }, {
        "name": "trace_bwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:563",
        "launches": train_launches[1], "max_abs_err": bwd_max_err, "ms": bwd_ms,
        "alone_ms": bwd_alone_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["trace_bwd"][0], "bound_by": bounds["trace_bwd"][1],
        "library_ms": None,
    }, {
        "name": "trace_bwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:563",
        "launches": tex_train_launches[1], "max_abs_err": tex_bwd_err, "ms": tex_bwd_ms,
        "alone_ms": tex_bwd_alone_ms, "plain_ms": tex_bwd_plain_ms,
        "bound_ms": bounds["trace_bwd_textured"][0],
        "bound_by": bounds["trace_bwd_textured"][1],
        "library_ms": None,
    }, {
        "name": "march_bwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:1060",
        "launches": march_train_launches[3], "max_abs_err": march_bwd_max_err,
        "ms": march_bwd_ms, "plain_ms": march_bwd_plain_ms,
        "bound_ms": bounds["march_bwd"][0], "bound_by": bounds["march_bwd"][1],
        "library_ms": None,
    }, {
        "name": "trace_retrace", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_retrace.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1555",
        "launches": retrace_launches, "max_abs_err": retrace_max_err, "ms": retrace_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["trace_retrace"][0], "bound_by": bounds["trace_retrace"][1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
