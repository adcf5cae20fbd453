#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_rust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the builds of the CUDA kernels from ray_rust_tpu_torch/csrc, all at once:
   the trace kernel (K1), the march kernel (K3), the trace backward (K2),
   the march backward (K4), each also in its global-table build (``_global``,
   for scenes too large for shared memory), the re-trace gradient oracle
   (K5) and the scene pack with its pull-back (one library, two kernels);
   ptxas registers, stack and spills (K1 with and without its cull, K1b, at
   task stacks of 16 and 64; the trace backward built for three record
   caps, one kernel each, and the 64-task stack at two; the march backward
   in two instances, untextured and textured; KERNEL_COUNTS), and the trace
   backward's TraceBody instances and the march backward's untextured
   instance must keep theirs (PINNED_PTXAS); each kernel must be one
   function (ptxas reports no device function beside the kernel:
   everything is inlined, the texture fetch too);
3. each kernel against its plain PyTorch version on the card, and against
   its full-depth golden image, each within the JAX package's golden budget:
   at most 2% of pixels off by more than 1e-3, mean difference at most 0.01;
   also at the shape of its main path; the trace kernel with image textures
   (K1a: the default scene with the goldens' 256x256 noise texture as
   ``bar.png``) against its plain version at 1920x1080 in Nearest and in
   Bilinear, and against the two textured goldens (mean at most 0.015,
   tests/test_parity.py:192-214); the pack kernel against
   ``kernel_trace.pack_scene`` (and the meta rows of ``pack_textures``) bit
   for bit, and the pull-back kernel against autograd of ``pack_scene`` on
   a seeded block, bit for bit but within relative L2 1e-6 on the materials
   two objects share (summation order), on the default scene, the Bilinear
   textured one and 101 objects; the trace backward against torch
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
   boundary: tests/test_pallas.py:238-261); the textured march kernel (K3
   reading the atlas) on the default scene with ``bar.png`` at 1280x720 in
   Nearest and in Bilinear: with the floor tail off bit-equal to the plain
   textured march, with it on within the golden budget of it (a shaded
   march takes no tail toward a textured floor), and on against off
   knife-edge-only at 320x240; the textured march backward (K4's textured
   instance) against torch autograd of the plain textured march under the
   march contract above at 160x120 (a 2000-step budget) and at the march
   training path's shape, in Nearest and in Bilinear, its image the march
   kernel's; the re-trace gradient oracle against torch autograd of the
   plain trace, per scene leaf within relative L2 0.01, at 320x240 (its
   image bit-equal to the trace kernel's) and, beside the trace backward
   against the same plain call, at the gradient oracle's main path's shape
   and cotangent planes;
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: trace mode, the CLI at 1920x1080 then ``render_u8`` at
   three camera poses (three viewer requests), one trace kernel launch and
   one pack launch per render; march mode with glow, the CLI at 1280x720
   ``-m -g 1.0`` then three ``render_u8`` requests, one march kernel launch
   and one pack launch per render;
   textured trace, the CLI at 1920x1080 in a directory holding ``bar.png``
   (its floor must differ from the untextured one) then a Bilinear
   ``render_u8``, one trace kernel launch each; textured march
   (configuration 3 of BASELINE.md), the CLI at 1280x720 ``-m -g 1.0`` where
   ``bar.png`` lies (its PNG ``render_u8`` of the textured scene, its floor
   not the untextured one's) then a Bilinear ``render_u8``, one march
   kernel and one pack launch each; training, five
   ``sgd_train_step``s at 1920x1080 on the default scene against a target
   whose red material is 0.1 redder, one trace, one backward, one pack and
   one pull-back kernel launch per step, the loss falling; the same on the Bilinear textured
   scene, the loss falling at every step; march training with glow, five
   ``sgd_train_step``s at 1280x720 ``-m -g 1.0`` against the same
   kind of target, one march and one march backward launch per step, the
   loss falling at every step; the same on the Bilinear textured scene (K4's
   textured instance), the loss falling at every step, and K4's image at
   1280x720 the march kernel's bit for bit; the gradient oracle,
   ``render_grads_retrace``
   at 1920x1080 on the default scene with cotangent planes from numpy seed
   0, one re-trace launch, its cotangent against the trace
   backward's per scene leaf within relative L2 0.01 (the JAX oracle test's
   budget, tests/test_pallas_bwd.py:250-260) and its image bit-equal to the
   trace kernel's on every pixel; scene files (configuration 4 of
   BASELINE.md): ``serialize_scene`` writes the 101-object scene, which
   loads back to the same leaves, then the CLI's ``-d`` on it in trace mode
   at 1920x1080 and in march + glow at 1280x720 (one kernel and one pack
   launch each, the PNG ``render_u8`` of the file's scene under its caps),
   ``-s`` on the loaded scene (its file loads back to the same leaves bit for
   bit), and the file with two camera keyframes at 320x240 (the JAX
   package's frame count, one frame file and one trace launch a frame), the
   trace request's one K1 launch taking K1b's cull;
4b. many objects: K1 with its cull (K1b) against K1 with
   ``pallas_prefilter`` off, bit for bit, and timed in turns (on, off, off,
   on; 3 warm-ups, 10 frames), at 1920x1080 on configuration 4's 101 objects
   and on 1 024 (past 512), with the mean primary and shadow candidate
   lists from K1's counting build; K1 with the cull against the plain trace
   at 1920x1080 on the 101 objects (its ``plain_ms``) and at 320x240 on the
   1 024; on the 1 024 with glow K3 against the plain march at 160x120 (a
   2000-step budget); K2 and K4 against autograd of the plain versions at
   160x120 within relative L2 0.01 and 0.02 per scene leaf, each in the
   build its wrapper launches (global tables) and in its shared-table
   build; each of K1-K4 in its two table regimes (the shared-table build
   and the ``_global`` one) on the same packed words, the images bit for
   bit and the backwards' cotangent blocks within relative L2
   REGIME_REL_L2, and timed in turns, at its threshold (``SHARED_TABLE_MAX``
   objects, where both fit its launch shape; K3's 1 200 is past the 1 024)
   and at 1 024 objects at the main paths' shapes (K1 and K2 1920x1080, K3
   and K4 1280x720); a 1 024-object scene file through ``-d`` at 1920x1080
   (one K1 launch with the cull); K1 at ``max_reflections=8`` (its 64-task
   stack) against the plain trace at 320x240, and timed at 1920x1080;
5. times with CUDA events: the trace forward at 1920x1080, kernel and plain
   version in turns (3 warm-ups, 10 timed renders each), then the kernel
   through its wrapper and alone on words packed once in turns, beside the
   share of 67 TFLOP/s it reaches with its object tests and with the
   shading and sky operations its counting build counts (a diagnostic);
   the packing by events and by the host's clock (100 calls enqueued): the
   pack kernel untextured and textured, the pull-back kernel and their
   plain versions; the forward and backward step at 1920x1080 through the
   kernels twice by events, then by the host's clock (20 steps enqueued)
   and the card's busy time and idle share from a ``torch.profiler``
   trace, its plain twin phase 3's plain autograd of the same render (one
   call, ~32 s at 1080p); the backward kernel through its wrapper and alone
   (on words packed once) in turns, beside the host counts of its
   accumulator's adds, their distinct (warp, entry) pairs and the sites
   (3 warm-ups, 10 timed calls each), its plain version phase 3's call;
   the march forward and backward step at 1280x720 through the march
   kernels (3 warm-ups, 10 timed calls), its plain twin phase 3's plain
   autograd at 1280x720, the march backward alone (3 warm-ups, 10 timed
   calls), its plain version that same call; the march kernel at
   1280x720, 1920x1080 and 320x240 (3 warm-ups, 10 timed renders each), the
   plain march once at 1280x720 (the comparison of phase 3: a plain frame
   takes tens of seconds at any size); the textured trace
   kernel at 1920x1080 in both filters, the textured training step and the
   backward kernel through its wrapper and alone on the Bilinear scene (3
   warm-ups, 10 timed calls;
   their plain versions once, in phase 3); the textured march kernel and
   the textured march backward at 1280x720 in Nearest and in Bilinear
   beside the untextured ones in turns, and the textured march step
   (Bilinear) (3 warm-ups, 10 timed calls; their plain versions once, in
   phase 3), and the scene-file requests' wall times; the re-trace oracle
   through its
   wrapper and alone on words packed once, and the trace backward, at
   1920x1080 in turns (3 warm-ups, 10 timed calls each; their plain version
   is the trace backward's, timed above), beside the oracle's host counts:
   its Dual passes (their mean, their most, and the mean over rows of 32
   pixels of the longest) and the pixels by their distinct winners; each
   kernel's roofline bound from the operation count of its main path's
   frame, which the kernel's body built for the host with -DRT_COUNT_OPS
   counts on the CPU while phases 3 and 4 run (the same body, bit for bit,
   as the card runs); the re-trace oracle's bound is the trace backward's,
   since it computes the same function on the same inputs (its value
   pass's and forward-mode operations, counted the same way, are printed
   beside it as a diagnostic); the floor tail on and off in turns (on, off,
   off, on) at 1280x720: the march kernel, the march backward and the march
   training step (3 warm-ups, 10 calls each), beside the longest pixel's
   operations and object passes from the counting builds, on and off (the
   march bounds are the tail's counts; the step-by-step ones are printed as
   a diagnostic); K1b's bound from the counting build with the cull on the
   101 objects (and on 1 024, printed); each phase's wall time.

The last two lines are JSON: the kernel table, then
``{"ok": true, "device": {...}}``. Each kernel's ``ms`` is its time through
its public wrapper (for K1, K2 and K5 packing included); the trace
backward's two entries and the re-trace oracle's also give ``alone_ms``,
the kernel alone on the pack kernel's words packed once (``launch_words``).
The pack kernel's and the
pull-back's entries are timed on the default scene, their launches counted
in the five trace training steps. ``trace_fwd_cull`` (K1b) is K1 with its
cull on configuration 4's 101 objects at 1920x1080 (``off_ms``: with
``pallas_prefilter`` off), its launches those of the ``-d`` trace request
that took the cull, its ``max_abs_err`` against K1 without the cull.
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
# ptxas figures the trace backward (one kernel a record cap: 16, 64, 192)
# and the march backward keep while the re-trace oracle, which shares their
# frame (csrc/bwd_kernel.cuh) and the trace body, changes, and while K1's
# cull (K1b), the deep task stack and the global-table builds are added
# beside them: registers, stack frame, spill stores and spill loads in
# bytes, by kernel (PERF.md §6)
PINNED_PTXAS = {"trace_bwd": [(119, 2512, 0, 0), (119, 7504, 0, 0), (119, 20816, 0, 0)],
                "march_bwd": [(128, 8168, 4188, 5512)]}
# The kernels of a library whose figures are pinned, by a part of their
# mangled names: the trace backward's TraceBody<CAP> (its DeepTraceBody<CAP>
# instances, with the 64-task stack, are reported beside them), the march
# backward's untextured instance (MarchBody<false>; its textured one,
# MarchBody<true>, is reported beside it)
PINNED_KERNELS = {"trace_bwd": "9TraceBodyI", "march_bwd": "MarchBodyILb0E"}
# The kernels each library holds, its global-table build the same: K1 with
# and without K1b's cull at task stacks of 16 and 64, K2 at its three record
# caps and, for 64 and 192, with the deep stack, K4 untextured and textured
KERNEL_COUNTS = {"trace_fwd": 4, "trace_fwd_global": 4, "march_fwd": 1, "march_fwd_global": 1,
                 "trace_bwd": 5, "trace_bwd_global": 5, "march_bwd": 2, "march_bwd_global": 2,
                 "trace_retrace": 1, "pack_scene": 2}
# The largest relative L2 between a backward's cotangent blocks from its two
# table regimes on the same inputs: their atomics add in different orders
# (2.7e-6 to 4.2e-6 for K2 and K4 on 640 and 1 024 objects, PERF.md §6),
# twenty times over
REGIME_REL_L2 = 1e-4
# The many-object scenes: BASELINE.md configuration 4's 101 objects and
# 1 024 (past 512); their plain references run at the smallest shapes the
# checks need (the plain trace loops over the objects in Python)
MANY_SMALL = (320, 240)  # K1 against the plain trace on 1 024 objects
MANY_GRAD = (160, 120)  # K3, K2 and K4 against the plain versions on 1 024 objects
# frames per keyframe = duration / FRAME_STEP (ray_rust_tpu/animation.py:22)
FRAME_STEP = 0.5


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
    return spheres_build(rtt, seed, n_spheres, glow_dist)[0]


def spheres_build(rtt, seed, n_spheres, glow_dist=0.0):
    """:func:`spheres_scene` with its ``SceneMeta``."""
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
    return rtt.build_scene(mats, objs, (0.0, 0.0, -400.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0))


def ptxas_figures(log, kernel=""):
    """Each kernel's (registers, stack frame, spill stores, spill loads)
    in a ``ptxas -v`` log, in the log's order, of the kernels whose mangled
    names hold ``kernel``."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        if kernel not in chunk.split("'", 1)[0]:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        out.append((int(regs.group(1)), *map(int, frame.groups())))
    return out


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


def count_ops(name, mod, cfg, texture_dir=".", texture_filter=0, scene=None):
    """The f32 operations kernel ``name``'s body (``"trace"`` or
    ``"march"``) takes on the default scene (or the CPU ``scene``) under
    ``cfg``, textured from ``texture_dir``, and the texel bytes its texture
    fetches read: its host build with -DRT_COUNT_OPS, run on the CPU. A
    march body also gives the most operations of one pixel, the object
    passes and the most passes of one pixel and the marches the
    never-converges test ended (``kernel_march.OPS_SLOTS`` counts in all);
    the trace body, where it takes K1b's cull (above 64 objects), the
    objects the cull tested, the primary candidates scanned and the scans,
    and the shadow candidates scanned and the scans (eight counts in
    all)."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops.rays import fov_scales

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    if scene is None:
        scene = _host_scene(texture_dir, texture_filter)
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)  # held until the call returns
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32)
    ops = torch.zeros(max(km.OPS_SLOTS, 8), dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    cpu = torch.device("cpu")
    args = (kt.launch_args(cfg, tex, cpu, scene.objects.count) if mod is kt
            else mod.launch_args(cfg, tex, cpu))
    getattr(lib, f"rt_{name}_host")(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
        sx, sy, *args, *(plane.data_ptr() for plane in out), ops.data_ptr())
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
    args = mod.launch_args(cfg, tex, torch.device("cpu"))
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
    """The re-trace oracle's counts for one cotangent on the default scene
    under ``cfg``: its host build with -DRT_COUNT_OPS, all
    ``kernel_trace_retrace.OPS_SLOTS`` (the value pass's object tests and
    every forward-mode operation with its tangents, the Dual passes, the
    most passes of one pixel, the sum over rows of 32 pixels of their
    longest pixel's passes, the histogram of distinct winners a pixel).
    The operations are a diagnostic: the oracle's bound is the trace
    backward's, whose function it computes."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    lib = _build.build_host_library(_build.BUILD_DIR, "trace_retrace", count_ops=True)
    scene = _host_scene(".", 0)
    g = [torch.zeros((cfg.yres, cfg.xres), dtype=torch.float32) for _ in range(3)]
    ops = torch.zeros(kr.OPS_SLOTS, dtype=torch.int64)
    tables = kt.pack_scene(scene)  # held until the call returns
    kr.launch_all(lib.rt_trace_retrace_host, [t.data_ptr() for t in tables], scene.objects.count,
                  torch.device("cpu"), cfg, g, False, (ops.data_ptr(),))
    return tuple(int(v) for v in ops)


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


def device_busy(torch, fn, reps=10):
    """The card's busy time and span per call of ``fn`` over ``reps`` calls
    after 3 warm-ups, in ms, from a ``torch.profiler`` trace of the card
    alone, and its kernels, copies and sets per call by name: busy is the
    union of them, the span runs from the first one's start to the last
    one's end. (0, 0, {}) where the trace holds no device activity."""
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
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    if not spans:
        return 0.0, 0.0, {}
    busy, end = 0.0, spans[0][0]
    for a, b in spans:  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    names = {}
    for e in device:
        names[e["name"]] = names.get(e["name"], 0) + 1
    return (busy / 1e3 / reps, (end - spans[0][0]) / 1e3 / reps,
            {k: n / reps for k, n in names.items()})


def host_ms(torch, fn, reps=100):
    """The host's clock per call of ``fn`` over ``reps`` calls after 3
    warm-ups, without waiting for the card inside the loop: the enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def pack_bytes(scene):
    """Bytes the pack must move: each leaf it reads once (the objects' 10
    columns, the materials' 15, the camera's 7 and the light's 3, the
    textures' widths and heights), its words written once."""
    from ray_rust_tpu_torch.ops import kernel_pack as kp

    n, m, n_tex, _ = kp.sizes(scene)
    return 4 * (10 * n + 15 * m + 10 + 2 * n_tex) + 4 * kp.pack_words(n, n_tex)


def pull_back_bytes_ops(scene):
    """Bytes the pull-back must move (the block and the material indices
    read once, a cotangent for each element of the scene's float leaves
    written once) and its f32 operations: each object adds its 12 material
    columns the tables read once."""
    from ray_rust_tpu_torch.ops import kernel_pack as kp

    n = scene.objects.count
    written = sum(t.numel() for t in kp.float_leaves(scene))
    return 4 * ((n + 1) * kp.GRAD_COLS + n) + 4 * written, 12 * n


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


# Two keyframes spliced into a scene file: one slerped to its pose, one
# looking at the mirror sphere (tests/test_serialize.py:74-81's form)
MOTION = """camera_motion:
- camera:
    position: {x: 40.0, y: 0.0, z: -400.0}
    pyr: {x: 0.1, y: -1.5707964, z: -1.5707964}
  velocity: {x: 10.0, y: 0.0, z: 0.0}
  duration: 1.0
- camera:
    position: {x: 80.0, y: 20.0, z: -380.0}
    pyr: {x: 0.0, y: -1.5707964, z: -1.5707964}
  velocity: {x: 0.0, y: 0.0, z: 0.0}
  camera_target: {x: 0.0, y: 0.0, z: 300.0}
  duration: 1.5
"""


def scene_files(torch, rtt, cli, kt, km, kp, built):
    """Configuration 4: the scene ``built`` (a scene and its meta) written
    by ``serialize_scene``, then the CLI's ``-d`` on it in trace mode at
    1920x1080 and in march + glow at 1280x720 (one kernel and one pack
    launch each, the PNG ``render_u8`` of the loaded scene under the file's
    caps), ``-s`` on the loaded scene (its file loads back to the same
    leaves, bit for bit, as the scene written), and a file with two camera
    keyframes at 320x240, whose frames must be the JAX package's count for
    the file (the sum of duration / FRAME_STEP, as ray_rust_tpu/animation.py
    renders them), one trace launch each. Returns each request's wall time
    in seconds and the trace request's K1 launches that took K1b's cull."""
    from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
    from ray_rust_tpu_torch.utils.image import load_png

    def leaves(scene):
        return rtt.scene_to_numpy(scene)

    def same_leaves(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    scene, meta = built
    wall = {}
    with tempfile.TemporaryDirectory() as sd:
        path = os.path.join(sd, "spheres.yaml")
        with open(path, "w") as f:
            f.write(serialize_scene(scene, meta))
        with open(path) as f:
            loaded, _, caps = deserialize_scene(f.read())
        if not same_leaves(leaves(loaded), leaves(scene)):
            raise SystemExit("chip_smoke: the scene file does not load back to its scene")
        for name, (w, h), march, mod, other in (("trace", (W, H), False, kt, km),
                                                ("march + glow", (MW, MH), True, km, kt)):
            png_path = os.path.join(sd, "out.png")
            kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = kt.CULL_LAUNCHES = 0
            t0 = time.time()
            argv = [str(w), str(h), "-d", path, "-o", png_path] + (["-m", "-g", "1.0"] if march
                                                                   else [])
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall[name] = time.time() - t0
            launches = (mod.LAUNCHES, other.LAUNCHES, kp.LAUNCHES)
            if not march:  # above 64 objects K1 takes K1b's cull
                cull_launches = kt.CULL_LAUNCHES
                print(f"  of them with K1b's cull: {cull_launches}")
                if cull_launches != (scene.objects.count > kt.CULL_MIN_OBJECTS):
                    raise SystemExit(f"chip_smoke: -d trace: {cull_launches} K1 launches took "
                                     f"the cull")
            cfg = rtt.RenderConfig(xres=w, yres=h, use_raymarching=march,
                                   glow_effect=1.0 if march else None, **caps)
            png = load_png(png_path)
            print(f"main path, -d {name} (configuration 4, {scene.objects.count} objects): CLI "
                  f"{w}x{h} in {wall[name]:.2f} s, launches (kernel, other kernel, pack) "
                  f"{launches}")
            if rc != 0 or launches != (1, 0, 1):
                raise SystemExit(f"chip_smoke: -d {name}: CLI exit {rc}, launches {launches}")
            if not np.array_equal(png, rtt.render_u8(loaded, cfg)) or png.std() < 10:
                raise SystemExit(f"chip_smoke: -d {name}: the PNG is not render_u8 of the file's "
                                 f"scene")
        copy = os.path.join(sd, "copy.yaml")
        t0 = time.time()
        rc = cli.main(["320", "240", "-d", path, "-s", copy, "-o", os.path.join(sd, "s.png")])
        torch.cuda.synchronize()
        wall["-s"] = time.time() - t0
        with open(copy) as f:
            again = deserialize_scene(f.read())[0]
        ok = rc == 0 and same_leaves(leaves(again), leaves(loaded))
        print(f"main path, -s on the loaded scene: CLI 320x240 in {wall['-s']:.2f} s, its file "
              f"loads back to the same leaves bit for bit: {ok}")
        if not ok:
            raise SystemExit("chip_smoke: -s did not round-trip the loaded scene")
        with open(path) as f:
            text = f.read().replace("camera_motion: []\n", MOTION)
        motion = os.path.join(sd, "motion.yaml")
        with open(motion, "w") as f:
            f.write(text)
        want = sum(int(d / FRAME_STEP) for d in (1.0, 1.5))  # MOTION's durations
        kt.LAUNCHES = km.LAUNCHES = 0
        t0 = time.time()
        rc = cli.main(["320", "240", "-d", motion, "-o", os.path.join(sd, "frame")])
        torch.cuda.synchronize()
        wall["camera_motion"] = time.time() - t0
        files = sorted(n for n in os.listdir(sd) if n.startswith("frame"))
        frames = [load_png(os.path.join(sd, f"frame{i}.png")) for i in range(want)
                  if f"frame{i}.png" in files]
        print(f"main path, camera_motion at 320x240: {len(files)} frames (the JAX package's "
              f"count: {want}) in {wall['camera_motion']:.2f} s, {kt.LAUNCHES} trace launches")
        if (rc != 0 or sorted(files) != sorted(f"frame{i}.png" for i in range(want))
                or kt.LAUNCHES != want or km.LAUNCHES != 0):
            raise SystemExit(f"chip_smoke: camera_motion: CLI exit {rc}, frames {files}, "
                             f"{kt.LAUNCHES} trace launches, want {want}")
        if any(f.shape != (240, 320, 3) for f in frames) or np.array_equal(frames[0], frames[-1]):
            raise SystemExit("chip_smoke: camera_motion: the frames are not a moving camera's")
    return wall, cull_launches


def cli_file(torch, rtt, cli, kt, kp, built, w, h):
    """The CLI's ``-d`` on the scene ``built`` (scene, meta) written by
    ``serialize_scene``, in trace mode at w x h: one K1 launch, with K1b's
    cull above 64 objects, and one pack, the PNG ``render_u8`` of the loaded
    scene. Returns the request's wall time in seconds and its K1 launches
    that took the cull."""
    from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
    from ray_rust_tpu_torch.utils.image import load_png

    scene, meta = built
    with tempfile.TemporaryDirectory() as sd:
        path, png_path = os.path.join(sd, "many.yaml"), os.path.join(sd, "out.png")
        with open(path, "w") as f:
            f.write(serialize_scene(scene, meta))
        kt.LAUNCHES = kp.LAUNCHES = kt.CULL_LAUNCHES = 0
        t0 = time.time()
        rc = cli.main([str(w), str(h), "-d", path, "-o", png_path])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = (kt.LAUNCHES, kt.CULL_LAUNCHES, kp.LAUNCHES)
        with open(path) as f:
            loaded, _, caps = deserialize_scene(f.read())
        png = load_png(png_path)
        print(f"main path, -d trace ({scene.objects.count} objects): CLI {w}x{h} in {wall:.2f} s, "
              f"launches (K1, of them with the cull, pack) {launches}")
        if rc != 0 or launches != (1, 1, 1):
            raise SystemExit(f"chip_smoke: -d {scene.objects.count} objects: CLI exit {rc}, "
                             f"launches {launches}")
        want = rtt.render_u8(loaded, rtt.RenderConfig(xres=w, yres=h, **caps))
        if not np.array_equal(png, want) or png.std() < 10:
            raise SystemExit(f"chip_smoke: -d {scene.objects.count} objects: the PNG is not "
                             f"render_u8 of the file's scene")
    return wall, launches[1]


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
    from ray_rust_tpu_torch.ops import kernel_pack as kp
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
                   "trace_retrace": counting.submit(count_retrace_ops, cfg_main),
                   "march_fwd_textured": counting.submit(count_ops, "march", km, cfg_march,
                                                         tex_dir, 0),
                   "march_fwd_textured_bilinear": counting.submit(count_ops, "march", km,
                                                                  cfg_march, tex_dir, 1),
                   "march_bwd_textured": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                         cfg_march, tex_dir, 1),
                   # K1 with K1b's cull on configuration 4's 101 objects and on 1 024
                   "trace_fwd_cull": counting.submit(
                       count_ops, "trace", kt, cfg_main,
                       scene=spheres_scene(rtt, 11, 100).to(torch.device("cpu"))),
                   "trace_fwd_cull_1024": counting.submit(
                       count_ops, "trace", kt, cfg_main,
                       scene=spheres_scene(rtt, 11, 1023).to(torch.device("cpu")))}

    # 2. the builds, one nvcc each, all started together
    t0 = time.time()
    stems = tuple(KERNEL_COUNTS)
    _build.prebuild(stems)
    print(f"build: {', '.join(f'{stem}.cu' for stem in stems)} with nvcc in "
          f"{time.time() - t0:.1f} s, each: " + ", ".join(
              f"{stem} {_build.build_seconds[stem]:.0f} s" for stem in stems
              if stem in _build.build_seconds))
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
        got = ptxas_figures(_build.build_logs[stem], PINNED_KERNELS[stem])
        print(f"  {stem}: (registers, stack, spill stores, spill loads) {got}, pinned {want}")
        if sorted(got) != sorted(want):
            raise SystemExit(f"chip_smoke: {stem}.cu left its ptxas figures {want}: {got}")
    # the march backward's textured instance (MarchBody<true>), one kernel
    march_bwd_tex_ptxas = ptxas_figures(_build.build_logs["march_bwd"], "MarchBodyILb1E")
    print(f"  march_bwd, textured instance: (registers, stack, spill stores, spill loads) "
          f"{march_bwd_tex_ptxas}")
    if len(march_bwd_tex_ptxas) != 1:
        raise SystemExit("chip_smoke: march_bwd.cu does not hold its textured instance")
    # the instances beside the pinned ones: K1's (cull, stack), K2's deep
    # stack, the global-table builds
    for stem, frag, what in (
            ("trace_fwd", "", "K1: <no cull, 16>, <cull, 16>, <no cull, 64>, <cull, 64>"),
            ("trace_bwd", "13DeepTraceBodyI", "K2 with the 64-task stack: caps 192, 64"),
            ("trace_fwd_global", "", "K1 global tables: <no cull, 16>, <cull, 16>, "
                                     "<no cull, 64>, <cull, 64>"),
            ("march_fwd_global", "", "K3 global tables"),
            ("trace_bwd_global", "9TraceBodyI", "K2 global tables: caps 192, 64, 16"),
            ("trace_bwd_global", "13DeepTraceBodyI", "K2 global tables, 64-task stack: caps "
                                                     "192, 64"),
            ("march_bwd_global", "", "K4 global tables: untextured, textured")):
        print(f"  {stem}, {what}: {ptxas_figures(_build.build_logs[stem], frag)}")
    for stem, want in KERNEL_COUNTS.items():
        if len(ptxas_figures(_build.build_logs[stem])) != want:
            raise SystemExit(f"chip_smoke: {stem} does not hold its {want} kernels")

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
    phase_s = {"2": time.time() - t0}  # the phases' wall times, printed at the end
    t_phase = time.time()
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

    print("pack kernel vs pack_scene (bit for bit), pull-back kernel vs autograd of pack_scene:")
    pack_cases = [("default", default), ("textured Bilinear", tex_scenes[1]),
                  ("101 objects", spheres_scene(rtt, 11, 100))]
    pack_err, vjp_err = 0.0, 0.0
    for k, (name, scene) in enumerate(pack_cases):
        scene = scene.to(dev)
        tables, meta = kp.pack_tables(scene)
        plain_tex = kt.pack_textures(scene)
        pairs = list(zip(tables, kt.pack_scene(scene)))
        same = all(torch.equal(a.view(torch.int32), b.detach().view(torch.int32))
                   for a, b in pairs)
        same &= (meta is None) == (plain_tex is None) and (
            meta is None or torch.equal(meta, plain_tex[1]))
        if meta is not None and plain_tex is not None:
            pairs.append((meta, plain_tex[1]))
        tab_err = max(float((a.double() - b.detach().double()).abs().max()) for a, b in pairs)
        pack_err = max(pack_err, tab_err)
        n = scene.objects.count
        block = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n + 1, kb.GRAD_COLS)).astype(np.float32)).to(dev)
        counts = np.bincount(scene.objects.mat.cpu().numpy(),
                             minlength=scene.materials.pn.shape[0])
        worst, err = 0.0, 0.0
        for path, got, want in zip(
                [p for p, x in zip(rtt.scene_to_numpy(scene), scene.tensors())
                 if x.is_floating_point()],
                kp.pack_scene_vjp(scene, block),
                kp.pack_scene_vjp_plain(scene, kp.split_block(block, n))):
            a, b = got.cpu().numpy().astype(np.float64), want.cpu().numpy().astype(np.float64)
            err = max(err, float(np.abs(a - b).max()))
            shared = (counts > 1) if path.startswith("materials.") else np.zeros(a.shape, bool)
            if not np.array_equal(a[~shared], b[~shared]):
                raise SystemExit(f"chip_smoke: pull-back, {name}: {path} not bit-equal")
            if shared.any():
                worst = max(worst, float(np.linalg.norm(a[shared] - b[shared])
                                         / max(np.linalg.norm(b[shared]), 1e-30)))
        vjp_err = max(vjp_err, err)
        ok = same and worst <= 1e-6
        print(f"  {name}: tables and meta bit-equal {same} (max abs {tab_err:.3g}); pull-back "
              f"bit-equal on unshared entries, shared materials relative L2 {worst:.3g} "
              f"(budget 1e-6), max abs {err:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the pack kernels, {name}: outside their budget")

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

    print("textured march kernel (K3 reading the atlas) vs plain version: tail off bit for bit, "
          "tail on within the budget, on vs off knife-edge-only:")
    march_tex_err, march_tex_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        got, ref, march_tex_plain_ms[f] = both(tex_scenes[f], cfg_march, km)
        march_tex_err[f] = compare(f"march textured {fname} {MW}x{MH}, tail on", ref, got)
        off = img(km.render_color_kernel(tex_scenes[f], cfg_march_off))
        same = float((off == ref).all(-1).mean())
        print(f"  march textured {fname} {MW}x{MH}, tail off: bit-equal to the plain version on "
              f"{same:.4%} of pixels (plain {march_tex_plain_ms[f]:.1f} ms) -> "
              f"{'ok' if same == 1.0 else 'FAIL'}")
        if same < 1.0:
            raise SystemExit(f"chip_smoke: textured K3 ({fname}), tail off, is not its plain "
                             f"version")
        small = cfg_march.with_(xres=320, yres=240)
        knife_edge_only(f"textured {fname} tail on vs off 320x240",
                        img(km.render_color_kernel(tex_scenes[f], small)),
                        img(km.render_color_kernel(tex_scenes[f],
                                                   small.with_(march_floor_skip=False))))

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
            (bwd_max_err, retrace_max_err), bwd_plain_ms = grad_case(
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

    def march_grad_main(name, scene):
        """``grad_case`` at the march training path's frame, or the largest
        whose plain autograd graph fits; at that frame the plain image is the
        march kernel's with the tail off (bit for bit on this frame, phase
        3), a thousandth of the plain march's time. Returns the largest
        relative L2, the plain version's ms and the frame."""
        for pw_m, ph_m in ((MW, MH), (960, 540), (640, 360)):
            try:
                main_frame = (pw_m, ph_m) == (MW, MH)
                (err,), plain_ms = grad_case(
                    f"{name} {pw_m}x{ph_m}", scene, cfg_march.with_(xres=pw_m, yres=ph_m),
                    **{**mgrad, "agree_with": (
                        (lambda s, c: km.render_color_kernel(s, c.with_(march_floor_skip=False)))
                        if main_frame else km.render_color_plain)})
                return err, plain_ms, (pw_m, ph_m)
            except torch.cuda.OutOfMemoryError as e:
                print(f"  {name} {pw_m}x{ph_m}: the plain autograd graph does not fit the card: "
                      f"{e}")
                torch.cuda.empty_cache()
        raise SystemExit(f"chip_smoke: {name}: the plain march autograd graph fits at no shape "
                         f"tried")

    march_bwd_max_err, march_bwd_plain_ms, (pw_m, ph_m) = march_grad_main("march default",
                                                                          default)

    print("textured march backward (K4's textured instance) vs torch autograd of the plain "
          "textured march, its image vs the march kernel's:")
    # two small cases with a 2000-step budget (the plain march's time is its
    # longest lane's steps), then the march training path's frame
    cfg_tex_grad = rtt.RenderConfig(xres=160, yres=120, march_max_iter=2000, **glow)
    march_tex_bwd_err, march_tex_bwd_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        _, march_tex_bwd_plain_ms[f"{fname} 160x120"] = grad_case(
            f"march textured {fname} 160x120 march_max_iter=2000", tex_scenes[f], cfg_tex_grad,
            **mgrad)
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        march_tex_bwd_err[fname], march_tex_bwd_plain_ms[fname], march_tex_bwd_frame = (
            march_grad_main(f"march textured {fname}", tex_scenes[f]))

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
            kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = 0
            t0 = time.time()
            if cli.main(argv + ["-o", png_path]) != 0:
                raise SystemExit("chip_smoke: the CLI failed")
            frames = [rtt.render_u8(v, cfg) for v in views]
            torch.cuda.synchronize()
            main_s = time.time() - t0
            launches, stray, packs = mod.LAUNCHES, other.LAUNCHES, kp.LAUNCHES
            png = load_png(png_path)
        print(f"main path, {name}: CLI {cfg.xres}x{cfg.yres} + 3 render_u8 in {main_s:.2f} s, "
              f"{launches} kernel launches, {packs} pack launches")
        if launches != 4 or stray != 0 or packs != 4:
            raise SystemExit(f"chip_smoke: want 4 launches of the {name} kernel, 0 of the "
                             f"other and 4 of the pack on its main path, got {launches}, "
                             f"{stray} and {packs}")
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

    # configuration 3: the CLI's march + glow where bar.png lies (Nearest),
    # then one Bilinear request
    kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = 0
    t0 = time.time()
    os.chdir(tex_dir)
    try:
        rc = cli.main([str(MW), str(MH), "-m", "-g", "1.0", "-o", png_path])
    finally:
        os.chdir(cwd)
    frame_bi = rtt.render_u8(tex_scenes[1], cfg_march)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    march_tex_launches, stray, packs = km.LAUNCHES, kt.LAUNCHES, kp.LAUNCHES
    png = load_png(png_path)
    print(f"main path, textured march (configuration 3): CLI {MW}x{MH} -m -g 1.0 with bar.png + "
          f"1 Bilinear render_u8 in {main_s:.2f} s, {march_tex_launches} march kernel launches, "
          f"{packs} pack launches")
    if rc != 0 or march_tex_launches != 2 or stray != 0 or packs != 2:
        raise SystemExit(f"chip_smoke: the textured march path: CLI exit {rc}, want 2 march, 0 "
                         f"trace and 2 pack launches, got {march_tex_launches}, {stray} and "
                         f"{packs}")
    if not np.array_equal(png, rtt.render_u8(tex_scenes[0], cfg_march)):
        raise SystemExit("chip_smoke: the march CLI's PNG with bar.png is not the textured render")
    mfloor = slice(3 * MH // 4, MH)
    if np.array_equal(png[mfloor], rtt.render_u8(scene_dev, cfg_march)[mfloor]):
        raise SystemExit("chip_smoke: the march CLI did not texture the floor with bar.png")
    if np.array_equal(png, frame_bi):
        raise SystemExit("chip_smoke: textured march in Nearest and Bilinear gave the same image")

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
        ``target``; the launches (K1, K2, K3, K4, the pack, the pull-back)
        must be ``want``. Returns the losses and the launches."""
        bm = base.materials
        s = base._replace(materials=bm._replace(diffuse=colours(bm.diffuse),
                                                specular=colours(bm.specular)))
        kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = 0
        kp.LAUNCHES = kp.VJP_LAUNCHES = 0
        t0 = time.time()
        losses = []
        for _ in range(5):
            s, loss = sgd_train_step(s, cfg, target, lr=lr)
            losses.append(float(loss))
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = (kt.LAUNCHES, kb.LAUNCHES, km.LAUNCHES, kmb.LAUNCHES, kp.LAUNCHES,
                    kp.VJP_LAUNCHES)
        print(f"main path, {name}: 5 sgd_train_step at {cfg.xres}x{cfg.yres} in {train_s:.2f} s, "
              f"launches (K1 trace, K2 trace backward, K3 march, K4 march backward, pack, "
              f"pull-back) {launches}, "
              f"losses " + ", ".join(f"{v:.6g}" for v in losses)
              + f"; red {float(s.materials.diffuse.r[2].detach()):.4f} (target 0.9, start 0.8)")
        if launches != want:
            raise SystemExit(f"chip_smoke: want launches {want} in {name}, got {launches}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"chip_smoke: the {name} loss did not fall: {losses}")
        return losses, launches

    _, train_launches = train("training", cfg_main, target, TRAIN_LR, (5, 5, 0, 0, 5, 5))
    tex_bi = tex_scenes[1]
    with torch.no_grad():
        tex_target = rtt.render_color(tex_bi._replace(materials=tex_bi.materials._replace(
            diffuse=tex_bi.materials.diffuse._replace(r=red))), cfg_main).to_array()
    tex_losses, tex_train_launches = train("textured training (Bilinear)", cfg_main, tex_target,
                                           TRAIN_LR, (5, 5, 0, 0, 5, 5), base=tex_bi)
    if not all(b < a for a, b in zip(tex_losses, tex_losses[1:])):
        raise SystemExit(f"chip_smoke: the textured training loss did not fall at every step: "
                         f"{tex_losses}")
    with torch.no_grad():
        march_target = rtt.render_color(scene_dev._replace(
            materials=m._replace(diffuse=m.diffuse._replace(r=red))), cfg_march).to_array()
    march_losses, march_train_launches = train("march training", cfg_march, march_target,
                                               MARCH_TRAIN_LR, (0, 0, 5, 5, 5, 5))
    if not all(b < a for a, b in zip(march_losses, march_losses[1:])):
        raise SystemExit(f"chip_smoke: the march training loss did not fall at every step: "
                         f"{march_losses}")
    # the textured march step (Bilinear: its uv carries a gradient), and
    # K4's image at its shape K3's bit for bit
    with torch.no_grad():
        march_tex_target = rtt.render_color(tex_bi._replace(materials=tex_bi.materials._replace(
            diffuse=tex_bi.materials.diffuse._replace(r=red))), cfg_march).to_array()
    march_tex_losses, march_tex_train_launches = train(
        "textured march training (Bilinear)", cfg_march, march_tex_target, MARCH_TRAIN_LR,
        (0, 0, 5, 5, 5, 5), base=tex_bi)
    if not all(b < a for a, b in zip(march_tex_losses, march_tex_losses[1:])):
        raise SystemExit(f"chip_smoke: the textured march training loss did not fall at every "
                         f"step: {march_tex_losses}")
    g_tex = rtt.Color(*(torch.from_numpy(np.random.default_rng(3).standard_normal((MH, MW))
                                         .astype(np.float32)).to(dev) for _ in range(3)))
    _, tex_prim = kmb.render_grads_kernel(tex_bi, cfg_march, g_tex, return_primal=True)
    same = float((img(tex_prim) == img(km.render_color_kernel(tex_bi, cfg_march))).all(-1).mean())
    print(f"  textured march backward {MW}x{MH}: image bit-equal to the march kernel's on "
          f"{same:.4%} of pixels")
    if same < 1.0:
        raise SystemExit("chip_smoke: textured K4's image is not K3's")

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
    want_launches = 1  # one launch a cotangent
    # the oracle's use: the trace backward held against it (each was held
    # against plain autograd on these inputs in phase 3)
    retrace_err, retrace_leaf = leaf_err(
        "the gradient oracle", scene_dev, oracle,
        kb.render_grads_kernel(scene_dev, cfg_main, g_oracle))
    oracle_same = float((img(oracle_img) == img(kt.render_color_kernel(scene_dev, cfg_main)))
                        .all(-1).mean())
    print(f"main path, gradient oracle: render_grads_retrace {W}x{H} in {oracle_s:.2f} s, "
          f"{retrace_launches} re-trace launch ({lanes} lanes a pass), largest leaf relative L2 "
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

    file_s, cull_launches = scene_files(torch, rtt, cli, kt, km, kp, spheres_build(rtt, 11, 100))
    phase_s["3-4"] = time.time() - t_phase

    # 4b. many objects: K1b (the cull inside K1) against the full scan, the
    # scenes past 512 objects in K1-K4, max_reflections 8
    t_phase = time.time()
    print("many objects (K1b, the per-tile cull inside K1; more than 512 objects; "
          "max_reflections 8):")

    def k1_turns(name, scene, cfg):
        """K1 through its wrapper with the cull and with pallas_prefilter
        off, bit for bit, then timed in turns (on, off, off, on: 3 warm-ups,
        10 frames each); returns the largest difference and the two means."""
        off_cfg = cfg.with_(pallas_prefilter=False)
        with torch.no_grad():
            on_img = img(kt.render_color_kernel(scene, cfg))
            err = float(np.abs(on_img - img(kt.render_color_kernel(scene, off_cfg))).max())
            runs = [(k, cuda_ms(torch, lambda c=c: kt.render_color_kernel(scene, c)))
                    for k, c in (("on", cfg), ("off", off_cfg), ("off", off_cfg), ("on", cfg))]
        means = [float(np.mean([ms for k, ms in runs if k == tag])) for tag in ("on", "off")]
        print(f"  K1 {name} {cfg.xres}x{cfg.yres}, cull on vs off: max abs {err} "
              f"({'bit-equal' if err == 0.0 else 'FAIL'}); " + ", ".join(
                  f"{k} {ms:.4f}" for k, ms in runs) + f" ms/frame ({card})")
        if err != 0.0 or not np.isfinite(on_img).all():
            raise SystemExit(f"chip_smoke: K1b, {name}: the cull changes the image")
        return err, means[0], means[1]

    conf4 = spheres_scene(rtt, 11, 100).to(dev)
    cull_err, cull_ms, nocull_ms = k1_turns("configuration 4, 101 objects", conf4, cfg_main)
    got, ref, cull_plain_ms = both(conf4, cfg_main)
    compare(f"K1 with the cull vs plain, 101 objects {W}x{H} (plain one frame "
            f"{cull_plain_ms:.0f} ms)", ref, got)
    counts = {k: ops_futures[k].result() for k in ("trace_fwd_cull", "trace_fwd_cull_1024")}
    for k, c in counts.items():
        print(f"  host counts, {k} {W}x{H}: {c[0]} f32 operations, objects tested by the cull "
              f"{c[3]}, primary lists {c[4] / c[5]:.2f} candidates a scan ({c[5]} scans), "
              f"shadow lists {c[6] / c[7]:.2f} ({c[7]} scans)")
    big_built = spheres_build(rtt, 11, 1023)
    big = big_built[0].to(dev)
    k1_turns("1024 objects", big, cfg_main)
    sw, sh = MANY_SMALL
    got, ref, big_plain_ms = both(big, rtt.RenderConfig(xres=sw, yres=sh))  # noqa: F841
    compare(f"K1 vs plain, 1024 objects {sw}x{sh} (plain one frame {big_plain_ms:.0f} ms)",
            ref, got)
    gw, gh = MANY_GRAD
    # the plain march's time is its longest lane's steps: a 2000-step budget
    cfg_big_march = rtt.RenderConfig(xres=gw, yres=gh, march_max_iter=2000, **glow)
    big_glow = spheres_scene(rtt, 11, 1023, glow_dist=3.0).to(dev)
    got, ref, big_march_plain_ms = both(big_glow, cfg_big_march, km)
    compare(f"K3 vs plain, 1024 objects {gw}x{gh} march_max_iter=2000 (plain one frame "
            f"{big_march_plain_ms:.0f} ms)", ref, got)

    def regime_args(stem, scene, cfg, tail, cull=None):
        """Launcher ``stem``'s arguments after the field of view for
        ``scene`` under ``cfg``, ``tail`` its texture pointers; K1's cull as
        its wrapper takes it, unless ``cull`` forces it."""
        if cull is None:
            cull = kt.cull_on(cfg, scene.objects.count)
        return {"trace_fwd": kt.kernel_args(cfg) + tail + [int(cull)],
                "march_fwd": km.kernel_args(cfg) + tail,
                "trace_bwd": kb.kernel_args(cfg) + [kb.site_cap(cfg)] + tail,
                "march_bwd": kmb.kernel_args(cfg) + tail}[stem]

    def regime_launch(stem, scene, cfg, g=None, table_regime="", cull=None):
        """Launcher ``stem`` of the build ``stem + table_regime`` ("" stages
        the tables in shared memory, ``_build.GLOBAL_SUFFIX`` reads them from
        global memory) on ``scene`` packed once by the pack kernel (the
        closure holds the words): a function giving the image (a forward)
        or (block, image) for cotangent planes ``g`` (a backward)."""
        n = scene.objects.count
        words = kp.launch_pack(scene)
        ptrs, meta = kp.word_pointers(words, n)
        lib = _build.load_cuda_library(stem + table_regime)
        fn = getattr(lib, f"rt_{stem}")
        args = regime_args(stem, scene, cfg, kp.texture_pointers(scene, meta), cull)
        if g is None:
            return lambda words=words: kt.launch(lib, fn, ptrs, n, dev, cfg, args)
        return lambda words=words: kb.launch_block(lib, fn, ptrs, n, dev, cfg, args, g, True)

    def regimes(label, stem, scene, cfg, g=None, warm=3, reps=10):
        """``stem``'s two table regimes on the same words: the images bit
        for bit, a backward's blocks within relative L2 REGIME_REL_L2 (their
        atomics add in another order), then timed in turns (shared, global,
        global, shared). Returns the two means (ms) and the relative L2 (0
        for a forward)."""
        fns = {tag: regime_launch(stem, scene, cfg, g, suffix)
               for tag, suffix in (("shared", ""), ("global", _build.GLOBAL_SUFFIX))}
        with torch.no_grad():
            a, b = (f() for f in fns.values())
            rel = 0.0
            if g is not None:
                rel = float((a[0] - b[0]).norm() / b[0].norm())
                a, b = a[1], b[1]
            same = float((img(a) == img(b)).all(-1).mean())
            runs = [(tag, cuda_ms(torch, fns[tag], warm, reps))
                    for tag in ("shared", "global", "global", "shared")]
        means = [float(np.mean([ms for k, ms in runs if k == tag])) for tag in ("shared", "global")]
        print(f"  {stem} {label} {cfg.xres}x{cfg.yres}, tables staged vs read from global memory: "
              f"image bit-equal on {same:.4%} of pixels"
              + (f", blocks relative L2 {rel:.3g}" if g is not None else "") + "; "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in runs) + f" ms ({card})")
        if same < 1.0 or not rel <= REGIME_REL_L2 or not np.isfinite(img(a)).all():
            raise SystemExit(f"chip_smoke: {stem} {label}: the two table regimes disagree")
        return means[0], means[1], rel

    def staged(stem):
        """Backward ``stem`` on its shared-table build at any n, returning
        as the wrappers' ``render_grads_kernel(..., return_primal=True)``."""
        def fn(scene, cfg, g, return_primal=True):
            block, prim = regime_launch(stem, scene, cfg, g)()
            return kb.split_block(block, scene.objects.count), prim
        fn.__name__ = f"{stem} with its tables staged"
        return fn

    # K1b's rule: the cull only above kt.CULL_MIN_OBJECTS; below, on the
    # default scene's 5 objects, forced on against off
    fns = {c: regime_launch("trace_fwd", scene_dev, cfg_main, cull=c) for c in (True, False)}
    with torch.no_grad():
        forced_err = float(np.abs(img(fns[True]()) - img(fns[False]())).max())
        runs = [(c, cuda_ms(torch, fns[c])) for c in (True, False, False, True)]
    print(f"  K1 default scene (5 objects) {W}x{H} alone, the cull forced on vs off: max abs "
          f"{forced_err}; " + ", ".join(f"{'on' if c else 'off'} {ms:.4f}" for c, ms in runs)
          + f" ms ({card})")
    if forced_err != 0.0:
        raise SystemExit("chip_smoke: K1b forced on the default scene changes the image")

    # K2 and K4 (past kb.SHARED_TABLE_MAX: their global-table builds) and
    # their shared-table builds, which 1 024 objects still fit, against one
    # autograd call each
    _, big_bwd_plain_ms = grad_case(f"1024 objects {gw}x{gh}", big,
                                    rtt.RenderConfig(xres=gw, yres=gh),
                                    kernels=[kb.render_grads_kernel, staged("trace_bwd")])
    _, big_march_bwd_plain_ms = grad_case(
        f"march 1024 objects {gw}x{gh} march_max_iter=2000", big_glow, cfg_big_march,
        kernels=[kmb.render_grads_kernel, staged("march_bwd")], **mgrad)
    # each kernel's two table regimes (the build a wrapper launches is chosen
    # by n against its SHARED_TABLE_MAX) at its threshold, where both fit its
    # launch shape, and at 1 024 objects, the shapes of the times below
    g_big = rtt.Color(*(torch.from_numpy(np.random.default_rng(5).standard_normal((H, W))
                                         .astype(np.float32)).to(dev) for _ in range(3)))
    g_bigm = rtt.Color(*(c[:MH, :MW].contiguous() for c in g_big))
    regime_ms = {}
    for stem, cfg, g, march, sizes in (
            ("trace_fwd", cfg_main, None, False, (kt.SHARED_TABLE_MAX, 1024)),
            ("march_fwd", cfg_march, None, True, (1024,)),
            ("trace_bwd", cfg_main, g_big, False, (kb.SHARED_TABLE_MAX, 1024)),
            ("march_bwd", cfg_march, g_bigm, True, (kb.SHARED_TABLE_MAX, 1024))):
        for n in sizes:
            scene = (big_glow if march else big) if n == 1024 else spheres_scene(
                rtt, 11, n - 1, glow_dist=3.0 if march else 0.0).to(dev)
            regime_ms[stem, n] = regimes(f"{n} objects", stem, scene, cfg, g,
                                         *((1, 3) if march else (3, 10)))
    cli_file(torch, rtt, cli, kt, kp, big_built, W, H)
    print(f"  1024 objects ({card}), alone on words packed once, the build the wrappers launch: "
          f"K1 {W}x{H} with the cull {regime_ms['trace_fwd', 1024][1]:.3f} ms, K2 {W}x{H} with "
          f"the image {regime_ms['trace_bwd', 1024][1]:.3f} ms, K3 {MW}x{MH} -m -g 1.0 "
          f"{regime_ms['march_fwd', 1024][0]:.3f} ms, K4 {MW}x{MH} with the image "
          f"{regime_ms['march_bwd', 1024][1]:.3f} ms (plain versions at {gw}x{gh}: K2's "
          f"autograd {big_bwd_plain_ms:.0f} ms, K3's {big_march_plain_ms:.0f} ms, K4's autograd "
          f"{big_march_bwd_plain_ms:.0f} ms)")
    deep = cfg_main.with_(max_reflections=8)
    got, ref, deep_plain_ms = both(default, deep.with_(xres=sw, yres=sh))
    deep_err = compare(f"K1 max_reflections=8 vs plain, default {sw}x{sh} (plain one frame "
                       f"{deep_plain_ms:.0f} ms)", ref, got)
    with torch.no_grad():
        deep_img = img(kt.render_color_kernel(scene_dev, deep))
        deep_ms = cuda_ms(torch, lambda: kt.render_color_kernel(scene_dev, deep))
    if not np.isfinite(deep_img).all():
        raise SystemExit("chip_smoke: K1 at max_reflections=8 is not finite")
    print(f"  K1 max_reflections=8, default {W}x{H} (64-task stack): {deep_ms:.4f} ms/frame")
    phase_s["4b"] = time.time() - t_phase
    t_phase = time.time()

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
    words_once = kp.launch_pack(scene_dev)
    alone = lambda: kt.render_words_kernel(scene_dev, words_once, cfg_main)  # noqa: E731
    with torch.no_grad():
        alone_runs = [(k, cuda_ms(torch, kernel if k == "wrapper" else alone))
                      for k in ("wrapper", "alone", "alone", "wrapper")]
    for name, ms in alone_runs:
        how = "through render_color_kernel" if name == "wrapper" else "alone on words packed once"
        print(f"  kernel {how}: {ms:.4f} ms/frame")
    k_alone_ms = float(np.mean([ms for n, ms in alone_runs if n == "alone"]))
    n_ops, _, shade_ops = ops["trace_fwd"][:3]
    print(f"  diagnostic: the body's object tests {n_ops} and shading and sky {shade_ops} f32 "
          f"operations (host count); with both, the kernel alone reaches "
          f"{(n_ops + shade_ops) / F32_OPS_PER_S / (k_alone_ms / 1e3):.1%} of "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s (the object tests alone: "
          f"{n_ops / F32_OPS_PER_S / (k_alone_ms / 1e3):.1%})")

    print(f"packing {W}x{H}, default scene ({card}): by CUDA events and by the host's clock "
          f"(100 calls enqueued)")
    g_block = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (scene_dev.objects.count + 1, kb.GRAD_COLS)).astype(np.float32)).to(dev)
    pack_fns = {"pack kernel (kernel_pack.launch_pack)": lambda: kp.launch_pack(scene_dev),
                "pack kernel and the cached atlas's arguments, textured Nearest":
                    lambda: kp.texture_pointers(tex_scenes[0], kp.word_pointers(
                        kp.launch_pack(tex_scenes[0]), tex_scenes[0].objects.count)[1]),
                "plain pack_scene": lambda: kt.pack_scene(scene_dev),
                "pull-back kernel (kernel_pack.pack_scene_vjp)":
                    lambda: kp.pack_scene_vjp(scene_dev, g_block),
                "plain pull-back (autograd of pack_scene)":
                    lambda: kp.pack_scene_vjp_plain(
                        scene_dev, kp.split_block(g_block, scene_dev.objects.count))}
    pack_ms = {}
    for name, fn in pack_fns.items():
        pack_ms[name] = cuda_ms(torch, fn)
        print(f"  {name}: {pack_ms[name]:.4f} ms by events, {host_ms(torch, fn):.4f} ms by the "
              f"host's clock")
    pack_ms = list(pack_ms.values())

    print(f"forward + backward {W}x{H}, default scene, default cfg ({card}):")
    def step(render, cfg, base=scene_dev):
        return training_step(torch, render, cfg, base)

    kernel_step = step(rtt.render_color, cfg_main)
    for _ in range(2):
        print(f"  step (kernels at {W}x{H}: render, MSE, gradient of every float leaf): "
              f"{cuda_ms(torch, kernel_step):.3f} ms by events")
    # the plain step is phase 3's plain autograd (the same render and
    # gradient, without the MSE): no yardstick of speed, not run twice
    print(f"  its plain twin (phase 3's plain autograd at {pw}x{ph}, one call): "
          f"{bwd_plain_ms:.3f} ms")
    busy, span, names = device_busy(torch, kernel_step)
    print(f"  step through the kernels: {host_ms(torch, kernel_step, reps=20):.3f} ms by the "
          f"host's clock (20 steps enqueued), the card busy {busy:.3f} ms of a span of "
          f"{span:.3f} ms (idle share {1 - busy / span if span else float('nan'):.3f})")
    packs = [sum(c for k, c in names.items() if f"{kernel}(" in k)
             for kernel in ("pack_scene_kernel", "pack_scene_vjp_kernel")]
    print(f"  profiled step: {sum(names.values()):.1f} kernels, copies and sets a step, of "
          f"them {packs[0]:.1f} pack and {packs[1]:.1f} pull-back launches")
    if names and packs != [1, 1]:
        raise SystemExit("chip_smoke: the profiled step is not one pack and one pull-back")
    rng = np.random.default_rng(0)

    def planes(cfg):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                            .astype(np.float32)).to(dev) for _ in range(3)))

    g_main = planes(cfg_main)

    def bwd_times(scene, name):
        """The backward kernel at the main path's shape, with the image, in
        turns through its wrapper (packing included) and alone on words
        packed once; returns the means (wrapper, alone)."""
        words = kp.launch_pack(scene)
        fns = {"wrapper": lambda: kb.render_grads_kernel(scene, cfg_main, g_main,
                                                         return_primal=True),
               "alone": lambda: kb.launch_words(scene, words, cfg_main, g_main, True)}
        runs = [(k, cuda_ms(torch, fns[k])) for k in ("wrapper", "alone", "alone", "wrapper")]
        for k, ms in runs:
            print(f"  backward kernel, {name} {W}x{H} with the image, "
                  f"{'through its wrapper' if k == 'wrapper' else 'alone on packed words'}: "
                  f"{ms:.3f} ms")
        return tuple(float(np.mean([ms for kind, ms in runs if kind == k])) for k in fns)

    bwd_ms, bwd_alone_ms = bwd_times(scene_dev, "untextured")
    _, _, adds, pairs, sites, most = ops["trace_bwd"]
    print(f"  host counts, {W}x{H}, cotangent 1 on every pixel: {adds} accumulator adds lane "
          f"by lane, {pairs} distinct (warp of 32 pixels, entry) pairs, {sites} sites "
          f"({sites / (W * H):.3f} a pixel, at most {most})")
    print(f"  its plain version (autograd of the plain trace) at {pw}x{ph}: {bwd_plain_ms:.3f} ms "
          f"(one call, phase 3)")

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
    oracle_words = kp.launch_pack(scene_dev)
    oracle_fns = {
        "oracle kernel (wrapper, with the image)":
            lambda: kr.render_grads_retrace(scene_dev, cfg_main, g_main, return_primal=True),
        "oracle kernel alone on packed words, with the image":
            lambda: kr.launch_words(scene_dev, oracle_words, cfg_main, g_main, True),
        "backward kernel (wrapper, with the image)":
            lambda: kb.render_grads_kernel(scene_dev, cfg_main, g_main, return_primal=True)}
    names = list(oracle_fns)
    oracle_runs = [(k, cuda_ms(torch, oracle_fns[k])) for k in names + names[::-1]]
    for name, ms in oracle_runs:
        print(f"  {name}: {ms:.3f} ms per cotangent")
    retrace_ms, retrace_alone_ms = (float(np.mean([ms for k, ms in oracle_runs if k == name]))
                                    for name in names[:2])
    print(f"  their plain version (autograd of the plain trace) at {pw}x{ph}: "
          f"{bwd_plain_ms:.3f} ms (one call, above)")
    counts = ops["trace_retrace"]
    hist = counts[kr.HIST_SLOT:]
    print(f"  host counts, {W}x{H}: Dual passes of {lanes} lanes {counts[2]} "
          f"({counts[2] / (W * H):.4f} a pixel, at most {counts[3]}; a row of 32 pixels' "
          f"longest {counts[4] / (H * -(-W // 32)):.4f} on average; seeding every entry "
          f"{-(-kr.n_out(scene_dev.objects.count) // lanes)}); pixels by distinct winners "
          + ", ".join(f"{w}: {c}" for w, c in enumerate(hist) if c))

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
    print(f"  step (march kernel + march backward kernel at {MW}x{MH}: render, MSE, gradient "
          f"of every float leaf): {march_step_ms:.3f} ms")
    print(f"  its plain twin (phase 3's plain autograd with the implicit VJP at "
          f"{pw_m}x{ph_m}, one call): {march_bwd_plain_ms:.3f} ms")
    g_march = planes(cfg_march)
    march_bwd_ms = cuda_ms(torch, lambda: kmb.render_grads_kernel(scene_dev, cfg_march, g_march,
                                                                  return_primal=True))
    print(f"  march backward kernel alone at {MW}x{MH} (wrapper, with the image): "
          f"{march_bwd_ms:.3f} ms; its plain version at {pw_m}x{ph_m}: "
          f"{march_bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"textured march {MW}x{MH}, default scene with bar.png, -m -g 1.0, beside the "
          f"untextured in turns ({card}):")
    march_scenes = {"untextured": scene_dev, "Nearest": tex_scenes[0], "Bilinear": tex_scenes[1]}
    order = list(march_scenes) + list(march_scenes)[::-1]
    with torch.no_grad():
        k3_runs = [(k, cuda_ms(torch, lambda k=k: km.render_color_kernel(march_scenes[k],
                                                                        cfg_march)))
                   for k in order]
    k4_runs = [(k, cuda_ms(torch, lambda k=k: kmb.render_grads_kernel(
        march_scenes[k], cfg_march, g_march, return_primal=True))) for k in order]
    for (k, k3), (_, k4) in zip(k3_runs, k4_runs):
        print(f"  {k}: march kernel {k3:.3f} ms/frame, march backward {k4:.3f} ms (with the "
              f"image)")
    k3_tex_ms = {k: float(np.mean([ms for n, ms in k3_runs if n == k])) for k in march_scenes}
    k4_tex_ms = {k: float(np.mean([ms for n, ms in k4_runs if n == k])) for k in march_scenes}
    march_tex_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_march, base=tex_bi))
    print(f"  textured march step, Bilinear (render, MSE, gradient of every float leaf): "
          f"{march_tex_step_ms:.3f} ms")
    print(f"  plain textured march {MW}x{MH}: Nearest {march_tex_plain_ms[0]:.1f} ms, Bilinear "
          f"{march_tex_plain_ms[1]:.1f} ms (one frame each, phase 3); plain autograd (160x120 "
          f"with march_max_iter=2000, and the textured frame "
          f"{march_tex_bwd_frame[0]}x{march_tex_bwd_frame[1]}): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in march_tex_bwd_plain_ms.items())
          + " (phase 3)")
    print(f"  scene files (configuration 4), wall time a CLI request: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in file_s.items()))

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
            n_ops, _, px_ops, passes, px_passes, never = ops[key][:6]
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
                             ("trace_bwd_textured", cfg_main, tex_bi),
                             ("march_fwd_textured", cfg_march, tex_scenes[0]),
                             ("march_fwd_textured_bilinear", cfg_march, tex_bi),
                             ("march_bwd_textured", cfg_march, tex_bi)):
        n_ops, fetched = ops[name][:2]
        nbytes = io_bytes(scene, cfg) + texel_bytes(scene, fetched)
        if "_bwd" in name:
            # + the cotangent planes read, the block written
            nbytes += 3 * 4 * cfg.xres * cfg.yres + 4 * (scene.objects.count + 1) * kb.GRAD_COLS
        bounds[name] = roofline(n_ops, nbytes)
        print(f"  bound, {name} {cfg.xres}x{cfg.yres}: {n_ops} f32 operations, {nbytes} bytes "
              f"({fetched} B of texel fetches) -> {bounds[name][0]:.4f} ms ({bounds[name][1]})")
        if name in ("march_fwd", "march_bwd"):  # the step-by-step march's work, a diagnostic
            off_ops = ops[f"{name}_off"][0]
            print(f"    with the floor tail off (diagnostic, not the bound): {off_ops} f32 "
                  f"operations -> {roofline(off_ops, nbytes)[0]:.4f} ms")
    bounds["pack_scene"] = roofline(0, pack_bytes(scene_dev))
    vjp_bytes, vjp_ops = pull_back_bytes_ops(scene_dev)
    bounds["pack_scene_vjp"] = roofline(vjp_ops, vjp_bytes)
    for name in ("pack_scene", "pack_scene_vjp"):
        print(f"  bound, {name}, default scene: {bounds[name][0]:.3g} ms ({bounds[name][1]})")
    # the re-trace oracle computes the trace backward's function on the same
    # inputs, so the least time for its work is the trace backward's bound;
    # its forward-mode operations are only a diagnostic
    bounds["trace_retrace"] = bounds["trace_bwd"]
    dual_ops = ops["trace_retrace"][0]
    print(f"  bound, trace_retrace {W}x{H}: the trace backward's, {bounds['trace_retrace'][0]:.4f} "
          f"ms ({bounds['trace_retrace'][1]}); its value pass and forward-mode operations "
          f"(diagnostic, not the bound): {dual_ops} -> {roofline(dual_ops, 0)[0]:.4f} ms")

    cull_ops = ops["trace_fwd_cull"][0]
    bounds["trace_fwd_cull"] = roofline(cull_ops, io_bytes(conf4, cfg_main))
    big_ops = ops["trace_fwd_cull_1024"][0]
    print(f"  bound, trace_fwd_cull {W}x{H}, 101 objects: {cull_ops} f32 operations -> "
          f"{bounds['trace_fwd_cull'][0]:.4f} ms ({bounds['trace_fwd_cull'][1]}); 1024 objects: "
          f"{big_ops} -> {roofline(big_ops, io_bytes(big, cfg_main))[0]:.4f} ms")
    phase_s["5"] = time.time() - t_phase
    print("phase wall times: " + ", ".join(f"{k} {v:.0f} s" for k, v in phase_s.items()))

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
        "name": "trace_fwd_cull", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1109",
        "launches": cull_launches, "max_abs_err": cull_err, "ms": cull_ms,
        "off_ms": nocull_ms, "plain_ms": cull_plain_ms,
        "bound_ms": bounds["trace_fwd_cull"][0], "bound_by": bounds["trace_fwd_cull"][1],
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
        "name": "march_fwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_march.py:814",
        "launches": march_tex_launches, "max_abs_err": max(march_tex_err.values()),
        "ms": k3_tex_ms["Nearest"], "plain_ms": march_tex_plain_ms[0],
        "bound_ms": bounds["march_fwd_textured"][0], "bound_by": bounds["march_fwd_textured"][1],
        "library_ms": None,
    }, {
        "name": "march_bwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:1060",
        "launches": march_tex_train_launches[3],
        "max_abs_err": max(march_tex_bwd_err.values()),
        "ms": k4_tex_ms["Bilinear"], "plain_ms": march_tex_bwd_plain_ms["Bilinear"],
        "bound_ms": bounds["march_bwd_textured"][0], "bound_by": bounds["march_bwd_textured"][1],
        "library_ms": None,
    }, {
        "name": "pack_scene", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/pack_scene.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:127",
        "launches": train_launches[4], "max_abs_err": pack_err, "ms": pack_ms[0],
        "plain_ms": pack_ms[2], "bound_ms": bounds["pack_scene"][0],
        "bound_by": bounds["pack_scene"][1], "library_ms": None,
    }, {
        "name": "pack_scene_vjp", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/pack_scene.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1656",
        "launches": train_launches[5], "max_abs_err": vjp_err, "ms": pack_ms[3],
        "plain_ms": pack_ms[4], "bound_ms": bounds["pack_scene_vjp"][0],
        "bound_by": bounds["pack_scene_vjp"][1], "library_ms": None,
    }, {
        "name": "trace_retrace", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_retrace.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1555",
        "launches": retrace_launches, "max_abs_err": retrace_max_err, "ms": retrace_ms,
        "alone_ms": retrace_alone_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["trace_retrace"][0], "bound_by": bounds["trace_retrace"][1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
