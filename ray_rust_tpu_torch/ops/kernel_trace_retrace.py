"""The re-trace gradient oracle (K5) as one hand-written CUDA kernel, and its
plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads``.
The kernel (``csrc/trace_retrace.cu``, per-pixel body
``csrc/trace_retrace_body.cuh``) computes the trace-mode table cotangent by
a second mechanism, independent of the trace backward's site replay (K2,
:mod:`.kernel_trace_bwd`): it runs the forward kernel's own trace body in
forward-mode numbers (``csrc/dual.cuh``), each launch carrying the
derivatives by ``lanes`` consecutive entries of the ``n_out = 19 N + 10``
live entries (object rows of 19, then the camera's 7 and the light's 3),
and sums ``g . d img / d entry`` over the pixels. The wrapper launches
``ceil(n_out / lanes)`` times; the first launch also writes the image, which
is the forward kernel's bit for bit. Like the JAX function it takes
untextured scenes of at most 64 objects, and no config flag routes a
gradient through it: it is the oracle that K2 is held against.

:func:`render_grads_retrace` launches the kernel on a CUDA scene or raises;
it never falls back. On a CPU scene it returns the plain version. K5 computes
the function K2 computes, so its plain version is K2's:
:func:`render_grads_plain`, torch autograd of the plain trace.
:func:`kernel_trace_bwd.leaf_grads` pulls the table cotangents back to the
scene's leaves, as the JAX function pulls them back through ``_pack_scene``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from . import kernel_trace
from .kernel_trace import F32_COLS, check_launchable, check_tables, check_tensor, pack_scene
# K5 computes the function K2 computes, so its plain version is K2's:
# render_grads_plain, torch autograd of the plain trace.
from .kernel_trace_bwd import GRAD_COLS, kernel_args, render_grads_plain, split_block
from .rays import fov_scales

__all__ = [
    "OBJECT_MAX",
    "n_out",
    "unsupported_reason",
    "launch_all",
    "render_grads_retrace",
    "render_grads_plain",
]

# Launches of the re-trace kernel since import (or since a caller reset it):
# ceil(n_out / lanes) for each cotangent.
LAUNCHES = 0

OBJECT_MAX = 64  # the JAX kernel's cap (pallas_trace.py:_KERNEL_UNROLL_MAX)
SCENE_ENTRIES = 10  # camera position xyz, rotation xyzw, light xyz


def n_out(n_objects: int) -> int:
    """Live entries of the cotangent block for ``n_objects`` objects (the
    JAX kernel's ``n_out``)."""
    return n_objects * F32_COLS + SCENE_ENTRIES


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the re-trace kernel cannot take a gradient of ``scene`` under
    ``cfg``, or None: its own limits (the JAX function's), then the forward
    kernel's reasons, whose trace body it runs."""
    if scene.objects.count > OBJECT_MAX:
        return (f"more than {OBJECT_MAX} objects: the re-trace oracle's cap, as the JAX "
                f"kernel's (K2 takes up to {kernel_trace.KERNEL_OBJECT_MAX})")
    if scene.textures is not None:
        return "image textures: the re-trace oracle takes untextured scenes, as the JAX kernel"
    return kernel_trace.unsupported_reason(scene, cfg)


def launch_all(fn, lanes: int, tables, cfg: RenderConfig, g: Color, return_primal: bool,
               tail: tuple):
    """Run launcher ``fn`` (the kernel's ``rt_trace_retrace`` or its host
    build's ``rt_trace_retrace_host``) once for each ``lanes`` entries of the
    block, as ``fn(tables, n, xres, yres, sx, sy, *kernel_args(cfg), seed,
    g_r, g_g, g_b, block, prim_r, prim_g, prim_b, *tail)``, the primal planes
    with the first launch only. ``tail`` is the device and stream, or the
    host build's operation counter. Returns the three table cotangents and,
    with ``return_primal``, the image. Raises if a launch returns non-zero."""
    check_tables(tables)
    f32t, i32t, cam, light = tables
    n, dev = f32t.shape[0], f32t.device
    for name, plane in zip("rgb", g):
        check_tensor(plane, f"cotangent {name}", torch.float32, (cfg.yres, cfg.xres), dev)
    block = torch.zeros((n + 1, GRAD_COLS), dtype=torch.float32, device=dev)
    prim = (torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
            if return_primal else None)
    sx, sy = fov_scales(cfg)
    args = kernel_args(cfg)
    for seed in range(0, n_out(n), lanes):
        prims = [p.data_ptr() for p in prim] if return_primal and seed == 0 else [None] * 3
        rc = fn(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(), n,
                cfg.xres, cfg.yres, sx, sy, *args, seed, *(plane.data_ptr() for plane in g),
                block.data_ptr(), *prims, *tail)
        if rc:
            raise RuntimeError(f"{fn.__name__} launch failed: error {rc}")
    grads = split_block(block, n)
    return (grads, Color(prim[0], prim[1], prim[2])) if return_primal else grads


def _launch(tables, cfg: RenderConfig, g: Color, return_primal: bool):
    """Launch the re-trace kernel on packed tables on their CUDA device,
    counting each launch."""
    from ._build import load_cuda_library

    lib = load_cuda_library("trace_retrace")
    dev = tables[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fn(*a):
        global LAUNCHES
        rc = lib.rt_trace_retrace(*a)
        if rc != 0:
            raise RuntimeError(f"rt_trace_retrace launch failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        LAUNCHES += 1
        return 0

    return launch_all(fn, lib.rt_trace_retrace_lanes(), tables, cfg, g, return_primal,
                      (dev.index, stream))


def render_grads_retrace(scene: Scene, cfg: RenderConfig, g: Color,
                         return_primal: bool = False):
    """The cotangents ``(g_f32t (N, 19), g_cam (1, 8), g_light (1, 4))`` of
    the packed tables for image cotangent ``g`` (three ``(H, W)`` f32 planes
    on the scene's device), by the re-trace kernel on a CUDA scene and by
    the plain version on a CPU one. ``return_primal=True`` also returns the
    image the gradient is the derivative of: the kernel's re-trace (the
    forward kernel's image) or the plain render. Raises on anything the
    kernel does not take, on either device."""
    reason = unsupported_reason(scene, cfg)
    g = Color(*(c.contiguous() for c in g))
    if scene.device.type == "cpu":
        if reason is not None:
            raise ValueError(f"the re-trace gradient does not cover this render: {reason}")
        grads = render_grads_plain(scene, cfg, g)
        return (grads, kernel_trace.render_color_plain(scene, cfg)) if return_primal else grads
    check_launchable(scene, reason, "re-trace gradient")
    tables = tuple(t.detach() for t in pack_scene(scene))
    return _launch(tables, cfg, g, return_primal)
