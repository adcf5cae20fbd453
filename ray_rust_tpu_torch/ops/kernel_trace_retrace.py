"""The re-trace gradient oracle (K5) as one hand-written CUDA kernel, and its
plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py:render_color_pallas_grads``.
The kernel (``csrc/trace_retrace.cu``, per-pixel body
``csrc/trace_retrace_body.cuh``) computes the trace-mode table cotangent by
a second mechanism, independent of the trace backward's site replay (K2,
:mod:`.kernel_trace_bwd`): each pixel first runs the forward kernel's float
trace, which gives its colour (the forward kernel's image bit for bit) and
its winners, then runs the same trace body in forward-mode numbers
(``csrc/dual.cuh``) over its live entries only, two a pass: the
camera's 7, the light's 3 and the 19 of each object it hits, of the
``n_out = 19 N + 10`` entries of the block. It sums ``g . d img / d entry``
over the pixels. One launch computes the whole cotangent. Like the JAX
function it takes untextured scenes of at most 64 objects (the winners of a
pixel are one 64-bit mask), and no config flag routes a gradient through it:
it is the oracle that K2 is held against.

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
from . import kernel_pack, kernel_trace
from .kernel_pack import F32_COLS
from .kernel_trace import check_launchable, check_tensor
# K5 computes the function K2 computes, so its plain version is K2's:
# render_grads_plain, torch autograd of the plain trace.
from .kernel_trace_bwd import GRAD_COLS, kernel_args, render_grads_plain, split_block
from .rays import fov_scales

__all__ = [
    "OBJECT_MAX",
    "n_out",
    "unsupported_reason",
    "launch_all",
    "launch_words",
    "render_grads_retrace",
    "render_grads_plain",
]

# Launches of the re-trace kernel since import (or since a caller reset it):
# one for each cotangent.
LAUNCHES = 0

OBJECT_MAX = 64  # the JAX kernel's cap (pallas_trace.py:_KERNEL_UNROLL_MAX)
SCENE_ENTRIES = 10  # camera position xyz, rotation xyzw, light xyz
# The counting host build's slots (csrc/trace_retrace_host.cpp): f32
# operations, texel bytes (none), Dual passes, the most passes of one pixel,
# the sum over rows of 32 pixels of their longest pixel's passes, then from
# HIST_SLOT the pixels with w distinct winners for w = 0 .. OBJECT_MAX.
HIST_SLOT = 5
OPS_SLOTS = HIST_SLOT + OBJECT_MAX + 1


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
                f"kernel's (K2 takes larger scenes)")
    if scene.textures is not None:
        return "image textures: the re-trace oracle takes untextured scenes, as the JAX kernel"
    r = max(cfg.max_reflections, 1)
    if 1 + r * (r - 1) // 2 > kernel_trace.STACK_CAP:
        return (f"max_reflections={cfg.max_reflections} overflows the re-trace oracle's task "
                f"stack ({kernel_trace.STACK_CAP} tasks: max_reflections up to 6)")
    return kernel_trace.unsupported_reason(scene, cfg)


def launch_all(fn, ptrs: list, n: int, dev, cfg: RenderConfig, g: Color, return_primal: bool,
               tail: tuple):
    """Run launcher ``fn`` (the kernel's ``rt_trace_retrace`` or its host
    build's ``rt_trace_retrace_host``) once, as ``fn(tables, n, xres, yres,
    sx, sy, *kernel_args(cfg), g_r, g_g, g_b, block, prim_r, prim_g,
    prim_b, *tail)``, the tables of ``n`` objects on device ``dev`` given
    by their addresses ``ptrs`` (f32 table, i32 table, camera, light: the
    pack kernel's words, ``kernel_pack.word_pointers``, or the host build's
    ``pack_scene`` tables, which the caller holds). ``tail`` is the device
    and stream, or the host build's operation counter. Returns the three
    table cotangents and, with ``return_primal``, the image. Raises on more
    than OBJECT_MAX objects (a pixel's winners are one 64-bit mask) and if
    the launch returns non-zero."""
    if n > OBJECT_MAX:
        raise ValueError(f"the re-trace kernel takes at most {OBJECT_MAX} objects, got {n}")
    for name, plane in zip("rgb", g):
        check_tensor(plane, f"cotangent {name}", torch.float32, (cfg.yres, cfg.xres), dev)
    block = torch.zeros((n + 1, GRAD_COLS), dtype=torch.float32, device=dev)
    prim = (torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
            if return_primal else None)
    sx, sy = fov_scales(cfg)
    prims = [p.data_ptr() for p in prim] if return_primal else [None] * 3
    rc = fn(*ptrs, n, cfg.xres, cfg.yres, sx, sy, *kernel_args(cfg),
            *(plane.data_ptr() for plane in g), block.data_ptr(), *prims, *tail)
    if rc:
        raise RuntimeError(f"{fn.__name__} launch failed: error {rc}")
    grads = split_block(block, n)
    return (grads, Color(prim[0], prim[1], prim[2])) if return_primal else grads


def launch_words(scene: Scene, words: torch.Tensor, cfg: RenderConfig, g: Color,
                 return_primal: bool = False):
    """The re-trace kernel on the pack kernel's ``words`` of ``scene``
    (``kernel_pack.launch_pack``), straight from their addresses, counting
    its launch: the kernel without :func:`render_grads_retrace`'s checks and
    packing; returns as :func:`launch_all`."""
    from ._build import load_cuda_library

    lib = load_cuda_library("trace_retrace")
    dev = words.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fn(*a):
        global LAUNCHES
        rc = lib.rt_trace_retrace(*a)
        if rc != 0:
            raise RuntimeError(f"rt_trace_retrace launch failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        LAUNCHES += 1
        return 0

    n = scene.objects.count
    return launch_all(fn, kernel_pack.word_pointers(words, n)[0], n, dev, cfg, g, return_primal,
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
    return launch_words(scene, kernel_pack.launch_pack(scene), cfg, g, return_primal)
