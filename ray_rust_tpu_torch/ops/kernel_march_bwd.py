"""The march-mode backward as one hand-written CUDA kernel, its plain
version, and the autograd pairing of the two march kernels.

Counterpart of the march half of ``ray_rust_tpu/ops/pallas_bwd.py``. The
kernel (``csrc/march_bwd.cu``, per-pixel body ``csrc/march_bwd_body.cuh``)
replaces the Pallas kernel ``render_color_pallas_march_grads`` for
march-mode scenes of any size the forward takes (above
``kernel_trace_bwd.SHARED_TABLE_MAX`` objects in its global-table build,
``march_bwd_global``, as the trace backward's; textured scenes, which the JAX
package differentiates through its jnp march's implicit VJP, in a second
instance of the kernel whose adjoint takes the texture's uv cotangents): from the packed scene
tables and the cotangent of the image it gives the cotangents of the f32
table ``(N, 19)`` (column 18 is ``glow_dist``), the camera ``(1, 8)`` and the
light ``(1, 4)``. It records each pixel's raymarch calls and laps with the
march kernel's own traversal, then runs a hand-written adjoint over them
backwards, with the hit points pulled back by the implicit function theorem
and the glow through its recorded argmin, as ``ops/march.py``'s implicit VJP
does. It records at most :data:`SITE_CAP` laps a pixel in local arrays;
configurations with more (``raymarch_max_reflections=7`` needs 39), or with
a refraction cap past ``kernel_march.FRAME_CAP``, launch its buffer
instance (``csrc/march_bwd_buf.cu``, a library of its own, in the
global-table regime, textured or not, its record pass the deep march on an
explicit stack of ``kernel_march.FRAME_CAP_DEEP`` frames), whose records, :data:`RECORD_WORDS`
words a lap, lie in a buffer in device memory that
``kernel_trace_bwd.launch_buffered`` fills band by band of the window's
rows within ``kernel_trace_bwd.RECORD_BUDGET``.

:class:`MarchRender` pairs the march kernel with it, as ``_fast_march_fn``
(``pallas_trace.py:1705-1740``) pairs the JAX kernels, from the scene's
float leaves to the image: its forward packs the scene (``kernel_pack``)
and launches the march kernel on the tables, its backward launches this
kernel and pulls its block back to the leaves
(``kernel_pack.pack_scene_vjp``). Each covers a window of the frame at its
global origin (``origin=``, ``shape=``; the whole frame by default), as the
trace backward's do (``kernel_trace_bwd``).

:func:`render_grads_kernel` launches the kernel or raises; it never falls
back. :func:`render_grads_plain` computes the same three cotangents with
torch autograd of the plain march (``kernel_march.render_color_plain``,
whose marches differentiate through the implicit VJP); the tests and
``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from . import kernel_march, kernel_pack, kernel_trace
from . import kernel_trace_bwd as ktb
from .kernel_trace import check_launchable, texture_args
from .rays import window

__all__ = [
    "SITE_CAP",
    "count_sites",
    "count_frames",
    "buffered",
    "nesting",
    "unsupported_reason",
    "kernel_supported",
    "kernel_args",
    "launch_args",
    "render_grads_kernel",
    "render_grads_plain",
    "MarchRender",
    "render_color_grad",
]

# Launches of the march backward kernel since import (or since a caller
# reset it): its instances with local records, and its buffer instance (one
# a band).
LAUNCHES = 0
BUF_LAUNCHES = 0

# Laps a pixel may record in local arrays (csrc/march_bwd_body.cuh:
# rt::MARCH_SITE_CAP): refraction_unroll=None at 3 laps needs 35. Past it
# the buffer instance runs.
SITE_CAP = 35
# Words of a lap's records in the buffer instance: its MSite (68 bytes),
# the buffer's first kind of record, and its MFrame (124;
# csrc/march_bwd_body.cuh, static_assert).
LAP_WORDS = 17
RECORD_WORDS = LAP_WORDS + 31

# The kernel's function in plain PyTorch: autograd of the plain march, pulled
# back to the packed tables (the trace backward's, which renders through
# render_color_plain in either mode).
render_grads_plain = ktb.render_grads_plain


def count_sites(cfg: RenderConfig) -> int:
    """The most laps one pixel can run under ``cfg`` (11 at the default
    config, 35 at ``refraction_unroll=None``): the static lap-site tree
    (``pallas_bwd.py:_march_unroll_nodes``) is the trace tree with the laps'
    compile-time cap ``raymarch_max_reflections`` in place of
    ``max_reflections`` (``kernel_trace.tree_counts``)."""
    return kernel_trace.tree_counts(cfg.raymarch_max_reflections, cfg.refraction_cap())[0]


def count_frames(cfg: RenderConfig) -> int:
    """The most raymarch calls one pixel can make (one glow record each,
    ``pallas_bwd.py:_glow_sid_map``): the camera ray's, and one sub-march
    under every lap below the refraction cap."""
    return kernel_trace.tree_counts(cfg.raymarch_max_reflections, cfg.refraction_cap())[1]


def nesting(buf: torch.Tensor, cap: int, pixels: int) -> torch.Tensor:
    """The deepest chain of nested raymarch calls (the camera ray's march
    is 1, a refraction sub-march one more than the call whose lap started
    it) that each pixel of a one-band launch of the buffer instance over
    ``pixels`` pixels recorded into ``buf``, filled with
    ``kernel_trace_bwd.RECORD_FILL`` before it and read after it: a frame
    record's first word is the lap that started it, a lap record's word 13
    its frame (``csrc/march_bwd_body.cuh``: MSite, MFrame)."""
    laps = buf[:cap * LAP_WORDS * pixels].view(cap, LAP_WORDS, pixels)[:, 13].long()
    parents = buf[cap * LAP_WORDS * pixels:cap * RECORD_WORDS * pixels].view(
        cap, RECORD_WORDS - LAP_WORDS, pixels)[:, 0].long()
    cols = torch.arange(pixels, device=buf.device)
    depth = torch.zeros((cap, pixels), dtype=torch.long, device=buf.device)
    for k in range(cap):  # parents first: a frame's parent lap is in an earlier frame
        p = parents[k]
        written = (p >= -1) & (p < cap)  # RECORD_FILL where frame k never began
        up = depth[laps[p.clamp(0, cap - 1), cols].clamp(0, cap - 1), cols]
        depth[k] = torch.where(written, torch.where(p < 0, 1, up + 1), 0)
    return depth.amax(0)


def buffered(cfg: RenderConfig) -> bool:
    """Whether the buffer instance takes ``cfg``: more laps than
    :data:`SITE_CAP`, or a refraction cap past ``kernel_march.FRAME_CAP``
    (its record pass is the deep march, ``csrc/march_body.cuh:
    raymarch_deep``)."""
    return count_sites(cfg) > SITE_CAP or kernel_march.deep(cfg)


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the two march kernels cannot take a gradient of ``scene`` under
    ``cfg``, or None: the march kernel's reasons, then a pixel's records
    past ``kernel_trace_bwd.RECORD_BUDGET``."""
    reason = kernel_march.unsupported_reason(scene, cfg)
    if reason is not None:
        return reason
    laps = count_sites(cfg)
    return ktb.record_reason(RECORD_WORDS * laps, ktb.RECORD_BUDGET, f"{laps} laps per pixel")


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """March mode, scenes within ``kernel_trace.size_reason``'s limit (the
    pack's int32 words and K1b's masks in a block's shared memory; textured
    within the atlas limits), refraction depth at most
    ``kernel_march.FRAME_CAP_DEEP``, a pixel's records within
    ``kernel_trace_bwd.RECORD_BUDGET``."""
    return unsupported_reason(scene, cfg) is None


def kernel_args(cfg: RenderConfig) -> list:
    """The launcher's render arguments after the image size and field of
    view (also those of the host build, ``csrc/march_bwd_host.cpp``): the
    march kernel's, then ``grad_distance_cutoff`` (+inf for None)."""
    cutoff = cfg.grad_distance_cutoff
    return kernel_march.kernel_args(cfg) + [float("inf") if cutoff is None else float(cutoff)]


def launch_args(cfg: RenderConfig, tex, device) -> list:
    """This kernel's arguments after the image size and field of view (also
    its host build's): :func:`kernel_args`, then
    ``kernel_trace.texture_args`` of atlas ``tex`` on ``device``."""
    return kernel_args(cfg) + texture_args(tex, device)


def launch_words(scene: Scene, words, cfg: RenderConfig, g: Color, return_primal: bool,
                 origin=(0, 0), shape=None):
    """Launch the march backward kernel on the pack kernel's ``words`` of
    ``scene`` (``kernel_pack.launch_pack``) and its cached texture atlas,
    straight from their addresses (``kernel_trace_bwd.launch_block``), over
    the window at ``origin`` of size ``shape``, counting it: an instance
    with local records, or past :data:`SITE_CAP` laps the buffer instance
    band by band (``kernel_trace_bwd.launch_buffered``). Returns its block
    and, with ``return_primal``, the window's image."""
    global LAUNCHES, BUF_LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = kernel_pack.word_pointers(words, n)
    args = kernel_args(cfg) + kernel_pack.texture_pointers(scene, meta)
    if buffered(cfg):
        lib = load_cuda_library("march_bwd_buf")
        cap = count_sites(cfg)
        block, prim, bands = ktb.launch_buffered(lib, lib.rt_march_bwd_buf, ptrs, n,
                                                 words.device, cfg, args, g, return_primal,
                                                 origin, shape, RECORD_WORDS * cap, (cap,))
        BUF_LAUNCHES += bands
        return block, prim
    lib = load_cuda_library(kernel_trace.library("march_bwd", n, ktb.SHARED_TABLE_MAX,
                                                 kernel_trace.texture_count(scene)))
    out = ktb.launch_block(lib, lib.rt_march_bwd, ptrs, n, words.device, cfg, args, g,
                           return_primal, origin, shape)
    LAUNCHES += 1
    return out


def render_grads_kernel(scene: Scene, cfg: RenderConfig, g: Color,
                        return_primal: bool = False, origin=(0, 0), shape=None):
    """The cotangents of the packed tables through the CUDA march backward
    kernel, for image cotangent ``g`` of the window at ``origin`` of size
    ``shape`` (three ``(h, w)`` f32 planes on the scene's CUDA device; the
    whole frame by default), the scene packed by the pack kernel.
    ``return_primal=True`` also returns the window's image the kernel
    marched (the march kernel's). Raises on anything the kernels do not
    take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march backward")
    block, prim = launch_words(scene, kernel_pack.launch_pack(scene), cfg,
                               Color(*(c.contiguous() for c in g)), return_primal, origin,
                               shape)
    grads = ktb.split_block(block, scene.objects.count)
    return (grads, prim) if return_primal else grads


class MarchRender(torch.autograd.Function):
    """The march image as a function of the scene's float leaves
    (``kernel_pack.float_leaves``): the pack kernel, then the march kernel,
    in the forward pass; the march backward kernel, then the pull-back
    kernel, in the backward pass, both over the window at ``origin`` of size
    ``shape``. The integer leaves, the config and the window get no
    gradient."""

    @staticmethod
    def forward(ctx, scene, cfg, origin, shape, *leaves):
        words = kernel_pack.launch_pack(scene)
        ctx.scene, ctx.cfg, ctx.words, ctx.window = scene, cfg, words, (origin, shape)
        img = kernel_march.render_words_kernel(scene, words, cfg, origin, shape)
        return img.r, img.g, img.b

    @staticmethod
    def backward(ctx, g_r, g_g, g_b):
        g = Color(*(c.contiguous() for c in (g_r, g_g, g_b)))
        block, _ = launch_words(ctx.scene, ctx.words, ctx.cfg, g, False, *ctx.window)
        return (None, None, None, None, *kernel_pack.pack_scene_vjp(ctx.scene, block))


def render_color_grad(scene: Scene, cfg: RenderConfig, origin=(0, 0), shape=None) -> Color:
    """Render a CUDA march scene, or the window at ``origin`` of size
    ``shape`` of its frame, through :class:`MarchRender`, so that autograd
    takes its gradient with the march backward kernel. Raises on anything
    the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march backward")
    window(cfg, origin, shape)  # raises before a launch on a window not in the frame
    return Color(*MarchRender.apply(scene, cfg, origin, shape,
                                    *kernel_pack.float_leaves(scene)))
