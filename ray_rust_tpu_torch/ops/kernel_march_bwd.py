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
does.

:class:`MarchRender` pairs the march kernel with it, as ``_fast_march_fn``
(``pallas_trace.py:1705-1740``) pairs the JAX kernels, from the scene's
float leaves to the image: its forward packs the scene (``kernel_pack``)
and launches the march kernel on the tables, its backward launches this
kernel and pulls its block back to the leaves
(``kernel_pack.pack_scene_vjp``).

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

__all__ = [
    "SITE_CAP",
    "march_nodes",
    "count_sites",
    "count_frames",
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
# reset it).
LAUNCHES = 0

# Laps a pixel may record (csrc/march_bwd_body.cuh: rt::MARCH_SITE_CAP):
# refraction_unroll=None at 3 laps needs 35.
SITE_CAP = 35

# The kernel's function in plain PyTorch: autograd of the plain march, pulled
# back to the packed tables (the trace backward's, which renders through
# render_color_plain in either mode).
render_grads_plain = ktb.render_grads_plain


def march_nodes(cfg: RenderConfig) -> tuple:
    """The static lap-site tree of a march (``pallas_bwd.py:_march_unroll_nodes``):
    the trace tree with the laps' compile-time cap ``raymarch_max_reflections``
    in place of ``max_reflections``."""
    return ktb._site_nodes(cfg.with_(max_reflections=cfg.raymarch_max_reflections))


def count_sites(cfg: RenderConfig) -> int:
    """The most laps one pixel can run under ``cfg`` (11 at the default
    config, 35 at ``refraction_unroll=None``)."""
    return ktb._count(march_nodes(cfg))


def count_frames(cfg: RenderConfig) -> int:
    """The most raymarch calls one pixel can make (one glow record each,
    ``pallas_bwd.py:_glow_sid_map``): the camera ray's, and one sub-march
    under every lap below the refraction cap."""
    def calls(nodes):
        return 1 + sum(calls(n.children) for n in nodes if n.children)

    return calls(march_nodes(cfg))


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the two march kernels cannot take a gradient of ``scene`` under
    ``cfg``, or None: the march kernel's reasons, and the site cap."""
    reason = kernel_march.unsupported_reason(scene, cfg)
    if reason is not None:
        return reason
    sites = count_sites(cfg)
    if sites > SITE_CAP:
        return f"{sites} laps per pixel; the march backward kernel records at most {SITE_CAP}"
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """March mode, at most 512 objects (textured within the atlas limits),
    refraction depth at most ``kernel_march.FRAME_CAP``, at most
    ``SITE_CAP`` laps per pixel."""
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


def launch_words(scene: Scene, words, cfg: RenderConfig, g: Color, return_primal: bool):
    """Launch the march backward kernel on the pack kernel's ``words`` of
    ``scene`` (``kernel_pack.launch_pack``) and its cached texture atlas,
    straight from their addresses (``kernel_trace_bwd.launch_block``),
    counting it: its block and, with ``return_primal``, the image."""
    global LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = kernel_pack.word_pointers(words, n)
    lib = load_cuda_library(kernel_trace.library("march_bwd", n, ktb.SHARED_TABLE_MAX))
    out = ktb.launch_block(lib, lib.rt_march_bwd, ptrs, n, words.device, cfg,
                           kernel_args(cfg) + kernel_pack.texture_pointers(scene, meta), g,
                           return_primal)
    LAUNCHES += 1
    return out


def render_grads_kernel(scene: Scene, cfg: RenderConfig, g: Color,
                        return_primal: bool = False):
    """The cotangents of the packed tables through the CUDA march backward
    kernel, for image cotangent ``g`` (three ``(H, W)`` f32 planes on the
    scene's CUDA device), the scene packed by the pack kernel.
    ``return_primal=True`` also returns the image the kernel marched (the
    march kernel's). Raises on anything the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march backward")
    block, prim = launch_words(scene, kernel_pack.launch_pack(scene), cfg,
                               Color(*(c.contiguous() for c in g)), return_primal)
    grads = ktb.split_block(block, scene.objects.count)
    return (grads, prim) if return_primal else grads


class MarchRender(torch.autograd.Function):
    """The march image as a function of the scene's float leaves
    (``kernel_pack.float_leaves``): the pack kernel, then the march kernel,
    in the forward pass; the march backward kernel, then the pull-back
    kernel, in the backward pass. The integer leaves and the config get no
    gradient."""

    @staticmethod
    def forward(ctx, scene, cfg, *leaves):
        words = kernel_pack.launch_pack(scene)
        ctx.scene, ctx.cfg, ctx.words = scene, cfg, words
        img = kernel_march.render_words_kernel(scene, words, cfg)
        return img.r, img.g, img.b

    @staticmethod
    def backward(ctx, g_r, g_g, g_b):
        g = Color(*(c.contiguous() for c in (g_r, g_g, g_b)))
        block, _ = launch_words(ctx.scene, ctx.words, ctx.cfg, g, False)
        return (None, None, *kernel_pack.pack_scene_vjp(ctx.scene, block))


def render_color_grad(scene: Scene, cfg: RenderConfig) -> Color:
    """Render a CUDA march scene through :class:`MarchRender`, so that
    autograd takes its gradient with the march backward kernel. Raises on
    anything the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march backward")
    return Color(*MarchRender.apply(scene, cfg, *kernel_pack.float_leaves(scene)))
