"""The trace-mode backward as one hand-written CUDA kernel, its plain
version, and the autograd pairing of the two trace kernels.

Counterpart of ``ray_rust_tpu/ops/pallas_bwd.py``. The kernel
(``csrc/trace_bwd.cu``, per-pixel body ``csrc/trace_bwd_body.cuh``) replaces
the Pallas kernel ``render_color_pallas_grads_site`` for trace-mode scenes of
any size the forward takes, textured or not (above :data:`SHARED_TABLE_MAX`
objects in its global-table build, ``trace_bwd_global``, which reads the
tables from global memory and adds straight to the output block): from the packed scene tables, the
texture atlas and the cotangent of the image it gives the cotangents of the
f32 table ``(N, 19)``, the camera ``(1, 8)`` and the light ``(1, 4)``. It
records each pixel's raycast sites with the forward kernel's own traversal,
then runs a hand-written adjoint over them backwards; at a textured hit only
the bilinear weights depend on the uv (the u8 texels get no gradient). Its
records are sized from the config: it is built for each record cap of
:data:`SITE_CAPS`, and :func:`site_cap` picks the smallest that holds the
config's sites; ``max_reflections`` 7 to 11 record with the forward's
64-task stack. The JAX kernel's pruned replay variants are not carried
over.

:class:`TraceRender` pairs the forward kernel with it, as ``_fast_fn``
(``pallas_trace.py:1670-1701``) pairs the JAX kernels, from the scene's
float leaves to the image: its forward packs the scene in one launch
(``kernel_pack``) and launches the trace kernel on the tables, which it
keeps; its backward launches this kernel and pulls the block back to the
leaves in one launch (``kernel_pack.pack_scene_vjp``, the counterpart of
``jax.vjp(pack_f32, scene)``); the atlas rides along as a constant.

:func:`render_grads_kernel` launches the kernel or raises; it never falls
back. :func:`render_grads_plain` computes the same three cotangents with
torch autograd of the plain trace (``kernel_trace.render_color_plain``); the
tests and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..models.material import MaterialTable
from ..models.quat import Quat
from ..models.scene import Camera, ObjectTable, Scene, scene_to_numpy
from ..models.vec import Color, Vec3
from . import kernel_pack, kernel_trace
from .kernel_pack import GRAD_COLS, split_block
from .kernel_trace import check_launchable, check_tensor, library, pack_scene, texture_args
from .rays import fov_scales

__all__ = [
    "SITE_CAPS",
    "SHARED_TABLE_MAX",
    "count_sites",
    "site_cap",
    "unsupported_reason",
    "kernel_supported",
    "kernel_args",
    "launch_args",
    "launch_block",
    "launch_words",
    "split_block",
    "render_grads_kernel",
    "render_grads_plain",
    "leaf_grads",
    "TraceRender",
    "render_color_grad",
]

# Launches of the backward kernel since import (or since a caller reset it).
LAUNCHES = 0

# The record caps the kernel is built for (csrc/trace_bwd_body.cuh:
# rt::with_site_cap): the default config's 11 sites, refraction_unroll=None
# up to 4 reflections (63), and up to 191, the most of any config the
# forward kernel takes (6 reflections, refraction_unroll=None).
SITE_CAPS = (16, 64, 192)

# The most objects whose tables and (n+1, 20) cotangent block the backward
# frame (csrc/bwd_kernel.cuh, K2's and K4's) keeps in shared memory: its
# 32x8 blocks run two an SM, which leaves each block 233472 / 2 - 1024 =
# 115712 bytes, and an object takes 92 bytes of tables and 80 of the block.
# Above it the global-table builds run (PERF.md §6).
SHARED_TABLE_MAX = 640


class _Node(NamedTuple):
    """One raycast site of the unrolled ray tree and the sites of its
    refraction sub-trace (``pallas_bwd.py:_Node``)."""

    sid: int
    children: tuple


def _site_nodes(cfg: RenderConfig, lev: int = 0, counter=None) -> tuple:
    """The static site tree of a trace at level ``lev``
    (``pallas_bwd.py:_site_nodes``): one site per bounce, and under each
    bounce below the refraction cap the sites of its sub-trace."""
    if counter is None:
        counter = [0]
    nodes = []
    for step in range(max(1, cfg.max_reflections - lev)):
        lev_i = lev + 1 + step
        sid = counter[0]
        counter[0] += 1
        children = _site_nodes(cfg, lev_i, counter) if lev_i < cfg.refraction_cap() else ()
        nodes.append(_Node(sid, children))
    return tuple(nodes)


def _count(nodes) -> int:
    return sum(1 + _count(n.children) for n in nodes)


def count_sites(cfg: RenderConfig) -> int:
    """The most raycast sites one pixel can reach under ``cfg`` (11 at the
    default config, 35 at ``refraction_unroll=None``)."""
    return _count_sites(cfg.max_reflections, cfg.refraction_cap())


@functools.lru_cache(maxsize=None)
def _count_sites(max_reflections: int, refraction_cap: int) -> int:
    """:func:`count_sites` of the two fields the site tree reads."""
    cfg = RenderConfig(max_reflections=max_reflections, max_refractions=refraction_cap,
                       refraction_unroll=None)
    return _count(_site_nodes(cfg))


def site_cap(cfg: RenderConfig) -> int:
    """The record cap the kernel is launched with under ``cfg``: the
    smallest of :data:`SITE_CAPS` that holds :func:`count_sites`."""
    sites = count_sites(cfg)
    for cap in SITE_CAPS:
        if cap >= sites:
            return cap
    raise ValueError(f"{sites} raycast sites per pixel; the backward kernel is built for at "
                     f"most {SITE_CAPS[-1]}")


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the two trace kernels cannot take a gradient of ``scene`` under
    ``cfg``, or None: the forward kernel's reasons, then the record caps
    (``refraction_unroll=None`` past 6 reflections needs more than 192
    sites)."""
    reason = kernel_trace.unsupported_reason(scene, cfg)
    if reason is not None:
        return reason
    sites = count_sites(cfg)
    if sites > SITE_CAPS[-1]:
        return (f"{sites} raycast sites per pixel; the backward kernel records at most "
                f"{SITE_CAPS[-1]}")
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Trace mode, at most 512 objects, textured or not."""
    return unsupported_reason(scene, cfg) is None


def _scene_from_tables(f32t, i32t, cam, light, textures, texture_filter) -> Scene:
    """A scene whose leaves are the tables' columns, one material per
    object, with the texture bank ``textures`` (or None) and each object's
    texture filter ``texture_filter``: it renders as the scene the tables
    were packed from, and its gradient is the tables' cotangent."""
    n = f32t.shape[0]

    def col(k):
        return f32t[:, k]

    def vec(k):
        return Vec3(col(k), col(k + 1), col(k + 2))

    ones = torch.ones_like(col(0))
    objects = ObjectTable(kind=i32t[:, 0], org=vec(0), radius=col(17), normal=vec(3),
                          mat=torch.arange(n, dtype=torch.int32, device=f32t.device),
                          uvmap=i32t[:, 2])
    materials = MaterialTable(
        diffuse=Color(col(6), col(7), col(8)), specular=Color(col(9), col(10), col(11)),
        pn=col(12), transparency=col(13), refraction=col(14), glow_dist=col(18),
        frac=Color(ones, ones, ones), pattern=i32t[:, 1], pattern_scale=col(15),
        pattern_angle_scale=col(16), texture_id=i32t[:, 3], texture_filter=texture_filter)
    c = cam[0]
    pad = c[7]  # pyr is not rendered: the pad stands in
    camera = Camera(position=Vec3(c[0], c[1], c[2]), pyr=Vec3(pad, pad, pad),
                    rotation=Quat(c[3], c[4], c[5], c[6]))
    return Scene(objects, materials, camera, Vec3(light[0, 0], light[0, 1], light[0, 2]),
                 textures)


def render_grads_plain(scene: Scene, cfg: RenderConfig, g: Color):
    """The kernel's function in plain PyTorch: torch autograd of
    ``render_color_plain`` pulls the image cotangent ``g`` back to the packed
    tables. Returns ``(g_f32t (N, 19), g_cam (1, 8), g_light (1, 4))``."""
    f32t, i32t, cam, light = (t.detach() for t in pack_scene(scene))
    wrt = tuple(t.requires_grad_() for t in (f32t, cam, light))
    filt = scene.materials.texture_filter[scene.objects.mat.long()]
    with torch.enable_grad():
        img = kernel_trace.render_color_plain(
            _scene_from_tables(f32t, i32t, cam, light, scene.textures, filt), cfg)
        grads = torch.autograd.grad(tuple(img), wrt, tuple(g), allow_unused=True)
    return tuple(torch.zeros_like(t) if gr is None else gr for t, gr in zip(wrt, grads))


def kernel_args(cfg: RenderConfig) -> list:
    """The launcher's render arguments after the image size and field of
    view (also those of the host build, ``csrc/trace_bwd_host.cpp``): the
    forward kernel's, then ``grad_distance_cutoff`` (+inf for None)."""
    cutoff = cfg.grad_distance_cutoff
    return kernel_trace.kernel_args(cfg) + [float("inf") if cutoff is None else float(cutoff)]


def launch_args(cfg: RenderConfig, tex, device) -> list:
    """This kernel's arguments after the image size and field of view (also
    its host build's): :func:`kernel_args`, the record cap
    (:func:`site_cap`) and :func:`kernel_trace.texture_args` of atlas
    ``tex`` on ``device``."""
    return kernel_args(cfg) + [site_cap(cfg)] + texture_args(tex, device)


def launch_block(lib, fn, ptrs: list, n: int, dev, cfg: RenderConfig, args: list, g: Color,
                 return_primal: bool):
    """Call backward launcher ``fn`` of ``lib`` as ``fn(tables, n, xres,
    yres, sx, sy, *args, g_r, g_g, g_b, block, prim_r, prim_g, prim_b,
    device, stream)`` (``args``: :func:`launch_args` for this kernel, the
    march backward's ``kernel_args`` for it) on the tables' addresses
    ``ptrs`` (f32 table, i32 table, camera, light: the pack kernel's words,
    ``kernel_pack.word_pointers``) of ``n`` objects and image cotangent
    planes ``g`` on CUDA device ``dev``; returns the kernel's ``(n+1,
    GRAD_COLS)`` block and, with ``return_primal``, the image the kernel
    traced (else None). Raises if the cotangent or the launch is not as the
    kernel takes it."""
    for name, plane in zip("rgb", g):
        check_tensor(plane, f"cotangent {name}", torch.float32, (cfg.yres, cfg.xres), dev)
    block = torch.zeros((n + 1, GRAD_COLS), dtype=torch.float32, device=dev)
    prim = (torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
            if return_primal else None)
    plane = 4 * cfg.yres * cfg.xres
    prim_ptrs = ([prim.data_ptr() + k * plane for k in range(3)] if return_primal
                 else [None] * 3)
    sx, sy = fov_scales(cfg)
    rc = fn(*ptrs, n, cfg.xres, cfg.yres, sx, sy, *args, *(c.data_ptr() for c in g),
            block.data_ptr(), *prim_ptrs, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {lib.rt_error_string(rc).decode()}")
    return block, (Color(*prim.unbind(0)) if return_primal else None)


def launch_words(scene: Scene, words: torch.Tensor, cfg: RenderConfig, g: Color,
                 return_primal: bool):
    """Launch the backward kernel on the pack kernel's ``words`` of
    ``scene`` (``kernel_pack.launch_pack``) and its cached atlas, straight
    from their addresses, counting it; returns as
    :func:`launch_block`."""
    global LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = kernel_pack.word_pointers(words, n)
    lib = load_cuda_library(library("trace_bwd", n, SHARED_TABLE_MAX))
    args = kernel_args(cfg) + [site_cap(cfg)] + kernel_pack.texture_pointers(scene, meta)
    out = launch_block(lib, lib.rt_trace_bwd, ptrs, n, words.device, cfg, args, g, return_primal)
    LAUNCHES += 1
    return out


def render_grads_kernel(scene: Scene, cfg: RenderConfig, g: Color,
                        return_primal: bool = False):
    """The cotangents of the packed tables through the CUDA backward kernel,
    for image cotangent ``g`` (three ``(H, W)`` f32 planes on the scene's
    CUDA device), the scene packed by the pack kernel. ``return_primal=True``
    also returns the image the kernel traced (the forward kernel's). Raises
    on anything the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    block, prim = launch_words(scene, kernel_pack.launch_pack(scene), cfg,
                               Color(*(c.contiguous() for c in g)), return_primal)
    grads = split_block(block, scene.objects.count)
    return (grads, prim) if return_primal else grads


def leaf_grads(scene: Scene, table_grads) -> dict:
    """The cotangents of ``scene``'s float leaves, keyed by
    :func:`scene_to_numpy`'s dotted paths, given those of its packed f32
    table, camera and light: autograd of :func:`pack_scene`
    (``kernel_pack.pack_scene_vjp_plain``) on either device, zeros for the
    leaves the tables do not read. The tests and ``chip_smoke.py`` hold the
    kernels' cotangents against the plain ones through it, so it stays
    plain: the pull-back kernel is held against it on its own."""
    paths = [p for p, t in zip(scene_to_numpy(scene), scene.tensors()) if t.is_floating_point()]
    return dict(zip(paths, kernel_pack.pack_scene_vjp_plain(scene, table_grads)))


class TraceRender(torch.autograd.Function):
    """The image as a function of the scene's float leaves
    (``kernel_pack.float_leaves``), as ``_fast_fn`` pairs the JAX kernels
    from the scene to the image: the forward packs the scene with the pack
    kernel and launches the trace kernel on the tables, which it keeps; the
    backward launches the backward kernel on them and pulls its block back
    to the leaves with the pull-back kernel (zeros for ``frac`` and
    ``pyr``, which the tables do not read). The integer leaves, the texture
    atlas and the config get no gradient."""

    @staticmethod
    def forward(ctx, scene, cfg, *leaves):
        words = kernel_pack.launch_pack(scene)
        ctx.scene, ctx.cfg, ctx.words = scene, cfg, words
        img = kernel_trace.render_words_kernel(scene, words, cfg)
        return img.r, img.g, img.b

    @staticmethod
    def backward(ctx, g_r, g_g, g_b):
        g = Color(*(c.contiguous() for c in (g_r, g_g, g_b)))
        block, _ = launch_words(ctx.scene, ctx.words, ctx.cfg, g, False)
        return (None, None, *kernel_pack.pack_scene_vjp(ctx.scene, block))


def render_color_grad(scene: Scene, cfg: RenderConfig) -> Color:
    """Render a CUDA scene through :class:`TraceRender`, so that autograd
    takes its gradient with the backward kernel. Raises on anything the
    kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    return Color(*TraceRender.apply(scene, cfg, *kernel_pack.float_leaves(scene)))
