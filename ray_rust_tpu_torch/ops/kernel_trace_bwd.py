"""The trace-mode backward as one hand-written CUDA kernel, its plain
version, and the autograd pairing of the two trace kernels.

Counterpart of ``ray_rust_tpu/ops/pallas_bwd.py``. The kernel
(``csrc/trace_bwd.cu``, per-pixel body ``csrc/trace_bwd_body.cuh``) replaces
the Pallas kernel ``render_color_pallas_grads_site`` for trace-mode scenes of
up to 512 objects, textured or not: from the packed scene tables, the
texture atlas and the cotangent of the image it gives the cotangents of the
f32 table ``(N, 19)``, the camera ``(1, 8)`` and the light ``(1, 4)``. It
records each pixel's raycast sites with the forward kernel's own traversal,
then runs a hand-written adjoint over them backwards; at a textured hit only
the bilinear weights depend on the uv (the u8 texels get no gradient). The
JAX kernel's pruned replay variants are not carried over.

:class:`TraceRender` pairs the forward kernel with it, as ``_fast_fn``
(``pallas_trace.py:1670-1701``) pairs the JAX kernels: its forward launches
the trace kernel on the packed tables and saves nothing else, its backward
launches this kernel; the atlas rides along as a constant.
:func:`render_color_grad` wraps the scene's
differentiable :func:`pack_scene` around it, so autograd carries the table
cotangents to the scene's leaves, through the object->material gather (the
counterpart of ``jax.vjp(pack_f32, scene)``).

:func:`render_grads_kernel` launches the kernel or raises; it never falls
back. :func:`render_grads_plain` computes the same three cotangents with
torch autograd of the plain trace (``kernel_trace.render_color_plain``); the
tests and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..models.material import MaterialTable
from ..models.quat import Quat
from ..models.scene import Camera, ObjectTable, Scene, scene_to_numpy
from ..models.vec import Color, Vec3
from . import kernel_trace
from .kernel_trace import (
    F32_COLS,
    check_launchable,
    check_tables,
    check_tensor,
    pack_scene,
    pack_textures,
    texture_args,
)
from .rays import fov_scales

__all__ = [
    "SITE_CAP",
    "count_sites",
    "unsupported_reason",
    "kernel_supported",
    "kernel_args",
    "launch_grads",
    "split_block",
    "render_grads_kernel",
    "render_grads_plain",
    "leaf_grads",
    "TraceRender",
    "render_color_grad",
]

# Launches of the backward kernel since import (or since a caller reset it).
LAUNCHES = 0

# Raycast sites a pixel may record (csrc/trace_bwd_body.cuh: rt::SITE_CAP):
# refraction_unroll=None at 3 reflections needs 35.
SITE_CAP = 35
GRAD_COLS = 20  # the kernel's block: object rows of 19, then camera 7 + light 3


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
    return _count(_site_nodes(cfg))


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the two trace kernels cannot take a gradient of ``scene`` under
    ``cfg``, or None: the forward kernel's reasons, and the site cap."""
    reason = kernel_trace.unsupported_reason(scene, cfg)
    if reason is not None:
        return reason
    sites = count_sites(cfg)
    if sites > SITE_CAP:
        return (f"{sites} raycast sites per pixel; the backward kernel records at "
                f"most {SITE_CAP}")
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Trace mode, at most 512 objects, textured or not, at most
    ``SITE_CAP`` raycast sites per pixel."""
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


def launch_grads(lib, fn, tables, cfg: RenderConfig, args: list, g: Color,
                 return_primal: bool):
    """Call backward launcher ``fn`` of ``lib`` as ``fn(tables, n, xres, yres,
    sx, sy, *args, g_r, g_g, g_b, block, prim_r, prim_g, prim_b, device,
    stream)`` (``args``: :func:`kernel_args` and, for this kernel,
    :func:`kernel_trace.texture_args`) on packed tables and image cotangent
    planes ``g`` on their
    CUDA device; returns :func:`split_block`'s three cotangents, and the
    image the kernel traced with ``return_primal``. Raises if the inputs or
    the launch are not as the kernel takes them."""
    check_tables(tables)
    f32t, i32t, cam, light = tables
    n, dev = f32t.shape[0], f32t.device
    for name, plane in zip("rgb", g):
        check_tensor(plane, f"cotangent {name}", torch.float32, (cfg.yres, cfg.xres), dev)
    block = torch.zeros((n + 1, GRAD_COLS), dtype=torch.float32, device=dev)
    prim = (torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
            if return_primal else None)
    prim_ptrs = [p.data_ptr() for p in prim] if return_primal else [None] * 3
    sx, sy = fov_scales(cfg)
    rc = fn(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(), n, cfg.xres,
            cfg.yres, sx, sy, *args, *(plane.data_ptr() for plane in g), block.data_ptr(),
            *prim_ptrs, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {lib.rt_error_string(rc).decode()}")
    grads = split_block(block, n)
    return (grads, Color(prim[0], prim[1], prim[2])) if return_primal else grads


def _launch(tables, tex, cfg: RenderConfig, g: Color, return_primal: bool):
    """Launch the backward kernel (:func:`launch_grads`) on packed tables and
    texture atlas ``tex`` (:func:`kernel_trace.pack_textures`)."""
    global LAUNCHES
    from ._build import load_cuda_library

    lib = load_cuda_library("trace_bwd")
    args = kernel_args(cfg) + texture_args(tex, tables[0].device)
    out = launch_grads(lib, lib.rt_trace_bwd, tables, cfg, args, g, return_primal)
    LAUNCHES += 1
    return out


def split_block(block: torch.Tensor, n: int):
    """The kernel's ``(n+1, 20)`` block as ``(g_f32t (n, 19), g_cam (1, 8),
    g_light (1, 4))``, the tables' shapes, zero in their pad columns."""
    zero = block.new_zeros(1)
    g_cam = torch.cat([block[n, 0:7], zero]).reshape(1, 8)
    g_light = torch.cat([block[n, 7:10], zero]).reshape(1, 4)
    return block[:n, :F32_COLS], g_cam, g_light


def render_grads_kernel(scene: Scene, cfg: RenderConfig, g: Color,
                        return_primal: bool = False):
    """The cotangents of the packed tables through the CUDA backward kernel,
    for image cotangent ``g`` (three ``(H, W)`` f32 planes on the scene's
    CUDA device). ``return_primal=True`` also returns the image the kernel
    traced (the forward kernel's). Raises on anything the kernel does not
    take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    tables = tuple(t.detach() for t in pack_scene(scene))
    return _launch(tables, pack_textures(scene), cfg, Color(*(c.contiguous() for c in g)),
                   return_primal)


def leaf_grads(scene: Scene, table_grads) -> dict:
    """The cotangents of ``scene``'s float leaves, keyed by
    :func:`scene_to_numpy`'s dotted paths, given those of its packed f32
    table, camera and light (autograd of :func:`pack_scene`)."""
    paths = list(scene_to_numpy(scene))
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    f32t, _, cam, light = pack_scene(scene.with_tensors(leaves))
    wrt = [(p, t) for p, t in zip(paths, leaves) if t.requires_grad]
    grads = torch.autograd.grad((f32t, cam, light), [t for _, t in wrt], tuple(table_grads),
                                allow_unused=True)
    return {p: torch.zeros_like(t) if gr is None else gr for (p, t), gr in zip(wrt, grads)}


class TraceRender(torch.autograd.Function):
    """The image as a function of the packed tables: the forward kernel in
    the forward pass, the backward kernel in the backward pass. The i32
    table, the texture atlas and its meta (None for an untextured scene)
    and the config get no gradient."""

    @staticmethod
    def forward(ctx, f32t, cam, light, i32t, atlas, meta, cfg):
        ctx.save_for_backward(f32t, cam, light, i32t, atlas, meta)
        ctx.cfg = cfg
        tex = None if atlas is None else (atlas, meta)
        img = kernel_trace.render_tables_kernel((f32t, i32t, cam, light), cfg, tex)
        return img.r, img.g, img.b

    @staticmethod
    def backward(ctx, g_r, g_g, g_b):
        f32t, cam, light, i32t, atlas, meta = ctx.saved_tensors
        g = Color(*(c.contiguous() for c in (g_r, g_g, g_b)))
        tex = None if atlas is None else (atlas, meta)
        g_f32t, g_cam, g_light = _launch((f32t, i32t, cam, light), tex, ctx.cfg, g, False)
        return g_f32t, g_cam, g_light, None, None, None, None


def render_color_grad(scene: Scene, cfg: RenderConfig) -> Color:
    """Render a CUDA scene through :class:`TraceRender`, so that autograd
    takes its gradient with the backward kernel. Raises on anything the two
    kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    f32t, i32t, cam, light = pack_scene(scene)
    atlas, meta = pack_textures(scene) or (None, None)
    return Color(*TraceRender.apply(f32t, cam, light, i32t, atlas, meta, cfg))
