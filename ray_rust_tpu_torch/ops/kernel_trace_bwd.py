"""The trace-mode backward as one hand-written CUDA kernel, its plain
version, and the autograd pairing of the two trace kernels.

Counterpart of ``ray_rust_tpu/ops/pallas_bwd.py``. The kernel
(``csrc/trace_bwd.cu``, per-pixel body ``csrc/trace_bwd_body.cuh``) replaces
the Pallas kernel ``render_color_pallas_grads_site`` for trace-mode scenes of
any size the forward takes, textured or not (above :data:`SHARED_TABLE_MAX`
objects in its global-table build, ``trace_bwd_global``, which reads the
tables from global memory and adds straight to the launch's int64 block):
from the packed scene tables, the
texture atlas and the cotangent of the image it gives the cotangents of the
f32 table ``(N, 19)``, the camera ``(1, 8)`` and the light ``(1, 4)``. It
records each pixel's raycast sites with the forward kernel's own traversal,
then runs a hand-written adjoint over them backwards; at a textured hit only
the bilinear weights depend on the uv (the u8 texels get no gradient). Its
records are sized from the config: it is built for each record cap of
:data:`SITE_CAPS`, and :func:`site_cap` picks the smallest that holds the
config's sites. Past the largest (7 reflections at ``refraction_unroll=None``
need 319) a third kind of instance keeps the records in a buffer in device
memory (:data:`RECORD_WORDS` words a site), which :func:`launch_buffered`
allocates within :data:`RECORD_BUDGET` and fills band by band of the
window's rows (:func:`record_bands`). It records with the forward's task
stack (``kernel_trace.stack_tasks``: 16 tasks, or 64 past a refraction cap
of 17). The JAX kernel's pruned replay variants are not carried over.
Every sum across the kernel's threads is a 64-bit fixed-point sum
(``csrc/fixed_sum.cuh``), so the same inputs give the same block bit for
bit, launch after launch; a buffer instance's bands sum into one block.

:class:`TraceRender` pairs the forward kernel with it, as ``_fast_fn``
(``pallas_trace.py:1670-1701``) pairs the JAX kernels, from the scene's
float leaves to the image: its forward packs the scene in one launch
(``kernel_pack``) and launches the trace kernel on the tables, which it
keeps; its backward launches this kernel and pulls the block back to the
leaves in one launch (``kernel_pack.pack_scene_vjp``, the counterpart of
``jax.vjp(pack_f32, scene)``); the atlas rides along as a constant.

Each of them covers a window of the frame at its global origin (``origin=``,
``shape=``: ``kernel_trace.window``; the whole frame by default), as the JAX
kernels' ``origin=`` and ``shape=`` do: the cotangent and the primal are the
window's ``(h, w)`` planes, and each pixel differentiates as the whole
frame's, so a window's block is the whole frame's with the image cotangent
zero outside it (at the window's own fixed-point scale, so up to its
rounding).
The multi-device layer (``parallel/shard.py``) differentiates a frame as
windows.

:func:`render_grads_kernel` launches the kernel or raises; it never falls
back. :func:`render_grads_plain` computes the same three cotangents with
torch autograd of the plain trace (``kernel_trace.render_color_plain``); the
tests and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..models.material import MaterialTable
from ..models.quat import Quat
from ..models.scene import Camera, ObjectTable, Scene, scene_to_numpy
from ..models.vec import Color, Vec3
from . import kernel_pack, kernel_trace
from .kernel_pack import GRAD_COLS, split_block
from .kernel_trace import (
    check_launchable,
    check_tensor,
    count_sites,
    library,
    pack_scene,
    texture_args,
)
from .rays import fov_scales, window

__all__ = [
    "SITE_CAPS",
    "SHARED_TABLE_MAX",
    "SITE_WORDS",
    "RECORD_WORDS",
    "RECORD_BUDGET",
    "RECORD_FILL",
    "count_sites",
    "site_cap",
    "buffered",
    "record_bands",
    "launch_buffered",
    "recorded",
    "unsupported_reason",
    "kernel_supported",
    "kernel_args",
    "launch_args",
    "launch_block",
    "launch_words",
    "split_block",
    "render_grads_kernel",
    "render_grads_plain",
    "plain_vjp",
    "leaf_grads",
    "TraceRender",
    "render_color_grad",
]

# Launches of the backward kernel since import (or since a caller reset it):
# its instances with local records, and its buffer instance (one a band).
LAUNCHES = 0
BUF_LAUNCHES = 0

# The record caps the kernel is built for (csrc/trace_bwd_body.cuh:
# rt::with_site_cap): the default config's 11 sites, refraction_unroll=None
# up to 4 reflections (63), and up to 191 (6 reflections,
# refraction_unroll=None; 25 at the default unroll). Past it the buffer
# instance runs.
SITE_CAPS = (16, 64, 192)
# Words of a site's records in the buffer instance: its Site (56 bytes),
# the buffer's first kind of record, and its TaskRec (48;
# csrc/trace_bwd_body.cuh, static_assert).
SITE_WORDS = 14
RECORD_WORDS = SITE_WORDS + 12
# The device memory a buffer instance's records may take at once (K2's and
# K4's), read at each launch: a 1080p frame at 319 sites would need 69 GB,
# so it runs in 5 bands of 269 rows. Each band costs a launch and a tail:
# on an H100 K2 there took 0.62 ms in 17 bands (a 4 GiB budget), 0.44 in 5
# and 0.39 in 2 (34 GB; PERF.md §6), so the budget trades a fifth of an 80
# GB card for most of that gain.
RECORD_BUDGET = 16 * 2**30
# The word :func:`recorded` finds where a launch wrote no record: a NaN
# whose payload no record word takes.
RECORD_FILL = 0x7FBADBAD

# The most objects whose tables and (n+1, 20) cotangent block the backward
# frame (csrc/bwd_kernel.cuh, K2's and K4's) keeps in shared memory: its
# 32x8 blocks run two an SM, which leaves each block 233472 / 2 - 1024 =
# 115712 bytes, and an object takes 92 bytes of tables and 320 of the
# block's int64 fixed-point digits (279 objects; 640 when the block was
# f32, PERF.md §6). Above it the global-table builds run.
SHARED_TABLE_MAX = 272


def site_cap(cfg: RenderConfig) -> int:
    """The record cap the kernel is launched with under ``cfg``: the
    smallest of :data:`SITE_CAPS` that holds :func:`count_sites`, or past
    the largest the site count itself, which the buffer instance takes
    (:func:`buffered`)."""
    sites = count_sites(cfg)
    return next((cap for cap in SITE_CAPS if cap >= sites), sites)


def buffered(cfg: RenderConfig) -> bool:
    """Whether the kernel keeps ``cfg``'s records in a buffer in device
    memory: more sites than the largest of :data:`SITE_CAPS`."""
    return count_sites(cfg) > SITE_CAPS[-1]


def record_reason(words: int, budget: int, what: str) -> Optional[str]:
    """Why a pixel's ``words`` record words do not fit ``budget`` bytes,
    or None."""
    if 4 * words > budget:
        return (f"{what}: {4 * words} bytes of records a pixel; the record buffer holds "
                f"{budget}")
    return None


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the two trace kernels cannot take a gradient of ``scene`` under
    ``cfg``, or None: the forward kernel's reasons (its task stack among
    them), then a pixel's records past :data:`RECORD_BUDGET`."""
    reason = kernel_trace.unsupported_reason(scene, cfg)
    if reason is not None:
        return reason
    return record_reason(RECORD_WORDS * site_cap(cfg), RECORD_BUDGET,
                         f"{count_sites(cfg)} raycast sites per pixel")


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Trace mode, scenes within ``kernel_trace.size_reason``'s limit (the
    pack's int32 words and K1b's masks in a block's shared memory),
    textured or not, a task stack of at most 64 tasks, and a pixel's records
    within :data:`RECORD_BUDGET`."""
    return unsupported_reason(scene, cfg) is None


def record_bands(h: int, w: int, pixel_bytes: int, budget: Optional[int] = None) -> list:
    """Bands ``(r0, c0, rows, cols)`` of an ``(h, w)`` window whose
    records, ``pixel_bytes`` a pixel, fit ``budget`` bytes each (by default
    :data:`RECORD_BUDGET`): runs of whole rows, or pieces of one row where a
    row does not fit. Each band's planes are one contiguous run of the
    window's."""
    budget = RECORD_BUDGET if budget is None else budget
    per = budget // pixel_bytes
    if per < 1:
        raise ValueError(f"{pixel_bytes} bytes of records a pixel; the buffer holds {budget}")
    if per >= w:
        rows = min(h, per // w)
        return [(r, 0, min(rows, h - r), w) for r in range(0, h, rows)]
    return [(r, c, 1, min(per, w - c)) for r in range(h) for c in range(0, w, per)]


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


def plain_vjp(scene: Scene, cfg: RenderConfig, origin=(0, 0), shape=None, rows=None):
    """``(image, vjp)``: the plain version's image of the window at
    ``origin`` of size ``shape`` (``render_color_plain``; the whole frame by
    default; or of the whole ``rows``), rendered from the packed tables
    under autograd, and the function that pulls a cotangent ``g`` of that
    image back to the tables once: ``vjp(g) -> (g_f32t (N, 19), g_cam (1,
    8), g_light (1, 4))``. The graph lives until then, so the cotangent may
    depend on the image."""
    f32t, i32t, cam, light = (t.detach() for t in pack_scene(scene))
    wrt = tuple(t.requires_grad_() for t in (f32t, cam, light))
    filt = scene.materials.texture_filter[scene.objects.mat.long()]
    with torch.enable_grad():
        img = kernel_trace.render_color_plain(
            _scene_from_tables(f32t, i32t, cam, light, scene.textures, filt), cfg, origin, shape,
            rows)

    def vjp(g: Color):
        grads = torch.autograd.grad(tuple(img), wrt, tuple(g), allow_unused=True)
        return tuple(torch.zeros_like(t) if gr is None else gr for t, gr in zip(wrt, grads))

    return Color(*(c.detach() for c in img)), vjp


def render_grads_plain(scene: Scene, cfg: RenderConfig, g: Color, origin=(0, 0), shape=None):
    """The kernel's function in plain PyTorch: torch autograd of
    ``render_color_plain`` over the window at ``origin`` of size ``shape``
    (the whole frame by default) pulls the window's image cotangent ``g``
    back to the packed tables (:func:`plain_vjp`). Returns ``(g_f32t (N,
    19), g_cam (1, 8), g_light (1, 4))``."""
    return plain_vjp(scene, cfg, origin, shape)[1](g)


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
                 return_primal: bool, origin=(0, 0), shape=None, extra=(), tail=None):
    """Call backward launcher ``fn`` of ``lib`` as ``fn(tables, n, xres,
    yres, row0, col0, h, w, sx, sy, *args, g_r, g_g, g_b, block, prim_r,
    prim_g, prim_b, *extra, device, stream)`` (``args``: :func:`launch_args`
    for this kernel, the march backward's ``kernel_args`` for it) on the
    tables' addresses ``ptrs`` (f32 table, i32 table, camera, light: the
    pack kernel's words, ``kernel_pack.word_pointers``) of ``n`` objects
    and the image cotangent planes ``g`` of the window at ``origin`` of size
    ``shape`` (``(h, w)``; the whole frame by default) on CUDA device
    ``dev``, or on the CPU a host build's launcher (``tail``: the arguments
    after ``extra``, by default the device and the stream, or on the CPU a
    null operation counter), once. Returns the ``(n+1, GRAD_COLS)`` block
    and, with ``return_primal``, the window's image the kernel traced (else
    None). Raises if the cotangent or the launch is not as the kernel takes
    it, naming the launcher's error (``lib.rt_error_string``: a CUDA error,
    or the fixed-point sum's overflow)."""
    row0, col0, h, w = window(cfg, origin, shape)
    for name, plane in zip("rgb", g):
        check_tensor(plane, f"cotangent {name}", torch.float32, (h, w), dev)
    block = torch.zeros((n + 1, GRAD_COLS), dtype=torch.float32, device=dev)
    prim = torch.empty((3, h, w), dtype=torch.float32, device=dev) if return_primal else None
    prim_ptrs = [p.data_ptr() for p in prim] if return_primal else [None] * 3
    sx, sy = fov_scales(cfg)
    if tail is None:
        tail = ((dev.index, torch.cuda.current_stream(dev).cuda_stream) if dev.type == "cuda"
                else (None,))
    rc = fn(*ptrs, n, cfg.xres, cfg.yres, row0, col0, h, w, sx, sy, *args,
            *(p.data_ptr() for p in g), block.data_ptr(), *prim_ptrs, *extra, *tail)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {lib.rt_error_string(rc).decode()}")
    return block, (Color(*prim.unbind(0)) if return_primal else None)


def launch_buffered(lib, fn, ptrs: list, n: int, dev, cfg: RenderConfig, args: list, g: Color,
                    return_primal: bool, origin=(0, 0), shape=None, cap_words: int = 0,
                    extra=(), budget: Optional[int] = None, tail=None, buf=None):
    """:func:`launch_block` for a buffer instance's launcher ``fn``, whose
    records take ``cap_words`` words a pixel: a buffer for the largest of
    the window's :func:`record_bands` within ``budget`` bytes (by default
    :data:`RECORD_BUDGET`), allocated on ``dev`` (or the caller's int32
    ``buf``, as large or larger) and passed after ``extra`` (K4's record
    cap) with the bands' rows and columns, then ``tail``: the launcher runs
    the window band by band in stream order, every band summing into one
    block at the window's fixed-point scale (``csrc/bwd_kernel.cuh``), so
    the block is a one-band launch's bit for bit. Returns the block, the
    image (or None) and the bands (the kernel's launches)."""
    row0, col0, h, w = window(cfg, origin, shape)
    bands = record_bands(h, w, 4 * cap_words, budget)
    words = bands[0][2] * bands[0][3] * cap_words
    if buf is None:
        buf = torch.empty(words, dtype=torch.int32, device=dev)
    elif buf.dtype != torch.int32 or buf.numel() < words or buf.device != dev:
        raise ValueError(f"the record buffer must hold {words} int32 words on {dev}")
    block, prim = launch_block(lib, fn, ptrs, n, dev, cfg, args, g, return_primal, origin, shape,
                               tuple(extra) + (buf.data_ptr(), bands[0][2], bands[0][3]), tail)
    return block, prim, len(bands)


def recorded(buf: torch.Tensor, cap: int, words: int, pixels: int) -> torch.Tensor:
    """The records of the first kind (``words`` words each, ``cap`` a
    pixel: K2's sites, K4's laps) that each pixel of a one-band launch over
    ``pixels`` pixels wrote into ``buf``, filled with :data:`RECORD_FILL`
    before it: one past the last record any of whose words changed."""
    written = (buf[:cap * words * pixels].view(cap, words, pixels) != RECORD_FILL).any(1)
    return (torch.arange(1, cap + 1, device=buf.device)[:, None] * written).amax(0)


def launch_words(scene: Scene, words: torch.Tensor, cfg: RenderConfig, g: Color,
                 return_primal: bool, origin=(0, 0), shape=None):
    """Launch the backward kernel on the pack kernel's ``words`` of
    ``scene`` (``kernel_pack.launch_pack``) and its cached atlas, straight
    from their addresses, over the window at ``origin`` of size ``shape``,
    counting it: an instance with local records, or past :data:`SITE_CAPS`
    the buffer instance band by band (:func:`launch_buffered`); returns as
    :func:`launch_block`."""
    global LAUNCHES, BUF_LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = kernel_pack.word_pointers(words, n)
    lib = load_cuda_library(library("trace_bwd", n, SHARED_TABLE_MAX,
                                    kernel_trace.texture_count(scene)))
    cap = site_cap(cfg)
    args = kernel_args(cfg) + [cap] + kernel_pack.texture_pointers(scene, meta)
    if buffered(cfg):
        block, prim, bands = launch_buffered(lib, lib.rt_trace_bwd_buf, ptrs, n, words.device,
                                             cfg, args, g, return_primal, origin, shape,
                                             RECORD_WORDS * cap)
        BUF_LAUNCHES += bands
        return block, prim
    out = launch_block(lib, lib.rt_trace_bwd, ptrs, n, words.device, cfg, args, g, return_primal,
                       origin, shape)
    LAUNCHES += 1
    return out


def render_grads_kernel(scene: Scene, cfg: RenderConfig, g: Color,
                        return_primal: bool = False, origin=(0, 0), shape=None):
    """The cotangents of the packed tables through the CUDA backward kernel,
    for image cotangent ``g`` of the window at ``origin`` of size ``shape``
    (three ``(h, w)`` f32 planes on the scene's CUDA device; the whole frame
    by default), the scene packed by the pack kernel. ``return_primal=True``
    also returns the window's image the kernel traced (the forward kernel's).
    Raises on anything the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    block, prim = launch_words(scene, kernel_pack.launch_pack(scene), cfg,
                               Color(*(c.contiguous() for c in g)), return_primal, origin,
                               shape)
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
    ``pyr``, which the tables do not read). Both kernels cover the window at
    ``origin`` of size ``shape`` (the whole frame for ``shape=None``). The
    integer leaves, the texture atlas, the config and the window get no
    gradient."""

    @staticmethod
    def forward(ctx, scene, cfg, origin, shape, *leaves):
        words = kernel_pack.launch_pack(scene)
        ctx.scene, ctx.cfg, ctx.words, ctx.window = scene, cfg, words, (origin, shape)
        img = kernel_trace.render_words_kernel(scene, words, cfg, origin, shape)
        return img.r, img.g, img.b

    @staticmethod
    def backward(ctx, g_r, g_g, g_b):
        g = Color(*(c.contiguous() for c in (g_r, g_g, g_b)))
        block, _ = launch_words(ctx.scene, ctx.words, ctx.cfg, g, False, *ctx.window)
        return (None, None, None, None, *kernel_pack.pack_scene_vjp(ctx.scene, block))


def render_color_grad(scene: Scene, cfg: RenderConfig, origin=(0, 0), shape=None) -> Color:
    """Render a CUDA scene, or the window at ``origin`` of size ``shape``
    of its frame, through :class:`TraceRender`, so that autograd takes its
    gradient with the backward kernel. Raises on anything the kernels do not
    take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace backward")
    window(cfg, origin, shape)  # raises before a launch on a window not in the frame
    return Color(*TraceRender.apply(scene, cfg, origin, shape,
                                    *kernel_pack.float_leaves(scene)))
