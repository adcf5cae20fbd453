"""The trace forward as one hand-written CUDA kernel, and its plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py``. The kernel
(``csrc/trace_fwd.cu``, per-pixel body ``csrc/trace_body.cuh``) replaces the
Pallas kernel ``render_color_pallas``: camera rays, the reflection loop,
nearest-hit scans, shading with shadow rays, patterns and image textures
(K1a), the refraction subtree and the sky, one thread per pixel, for
trace-mode scenes of up to 512 objects. Every object is scanned for every
ray; the JAX kernel's per-tile cull for large scenes is exact, so it changes
no pixel, and it is later work. The texture atlas goes to the kernel as
:func:`pack_textures` lays it out.

:func:`render_color_kernel` launches the kernel or raises; it never falls
back. :func:`render_color_plain` computes the same function with PyTorch
operations (``ops/trace.py``); the renderer takes it for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from .rays import camera_rays, fov_scales
from .sky import BG_IDS
from .trace import trace_image

__all__ = [
    "pack_scene",
    "pack_textures",
    "texture_args",
    "kernel_supported",
    "unsupported_reason",
    "render_color_kernel",
    "render_tables_kernel",
    "render_color_plain",
    "kernel_args",
]

# Launches of the trace kernel since import (or since a caller reset it).
LAUNCHES = 0

KERNEL_OBJECT_MAX = 512  # the tables must fit one block's shared memory
STACK_CAP = 16  # csrc/trace_body.cuh: rt::STACK_CAP
F32_COLS, I32_COLS = 19, 4
TEX_META_COLS = 4  # csrc/trace_body.cuh: rt::TEX_META_COLS
TEXTURE_MAX = 1024  # the meta rows share the block's shared memory with the tables


def pack_scene(scene: Scene):
    """The kernel's scene tables, in the JAX kernel's column layout
    (``pallas_trace.py:_pack_scene``): f32 ``(N, 19)`` with the material
    fields joined through the object->material index, i32 ``(N, 4)``,
    camera ``(1, 8)`` and light ``(1, 4)``."""
    objs, mats = scene.objects, scene.materials
    m = objs.mat.long()
    f32t = torch.stack(
        [
            objs.org.x, objs.org.y, objs.org.z,
            objs.normal.x, objs.normal.y, objs.normal.z,
            mats.diffuse.r[m], mats.diffuse.g[m], mats.diffuse.b[m],
            mats.specular.r[m], mats.specular.g[m], mats.specular.b[m],
            mats.pn[m], mats.transparency[m], mats.refraction[m],
            mats.pattern_scale[m], mats.pattern_angle_scale[m],
            objs.radius,
            mats.glow_dist[m],
        ],
        dim=1,
    ).to(torch.float32)
    i32t = torch.stack(
        [objs.kind, mats.pattern[m], objs.uvmap, mats.texture_id[m]], dim=1
    ).to(torch.int32)
    cam = scene.camera
    zero = torch.zeros_like(scene.light.x)
    cam_t = torch.stack(
        [cam.position.x, cam.position.y, cam.position.z,
         cam.rotation.x, cam.rotation.y, cam.rotation.z, cam.rotation.w, zero]
    ).to(torch.float32).reshape(1, 8)
    light_t = torch.stack(
        [scene.light.x, scene.light.y, scene.light.z, zero]
    ).to(torch.float32).reshape(1, 4)
    return f32t, i32t, cam_t, light_t


def pack_textures(scene: Scene):
    """The kernel's texture atlas, or None for an untextured scene:
    ``(atlas, meta)``. ``atlas`` is ``(T, Hmax, Wmax, 4)`` int32, 16 bytes a
    texel holding its four taps (``TextureBank.packed``'s p00, p10,
    p01, p11) as ``r | g<<8 | b<<16`` words, texture-major with row stride
    ``Wmax``: the layout of the JAX package's ``_pack_textures``
    (``pallas_trace.py:200-265``) without its 128-lane chunks. ``meta`` is
    ``(T, 4)`` int32 rows ``[width, height, base texel, filter]``, the
    filter of the texture's owner material (by scatter-max, so a texture
    shared by a Nearest and a Bilinear material is Bilinear, as there)."""
    bank = scene.textures
    if bank is None:
        return None
    t, hmax, wmax = bank.packed.shape[:3]
    q = bank.packed.to(torch.int32).reshape(t * hmax * wmax, 4, 3)
    atlas = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).reshape(t, hmax, wmax, 4)
    mats = scene.materials
    tid = mats.texture_id.long()
    owner_filt = torch.where(tid >= 0, mats.texture_filter, 0).to(torch.int32)
    filt = torch.zeros(t, dtype=torch.int32, device=atlas.device).scatter_reduce(
        0, tid.clamp(0, t - 1), owner_filt, reduce="amax")
    base = torch.arange(t, dtype=torch.int32, device=atlas.device) * (hmax * wmax)
    meta = torch.stack([bank.widths.to(torch.int32), bank.heights.to(torch.int32), base, filt],
                       dim=1).contiguous()
    return atlas, meta


def texture_args(tex, device) -> list:
    """The launcher's texture arguments (also those of the host builds) for
    :func:`pack_textures`'s pair on ``device``, or for None: the atlas and
    meta pointers, the texture count, the row stride and the atlas length in
    texels. Raises unless the pair is as the kernels take it."""
    if tex is None:
        return [None, None, 0, 0, 0]
    atlas, meta = tex
    t, hmax, wmax = atlas.shape[:3]
    check_tensor(atlas, "texture atlas", torch.int32, (t, hmax, wmax, 4), device)
    check_tensor(meta, "texture meta", torch.int32, (t, TEX_META_COLS), device)
    if atlas.data_ptr() % 16:
        raise ValueError("the texture atlas must be 16-byte aligned")
    return [atlas.data_ptr(), meta.data_ptr(), t, wmax, t * hmax * wmax]


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the kernel cannot render ``scene`` under ``cfg``, or None."""
    if cfg.use_raymarching:
        return "march mode runs in the march kernel (K3, ops/kernel_march.py)"
    if scene.textures is not None:
        t, hmax, wmax = scene.textures.packed.shape[:3]
        if t > TEXTURE_MAX:
            return f"more than {TEXTURE_MAX} textures"
        if t * hmax * wmax >= 2**31:
            return "a texture atlas of 2^31 texels or more"
    if scene.objects.count > KERNEL_OBJECT_MAX:
        return f"more than {KERNEL_OBJECT_MAX} objects"
    if cfg.bg not in BG_IDS:
        return f"unknown background {cfg.bg!r}"
    r = max(cfg.max_reflections, 1)
    if 1 + r * (r - 1) // 2 > STACK_CAP:
        return f"max_reflections={cfg.max_reflections} overflows the kernel's task stack"
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Trace mode, at most 512 objects, textured or not (the JAX kernel's
    ``pallas_supported`` with its in-kernel textures, for atlases within
    its cap)."""
    return unsupported_reason(scene, cfg) is None


def render_color_plain(scene: Scene, cfg: RenderConfig) -> Color:
    """The kernel's function in plain PyTorch: camera rays + ``trace_image``."""
    vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, cfg)
    return trace_image(scene, cfg, vi, eye)


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(lib, fn, tables, cfg: RenderConfig, args: list) -> Color:
    """Call launcher ``fn`` of ``lib`` as ``fn(tables, n, xres, yres, sx, sy,
    *args, out_r, out_g, out_b, device, stream)`` on the current stream
    with the packed scene ``tables`` (:func:`pack_scene`'s four) and return
    the image (``args``: the kernel's ``kernel_args``, and for the trace
    kernel :func:`texture_args`); raises if the tables or the launch are not
    as the kernel takes them."""
    check_tables(tables)
    f32t, i32t, cam, light = tables
    dev = f32t.device
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
    sx, sy = fov_scales(cfg)
    rc = fn(f32t.data_ptr(), i32t.data_ptr(), cam.data_ptr(), light.data_ptr(),
            f32t.shape[0], cfg.xres, cfg.yres, sx, sy, *args,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {lib.rt_error_string(rc).decode()}")
    return Color(out[0], out[1], out[2])


def check_tables(tables):
    """Raise ValueError unless ``tables`` are :func:`pack_scene`'s four
    tensors, contiguous, on one device."""
    f32t, i32t, cam, light = tables
    n, dev = f32t.shape[0], f32t.device
    check_tensor(f32t, "f32 table", torch.float32, (n, F32_COLS), dev)
    check_tensor(i32t, "i32 table", torch.int32, (n, I32_COLS), dev)
    check_tensor(cam, "camera", torch.float32, (1, 8), dev)
    check_tensor(light, "light", torch.float32, (1, 4), dev)


def kernel_args(cfg: RenderConfig) -> list:
    """The launcher's render arguments after the image size and field of
    view (also those of the host build, ``csrc/trace_host.cpp``)."""
    return [cfg.max_reflections, cfg.refraction_cap(), BG_IDS[cfg.bg]]


def check_launchable(scene: Scene, reason: Optional[str], what: str):
    """Raise ValueError unless the ``what`` kernel takes this render: no
    ``reason`` against it, and the scene's tensors on a CUDA device."""
    if reason is not None:
        raise ValueError(f"the {what} kernel does not cover this render: {reason}")
    if scene.device.type != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors, got {scene.device}")


def render_color_kernel(scene: Scene, cfg: RenderConfig) -> Color:
    """Render through the CUDA trace kernel. The scene's tensors must lie on
    a CUDA device; the image is returned there as a Color of ``(H, W)``
    planes. Raises on anything the kernel does not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace")
    return render_tables_kernel(pack_scene(scene), cfg, pack_textures(scene))


def render_tables_kernel(tables, cfg: RenderConfig, tex=None) -> Color:
    """Launch the trace kernel on packed tables (:func:`pack_scene`'s four,
    on a CUDA device) and texture atlas ``tex`` (:func:`pack_textures`'s
    pair, or None) that the caller has checked with
    :func:`unsupported_reason`."""
    global LAUNCHES
    from ._build import load_cuda_library

    lib = load_cuda_library("trace_fwd")
    args = kernel_args(cfg) + texture_args(tex, tables[0].device)
    img = launch(lib, lib.rt_trace_fwd, tables, cfg, args)
    LAUNCHES += 1
    return img

