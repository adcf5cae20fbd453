"""The trace forward as one hand-written CUDA kernel, and its plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py``. The kernel
(``csrc/trace_fwd.cu``, per-pixel body ``csrc/trace_body.cuh``) replaces the
Pallas kernel ``render_color_pallas``: camera rays, the reflection loop,
nearest-hit scans, shading with shadow rays, patterns and image textures
(K1a), the refraction subtree and the sky, one thread per pixel, for
trace-mode scenes of any size the pack's 32-bit words hold. Above
:data:`CULL_MIN_OBJECTS` objects, with ``RenderConfig.pallas_prefilter``,
it takes the JAX kernel's per-tile cull (K1b, ``_build_candidates``): each
16x16 block lists the spheres its camera rays and their shadow rays can
reach, and the root trace's first raycast and shadow ray scan only those;
the cull is exact, so it changes no pixel (:mod:`.cull` is its plain
version, for the tests). Scenes above :data:`SHARED_TABLE_MAX` objects run
the kernel's global-table build (``trace_fwd_global``), which reads the
tables where the pack wrote them; ``max_reflections`` 7 to 11 run its
64-task stack. The texture atlas goes to the kernel as
:func:`pack_textures` lays it out. On the card the scene's tables come from
the pack kernel (``kernel_pack``: one launch from the scene's leaves, the
atlas built once per bank), and the kernel is launched on their addresses;
``kernel_pack.pack_scene`` and ``pack_textures`` (imported here) are the
pack's plain versions.

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
from .kernel_pack import (
    CAM_COLS,
    LIGHT_COLS,
    TEX_META_COLS,
    launch_pack,
    pack_words,
    pack_scene,
    pack_textures,
    texture_pointers,
    word_pointers,
)
from .rays import camera_rays, fov_scales
from .sky import BG_IDS
from .trace import trace_image

__all__ = [
    "pack_scene",
    "pack_textures",
    "texture_args",
    "texture_reason",
    "kernel_supported",
    "unsupported_reason",
    "size_reason",
    "render_color_kernel",
    "render_words_kernel",
    "render_color_plain",
    "kernel_args",
    "launch_args",
    "cull_on",
    "library",
]

# Launches of the trace kernel since import (or since a caller reset it),
# and of them those that took K1b's cull.
LAUNCHES = 0
CULL_LAUNCHES = 0

STACK_CAP = 16  # csrc/trace_body.cuh: rt::STACK_CAP
STACK_CAP_DEEP = 64  # rt::STACK_CAP_DEEP: max_reflections up to 11
TEXTURE_MAX = 1024  # the meta rows share the block's shared memory with the tables
# K1b runs above this many objects (the JAX kernel's _KERNEL_UNROLL_MAX);
# below, the full scan (PERF.md §6 has the times of both at 5 objects).
CULL_MIN_OBJECTS = 64
# The most objects whose tables K1 stages in shared memory: five 16x16
# blocks an SM (its launch shape, csrc/trace_fwd.cu) leave each block
# 233472 / 5 - 1024 = 45670 bytes, which hold 480 objects' 92-byte rows with
# K1b's masks, the camera and light rows and 80 textures' meta rows. Above
# it the global-table build runs (PERF.md §6 has the times of both sides).
SHARED_TABLE_MAX = 480
# K1b's masks stay in a block's shared memory at any n: two words a 32
# objects, beside the camera and light and the meta rows, within the 227 KB
# a block may take.
BLOCK_SMEM_MAX = 232448
# The pack's words (kernel_pack.pack_words) are indexed in int32.
WORDS_MAX = 2**31 - 1


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


def texture_reason(scene: Scene) -> Optional[str]:
    """Why the kernels cannot read the scene's textures, or None: the
    texture meta rows share a block's shared memory with the tables, and the
    atlas is indexed in 32 bits."""
    if scene.textures is not None:
        t, hmax, wmax = scene.textures.packed.shape[:3]
        if t > TEXTURE_MAX:
            return f"more than {TEXTURE_MAX} textures"
        if t * hmax * wmax >= 2**31:
            return "a texture atlas of 2^31 texels or more"
    return None


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the kernel cannot render ``scene`` under ``cfg``, or None."""
    if cfg.use_raymarching:
        return "march mode runs in the march kernel (K3, ops/kernel_march.py)"
    reason = texture_reason(scene)
    if reason is not None:
        return reason
    reason = size_reason(scene)
    if reason is not None:
        return reason
    if cfg.bg not in BG_IDS:
        return f"unknown background {cfg.bg!r}"
    r = max(cfg.max_reflections, 1)
    if 1 + r * (r - 1) // 2 > STACK_CAP_DEEP:
        return (f"max_reflections={cfg.max_reflections} overflows the kernel's task stack "
                f"({STACK_CAP_DEEP} tasks: max_reflections up to 11)")
    return None


def size_reason(scene: Scene) -> Optional[str]:
    """Why the kernels cannot hold the scene's tables, or None: the pack's
    words are indexed in int32, and K1b's masks (8 bytes a 32 objects) stay
    in a block's shared memory."""
    n = scene.objects.count
    n_tex = 0 if scene.textures is None else scene.textures.packed.shape[0]
    words = pack_words(n, n_tex)
    if words > WORDS_MAX:
        return f"{n} objects take {words} pack words; the kernels index at most {WORDS_MAX}"
    smem = 4 * (CAM_COLS + LIGHT_COLS + TEX_META_COLS * n_tex) + 8 * ((n + 31) // 32)
    if smem > BLOCK_SMEM_MAX:
        return (f"{n} objects' cull masks take {smem} bytes of a block's shared memory; "
                f"a block takes at most {BLOCK_SMEM_MAX}")
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Trace mode, textured or not (the JAX kernel's ``pallas_supported``
    with its in-kernel textures, for atlases within its cap, and the scenes
    past 512 objects it renders through jnp), ``max_reflections`` up to
    11."""
    return unsupported_reason(scene, cfg) is None


def cull_on(cfg: RenderConfig, n: int) -> bool:
    """Whether K1 takes K1b's cull for ``n`` objects under ``cfg``."""
    return cfg.pallas_prefilter and n > CULL_MIN_OBJECTS


def library(name: str, n: int, shared_max: int) -> str:
    """CUDA library ``name``, or its global-table build above
    ``shared_max`` objects (``_build.GLOBAL_SUFFIX``)."""
    from ._build import GLOBAL_SUFFIX

    return name + GLOBAL_SUFFIX if n > shared_max else name


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


def launch(lib, fn, ptrs: list, n: int, dev, cfg: RenderConfig, args: list) -> Color:
    """Call launcher ``fn`` of ``lib`` as ``fn(tables, n, xres, yres, sx, sy,
    *args, out_r, out_g, out_b, device, stream)`` on the current stream of
    CUDA device ``dev``, the tables given by their addresses ``ptrs`` (f32
    table, i32 table, camera, light: the pack kernel's words,
    ``kernel_pack.word_pointers``), and return the image (``args``: the
    kernel's ``kernel_args``, then its texture arguments); raises if the
    launch fails."""
    out = torch.empty((3, cfg.yres, cfg.xres), dtype=torch.float32, device=dev)
    sx, sy = fov_scales(cfg)
    plane = 4 * cfg.yres * cfg.xres
    base = out.data_ptr()
    rc = fn(*ptrs, n, cfg.xres, cfg.yres, sx, sy, *args, base, base + plane, base + 2 * plane,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {lib.rt_error_string(rc).decode()}")
    return Color(*out.unbind(0))


def kernel_args(cfg: RenderConfig) -> list:
    """The render arguments after the image size and field of view that
    the trace kernels share (K1, K2 and K5, and their host builds)."""
    return [cfg.max_reflections, cfg.refraction_cap(), BG_IDS[cfg.bg]]


def launch_args(cfg: RenderConfig, tex, device, n: int) -> list:
    """K1's arguments after the image size and field of view (also its
    host build's, ``csrc/trace_host.cpp``) for ``n`` objects:
    :func:`kernel_args`, :func:`texture_args` of atlas ``tex`` on
    ``device``, and K1b's switch (:func:`cull_on`)."""
    return kernel_args(cfg) + texture_args(tex, device) + [int(cull_on(cfg, n))]


def check_launchable(scene: Scene, reason: Optional[str], what: str):
    """Raise ValueError unless the ``what`` kernel takes this render: no
    ``reason`` against it, and the scene's tensors on a CUDA device."""
    if reason is not None:
        raise ValueError(f"the {what} kernel does not cover this render: {reason}")
    if scene.device.type != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors, got {scene.device}")


def render_color_kernel(scene: Scene, cfg: RenderConfig) -> Color:
    """Render through the CUDA trace kernel, the scene packed by the pack
    kernel (``kernel_pack.launch_pack``). The scene's tensors must lie on a CUDA
    device; the image is returned there as a Color of ``(H, W)`` planes.
    Raises on anything the kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "trace")
    return render_words_kernel(scene, launch_pack(scene), cfg)


def render_words_kernel(scene: Scene, words: torch.Tensor, cfg: RenderConfig) -> Color:
    """Launch the trace kernel on the pack kernel's ``words`` of ``scene``
    (``kernel_pack.launch_pack``) and the scene's cached texture atlas,
    straight from their addresses: the kernel after the pack, which the
    caller has checked with :func:`unsupported_reason`."""
    global LAUNCHES, CULL_LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = word_pointers(words, n)
    lib = load_cuda_library(library("trace_fwd", n, SHARED_TABLE_MAX))
    cull = cull_on(cfg, n)
    img = launch(lib, lib.rt_trace_fwd, ptrs, n, words.device, cfg,
                 kernel_args(cfg) + texture_pointers(scene, meta) + [int(cull)])
    LAUNCHES += 1
    CULL_LAUNCHES += cull
    return img
