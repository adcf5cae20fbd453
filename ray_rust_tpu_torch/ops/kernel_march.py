"""The march-mode forward with glow as one hand-written CUDA kernel, and its
plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_march.py``. The kernel
(``csrc/march_fwd.cu``, per-pixel body ``csrc/march_body.cuh``) replaces the
Pallas kernel ``render_color_pallas_march``: camera rays, sphere tracing over
the scene SDF, the lap loop, march shading with shadow marches, patterns,
the refraction sub-marches, the sky and the glow factor, one thread per
pixel, for march-mode scenes of any size the pack's 32-bit words hold;
above :data:`SHARED_TABLE_MAX` objects its global-table build
(``march_fwd_global``) reads the tables where the pack wrote them instead of
staging them in shared memory. A textured hit reads the
scene's texture atlas as the trace kernel does (K1a); the JAX package's
march kernel declines textures and renders them through its jnp march
(``pallas_trace.py:render_color_fast``), whose function the plain version
here computes.

:func:`render_color_kernel` launches the kernel or raises; it never falls
back. :func:`render_color_plain` (the trace kernel's: camera rays and
``trace_image``, which takes ``ops/trace.py:raymarch`` in march mode)
computes the same function with PyTorch operations; the renderer takes it
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
against it. The scene tables are the trace kernel's, packed by the pack
kernel (``kernel_pack.launch_pack``; column 18 holds ``glow_dist``).

``RenderConfig.march_floor_skip`` (on by default, as in the JAX package)
lets the kernel resolve a march's floor tail in closed form; the plain
version ignores it and stays the exact step-by-step march. With it off the
kernel steps as the plain version does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from .kernel_pack import launch_pack, texture_pointers, word_pointers
from .kernel_trace import (
    check_launchable,
    launch,
    library,
    render_color_plain,
    size_reason,
    texture_args,
    texture_reason,
)
from .sky import BG_IDS

__all__ = [
    "kernel_supported",
    "unsupported_reason",
    "render_color_kernel",
    "render_words_kernel",
    "render_color_plain",
    "kernel_args",
    "launch_args",
]

# Launches of the march kernel since import (or since a caller reset it).
LAUNCHES = 0

# The most objects whose tables K3 stages in shared memory: its 32x8
# blocks at 128 registers run two an SM, which leaves each block 233472 / 2
# - 1024 = 115712 bytes, and 1 024 objects' 92-byte rows take 94 KB. Above
# it the global-table build runs (PERF.md §6 has the times of both sides).
SHARED_TABLE_MAX = 1200
# The counters a -DRT_COUNT_OPS host build of a march body fills
# (csrc/march_body.cuh): f32 operations, texel bytes, the most
# operations of one pixel, object passes (SDF sweeps and the shortcuts'
# passes), the most passes of one pixel, the marches the never-converges
# test ended.
OPS_SLOTS = 6
# The kernel's raymarch frames (csrc/march_body.cuh: rt::MARCH_FRAMES). A
# raymarch at level L runs laps at levels L+1 .. L+max(1, R-L) for
# R = raymarch_max_reflections, and a lap at level l < cap starts a
# refraction sub-march at level l. Every chain of nested calls climbs through
# distinct levels below the cap, so a pixel nests at most max(1, cap)
# raymarch calls; at R = 3 its tree holds 8 calls at cap 4 and 32 at cap 10.
FRAME_CAP = 10


def unsupported_reason(scene: Scene, cfg: RenderConfig) -> Optional[str]:
    """Why the march kernel cannot render ``scene`` under ``cfg``, or None."""
    if not cfg.use_raymarching:
        return "trace mode runs in the trace kernel (K1, ops/kernel_trace.py)"
    reason = texture_reason(scene)
    if reason is not None:
        return reason
    reason = size_reason(scene)
    if reason is not None:
        return reason
    if cfg.bg not in BG_IDS:
        return f"unknown background {cfg.bg!r}"
    cap = cfg.refraction_cap()
    if cap > FRAME_CAP:
        return (f"refraction depth {cap} nests {cap} raymarch calls; "
                f"the kernel's task stack holds {FRAME_CAP}")
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """March mode (the JAX kernel's ``pallas_march_supported``, the
    scenes past 512 objects it renders through jnp, and textured scenes
    within the trace kernel's atlas limits), refraction depth at most
    ``FRAME_CAP``."""
    return unsupported_reason(scene, cfg) is None


def kernel_args(cfg: RenderConfig) -> list:
    """The launcher's render arguments after the image size and field of
    view (also those of the host build, ``csrc/march_host.cpp``)."""
    glow_on = cfg.glow_effect is not None
    return [cfg.refraction_cap(), BG_IDS[cfg.bg], cfg.raymarch_max_reflections,
            cfg.march_max_iter, cfg.march_eps, cfg.far_away, int(glow_on),
            float(np.float32(cfg.glow_effect)) if glow_on else 0.0, int(cfg.march_floor_skip)]


def launch_args(cfg: RenderConfig, tex, device) -> list:
    """This kernel's arguments after the image size and field of view (also
    its host build's): :func:`kernel_args`, then
    ``kernel_trace.texture_args`` of atlas ``tex`` on ``device``."""
    return kernel_args(cfg) + texture_args(tex, device)


def render_color_kernel(scene: Scene, cfg: RenderConfig) -> Color:
    """Render through the CUDA march kernel, the scene packed by the pack
    kernel. The scene's tensors must lie on a CUDA device; the image is
    returned there as a Color of ``(H, W)`` planes. Raises on anything the
    kernels do not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march")
    return render_words_kernel(scene, launch_pack(scene), cfg)


def render_words_kernel(scene: Scene, words, cfg: RenderConfig) -> Color:
    """Launch the march kernel on the pack kernel's ``words`` of ``scene``
    (``kernel_pack.launch_pack``) and the scene's cached texture atlas,
    straight from their addresses, for a render the caller has checked with
    :func:`unsupported_reason`."""
    global LAUNCHES
    from ._build import load_cuda_library

    n = scene.objects.count
    ptrs, meta = word_pointers(words, n)
    lib = load_cuda_library(library("march_fwd", n, SHARED_TABLE_MAX))
    img = launch(lib, lib.rt_march_fwd, ptrs, n, words.device, cfg,
                 kernel_args(cfg) + texture_pointers(scene, meta))
    LAUNCHES += 1
    return img
