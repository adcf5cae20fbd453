"""The march-mode forward with glow as one hand-written CUDA kernel, and its
plain version.

Counterpart of ``ray_rust_tpu/ops/pallas_march.py``. The kernel
(``csrc/march_fwd.cu``, per-pixel body ``csrc/march_body.cuh``) replaces the
Pallas kernel ``render_color_pallas_march``: camera rays, sphere tracing over
the scene SDF, the lap loop, march shading with shadow marches, patterns,
the refraction sub-marches, the sky and the glow factor, one thread per
pixel, for untextured march-mode scenes of up to 512 objects.

:func:`render_color_kernel` launches the kernel or raises; it never falls
back. :func:`render_color_plain` (the trace kernel's: camera rays and
``trace_image``, which takes ``ops/trace.py:raymarch`` in march mode)
computes the same function with PyTorch operations; the renderer takes it
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
against it. The scene tables are the trace kernel's
(``kernel_trace.pack_scene``; column 18 holds ``glow_dist``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from .kernel_trace import check_launchable, launch, pack_scene, render_color_plain
from .sky import BG_IDS

__all__ = [
    "kernel_supported",
    "unsupported_reason",
    "render_color_kernel",
    "render_tables_kernel",
    "render_color_plain",
    "kernel_args",
]

# Launches of the march kernel since import (or since a caller reset it).
LAUNCHES = 0

KERNEL_OBJECT_MAX = 512  # the tables must fit one block's shared memory
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
    if scene.textures is not None:
        return "image textures are not ported yet (ROADMAP queue 2, K1a)"
    if scene.objects.count > KERNEL_OBJECT_MAX:
        return f"more than {KERNEL_OBJECT_MAX} objects"
    if cfg.bg not in BG_IDS:
        return f"unknown background {cfg.bg!r}"
    cap = cfg.refraction_cap()
    if cap > FRAME_CAP:
        return (f"refraction depth {cap} nests {cap} raymarch calls; "
                f"the kernel's task stack holds {FRAME_CAP}")
    return None


def kernel_supported(scene: Scene, cfg: RenderConfig) -> bool:
    """March mode, untextured, at most 512 objects (the JAX kernel's
    ``pallas_march_supported``), refraction depth at most ``FRAME_CAP``."""
    return unsupported_reason(scene, cfg) is None


def kernel_args(cfg: RenderConfig) -> list:
    """The launcher's render arguments after the image size and field of
    view (also those of the host build, ``csrc/march_host.cpp``)."""
    glow_on = cfg.glow_effect is not None
    return [cfg.refraction_cap(), BG_IDS[cfg.bg], cfg.raymarch_max_reflections,
            cfg.march_max_iter, cfg.march_eps, cfg.far_away, int(glow_on),
            float(np.float32(cfg.glow_effect)) if glow_on else 0.0]


def render_color_kernel(scene: Scene, cfg: RenderConfig) -> Color:
    """Render through the CUDA march kernel. The scene's tensors must lie on
    a CUDA device; the image is returned there as a Color of ``(H, W)``
    planes. Raises on anything the kernel does not take."""
    check_launchable(scene, unsupported_reason(scene, cfg), "march")
    return render_tables_kernel(pack_scene(scene), cfg)


def render_tables_kernel(tables, cfg: RenderConfig) -> Color:
    """Launch the march kernel on packed tables (``pack_scene``'s four, on a
    CUDA device) that the caller has checked with :func:`unsupported_reason`."""
    global LAUNCHES
    from ._build import load_cuda_library

    lib = load_cuda_library("march_fwd")
    img = launch(lib, lib.rt_march_fwd, tables, cfg, kernel_args(cfg))
    LAUNCHES += 1
    return img

