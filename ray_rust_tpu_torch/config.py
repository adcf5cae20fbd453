"""Static render configuration.

PyTorch counterpart of ``ray_rust_tpu/config.py``. It keeps the semantic
fields, and of the JAX package's kernel switches only ``march_floor_skip``,
which the march kernels take, and ``pallas_prefilter``, which the trace
kernel takes; the TPU tiling knobs have no meaning here. A
render runs on the device of the scene's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RenderConfig"]

# Reference compile-time constants (src/render.rs:11-12, 1253-1255)
REF_MAX_REFLECTIONS = 3
REF_MAX_REFRACTIONS = 10
RAYMARCH_EPS = 1e-3
FAR_AWAY = 1e4
MARCH_MAX_ITER = 10000


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    xres: int = 320
    yres: int = 240
    xfov: float = 1.0
    yfov: Optional[float] = None  # defaults to yres/xres (src/main.rs:135-136)

    max_reflections: int = REF_MAX_REFLECTIONS
    max_refractions: int = REF_MAX_REFRACTIONS
    # Depth cap of the refraction recursion: it runs to
    # min(max_refractions, refraction_unroll) levels. On the reference
    # default scene depth 3 already equals depth 10. None = the exact
    # reference depth.
    refraction_unroll: Optional[int] = 4

    use_raymarching: bool = False
    glow_effect: Optional[float] = None  # render.rs:663

    # Ray-march constants (render.rs:1253-1255); the march loop's reflection
    # cap is the reference's compile-time constant (render.rs:1368,1391).
    march_eps: float = RAYMARCH_EPS
    far_away: float = FAR_AWAY
    march_max_iter: int = MARCH_MAX_ITER
    raymarch_max_reflections: int = REF_MAX_REFLECTIONS

    bg: str = "default_sky"  # background shader registry key

    # The march kernels' closed-form floor tail (csrc/march_body.cuh:
    # floor_tail, the JAX package's field of the same name): while a floor
    # wins the SDF the remaining distances form h*rho^k (rho = 1 + e.n), so
    # the stop step, travel, end state and sampled glow minimum have closed
    # forms, resolved up to the first travel where another object would tie
    # the floor. Equal to the step-by-step march up to f32 rounding, which
    # flips only knife-edge pixels. Kernels only: the plain march ignores it
    # and stays the exact step-by-step oracle.
    march_floor_skip: bool = True

    # The trace kernel's per-tile object cull (K1b, csrc/trace_body.cuh:
    # cull_tile, the JAX package's field of the same name): above 64 objects
    # each 16x16 block lists the spheres its camera rays' pyramid can reach,
    # and those its primary shadow rays can, and the root trace's first
    # raycast and its shadow scan those lists alone. Conservative, so the
    # image is the full scan's bit for bit. Kernels only: the plain trace
    # ignores it.
    pallas_prefilter: bool = True

    # Backward hygiene: hits farther than this are constants for autograd
    # (knife-edge horizon rays). The forward is unchanged. None disables.
    grad_distance_cutoff: Optional[float] = 1e6

    def resolved_yfov(self) -> float:
        return self.yfov if self.yfov is not None else self.yres / self.xres

    def refraction_cap(self) -> int:
        """Levels the refraction recursion runs to."""
        if self.refraction_unroll is None:
            return self.max_refractions
        return min(self.max_refractions, self.refraction_unroll)

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
