"""Traced-ray accounting for throughput reporting.

PyTorch counterpart of ``ray_rust_tpu/ops/accounting.py``. BASELINE.md:34-37
asks for total traced rays per second beside primary rays per second: the
reference traces one camera ray a pixel, one shadow ray a shading call
(src/render.rs:1048-1082), one reflection ray a surviving bounce
(render.rs:1156-1221) and a refraction sub-tree a transparent hit
(render.rs:1093-1115). :func:`count_traced_rays` replays the Whitted loop's
control flow only (raycasts, masks and terminations, no shading) and counts
each lane's raycast calls, in plain PyTorch on the scene's device; it
launches no kernel (the JAX function reaches no ``pallas_call``).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color, Vec3
from .gather import gather_hit_fields, surface_normal_from
from .intersect import F32_EPSILON, INONLY, OUTONLY, raycast
from .rays import camera_rays
from .trace import _reflect_update, refraction_ray

__all__ = ["count_traced_rays"]


def _count_raytrace(scene: Scene, cfg: RenderConfig, vi: Vec3, eye: Vec3, lev: int, ig,
                    flags, active) -> torch.Tensor:
    """Each lane's raycast calls of ``raytrace`` (render.rs:1142-1224) and its
    shading's shadow and refraction rays (render.rs:1048-1115), with the
    reference's terminations (the masks of ``ops/trace.py``)."""
    count = torch.zeros(eye.shape, dtype=torch.float32, device=eye.x.device)
    fcs = Color.full(1.0, 1.0, 1.0, eye.shape, device=eye.x.device)
    for step in range(max(1, cfg.max_reflections - lev)):
        lev_i = lev + 1 + step
        t, idx = raycast(scene, vi, eye, ig, flags)
        count = count + active.float()  # the trace ray itself
        shaded = active & torch.isfinite(t)
        count = count + shaded.float()  # one shadow raycast a shaded lane
        pt = vi + eye * torch.where(torch.isfinite(t), t, 0.0)
        fields = gather_hit_fields(scene, idx)
        n = surface_normal_from(fields, pt)
        # The reference's ray tree spawns refraction sub-traces down to the
        # full max_refractions (render.rs:1093), not the image's depth cap
        # (cfg.refraction_unroll): rays past the cap add ~nothing to the
        # image but are traced all the same.
        if lev_i < cfg.max_refractions:
            f = fields.transparency
            ray, sp = refraction_ray(eye, n, f, fields.refraction)
            sub_flags = torch.where(sp < 0.0, OUTONLY, INONLY).to(torch.int32)
            count = count + _count_raytrace(scene, cfg, pt + ray * F32_EPSILON, ray, lev_i, idx,
                                            sub_flags, shaded & (f > 0.0))
        spec = fields.specular
        fcs = Color(*(torch.where(shaded, a * s, a) for a, s in zip(fcs, spec)))
        cont = shaded & (idx != 0) & (fcs.sum() > 0.1) & (lev_i < cfg.max_reflections)
        vi, eye, flags, ig = _reflect_update(vi, eye, flags, ig, pt, n, idx, cont)
        active = cont
    return count


def count_traced_rays(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Total rays the reference traces for this frame: a scalar int64
    tensor on the scene's device (the JAX function sums in f32, exact
    below 2^24 rays). Trace mode only (a march's cost is counted in steps,
    not rays; BASELINE.md's accounting is the Whitted path's)."""
    if cfg.use_raymarching:
        raise ValueError("ray accounting is defined for trace mode")
    with torch.no_grad():
        vi, eye = camera_rays(scene.camera.position, scene.camera.rotation, cfg)
        dev = eye.x.device
        ig = torch.full(eye.shape, -1, dtype=torch.int32, device=dev)
        flags = torch.zeros(eye.shape, dtype=torch.int32, device=dev)
        active = torch.ones(eye.shape, dtype=torch.bool, device=dev)
        return torch.sum(_count_raytrace(scene, cfg, vi, eye, 0, ig, flags, active).long())
