"""The plain PyTorch trace: shading, the Whitted reflection loop (trace
mode) and the march loop with glow (march mode).

PyTorch counterpart of ``ray_rust_tpu/ops/trace.py`` — ``shading``
(render.rs:1020-1140), ``raytrace`` (render.rs:1142-1224) and ``raymarch``
(render.rs:1299-1411). Every level is a Python int, so the ray tree
(reflection chain × refraction recursion) runs as a fixed sequence of tensor
operations over the whole ``(H, W)`` ray batch, with per-ray masks standing
in for early exits. Trace mode is differentiable by autograd; march mode is
forward only. They are the plain versions the CUDA kernels
(``ops/kernel_trace.py``, ``ops/kernel_march.py``) are held against.

Reference quirks kept as in the JAX package: hitting object 0 ends the
bounce loop; throughput cutoff ``r+g+b <= 0.1``; per-channel IGNORE guards;
pseudo-refraction bends the ray and ignores the source object; the
trace-mode shadow ray passes transparent blockers, while the march-mode
shadow checks the transparency of the *shaded* object; the march loop's
reflection cap is the reference's compile-time constant
(``raymarch_max_reflections``); a march-mode miss does not end the lane and
re-adds the background every remaining lap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color, Vec3
from .gather import HitFields, gather_hit_fields, surface_normal_from
from .intersect import (
    BIGNORE,
    F32_EPSILON,
    GIGNORE,
    INONLY,
    OUTONLY,
    RIGNORE,
    raycast,
)
from .march import march_single
from .sky import get_bg
from .texture import get_uv, lookup_diffuse

__all__ = ["shading", "raytrace", "raymarch", "trace_image"]


def shading(scene: Scene, cfg: RenderConfig, idx, fields: HitFields, n: Vec3,
            pt: Vec3, eye: Vec3, nest: int, active=None) -> Color:
    """Lambert + Phong + shadow + pattern + pseudo-refraction
    (render.rs:1020-1140). The refraction recursion runs while
    ``nest < cfg.refraction_cap()``. In march mode ``active`` masks the
    lanes whose shadow march and refraction sub-march matter."""
    light = scene.light

    light_incidence = light.dot(n)
    ln2 = 2.0 * light_incidence
    reflected_to_light = Vec3(n.x * ln2, n.y * ln2, n.z * ln2) - light
    diffuse_intensity = torch.clamp(light_incidence, min=0.0)
    shadow_org = pt + light * F32_EPSILON
    pn = fields.pn
    refl_incidence = -reflected_to_light.dot(eye)
    ri_safe = torch.where(refl_incidence > 0.0, refl_incidence, 1.0)
    reflection_intensity = torch.where(
        (pn != 0.0) & (refl_incidence > 0.0), torch.pow(ri_safe, pn), 0.0)

    if cfg.use_raymarching:
        # Shadow march (render.rs:1048-1067): lit when it escapes or runs out
        # of steps, or when the shaded object itself is transparent.
        res = march_single(scene, cfg, shadow_org, light.broadcast_to(pt.shape), idx,
                           active=active, need_glow=False)
        lit = ((res.travel_dist >= cfg.far_away) | (res.iter >= cfg.march_max_iter)
               | (fields.transparency > 0.0))
    else:
        # Shadow ray (render.rs:1068-1082): lit when it escapes or its
        # blocker is transparent.
        zero_flags = torch.zeros_like(idx)
        t_s, i_s = raycast(scene, shadow_org, light.broadcast_to(pt.shape), idx,
                           zero_flags)
        blocker = scene.objects.mat.long()[i_s.long()]
        lit = torch.isinf(t_s) | (scene.materials.transparency[blocker] > 0.0)

    k1 = torch.where(lit, torch.clamp(0.2 + diffuse_intensity, max=1.0), 0.2)
    k2 = torch.where(lit, reflection_intensity, 0.0)

    uv = get_uv(pt - fields.org, fields.uvmap, fields.pattern_scale,
                fields.pattern_angle_scale)
    kd = lookup_diffuse(scene, fields, uv)
    base = Color(kd.r * k1 + k2, kd.g * k1 + k2, kd.b * k1 + k2)

    if nest >= cfg.refraction_cap():
        return base
    # Pseudo-refraction (render.rs:1093-1132): the sub-trace starts at level
    # ``nest`` with the source object ignored.
    sp = eye.dot(n)
    f = fields.transparency
    fracn = fields.refraction
    # |n| ~ 0 with t > 0 is degenerate (1/0 in the reference): use index 1
    fracn_safe = torch.where((f > 0.0) & (torch.abs(fracn) > 1e-6), fracn, 1.0)
    bend = sp * (torch.where(sp > 0.0, fracn_safe, 1.0 / fracn_safe) - 1.0)
    ray = (eye + Vec3(n.x * bend, n.y * bend, n.z * bend)).normalized()
    pt3 = pt + ray * F32_EPSILON
    sub_flags = torch.where(sp < 0.0, OUTONLY, INONLY).to(torch.int32)
    if cfg.use_raymarching:
        sub_active = f > 0.0 if active is None else (f > 0.0) & active
        fc2 = raymarch(scene, cfg, pt3, ray, nest, idx, sub_flags, active0=sub_active)
    else:
        fc2 = raytrace(scene, cfg, pt3, ray, nest, idx, sub_flags)
    blended = Color(
        (kd.r * k1 + k2) * (1.0 - f) + fc2.r * f,
        (kd.g * k1 + k2) * (1.0 - f) + fc2.g * f,
        (kd.b * k1 + k2) * (1.0 - f) + fc2.b * f,
    )
    return blended.where(f > 0.0, base)


def _accumulate(ret: Color, fcs: Color, face: Color, ks: Color, mask, flags):
    """Masked color accumulation + throughput attenuation with the
    per-channel IGNORE guards (render.rs:1175-1186)."""
    ms = [mask & ((flags & bit) == 0) for bit in (RIGNORE, GIGNORE, BIGNORE)]
    ret = Color(*(torch.where(m, r + fa * fc, r)
                  for m, r, fa, fc in zip(ms, ret, face, fcs)))
    fcs = Color(*(torch.where(m, fc * k, fc) for m, fc, k in zip(ms, fcs, ks)))
    return ret, fcs


def _reflect_update(vi, eye, flags, ig, pt, n, idx, upd):
    """Mirror bounce + entry/exit flag flip (render.rs:1199-1211)."""
    en2 = -2.0 * eye.dot(n)
    new_eye = eye + Vec3(n.x * en2, n.y * en2, n.z * en2)
    inside = n.dot(new_eye) < 0.0
    new_flags = torch.where(inside, (flags & ~INONLY) | OUTONLY,
                            (flags & ~OUTONLY) | INONLY)
    return (
        pt.where(upd, vi),
        new_eye.where(upd, eye),
        torch.where(upd, new_flags, flags),
        torch.where(upd, idx, ig),
    )


def _raytrace_step(scene: Scene, cfg: RenderConfig, lev_i: int, vi, eye, flags,
                   ig, fcs, ret, active):
    """One bounce of the Whitted loop at level ``lev_i``."""
    t, idx = raycast(scene, vi, eye, ig, flags)
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    pt = vi + eye * t_safe
    if cfg.grad_distance_cutoff is not None:
        # knife-edge horizon hits are constants for autograd (forward no-op)
        near = t_safe < cfg.grad_distance_cutoff
        pt = pt.where(near, Vec3(*(c.detach() for c in pt)))
    fields = gather_hit_fields(scene, idx)
    n = surface_normal_from(fields, pt)
    face = shading(scene, cfg, idx, fields, n, pt, eye, lev_i)
    ret, fcs = _accumulate(ret, fcs, face, fields.specular, active & hit, flags)

    # a miss picks up the background once, unguarded (render.rs:1212-1217)
    miss = active & ~hit
    bg = get_bg(cfg.bg)(scene.light, eye)
    ret = Color(*(torch.where(miss, r + b * fc, r) for r, b, fc in zip(ret, bg, fcs)))

    cont = (active & hit & (idx != 0) & (fcs.sum() > 0.1)
            & (lev_i < cfg.max_reflections))
    vi, eye, flags, ig = _reflect_update(vi, eye, flags, ig, pt, n, idx, cont)
    return vi, eye, flags, ig, fcs, ret, cont


def raytrace(scene: Scene, cfg: RenderConfig, vi: Vec3, eye: Vec3, lev: int,
             ig, flags) -> Color:
    """Whitted reflection loop (render.rs:1142-1224): bounces at levels
    ``lev+1 .. max(lev+1, max_reflections)``."""
    shape, dev = eye.shape, eye.x.device
    fcs = Color.full(1.0, 1.0, 1.0, shape, device=dev)
    ret = Color.zero(shape, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    for step in range(max(1, cfg.max_reflections - lev)):
        vi, eye, flags, ig, fcs, ret, active = _raytrace_step(
            scene, cfg, lev + 1 + step, vi, eye, flags, ig, fcs, ret, active)
    return ret


def raymarch(scene: Scene, cfg: RenderConfig, vi: Vec3, eye: Vec3, lev: int,
             ig, flags, active0=None) -> Color:
    """March + reflect loop with the glow post-multiply (render.rs:1299-1411):
    laps at levels ``lev+1 .. max(lev+1, raymarch_max_reflections)``.

    ``active0`` masks the lanes that need tracing at all (a refraction
    sub-march passes its transparent lanes). A lane marches again only after
    it reflected; a lane that missed keeps its march result and re-adds the
    background every remaining lap (render.rs:1385-1391). Every call ends
    with the factor ``1 + g·0.99^min_min_dist`` (1 where no glow was seen)."""
    shape, dev = eye.shape, eye.x.device
    active = (torch.ones(shape, dtype=torch.bool, device=dev) if active0 is None
              else active0.expand(shape))
    if not bool(active.any()):  # no lane to trace: every term below is masked
        return Color.zero(shape, device=dev)
    fcs = Color.full(1.0, 1.0, 1.0, shape, device=dev)
    ret = Color.zero(shape, device=dev)
    min_min_dist = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
    pos = vi
    bg_fn = get_bg(cfg.bg)

    need_march = active
    res = None
    for step in range(max(1, cfg.raymarch_max_reflections - lev)):
        lev_i = lev + 1 + step
        new_res = march_single(scene, cfg, pos, eye, ig, active=need_march,
                               need_glow=cfg.glow_effect is not None)
        res = new_res if res is None else new_res.where(need_march, res)
        min_min_dist = torch.where(active & (res.min_dist < min_min_dist), res.min_dist,
                                   min_min_dist)
        hit = res.final_dist < cfg.march_eps
        pt = res.pos
        fields = gather_hit_fields(scene, res.idx)
        n = surface_normal_from(fields, pt)
        face = shading(scene, cfg, res.idx, fields, n, pt, eye, lev_i, active=active & hit)
        ret, fcs = _accumulate(ret, fcs, face, fields.specular, active & hit, flags)

        miss = active & ~hit
        bg = bg_fn(scene.light, eye)
        ret = Color(*(torch.where(miss, r + b * fc, r) for r, b, fc in zip(ret, bg, fcs)))

        cont_hit = (hit & (res.idx != 0) & (fcs.sum() > 0.1)
                    & (lev_i < cfg.raymarch_max_reflections))
        upd = active & cont_hit
        pos, eye, flags, ig = _reflect_update(pos, eye, flags, ig, pt, n, res.idx, upd)
        active = active & (cont_hit | ~hit)
        need_march = upd

    if cfg.glow_effect is not None:
        g = float(np.float32(cfg.glow_effect))
        base = torch.tensor(0.99, dtype=torch.float32, device=dev)
        factor = torch.where(torch.isinf(min_min_dist), 1.0,
                             1.0 + g * torch.pow(base, min_min_dist))
        ret = Color(ret.r * factor, ret.g * factor, ret.b * factor)
    return ret


def trace_image(scene: Scene, cfg: RenderConfig, vi: Vec3, eye: Vec3) -> Color:
    """Trace a full ray grid from scratch: level 0, no ignored object, no
    flags (render.rs:820-824)."""
    ig = torch.full(eye.shape, -1, dtype=torch.int32, device=eye.x.device)
    flags = torch.zeros(eye.shape, dtype=torch.int32, device=eye.x.device)
    if cfg.use_raymarching:
        return raymarch(scene, cfg, vi, eye, 0, ig, flags)
    return raytrace(scene, cfg, vi, eye, 0, ig, flags)
