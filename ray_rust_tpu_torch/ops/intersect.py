"""Ray-object intersection and nearest-hit reduction.

PyTorch counterpart of ``ray_rust_tpu/ops/intersect.py`` (reference
render.rs:993-1018, sphere render.rs:447-471, floor render.rs:557-569). Both
primitive equations are evaluated for the whole ray grid and the object axis
is reduced in order: strictly closer wins, the first index wins ties, and the
ignored object is masked by index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import KIND_SPHERE, Scene
from ..models.vec import Vec3

__all__ = [
    "OUTONLY",
    "INONLY",
    "RIGNORE",
    "GIGNORE",
    "BIGNORE",
    "F32_EPSILON",
    "object_candidate_t",
    "raycast",
]

# Ray flags (render.rs:14-18). OUTONLY skips the sphere entry root, INONLY the
# exit root; the channel IGNORE bits guard color accumulation (never set by
# any reference caller, kept for parity).
OUTONLY = 1
INONLY = 1 << 1
RIGNORE = 1 << 2
GIGNORE = 1 << 3
BIGNORE = 1 << 4

F32_EPSILON = float(np.finfo(np.float32).eps)  # f32::EPSILON (render.rs:460)

_INF = float("inf")


def object_candidate_t(kind, org: Vec3, radius, normal: Vec3, vi: Vec3, eye: Vec3,
                       t_running, flags):
    """Intersection parameter of one object against the ray batch, or +inf.
    The object's fields are 0-d tensors; ``t_running`` is the current nearest
    t and ``flags`` the per-ray flag word."""
    wpt = vi - org

    # sphere: quadratic with entry/exit selection
    b = 2.0 * eye.dot(wpt)
    c = wpt.dot(wpt) - radius * radius
    d2 = b * b - 4.0 * c
    has_roots = d2 >= F32_EPSILON
    d = torch.sqrt(torch.where(has_roots, d2, 1.0))
    t0 = (-b - d) / 2.0
    far = t0 + d
    outonly = (flags & OUTONLY) != 0
    inonly = (flags & INONLY) != 0
    take_near = has_roots & ~outonly & (t0 >= 0.0) & (t0 < t_running)
    take_far = has_roots & ~inonly & (far > 0.0) & (far < t_running)
    cand_sphere = torch.where(take_near, t0, torch.where(take_far, far, _INF))

    # floor: front-facing rays only (w < 0; w == 0 never hits)
    w = normal.dot(eye)
    denom = torch.where(w < 0.0, w, -1.0)
    t0f = -normal.dot(wpt) / denom
    take_floor = (w < 0.0) & (t0f >= 0.0) & (t0f < t_running)
    cand_floor = torch.where(take_floor, t0f, _INF)

    return torch.where(kind == KIND_SPHERE, cand_sphere, cand_floor)


def raycast(scene: Scene, vi: Vec3, eye: Vec3, ig, flags):
    """Nearest hit over all objects (render.rs:993-1018). ``ig`` is the
    per-ray ignored object index (-1 = none). Returns ``(t, idx)`` with
    ``t = +inf`` on a miss and ``idx = 0`` there."""
    objs = scene.objects
    t = torch.full(eye.shape, _INF, dtype=torch.float32, device=eye.x.device)
    idx = torch.zeros(eye.shape, dtype=torch.int32, device=eye.x.device)
    for i in range(objs.count):
        cand = object_candidate_t(objs.kind[i], objs.org.take(i), objs.radius[i],
                                  objs.normal.take(i), vi, eye, t, flags)
        cand = torch.where(ig == i, _INF, cand)
        closer = cand < t
        t = torch.where(closer, cand, t)
        idx = torch.where(closer, i, idx)
    return t, idx
