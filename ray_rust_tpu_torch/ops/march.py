"""SDF evaluation and the sphere-tracing march (forward).

PyTorch counterpart of ``ray_rust_tpu/ops/march.py`` in its while mode:
``distance_estimate`` (render.rs:1226-1251) and ``march_single``
(render.rs:1266-1297). The scene SDF is evaluated for every object at once
along a leading object axis and reduced in order (strictly closer wins, the
first index wins ties, the ignored object is masked by index), which gives
the same values as the JAX package's object-by-object loop.

``march_single`` is a batched masked loop over the whole ray batch. The host
reads ``any(~done)`` only every ``CHECK_EVERY`` steps, so it does not
synchronise with the device each step; the extra steps are masked no-ops on
settled lanes, as the JAX package's chunked ``while_loop`` runs them. There
is no gradient through the march here (the JAX package's implicit VJP
``_march_while_vjp`` is the march-gradient slice).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..models.scene import KIND_SPHERE, Scene
from ..models.vec import Vec3

__all__ = ["MarchResult", "distance_estimate", "march_single"]

# Masked march steps between two host reads of "is any lane still live".
CHECK_EVERY = 16

_INF = float("inf")


class MarchResult(NamedTuple):
    """Per-ray march outcome (reference RaymarchSingleResult,
    render.rs:1257-1264)."""

    final_dist: torch.Tensor
    idx: torch.Tensor  # int32
    pos: Vec3
    iter: torch.Tensor  # int32
    travel_dist: torch.Tensor
    min_dist: torch.Tensor  # running min of the glow metric

    def where(self, mask, other: "MarchResult") -> "MarchResult":
        """Lane select: ``mask ? self : other``."""
        return MarchResult(*(a.where(mask, b) if isinstance(a, Vec3) else torch.where(mask, a, b)
                             for a, b in zip(self, other)))


class _SceneSDF:
    """The scene SDF for points of ``ndim`` dimensions: the object leaves laid
    along a leading object axis, with object ``ig`` (a scalar or a tensor of
    the points' shape) masked. Built once per march, since nothing in it
    changes from step to step."""

    def __init__(self, scene: Scene, ig, ndim: int):
        objs = scene.objects
        n = objs.count

        def col(t):  # per-object leaf -> (N, 1, ..., 1)
            return t.reshape((n,) + (1,) * ndim)

        dev = objs.radius.device
        self.org = Vec3(*(col(c) for c in objs.org))
        self.fnorm = Vec3(*(col(c) for c in objs.normal))
        self.radius = col(objs.radius)
        self.sphere = col(objs.kind) == KIND_SPHERE
        self.skip = col(torch.arange(n, dtype=torch.int32, device=dev)) == torch.as_tensor(
            ig, device=dev)
        self.glow_dist = col(scene.materials.glow_dist[objs.mat.long()])

    def __call__(self, pos: Vec3, need_glow: bool = True):
        """``(dist, idx, glow)``; without ``need_glow`` the glow is None."""
        delta = self.org - pos
        # sphere max(|org - p| - r, 0) (render.rs:473-475); floor
        # max((p - o).n, 0) (render.rs:571-573), where (p - o).n is exactly
        # -((o - p).n) since rounding is symmetric under negation
        d_sphere = torch.clamp(torch.sqrt(delta.dot(delta)) - self.radius, min=0.0)
        d_floor = torch.clamp(-delta.dot(self.fnorm), min=0.0)
        dist = torch.where(self.sphere, d_sphere, d_floor)
        closest, idx = torch.where(self.skip, _INF, dist).min(dim=0)
        glowing = None
        if need_glow:
            glow = dist * self.glow_dist
            glowing = torch.where(~self.skip & (glow > 0.0), glow, _INF).amin(dim=0)
        return closest, idx.to(torch.int32), glowing


def distance_estimate(scene: Scene, pos: Vec3, ig):
    """Scene SDF: nearest object distance, its index and the glow metric
    (render.rs:1226-1251). The glow metric is ``dist * material.glow_dist``,
    min-tracked over the objects where it is positive (+inf where none is).
    Object ``ig`` is skipped."""
    ndim = len(torch.broadcast_shapes(pos.x.shape, pos.y.shape, pos.z.shape))
    return _SceneSDF(scene, ig, ndim)(pos)


def march_single(scene: Scene, cfg: RenderConfig, init_pos: Vec3, eye: Vec3, ig,
                 active=None, need_glow: bool = True) -> MarchResult:
    """Sphere-trace a ray batch until ``dist < eps``, ``dist > far`` or past
    the iteration cap (render.rs:1266-1297). Position, travel and the
    iteration count update *before* the stop check, as in the reference, so
    the result includes the final step.

    ``active``: optional lane mask. Inactive lanes start done and return
    their initial state; callers mask the results. ``need_glow=False``
    skips the glow metric (a shadow march reads only travel and iter):
    ``min_dist`` stays +inf."""
    shape = torch.broadcast_shapes(init_pos.shape, eye.shape)
    eye = eye.broadcast_to(shape)
    pos = init_pos.broadcast_to(shape)
    dev = eye.x.device
    done = (torch.zeros(shape, dtype=torch.bool, device=dev) if active is None
            else ~active.expand(shape))

    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    travel, final_dist = zeros, zeros
    it = torch.zeros(shape, dtype=torch.int32, device=dev)
    idx = it
    min_dist = torch.full(shape, _INF, dtype=torch.float32, device=dev)

    sdf = _SceneSDF(scene, ig, len(shape))
    step = 0
    while step % CHECK_EVERY != 0 or bool((~done).any()):
        dist, d_idx, glow = sdf(pos, need_glow)
        live = ~done
        new_iter = it + 1
        stop = (dist < cfg.march_eps) | (dist > cfg.far_away) | (new_iter > cfg.march_max_iter)
        # a settled lane steps by 0: p + e*0 == p, t + 0 == t
        step_len = torch.where(live, dist, 0.0)
        pos = pos + eye * step_len
        travel = travel + step_len
        it = torch.where(live, new_iter, it)
        if need_glow:
            min_dist = torch.where(live & (glow < min_dist), glow, min_dist)
        final_dist = torch.where(live, dist, final_dist)
        idx = torch.where(live, d_idx, idx)
        done = done | (live & stop)
        step += 1
    return MarchResult(final_dist, idx, pos, it, travel, min_dist)
