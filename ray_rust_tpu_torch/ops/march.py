"""SDF evaluation and the sphere-tracing march, with the implicit VJP.

PyTorch counterpart of ``ray_rust_tpu/ops/march.py``:
``distance_estimate`` (render.rs:1226-1251) and ``march_single``
(render.rs:1266-1297), in its while mode and in its scan mode. The scene
SDF is evaluated for every object at once along a leading object axis and
reduced in order (strictly closer wins, the first index wins ties, the
ignored object is masked by index), which gives the same values as the JAX
package's object-by-object loop.

``march_single`` is a batched masked loop over the whole ray batch. The host
reads ``any(~done)`` only every ``CHECK_EVERY`` steps, so it does not
synchronise with the device each step; the extra steps are masked no-ops on
settled lanes, as the JAX package's chunked ``while_loop`` runs them.

Scan mode (``cfg.differentiable``, the JAX package's ``lax.scan`` path,
``ray_rust_tpu/ops/march.py:344-364``): every ray runs exactly
``cfg.march_budget`` masked steps of the same body, with no host reads, and
autograd differentiates through every step; rays not settled within the
budget count as escaped (``iter = march_max_iter + 1``, ``final_dist =
2 * far_away``). It is the brute-force gradient oracle of the implicit VJP
below, a mode the caller selects: nothing falls back to it, and the march
kernels never run it (``renderer.render_color`` sends such a config to the
plain march on either device). Autograd keeps every step's SDF, so its
memory grows as steps x rays x objects: a march whose recorded residuals
would pass ``SCAN_MAX_BYTES`` raises (:func:`scan_residual_bytes`).

While mode: where a scene leaf, the start point or the direction requires
grad, the march runs inside :class:`_ImplicitMarch`, the counterpart of the
JAX package's closed-form implicit VJP ``_march_while_vjp``. The loop itself
is never differentiated: the hit point is a root of the scene SDF along the
ray, ``D(p0 + e t*, θ) = 0``, so by the implicit function theorem

    dt* = -(∇D·dp0 + t* ∇D·de + D_θ·dθ) / (∇D·e),

one SDF vjp at the hit. The glow channel ``min_dist`` differentiates through
one glow-metric evaluation at its argmin position ``glow_pos``: a constant
where the argmin lies inside the path (the envelope), the hit itself where
it is the march's last sample (its spatial gradient then joins the hit's
cotangent). Only ``pos`` and ``min_dist`` carry cotangents.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..models.scene import KIND_SPHERE, Scene
from ..models.vec import Vec3

__all__ = ["MarchResult", "distance_estimate", "march_single", "scan_residual_bytes",
           "SCAN_MAX_BYTES"]

# Masked march steps between two host reads of "is any lane still live".
CHECK_EVERY = 16

# The most residual bytes one scan-mode march may record for autograd.
SCAN_MAX_BYTES = 8 << 30

_INF = float("inf")


class MarchResult(NamedTuple):
    """Per-ray march outcome (reference RaymarchSingleResult,
    render.rs:1257-1264), with the position before the step that set
    ``min_dist`` (``glow_pos``) and that step's index (``glow_iter``, -1 where
    no glow was seen), as the JAX package carries them for the VJP."""

    final_dist: torch.Tensor
    idx: torch.Tensor  # int32
    pos: Vec3
    iter: torch.Tensor  # int32
    travel_dist: torch.Tensor
    min_dist: torch.Tensor  # running min of the glow metric
    glow_pos: Vec3
    glow_iter: torch.Tensor  # int32

    def where(self, mask, other: "MarchResult") -> "MarchResult":
        """Lane select: ``mask ? self : other``."""
        return MarchResult(*(a.where(mask, b) if isinstance(a, Vec3) else torch.where(mask, a, b)
                             for a, b in zip(self, other)))


def _object_columns(scene: Scene):
    """The SDF's per-object inputs: the kind, and the float columns org xyz,
    normal xyz, radius and the material's ``glow_dist`` (gathered, so
    autograd reaches the material table)."""
    objs = scene.objects
    return objs.kind, (*objs.org, *objs.normal, objs.radius,
                       scene.materials.glow_dist[objs.mat.long()])


class _SceneSDF:
    """The scene SDF for points of ``ndim`` dimensions: the object columns
    laid along a leading object axis, with object ``ig`` (a scalar or a
    tensor of the points' shape) masked. Built once per march, since nothing
    in it changes from step to step."""

    def __init__(self, kind, cols, ig, ndim: int):
        n = kind.shape[0]

        def col(t):  # per-object column -> (N, 1, ..., 1)
            return t.reshape((n,) + (1,) * ndim)

        ox, oy, oz, nx, ny, nz, radius, glow_dist = (col(c) for c in cols)
        self.org = Vec3(ox, oy, oz)
        self.fnorm = Vec3(nx, ny, nz)
        self.radius = radius
        self.glow_dist = glow_dist
        self.sphere = col(kind) == KIND_SPHERE
        self.skip = col(torch.arange(n, dtype=torch.int32, device=kind.device)) == ig

    def __call__(self, pos: Vec3, need_glow: bool = True):
        """``(dist, idx, glow)``; without ``need_glow`` the glow is None."""
        delta = self.org - pos
        # sphere max(|org - p| - r, 0) (render.rs:473-475), its square root
        # guarded under autograd so that the gradient stays finite at
        # |org - p| = 0 (the value is the same); floor max((p - o).n, 0)
        # (render.rs:571-573), where (p - o).n is exactly -((o - p).n) since
        # rounding is symmetric under negation
        sq = delta.dot(delta)
        if sq.requires_grad:
            nonzero = sq > 0
            length = torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)
        else:
            length = torch.sqrt(sq)
        d_sphere = torch.clamp(length - self.radius, min=0.0)
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
    kind, cols = _object_columns(scene)
    return _SceneSDF(kind, cols, torch.as_tensor(ig, device=kind.device), ndim)(pos)


def scan_residual_bytes(n_objects: int, rays: int, budget: int) -> int:
    """The bytes autograd records for a scan-mode march of ``budget`` steps
    over ``rays`` rays and ``n_objects`` objects, rounded up: per step and
    ray, 36 bytes an object for the SDF and 24 of march state (with glow,
    34 and 18 bytes measured by ``torch.autograd.graph.saved_tensors_hooks``
    on 5, 20 and 40 objects: tests/test_torch_march_grad.py)."""
    return budget * rays * (36 * n_objects + 24)


def _march_loop(sdf: _SceneSDF, cfg: RenderConfig, pos: Vec3, eye: Vec3, done,
                need_glow: bool, budget=None) -> MarchResult:
    """The masked step loop from start points ``pos`` (lanes already done
    stay as they are): until every lane is done, or, given a ``budget``,
    exactly that many steps (the scan mode, which autograd differentiates;
    lanes still live at its end count as escaped)."""
    shape, dev = done.shape, done.device
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    travel, final_dist = zeros, zeros
    it = torch.zeros(shape, dtype=torch.int32, device=dev)
    idx = it
    min_dist = torch.full(shape, _INF, dtype=torch.float32, device=dev)
    glow_pos, glow_iter = pos, torch.full(shape, -1, dtype=torch.int32, device=dev)

    step = 0
    while (step < budget if budget is not None
           else step % CHECK_EVERY != 0 or bool((~done).any())):
        dist, d_idx, glow = sdf(pos, need_glow)
        live = ~done
        new_iter = it + 1
        stop = (dist < cfg.march_eps) | (dist > cfg.far_away) | (new_iter > cfg.march_max_iter)
        if need_glow:  # the argmin sample is the position before the step
            upd = live & (glow < min_dist)
            min_dist = torch.where(upd, glow, min_dist)
            glow_pos = pos.where(upd, glow_pos)
            glow_iter = torch.where(upd, it, glow_iter)
        # a settled lane steps by 0: p + e*0 == p, t + 0 == t
        step_len = torch.where(live, dist, 0.0)
        pos = pos + eye * step_len
        travel = travel + step_len
        it = torch.where(live, new_iter, it)
        final_dist = torch.where(live, dist, final_dist)
        idx = torch.where(live, d_idx, idx)
        done = done | (live & stop)
        step += 1
    if budget is not None:  # the reference treats an exhausted march as escaped
        it = torch.where(done, it, cfg.march_max_iter + 1)
        final_dist = torch.where(done, final_dist, cfg.far_away * 2)
    return MarchResult(final_dist, idx, pos, it, travel, min_dist, glow_pos, glow_iter)


class _ImplicitMarch(torch.autograd.Function):
    """The march as a function of its start points, directions and the
    objects' SDF columns, differentiated by the implicit function theorem
    (``ray_rust_tpu/ops/march.py:_march_while_vjp``, its contract exactly).
    Outputs in :class:`MarchResult` order, Vec3s flattened; only ``pos`` and
    ``min_dist`` carry cotangents."""

    @staticmethod
    def forward(ctx, cfg, need_glow, kind, ig, done, px, py, pz, ex, ey, ez, *cols):
        eye = Vec3(ex, ey, ez)
        res = _march_loop(_SceneSDF(kind, cols, ig, done.dim()), cfg, Vec3(px, py, pz), eye,
                          done, need_glow)
        ctx.cfg, ctx.need_glow = cfg, need_glow
        ctx.save_for_backward(kind, ig, ex, ey, ez, res.final_dist, *res.pos, res.iter,
                              res.travel_dist, res.min_dist, *res.glow_pos, res.glow_iter, *cols)
        out = (res.final_dist, res.idx, *res.pos, res.iter, res.travel_dist, res.min_dist,
               *res.glow_pos, res.glow_iter)
        ctx.mark_non_differentiable(*(out[k] for k in (0, 1, 5, 6, 8, 9, 10, 11)))
        return out

    @staticmethod
    def backward(ctx, _fd, _idx, g_px, g_py, g_pz, _it, _travel, g_min, *_glow):
        (kind, ig, ex, ey, ez, final_dist, px, py, pz, it, travel, min_dist,
         gx, gy, gz, glow_iter, *cols) = ctx.saved_tensors
        cfg = ctx.cfg
        eye = Vec3(ex, ey, ez)
        hit = final_dist < cfg.march_eps
        gp = Vec3(*(torch.where(hit, g, 0.0) for g in (g_px, g_py, g_pz)))
        with torch.enable_grad():
            leaves = [c.detach().requires_grad_() for c in cols]
            sdf = _SceneSDF(kind, leaves, ig, final_dist.dim())
            scene_ct = [torch.zeros_like(c) for c in cols]

            def add_scene(grads):
                for k, g in enumerate(grads):
                    if g is not None:
                        scene_ct[k] = scene_ct[k] + g

            if ctx.need_glow:
                # glow channel, split by where the argmin landed: inside the
                # path the sample position is a constant (the envelope); at
                # the march's last sample it tracks the moving surface, so
                # its spatial gradient joins the hit point's cotangent
                gmin = torch.where(torch.isfinite(min_dist), g_min, 0.0)
                end_arg = hit & (glow_iter == it - 1)
                xg = [c.detach().requires_grad_() for c in (gx, gy, gz)]
                _, _, glow = sdf(Vec3(*xg))
                glow = torch.where(torch.isfinite(glow), glow, 0.0)
                grads = torch.autograd.grad(glow, leaves + xg, gmin, allow_unused=True)
                add_scene(grads[:len(leaves)])
                gp = gp + Vec3(*(torch.where(end_arg, g, 0.0) for g in grads[len(leaves):]))

            # the hit point by the implicit function theorem: ∇D and
            # ddt = ∇D·e at the hit; grazing hits (|ddt| ~ 0) get no gradient
            x = [c.detach().requires_grad_() for c in (px, py, pz)]
            d, _, _ = sdf(Vec3(*x), need_glow=False)
            grad_d = Vec3(*torch.autograd.grad(d, x, torch.ones_like(d), retain_graph=True))
            ddt = grad_d.dot(eye)
            safe = hit & (torch.abs(ddt) > 1e-5)
            w = torch.where(safe, -gp.dot(eye) / torch.where(safe, ddt, 1.0), 0.0)
            add_scene(torch.autograd.grad(d, leaves, w, allow_unused=True))

        # x* = p0 + e t*: p̄0 = ḡ + w ∇D, ē = t* p̄0
        p0_bar = gp + grad_d * w
        t_star = torch.where(hit, travel, 0.0)
        eye_bar = p0_bar * t_star
        return (None, None, None, None, None, *p0_bar, *eye_bar, *scene_ct)


def march_single(scene: Scene, cfg: RenderConfig, init_pos: Vec3, eye: Vec3, ig,
                 active=None, need_glow: bool = True) -> MarchResult:
    """Sphere-trace a ray batch until ``dist < eps``, ``dist > far`` or past
    the iteration cap (render.rs:1266-1297). Position, travel and the
    iteration count update *before* the stop check, as in the reference, so
    the result includes the final step.

    ``active``: optional lane mask. Inactive lanes start done and return
    their initial state; callers mask the results. ``need_glow=False``
    skips the glow metric (a shadow march reads only travel and iter):
    ``min_dist`` stays +inf. Differentiable through the implicit VJP
    (:class:`_ImplicitMarch`) wherever an input requires grad; a caller that
    reads only decisions (the shadow march) runs it under ``no_grad``.

    With ``cfg.differentiable`` every call runs the scan mode (module
    docstring), the shadow march too, and autograd differentiates it step
    by step; it raises ``ValueError`` where the steps' residuals would pass
    ``SCAN_MAX_BYTES``."""
    shape = torch.broadcast_shapes(init_pos.shape, eye.shape)
    eye = eye.broadcast_to(shape)
    pos = init_pos.broadcast_to(shape)
    dev = eye.x.device
    done = (torch.zeros(shape, dtype=torch.bool, device=dev) if active is None
            else ~active.expand(shape))
    ig = torch.as_tensor(ig, device=dev)
    kind, cols = _object_columns(scene)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (*cols, *pos, *eye))
    if cfg.differentiable:
        need = scan_residual_bytes(kind.shape[0], done.numel(), cfg.march_budget)
        if grad and need > SCAN_MAX_BYTES:
            raise ValueError(
                f"the scan-mode march would record ~{need / 2**30:.1f} GiB for autograd "
                f"({cfg.march_budget} steps x {done.numel()} rays x {kind.shape[0]} objects), "
                f"more than SCAN_MAX_BYTES ({SCAN_MAX_BYTES / 2**30:.0f} GiB): it is an "
                "oracle for small frames; take the implicit VJP (differentiable=False)")
        return _march_loop(_SceneSDF(kind, cols, ig, len(shape)), cfg, pos, eye, done,
                           need_glow, budget=cfg.march_budget)
    if grad:
        out = _ImplicitMarch.apply(cfg, need_glow, kind, ig, done, *pos, *eye, *cols)
        return MarchResult(out[0], out[1], Vec3(*out[2:5]), *out[5:8], Vec3(*out[8:11]),
                           out[11])
    return _march_loop(_SceneSDF(kind, cols, ig, len(shape)), cfg, pos, eye, done, need_glow)
