"""The per-tile object cull (K1b) in plain PyTorch.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py:_build_candidates`` and
``_corner_dir``, which the JAX trace kernel runs at each tile's start above
64 objects. The port's cull lives in the trace kernel's body
(``csrc/trace_body.cuh: cull_tile, cull_object``); this module computes the
same two masks, operation for operation in f32, for one tile at a time, so
the tests can hold the kernel's host build against it and check that the
masks hold every object the tile's rays reach. Nothing on the card's main
path calls it.

A tile's camera rays all lie in the pyramid over its corner pixels' rays.
In camera space a pixel's ray is ``(1, ey, ez)`` with ``ey`` and ``ez`` from
``ops/rays.py``'s arithmetic, monotone in the pixel, so the pyramid's side
planes have the exact normals ``(-ylo, 1, 0)``, ``(yhi, -1, 0)``, ``(-zlo, 0,
1)`` and ``(zhi, 0, -1)``; they are rotated into the world as the rays are.
A sphere is a primary candidate unless it lies more than its radius and a
margin outside one plane, and a shadow candidate unless it does so for a
plane that faces the light; floors are always both. The margin covers f32
rounding (``trace_body.cuh: cull_object`` says why it is enough).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.scene import KIND_SPHERE, Scene
from .rays import fov_scales

__all__ = ["TILE", "CULL_REL", "CULL_ABS", "CULL_SHADOW_MIN", "tile_planes", "tile_masks",
           "tiles"]

TILE = 16  # csrc/trace_body.cuh: rt::CULL_TILE, the trace kernel's block
CULL_REL = 2e-3  # rt::CULL_REL
CULL_ABS = 1e-5  # rt::CULL_ABS
CULL_SHADOW_MIN = 2e-3  # rt::CULL_SHADOW_MIN


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _qmul(a, b):
    """Hamilton product of quaternions (x, y, z, w), in trace_body.cuh's
    term order."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (ay * bz - az * by + ax * bw + aw * bx,
            az * bx - ax * bz + ay * bw + aw * by,
            ax * by - ay * bx + az * bw + aw * bz,
            -ax * bx - ay * by - az * bz + aw * bw)


def _rotate(q, v):
    """``q * (v, 0) * conj(q)``, as the camera ray is rotated."""
    qc = (-q[0], -q[1], -q[2], q[3])
    r = _qmul(_qmul(q, (v[0], v[1], v[2], _f32(0.0))), qc)
    return r[0], r[1], r[2]


def _normalized(v):
    sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    if not bool(sq > 0.0):
        return (_f32(0.0),) * 3
    ln = torch.sqrt(sq)
    return v[0] / ln, v[1] / ln, v[2] / ln


def _pixel_e(i: int, res: int, s: float, row: bool) -> torch.Tensor:
    """``(i - res // 2) * s / res`` in f32 as ``ops/rays.py`` computes it,
    negated first for a row."""
    e = _f32(float(i - res // 2))
    return (-e if row else e) * _f32(s) / _f32(float(res))


def tile_planes(cam: torch.Tensor, light: torch.Tensor, cfg: RenderConfig, col0: int,
                row0: int):
    """The side planes of the pyramid of the tile whose top-left pixel is
    ``(col0, row0)`` (the whole ``TILE`` by ``TILE`` tile: a ragged one is
    only widened): four unit inward normals ``(nx, ny, nz)`` as f32 scalars,
    and whether each also culls shadow rays. ``cam`` is the packed camera
    row (position xyz, rotation xyzw), ``light`` the light direction."""
    sx, sy = fov_scales(cfg)
    ya, yb = _pixel_e(col0, cfg.xres, sx, False), _pixel_e(col0 + TILE - 1, cfg.xres, sx, False)
    za, zb = _pixel_e(row0, cfg.yres, sy, True), _pixel_e(row0 + TILE - 1, cfg.yres, sy, True)
    ylo, yhi = torch.minimum(ya, yb), torch.maximum(ya, yb)
    zlo, zhi = torch.minimum(za, zb), torch.maximum(za, zb)
    one, zero = _f32(1.0), _f32(0.0)
    q = tuple(cam[k] for k in range(3, 7))
    planes = []
    for nc in ((-ylo, one, zero), (yhi, -one, zero), (-zlo, zero, one), (zhi, zero, -one)):
        n = _normalized(_rotate(q, nc))
        nl = n[0] * light[0] + n[1] * light[1] + n[2] * light[2]
        planes.append((n, bool(nl >= _f32(CULL_SHADOW_MIN))))
    return planes


def tile_masks(scene: Scene, cfg: RenderConfig, col0: int, row0: int, tables=None):
    """K1b's two candidate masks of the tile at ``(col0, row0)``: boolean
    ``(N,)`` tensors, primary and shadow. ``tables`` are the packed f32
    table, i32 table, camera and light (``kernel_pack.pack_scene``'s, for
    a CPU scene); by default the scene's own."""
    if tables is None:
        from .kernel_pack import pack_scene

        tables = pack_scene(scene)
    f32t, i32t, cam, light = (t.detach().cpu() for t in tables)
    cam, light = cam[0], light[0]
    planes = tile_planes(cam, light, cfg, col0, row0)
    dx, dy, dz = f32t[:, 0] - cam[0], f32t[:, 1] - cam[1], f32t[:, 2] - cam[2]
    r = f32t[:, 17].abs()
    cam_abs = cam[0].abs() + cam[1].abs() + cam[2].abs()
    m = r + _f32(CULL_REL) * (dx.abs() + dy.abs() + dz.abs() + r) + _f32(CULL_ABS) * cam_abs
    out_p = torch.zeros_like(r, dtype=torch.bool)
    out_s = torch.zeros_like(out_p)
    for (nx, ny, nz), shadow in planes:
        out = nx * dx + ny * dy + nz * dz < -m
        out_p |= out
        if shadow:
            out_s |= out
    floor = i32t[:, 0] != KIND_SPHERE
    return floor | ~out_p, floor | ~out_s


def tiles(cfg: RenderConfig):
    """The top-left pixels ``(col0, row0)`` of the trace kernel's tiles."""
    return [(c, r) for r in range(0, cfg.yres, TILE) for c in range(0, cfg.xres, TILE)]
