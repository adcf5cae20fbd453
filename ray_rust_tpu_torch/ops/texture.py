"""UV mapping and procedural patterns (render.rs:220-233, 301-314).

PyTorch counterpart of the pattern half of ``ray_rust_tpu/ops/texture.py``.
Image-texture sampling comes with the textures slice (ROADMAP queue 2, K1a).
"""

from __future__ import annotations

import torch

from ..models.material import (
    PATTERN_CHECKERBOARD,
    PATTERN_GRADATION,
    UVMAP_LL,
    UVMAP_YZ,
    UVMAP_ZX,
)
from ..models.vec import Color, Vec3
from ..utils.fastmath import atan2
from ..utils.modutil import fmod

__all__ = ["get_uv", "lookup_diffuse"]


def get_uv(rel: Vec3, uvmap, pattern_scale, pattern_angle_scale):
    """UV of the hit relative to the object origin for all four projections,
    selected per hit by ``uvmap`` (render.rs:220-233)."""
    ps = pattern_scale
    u = rel.x / ps
    v = rel.y / ps
    u = torch.where(uvmap == UVMAP_YZ, rel.y / ps, u)
    v = torch.where(uvmap == UVMAP_YZ, rel.z / ps, v)
    u = torch.where(uvmap == UVMAP_ZX, rel.z / ps, u)
    v = torch.where(uvmap == UVMAP_ZX, rel.x / ps, v)
    u_ll = atan2(rel.z, rel.x) / pattern_angle_scale
    v_ll = atan2(torch.sqrt(rel.x * rel.x + rel.z * rel.z), rel.y) / pattern_angle_scale
    u = torch.where(uvmap == UVMAP_LL, u_ll, u)
    v = torch.where(uvmap == UVMAP_LL, v_ll, v)
    return u, v


def lookup_diffuse(scene, fields, uv) -> Color:
    """Diffuse color at a hit from its procedural pattern
    (render.rs:301-314): checkerboard black where floor(u)+floor(v) is even,
    repeated gradation scales red by frac(u) and green by frac(v)."""
    if scene.textures is not None:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP queue 2, K1a)")
    u, v = uv
    diffuse = fields.diffuse
    pattern = fields.pattern

    ix = torch.floor(u).to(torch.int32)
    iy = torch.floor(v).to(torch.int32)
    black = (pattern == PATTERN_CHECKERBOARD) & (torch.remainder(ix + iy, 2) == 0)
    col = Color(*(torch.where(black, 0.0, c) for c in diffuse))
    grad = Color(diffuse.r * fmod(u, 1.0), diffuse.g * fmod(v, 1.0), diffuse.b)
    return grad.where(pattern == PATTERN_GRADATION, col)
