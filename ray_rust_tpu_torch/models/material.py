"""Materials: host-side spec + device-side structure-of-arrays table.

PyTorch counterpart of ``ray_rust_tpu/models/material.py``. Every material
field is stacked into a table of ``(M,)`` tensors; objects refer to rows by
index. Image textures (``TextureBank``) come with the textures slice: until
then a spec that carries a texture is refused by
:func:`build_material_table`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .vec import Color

__all__ = [
    "PATTERN_SOLID",
    "PATTERN_CHECKERBOARD",
    "PATTERN_GRADATION",
    "FILTER_NEAREST",
    "FILTER_BILINEAR",
    "UVMAP_XY",
    "UVMAP_YZ",
    "UVMAP_ZX",
    "UVMAP_LL",
    "MaterialSpec",
    "MaterialTable",
    "build_material_table",
]

# RenderPattern (render.rs:44-49)
PATTERN_SOLID = 0
PATTERN_CHECKERBOARD = 1
PATTERN_GRADATION = 2

# TextureFilter (render.rs:59-63)
FILTER_NEAREST = 0
FILTER_BILINEAR = 1

# UVMap (render.rs:51-57)
UVMAP_XY = 0
UVMAP_YZ = 1
UVMAP_ZX = 2
UVMAP_LL = 3


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description (render.rs:106-181)."""

    name: str
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    pn: int = 0  # Phong exponent
    transparency: float = 0.0  # ``t``
    refraction: float = 0.0  # ``n``
    glow_dist: float = 0.0
    frac: tuple = (1.0, 1.0, 1.0)  # per-spectrum refraction (vestigial)
    pattern: int = PATTERN_SOLID
    pattern_scale: float = 1.0
    pattern_angle_scale: float = 1.0
    texture_name: str = ""
    texture_filter: int = FILTER_NEAREST
    texture: Optional[np.ndarray] = None  # (H, W, 3) uint8, RGB only

    def texture_ok(self, path: str) -> "MaterialSpec":
        """Record the texture path. Loading images comes with the textures
        slice; a missing file is ignored quietly as in the reference
        (render.rs:177-181), so a spec stays untextured here."""
        self.texture_name = path
        return self


class MaterialTable(NamedTuple):
    """Device-side SoA material table; every leaf has leading dim ``(M,)``."""

    diffuse: Color
    specular: Color
    pn: torch.Tensor  # f32 (powers are computed in f32)
    transparency: torch.Tensor
    refraction: torch.Tensor
    glow_dist: torch.Tensor
    frac: Color
    pattern: torch.Tensor  # int32
    pattern_scale: torch.Tensor
    pattern_angle_scale: torch.Tensor
    texture_id: torch.Tensor  # int32, -1 = none
    texture_filter: torch.Tensor  # int32


def build_material_table(specs: Sequence[MaterialSpec]) -> MaterialTable:
    """Stack host specs into a :class:`MaterialTable`; ``specs`` order
    defines material ids."""
    if any(s.texture is not None for s in specs):
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP queue 2, K1a)")

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float32))

    def i32(vals):
        return torch.tensor(np.asarray(vals, np.int32))

    return MaterialTable(
        diffuse=Color(*(f32([s.diffuse[c] for s in specs]) for c in range(3))),
        specular=Color(*(f32([s.specular[c] for s in specs]) for c in range(3))),
        pn=f32([s.pn for s in specs]),
        transparency=f32([s.transparency for s in specs]),
        refraction=f32([s.refraction for s in specs]),
        glow_dist=f32([s.glow_dist for s in specs]),
        frac=Color(*(f32([s.frac[c] for s in specs]) for c in range(3))),
        pattern=i32([s.pattern for s in specs]),
        pattern_scale=f32([s.pattern_scale for s in specs]),
        pattern_angle_scale=f32([s.pattern_angle_scale for s in specs]),
        texture_id=i32([-1] * len(specs)),
        texture_filter=i32([s.texture_filter for s in specs]),
    )
