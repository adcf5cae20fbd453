"""Materials: host-side spec + device-side structure-of-arrays table.

PyTorch counterpart of ``ray_rust_tpu/models/material.py``. Every material
field is stacked into a table of ``(M,)`` tensors; objects refer to rows by
index. Image textures are stacked into one :class:`TextureBank`, and a
material refers to its texture by ``texture_id``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.image import PngNotRgb, load_png
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
    "PATTERN_NAMES",
    "PATTERN_IDS",
    "FILTER_NAMES",
    "FILTER_IDS",
    "UVMAP_NAMES",
    "UVMAP_IDS",
    "MaterialSpec",
    "MaterialTable",
    "TextureBank",
    "build_material_table",
    "load_texture",
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

# The enums' names in scene files (serde's variant names)
PATTERN_NAMES = {PATTERN_SOLID: "Solid", PATTERN_CHECKERBOARD: "Checkerboard",
                 PATTERN_GRADATION: "RepeatedGradation"}
PATTERN_IDS = {v: k for k, v in PATTERN_NAMES.items()}
FILTER_NAMES = {FILTER_NEAREST: "Nearest", FILTER_BILINEAR: "Bilinear"}
FILTER_IDS = {v: k for k, v in FILTER_NAMES.items()}
UVMAP_NAMES = {UVMAP_XY: "XY", UVMAP_YZ: "YZ", UVMAP_ZX: "ZX", UVMAP_LL: "LL"}
UVMAP_IDS = {v: k for k, v in UVMAP_NAMES.items()}


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
        """Attach a texture image, quietly ignoring load failure
        (render.rs:177-181)."""
        self.texture_name = path
        self.texture = load_texture(path)
        return self


# Signatures of image files that PIL, which the JAX package reads textures
# with, would decode and this port does not: such a file raises rather than
# leaving the material untextured.
_OTHER_IMAGES = (b"\xff\xd8\xff", b"BM", b"II*\x00", b"MM\x00*", b"P6")


def load_texture(path: str) -> Optional[np.ndarray]:
    """Load an RGB8 texture (``(H, W, 3)`` uint8), or None where the JAX
    package's ``load_texture`` gives None: a missing file, a file that is no
    image, or a PNG that is not RGB (the reference only samples
    ``DynamicImage::ImageRgb8``, render.rs:251). 16-bit RGB keeps the high
    byte, as PIL does. An interlaced PNG, or another image format, raises
    ``ValueError``: the JAX package would texture with it, so None would
    render a different image."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return None
    if head.startswith(_OTHER_IMAGES) or (head[:4] == b"RIFF" and head[8:12] == b"WEBP"):
        raise ValueError(f"{path}: textures are read from PNG files only")
    if not head.startswith(b"\x89PNG\r\n\x1a\n"):
        return None
    try:
        return load_png(path)
    except PngNotRgb:
        return None


class TextureBank(NamedTuple):
    """Stacked, zero-padded texture atlas with per-texture true sizes.

    ``packed`` stores each texel's 2x2 wrap-around neighbourhood (p00, p10,
    p01, p11: x then y, 12 u8 channels), so one lookup serves both filters
    (``ops/texture.py:sample_texture_packed``) and the trace kernel reads a
    texel's four taps in one 16-byte load (``ops/kernel_trace.py:
    pack_textures``)."""

    data: torch.Tensor  # (T, Hmax, Wmax, 3) uint8
    heights: torch.Tensor  # (T,) int32
    widths: torch.Tensor  # (T,) int32
    packed: torch.Tensor  # (T, Hmax, Wmax, 12) uint8


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


def _texture_bank(textures: list) -> TextureBank:
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    data = np.zeros((len(textures), hmax, wmax, 3), np.uint8)
    packed = np.zeros((len(textures), hmax, wmax, 12), np.uint8)
    for i, t in enumerate(textures):
        h, w = t.shape[:2]
        data[i, :h, :w] = t
        xp = (np.arange(w) + 1) % w
        yp = (np.arange(h) + 1) % h
        packed[i, :h, :w, 0:3] = t
        packed[i, :h, :w, 3:6] = t[:, xp]  # (x+1 wrap, y)
        packed[i, :h, :w, 6:9] = t[yp, :]  # (x, y+1 wrap)
        packed[i, :h, :w, 9:12] = t[yp][:, xp]  # (x+1, y+1)
    sizes = np.asarray([t.shape[:2] for t in textures], np.int32)
    return TextureBank(torch.from_numpy(data), torch.from_numpy(sizes[:, 0].copy()),
                       torch.from_numpy(sizes[:, 1].copy()), torch.from_numpy(packed))


def build_material_table(specs: Sequence[MaterialSpec]):
    """Stack host specs into a :class:`MaterialTable` and a
    :class:`TextureBank` (None when no spec has a texture). Returns
    ``(table, bank_or_None)``; ``specs`` order defines material ids, and each
    textured material gets its own texture id, in that order."""
    textures, tex_ids = [], []
    for s in specs:
        tex_ids.append(len(textures) if s.texture is not None else -1)
        if s.texture is not None:
            textures.append(np.asarray(s.texture, np.uint8))
    bank = _texture_bank(textures) if textures else None

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float32))

    def i32(vals):
        return torch.tensor(np.asarray(vals, np.int32))

    table = MaterialTable(
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
        texture_id=i32(tex_ids),
        texture_filter=i32([s.texture_filter for s in specs]),
    )
    return table, bank
