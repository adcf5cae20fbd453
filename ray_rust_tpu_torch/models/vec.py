"""Batched 3-vector and RGB color as structure-of-arrays NamedTuples of tensors.

PyTorch counterpart of ``ray_rust_tpu/models/vec.py``: each component is its
own tensor, so a ``Vec3`` of ``(H, W)`` components keeps the image layout of
the JAX package at every public function. Components broadcast like tensors
(a 0-d tensor or a Python float stands for a scalar).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Vec3", "Color", "v3", "color"]


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def normalized(self) -> "Vec3":
        """``v / sqrt(v·v)`` as a sqrt followed by a divide (not rsqrt), safe
        at zero length for autograd (vec3.rs:36-39)."""
        sq = self.dot(self)
        ok = sq > 0
        ln = torch.sqrt(torch.where(ok, sq, 1.0))
        return Vec3(
            torch.where(ok, self.x / ln, 0.0),
            torch.where(ok, self.y / ln, 0.0),
            torch.where(ok, self.z / ln, 0.0),
        )

    def where(self, mask, other: "Vec3") -> "Vec3":
        """Elementwise select: ``mask ? self : other``."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    @property
    def shape(self):
        return self.x.shape

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(*(c.expand(shape) for c in self))

    def take(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])


class Color(NamedTuple):
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor

    def sum(self):
        return self.r + self.g + self.b

    def where(self, mask, other: "Color") -> "Color":
        return Color(
            torch.where(mask, self.r, other.r),
            torch.where(mask, self.g, other.g),
            torch.where(mask, self.b, other.b),
        )

    def take(self, idx) -> "Color":
        return Color(self.r[idx], self.g[idx], self.b[idx])

    @staticmethod
    def zero(shape, device=None) -> "Color":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Color(z, z, z)

    @staticmethod
    def full(r, g, b, shape, device=None) -> "Color":
        def f(v):
            return torch.full(shape, v, dtype=torch.float32, device=device)

        return Color(f(r), f(g), f(b))

    def to_array(self) -> torch.Tensor:
        """Stack into a dense ``(..., 3)`` tensor."""
        return torch.stack([self.r, self.g, self.b], dim=-1)


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def v3(x, y, z, device=None) -> Vec3:
    return Vec3(_f32(x, device), _f32(y, device), _f32(z, device))


def color(r, g, b, device=None) -> Color:
    """A Color of f32 tensors: counterpart of ``ray_rust_tpu.models.vec.color``."""
    return Color(_f32(r, device), _f32(g, device), _f32(b, device))
