"""Quaternion camera pose (parity with reference src/quat.rs:6-134).

PyTorch counterpart of ``ray_rust_tpu/models/quat.py``: the pitch-yaw-roll
constructor, vector rotation, and ``slerp`` for the camera animation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import Vec3, _f32

__all__ = ["Quat"]


class Quat(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor

    def dot(self, o: "Quat"):
        return self.x * o.x + self.y * o.y + self.z * o.z + self.w * o.w

    def conjugated(self) -> "Quat":
        return Quat(-self.x, -self.y, -self.z, self.w)

    def __mul__(self, o: "Quat") -> "Quat":
        """Hamilton product, component layout as in quat.rs:63-72."""
        qa, qb = self, o
        return Quat(
            qa.y * qb.z - qa.z * qb.y + qa.x * qb.w + qa.w * qb.x,
            qa.z * qb.x - qa.x * qb.z + qa.y * qb.w + qa.w * qb.y,
            qa.x * qb.y - qa.y * qb.x + qa.z * qb.w + qa.w * qb.z,
            -qa.x * qb.x - qa.y * qb.y - qa.z * qb.z + qa.w * qb.w,
        )

    def transform(self, v: Vec3) -> Vec3:
        """Rotate a vector: ``q * (v,0) * conj(q)`` (quat.rs:74-80)."""
        qr = self * Quat(v.x, v.y, v.z, torch.zeros_like(v.x))
        qret = qr * self.conjugated()
        return Vec3(qret.x, qret.y, qret.z)

    @staticmethod
    def rotation(p, sx: float, sy: float, sz: float) -> "Quat":
        """Axis-angle rotation; axis must be normalized (quat.rs:92-95)."""
        half = _f32(p) / 2.0
        s = torch.sin(half)
        return Quat(s * sx, s * sy, s * sz, torch.cos(half))

    def slerp(self, o: "Quat", t) -> "Quat":
        """Spherical interpolation with the long-path sign fix (quat.rs:97-127),
        on the quaternion's device. Branchless as the JAX package's: where
        ``1 - dot^2`` is at most sqrt(1e-10) (nearly parallel), returns
        ``self`` unchanged."""
        t = _f32(t, self.x.device)
        qr = self.dot(o)
        ss = 1.0 - qr * qr
        degenerate = ss <= torch.sqrt(_f32(1e-10))
        sp = torch.sqrt(torch.where(degenerate, 1.0, ss))
        ph = torch.arccos(torch.clamp(qr, -1.0, 1.0))
        pt = ph * t
        t1 = torch.sin(pt) / sp
        t0 = torch.sin(ph - pt) / sp
        t1 = torch.where(qr < 0.0, -t1, t1)  # long path (quat.rs:116-118)
        return Quat(*(torch.where(degenerate, a, a * t0 + b * t1) for a, b in zip(self, o)))

    @staticmethod
    def from_pyr(pyr: Vec3) -> "Quat":
        """Pitch-yaw-roll to quaternion with the reference's axis convention
        (quat.rs:129-134): roll about +X, yaw about +Z, pitch about +Y."""
        mx = Quat.rotation(pyr.z, 1.0, 0.0, 0.0)
        my = Quat.rotation(pyr.y, 0.0, 0.0, 1.0)
        mp = Quat.rotation(pyr.x, 0.0, 1.0, 0.0)
        return mx * my * mp
