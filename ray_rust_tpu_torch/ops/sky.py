"""Background shaders (the reference's ``bgproc``, src/main.rs:231-260).

PyTorch counterpart of ``ray_rust_tpu/ops/sky.py``: a small registry of
functions keyed by name, since code pointers never serialize.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.vec import Color, Vec3
from ..utils.fastmath import asin, atan2
from ..utils.modutil import rust_rem

__all__ = ["default_sky", "black_bg", "get_bg", "BACKGROUNDS", "BG_IDS"]

_PI = np.float32(np.pi)
_A = float(np.float32(50.0) * _PI)  # 50π rounded in f32, as in the JAX package
_TWO_PI = float(np.float32(2.0) * _PI)


def default_sky(light: Vec3, direction: Vec3) -> Color:
    """Angular stripe grid + sun glare (main.rs:231-260), branch-free."""
    phi = atan2(direction.z, direction.x)
    the = asin(torch.clamp(direction.y, -1.0, 1.0))
    d = rust_rem(_A + phi * 10.0 * float(_PI), _TWO_PI) - float(_PI)
    dd = rust_rem(_A + the * 10.0 * float(_PI), _TWO_PI) - float(_PI)

    base_r = 0.5 / (15.0 * (d * d * dd * dd) + 1.0)
    base_gb = 0.25 - direction.y / 4.0

    dot = light.dot(direction)
    glare = torch.where(dot > 0.995, (dot - 0.995) * 150.0, 0.0)
    dot2 = torch.where(dot > 0.9, (dot - 0.9) * 5.0, 0.0)

    sun = dot > 0.9995
    return Color(
        torch.where(sun, 2.0, base_r + glare + dot2),
        torch.where(sun, 2.0, base_gb + glare + dot2),
        torch.where(sun, 2.0, base_gb + glare),
    )


def black_bg(light: Vec3, direction: Vec3) -> Color:
    z = torch.zeros_like(direction.x)
    return Color(z, z, z)


BACKGROUNDS = {
    "default_sky": default_sky,
    "black": black_bg,
}
# Background ids the CUDA kernel takes (csrc/trace_body.cuh: rt_background).
BG_IDS = {"default_sky": 0, "black": 1}


def get_bg(name: str):
    try:
        return BACKGROUNDS[name]
    except KeyError:
        raise KeyError(f"unknown background {name!r}; known: {list(BACKGROUNDS)}")
