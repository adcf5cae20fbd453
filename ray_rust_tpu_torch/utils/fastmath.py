"""f32 inverse trigonometry: Cephes ``atanf``/``asinf`` polynomials.

PyTorch counterpart of ``ray_rust_tpu/utils/fastmath.py``. Both JAX render
paths compute the sky and the lat-long UV map with these polynomials, so the
port keeps them, written op for op (``csrc/trace_body.cuh`` holds the same
formulas for the kernel), instead of calling ``torch.atan2``/``torch.asin``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["atan", "atan2", "asin"]

_PI = float(np.float32(np.pi))
_PIO2 = float(np.float32(np.pi / 2))
_PIO4 = float(np.float32(np.pi / 4))
_TAN3PIO8 = float(np.float32(2.414213562373095))  # tan(3π/8)
_TANPIO8 = float(np.float32(0.4142135623730950))  # tan(π/8)

_ATAN_P = [float(np.float32(c)) for c in
           (8.05374449538e-2, 1.38776856032e-1, 1.99777106478e-1, 3.33329491539e-1)]
_ASIN_P = [float(np.float32(c)) for c in
           (4.2163199048e-2, 2.4181311049e-2, 4.5470025998e-2, 7.4953002686e-2,
            1.6666752422e-1)]


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def atan(x):
    """Range-reduce to [0, tan(π/8)], then a degree-9 odd polynomial."""
    x = _f32(x)
    sign = torch.where(x < 0.0, -1.0, 1.0)
    a = torch.abs(x)
    big = a > _TAN3PIO8
    mid = (a > _TANPIO8) & ~big

    a_safe = torch.where(big, a, 1.0)
    xr = torch.where(big, -1.0 / a_safe, torch.where(mid, (a - 1.0) / (a + 1.0), a))
    y0 = torch.where(big, _PIO2, torch.where(mid, _PIO4, 0.0))

    z = xr * xr
    c0, c1, c2, c3 = _ATAN_P
    p = (((c0 * z - c1) * z + c2) * z - c3) * z * xr + xr
    return sign * (y0 + p)


def atan2(y, x):
    """``atan2(y, x)`` with the libm quadrant and axis conventions."""
    y, x = _f32(y), _f32(x)
    x_zero = x == 0.0
    z = atan(y / torch.where(x_zero, 1.0, x))
    w = torch.where(x < 0.0, torch.where(y < 0.0, -_PI, _PI), 0.0)
    on_axis = torch.where(y > 0.0, _PIO2, torch.where(y < 0.0, -_PIO2, 0.0))
    return torch.where(x_zero, on_axis, w + z)


def asin(x):
    """Arcsine; inputs are clamped to [-1, 1]."""
    x = _f32(x)
    sign = torch.where(x < 0.0, -1.0, 1.0)
    a = torch.clamp(torch.abs(x), max=1.0)
    flag = a > 0.5
    z = torch.where(flag, 0.5 * (1.0 - a), a * a)
    # the unselected sqrt branch gets 1.0, keeping its gradient finite at 0
    xr = torch.where(flag, torch.sqrt(torch.where(flag, z, 1.0)), a)
    c0, c1, c2, c3, c4 = _ASIN_P
    p = ((((c0 * z + c1) * z + c2) * z + c3) * z + c4) * z * xr + xr
    return sign * torch.where(flag, _PIO2 - 2.0 * p, p)
