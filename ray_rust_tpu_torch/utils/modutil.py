"""Wrap-around modulo helpers (parity with reference src/modutil.rs:1-14).

PyTorch counterpart of ``ray_rust_tpu/utils/modutil.py``: the exact float32
formulas of the Rust code, including the integer variants' detour through
f32 (modutil.rs:4-9).
"""

from __future__ import annotations

import torch

__all__ = ["fmod", "imod", "umod", "fimod", "rust_rem"]


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _i32(v):
    return torch.as_tensor(v, dtype=torch.int32)


def fmod(f, freq):
    """Floored f32 modulo: ``f - floor(f/freq)*freq`` (modutil.rs:1-3)."""
    f, freq = _f32(f), _f32(freq)
    return f - torch.floor(f / freq) * freq


def imod(f, freq):
    """Integer modulo via f32 division (modutil.rs:4-6)."""
    f, freq = _i32(f), _i32(freq)
    q = torch.floor(f.to(torch.float32) / freq.to(torch.float32)).to(torch.int32)
    return f - q * freq


umod = imod  # modutil.rs:7-9: same formula, inputs assumed >= 0


def fimod(f, freq):
    """``(frac, idx)`` split of the floored modulo (modutil.rs:10-14); the
    Rust ``as i32`` casts truncate toward zero."""
    fm = fmod(f, freq)
    idx = imod(fm.to(torch.int32), _f32(freq).to(torch.int32))
    return fm - torch.floor(fm), idx


def rust_rem(a, b):
    """Rust's ``%`` on f32: truncated remainder, sign of the dividend."""
    return torch.fmod(_f32(a), _f32(b))
