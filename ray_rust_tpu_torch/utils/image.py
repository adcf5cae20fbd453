"""Host-side image IO: PNG write/read and the debug gradient prefill.

PyTorch-port counterpart of ``ray_rust_tpu/utils/image.py``. The PNG codec is
a short writer over the standard library's ``zlib``, so it needs neither PIL
nor a native toolchain. :func:`load_png` reads back the files
:func:`save_png` writes: 8-bit RGB, rows without a filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["save_png", "encode_png", "load_png", "gradient_prefill"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(data: np.ndarray) -> bytes:
    """Encode an ``(H, W, 3)`` uint8 buffer as PNG bytes (filter 0 rows)."""
    img = np.ascontiguousarray(data, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, data: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 buffer as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(data))


def load_png(path: str) -> np.ndarray:
    """Read a PNG written by :func:`save_png` into an ``(H, W, 3)`` uint8 array."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only rows without a filter (type 0) are read")
    return raw[:, 1:].reshape(h, w, 3).copy()


def gradient_prefill(width: int, height: int) -> np.ndarray:
    """The reference's debug gradient the render buffer starts from
    (main.rs:140-146); visible only where a pixel is never written."""
    x = np.arange(width)[None, :]
    y = np.arange(height)[:, None]
    data = np.zeros((height, width, 3), np.uint8)
    data[..., 0] = (x * 255 // width).astype(np.uint8)
    data[..., 1] = (y * 255 // height).astype(np.uint8)
    data[..., 2] = ((x + y) % 32 + 32).astype(np.uint8)
    return data
