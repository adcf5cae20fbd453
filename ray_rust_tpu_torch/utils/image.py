"""Host-side image IO: PNG write/read and the debug gradient prefill.

PyTorch-port counterpart of ``ray_rust_tpu/utils/image.py``.
:func:`encode_png` and :func:`save_png` are written over the standard
library's ``zlib`` and numpy (8-bit RGB rows without a filter), so they need
neither PIL nor a native toolchain. Unlike the JAX package they do not take
the native encoder (``utils/native.py``) where it builds: on a 1920x1080
frame it filters every row and takes 2.5x as long (PERF.md §5); the native
library writes only the camera-motion frames, through
``utils/native.FrameWriter``'s pool. :func:`load_png` reads any
non-interlaced RGB PNG of bit depth 8 or 16 with the five row filters, the
files a texture comes in (:func:`ray_rust_tpu_torch.models.material.load_texture`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["save_png", "encode_png", "load_png", "PngNotRgb", "gradient_prefill"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_RGB = 2


class PngNotRgb(ValueError):
    """A valid PNG whose pixels are not RGB (grey, grey-alpha, palette or
    RGBA): the images the reference does not sample as textures."""


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters (PNG spec 9.2) of ``raw``: ``h`` rows of a filter
    byte and ``stride`` bytes, ``bpp`` bytes a pixel."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:  # None
            cur = row.copy()
        elif kind == 1:  # Sub: a running sum along each byte of the pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left result
            cur = bytearray(row.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def load_png(path: str) -> np.ndarray:
    """Read an RGB PNG into an ``(H, W, 3)`` uint8 array: bit depth 8, or 16
    with the high byte of each sample kept (as PIL's ``RGB;16B`` mode does),
    any of the five row filters. Raises :class:`PngNotRgb` for grey,
    grey-alpha, palette and RGBA files, and ``ValueError`` for a file that is
    not a PNG, is damaged, or is interlaced (Adam7), which this reader does
    not decode."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if len(data) != n or blob[pos + 8 + n:pos + 12 + n] != struct.pack(
                ">I", zlib.crc32(kind + data) & 0xFFFFFFFF):
            raise ValueError(f"{path}: damaged {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype != _COLOUR_RGB:
        raise PngNotRgb(f"{path}: colour type {ctype}, not RGB")
    if depth not in (8, 16):
        raise ValueError(f"{path}: RGB at bit depth {depth}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
    bpp = 3 * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for {w}x{h}")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w * bpp, bpp, path)
    if depth == 16:  # big-endian samples: keep the high byte
        px = px[:, 0::2]
    return np.ascontiguousarray(px.reshape(h, w, 3))


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
