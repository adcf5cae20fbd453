"""ctypes bindings for the repository's native host runtime (``native/png_io.cpp``).

PyTorch-port counterpart of ``ray_rust_tpu/utils/native.py``: the PNG
encoder (``rrt_png_encode``, ``rrt_png_write``: each row takes the filter of
the five with the smallest sum of absolute deltas, then zlib) and the
pthread frame-writer pool (``rrt_writer_*``). The source is compiled in
place from ``native/png_io.cpp`` with ``g++ -O3 -shared -fPIC -lz
-lpthread`` at first use, once per process and under a lock, into
``ray_rust_tpu_torch/_build/`` (git-ignored; the file name carries a hash of
the source and flags, and the library is written atomically, so processes
that build at once never load half a file). Where g++, ``zlib.h`` or the
source is missing, :func:`native_available` is false and
``utils/image.py`` encodes with the standard library's ``zlib``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "native_available", "build_error", "FrameWriter", "encode_png_native",
           "write_png_native", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "png_io.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_lib = None
_error = None  # why the library is unavailable, once a build failed


def _build() -> Path:
    """Compile ``SOURCE`` into ``BUILD_DIR`` unless that build exists; the
    library's path. Raises ``OSError`` (no source, no g++) or
    ``RuntimeError`` (the compiler's output) when it cannot."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libpng_io-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(SOURCE), "-o", tmp, *_LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {SOURCE.name} failed:\n{proc.stderr.strip()}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "rrt_png_encode": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)], ctypes.c_int),
        "rrt_png_write": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int], ctypes.c_int),
        "rrt_free": ([u8p], None),
        "rrt_writer_create": ([ctypes.c_int], ctypes.c_void_p),
        "rrt_writer_submit": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int], None),
        "rrt_writer_drain": ([ctypes.c_void_p], ctypes.c_int),
        "rrt_writer_destroy": ([ctypes.c_void_p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def get_lib():
    """The loaded library, or None when it cannot be built or loaded here
    (:func:`build_error` says why). Builds at most once per process."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(_build())
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
                _error = str(e)
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_error():
    """Why the native library is unavailable (the compiler's output, or the
    missing file or tool), or None."""
    get_lib()
    return _error


def _as_bytes(data) -> tuple:
    arr = np.ascontiguousarray(np.asarray(data, np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {arr.shape}")
    h, w, _ = arr.shape
    return arr.tobytes(), w, h


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native png_io unavailable: {_error}")
    return lib


def encode_png_native(data, level: int = 6) -> bytes:
    """PNG bytes of an ``(H, W, 3)`` uint8 buffer from the native encoder."""
    lib = _require()
    raw, w, h = _as_bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    if lib.rrt_png_encode(raw, w, h, level, ctypes.byref(out), ctypes.byref(out_len)) != 0:
        raise RuntimeError("native PNG encode failed")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.rrt_free(out)


def write_png_native(path: str, data, level: int = 6) -> None:
    lib = _require()
    raw, w, h = _as_bytes(data)
    if lib.rrt_png_write(os.fsencode(path), raw, w, h, level) != 0:
        raise RuntimeError(f"native PNG write failed: {path}")


_IEND = b"\x00\x00\x00\x00IEND\xaeB`\x82"  # the chunk every whole PNG ends with


def _written(path: str) -> bool:
    """Whether ``path`` is a file holding a whole PNG (it ends with IEND)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() < 8 + len(_IEND):
                return False
            f.seek(-len(_IEND), os.SEEK_END)
            return f.read() == _IEND
    except OSError:  # missing, or a directory
        return False


class FrameWriter:
    """Asynchronous PNG frame writer over the native pthread pool: frame i+1
    renders on the card while earlier frames are encoded and written by
    native threads (the reference's worker pipeline, src/render.rs:836-898).
    Without the native library each :meth:`submit` writes synchronously with
    ``utils/image.save_png``, which raises on a failed write.

    :meth:`close` joins the pool and returns how many submitted frames are
    not on disk whole. That count is exact where :meth:`drain`'s is not:
    the native ``rrt_writer_drain`` returns once the last frame is taken off
    the queue, so a frame a thread is still writing may fail after it."""

    def __init__(self, n_threads: int = 2, level: int = 6):
        self._level = level
        self._lib = get_lib()
        self._handle = self._lib.rrt_writer_create(n_threads) if self._lib else None
        self._paths = []
        self._failed = 0

    def submit(self, path: str, data) -> None:
        if self._handle:
            raw, w, h = _as_bytes(data)  # the pool copies the buffer
            try:  # a stale file must not pass for this frame in close()
                os.unlink(path)
            except OSError:
                pass
            self._paths.append(path)
            self._lib.rrt_writer_submit(self._handle, os.fsencode(path), raw, w, h, self._level)
        else:
            from .image import save_png

            save_png(path, data)

    def drain(self) -> int:
        """Block until the pool's queue is empty; the number of frames that
        have failed so far (frames still being written not included)."""
        return self._lib.rrt_writer_drain(self._handle) if self._handle else 0

    def close(self) -> int:
        """Stop the pool and join its threads, so every frame is written or
        failed; the number of submitted frames that are not on disk whole
        (the same number on every later call)."""
        if self._handle:
            self._lib.rrt_writer_destroy(self._handle)  # drains the queue, joins
            self._handle = None
            self._failed = sum(not _written(p) for p in self._paths)
        return self._failed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
