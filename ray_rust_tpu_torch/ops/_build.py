"""Build and load the port's native kernels from ``ray_rust_tpu_torch/csrc``.

The CUDA kernels are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is loaded
with ``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
The build goes to ``ray_rust_tpu_torch/_build/`` (git-ignored). A failed
build raises with the compiler's output.

:func:`build_host_library` compiles the same per-pixel body for the CPU with
``g++`` (``csrc/trace_host.cpp``), for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_trace_library", "build_host_library", "BUILD_DIR", "CSRC_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float

# The last build's compiler output (register and spill counts from ptxas).
build_log = ""
_trace_lib = None


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _compile(compiler: list, main_src: Path, out_dir: Path, stem: str) -> tuple:
    """Compile ``main_src`` (which includes headers from csrc) into
    ``out_dir/lib<stem>-<hash>.so`` unless that file exists. Returns the path
    and the compiler output."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh", ".cpp", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    out = out_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run(compiler + ["-o", tmp, str(main_src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {main_src.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, proc.stderr


def load_trace_library() -> ctypes.CDLL:
    """Build (if needed) and load the CUDA trace kernel library."""
    global _trace_lib, build_log
    if _trace_lib is None:
        path, build_log = _compile([_find_nvcc()] + NVCC_FLAGS,
                                   CSRC_DIR / "trace_fwd.cu", BUILD_DIR, "trace_fwd")
        lib = ctypes.CDLL(str(path))
        lib.rt_trace_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I,
                                     _P, _P, _P, _I, _P]
        lib.rt_trace_fwd.restype = _I
        lib.rt_error_string.argtypes = [_I]
        lib.rt_error_string.restype = ctypes.c_char_p
        _trace_lib = lib
    return _trace_lib


def build_host_library(out_dir) -> ctypes.CDLL:
    """Build and load ``csrc/trace_host.cpp``: the kernel's per-pixel body
    in a CPU loop."""
    path, _ = _compile(["g++"] + GXX_FLAGS, CSRC_DIR / "trace_host.cpp",
                       Path(out_dir), "trace_host")
    lib = ctypes.CDLL(str(path))
    lib.rt_trace_host.argtypes = [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I,
                                  _P, _P, _P]
    lib.rt_trace_host.restype = None
    return lib
