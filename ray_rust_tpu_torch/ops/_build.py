"""Build and load the port's native kernels from ``ray_rust_tpu_torch/csrc``.

The CUDA kernels (``trace_fwd.cu``, ``march_fwd.cu``, ``trace_bwd.cu``,
``march_bwd.cu``, ``trace_retrace.cu``, ``pack_scene.cu``) are compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into shared libraries with a
plain C interface, which are loaded with ``ctypes``. A library's file name carries
a hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. The builds go to ``ray_rust_tpu_torch/_build/``
(git-ignored), each with its compiler output beside it, so a cached build
reports the same ptxas lines as a fresh one. A failed build raises with the
compiler's output. :func:`prebuild` runs several builds at once, one
compiler each. Each of ``trace_fwd``, ``march_fwd``, ``trace_bwd`` and
``march_bwd`` also builds as ``<name>_global`` with ``-DRT_GLOBAL_TABLES``:
the same launcher, its kernels reading the object tables from global memory
(``csrc/trace_body.cuh: GLOBAL_TABLES``) for scenes too large for shared
memory.

:func:`build_host_library` compiles a kernel's per-pixel body for the CPU
with ``g++`` (``csrc/trace_host.cpp``, ``csrc/march_host.cpp``,
``csrc/trace_bwd_host.cpp``, ``csrc/march_bwd_host.cpp``,
``csrc/trace_retrace_host.cpp``, ``csrc/pack_scene_host.cpp``), for the
tests; with ``count_ops=True`` it builds it with ``-DRT_COUNT_OPS``, which
adds the f32 operations the body takes to a counter, for the kernels'
roofline bound (the march bodies also count object passes and each pixel's
largest counts, ``kernel_march.OPS_SLOTS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load_cuda_library", "prebuild", "build_host_library", "called_functions",
           "build_logs", "build_seconds", "BUILD_DIR", "CSRC_DIR", "GLOBAL_SUFFIX"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]
COUNT_FLAGS = ["-DRT_COUNT_OPS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float

# C signatures, up to the output planes: the CUDA launchers add the device
# and the stream, their host loops the operation counter. The trace and
# march kernels take the texture atlas after their render arguments
# (kernel_trace.texture_args).
_TRACE_CFG = [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I]
_MARCH_CFG = [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _I, _F, _I]
_TEX_ARGS = [_P, _P, _I, _I, _I]
# the trace forward takes K1b's switch after the atlas
_TRACE_ARGS = _TRACE_CFG + _TEX_ARGS + [_I] + [_P, _P, _P]
_MARCH_ARGS = _MARCH_CFG + _TEX_ARGS + [_P, _P, _P]
# the backward kernels: the forward's render arguments, the cutoff, (trace:
# the record cap), the atlas, the three cotangent planes, the block, the
# three primal planes
_BWD_ARGS = _TRACE_CFG + [_F, _I] + _TEX_ARGS + [_P] * 7
_MARCH_BWD_ARGS = _MARCH_CFG + [_F] + _TEX_ARGS + [_P] * 7
# the re-trace gradient: the trace backward's, without the record cap and
# the atlas
_RETRACE_ARGS = _TRACE_CFG + [_F] + [_P] * 7
# the scene pack: the leaves' pointer array, n, m, the texture count, the
# texels a texture, the output words; its pull-back: the block, the material
# indices, n, m, the output
_PACK_ARGS = [_P, _I, _I, _I, _I, _P]
_PACK_VJP_ARGS = [_P, _P, _I, _I, _P]
_CUDA_FNS = {"trace_fwd": ("rt_trace_fwd", _TRACE_ARGS), "march_fwd": ("rt_march_fwd", _MARCH_ARGS),
             "trace_bwd": ("rt_trace_bwd", _BWD_ARGS),
             "march_bwd": ("rt_march_bwd", _MARCH_BWD_ARGS),
             "trace_retrace": ("rt_trace_retrace", _RETRACE_ARGS),
             "pack_scene": ("rt_pack_scene", _PACK_ARGS)}
_HOST_FNS = {"trace": ("rt_trace_host", _TRACE_ARGS), "march": ("rt_march_host", _MARCH_ARGS),
             "trace_bwd": ("rt_trace_bwd_host", _BWD_ARGS),
             "march_bwd": ("rt_march_bwd_host", _MARCH_BWD_ARGS),
             "trace_retrace": ("rt_trace_retrace_host", _RETRACE_ARGS),
             "pack_scene": ("rt_pack_scene_host", _PACK_ARGS)}
# Other functions a library exports (its CUDA and host builds alike):
# name -> (argtypes, restype). The pull-back's host build keeps the kernel's
# interface (csrc/pack_scene_host.cpp).
_EXTRA_FNS = {"trace_retrace": {"rt_trace_retrace_lanes": ([], _I)},
              "trace": {"rt_cull_masks_host": ([_P] * 4 + [_I] * 3 + [_F] * 2 + [_I] * 2
                                               + [_P] * 2, None)},
              "pack_scene": {"rt_pack_scene_vjp": (_PACK_VJP_ARGS + [_I, _P], _I)}}

# Each build's compiler output (for nvcc, ptxas's registers, stack and
# spills), by library stem, and the seconds its compiler took (this process's
# builds only; a cached library takes none).
build_logs: dict = {}
build_seconds: dict = {}
_cuda_libs: dict = {}


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
    and the compiler output, which is kept in ``lib<stem>-<hash>.log`` beside
    the library and recorded in ``build_logs[stem]``."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh", ".cpp", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    out = out_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        build_logs[stem] = log_path.read_text()
        return out, build_logs[stem]
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.time()
    proc = subprocess.run(compiler + ["-o", tmp, str(main_src)],
                          capture_output=True, text=True)
    build_seconds[stem] = time.time() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {main_src.name} failed:\n{proc.stderr}")
    log_path.write_text(proc.stderr)  # before the library: a cached build has its log
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_logs[stem] = proc.stderr
    return out, proc.stderr


def _bind(path: Path, fn_name: str, argtypes: list, restype, extra=None) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in [(fn_name, (argtypes, restype))] + list((extra or {}).items()):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


GLOBAL_SUFFIX = "_global"


def _source(name: str) -> tuple:
    """The ``.cu`` stem of CUDA library ``name`` and its extra flags."""
    if name.endswith(GLOBAL_SUFFIX):
        return name[:-len(GLOBAL_SUFFIX)], ["-DRT_GLOBAL_TABLES"]
    return name, []


def _compile_cuda(name: str) -> Path:
    src, flags = _source(name)
    return _compile([_find_nvcc()] + NVCC_FLAGS + flags, CSRC_DIR / f"{src}.cu", BUILD_DIR,
                    name)[0]


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load CUDA library ``name`` (``"trace_fwd"``,
    ``"march_fwd"``, ``"trace_bwd"``, ``"march_bwd"``, ``"trace_retrace"``
    or ``"pack_scene"``; the first four also with ``_global``)."""
    if name not in _cuda_libs:
        src = _source(name)[0]
        fn_name, argtypes = _CUDA_FNS[src]
        lib = _bind(_compile_cuda(name), fn_name, argtypes + [_I, _P], _I,
                    _EXTRA_FNS.get(src, {}))
        lib.rt_error_string.argtypes = [_I]
        lib.rt_error_string.restype = ctypes.c_char_p
        _cuda_libs[name] = lib
    return _cuda_libs[name]


def prebuild(names) -> None:
    """Compile several CUDA libraries at once, one ``nvcc`` each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for f in [pool.submit(_compile_cuda, n) for n in names]:
            f.result()


def called_functions(ptxas_log: str) -> list:
    """The functions that ``ptxas -v`` reports in ``ptxas_log`` besides the
    kernels (entry functions): device functions left as real calls. Raises
    if the log reports no kernel."""
    entries = set(re.findall(r"Compiling entry function '([^']+)'", ptxas_log))
    if not entries:
        raise ValueError("the ptxas log reports no kernel")
    reported = re.findall(r"Function properties for (\S+)", ptxas_log)
    return sorted(set(reported) - entries)


def build_host_library(out_dir, name: str = "trace", count_ops: bool = False) -> ctypes.CDLL:
    """Build and load ``csrc/<name>_host.cpp``: a kernel's per-pixel body in
    a CPU loop (``rt_trace_host``, with K1b's ``rt_cull_masks_host``,
    ``rt_march_host``, ``rt_trace_bwd_host``, ``rt_march_bwd_host``,
    ``rt_trace_retrace_host`` or ``rt_pack_scene_host``, with
    ``rt_pack_scene_vjp``)."""
    stem = f"{name}_host" + ("_ops" if count_ops else "")
    path, _ = _compile(["g++"] + GXX_FLAGS + (COUNT_FLAGS if count_ops else []),
                       CSRC_DIR / f"{name}_host.cpp", Path(out_dir), stem)
    fn_name, argtypes = _HOST_FNS[name]
    return _bind(path, fn_name, argtypes + [_P], None, _EXTRA_FNS.get(name, {}))
