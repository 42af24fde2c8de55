"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles `csrc/*.cu` for `sm_90a` into one shared library with a
plain C interface under `build/hcmoco_tpu_torch/` at the repository root
(git-ignored).  The file name carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.  A failed
build raises: there is no fallback to the plain PyTorch versions.

Nothing here runs at import time, so the package imports on machines with
no GPU and no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = _PKG_DIR.parent / "build" / "hcmoco_tpu_torch"
SOURCES = (_PKG_DIR / "csrc" / "matmul_bn.cu",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of hcmoco_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhcmoco_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call; argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.hcmoco_mm_bn_row_tile.argtypes = []
            lib.hcmoco_mm_bn_row_tile.restype = ci
            lib.hcmoco_mm_bn_stats.argtypes = [vp, vp, vp, vp, vp,
                                               ci, ci, ci, vp]
            lib.hcmoco_mm_bn_stats.restype = ci
            lib.hcmoco_cuda_error_string.argtypes = [ci]
            lib.hcmoco_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.hcmoco_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
