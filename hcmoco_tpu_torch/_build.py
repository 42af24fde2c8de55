"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles each of `csrc/*.cu` for `sm_90a` into an object, all of
them at once in parallel processes, and links the objects into one shared
library with a plain C interface under `build/hcmoco_tpu_torch/` at the
repository root (git-ignored).  The file name carries a hash of every
source and header under `csrc/` and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  A failed build
raises: there is no fallback to the plain PyTorch versions.

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
SOURCES = tuple(_PKG_DIR / "csrc" / name for name in (
    "matmul_bn.cu",      # K1, K1b
    "fps.cu",            # K2
    "ball_query.cu",     # K3
    "three_nn.cu",       # K4
    "point_gather.cu",   # K5, K6, K56a, K56b
))
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

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
    csrc = _PKG_DIR / "csrc"
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhcmoco_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            _check_proc(cmd, proc.returncode, stdout, stderr)
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_proc(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _check_proc(cmd, rc: int, stdout: str, stderr: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call; argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            f = ctypes.c_float
            lib.hcmoco_mm_bn_slots.argtypes = [ci] * 4
            lib.hcmoco_mm_bn_stats.argtypes = [ci] + [vp] * 6 + [ci] * 3 + [vp]
            lib.hcmoco_mm_bn_dyt.argtypes = [ci] + [vp] * 5 + [ci, ci, vp]
            lib.hcmoco_bn_fwd.argtypes = ([ci] + [vp] * 12
                                          + [ci, ci, ci, f, f, f, f, vp])
            lib.hcmoco_bn_bwd_slots.argtypes = [ci, ci]
            lib.hcmoco_bn_bwd_stats.argtypes = ([ci] + [vp] * 14
                                                + [ci, ci, ci, vp])
            lib.hcmoco_bn_bwd_dy.argtypes = [ci] + [vp] * 4 + [ci, ci, vp]
            lib.hcmoco_fps_scratch.argtypes = [ci]
            lib.hcmoco_fps_scratch.restype = ctypes.c_longlong
            lib.hcmoco_fps.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            lib.hcmoco_ball_query.argtypes = [vp, vp, vp, ci, ci, ci, ci,
                                              ctypes.c_float, vp]
            lib.hcmoco_three_nn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            lib.hcmoco_group_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                             vp]
            lib.hcmoco_interp_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                              ci, vp]
            lib.hcmoco_dest_csr.argtypes = [vp] * 5 + [ci] * 4 + [vp]
            lib.hcmoco_segment_sum.argtypes = [vp] * 6 + [ci] * 5 + [vp]
            for fn in (lib.hcmoco_mm_bn_slots, lib.hcmoco_mm_bn_stats,
                       lib.hcmoco_mm_bn_dyt, lib.hcmoco_bn_fwd,
                       lib.hcmoco_bn_bwd_slots, lib.hcmoco_bn_bwd_stats,
                       lib.hcmoco_bn_bwd_dy, lib.hcmoco_fps,
                       lib.hcmoco_ball_query, lib.hcmoco_three_nn,
                       lib.hcmoco_group_fwd, lib.hcmoco_interp_fwd,
                       lib.hcmoco_dest_csr, lib.hcmoco_segment_sum):
                fn.restype = ci
            lib.hcmoco_cuda_error_string.argtypes = [ci]
            lib.hcmoco_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.hcmoco_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
