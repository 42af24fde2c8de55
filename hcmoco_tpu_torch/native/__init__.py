"""ctypes binding for the native host cores (preproc.cpp, resample.cpp);
counterpart of hcmoco_tpu/native/__init__.py.

Each library is built with g++ (-O3 -march=native) at first use into
`build/hcmoco_tpu_torch/native/` at the repository root (git-ignored),
never into the source tree.  The directory name carries a hash of the
source, the flags, the compiler's version and the host's CPU, so a
library built for one host is never loaded on another.  All callers fall
back to the numpy/PIL versions, the reference's semantics, when the
compiler or the library is unavailable; `library_route()` says which one a
run took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent.parent / "build" / "hcmoco_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_cache: dict = {}


@functools.lru_cache(maxsize=None)
def _machine_key() -> str:
    """The CPU's model and feature flags and the compiler's version:
    -march=native code is only valid where these match."""
    h = hashlib.sha256(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    h.update(line.encode())
                    if line.startswith("flags"):
                        break
    except OSError:
        pass
    try:
        h.update(subprocess.run([_cxx(), "--version"], capture_output=True,
                                timeout=30).stdout)
    except (OSError, subprocess.SubprocessError):
        pass
    return h.hexdigest()[:12]


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def library_path(name: str) -> Path:
    """Where libhcmoco_<name>.so of <name>.cpp is built on this host."""
    src = _HERE / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{h.hexdigest()[:12]}-{_machine_key()}" / \
        f"libhcmoco_{name}.so"


def build_native(name: str) -> Optional[Path]:
    """Compile <name>.cpp unless this exact build exists; None if g++ is
    missing or fails.  The library is written under a temporary name and
    renamed into place, so concurrent processes never load a partial file."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        r = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                            str(_HERE / f"{name}.cpp")],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


class NativeLib:
    def __init__(self, cdll):
        self._c = cdll
        c = cdll
        c.parse_skeleton.restype = ctypes.c_long
        c.parse_skeleton.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long]
        c.ransac_homography.restype = ctypes.c_long
        c.ransac_homography.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_double, ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        c.warp_perspective_u8.restype = ctypes.c_int
        c.warp_perspective_u8.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long]

    def parse_skeleton(self, path: str,
                       max_records: int = 1 << 20) -> Optional[np.ndarray]:
        buf = np.empty((max_records, 10), np.float64)
        n = self._c.parse_skeleton(path.encode(), buf, max_records)
        if n < 0:
            if n == -1:
                return None
            # buffer too small; retry sized
            buf = np.empty((-n, 10), np.float64)
            n = self._c.parse_skeleton(path.encode(), buf, -n)
            if n < 0:
                return None
        return buf[:n].copy()

    def ransac_homography(self, src: np.ndarray, dst: np.ndarray,
                          thresh: float, iters: int,
                          seed: int) -> Optional[np.ndarray]:
        src = np.ascontiguousarray(src, np.float64)
        dst = np.ascontiguousarray(dst, np.float64)
        out = np.empty(9, np.float64)
        n = self._c.ransac_homography(src, dst, len(src), thresh, iters,
                                      seed, out)
        if n < 0:
            return None
        return out.reshape(3, 3)

    def warp_perspective(self, img: np.ndarray, h_inv: np.ndarray,
                         out_size: Tuple[int, int]) -> Optional[np.ndarray]:
        img = np.ascontiguousarray(img, np.uint8)
        w, hh = out_size
        out = np.empty((hh, w, img.shape[2]), np.uint8)
        rc = self._c.warp_perspective_u8(
            img, img.shape[0], img.shape[1], img.shape[2],
            np.ascontiguousarray(h_inv, np.float64).reshape(-1), out, hh, w)
        return out if rc == 0 else None


class ResampleLib:
    """Pixel-exact PIL resize replacement (resample.cpp): crop window read
    straight from the (mmap) frame + BILINEAR u8 / NEAREST u16 resample +
    flip, in one native call."""

    def __init__(self, cdll):
        self._c = cdll
        c = cdll
        c.resized_crop_u8.restype = ctypes.c_int
        c.resized_crop_u8.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        c.resized_crop_nearest_u16.restype = ctypes.c_int
        c.resized_crop_nearest_u16.argtypes = [
            np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")]

    def resized_crop_u8(self, frame: np.ndarray, i: int, j: int, h: int,
                        w: int, out_hw: Tuple[int, int],
                        flip: bool = False,
                        out: Optional[np.ndarray] = None
                        ) -> Optional[np.ndarray]:
        """frame: (H, W, C) uint8 (C-contiguous; mmap slices fine).
        Returns (out_h, out_w, C) uint8, PIL-crop+BILINEAR-resize exact.
        `out`: optional preallocated C-contiguous destination (e.g. a batch
        slot) — the resample writes straight into it, skipping the
        per-sample allocation + collate copy."""
        if frame.ndim == 2:
            frame = frame[:, :, None]
        if not frame.flags["C_CONTIGUOUS"]:
            frame = np.ascontiguousarray(frame)
        oh, ow = out_hw
        if out is None:
            out = np.empty((oh, ow, frame.shape[2]), np.uint8)
        rc = self._c.resized_crop_u8(
            frame, frame.shape[0], frame.shape[1], frame.shape[2],
            i, j, h, w, oh, ow, int(flip), out)
        return out if rc == 0 else None

    def resized_crop_nearest_u16(self, frame: np.ndarray, i: int, j: int,
                                 h: int, w: int, out_hw: Tuple[int, int],
                                 flip: bool = False,
                                 out: Optional[np.ndarray] = None
                                 ) -> Optional[np.ndarray]:
        if not frame.flags["C_CONTIGUOUS"]:
            frame = np.ascontiguousarray(frame)
        oh, ow = out_hw
        if out is None:
            out = np.empty((oh, ow), np.uint16)
        rc = self._c.resized_crop_nearest_u16(
            frame, frame.shape[0], frame.shape[1],
            i, j, h, w, oh, ow, int(flip), out)
        return out if rc == 0 else None


def _load(name: str, cls):
    """Load (building if needed) libhcmoco_<name>.so once per process; None if
    unavailable.  HCMOCO_NO_NATIVE forces the numpy/PIL fallbacks."""
    with _lock:
        if name not in _cache:
            lib = None
            if not os.environ.get("HCMOCO_NO_NATIVE"):
                path = build_native(name)
                if path is not None:
                    try:
                        lib = cls(ctypes.CDLL(str(path)))
                    except OSError:
                        lib = None
            _cache[name] = lib
        return _cache[name]


def native_lib() -> Optional[NativeLib]:
    """The preprocessing core (skeleton parse, RANSAC, warp); None if
    unavailable."""
    return _load("preproc", NativeLib)


def resample_lib() -> Optional[ResampleLib]:
    """The resample core; None if unavailable (callers fall back to PIL —
    identical pixels either way)."""
    return _load("resample", ResampleLib)


def library_route(name: str) -> str:
    """'native <path>' if libhcmoco_<name>.so is loaded in this process, else
    'numpy/PIL fallback'."""
    lib = _cache.get(name)
    return f"native {library_path(name)}" if lib is not None \
        else "numpy/PIL fallback"
