"""Offline NTU preprocessing: skeleton parsing + RGB->depth-frame warping
(counterpart of hcmoco_tpu/data/preprocess.py).

Behavioral spec: `pycontrast/data/NTURGBD/` —
  * `generate_skeleton_data.py:17-53`: parse `.skeleton` text files into
    per-frame pkl dicts {frame_idx, joints: [{body_idx, 3d_loc, rgb_loc,
    d_loc}]} where each joint line holds x y z dx dy cx cy ...
  * `preprocess_nturgbd.py:26-97`: per (setup, camera) RANSAC homography
    fitted from RGB-joint <-> depth-joint correspondences (cv2.findHomography
    RANSAC), then warp every RGB video frame into the 512x424 depth frame.

The hot loops (text parsing of ~4M skeleton files, RANSAC iterations,
per-frame perspective warps) run in the C++ native core
(`hcmoco_tpu_torch/native/`) when built; numpy fallbacks keep everything
importable without a compiler.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native import native_lib

_TAG_REGEX = re.compile(r".*S(\d{3})C(\d{3})P(\d{3})R(\d{3})A(\d{3}).*")


def parse_skeleton_file(path: str) -> List[dict]:
    """Parse one `.skeleton` file into per-frame dicts (reference layout).

    Uses the C++ parser when available (~20x faster than the python text
    loop), falling back to pure python."""
    lib = native_lib()
    if lib is not None:
        arr = lib.parse_skeleton(path)
        if arr is not None:
            return _frames_from_records(arr)
    return _parse_skeleton_py(path)


def _parse_skeleton_py(path: str) -> List[dict]:
    with open(path) as f:
        data = f.read().split("\n")
    pos = 0

    def nxt():
        nonlocal pos
        line = data[pos]
        pos += 1
        return line

    frames = []
    n_frames = int(nxt())
    for frame_idx in range(n_frames):
        cur = {"frame_idx": frame_idx, "joints": []}
        for body_idx in range(int(nxt())):
            nxt()  # body info line
            body = {"body_idx": body_idx, "3d_loc": [], "rgb_loc": [],
                    "d_loc": []}
            for _ in range(int(nxt())):
                vals = np.array(nxt().split()[:7], np.float32)
                body["3d_loc"].append(list(vals[:3]))
                body["d_loc"].append(list(vals[3:5]))
                body["rgb_loc"].append(list(vals[5:7]))
            cur["joints"].append(body)
        frames.append(cur)
    return frames


def _frames_from_records(arr: np.ndarray) -> List[dict]:
    """(N, 10) records [frame, body, joint, x, y, z, dx, dy, cx, cy] ->
    reference frame dicts."""
    frames: List[dict] = []
    for rec in arr:
        fi, bi = int(rec[0]), int(rec[1])
        while len(frames) <= fi:
            frames.append({"frame_idx": len(frames), "joints": []})
        joints = frames[fi]["joints"]
        while len(joints) <= bi:
            joints.append({"body_idx": len(joints), "3d_loc": [],
                           "rgb_loc": [], "d_loc": []})
        joints[bi]["3d_loc"].append([float(rec[3]), float(rec[4]),
                                     float(rec[5])])
        joints[bi]["d_loc"].append([float(rec[6]), float(rec[7])])
        joints[bi]["rgb_loc"].append([float(rec[8]), float(rec[9])])
    return frames


def write_parsed_skeletons(skeleton_path: str, out_dir: str) -> int:
    """generate_skeleton_data.func equivalent: one pkl per frame."""
    frames = parse_skeleton_file(skeleton_path)
    os.makedirs(out_dir, exist_ok=True)
    for i, fd in enumerate(frames):
        with open(os.path.join(out_dir, f"Skeleton-{i:08d}.pkl"),
                  "wb") as f:
            pickle.dump(fd, f)
    return len(frames)


# ---------------------------------------------------------------------------
# Homography estimation + warping
# ---------------------------------------------------------------------------


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalized DLT from >=4 correspondences; (3,3) with H[2,2]=1."""
    def normalize(p):
        mean = p.mean(0)
        scale = np.sqrt(2.0) / max(np.linalg.norm(p - mean, axis=1).mean(),
                                   1e-12)
        t = np.array([[scale, 0, -scale * mean[0]],
                      [0, scale, -scale * mean[1]],
                      [0, 0, 1]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ t.T
        return ph[:, :2], t

    s, ts = normalize(src.astype(np.float64))
    d, td = normalize(dst.astype(np.float64))
    n = len(s)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = s
    a[0::2, 2] = 1
    a[0::2, 6:8] = -s * d[:, 0:1]
    a[0::2, 8] = -d[:, 0]
    a[1::2, 3:5] = s
    a[1::2, 5] = 1
    a[1::2, 6:8] = -s * d[:, 1:2]
    a[1::2, 8] = -d[:, 1]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    h = np.linalg.inv(td) @ h @ ts
    return h / h[2, 2]


def apply_homography(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ h.T
    return ph[:, :2] / np.maximum(np.abs(ph[:, 2:]), 1e-12) * np.sign(
        ph[:, 2:])


def find_homography_ransac(src: np.ndarray, dst: np.ndarray,
                           thresh: float = 3.0, iters: int = 2000,
                           seed: int = 0) -> np.ndarray:
    """RANSAC + DLT refit on inliers (cv2.findHomography(RANSAC) analog).
    Uses the C++ core when built."""
    lib = native_lib()
    if lib is not None:
        h = lib.ransac_homography(src.astype(np.float64),
                                  dst.astype(np.float64), thresh, iters,
                                  seed)
        if h is not None:
            return h
    rng = np.random.default_rng(seed)
    n = len(src)
    best_inliers = None
    best_count = -1
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        try:
            h = homography_dlt(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        err = np.linalg.norm(apply_homography(h, src) - dst, axis=1)
        inliers = err < thresh
        c = int(inliers.sum())
        if c > best_count:
            best_count = c
            best_inliers = inliers
    if best_inliers is None or best_count < 4:
        return homography_dlt(src, dst)
    return homography_dlt(src[best_inliers], dst[best_inliers])


def warp_perspective(image: np.ndarray, h: np.ndarray,
                     out_size: Tuple[int, int] = (512, 424)) -> np.ndarray:
    """Bilinear inverse warp (cv2.warpPerspective analog); out_size is
    (width, height).  C++ core when built, vectorized numpy fallback."""
    lib = native_lib()
    if lib is not None and image.dtype == np.uint8 and image.ndim == 3:
        out = lib.warp_perspective(image, np.linalg.inv(h), out_size)
        if out is not None:
            return out
    w, hh = out_size
    yy, xx = np.meshgrid(np.arange(hh), np.arange(w), indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel()], 1).astype(np.float64)
    src = apply_homography(np.linalg.inv(h), pts)
    sx = src[:, 0].reshape(hh, w)
    sy = src[:, 1].reshape(hh, w)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    ih, iw = image.shape[:2]
    img = image.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
        v = img[np.clip(yi, 0, ih - 1), np.clip(xi, 0, iw - 1)]
        return v * inside[..., None]

    # tap-wise BORDER_CONSTANT(0), matching cv2.warpPerspective defaults
    out = (tap(x0, y0) * (1 - fx) * (1 - fy)
           + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy
           + tap(x0 + 1, y0 + 1) * fx * fy)
    if image.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(image.dtype, np.integer):
        out = np.rint(out)
    return out.astype(image.dtype)


def fit_video_set_homography(skeleton_paths: List[str], seed: int = 0,
                             sample_prob: float = 1.0) -> np.ndarray:
    """Collect body-0 rgb<->depth joint correspondences over a (setup,
    camera) set and fit the homography (process_video_set,
    preprocess_nturgbd.py:26-56)."""
    rng = np.random.default_rng(seed)
    rgb, dep = [], []
    for p in skeleton_paths:
        if rng.random() > sample_prob:
            continue
        for frame in parse_skeleton_file(p):
            if frame["joints"]:
                b = frame["joints"][0]
                rgb.extend(b["rgb_loc"])
                dep.extend(b["d_loc"])
    rgb = np.asarray(rgb, np.float64)
    dep = np.asarray(dep, np.float64)
    return find_homography_ransac(rgb, dep, seed=seed)
