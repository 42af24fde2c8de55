"""Host-side image/joint transforms for the NTU/MPII/COCO pipelines
(counterpart of hcmoco_tpu/data/transforms.py, numpy/PIL as there).

Behavioral spec: `pycontrast/datasets/dataset.py` + `mpii_utils.py`:
  * torchvision RandomResizedCrop.get_params sampling (scale/ratio tries,
    center-crop fallback) — used with the human-bbox re-centering tricks
    (dataset.py:109-134, :215-228)
  * PIL out-of-bounds crop zero-padding semantics (TF.resized_crop)
  * center/scale/rotation affine for MPII (mpii_utils.py:29-65)
  * base-3 positional-encoded joint heatmaps (dataset.py:258-291)
  * ImageNet RGB normalization, depth/1000 (+ later mean-subtraction)
  * joint normalization / flip / pairwise-scale helpers
    (dataset.py:482-502, :1036-1043, :461-472)
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

MPII_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
COCO_REDUCE_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (7, 12), (8, 11), (9, 10))

# Kinect-25 -> MPII-16 joint remap (dataset.py:1022-1024)
KINECT2MPII = (14, 13, 12, 16, 17, 18, 0, 1, 2, 3, 6, 5, 4, 8, 9, 10)


def random_resized_crop_params(
    rng: np.random.Generator, height: int, width: int,
    scale: Tuple[float, float], ratio: Tuple[float, float],
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: 10 area/aspect attempts,
    then a clamped center-crop fallback. Returns (i, j, h, w)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # fallback: clamp aspect, center crop
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


def resized_crop(img: Image.Image, i: int, j: int, h: int, w: int,
                 size: Tuple[int, int], nearest: bool = False) -> Image.Image:
    """PIL crop (zero-padded outside bounds) + resize — TF.resized_crop."""
    box = (j, i, j + w, i + h)  # PIL box is (left, upper, right, lower)
    cropped = img.crop(box)
    return cropped.resize(size, Image.NEAREST if nearest else Image.BILINEAR)


def crop_pad(arr: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    """Numpy equivalent of PIL's out-of-bounds crop: (h, w[, C]) window at
    row i / col j, zero-padded where the box leaves the frame.  Lets mmap-
    backed datasets read only the crop bytes instead of the whole frame."""
    out_shape = (h, w) + arr.shape[2:]
    out = np.zeros(out_shape, arr.dtype)
    si0, si1 = max(i, 0), min(i + h, arr.shape[0])
    sj0, sj1 = max(j, 0), min(j + w, arr.shape[1])
    if si0 < si1 and sj0 < sj1:
        out[si0 - i:si1 - i, sj0 - j:sj1 - j] = arr[si0:si1, sj0:sj1]
    return out


def normalize_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv=False) -> np.ndarray:
    """MPII center/scale/rot -> 2x3 affine (mpii_utils.py:29-60)."""
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], np.float32)
    shift = np.asarray(shift, np.float32)
    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size

    rot_rad = math.pi * rot / 180.0
    sn, cs = math.sin(rot_rad), math.cos(rot_rad)
    # get_dir([0, -0.5*src_w], rot) = (0.5w*sn, -0.5w*cs)
    src_dir = np.array([0.5 * src_w * sn, -0.5 * src_w * cs], np.float32)
    dst_dir = np.array([0.0, -0.5 * dst_w], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src
    # solve the 2x3 affine from 3 point pairs (cv2.getAffineTransform)
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for k in range(3):
        a[k, :3] = [src[k, 0], src[k, 1], 1]
        a[k + 3, 3:] = [src[k, 0], src[k, 1], 1]
        b[k] = dst[k, 0]
        b[k + 3] = dst[k, 1]
    sol = np.linalg.solve(a, b)
    return sol.reshape(2, 3).astype(np.float32)


def affine_transform_point(pt, t) -> np.ndarray:
    v = np.array([pt[0], pt[1], 1.0], np.float32)
    return (t @ v)[:2]


def warp_affine(img: np.ndarray, trans: np.ndarray,
                size: Tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine INTER_LINEAR."""
    import cv2

    return cv2.warpAffine(img, trans, size, flags=cv2.INTER_LINEAR)


def positional_encoding(num_joints: int) -> np.ndarray:
    """Base-3 color code per joint, scaled 0.5 (dataset.py:261-268)."""
    enc = np.zeros((num_joints, 3), np.float32)
    for i in range(1, num_joints + 1):
        enc[i - 1] = [(i % 3), (i // 3) % 3, (i // 9) % 3]
    return enc * 0.5


def joint_heatmap_rgb(joints2d: np.ndarray, image_h: int, image_w: int,
                      pos_enc: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """(J, 2) (x, y) joints -> (H, W, 3) max-composited color-coded gaussian
    heatmap (generate_joint2d_heatmap, dataset.py:270-283), vectorized."""
    j = joints2d.shape[0]
    x = np.arange(image_w, dtype=np.float32)
    y = np.arange(image_h, dtype=np.float32)
    dx = x[None, None, :] - joints2d[:, 0][:, None, None]
    dy = y[None, :, None] - joints2d[:, 1][:, None, None]
    hm = np.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))  # (J, H, W)
    colored = pos_enc[:, :, None, None] * hm[:, None]  # (J, 3, H, W)
    return np.amax(colored, axis=0).transpose(1, 2, 0)


def transform_heatmap(hm: np.ndarray, i, j, h, w, size, flip: bool,
                      crop: bool) -> np.ndarray:
    """Crop/flip the rendered heatmap through a uint16 quantization round
    trip (transform_heatmap, dataset.py:277-291) for bit-parity."""
    scale = 10000
    q = (hm * scale).astype(np.uint16)
    out = []
    for c in range(3):
        im = Image.fromarray(q[:, :, c])
        if crop:
            im = resized_crop(im, i, j, h, w, size, nearest=True)
        if flip:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        out.append(np.array(im))
    return np.stack(out, axis=-1).astype(np.float32) / scale


def normalize_joints(joints2d: np.ndarray, root_index: int = 6) -> np.ndarray:
    """Root-center, (x,y)->(y,x) swap, max-abs scale
    (normalize_joints_myway, dataset.py:483-489)."""
    j = joints2d.astype(np.float32).copy()
    j -= j[root_index]
    j = j[:, ::-1]
    s = max(j.max(), abs(j.min()))
    if s > 0:
        j = j / s
    return j


def flip_normalized_joints(j: np.ndarray, pairs=MPII_FLIP_PAIRS) -> np.ndarray:
    out = j.copy()
    out[:, 1] = -out[:, 1]
    tmp = out.copy()
    for a, b in pairs:
        out[a] = tmp[b]
        out[b] = tmp[a]
    return out


def joint_pairwise_scale(joints2d: np.ndarray,
                         joints_vis: np.ndarray) -> float:
    """Max visible pairwise distance, fallback 80
    (generate_scale_mpii, dataset.py:461-472)."""
    d = joints2d[:, None] - joints2d[None]
    d = np.sqrt((d ** 2).sum(-1))
    vis = joints_vis.astype(bool)
    d[~vis, :] = -1
    d[:, ~vis] = -1
    m = d.max()
    return 80.0 if m <= 0 else float(m)
