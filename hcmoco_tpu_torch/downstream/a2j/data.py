"""ITOP depth dataset + preprocessing + PCK@10cm evaluation (the port's
copy of hcmoco_tpu/downstream/a2j/data.py: numpy, cv2 and scipy.io, no
torch; tests/test_torch_a2j.py holds the two equal).

Behavioral spec: `A2J/main.py` — per-frame .mat files with `DepthNormal`
(depth) + keypoints (:130-188 dataPreprocess), human crop from per-frame
bounding boxes, depth filtered past max-keypoint-z + 5cm and mean-
normalized on nonzero pixels (crop_human_pcd :190-198), rotation/scale
augmentation via cv2 rotation matrix, labels (row, col, normalized depth *
depthFactor=50); ITOP camera intrinsics pixel<->world (:86-93);
`evaluation10CMRule` (:423-449) maps predictions back through the test
bbox to world coordinates and scores the <10cm fraction.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

KEYPOINTS = 15
CROP_H, CROP_W = 288, 288
DEPTH_FACTOR = 50.0
RAND_CROP_SHIFT = 5
RAND_ROTATE = 180
RAND_SCALE = (1.0, 0.5)
RANDSHIFT_DEPTH = 1.0


def pixel2world(x, y, z):
    return (x - 160.0) * z * 0.0035, (120.0 - y) * z * 0.0035


def world2pixel(x, y, z):
    return 160.0 + x / (0.0035 * z), 120.0 - y / (0.0035 * z)


def crop_human_pcd(depth: np.ndarray, label_z: np.ndarray):
    """Zero out background past max keypoint depth + 5cm; mean of nonzero
    (A2J/main.py:190-198)."""
    max_z = label_z.max()
    f = depth.copy()
    f[depth > max_z + 0.05] = 0
    nz = (f != 0).sum()
    mean = f.sum() / nz if nz > 0 else 0.0
    return f, mean


def preprocess_frame(img: np.ndarray, keypoints_pixel: np.ndarray,
                     keypoints_world: np.ndarray, lefttop, rightbottom,
                     rng: Optional[np.random.Generator] = None
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
    """dataPreprocess (A2J/main.py:130-188). Returns
    (depth crop (H, W), label (P, 3) = (row, col, depth*factor), mean)."""
    import cv2

    augment = rng is not None
    if augment:
        off = [int(rng.integers(-RAND_CROP_SHIFT, RAND_CROP_SHIFT))
               for _ in range(4)]
        rot = int(rng.integers(-RAND_ROTATE, RAND_ROTATE))
        scale = rng.random() * RAND_SCALE[0] + RAND_SCALE[1]
    else:
        off = [0, 0, 0, 0]
        rot, scale = 0, 1.0
    matrix = cv2.getRotationMatrix2D((CROP_W / 2, CROP_H / 2), rot, scale)

    x0 = max(lefttop[0] + off[0], 0)
    y0 = max(lefttop[1] + off[1], 0)
    x1 = min(rightbottom[0] + off[2], img.shape[1] - 1)
    y1 = min(rightbottom[1] + off[3], img.shape[0] - 1)

    crop = img[int(y0):int(y1), int(x0):int(x1)].copy()
    crop = cv2.resize(crop, (CROP_W, CROP_H),
                      interpolation=cv2.INTER_NEAREST).astype(np.float32)
    crop, mean = crop_human_pcd(crop, keypoints_world[:, 2])
    crop[crop != 0] = crop[crop != 0] - mean

    label_xy = np.ones((KEYPOINTS, 2), np.float32)
    label_xy[:, 0] = (keypoints_pixel[:, 0] - x0) * CROP_W / (x1 - x0)
    label_xy[:, 1] = (keypoints_pixel[:, 1] - y0) * CROP_H / (y1 - y0)

    if augment:
        crop = cv2.warpAffine(crop, matrix, (CROP_W, CROP_H))
        hom = np.ones((KEYPOINTS, 3), np.float32)
        hom[:, :2] = label_xy
        label_xy = (matrix @ hom.T).T.astype(np.float32)

    label = np.ones((KEYPOINTS, 3), np.float32)
    label[:, 0] = label_xy[:, 1]  # row
    label[:, 1] = label_xy[:, 0]  # col
    label[:, 2] = (keypoints_world[:, 2] - mean) * DEPTH_FACTOR
    return crop, label, float(mean)


class ITOPDataset:
    """Per-frame .mat dir (A2J/data/data_preprocess.py output) + bbox
    tables. Each .mat holds 'DepthNormal' (H, W, 4+) with depth in channel
    3, 'keypointsPixel' (15, 2), 'keypointsWorld' (15, 3)."""

    def __init__(self, image_dir: str, bndbox: np.ndarray,
                 augment: bool = False, seed: int = 0):
        import scipy.io as scio

        self._scio = scio
        self.files = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if f.endswith(".mat"))
        self.bndbox = bndbox
        self.augment = augment
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def skip_draws(self, index) -> None:
        """Consume a sample's augmentation draws without loading it (a
        data-parallel rank skipping another rank's row), in
        preprocess_frame's order."""
        if self.augment:
            rng = self._rng
            for _ in range(4):
                rng.integers(-RAND_CROP_SHIFT, RAND_CROP_SHIFT)
            rng.integers(-RAND_ROTATE, RAND_ROTATE)
            rng.random()

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        mat = self._scio.loadmat(self.files[index])
        depth = mat["DepthNormal"][..., 3].astype(np.float32) \
            if mat["DepthNormal"].ndim == 3 else \
            mat["DepthNormal"].astype(np.float32)
        kp_pixel = mat["keypointsPixel"].astype(np.float32)
        kp_world = mat["keypointsWorld"].astype(np.float32)
        bb = self.bndbox[index]
        crop, label, mean = preprocess_frame(
            depth, kp_pixel, kp_world, (bb[0], bb[1]), (bb[2], bb[3]),
            self._rng if self.augment else None)
        return {
            "depth": crop[..., None],
            "label": label,
            "keypoints_world": kp_world,
            "mean": np.float32(mean),
            "index": np.int32(index),
        }


def random_erasing(img: np.ndarray, rng: np.random.Generator,
                   probability: float = 0.5, sl: float = 0.02,
                   sh: float = 0.4, r1: float = 0.3,
                   mean: float = 0.0) -> np.ndarray:
    """Random-erasing augmentation (A2J/random_erasing.py, wired at
    main.py:210 with p=0.5, sl=0.02, sh=0.4, r1=0.3, mean=[0])."""
    if rng.random() > probability:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(100):
        target = rng.uniform(sl, sh) * area
        ratio = rng.uniform(r1, 1.0 / r1)
        eh = int(round(np.sqrt(target * ratio)))
        ew = int(round(np.sqrt(target / ratio)))
        if eh < h and ew < w:
            y = int(rng.integers(0, h - eh))
            x = int(rng.integers(0, w - ew))
            img = img.copy()
            img[y:y + eh, x:x + ew] = mean
            return img
    return img


def convert_itop_h5(depth_h5: str, labels_h5: str, out_dir: str,
                    limit: int = 0) -> int:
    """ITOP h5 -> per-frame .mat files (A2J/data/data_preprocess.py:16-52):
    each valid frame saved as {'DepthNormal' (240,320,4) with depth in
    channel 3, 'keypointsPixel', 'keypointsWorld'}."""
    import h5py
    import scipy.io as scio

    os.makedirs(out_dir, exist_ok=True)
    depth_maps = h5py.File(depth_h5, "r")
    labels = h5py.File(labels_h5, "r")
    count = 0
    n = depth_maps["data"].shape[0]
    for i in range(n):
        if not labels["is_valid"][i]:
            continue
        dn = np.zeros((240, 320, 4), np.float32)
        dn[:, :, 3] = depth_maps["data"][i].astype(np.float32)
        count += 1
        scio.savemat(os.path.join(out_dir, f"{count}.mat"), {
            "DepthNormal": dn,
            "keypointsPixel": labels["image_coordinates"][i],
            "keypointsWorld": labels["real_world_coordinates"][i],
        })
        if limit and count >= limit:
            break
    return count


def evaluation_10cm(pred: np.ndarray, target_world: np.ndarray,
                    bndbox: np.ndarray, means: np.ndarray,
                    per_joint: bool = False):
    """PCK@10cm in world coords (evaluation10CMRule, A2J/main.py:423-449).

    pred: (N, P, 3) = (row, col, depth*factor - before de-normalization);
    de-normalize depth with the per-frame mean, map pixels back through the
    test bbox, lift to world, threshold at 0.1 m."""
    p = np.zeros_like(pred)
    p[:, :, 0] = pred[:, :, 1]  # x (col)
    p[:, :, 1] = pred[:, :, 0]  # y (row)
    p[:, :, 2] = pred[:, :, 2] / DEPTH_FACTOR + means[:, None]

    x = p[:, :, 0] * (bndbox[:, 2] - bndbox[:, 0])[:, None] / CROP_W \
        + bndbox[:, 0][:, None]
    y = p[:, :, 1] * (bndbox[:, 3] - bndbox[:, 1])[:, None] / CROP_H \
        + bndbox[:, 1][:, None]
    wx, wy = pixel2world(x, y, p[:, :, 2])
    world = np.stack([wx, wy, p[:, :, 2]], axis=-1)

    err2 = ((world - target_world) ** 2).sum(-1)
    hit = err2 < 0.1 ** 2
    if per_joint:
        return hit.mean(), hit.mean(axis=0)
    return hit.mean()


def make_itop_fixture(out_dir: str, n_train: int = 32, n_test: int = 16,
                      seed: int = 0):
    """Tiny ITOP-format fixture: per-frame .mat files (DepthNormal +
    keypointsPixel/World, the exact layout A2J/data/data_preprocess.py
    emits) plus bndbox pickles.  Frames hold a synthetic 'body' (foreground
    depth blob) with 15 keypoints in a fixed skeleton template, jittered a
    few pixels / ~2 cm per frame — learnable by a small A2J head in tens of
    steps, so tests can assert PCK@10cm actually improves.

    Returns (train_dir, test_dir, bndbox_train_pkl, bndbox_test_pkl)."""
    import pickle

    import scipy.io as scio

    h, w = 240, 320
    base_z = 2.5
    # 15-joint template around the image center (col, row) offsets
    template = np.array([
        (0, -60), (0, -40), (-25, -40), (25, -40), (-35, -10), (35, -10),
        (-38, 20), (38, 20), (0, -10), (0, 20), (-12, 45), (12, 45),
        (-14, 80), (14, 80), (0, 35),
    ], np.float32) + np.array([160.0, 120.0], np.float32)

    rng = np.random.default_rng(seed)
    out = []
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        boxes = np.zeros((n, 4), np.float32)
        for i in range(n):
            jitter = rng.uniform(-3, 3, template.shape).astype(np.float32)
            kp_pixel = template + jitter
            z = (base_z + rng.uniform(-0.02, 0.02, KEYPOINTS)).astype(
                np.float32)
            wx = (kp_pixel[:, 0] - 160.0) * z * 0.0035
            wy = (120.0 - kp_pixel[:, 1]) * z * 0.0035
            kp_world = np.stack([wx, wy, z], -1).astype(np.float32)

            depth = np.full((h, w), 4.0, np.float32)  # far background
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            for (u, v), zz in zip(kp_pixel, z):
                body = (xx - u) ** 2 + (yy - v) ** 2 < 18.0 ** 2
                depth[body] = zz
            dn = np.zeros((h, w, 4), np.float32)
            dn[..., 3] = depth
            scio.savemat(os.path.join(d, f"{i:05d}.mat"),
                         {"DepthNormal": dn, "keypointsPixel": kp_pixel,
                          "keypointsWorld": kp_world})
            boxes[i] = (kp_pixel[:, 0].min() - 25, kp_pixel[:, 1].min() - 25,
                        kp_pixel[:, 0].max() + 25, kp_pixel[:, 1].max() + 25)
        pkl = os.path.join(out_dir, f"bndbox_{split}.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(boxes, f)
        out.extend([d, pkl])
    return out[0], out[2], out[1], out[3]
