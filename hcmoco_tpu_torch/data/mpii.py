"""MPII keypoint annotation loader + train-crop pipeline (counterpart of
hcmoco_tpu/data/mpii.py).

Behavioral spec: `pycontrast/datasets/dataset.py:330-433,502-562` — json
annotations (center/scale, 1-based Matlab indices), center nudge
c[1] += 15*s, scale *1.25, random scale/rotation jitter, cv2 affine crop,
ImageNet norm, fake zero depth."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .transforms import (
    get_affine_transform, affine_transform_point, warp_affine,
    normalize_rgb, normalize_joints, flip_normalized_joints,
    positional_encoding, joint_heatmap_rgb,
)

MPII_NUM_JOINTS = 16


def load_mpii_db(root: str, image_set: str) -> List[dict]:
    """Parse annot/<set>.json into center/scale/joints records
    (dataset.py:330-381)."""
    path = os.path.join(root, "annot", image_set + ".json")
    with open(path) as f:
        anno = json.load(f)
    db = []
    for a in anno:
        c = np.array(a["center"], np.float64)
        s = np.array([a["scale"], a["scale"]], np.float64)
        if c[0] != -1:
            c[1] = c[1] + 15 * s[1]
            s = s * 1.25
        c = c - 1
        joints = np.zeros((MPII_NUM_JOINTS, 3), np.float64)
        vis = np.zeros((MPII_NUM_JOINTS, 3), np.float64)
        if image_set != "test":
            jj = np.array(a["joints"], np.float64)
            jj[:, :2] -= 1
            jv = np.array(a["joints_vis"], np.float64)
            joints[:, :2] = jj[:, :2]
            vis[:, 0] = jv
            vis[:, 1] = jv
        db.append({
            "image": os.path.join(root, "images", a["image"]),
            "center": c,
            "scale": s,
            "joints_3d": joints,
            "joints_3d_vis": vis,
        })
    return db


def load_image_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def skip_mpii_draws(rng: np.random.Generator, random_resized_crop: bool,
                    random_flip: bool) -> None:
    """Consume the draws of one mpii_gcn_item without decoding it (a
    data-parallel rank skipping another rank's row), in its order."""
    if random_resized_crop:
        rng.standard_normal()
        if rng.random() < 0.6:
            rng.standard_normal()
    if random_flip:
        rng.random()


def mpii_gcn_item(rec: dict, size: int, rng: np.random.Generator,
                  random_resized_crop: bool, random_flip: bool
                  ) -> Dict[str, np.ndarray]:
    """One MPII training sample for the GCN pipeline
    (mpii_getitem, dataset.py:502-562): affine crop + rotation jitter,
    normalized joints, crop-space joints, visibility, fake depth."""
    data = load_image_rgb(rec["image"])
    joints = rec["joints_3d"].copy()
    joints_vis = rec["joints_3d_vis"].copy()
    c = rec["center"].copy()
    s = rec["scale"].copy()
    r = 0.0
    out_size = (size, size)

    if random_resized_crop:
        sf, rf = 0.25, 30.0
        s = s * np.clip(rng.standard_normal() * sf + 1, 1 - sf, 1 + sf)
        r = float(np.clip(rng.standard_normal() * rf, -rf * 2, rf * 2)) \
            if rng.random() < 0.6 else 0.0
    trans = get_affine_transform(c, s, r, out_size)
    img = warp_affine(data, trans, out_size)

    original_joints = joints[:, :2].copy()
    if random_resized_crop:
        for i in range(MPII_NUM_JOINTS):
            if joints_vis[i, 0] > 0:
                original_joints[i] = affine_transform_point(joints[i, :2],
                                                            trans)
    norm_joints = normalize_joints(joints[:, :2])
    original_joints = original_joints[:, ::-1]  # (x,y) -> (row, col)

    flipped = random_flip and rng.random() <= 0.5
    if flipped:
        img = np.ascontiguousarray(img[:, ::-1, :])
        norm_joints = flip_normalized_joints(norm_joints)
        original_joints = original_joints.copy()
        original_joints[:, 1] = size - original_joints[:, 1]

    rgb = normalize_rgb(np.asarray(img))
    rgbd = np.concatenate([rgb, np.zeros_like(rgb)], -1)

    vis = np.logical_and(
        np.logical_and(
            np.logical_and(original_joints[:, 0] >= 0,
                           original_joints[:, 0] < size),
            np.logical_and(original_joints[:, 1] >= 0,
                           original_joints[:, 1] < size)),
        joints_vis[:, 0] > 0)

    return {
        "rgbd": rgbd.astype(np.float32),
        "skeleton": norm_joints.astype(np.float32),
        "joints2d": original_joints.astype(np.float32),
        "joints_vis": vis.astype(np.int32),
    }
