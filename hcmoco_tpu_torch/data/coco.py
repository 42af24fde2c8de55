"""COCO person-keypoint annotation loader (counterpart of
hcmoco_tpu/data/coco.py; no pycocotools dependency — plain json parsing
of person_keypoints_*.json).

Behavioral spec: `pycontrast/datasets/dataset.py:622-791` — person category
filter, bbox sanitize, keypoint presence filter, bbox -> center/scale with
aspect-ratio snap + 1.25 inflate, 2014/2017 file naming; and the COCO->13
"reduce" joint mapping (:889-894)."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

COCO_NUM_JOINTS = 17
# COCO17 -> reduce-13 (dataset.py:893)
COCO_REDUCE_SELECT = (16, 14, 12, 11, 13, 15, 0, 10, 8, 6, 5, 7, 9)
# Kinect25 -> reduce-13 (dataset.py:897)
KINECT_REDUCE_SELECT = (14, 13, 12, 16, 17, 18, 3, 6, 5, 4, 8, 9, 10)


def _box2cs(box, aspect_ratio=1.0, pixel_std=200.0):
    x, y, w, h = box[:4]
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], np.float32)
    if center[0] != -1:
        scale = scale * 1.25
    return center, scale


def load_coco_keypoint_db(coco_root: str, image_set: str) -> List[dict]:
    ann_path = os.path.join(coco_root, "annotations",
                            f"person_keypoints_{image_set}.json")
    with open(ann_path) as f:
        data = json.load(f)

    images = {im["id"]: im for im in data["images"]}
    person_cat = next(c["id"] for c in data["categories"]
                      if c["name"] == "person")

    def image_path(img_id: int) -> str:
        name = "%012d.jpg" % img_id
        if "2014" in image_set:
            name = f"COCO_{image_set}_" + name
        return os.path.join(coco_root, "images", image_set, name)

    db = []
    for ann in data["annotations"]:
        if ann.get("iscrowd", 0) or ann["category_id"] != person_cat:
            continue
        im = images[ann["image_id"]]
        width, height = im["width"], im["height"]
        x, y, w, h = ann["bbox"]
        x1, y1 = max(0, x), max(0, y)
        x2 = min(width - 1, x1 + max(0, w - 1))
        y2 = min(height - 1, y1 + max(0, h - 1))
        if ann["area"] <= 0 or x2 < x1 or y2 < y1:
            continue
        kp = ann["keypoints"]
        if max(kp) == 0:
            continue
        joints = np.zeros((COCO_NUM_JOINTS, 3), np.float64)
        vis = np.zeros((COCO_NUM_JOINTS, 3), np.float64)
        for i in range(COCO_NUM_JOINTS):
            joints[i, 0] = kp[i * 3]
            joints[i, 1] = kp[i * 3 + 1]
            vis[i, 0] = vis[i, 1] = min(kp[i * 3 + 2], 1)
        center, scale = _box2cs([x1, y1, x2 - x1, y2 - y1])
        db.append({
            "image": image_path(ann["image_id"]),
            "center": center.astype(np.float64),
            "scale": scale.astype(np.float64),
            "joints_3d": joints,
            "joints_3d_vis": vis,
        })
    return db


def coco_reduce(norm_joints, original_joints2d, joints_vis):
    s = list(COCO_REDUCE_SELECT)
    return (norm_joints[s].reshape(13, 2),
            original_joints2d[s].reshape(13, 2), joints_vis[s])


def kinect_reduce(joints):
    return joints[list(KINECT_REDUCE_SELECT)].reshape(13, 2)
