"""Synthetic on-disk dataset fixtures matching the NTU/MPII/Parsing-4K
layouts (counterpart of hcmoco_tpu/data/fixtures.py), so the file-level
datasets can be tested and driven without real data.  The NTU, MPII and
Parsing-4K writers also take the frame size (h, w); at their defaults
every file is the JAX package's, byte for byte."""

from __future__ import annotations

import json
import os
import pickle
from typing import Tuple

import numpy as np
from PIL import Image


def _save_rgb(path, rng, h=96, w=128):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


def _save_depth(path, rng, h=96, w=128):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d = np.zeros((h, w), np.uint16)
    d[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = rng.integers(
        1500, 4000, (h // 2, w // 2), dtype=np.uint16)
    Image.fromarray(d).save(path)


def _save_skeleton(path, rng, h=96, w=128, n_joints=25):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d_loc = np.stack([
        rng.uniform(w // 4, 3 * w // 4, n_joints),   # x (col)
        rng.uniform(h // 4, 3 * h // 4, n_joints),   # y (row)
    ], axis=1).astype(np.float32)
    joints = {"3d_loc": [rng.standard_normal(3).astype(np.float32)
                         for _ in range(n_joints)],
              "d_loc": [d_loc[i] for i in range(n_joints)],
              "c_loc": [d_loc[i] * 2 for i in range(n_joints)]}
    with open(path, "wb") as f:
        pickle.dump({"joints": [joints]}, f)


def make_ntu_fixture(root: str, n_frames: int = 4, seed: int = 0,
                     h: int = 96, w: int = 128) -> Tuple[str, str]:
    """Create an NTU-layout tree of (h, w) frames + file list. Returns
    (root, list_path)."""
    # file-list entries carry the bare nturgb+d_rgb_warped_correction
    # prefix; the depth/skeleton path transforms replace it with
    # HumanRGBD/NTURGBD/... (dataset.py:85-93)
    rng = np.random.default_rng(seed)
    rel_rgb = []
    for k in range(n_frames):
        tag = f"S001C001P001R001A{k + 1:03d}"
        fr = k + 1
        rgb = f"nturgb+d_rgb_warped_correction/{tag}/WRGB-{fr:08d}.jpg"
        depth = (f"HumanRGBD/NTURGBD/nturgb+d_depth_masked/{tag}/"
                 f"MDepth-{fr:08d}.png")
        skel = (f"HumanRGBD/NTURGBD/nturgb+d_parsed_skeleton/{tag}/"
                f"Skeleton-{fr - 1:08d}.pkl")
        _save_rgb(os.path.join(root, rgb), rng, h, w)
        _save_depth(os.path.join(root, depth), rng, h, w)
        _save_skeleton(os.path.join(root, skel), rng, h, w)
        rel_rgb.append(rgb)
    list_path = os.path.join(root, "train_list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(rel_rgb) + "\n")
    return root, list_path


def make_mpii_fixture(root: str, n_images: int = 3, seed: int = 1,
                      h: int = 128, w: int = 160) -> str:
    """MPII-layout tree of (h, w) images; the person box and joints scale
    with the image (at the defaults, the JAX package's numbers)."""
    rng = np.random.default_rng(seed)
    anno = []
    for k in range(n_images):
        name = f"{k:09d}.jpg"
        _save_rgb(os.path.join(root, "images", name), rng, h=h, w=w)
        joints = np.stack([rng.uniform(20 * w / 160, 140 * w / 160, 16),
                           rng.uniform(20 * h / 128, 108 * h / 128, 16)], 1)
        anno.append({
            "image": name,
            "center": [w / 2, h / 2],
            "scale": 0.6 * h / 128,
            "joints": joints.tolist(),
            "joints_vis": [1] * 16,
        })
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    with open(os.path.join(root, "annot", "train.json"), "w") as f:
        json.dump(anno, f)
    return root


def make_coco_fixture(root: str, n_images: int = 3, seed: int = 2) -> str:
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for k in range(n_images):
        img_id = k + 1
        name = "%012d.jpg" % img_id
        _save_rgb(os.path.join(root, "images", "train2014",
                               f"COCO_train2014_{name}"), rng, 128, 160)
        images.append({"id": img_id, "width": 160, "height": 128})
        kp = []
        for _ in range(17):
            kp += [float(rng.uniform(30, 130)), float(rng.uniform(30, 98)),
                   2]
        annotations.append({
            "id": 1000 + k, "image_id": img_id, "category_id": 1,
            "iscrowd": 0, "area": 5000.0, "bbox": [30, 30, 100, 68],
            "keypoints": kp,
        })
    data = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}]}
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations",
                           "person_keypoints_train2014.json"), "w") as f:
        json.dump(data, f)
    return root


def make_seg_fixture(root: str, ntu_root: str, n_frames: int = 3,
                     seed: int = 3, h: int = 96,
                     w: int = 128) -> Tuple[str, str]:
    """Parsing-4K-layout fixture of (h, w) frames (at most 999: the
    dataset's tag pattern has three-digit action and frame numbers);
    skeletons are placed in the NTU tree."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n_frames):
        tag = f"S001C001P001R001A{k + 1:03d}F{k + 1:03d}"
        rel = f"rgb/{tag}.jpg"
        _save_rgb(os.path.join(root, rel), rng, h, w)
        _save_depth(os.path.join(root, "depth", f"MDepth-{tag}.png"), rng,
                    h, w)
        lab = rng.choice([0, 1, 2, 17, 58], size=(h, w)).astype(np.uint8)
        p = os.path.join(root, "png_annotation_v2", f"{tag}.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(lab).save(p)
        _save_skeleton(
            os.path.join(ntu_root, "nturgb+d_parsed_skeleton", tag[:-4],
                         f"Skeleton-{k + 1:08d}.pkl"), rng, h, w)
        lines.append(rel)
    list_path = os.path.join(root, "seg_list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return root, list_path


def make_image_folder_fixture(root: str, n_classes: int = 3,
                              n_per_class: int = 4, seed: int = 0,
                              size: Tuple[int, int] = (64, 96)) -> str:
    """An ImageFolder tree of JPEGs under root: train/<class>/*.jpg with
    n_per_class images a class and val/<class>/*.jpg with half as many (at
    least one), classes `class_000`, ...  Each image's height and width
    are drawn in [size[0], size[1]]; its pixels are a smooth pattern of
    random waves over the class's own mean colour, plus noise, so that
    crops differ and a linear probe has something to learn.  Every file
    is a function of (seed, split, class, image) alone.  Returns root."""
    class_rng = np.random.default_rng(seed)
    colours = class_rng.uniform(40, 215, (n_classes, 3))
    for split, n in (("train", n_per_class),
                     ("val", max(n_per_class // 2, 1))):
        for c in range(n_classes):
            for i in range(n):
                rng = np.random.default_rng(
                    [seed, split == "val", c, i])
                h, w = rng.integers(size[0], size[1] + 1, 2)
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                img = np.broadcast_to(colours[c], (h, w, 3)).copy()
                for _ in range(3):
                    fy, fx = rng.uniform(0.02, 0.2, 2)
                    amp = rng.uniform(10, 40, 3)
                    img += amp * np.sin(fy * yy + fx * xx
                                        + rng.uniform(0, 6.3))[..., None]
                img += rng.normal(0, 8, img.shape)
                path = os.path.join(root, split, f"class_{c:03d}",
                                    f"img_{i:05d}.jpg")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    path, quality=90)
    return root
