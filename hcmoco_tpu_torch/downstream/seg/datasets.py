"""Downstream human-parsing datasets (the port's copy of
hcmoco_tpu/downstream/seg/datasets.py: numpy, PIL and cv2;
tests/test_torch_downstream_seg.py holds the samples equal bit for bit).

Behavioral spec: `HRNet-Semantic-Segmentation/lib/datasets/` —
  * `NTURGBDD` (nturgbd_d.py): depth parsing — MDepth png /1000, replicate
    x3, valid-pixel mean subtraction (`process_depth_map` :143-155), 60->25
    label remap (:103-107), train-time flip with left-right LABEL-PAIR swap
    (:219-231), multi-scale scale jitter + random crop (gen_sample), val
    mode resizes image to crop size and labels to 1000x1000 nearest
    (:209-215); hardcoded class weights (:87-88).
  * `NTURGBDRGB` (nturgbd_rgb.py): same for the warped RGB frames with
    ImageNet normalization.
  * `Human36M` (human36m.py): RGB parsing with the same 25-class mapping.

Samples return dicts: image (H, W, 3) float32 NHWC, label (H, W) int32.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
from PIL import Image

from ...data.transforms import normalize_rgb
from ..a2j.data import crop_human_pcd  # noqa: F401 (re-export convenience)

# nturgbd_d.py:90-101
LEFT_RIGHT_PAIRS = np.array(
    [[1, 6], [2, 7], [3, 8], [17, 25], [18, 26], [19, 27], [33, 38],
     [34, 39], [49, 56], [50, 58]])
ORIGINAL_LABELS = np.array(
    [0, 1, 2, 3, 6, 7, 8, 17, 18, 19, 25, 26, 27, 32, 33, 34, 38, 39, 43,
     44, 46, 49, 50, 56, 58])
CLASS_WEIGHTS_25 = (
    1.448, 49.234, 49.483, 48.030, 49.247, 49.492, 48.018, 49.704, 50.052,
    49.369, 49.694, 50.090, 49.425, 49.459, 45.846, 47.156, 45.868, 47.197,
    44.167, 42.789, 44.341, 48.632, 48.873, 48.644, 49.004)


def label_mapper() -> np.ndarray:
    m = np.arange(60)
    for i, l in enumerate(ORIGINAL_LABELS):
        m[l] = i
    return m


def mapped_pairs() -> np.ndarray:
    return label_mapper()[LEFT_RIGHT_PAIRS]


def swap_label_pairs(label: np.ndarray) -> np.ndarray:
    out = label.copy()
    for l, r in mapped_pairs():
        out[label == r] = l
        out[label == l] = r
    return out


def process_depth(image: np.ndarray) -> np.ndarray:
    """uint16 depth -> /1000, x3 channels, nonzero-mean subtraction
    (process_depth_map, nturgbd_d.py:143-155). Returns HWC."""
    d = image.astype(np.float32) / 1000.0
    x = np.stack([d, d, d], -1)
    nz = x != 0
    mean = x.sum() / nz.sum() if nz.sum() > 0 else 0.0
    x[nz] = x[nz] - mean
    return x


class ParsingDataset:
    """Shared train/val logic for the depth & RGB parsing sets."""

    def __init__(self, root: str, list_path: str, modality: str = "depth",
                 crop_size: Tuple[int, int] = (473, 473),
                 base_size: int = 473, num_classes: int = 25,
                 multi_scale: bool = True, flip: bool = True,
                 scale_factor: int = 11, ignore_label: int = 255,
                 is_train: bool = True, seed: int = 0,
                 num_samples: int = 0):
        assert modality in ("depth", "rgb")
        self.root = root
        self.modality = modality
        self.crop_size = crop_size
        self.base_size = base_size
        self.num_classes = num_classes
        self.multi_scale = multi_scale
        self.flip = flip
        self.scale_factor = scale_factor
        self.ignore_label = ignore_label
        self.is_train = is_train
        self.mapper = label_mapper()
        self._rng = np.random.default_rng(seed)
        self.class_weights = np.asarray(CLASS_WEIGHTS_25[:num_classes],
                                        np.float32)

        with open(list_path) as f:
            lines = [l.strip() for l in f if l.strip()]
        self.files = [self._paths(os.path.join(root, l)) for l in lines]
        if num_samples:
            self.files = self.files[:num_samples]

    def _paths(self, image_path: str) -> Dict[str, str]:
        """rgb/<name>.jpg <-> depth/MDepth-<name>.png <->
        png_annotation_v2/<name>.png (nturgbd_d.py:119-137)."""
        parts = image_path.split("/")
        name = parts[-1]
        lab = parts.copy()
        lab[-2] = "png_annotation_v2"
        lab[-1] = lab[-1][:-3] + "png"
        dep = parts.copy()
        dep[-2] = "depth"
        dep[-1] = "MDepth-" + dep[-1][:-3] + "png"
        return {"rgb": image_path, "depth": "/".join(dep),
                "label": "/".join(lab), "name": name}

    def __len__(self):
        return len(self.files)

    def _load(self, item):
        if self.modality == "depth":
            img = np.array(Image.open(item["depth"])).astype(np.uint16)
        else:
            img = np.array(Image.open(item["rgb"]).convert("RGB"))
        label = self.mapper[np.array(Image.open(item["label"]))
                            .astype(np.uint8)]
        return img, label

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        if self.modality == "depth":
            return process_depth(img)
        return normalize_rgb(img)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        import cv2

        item = self.files[index]
        img, label = self._load(item)
        orig_size = np.array(label.shape, np.int32)

        if not self.is_train:
            img = cv2.resize(img, self.crop_size,
                             interpolation=cv2.INTER_NEAREST)
            label = cv2.resize(label, (1000, 1000),
                               interpolation=cv2.INTER_NEAREST)
            return {"image": self._normalize(img).astype(np.float32),
                    "label": label.astype(np.int32),
                    "size": orig_size, "index": np.int32(index)}

        rng = self._rng
        if self.flip and rng.integers(0, 2) == 1:
            img = img[:, ::-1]
            label = swap_label_pairs(label[:, ::-1])

        img = cv2.resize(img, self.crop_size,
                         interpolation=cv2.INTER_NEAREST)
        label = cv2.resize(label, self.crop_size,
                           interpolation=cv2.INTER_NEAREST)

        if self.multi_scale:
            # gen_sample scale jitter + rand crop (base_dataset.py:118-131)
            rand_scale = 0.5 + int(rng.integers(0, self.scale_factor + 1)) \
                / 10.0
            long_size = int(self.base_size * rand_scale + 0.5)
            h, w = label.shape
            if h > w:
                nh, nw = long_size, int(w * long_size / h + 0.5)
            else:
                nw, nh = long_size, int(h * long_size / w + 0.5)
            img = cv2.resize(img, (nw, nh),
                             interpolation=cv2.INTER_NEAREST)
            label = cv2.resize(label, (nw, nh),
                               interpolation=cv2.INTER_NEAREST)
            img, label = self._rand_crop(img, label, rng)

        return {"image": self._normalize(img).astype(np.float32),
                "label": label.astype(np.int32),
                "size": orig_size, "index": np.int32(index)}

    def _rand_crop(self, img, label, rng):
        h, w = label.shape
        ch, cw = self.crop_size
        pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
        if pad_h or pad_w:
            img = np.pad(img, ((0, pad_h), (0, pad_w)) + ((0, 0),) *
                         (img.ndim - 2), mode="constant")
            label = np.pad(label, ((0, pad_h), (0, pad_w)),
                           constant_values=self.ignore_label)
        h, w = label.shape
        y = int(rng.integers(0, h - ch + 1))
        x = int(rng.integers(0, w - cw + 1))
        return img[y:y + ch, x:x + cw], label[y:y + ch, x:x + cw]


class Human36MParsing(ParsingDataset):
    """Human3.6M RGB parsing (human36m.py): rgb modality + same mapping;
    list entries point straight at the rgb frames."""

    def __init__(self, root: str, list_path: str, **kw):
        kw.setdefault("modality", "rgb")
        super().__init__(root, list_path, **kw)
