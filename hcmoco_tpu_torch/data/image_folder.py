"""ImageFolder-style classification dataset for the linear probe
(counterpart of hcmoco_tpu/data/image_folder.py, numpy/PIL as there).

Reference: torchvision ImageFolder as used by `main_linear.py` /
`ImageFolderInstance` (datasets/dataset.py:9-45): a class a subdirectory,
the standard train augmentation (RandomResizedCrop + flip) or the
resize + centre crop of evaluation.  `skip_draws` consumes a sample's
train draws without decoding it (a data-parallel rank's rows of the other
ranks, data/pipeline.py::DataSource)."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from .transforms import (normalize_rgb, random_resized_crop_params,
                         resized_crop)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """(path, class index) of every image under root/<class>/..., sorted,
    and the sorted class names."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for dirpath, _, files in sorted(os.walk(cdir)):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTS):
                    samples.append((os.path.join(dirpath, f), ci))
    return samples, classes


def image_hw(path: str) -> Tuple[int, int]:
    """(height, width) of an image file, from its header alone."""
    with Image.open(path) as img:
        return img.size[1], img.size[0]


class ImageFolderDataset:
    def __init__(self, root: str, size: int = 224, train: bool = True,
                 seed: int = 0):
        self.samples, self.classes = scan_image_folder(root)
        self.size = size
        self.train = train
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def _train_draws(self, hw: Tuple[int, int]) -> Tuple[tuple, bool]:
        crop = random_resized_crop_params(self._rng, hw[0], hw[1],
                                          (0.2, 1.0), (3.0 / 4, 4.0 / 3))
        return crop, bool(self._rng.random() < 0.5)

    def skip_draws(self, index) -> None:
        if self.train:
            self._train_draws(image_hw(self.samples[index][0]))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        path, target = self.samples[index]
        img = Image.open(path).convert("RGB")
        if self.train:
            (i, j, h, w), flip = self._train_draws((img.size[1],
                                                    img.size[0]))
            img = resized_crop(img, i, j, h, w, (self.size, self.size))
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            # the short side to size * 256 / 224, then a centre crop
            ow, oh = img.size
            scale = (self.size * 256 // 224) / min(ow, oh)
            img = img.resize((int(ow * scale), int(oh * scale)),
                             Image.BILINEAR)
            ow, oh = img.size
            left = (ow - self.size) // 2
            top = (oh - self.size) // 2
            img = img.crop((left, top, left + self.size, top + self.size))
        return {"rgbd": normalize_rgb(np.array(img)),
                "label": np.int32(target),
                "index": np.int32(index)}
