"""ImageFolder-based contrastive dataset, the InsDis/MoCo/CMC/PIRL
baselines' data (counterpart of hcmoco_tpu/data/contrast_folder.py).

Behavioral spec: `ImageFolderInstance` (datasets/dataset.py:9-45): the
transformed image (a second crop stacked on channels for the moco
methods), the jigsaw patch stack for PIRL, and the index.  `skip_draws`
makes a sample's draws (both crops', the patches') from the image's size
alone, with no decode: a data-parallel rank's rows of the other ranks
(data/pipeline.py::DataSource), so the ranks' batches are the rows of the
one-process batch."""

from __future__ import annotations

from typing import Dict

import numpy as np
from PIL import Image

from .augment import build_jigsaw_transform, build_transform
from .image_folder import image_hw, scan_image_folder


class ContrastImageFolder:
    def __init__(self, root: str, aug: str = "A", modal: str = "RGB",
                 two_crop: bool = False, jigsaw: bool = False,
                 size: int = 224, use_memory_bank: bool = True,
                 seed: int = 0):
        self.samples, self.classes = scan_image_folder(root)
        self.transform = build_transform(aug, modal, use_memory_bank, size,
                                         seed)
        self.jigsaw_transform = (build_jigsaw_transform(modal, seed + 1)
                                 if jigsaw else None)
        self.two_crop = two_crop

    def __len__(self):
        return len(self.samples)

    def skip_draws(self, index) -> None:
        hw = image_hw(self.samples[index][0])
        for _ in range(2 if self.two_crop else 1):
            self.transform(None, hw)
        if self.jigsaw_transform is not None:
            self.jigsaw_transform(None, hw)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        path, _ = self.samples[index]
        img = Image.open(path).convert("RGB")
        x = self.transform(img)
        if self.two_crop:
            x = np.concatenate([x, self.transform(img)], axis=-1)
        out = {"rgbd": x, "index": np.int32(index)}
        if self.jigsaw_transform is not None:
            out["rgbd_jig"] = self.jigsaw_transform(img)
        return out
