"""Legacy HRNet-seg benchmark datasets: Cityscapes, LIP, PASCAL-Context
(the port's copy of hcmoco_tpu/downstream/seg/legacy.py).

Behavioral spec: `HRNet-Semantic-Segmentation/lib/datasets/{cityscapes,lip,
pascal_ctx}.py`.  No shipped HCMoCo experiment touches these (the parsing
experiments use NTURGBD-D/RGB + Human36M — datasets.py here), but the
reference ships the loaders, so the semantics are reproduced:

  * `CityscapesParsing` (cityscapes.py): space-separated "img label" list
    files, the 34-id -> 19-class label mapping (+ inverse for prediction
    export, :56-68/:92-100), the hardcoded 19 class weights (:42-45),
    scale-jitter + random-crop + flip training samples, and palette'd
    prediction PNGs (get_palette/save_pred :176-204).
  * `LIPParsing` (lip.py): train-time horizontal flip swaps the
    left/right PART LABELS (14<->15, 16<->17, 18<->19, :88-100); val
    ("testval") resizes the image only and evaluates at the label's
    original size (:79-85); flip-TTA at inference swaps the same class
    CHANNELS (:110-131) — expressed here as `LIP_FLIP_PAIRS` for
    inference.multi_scale_inference(flip_pairs=...).
  * `PascalContextParsing` (pascal_ctx.py): the sorted 59-id detail
    mapping (:63-68), `_class_to_index` via digitize (:77-84), and the
    59-class mode's background-ignoring `label - 1` transform
    (:130-137).  The reference depends on the external `detail` SDK and
    its own `_preprocess` references a `self._key` it never defines
    (crashes without a pre-built mask cache) — dead-on-arrival for fresh
    data; this port takes pre-extracted mask PNGs next to the images
    instead and implements the standard `_key = arange(len(mapping))`.

Samples return dicts: image (H, W, 3) float32 NHWC, label (H, W) int32 —
the same contract as datasets.ParsingDataset, consumable by the seg
trainer.  ignore_label defaults to -1 as in the reference signatures.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from ...data.transforms import normalize_rgb

# cityscapes.py:42-45
CITYSCAPES_CLASS_WEIGHTS = np.array(
    [0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
     0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
     1.0865, 1.1529, 1.0507], np.float32)

# cityscapes.py:56-68 — raw id -> train id (everything else ignored)
CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18}

# lip.py:93-95 — right/left part label pairs swapped under horizontal flip
LIP_FLIP_PAIRS = np.array([[14, 15], [16, 17], [18, 19]])

# pascal_ctx.py:63-68 — the 59 detail ids kept (sorted), position = class
PASCAL_CTX_MAPPING = np.sort(np.array([
    0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22,
    23, 397, 25, 284, 158, 159, 416, 33, 162, 420, 454, 295, 296,
    427, 44, 45, 46, 308, 59, 440, 445, 31, 232, 65, 354, 424,
    68, 326, 72, 458, 34, 207, 80, 355, 85, 347, 220, 349, 360,
    98, 187, 104, 105, 366, 189, 368, 113, 115]))


def cityscapes_convert_label(label: np.ndarray, ignore_label: int = -1,
                             inverse: bool = False) -> np.ndarray:
    """34-id <-> 19-train-id remap (cityscapes.py convert_label :92-100)."""
    out = np.full_like(label, ignore_label)
    if inverse:
        for raw, train in CITYSCAPES_ID_TO_TRAIN.items():
            out[label == train] = raw
    else:
        for raw, train in CITYSCAPES_ID_TO_TRAIN.items():
            out[label == raw] = train
    return out


def lip_swap_flip_labels(label: np.ndarray) -> np.ndarray:
    """Swap left/right part labels after a horizontal flip (lip.py:92-100)."""
    out = label.copy()
    for r, l in LIP_FLIP_PAIRS:
        out[label == r] = l
        out[label == l] = r
    return out


def pascal_ctx_class_to_index(mask: np.ndarray) -> np.ndarray:
    """Raw detail ids -> 0..59 positions (pascal_ctx.py:77-84, with the
    `_key = arange` the reference omits)."""
    values = np.unique(mask)
    assert np.isin(values, PASCAL_CTX_MAPPING).all(), \
        f"unexpected detail ids {values[~np.isin(values, PASCAL_CTX_MAPPING)]}"
    index = np.digitize(mask.ravel(), PASCAL_CTX_MAPPING, right=True)
    return index.reshape(mask.shape).astype(np.int32)


def pascal_ctx_label_transform(label: np.ndarray,
                               num_classes: int = 59) -> np.ndarray:
    """59-class mode drops class 0 (background) to ignore=-1
    (pascal_ctx.py:130-137)."""
    label = label.astype(np.int32)
    if num_classes == 59:
        label = label - 1
        label[label == -2] = -1
    return label


def seg_palette(n: int = 256) -> List[int]:
    """Bit-interleaved PASCAL palette (cityscapes.py get_palette :176-190)."""
    palette = [0] * (n * 3)
    for j in range(n):
        lab, i = j, 0
        while lab:
            palette[j * 3 + 0] |= (((lab >> 0) & 1) << (7 - i))
            palette[j * 3 + 1] |= (((lab >> 1) & 1) << (7 - i))
            palette[j * 3 + 2] |= (((lab >> 2) & 1) << (7 - i))
            i += 1
            lab >>= 3
    return palette


class _LegacySegDataset:
    """Shared list-file + gen_sample machinery (base_dataset.py:118-131)."""

    def __init__(self, root: str, list_path: str,
                 crop_size: Tuple[int, int], base_size: int,
                 num_classes: int, multi_scale: bool = True,
                 flip: bool = True, scale_factor: int = 16,
                 ignore_label: int = -1, is_train: bool = True,
                 seed: int = 0, num_samples: int = 0):
        self.root = root
        self.crop_size = crop_size
        self.base_size = base_size
        self.num_classes = num_classes
        self.multi_scale = multi_scale
        self.flip = flip
        self.scale_factor = scale_factor
        self.ignore_label = ignore_label
        self.is_train = is_train
        self.class_weights: Optional[np.ndarray] = None
        self._rng = np.random.default_rng(seed)
        with open(os.path.join(root, list_path)) as f:
            self.img_list = [ln.strip().split() for ln in f if ln.strip()]
        if num_samples:
            self.img_list = self.img_list[:num_samples]

    def __len__(self):
        return len(self.img_list)

    def _read_image(self, rel: str) -> np.ndarray:
        return np.array(
            Image.open(os.path.join(self.root, rel)).convert("RGB"))

    def _read_label(self, rel: str) -> np.ndarray:
        return np.array(Image.open(os.path.join(self.root, rel))) \
            .astype(np.int32)

    def _resize(self, img, label, size_hw):
        """(h, w) resize — bilinear image, nearest label (lip.py:61-64).
        cv2.resize takes (w, h); converted here so every caller stays in
        the class-wide (h, w) convention of crop_size/_rand_crop."""
        import cv2

        wh = (size_hw[1], size_hw[0])
        img = cv2.resize(img, wh, interpolation=cv2.INTER_LINEAR)
        label = cv2.resize(label.astype(np.int32), wh,
                           interpolation=cv2.INTER_NEAREST)
        return img, label

    def _gen_sample(self, img, label, do_flip_swap=None, flip=None):
        """Scale jitter + random crop + optional flip (gen_sample)."""
        import cv2

        rng = self._rng
        if self.multi_scale:
            rand_scale = 0.5 + int(rng.integers(0, self.scale_factor + 1)) \
                / 10.0
            long_size = int(self.base_size * rand_scale + 0.5)
            h, w = label.shape
            if h > w:
                nh, nw = long_size, int(w * long_size / h + 0.5)
            else:
                nw, nh = long_size, int(h * long_size / w + 0.5)
            img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
            label = cv2.resize(label, (nw, nh),
                               interpolation=cv2.INTER_NEAREST)
            img, label = self._rand_crop(img, label)
        if (self.flip if flip is None else flip) \
                and int(self._rng.integers(0, 2)) == 1:
            img = img[:, ::-1]
            label = label[:, ::-1]
            if do_flip_swap is not None:
                label = do_flip_swap(label)
        return img, label

    def _skip_gen_sample(self, hw, flip=None) -> None:
        """Consume the draws _gen_sample makes for a label of size hw =
        (h, w), without decoding: the scale, the crop (whose ranges follow
        from the resized, padded size), the flip."""
        rng = self._rng
        if self.multi_scale:
            rand_scale = 0.5 + int(rng.integers(0, self.scale_factor + 1)) \
                / 10.0
            long_size = int(self.base_size * rand_scale + 0.5)
            h, w = hw
            if h > w:
                nh, nw = long_size, int(w * long_size / h + 0.5)
            else:
                nw, nh = long_size, int(h * long_size / w + 0.5)
            ch, cw = self.crop_size
            rng.integers(0, max(nh, ch) - ch + 1)
            rng.integers(0, max(nw, cw) - cw + 1)
        if self.flip if flip is None else flip:
            rng.integers(0, 2)

    def _label_hw(self, rel: str) -> Tuple[int, int]:
        """A label file's (h, w), from its header (PIL opens lazily)."""
        with Image.open(os.path.join(self.root, rel)) as im:
            w, h = im.size
        return h, w

    def _rand_crop(self, img, label):
        h, w = label.shape
        ch, cw = self.crop_size
        pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
        if pad_h or pad_w:
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)),
                         mode="constant")
            label = np.pad(label, ((0, pad_h), (0, pad_w)),
                           constant_values=self.ignore_label)
        h, w = label.shape
        y = int(self._rng.integers(0, h - ch + 1))
        x = int(self._rng.integers(0, w - cw + 1))
        return img[y:y + ch, x:x + cw], label[y:y + ch, x:x + cw]

    def _pack(self, img, label, orig_size, index):
        return {"image": normalize_rgb(np.ascontiguousarray(img))
                .astype(np.float32),
                "label": np.ascontiguousarray(label).astype(np.int32),
                "size": np.asarray(orig_size, np.int32),
                "index": np.int32(index)}


class CityscapesParsing(_LegacySegDataset):
    """cityscapes.py semantics; list entries are "img_rel label_rel"
    under <root>/cityscapes/."""

    def __init__(self, root: str, list_path: str,
                 crop_size: Tuple[int, int] = (512, 1024),
                 base_size: int = 2048, num_classes: int = 19, **kw):
        super().__init__(root, list_path, crop_size, base_size,
                         num_classes, **kw)
        self.class_weights = CITYSCAPES_CLASS_WEIGHTS[:num_classes]

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rels = self.img_list[index]
        img = self._read_image(os.path.join("cityscapes", rels[0]))
        orig_size = img.shape[:2]
        if len(rels) == 1:  # test split: image only (cityscapes.py:73-80)
            img, _ = self._resize(img, np.zeros(img.shape[:2], np.int32),
                                  self.crop_size)
            return self._pack(img, np.full(self.crop_size,
                                           self.ignore_label), orig_size,
                              index)
        label = cityscapes_convert_label(
            self._read_label(os.path.join("cityscapes", rels[1])),
            self.ignore_label)
        if not self.is_train:
            return self._pack(img, label, orig_size, index)
        img, label = self._gen_sample(img, label)
        return self._pack(img, label, orig_size, index)

    def skip_draws(self, index) -> None:
        """Consume a sample's draws without decoding it (a data-parallel
        rank skipping another rank's row): the test split's image-only
        entries and evaluation draw nothing."""
        rels = self.img_list[index]
        if len(rels) == 1 or not self.is_train:
            return
        self._skip_gen_sample(self._label_hw(os.path.join("cityscapes",
                                                          rels[1])))

    def save_pred(self, pred_classes: np.ndarray, sv_path: str, name: str):
        """Palette'd PNG with the INVERSE label map (cityscapes.py:192-204)."""
        raw = cityscapes_convert_label(pred_classes.astype(np.int32),
                                       ignore_label=0, inverse=True)
        im = Image.fromarray(raw.astype(np.uint8))
        im.putpalette(seg_palette(256))
        im.save(os.path.join(sv_path, name + ".png"))


class LIPParsing(_LegacySegDataset):
    """lip.py semantics; images under <root>/lip/TrainVal_images/, labels
    under <root>/lip/TrainVal_parsing_annotations/."""

    def __init__(self, root: str, list_path: str,
                 crop_size: Tuple[int, int] = (473, 473),
                 base_size: int = 473, num_classes: int = 20,
                 scale_factor: int = 11, **kw):
        super().__init__(root, list_path, crop_size, base_size,
                         num_classes, scale_factor=scale_factor, **kw)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rels = self.img_list[index]
        img = self._read_image(os.path.join("lip", "TrainVal_images",
                                            rels[0]))
        label = self._read_label(os.path.join(
            "lip", "TrainVal_parsing_annotations", rels[1]))
        orig_size = label.shape
        if not self.is_train:
            # resize the IMAGE only; eval at the label's original size
            # (lip.py:79-85)
            import cv2

            img = cv2.resize(img, (self.crop_size[1], self.crop_size[0]),
                             interpolation=cv2.INTER_LINEAR)
            return self._pack(img, label, orig_size, index)
        # flip-with-label-swap happens BEFORE the resize (lip.py:88-100);
        # gen_sample then runs with flip disabled (lip.py:104 gen_sample
        # multi_scale, False)
        if self.flip and int(self._rng.integers(0, 2)) == 1:
            img = img[:, ::-1]
            label = lip_swap_flip_labels(label[:, ::-1])
        img, label = self._resize(img, label, self.crop_size)
        img, label = self._gen_sample(img, label, flip=False)
        return self._pack(img, label, orig_size, index)

    def skip_draws(self, index) -> None:
        """Consume a training sample's draws without decoding it: the flip,
        then _gen_sample's on the label resized to crop_size."""
        if not self.is_train:
            return
        if self.flip:
            self._rng.integers(0, 2)
        self._skip_gen_sample(self.crop_size, flip=False)


class PascalContextParsing(_LegacySegDataset):
    """pascal_ctx.py semantics over pre-extracted detail masks: list
    entries are "img_rel mask_rel" under <root>/pascal_ctx/; masks hold
    raw detail ids (converted) or 0..59 class indices (mode='index')."""

    def __init__(self, root: str, list_path: str,
                 crop_size: Tuple[int, int] = (480, 480),
                 base_size: int = 520, num_classes: int = 59,
                 mask_mode: str = "index", **kw):
        assert mask_mode in ("index", "detail")
        super().__init__(root, list_path, crop_size, base_size,
                         num_classes, **kw)
        self.mask_mode = mask_mode

    def _label(self, rel: str) -> np.ndarray:
        m = self._read_label(os.path.join("pascal_ctx", rel))
        if self.mask_mode == "detail":
            m = pascal_ctx_class_to_index(m)
        return pascal_ctx_label_transform(m, self.num_classes)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rels = self.img_list[index]
        img = self._read_image(os.path.join("pascal_ctx", rels[0]))
        label = self._label(rels[1])
        orig_size = label.shape
        if not self.is_train:
            img, label = self._resize(img, label, self.crop_size)
            return self._pack(img, label, orig_size, index)
        img, label = self._gen_sample(img, label)
        return self._pack(img, label, orig_size, index)

    def skip_draws(self, index) -> None:
        """Consume a training sample's draws without decoding it."""
        if self.is_train:
            self._skip_gen_sample(self._label_hw(os.path.join(
                "pascal_ctx", self.img_list[index][1])))
