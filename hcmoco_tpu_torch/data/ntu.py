"""NTU RGB+D dataset family (counterpart of hcmoco_tpu/data/ntu.py).

Behavioral spec: `pycontrast/datasets/dataset.py`:
  * filename transforms: warped-RGB -> masked-depth PNG / parsed-skeleton pkl
    (dataset.py:85-93, :165-173; the skeleton frame number is 0-based while
    RGB/depth are 1-based, hence the -1)
  * NTURGBD: paired RGB+depth, RandomResizedCrop with crop center clamped
    into the valid-depth bbox, random flip, ImageNet norm, depth/1000
    replicated x3 (:65-160)
  * NTURGBD3DSkeleton: + parsed skeleton (root-relative 3D), crop centered
    on a random point inside the 2D-skeleton bbox with scale (0.08,1.2)
    ratio (1,1) (:162-250)
  * NTURGBD3D2DSkeleton: + color-coded joint heatmap channel (:252-304)

All samples are returned as dicts of numpy arrays (HWC float32).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .transforms import (
    IMAGENET_MEAN, IMAGENET_STD, KINECT2MPII, crop_pad, normalize_rgb,
    random_resized_crop_params, resized_crop, positional_encoding,
    joint_heatmap_rgb, transform_heatmap,
)


def rgb_to_depth_path(f: str,
                      prefix: str = "HumanRGBD/NTURGBD/nturgb+d_depth_masked"
                      ) -> str:
    f = f.replace("nturgb+d_rgb_warped_correction", prefix)
    f = f.replace("WRGB", "MDepth")
    return f.replace("jpg", "png")


def rgb_to_skeleton_path(
    f: str, prefix: str = "HumanRGBD/NTURGBD/nturgb+d_parsed_skeleton"
) -> str:
    f = f.replace("nturgb+d_rgb_warped_correction", prefix)
    f = f.replace("WRGB", "Skeleton")
    f = f.replace("jpg", "pkl")
    num = int(f[-12:-4])
    return f[:-12] + str(num - 1).zfill(8) + f[-4:]


def load_depth_png(path: str) -> np.ndarray:
    """uint16 depth PNG -> raw uint16 array."""
    return np.array(Image.open(path)).astype(np.uint16)


def load_skeleton_pkl(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


class NTURGBDPairs:
    """RGB (depth-frame-warped) + masked-depth pairs (NTURGBD)."""

    def __init__(self, root: str, file_list: str, size: int = 320,
                 random_flip: bool = False, random_resized_crop: bool = False,
                 seed: int = 0):
        self.root = root
        self.files = [f.strip() for f in open(file_list)]
        self.size = (size, size)
        self.scale = (0.8, 1.2)
        self.ratio = (3.0 / 4, 4.0 / 3)
        self.random_flip = random_flip
        self.random_resized_crop = random_resized_crop
        self.image_list = [os.path.join(root, f) for f in self.files]
        self.depth_list = [os.path.join(root, rgb_to_depth_path(f))
                           for f in self.files]
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.image_list)

    def _load_pair(self, index):
        img = Image.open(self.image_list[index]).convert("RGB")
        depth = load_depth_png(self.depth_list[index])
        return img, depth

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rng = self._rng
        img, depth_raw = self._load_pair(index)
        # valid-depth bbox via axis reductions (np.where built two full
        # index arrays per sample — the round-1 input-pipeline hotspot)
        rows = (depth_raw > 0).any(axis=1)
        cols = (depth_raw > 0).any(axis=0)
        xmin = int(np.argmax(rows))
        xmax = int(len(rows) - 1 - np.argmax(rows[::-1]))
        ymin = int(np.argmax(cols))
        ymax = int(len(cols) - 1 - np.argmax(cols[::-1]))
        depth = Image.fromarray(depth_raw)

        if self.random_resized_crop:
            # crop center clamped into the valid-depth bbox (:109-134)
            i, j, h, w = random_resized_crop_params(
                rng, img.size[1], img.size[0], self.scale, self.ratio)
            mid_x = np.clip(i + h / 2.0, xmin, xmax)
            mid_y = np.clip(j + w / 2.0, ymin, ymax)
            i = int(mid_x - h / 2.0)
            j = int(mid_y - w / 2.0)
            img = resized_crop(img, i, j, h, w, self.size)
            depth = resized_crop(depth, i, j, h, w, self.size, nearest=True)

        if self.random_flip and rng.random() >= 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            depth = depth.transpose(Image.FLIP_LEFT_RIGHT)

        rgb = normalize_rgb(np.array(img))
        d = np.array(depth).astype(np.float32) / 1000.0
        rgbd = np.concatenate([rgb, np.repeat(d[..., None], 3, -1)], -1)
        return {"rgbd": rgbd, "index": np.int32(index)}


class NTUSkeleton3D(NTURGBDPairs):
    """+ parsed skeleton; human-centered crop (NTURGBD3DSkeleton)."""

    def __init__(self, root: str, file_list: str, size: int = 320,
                 random_flip: bool = False, random_resized_crop: bool = False,
                 seed: int = 0):
        super().__init__(root, file_list, size, random_flip,
                         random_resized_crop, seed)
        self.skeleton_list = [os.path.join(root, rgb_to_skeleton_path(f))
                              for f in self.files]

    def _skeleton_dict(self, index) -> dict:
        return load_skeleton_pkl(self.skeleton_list[index])

    def _frame_hw(self, index):
        """(frame_h, frame_w) without forcing a decode when avoidable."""
        img, depth = self._load_pair(index)
        self._pair_cache = (index, img, depth)
        return img.size[1], img.size[0]

    def _header_hw(self, index):
        """(frame_h, frame_w) from the image file's header alone."""
        with Image.open(self.image_list[index]) as img:
            return img.size[1], img.size[0]

    def _draw_crop(self, sk: dict, original_h: int, original_w: int):
        """(i, j, h, w, need_flip) of one sample: every draw load_raw
        makes from the dataset's generator, in its order."""
        rng = self._rng
        if self.random_resized_crop:
            joints2d = np.asarray(sk["joints"][0]["d_loc"],
                                  np.float32)
            hx0, hx1 = joints2d[:, 1].min(), joints2d[:, 1].max()
            hy0, hy1 = joints2d[:, 0].min(), joints2d[:, 0].max()
            rand_x = int(rng.integers(int(hx0), max(int(hx1), int(hx0) + 1)))
            rand_y = int(rng.integers(int(hy0), max(int(hy1), int(hy0) + 1)))
            _, _, h, w = random_resized_crop_params(
                rng, original_h, original_w, (0.08, 1.2), (1.0, 1.0))
            i = int(rand_x - h / 2.0)
            j = int(rand_y - w / 2.0)
        else:
            i, j, h, w = 0, 0, original_w, original_h
        # the flip is drawn last (the load/resize consumes no randomness)
        return i, j, h, w, bool(rng.random() >= 0.5)

    def skip_draws(self, index) -> None:
        """Consume the draws of sample `index` without decoding it: a
        data-parallel rank's DataSource skips the other ranks' rows so
        that its own draw what one process would."""
        self._draw_crop(self._skeleton_dict(index), *self._header_hw(index))

    def _load_region(self, index, i, j, h, w):
        """(rgb uint8 (h,w,3), depth uint16 (h,w)) crop window, zero-padded
        outside the frame.  File-backed default decodes the full frame;
        the packed dataset overrides with an mmap slice that reads only
        the crop bytes."""
        cache = getattr(self, "_pair_cache", None)
        if cache is not None and cache[0] == index:
            img, depth = cache[1], cache[2]
        else:
            img, depth = self._load_pair(index)
        return (crop_pad(np.asarray(img, np.uint8), i, j, h, w),
                crop_pad(np.asarray(depth), i, j, h, w))

    def load_raw(self, index, raw_output: bool = False, out_pair=None):
        """Returns (rgbd HWC6, joints3d, skeleton_dict, crop params).
        Mirrors NTURGBD3DSkeleton.__getitem__(return_resize_param=True).
        Sources come through the _load_region/_skeleton_dict hooks so the
        packed (mmap) dataset can substitute decode-free reads.

        raw_output=True skips host-side normalization: rgbd is returned as
        a dict {"rgb_u8": (H,W,3) uint8, "depth_mm": (H,W) uint16} and the
        train step normalizes on device (4.7x fewer host->device bytes).

        out_pair=(rgb_slot, depth_slot): optional preallocated destinations
        (e.g. batch-array slots) the crop/resample writes into directly —
        the packed+native path then produces the batch with ZERO extra
        sample copies (raw_output mode only)."""
        original_h, original_w = self._frame_hw(index)

        sk = self._skeleton_dict(index)
        # asarray: the packed dataset hands ndarrays straight through (no
        # 25-element python list rebuild per sample on the hot input path)
        joints3d = np.asarray(sk["joints"][0]["3d_loc"],
                              np.float32)
        joints3d = joints3d - joints3d[0]

        i, j, h, w, need_flip = self._draw_crop(sk, original_h, original_w)
        if self.random_resized_crop:
            rgb_arr, depth_arr = self._crop_resize_pair(
                index, i, j, h, w, self.random_flip and need_flip,
                out_pair=out_pair)
        else:
            rgb_full, depth_full = self._load_region(
                index, 0, 0, original_h, original_w)
            if self.random_flip and need_flip:
                rgb_full = rgb_full[:, ::-1]
                depth_full = depth_full[:, ::-1]
            if out_pair is not None:
                out_pair[0][...] = rgb_full
                out_pair[1][...] = depth_full
                rgb_arr, depth_arr = out_pair
            else:
                rgb_arr = np.ascontiguousarray(rgb_full)
                depth_arr = np.ascontiguousarray(depth_full)

        params = (i, j, h, w, need_flip, original_h, original_w)
        if raw_output:
            rgbd = {"rgb_u8": rgb_arr,
                    "depth_mm": depth_arr.astype(np.uint16, copy=False)}
            return rgbd, joints3d, sk, params

        rgb = normalize_rgb(rgb_arr)
        d = depth_arr.astype(np.float32) / 1000.0
        rgbd = np.concatenate([rgb, np.repeat(d[..., None], 3, -1)], -1)
        return rgbd, joints3d, sk, params

    def _crop_resize_pair(self, index, i, j, h, w, flip, out_pair=None):
        """(rgb u8 (size,size,3), depth u16 (size,size)): crop window ->
        BILINEAR/NEAREST resize -> optional horizontal flip.  Default: PIL
        (the reference's torchvision path); PackedNTUSkeleton swaps in the
        bit-exact native core (native/resample.cpp).  out_pair: optional
        preallocated destinations (the PIL path copies into them; the
        native path writes them directly)."""
        rgb_crop, depth_crop = self._load_region(index, i, j, h, w)
        img = Image.fromarray(rgb_crop).resize(self.size, Image.BILINEAR)
        depth = Image.fromarray(depth_crop).resize(self.size, Image.NEAREST)
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            depth = depth.transpose(Image.FLIP_LEFT_RIGHT)
        if out_pair is not None:
            out_pair[0][...] = np.asarray(img, np.uint8)
            out_pair[1][...] = np.asarray(depth, np.uint16)
            return out_pair
        return np.asarray(img, np.uint8), np.asarray(depth, np.uint16)

    def __getitem__(self, index):
        if getattr(self, "raw_output", False):
            raw, joints3d, _, _ = self.load_raw(index, raw_output=True)
            return {"rgb_u8": raw["rgb_u8"], "depth_mm": raw["depth_mm"],
                    "index": np.int32(index), "joints3d": joints3d}
        rgbd, joints3d, _, _ = self.load_raw(index)
        return {"rgbd": rgbd, "index": np.int32(index),
                "joints3d": joints3d}


class NTUHeatmap(NTUSkeleton3D):
    """+ 3ch color-coded joint heatmap (NTURGBD3D2DSkeleton) -> 9ch."""

    num_joints = 25
    sigma = 2.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pos_enc = positional_encoding(self.num_joints)

    def __getitem__(self, index):
        rgbd, joints3d, sk, params = self.load_raw(index)
        joints2d = np.array([j for j in sk["joints"][0]["d_loc"]],
                            np.float32)
        i, j, h, w, flip, oh, ow = params
        hm = joint_heatmap_rgb(joints2d, oh, ow, self.pos_enc, self.sigma)
        hm = transform_heatmap(hm, i, j, h, w, self.size,
                               flip and self.random_flip,
                               self.random_resized_crop)
        return {"rgbd": np.concatenate([rgbd, hm], -1),
                "index": np.int32(index), "joints3d": joints3d}
