"""Packed record format: decode-free training input (counterpart of
hcmoco_tpu/data/packed.py).

The reference feeds 40 DataLoader workers with per-sample JPEG/PNG decodes
+ pickle reads — the documented input bottleneck.  Instead, pack each file
list ONCE into memory-mapped fixed-shape arrays (rgb uint8, depth uint16,
joints float32); training then reads mmap slices (~zero CPU) and only pays
for the crop/resize.

  python -m hcmoco_tpu_torch.cli.pack_ntu --data_folder ... \
      --train_file_list ... --out_dir packed/
  ... main_contrast --dataset NTUMPII --packed_dir packed/ ...

`PackedNTUSkeleton` is a drop-in for `NTUSkeleton3D` (same load_raw
surface), so every combined dataset can run off the pack.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from .ntu import NTUSkeleton3D, load_depth_png, load_skeleton_pkl


def pack_ntu(root: str, file_list: str, out_dir: str,
             verbose: bool = False) -> dict:
    """Decode the whole NTU file list once into memmapped arrays."""
    ds = NTUSkeleton3D(root, file_list)
    n = len(ds)
    os.makedirs(out_dir, exist_ok=True)

    first_rgb = np.array(Image.open(ds.image_list[0]).convert("RGB"))
    h, w = first_rgb.shape[:2]

    rgb = np.lib.format.open_memmap(
        os.path.join(out_dir, "rgb.npy"), mode="w+", dtype=np.uint8,
        shape=(n, h, w, 3))
    depth = np.lib.format.open_memmap(
        os.path.join(out_dir, "depth.npy"), mode="w+", dtype=np.uint16,
        shape=(n, h, w))
    joints3d = np.zeros((n, 25, 3), np.float32)
    joints_d = np.zeros((n, 25, 2), np.float32)

    for i in range(n):
        rgb[i] = np.array(Image.open(ds.image_list[i]).convert("RGB"))
        depth[i] = load_depth_png(ds.depth_list[i])
        sk = load_skeleton_pkl(ds.skeleton_list[i])
        joints3d[i] = np.array([j for j in sk["joints"][0]["3d_loc"]],
                               np.float32)
        joints_d[i] = np.array([j for j in sk["joints"][0]["d_loc"]],
                               np.float32)
        if verbose and (i + 1) % 500 == 0:
            print(f"packed {i + 1}/{n}")
    rgb.flush()
    depth.flush()
    np.save(os.path.join(out_dir, "joints3d.npy"), joints3d)
    np.save(os.path.join(out_dir, "joints_d.npy"), joints_d)
    meta = {"n": n, "h": h, "w": w, "root": root,
            "file_list": os.path.abspath(file_list)}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


class PackedNTUSkeleton(NTUSkeleton3D):
    """NTUSkeleton3D reading from a pack instead of decoding files."""

    def __init__(self, packed_dir: str, size: int = 320,
                 random_flip: bool = False,
                 random_resized_crop: bool = False, seed: int = 0,
                 raw_output: bool = False):
        with open(os.path.join(packed_dir, "meta.json")) as f:
            self.meta = json.load(f)
        # np.asarray: re-view the memmaps as base ndarrays (same pages,
        # zero copy) — np.memmap.__getitem__/__array_finalize__ cost ~1 ms
        # of pure python per slice, which at 100s of samples/s on a
        # 1-core host is a measurable tax on the hot input path
        self._rgb = np.asarray(np.load(
            os.path.join(packed_dir, "rgb.npy"), mmap_mode="r"))
        self._depth = np.asarray(np.load(
            os.path.join(packed_dir, "depth.npy"), mmap_mode="r"))
        self._joints3d = np.load(os.path.join(packed_dir, "joints3d.npy"))
        self._joints_d = np.load(os.path.join(packed_dir, "joints_d.npy"))
        n = self.meta["n"]
        # satisfy the base-class surface without touching the filesystem
        self.root = packed_dir
        self.files = [str(i) for i in range(n)]
        self.image_list = self.files
        self.depth_list = self.files
        self.skeleton_list = self.files
        self.size = (size, size)
        self.scale = (0.8, 1.2)
        self.ratio = (3.0 / 4, 4.0 / 3)
        self.random_flip = random_flip
        self.random_resized_crop = random_resized_crop
        self.raw_output = raw_output
        self._rng = np.random.default_rng(seed)

    def _load_pair(self, index):
        img = Image.fromarray(np.asarray(self._rgb[index]))
        return img, np.asarray(self._depth[index])

    def _frame_hw(self, index):
        # constant frame size from the pack header — no page-in at all
        return self.meta["h"], self.meta["w"]

    def _load_region(self, index, i, j, h, w):
        """Read ONLY the crop window's bytes from the mmap (the whole point
        of the packed format: the kernel pages in ~h*w rows, not frames)."""
        from .transforms import crop_pad

        return (crop_pad(self._rgb[index], i, j, h, w),
                crop_pad(self._depth[index], i, j, h, w))

    def _crop_resize_pair(self, index, i, j, h, w, flip, out_pair=None):
        """Native fast path: one C call does crop-window read (straight off
        the mmap frame) + Pillow-bit-exact BILINEAR/NEAREST resample + flip
        (native/resample.cpp; parity: tests/test_native_resample.py).
        out_pair: optional preallocated destinations (batch slots) the
        resample writes straight into — no per-sample allocation, no
        collate copy.  Falls back to the PIL path when the library is
        unavailable."""
        from ..native import resample_lib

        lib = resample_lib()
        if lib is None:
            return super()._crop_resize_pair(index, i, j, h, w, flip,
                                             out_pair=out_pair)
        out_hw = (self.size[1], self.size[0])
        ro, do = out_pair if out_pair is not None else (None, None)
        rgb = lib.resized_crop_u8(self._rgb[index], i, j, h, w, out_hw,
                                  flip, out=ro)
        depth = lib.resized_crop_nearest_u16(self._depth[index], i, j, h,
                                             w, out_hw, flip, out=do)
        if rgb is None or depth is None:
            return super()._crop_resize_pair(index, i, j, h, w, flip,
                                             out_pair=out_pair)
        return rgb, depth

    def getitem_into(self, index, out: Dict[str, np.ndarray], b: int):
        """Slot-writer protocol (data/pipeline.py::DataSource): produce
        sample `index` directly into row b of the preallocated batch
        arrays.  raw_output mode only — this is the zero-copy hot path the
        device-side normalization enables."""
        assert self.raw_output
        _, joints3d, _, _ = self.load_raw(
            index, raw_output=True,
            out_pair=(out["rgb_u8"][b], out["depth_mm"][b]))
        out["joints3d"][b] = joints3d
        out["index"][b] = np.int32(index)

    def _skeleton_dict(self, index):
        # ndarrays pass straight through load_raw's np.asarray (a python
        # list rebuild here cost ~0.5 ms/sample on the 1-core host)
        return {"joints": [{
            "3d_loc": self._joints3d[index],
            "d_loc": self._joints_d[index],
            "rgb_loc": self._joints_d[index] * 2,
        }]}
