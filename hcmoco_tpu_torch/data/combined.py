"""Combined tri-modal training datasets, the actual pre-training data
(counterpart of hcmoco_tpu/data/combined.py).

Behavioral spec:
  * NTUMPIIRGBD2S = NTUMPIIRGBD3D2DSkeletonGCN (dataset.py:474-618):
    MPII (RGB-only, affine crop, fake zero depth, true_depth=0) + NTU
    (RGBD, Kinect->MPII-16 remap, per-sample depth mean normalization).
  * NTUCOCORGBD2S = NTUCOCORGBD3D2DSkeletonGCN (:622-954): same with COCO
    keypoints reduced to 13 joints.
  * NTUSegRGBD2S = NTURGBDSegJoint (:957-1118): NTU pretrain frames + the
    NTURGBD-Parsing-4K segmentation frames in one dataset, with the 60->25
    label remap, optional modality masking on seg frames, and the HRNetPN
    extras (grid_xy, depth mean).

Reference quirks replicated on purpose:
  * joints_vis uses joints2d[:,1] in BOTH w-bound terms
    (dataset.py:595-596 uses `joints2d[:, 1] < j + w` where [:,0] was
    surely intended) — kept for loss-curve parity.
  * normalize_joints runs BEFORE visibility zeroing, on the uncropped
    full-frame joints.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .ntu import NTUSkeleton3D, load_depth_png
from .mpii import (load_mpii_db, mpii_gcn_item, skip_mpii_draws,
                   MPII_NUM_JOINTS)
from .coco import (load_coco_keypoint_db, coco_reduce, kinect_reduce)
from .transforms import (
    KINECT2MPII, COCO_REDUCE_FLIP_PAIRS, MPII_FLIP_PAIRS,
    normalize_joints, flip_normalized_joints, joint_pairwise_scale,
    resized_crop,
)

# 60-class -> 25-class parsing label remap (dataset.py:1017-1020); labels
# not in the list keep their identity (quirk preserved)
SEG_ORIGINAL_LABELS = np.array(
    [0, 1, 2, 3, 6, 7, 8, 17, 18, 19, 25, 26, 27, 32, 33, 34, 38, 39, 43,
     44, 46, 49, 50, 56, 58])


def seg_label_mapper() -> np.ndarray:
    mapper = np.arange(60)
    for i, l in enumerate(SEG_ORIGINAL_LABELS):
        mapper[l] = i
    return mapper


def _ntu_gcn_fields(ds: NTUSkeleton3D, index: int, num_joints: int,
                    kinect_map, flip_pairs, size: int,
                    with_grid: bool = False) -> Dict[str, np.ndarray]:
    """Shared NTU-side GCN item (dataset.py:578-617 / :884-940 /
    :1036-1103): remapped joints, normalized skeleton, crop-space joints,
    visibility, depth mean-normalization."""
    rgbd, joints3d, sk, params = ds.load_raw(index)
    i, j, h, w, need_flip, oh, ow = params
    joints2d = np.array([p for p in sk["joints"][0]["d_loc"]], np.float32)
    joints2d = kinect_map(joints2d)

    norm_joints = normalize_joints(joints2d)
    if ds.random_flip and need_flip:
        norm_joints = flip_normalized_joints(norm_joints, flip_pairs)

    # quirk: w-bound tests use joints2d[:,1] twice (see module docstring)
    vis = np.logical_and(
        np.logical_and(joints2d[:, 1] > i, joints2d[:, 1] < i + h),
        np.logical_and(joints2d[:, 0] > j, joints2d[:, 1] < j + w))
    oj = joints2d[:, ::-1].copy()
    oj[:, 0] = (oj[:, 0] - i) / h * size
    oj[:, 1] = (oj[:, 1] - j) / w * size

    depth = rgbd[..., 3]
    depth_mask = depth > 0
    n_valid = depth_mask.sum()
    mean = float(depth.sum() / n_valid) if n_valid > 0 else 0.0
    norm_depth = np.where(depth_mask, depth - mean, 0.0)
    rgbd = rgbd.copy()
    rgbd[..., 3:] = norm_depth[..., None]

    oj[~vis] = 0
    norm_joints[~vis] = 0

    out = {
        "rgbd": rgbd.astype(np.float32),
        "skeleton": norm_joints.astype(np.float32),
        "joints3d": joints3d.astype(np.float32),
        "joints2d": oj.astype(np.float32),
        "joints_vis": vis.astype(np.int32),
        "use_depth": np.int32(1),
        "depth_mask": depth_mask.astype(np.float32),
        "scale": np.float32(joint_pairwise_scale(oj, vis.astype(bool))),
        "use_rgb": np.int32(1),
        "depth_mean": np.float32(mean),
    }
    if with_grid:
        gx, gy = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
        gxi = resized_crop(Image.fromarray(gx.astype(np.uint16)),
                           i, j, h, w, (size, size), nearest=True)
        gyi = resized_crop(Image.fromarray(gy.astype(np.uint16)),
                           i, j, h, w, (size, size), nearest=True)
        out["grid_xy"] = np.stack(
            [np.array(gxi), np.array(gyi)], -1).astype(np.float32)
    return out, params


def _aux_fill(sample: Dict[str, np.ndarray], num_joints: int,
              size: int) -> Dict[str, np.ndarray]:
    """Complete an RGB-only auxiliary (MPII/COCO) sample with the NTU-side
    fields (fake depth/zeros, dataset.py:577-583)."""
    oj = sample["joints2d"]
    vis = sample["joints_vis"]
    oj = oj.copy()
    nj = sample["skeleton"].copy()
    oj[vis == 0] = 0
    nj[vis == 0] = 0
    return {
        "rgbd": sample["rgbd"],
        "skeleton": nj.astype(np.float32),
        # joints3d is always Kinect-25 (reference zeros([25,3]) for aux
        # samples, dataset.py:577)
        "joints3d": np.zeros((25, 3), np.float32),
        "joints2d": oj.astype(np.float32),
        "joints_vis": vis.astype(np.int32),
        "use_depth": np.int32(0),
        "depth_mask": np.zeros((size, size), np.float32),
        "scale": np.float32(joint_pairwise_scale(oj, vis.astype(bool))),
        "use_rgb": np.int32(1),
        "depth_mean": np.float32(0.0),
        "grid_xy": np.zeros((size, size, 2), np.float32),
    }


class NTUMPIIGCN:
    """NTUMPIIRGBD2S: MPII first (indices [0, len(db))), then NTU."""

    num_joints = MPII_NUM_JOINTS

    def __init__(self, ntu_root: str, ntu_file_list: str, mpii_root: str,
                 mpii_image_set: str = "train", size: int = 320,
                 random_flip: bool = False,
                 random_resized_crop: bool = True, seed: int = 0,
                 with_grid: bool = False, ntu_dataset=None):
        self.ntu = ntu_dataset or NTUSkeleton3D(
            ntu_root, ntu_file_list, size, random_flip,
            random_resized_crop, seed)
        self.db = load_mpii_db(mpii_root, mpii_image_set)
        self.size = size
        self.with_grid = with_grid
        self._rng = np.random.default_rng(seed + 1)

    def __len__(self):
        return len(self.db) + len(self.ntu)

    @property
    def aux_len(self):
        return len(self.db)

    def skip_draws(self, index) -> None:
        """Consume sample `index`'s draws without decoding it."""
        if index < len(self.db):
            skip_mpii_draws(self._rng, self.ntu.random_resized_crop,
                            self.ntu.random_flip)
        else:
            self.ntu.skip_draws(index - len(self.db))

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        if index < len(self.db):
            s = mpii_gcn_item(self.db[index], self.size, self._rng,
                              self.ntu.random_resized_crop,
                              self.ntu.random_flip)
            out = _aux_fill(s, self.num_joints, self.size)
        else:
            out, _ = _ntu_gcn_fields(
                self.ntu, index - len(self.db), self.num_joints,
                lambda j: j[list(KINECT2MPII)].reshape(16, 2),
                MPII_FLIP_PAIRS, self.size, self.with_grid)
            if not self.with_grid:
                out["grid_xy"] = np.zeros((self.size, self.size, 2),
                                          np.float32)
        out["index"] = np.int32(index)
        return out


class NTUCOCOGCN(NTUMPIIGCN):
    """NTUCOCORGBD2S: COCO-reduce 13 joints."""

    num_joints = 13

    def __init__(self, ntu_root: str, ntu_file_list: str, coco_root: str,
                 coco_image_set: str = "train2017", size: int = 320,
                 random_flip: bool = False,
                 random_resized_crop: bool = True, seed: int = 0,
                 with_grid: bool = False, ntu_dataset=None):
        self.ntu = ntu_dataset or NTUSkeleton3D(
            ntu_root, ntu_file_list, size, random_flip,
            random_resized_crop, seed)
        self.db = load_coco_keypoint_db(coco_root, coco_image_set)
        self.size = size
        self.with_grid = with_grid
        self._rng = np.random.default_rng(seed + 1)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        if index < len(self.db):
            s = mpii_gcn_item(self.db[index], self.size, self._rng,
                              self.ntu.random_resized_crop,
                              self.ntu.random_flip)
            # note: mpii_gcn_item computes over 17 joints, reduce after
            nj, oj, vis = coco_reduce(s["skeleton"], s["joints2d"],
                                      s["joints_vis"])
            s = {"rgbd": s["rgbd"], "skeleton": nj, "joints2d": oj,
                 "joints_vis": vis}
            out = _aux_fill(s, self.num_joints, self.size)
        else:
            out, _ = _ntu_gcn_fields(
                self.ntu, index - len(self.db), self.num_joints,
                kinect_reduce, COCO_REDUCE_FLIP_PAIRS, self.size,
                self.with_grid)
            if not self.with_grid:
                out["grid_xy"] = np.zeros((self.size, self.size, 2),
                                          np.float32)
        out["index"] = np.int32(index)
        return out


_SEG_REGEX = re.compile(r".*S(\d{3})C(\d{3})P(\d{3})R(\d{3})A(\d{3})F(\d{3}).*")


class NTUSegJoint:
    """NTUSegRGBD2S: NTU pretrain frames + NTURGBD-Parsing-4K seg frames.

    Seg-frame path conventions (dataset.py:975-996): rgb/<name>.jpg,
    depth/MDepth-<name>.png, png_annotation_v2/<name>.png; skeletons come
    from the NTU parsed-skeleton trees keyed by the SCPRAF tag."""

    num_joints = MPII_NUM_JOINTS

    def __init__(self, ntu_root: str, ntu_file_list: str, seg_root: str,
                 seg_file_list: str, size: int = 320,
                 random_flip: bool = False,
                 random_resized_crop: bool = True, seed: int = 0,
                 only_seg: bool = False, mask_seg_depth: bool = False,
                 mask_seg_rgb: bool = False,
                 skeleton_root: Optional[str] = None):
        assert not random_flip, "seg labels are not flip-aware (:1085)"
        self.ntu = NTUSkeleton3D(ntu_root, ntu_file_list, size, random_flip,
                                 random_resized_crop, seed)
        self.size = size
        self.only_seg = only_seg
        self.mask_seg_depth = mask_seg_depth
        self.mask_seg_rgb = mask_seg_rgb
        self.mapper = seg_label_mapper()
        self.skeleton_root = skeleton_root or ntu_root

        with open(seg_file_list) as f:
            lines = sorted(l.strip() for l in f if l.strip())

        def to_depth(fn):
            parts = fn.split("/")
            parts[0] = "depth"
            parts[1] = "MDepth-" + parts[1].split(".")[0] + ".png"
            return "/".join(parts)

        def to_gt(fn):
            parts = fn.split("/")
            parts[0] = "png_annotation_v2"
            parts[1] = parts[1].split(".")[0] + ".png"
            return "/".join(parts)

        def to_skeleton(fn):
            m = _SEG_REGEX.match(fn)
            frame = int(m.group(6))
            tag = fn.split("/")[-1][:-8]
            return os.path.join(self.skeleton_root,
                                "nturgb+d_parsed_skeleton", tag,
                                f"Skeleton-{frame:08d}.pkl")

        self.seg_image_list = [os.path.join(seg_root, l) for l in lines]
        self.seg_depth_list = [os.path.join(seg_root, to_depth(l))
                               for l in lines]
        self.seg_gt_list = [os.path.join(seg_root, to_gt(l)) for l in lines]
        self.seg_skeleton_list = [to_skeleton(l) for l in lines]

        self.split = 0 if only_seg else len(self.ntu.image_list)
        if only_seg:
            self.ntu.image_list = list(self.seg_image_list)
            self.ntu.depth_list = list(self.seg_depth_list)
            self.ntu.skeleton_list = list(self.seg_skeleton_list)
        else:
            self.ntu.image_list = (self.ntu.image_list
                                   + self.seg_image_list)
            self.ntu.depth_list = self.ntu.depth_list + self.seg_depth_list
            self.ntu.skeleton_list = (self.ntu.skeleton_list
                                      + self.seg_skeleton_list)

    def __len__(self):
        return len(self.ntu.image_list)

    @property
    def aux_len(self):
        # weighted-sampler balance partner = seg frames (util.py:574-576)
        return len(self.ntu.image_list) - self.split

    def skip_draws(self, index) -> None:
        """Consume sample `index`'s draws without decoding it."""
        self.ntu.skip_draws(index)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        out, params = _ntu_gcn_fields(
            self.ntu, index, self.num_joints,
            lambda j: j[list(KINECT2MPII)].reshape(16, 2),
            MPII_FLIP_PAIRS, self.size, with_grid=True)
        is_seg = index >= self.split or self.only_seg

        if is_seg:
            gt_path = self.seg_gt_list[index - self.split]
            label = Image.open(gt_path)
            i, j, h, w = params[:4]  # same crop as the rgb/depth pair
            label = resized_crop(label, i, j, h, w,
                                 (self.size, self.size), nearest=True)
            label = self.mapper[np.array(label).astype(np.uint8)]
            out["label"] = label.astype(np.int32)
            out["true_label"] = np.int32(1)
        else:
            out["label"] = np.full((self.size, self.size), 255, np.int32)
            out["true_label"] = np.int32(0)

        if self.mask_seg_depth and is_seg and not self.only_seg:
            out["use_depth"] = np.int32(0)
            out["depth_mask"] = np.zeros_like(out["depth_mask"])
            out["rgbd"] = np.concatenate(
                [out["rgbd"][..., :3], np.zeros_like(out["rgbd"][..., :3])],
                -1)
        if self.mask_seg_rgb and is_seg and not self.only_seg:
            out["use_rgb"] = np.int32(0)
            out["rgbd"] = np.concatenate(
                [np.zeros_like(out["rgbd"][..., :3]), out["rgbd"][..., 3:]],
                -1)
        out["index"] = np.int32(index)
        return out
