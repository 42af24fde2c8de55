"""Synthetic contrast batches (counterpart of hcmoco_tpu/data/synthetic.py).

Host numpy batches with the field layout of the NTUMPII GCN dataset
(`pycontrast/datasets/dataset.py:614-617`): ImageNet-normalised RGB,
mean-subtracted depth with a validity mask, root-centred 2D joints, and
about half the samples with no real depth (`use_depth=0`).  For one seed
the batch is the JAX package's, array for array.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _smooth_field(rng: np.random.Generator, b: int, s: int,
                  scale: int = 16) -> np.ndarray:
    """Bilinear-upsampled low-res noise: a spatially smooth (b, s, s)
    field, piecewise smooth like a real depth map."""
    ls = max(s // scale, 2)
    low = rng.standard_normal((b, ls, ls)).astype(np.float32)
    xi = np.linspace(0.0, ls - 1.0, s, dtype=np.float32)
    x0 = np.floor(xi).astype(np.int64)
    x1 = np.minimum(x0 + 1, ls - 1)
    wx = (xi - x0).astype(np.float32)
    tmp = low[:, :, x0] * (1.0 - wx) + low[:, :, x1] * wx
    return (tmp[:, x0, :] * (1.0 - wx)[None, :, None]
            + tmp[:, x1, :] * wx[None, :, None])


def synthetic_contrast_batch(
    rng: np.random.Generator,
    batch_size: int,
    size: int = 320,
    num_joints: int = 16,
    n_data: int = 4096,
    depth_ratio: float = 0.5,
) -> Dict[str, np.ndarray]:
    b, s, j = batch_size, size, num_joints
    rgb = rng.standard_normal((b, s, s, 3), dtype=np.float32)
    use_depth = (rng.random(b) < depth_ratio).astype(np.int32)
    depth_mask = (rng.random((b, s, s)) > 0.4).astype(np.float32)
    depth_mask *= use_depth[:, None, None]
    # mean-subtracted depth: smooth ~0.3 m body-scale relief + sensor noise
    depth = (_smooth_field(rng, b, s) * 0.3
             + rng.standard_normal((b, s, s)).astype(np.float32) * 0.01)
    depth = depth * depth_mask
    rgbd = np.concatenate(
        [rgb, np.repeat(depth[..., None], 3, axis=-1)], axis=-1)

    skeleton = rng.uniform(-1, 1, (b, j, 2)).astype(np.float32)
    joints2d = rng.uniform(0, s, (b, j, 2)).astype(np.float32)
    joints_vis = (rng.random((b, j)) > 0.2).astype(np.int32)
    joints2d = joints2d * joints_vis[..., None]

    gy, gx = np.meshgrid(np.arange(s), np.arange(s), indexing="xy")
    grid = np.stack([gx, gy], axis=-1).astype(np.float32)
    return {
        "rgbd": rgbd,
        "index": rng.integers(0, n_data, b).astype(np.int32),
        "skeleton": skeleton,
        "joints3d": rng.standard_normal((b, j, 3)).astype(np.float32),
        "joints2d": joints2d,
        "joints_vis": joints_vis,
        "use_depth": use_depth,
        "depth_mask": depth_mask,
        "scale": rng.uniform(0.5, 2.0, b).astype(np.float32),
        "use_rgb": np.ones(b, np.int32),
        # HRNetPN extras (dataset.py:1105-1118): crop-tracked original
        # pixel coords + per-sample depth mean
        "grid_xy": np.broadcast_to(grid, (b, s, s, 2)).copy(),
        "depth_mean": rng.uniform(2.0, 4.0, b).astype(np.float32),
    }


class SyntheticContrastSource:
    """Infinite iterator of synthetic batches (host numpy), the JAX
    package's, batch for batch.

    modal: "RGBD2S" (default) yields the full tri-modal dict; "CMC"/"RGB"
    yield only {rgbd[..., :3], index}, as their real datasets emit a single
    3-channel image."""

    def __init__(self, batch_size: int, size: int = 320,
                 num_joints: int = 16, n_data: int = 4096, seed: int = 0,
                 modal: str = "RGBD2S"):
        self.batch_size = batch_size
        self.size = size
        self.num_joints = num_joints
        self.n_data = n_data
        self.modal = modal
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = synthetic_contrast_batch(
                self._rng, self.batch_size, self.size, self.num_joints,
                self.n_data)
            if self.modal != "RGBD2S":
                b = {"rgbd": b["rgbd"][..., :3], "index": b["index"]}
            yield b
