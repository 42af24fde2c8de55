"""A2J anchor machinery: dense anchor grid, soft-argmax post-processing,
smooth-L1 anchor losses (counterpart of
hcmoco_tpu/downstream/a2j/anchors.py).

Behavioral spec: `A2J/anchor.py` — `generate_anchors`/`shift` (:7-42),
`post_process.forward` (:58-82: per-joint softmax over all anchors, weighted
sum of anchor+offset positions and depths), `A2J_loss.forward` (:99-154:
smooth-L1(beta=1) on the anchor-weighted position and the offset-regressed
position x spatialFactor, smooth-L1(beta=3) on depth).

The reference loops over the batch in python; here the batch is one
einsum chain in f32 (float64 for float64 heads).  Anchors are (y, x) pairs — reference column 0 is P_h
(row) — and the grid ravels W-major (np.meshgrid(shift_h, shift_w) then
ravel), the order in which model.AnchorHead enumerates its outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def generate_anchors(p_h: Optional[np.ndarray] = None,
                     p_w: Optional[np.ndarray] = None) -> np.ndarray:
    if p_h is None:
        p_h = np.array([2, 6, 10, 14])
    if p_w is None:
        p_w = np.array([2, 6, 10, 14])
    anchors = np.zeros((len(p_h) * len(p_w), 2))
    k = 0
    for i in range(len(p_w)):
        for j in range(len(p_h)):
            anchors[k, 1] = p_w[j]
            anchors[k, 0] = p_h[i]
            k += 1
    return anchors


def shift_anchors(shape: Tuple[int, int], stride: int,
                  anchors: np.ndarray) -> np.ndarray:
    """(K*A, 2) dense grid; W-major ravel order matching the reference's
    meshgrid(shift_h, shift_w).T (anchor.py:26-42)."""
    shift_h = np.arange(0, shape[0]) * stride
    shift_w = np.arange(0, shape[1]) * stride
    hh, ww = np.meshgrid(shift_h, shift_w)
    shifts = np.vstack([hh.ravel(), ww.ravel()]).T  # (K, 2)
    a = anchors.shape[0]
    k = shifts.shape[0]
    out = anchors.reshape(1, a, 2) + shifts.reshape(k, 1, 2)
    return out.reshape(k * a, 2)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in float64 if it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def post_process(heads, all_anchors: torch.Tensor,
                 is_3d: bool = True) -> torch.Tensor:
    """Soft-argmax keypoints: (B, P, 2 or 3).

    heads: classification (B, N, P), regression (B, N, P, 2),
    depth regression (B, N, P) with N = n_anchors; all_anchors (N, 2) in
    the heads' f32 (or float64).
    """
    if is_3d:
        cls, reg, depth = heads
    else:
        cls, reg = heads
    w = torch.softmax(_f32(cls), dim=1)  # (B, N, P)
    pos = all_anchors[None, :, None, :] + _f32(reg)
    xy = torch.einsum("bnp,bnpc->bpc", w, pos)
    if not is_3d:
        return xy
    d = torch.einsum("bnp,bnp->bp", w, _f32(depth))
    return torch.cat([xy, d[..., None]], dim=-1)


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    """torch-style smooth-L1 as written in the reference
    (anchor.py:126-131): 0.5*(1/beta)*d^2 if d<=beta else d - 0.5/(1/beta).
    For beta=3 the reference literally computes d - 0.5/(1/3) = d - 1.5,
    and so does this."""
    inv = 1.0 / beta
    return torch.where(diff <= beta, 0.5 * inv * diff * diff,
                       diff - 0.5 / inv)


def a2j_loss(heads, annotations: torch.Tensor, all_anchors: torch.Tensor,
             spatial_factor: float = 0.5,
             is_3d: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(anchor_cls_loss, regression_loss), each scalar.

    annotations: (B, P, 3) = (row, col, depth) targets in crop pixels.
    Reference: A2J_loss.forward (anchor.py:99-154), vectorized over batch.
    """
    if is_3d:
        cls, reg, depthreg = heads
    else:
        cls, reg = heads
    w = torch.softmax(_f32(cls), dim=1)  # (B, N, P)
    gt_xy = _f32(annotations[..., :2])  # (B, P, 2)

    # "anchor loss": weighted mean anchor position vs gt
    anchor_pos = torch.einsum("bnp,nc->bpc", w, all_anchors)
    anchor_loss = _smooth_l1(torch.abs(gt_xy - anchor_pos), 1.0).mean(
        dim=(1, 2))

    # offset-regressed position vs gt, x spatialFactor
    pos = all_anchors[None, :, None, :] + _f32(reg)
    reg_xy = torch.einsum("bnp,bnpc->bpc", w, pos)
    reg_loss = _smooth_l1(torch.abs(gt_xy - reg_xy), 1.0).mean(
        dim=(1, 2)) * spatial_factor

    if is_3d:
        gt_d = _f32(annotations[..., 2])
        d_pred = torch.einsum("bnp,bnp->bp", w, _f32(depthreg))
        reg_loss = reg_loss + _smooth_l1(torch.abs(gt_d - d_pred), 3.0).mean(
            dim=1)

    return anchor_loss.mean(), reg_loss.mean()
