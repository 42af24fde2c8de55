"""Furthest point sampling (kernel K2).

Counterpart of hcmoco_tpu/ops/pallas/fps.py (`fps_pallas`) and of the XLA
loop in hcmoco_tpu.ops.point_ops.furthest_point_sample: seed index 0,
then npoint-1 rounds of "update each point's min squared distance to the
picked set, pick the first point of largest min distance".

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel (csrc/fps.cu) or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from . import _points


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) -> (B, npoint) int32."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        picked = xyz[rows, last][:, None, :]  # (B, 1, 3)
        d = _points.sq_dists(picked, xyz)[:, 0]  # (B, N)
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1)  # the first maximum
        idx[:, j] = last.to(torch.int32)
    return idx


def fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch K2 on xyz's device and current stream.  Any N: past 8192
    points (16 a thread at 512 threads) the kernel streams the points from
    device memory and keeps the min-distances in a scratch allocated here.

    Counts its launches in `fps_cuda.launches`."""
    _points.check_cuda("fps_cuda", [("xyz", xyz, (torch.float32,))])
    b, n, three = xyz.shape
    if three != 3 or npoint < 1 or n < 1:
        raise ValueError(f"fps_cuda: xyz {tuple(xyz.shape)}, npoint {npoint}")
    per_sample = _build.load().hcmoco_fps_scratch(n)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty((b, per_sample), dtype=torch.float32,
                           device=xyz.device) if per_sample else None)
    _points.launch("fps", xyz.device, xyz.data_ptr(), idx.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), b, n,
                   npoint)
    fps_cuda.launches += 1
    return idx


fps_cuda.launches = 0


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """K2: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if xyz.is_cuda:
        return fps_cuda(xyz, npoint)
    return fps_plain(xyz, npoint)
