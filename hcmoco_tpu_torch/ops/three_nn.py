"""Three nearest neighbours (kernel K4).

Counterpart of hcmoco_tpu/ops/pallas/three_nn.py (`three_nn_pallas`) and
of the XLA formulation in hcmoco_tpu.ops.point_ops.three_nn: for each
unknown point, the three smallest squared distances to the known set in
ascending order, the earlier index first among equal distances.  With
fewer than three known points the missing neighbours have distance
float32 max and index 0, as the JAX package pads them.

The kernel (csrc/three_nn.cu) does not test every pair: a warp of 32
consecutive unknowns visits the 32-point known tiles best first by an
exact box-to-box bound (`tile_bounds` is that bound in PyTorch ops) and
stops at the first tile that provably holds no new neighbour, so its
output is the plain version's bit for bit.

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _points

F32_MAX = torch.finfo(torch.float32).max


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor,
                   chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (B, N, 3), (B, M, 3) -> dist2 (B, N, 3) f32,
    idx (B, N, 3) i32."""
    m = known.shape[1]
    dists, idxs = [], []
    for c0 in range(0, unknown.shape[1], chunk):
        live = _points.sq_dists(unknown[:, c0:c0 + chunk], known)  # (B,C,M)
        if m < 3:
            live = torch.cat([live, live.new_full(
                live.shape[:-1] + (3 - m,), F32_MAX)], dim=-1)
        d3, i3 = [], []
        for _ in range(3):
            k = live.argmin(dim=-1, keepdim=True)  # the first minimum
            d3.append(live.gather(-1, k))
            i3.append(k)
            live = live.scatter(-1, k, float("inf"))
        dists.append(torch.cat(d3, dim=-1))
        idxs.append(torch.cat(i3, dim=-1))
    idx = torch.cat(idxs, dim=1)
    idx = torch.where(idx >= m, 0, idx)
    return torch.cat(dists, dim=1), idx.to(torch.int32)


def tile_bounds(unknown: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """The kernel's tile-skip bound, (B, N, 3), (B, M, 3) -> (B, W, T) f32
    with W = ceil(N / 32) warps of unknowns and T = ceil(M / 32) known
    tiles: for warp w's box (min and max of its unknowns' coordinates) and
    tile t's, per axis g = max(lo_t - hi_w, lo_w - hi_t, 0), and
    ((g_x*g_x + g_y*g_y) + g_z*g_z), every op rounded in f32 in the
    kernel's order.  It is at most the rounded d2 of any unknown of the
    warp to any point of the tile."""
    ulo, uhi = _points.tile_boxes(unknown)
    klo, khi = _points.tile_boxes(known)
    return _points.box_bounds(klo[:, None], khi[:, None], ulo[:, :, None],
                              uhi[:, :, None])


def three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on unknown's device and current stream.

    Counts its launches in `three_nn_cuda.launches`."""
    _points.check_cuda("three_nn_cuda", [
        ("unknown", unknown, (torch.float32,)),
        ("known", known, (torch.float32,))])
    b, n, _ = unknown.shape
    m = known.shape[1]
    if (unknown.shape[-1] != 3 or known.shape[::2] != (b, 3) or m < 1
            or b > 65535):
        raise ValueError(f"three_nn_cuda: unknown {tuple(unknown.shape)}, "
                         f"known {tuple(known.shape)}")
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    _points.launch("three_nn", unknown.device, unknown.data_ptr(),
                   known.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m)
    three_nn_cuda.launches += 1
    return dist, idx


three_nn_cuda.launches = 0


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: the kernel for CUDA tensors, the plain version for CPU ones."""
    if unknown.is_cuda:
        return three_nn_cuda(unknown, known)
    return three_nn_plain(unknown, known)
