"""Ball query with first-hit fill (kernel K3).

Counterpart of hcmoco_tpu/ops/pallas/ball_query.py (`ball_query_pallas`
and `ball_query_windowed`, which return the same indices) and of the XLA
formulation in hcmoco_tpu.ops.point_ops.ball_query.  For each center, the
points with d2 < radius^2 in index order fill the nsample slots; the first
hit fills every slot that no later hit reaches; a center with no hit gets
index 0.  The TPU's index window is a speed device with an exact fallback
and is not ported; the kernel skips 32-point tiles by an exact bound
instead (`tile_bounds` is that bound in PyTorch ops).

radius^2 is taken in double precision and rounded to f32 once, as JAX
rounds the Python float it compares an f32 array with.

Dispatch: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel (csrc/ball_query.cu) or raises.
"""

from __future__ import annotations

import torch

from . import _points


def ball_query_plain(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                     nsample: int, chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3), (B, M, 3) -> (B, M, nsample) i32."""
    n = xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    k = min(nsample, n)
    lanes = torch.arange(n, device=xyz.device)
    outs = []
    for c0 in range(0, centers.shape[1], chunk):
        d2 = _points.sq_dists(centers[:, c0:c0 + chunk], xyz)  # (B, C, N)
        masked = torch.where(d2 < r2.to(d2.device), lanes, n)
        # the k lowest hit indices in order; N where there are fewer hits
        hits = masked.topk(k, dim=-1, largest=False, sorted=True).values
        if k < nsample:
            hits = torch.cat([hits, hits.new_full(
                hits.shape[:-1] + (nsample - k,), n)], dim=-1)
        first = hits[..., :1]
        first = torch.where(first < n, first, 0)
        outs.append(torch.where(hits < n, hits, first))
    return torch.cat(outs, dim=1).to(torch.int32)


TILE = _points.TILE


def tile_bounds(xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The kernel's tile-skip bound, (B, N, 3), (B, M, 3) -> (B, M, T) f32
    with T = ceil(N / 32): for tile t's box [lo, hi] (min and max of its
    points' coordinates) and a center c, per axis g = max(lo - c, c - hi,
    0), and ((g_x*g_x + g_y*g_y) + g_z*g_z), every op rounded in f32 in
    the kernel's order.  It is at most the rounded d2 of any point of the
    tile, so a tile whose bound is >= radius^2 holds no hit."""
    lo, hi = _points.tile_boxes(xyz)
    c = centers.float()[:, :, None, :]  # (B, M, 1, 3)
    return _points.box_bounds(lo[:, None], hi[:, None], c, c)


def ball_query_cuda(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                    nsample: int) -> torch.Tensor:
    """Launch K3 on xyz's device and current stream.

    Counts its launches in `ball_query_cuda.launches`."""
    _points.check_cuda("ball_query_cuda", [
        ("xyz", xyz, (torch.float32,)),
        ("centers", centers, (torch.float32,))])
    b, n, _ = xyz.shape
    m = centers.shape[1]
    if xyz.shape[-1] != 3 or centers.shape[::2] != (b, 3) or nsample < 1:
        raise ValueError(f"ball_query_cuda: xyz {tuple(xyz.shape)}, centers "
                         f"{tuple(centers.shape)}, nsample {nsample}")
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    _points.launch("ball_query", xyz.device, xyz.data_ptr(),
                   centers.data_ptr(), idx.data_ptr(), b, n, m, nsample,
                   radius * radius)
    ball_query_cuda.launches += 1
    return idx


ball_query_cuda.launches = 0


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """K3: the kernel for CUDA tensors, the plain version for CPU ones."""
    if xyz.is_cuda:
        return ball_query_cuda(xyz, centers, radius, nsample)
    return ball_query_plain(xyz, centers, radius, nsample)
