"""Batch normalisation over the global batch of the data-parallel ranks.

The JAX package normalises with the statistics of the whole (sharded)
batch: flax BatchNorm with use_fast_variance, f32 sums, var = E[x^2] -
E[x]^2 (hcmoco_tpu/models/hrnet.py).  nn.SyncBatchNorm would do it on the
card only, so the port has its own: each rank sums x and x^2 per channel
in f32 (float64 in a float64 model), one differentiable all-reduce adds
the sums over the ranks, and every rank normalises its rows with the same
global mean and variance.  The all-reduce's backward sums the sums'
cotangents over the ranks, so each rank's gradient is its share of the
global loss's.

The modules subclass nn.BatchNorm1d/2d (same parameters, buffers and
names, so state dicts and exports load strict); in eval mode, and in a
world of one, they run nn.BatchNorm's own forward unchanged.  Ranks hold
equal row counts (parallel/mesh.py::shard_rows), so the global count is
the local one times the world size.

In a region that recomputes in the backward (train/remat.py), the
running statistics move in the region's first run only, and the global
sums' all-reduce is issued by it alone (parallel/mesh.py::_AllReduceSum).

A one-process run that a data-parallel one is held to normalises with
the same sums and formula (E[x^2] - E[x]^2 and torch's two-pass variance
part by more than rounding once a step is sensitive to them): it patches
`global_stats_active` to return True, the all-reduce then an identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..train import remat
from .mesh import all_reduce_sum, world_size


def global_stats_active() -> bool:
    """Whether training BN takes the global formula: in a world above
    one."""
    return world_size() > 1


def _update_running(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
                    var: torch.Tensor, n) -> None:
    """nn.BatchNorm's running-stat update from the biased batch var of n
    values a channel (unbiased running var, var * n / (n - 1))."""
    if remat.replaying():  # the region's first run updated them
        return
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.to(bn.running_mean.dtype),
                                           alpha=m)
        bn.running_var.mul_(1.0 - m).add_(
            (var * (n / (n - 1))).to(bn.running_var.dtype), alpha=m)
        bn.num_batches_tracked.add_(1)


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm,
                      x: torch.Tensor) -> torch.Tensor:
    """Train-mode BN of x (N, C, ...) with the statistics of the ranks'
    global batch, running stats of `bn` updated; x's dtype."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))
    n = (x.numel() // c) * world_size()
    if n < 2:
        raise ValueError("BatchNorm in training needs more than 1 value per "
                         f"channel, got {n}")
    mean = sums[:c] / n
    var = torch.clamp(sums[c:] / n - mean * mean, min=0.0)
    _update_running(bn, mean.detach(), var.detach(), n)
    shape = (1, c) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    out = (xf - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)
    return out.to(x.dtype)


class _GlobalBN:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and global_stats_active():
            return global_batch_norm(self, x)
        if self.training and remat.replaying():
            # a recompute (train/remat.py): nn.BatchNorm's own call, on
            # copies of the running statistics that the first run moved
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        return super().forward(x)


class GlobalBatchNorm1d(_GlobalBN, nn.BatchNorm1d):
    """nn.BatchNorm1d over the ranks' global batch in training."""


class GlobalBatchNorm2d(_GlobalBN, nn.BatchNorm2d):
    """nn.BatchNorm2d over the ranks' global batch in training."""


def masked_global_stats(x: torch.Tensor, w: Optional[torch.Tensor]):
    """(mean, biased var, n) over the rows of NCHW x that the per-sample
    weights w (N, 1, 1, 1) keep, summed over the ranks with one
    differentiable all-reduce (the sums and the kept count together);
    n = max(kept rows * H * W, 1)."""
    c = x.shape[1]
    red = (0, 2, 3)
    hw = x.shape[2] * x.shape[3]
    if w is None:
        w = torch.ones((x.shape[0], 1, 1, 1), device=x.device)
    xw = x * w
    sums = all_reduce_sum(torch.cat([
        xw.sum(red), (xw * x).sum(red), (w.sum() * hw).reshape(1)]))
    n = torch.clamp(sums[2 * c], min=1.0)
    mean = sums[:c] / n
    var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
    return mean, var, n
