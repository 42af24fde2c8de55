"""Point-cloud ops (counterpart of hcmoco_tpu/ops/point_ops.py).

Spec: the reference CUDA ops of pycontrast/networks/pointnet2/src/
(furthest point sampling, first-hit-fill ball query, row gathers, three
nearest neighbours, weighted three-point interpolation).  Layout as the
JAX package: coordinates (B, N, 3), features channels-last (B, N, C).

Each function with a kernel takes it for CUDA tensors and its plain
PyTorch version for CPU tensors (the kernel modules fps, ball_query,
three_nn and point_gather hold both); `gather_points` and
`interpolation_weights` are plain PyTorch everywhere, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch

from .ball_query import ball_query  # noqa: F401  (K3)
from .fps import fps
from .point_gather import group_rows, interpolate_rows
from .three_nn import F32_MAX
from .three_nn import three_nn  # noqa: F401  (K4)

# K5: (B, N, C), (B, M, S) int32 -> (B, M, S, C)
group_points = group_rows
# K6: (B, M, C), (B, N, 3) int32, (B, N, 3) f32 -> (B, N, C) weighted
# three-row gather, summed in f32
three_interpolate = interpolate_rows


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          allow_identity: bool = False) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 (K2).

    allow_identity: with npoint == N return 0..N-1 in input order instead
    of FPS visit order (the same set), for consumers that are
    permutation-equivariant; the SA modules are, and the first one hits
    this case."""
    b, n, _ = xyz.shape
    if allow_identity and npoint == n:
        return torch.arange(n, dtype=torch.int32,
                            device=xyz.device).expand(b, n)
    return fps(xyz, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    c = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c))


def interpolation_weights(dist2: torch.Tensor) -> torch.Tensor:
    """1/(d2 + 1e-8), normalised over the 3 neighbours (the reference
    applies it to SQUARED distances); a neighbour padded at float32 max
    weighs 0."""
    recip = 1.0 / (dist2 + 1e-8)
    recip = torch.where(dist2 >= F32_MAX, 0.0, recip)
    total = (recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]
    return recip / total
