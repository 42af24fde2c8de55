"""What the point-op kernel modules share: the squared distance of the
JAX package's `_sq_dists_exact`, in the order the kernels round it; the
32-point tile boxes and the box-to-box bound by which K3 and K4 skip tiles
(csrc/point_bounds.cuh); and the argument checks and launch of their
wrappers."""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) x (..., Q, 3) -> (..., P, Q) f32 squared distances,
    ((dx*dx + dy*dy) + dz*dz) with d = a - b: the formula of
    hcmoco_tpu.ops.point_ops._sq_dists_exact and the CUDA kernels, which
    write it without FMA so that both round alike."""
    a = a.float()
    b = b.float()
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


TILE = 32  # points a tile of K3's and K4's skip tests


def tile_boxes(x: torch.Tensor):
    """(B, N, 3) -> lo, hi (B, ceil(N / 32), 3) f32: the min and max of
    the coordinates of each 32 consecutive points (the last tile's over the
    points it has)."""
    b, n, _ = x.shape
    t = -(-n // TILE)
    x = x.float()
    pad = x.new_full((b, t * TILE - n, 3), float("inf"))
    lo = torch.cat([x, pad], 1).view(b, t, TILE, 3).amin(2)
    hi = torch.cat([x, -pad], 1).view(b, t, TILE, 3).amax(2)
    return lo, hi


def box_bounds(lo_a: torch.Tensor, hi_a: torch.Tensor, lo_b: torch.Tensor,
               hi_b: torch.Tensor) -> torch.Tensor:
    """Boxes (..., 3), broadcast -> (...) f32: per axis g = max(lo_a - hi_b,
    lo_b - hi_a, 0), then ((g_x*g_x + g_y*g_y) + g_z*g_z), every op rounded
    in f32 in the kernels' order.  Never above the rounded d2 of a point of
    one box and a point of the other (csrc/point_bounds.cuh says why)."""
    g = torch.clamp_min(torch.maximum(lo_a - hi_b, lo_b - hi_a), 0.0)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
        + g[..., 2] * g[..., 2]


def check_cuda(name: str, tensors: Sequence[tuple]) -> None:
    """Each (label, tensor, dtypes) must be a contiguous CUDA tensor of one
    of `dtypes`, all on one device."""
    device = None
    for label, t, dtypes in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} is not on a CUDA device")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {label} must be one of {dtypes}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous, got "
                             f"strides {t.stride()}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: tensors on different devices")
        if any(s >= 2 ** 31 for s in t.shape):
            raise ValueError(f"{name}: {label} of shape {tuple(t.shape)} "
                             "has a dimension too large for the kernel's "
                             "int sizes")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point `hcmoco_<name>` on `device`'s current stream
    (appended as the last argument); raise on a CUDA error."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"hcmoco_{name}")(*args, stream)
    _build.check(lib, rc, name)
