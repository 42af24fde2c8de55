"""Peaks of one NVIDIA H100 SXM and the least time of each hand-written
kernel's work, from the cell's shapes alone.

A bound is the larger of bytes over the memory bandwidth (every input
read once, every output written once) and operations over the peak rate
of the arithmetic they need.  The byte and operation counts are those of
the port's kernel table (PERF.md), whatever kernel does the work; model
FLOPs count a forward pass of the plain reference (flops.py).
"""

from __future__ import annotations

from typing import List, Tuple

from .reference import models

# NVIDIA's H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12  # outside the tensor cores, an FMA counted as two
# f32 arithmetic that is not contracted into FMAs: 132 SMs x 128 lanes x
# 1.98 GHz, one op a lane a cycle
F32_NOFMA_OPS_S = 132 * 128 * 1.98e9


def bound_s(nbytes: float, ops: float, ops_s: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / ops_s)


# ---- fused 1x1 ConvBN: K1 and the four K1b kernels --------------------------


def convbn_sites(width: int, crop: int) -> List[Tuple[int, int, int]]:
    """(rows a sample, K in, C out) of each 1x1 stride-1 ConvBN site of
    one HRNet: layer1's bottleneck 1x1 convs and downsample, and each
    HR module's upsampling fuse conv (at the lower branch's
    resolution)."""
    st = models.hrnet_stages(width)
    h = crop // 4
    planes = st[0].channels[0]
    out, cin = planes * 4, 64
    sites = []
    for b in range(st[0].blocks[0]):
        sites += [(h * h, cin, planes), (h * h, planes, out)]
        if b == 0 and cin != out:
            sites.append((h * h, cin, out))
        cin = out
    for spec in st[1:]:
        for _ in range(spec.modules):
            for i in range(spec.branches):
                for j in range(i + 1, spec.branches):
                    sites.append(((h >> j) ** 2, spec.channels[j],
                                  spec.channels[i]))
    return sites


def k1_s(r: int, k: int, c: int) -> float:
    """K1: y = x w^T in bf16 with the column sums of y and y^2."""
    return bound_s(2 * (r * k + c * k + r * c) + 8 * c, 2 * r * k * c,
                   BF16_OPS_S)


def k1b_s(r: int, c: int) -> Tuple[float, float, float, float]:
    """K1b's forward (BN apply and running stats), its backward sums, its
    dy and K1's dyt prologue, bf16 (R, C) tensors."""
    rc = r * c
    return (bound_s(4 * rc + 36 * c, 3 * rc, F32_OPS_S),
            bound_s(4 * rc + 52 * c, 6 * rc, F32_OPS_S),
            bound_s(4 * rc + 8 * c, rc, F32_OPS_S),
            bound_s(6 * rc + 8 * c, 4 * rc, F32_OPS_S))


def convbn_step_s(width: int, crop: int, rows: int, encoders: int) -> float:
    """The least time of one training step's K1 and K1b work, `rows`
    samples a card, `encoders` HRNets."""
    total = 0.0
    for hw, k, c in convbn_sites(width, crop):
        r = rows * hw
        total += k1_s(r, k, c) + sum(k1b_s(r, c))
    return total * encoders


# ---- point ops: K2-K6 and the backwards (K56a + K56b) ----------------------


def k2_s(b: int, n: int, m: int) -> float:
    """FPS: 10 uncontracted f32 ops a point a round."""
    return bound_s(b * n * 12 + b * m * 4, 10 * b * n * (m - 1),
                   F32_NOFMA_OPS_S)


def k3_s(b: int, n: int, m: int, s: int) -> float:
    return bound_s(b * (n + m) * 12 + b * m * s * 4, 0, F32_OPS_S)


def k4_s(b: int, n: int, m: int) -> float:
    return bound_s(b * (n + m) * 12 + b * n * 24, 0, F32_OPS_S)


def k5_s(b: int, n: int, m: int, s: int, c: int, elt: int
         ) -> Tuple[float, float]:
    """The grouping's forward and backward: (B, N, C) rows gathered to
    (B, M, S, C), `elt` bytes an element."""
    rows, out_b = b * m * s, b * m * s * c * elt
    return (bound_s(b * n * c * elt + rows * 4 + out_b, 0, F32_OPS_S),
            bound_s(out_b + rows * 4 + b * n * c * elt, rows * c, F32_OPS_S))


def k6_s(b: int, n: int, m: int, c: int, elt: int) -> Tuple[float, float]:
    """The three-row interpolation's forward and backward: (B, M, C) onto
    N points with (B, N, 3) indices and weights."""
    small = b * m * c * elt + b * n * 24
    return (bound_s(small + b * n * c * elt, 5 * b * n * c, F32_OPS_S),
            bound_s(small + b * n * c * elt, 6 * b * n * c, F32_OPS_S))
