"""Fused 1x1-conv matmul with a BN-statistics epilogue (kernel K1).

Counterpart of hcmoco_tpu/ops/pallas/matmul_bn.py.  For a 1x1 stride-1
ConvBN site in training, `conv1x1_bn_stats` computes

    y = x2d @ w.T           (compute dtype, f32 accumulation)
    s1 = sum_rows f32(y)    over the ROUNDED y
    s2 = sum_rows f32(y)^2

in one pass, and `bn_apply_stats` normalises y from those sums, so the BN
statistics cost no second read of the activation.

Layout: x2d is the (R, K) view of an NHWC (channels_last) activation and
w is the (C, K) view of the torch conv weight (C, K, 1, 1), both without a
copy.  The JAX function takes w as (K, C); the port takes the transpose
because that is the layout the torch weight already has.

Dispatch: a CPU tensor takes the plain PyTorch version.  A CUDA tensor
launches the hand-written Hopper kernel (csrc/matmul_bn.cu) or raises;
there is no fallback.
"""

from __future__ import annotations

import torch

from .. import _build


def mm_bn_stats_plain(x2d: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch version: (R, K) x (C, K) -> (y (R, C), s1 (C,), s2 (C,))."""
    y = torch.matmul(x2d, w.t())
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def _check_kernel_args(x2d: torch.Tensor, w: torch.Tensor) -> None:
    for name, t in (("x2d", x2d), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"mm_bn_stats_cuda: {name} is not on a CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"mm_bn_stats_cuda: {name} must be bfloat16, got "
                             f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"mm_bn_stats_cuda: {name} must be a contiguous "
                             f"2-D tensor, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if x2d.device != w.device:
        raise ValueError("mm_bn_stats_cuda: x2d and w on different devices")
    if x2d.shape[1] != w.shape[1]:
        raise ValueError(f"mm_bn_stats_cuda: K mismatch, x2d {tuple(x2d.shape)}"
                         f" vs w {tuple(w.shape)}")
    if x2d.shape[0] == 0 or x2d.shape[0] >= 2 ** 31:
        raise ValueError(f"mm_bn_stats_cuda: row count {x2d.shape[0]} out of "
                         "range")


def mm_bn_stats_cuda(x2d: torch.Tensor, w: torch.Tensor):
    """Launch K1 on x2d's device and current stream.

    Counts its launches in `mm_bn_stats_cuda.launches`."""
    _check_kernel_args(x2d, w)
    lib = _build.load()
    r, k = x2d.shape
    c = w.shape[0]
    dev = x2d.device
    n_row_blocks = -(-r // lib.hcmoco_mm_bn_row_tile())
    y = torch.empty((r, c), dtype=x2d.dtype, device=dev)
    partials = torch.empty((n_row_blocks, 2, c), dtype=torch.float32,
                           device=dev)
    s = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hcmoco_mm_bn_stats(
            x2d.data_ptr(), w.data_ptr(), y.data_ptr(), partials.data_ptr(),
            s.data_ptr(), r, k, c, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "mm_bn_stats_cuda")
    mm_bn_stats_cuda.launches += 1
    return y, s[0], s[1]


mm_bn_stats_cuda.launches = 0


def mm_bn_stats(x2d: torch.Tensor, w: torch.Tensor):
    """Forward of K1: the kernel for CUDA tensors, the plain version for CPU."""
    if x2d.is_cuda:
        return mm_bn_stats_cuda(x2d, w)
    return mm_bn_stats_plain(x2d, w)


class _Conv1x1BNStats(torch.autograd.Function):
    """Custom VJP of hcmoco_tpu's conv1x1_bn_stats (_mm_bn_vjp_bwd)."""

    @staticmethod
    def forward(ctx, x2d, w):
        y, s1, s2 = mm_bn_stats(x2d, w)
        ctx.save_for_backward(x2d, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x2d, w, y = ctx.saved_tensors
        # s1/s2 are sums of the rounded y: their cotangents broadcast back
        # onto every row, dy_total = dy + ds1 + 2*y*ds2; then the two plain
        # matmul grads (outside the kernel, as in JAX)
        dyt = (dy.float() + ds1.float()[None, :]
               + 2.0 * y.float() * ds2.float()[None, :]).to(x2d.dtype)
        dx = torch.matmul(dyt, w)
        dw = torch.matmul(dyt.t(), x2d)
        return dx, dw


def conv1x1_bn_stats(x2d: torch.Tensor, w: torch.Tensor):
    """(R, K) x (C, K) -> (y (R, C), s1 (C,), s2 (C,)), differentiable."""
    return _Conv1x1BNStats.apply(x2d, w)


class _BNApplyStats(torch.autograd.Function):
    """Custom VJP of hcmoco_tpu's bn_apply_stats; plain PyTorch, no kernel."""

    @staticmethod
    def forward(ctx, y, s1, s2, scale, bias, eps):
        r = y.shape[0]
        mean = s1 / r
        var = torch.clamp(s2 / r - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        out = ((y.float() - mean) * (rstd * scale) + bias).to(y.dtype)
        ctx.save_for_backward(y, s1, mean, rstd, var, scale)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean_ct, dvar_ct):
        y, s1, mean, rstd, var, scale = ctx.saved_tensors
        yf = y.float()
        dof = dout.float()
        yhat = (yf - mean) * rstd
        dbias = dof.sum(0)
        dscale = (dof * yhat).sum(0)
        dy = (dof * (rstd * scale)).to(y.dtype)
        # out = (y - s1/R) * rstd(var(s1, s2)) * scale + bias
        dmean = -rstd * scale * dbias + dmean_ct
        # var = max(0, s2/R - mean^2): where the clamp binds, nothing flows
        # through var (matches autodiff of the unfused path)
        dvar = (-0.5 * rstd * rstd * scale * dscale + dvar_ct) * (var > 0)
        # R as a Python float: R*R overflows 32-bit ints at real shapes
        rf = float(y.shape[0])
        ds1 = dmean / rf + dvar * (-2.0 * s1 / rf / rf)
        ds2 = dvar / rf
        return dy, ds1, ds2, dscale, dbias, None


def bn_apply_stats(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BN of y (R, C) from precomputed channel sums.

    mean = s1/R, var = max(0, s2/R - mean^2) (biased).  Returns
    (out in y's dtype, mean, var)."""
    return _BNApplyStats.apply(y, s1, s2, scale, bias, eps)
