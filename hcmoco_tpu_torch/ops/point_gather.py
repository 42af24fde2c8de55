"""Row gathers of point features and their scatter-add gradients
(kernels K5 and K6).

K5, `group_rows`, is the counterpart of hcmoco_tpu/ops/pallas/
window_group.py::window_group: table (B, N, C), gidx (B, M, S) ->
table[b, gidx[b, m, s], :], with the gradient summed back into the table
rows in f32.  K6, `interpolate_rows`, is the counterpart of
hcmoco_tpu/ops/pallas/window_interp.py::window_interpolate: feat
(B, M, C), idx and weight (B, N, 3) -> sum_k weight[.., k] *
feat[b, idx[.., k], :], the weights first rounded to the feature dtype and
the sum taken in f32 (as the TPU kernel's one-hot matmul does), with the
gradient w * gout summed into the feature rows in f32; the indices and
weights get none (they come from the point coordinates, which are data).

The TPU kernels build a one-hot matrix over a window of table rows and
multiply it on the MXU, because Mosaic cannot gather rows; the window
needs the raster-sorted locality of depth2pts, a whole-batch exactness
fallback and, for K6, the `sample_ok` exemption of zero clouds.  None of
that is ported: the CUDA kernels (csrc/point_gather.cu) gather rows
directly, exact for every sample, and scatter the gradient with f32
atomics.  Atomics add in another order on every run, so the gradients
agree with the plain versions to f32 rounding (then one rounding to bf16).

Dispatch: a CPU tensor takes the plain PyTorch versions; a CUDA tensor
launches the kernels or raises.  Tables are float32 or bfloat16.
"""

from __future__ import annotations

import torch

from . import _points

_DTYPES = (torch.float32, torch.bfloat16)


def _dtype_code(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: f32, or f64 for f64 input."""
    return torch.promote_types(t.dtype, torch.float32)


def _rows(idx: torch.Tensor, c: int) -> torch.Tensor:
    """(B, ...) indices -> (B, R, C) int64 for gather/scatter along dim 1."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return flat[..., None].expand(-1, -1, c)


# ---- K5 ---------------------------------------------------------------------


def group_rows_plain(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward of K5: (B, N, C), (B, M, S) -> (B, M, S, C)."""
    b, m, s = gidx.shape
    c = table.shape[-1]
    return torch.gather(table, 1, _rows(gidx, c)).reshape(b, m, s, c)


def group_rows_bwd_plain(gout: torch.Tensor, gidx: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Plain PyTorch backward of K5: (B, M, S, C) -> (B, N, C) in gout's
    dtype, summed in f32 (f64 for f64)."""
    b, c = gout.shape[0], gout.shape[-1]
    acc = torch.zeros((b, n, c), dtype=_acc_dtype(gout), device=gout.device)
    acc.scatter_add_(1, _rows(gidx, c), gout.reshape(b, -1, c).to(acc.dtype))
    return acc.to(gout.dtype)


def group_rows_cuda(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Launch K5's forward; counts in `group_rows_cuda.launches`."""
    _points.check_cuda("group_rows_cuda", [
        ("table", table, _DTYPES), ("gidx", gidx, (torch.int32,))])
    b, n, c = table.shape
    _, m, s = gidx.shape
    if gidx.shape[0] != b:
        raise ValueError(f"group_rows_cuda: table {tuple(table.shape)}, "
                         f"gidx {tuple(gidx.shape)}")
    out = torch.empty((b, m, s, c), dtype=table.dtype, device=table.device)
    _points.launch("group_fwd", table.device, table.data_ptr(),
                   gidx.data_ptr(), out.data_ptr(), b, n, m * s, c,
                   _dtype_code(table))
    group_rows_cuda.launches += 1
    return out


group_rows_cuda.launches = 0


def group_rows_bwd_cuda(gout: torch.Tensor, gidx: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Launch K5's backward; counts in `group_rows_bwd_cuda.launches`."""
    _points.check_cuda("group_rows_bwd_cuda", [
        ("gout", gout, _DTYPES), ("gidx", gidx, (torch.int32,))])
    b, m, s, c = gout.shape
    if gidx.shape != (b, m, s):
        raise ValueError(f"group_rows_bwd_cuda: gout {tuple(gout.shape)}, "
                         f"gidx {tuple(gidx.shape)}")
    acc = torch.empty((b, n, c), dtype=torch.float32, device=gout.device)
    grad = acc if gout.dtype == torch.float32 else torch.empty(
        (b, n, c), dtype=gout.dtype, device=gout.device)
    _points.launch("group_bwd", gout.device, gout.data_ptr(),
                   gidx.data_ptr(), acc.data_ptr(), grad.data_ptr(), b, n,
                   m * s, c, _dtype_code(gout))
    group_rows_bwd_cuda.launches += 1
    return grad


group_rows_bwd_cuda.launches = 0


class _GroupRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, gidx):
        ctx.save_for_backward(gidx)
        ctx.n = table.shape[1]
        if table.is_cuda:
            return group_rows_cuda(table, gidx)
        return group_rows_plain(table, gidx)

    @staticmethod
    def backward(ctx, gout):
        (gidx,) = ctx.saved_tensors
        gout = gout.contiguous()
        if gout.is_cuda:
            return group_rows_bwd_cuda(gout, gidx, ctx.n), None
        return group_rows_bwd_plain(gout, gidx, ctx.n), None


def group_rows(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """K5, differentiable in table: (B, N, C), (B, M, S) int32 in [0, N)
    -> (B, M, S, C)."""
    return _GroupRows.apply(table, gidx)


# ---- K6 ---------------------------------------------------------------------


def interpolate_rows_plain(feat: torch.Tensor, idx: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward of K6: (B, M, C), (B, N, 3), (B, N, 3) ->
    (B, N, C), in the kernel's order: (w0*f0 + w1*f1) + w2*f2 in f32 (f64
    for f64)."""
    b, n, _ = idx.shape
    c = feat.shape[-1]
    acc = _acc_dtype(feat)
    g = torch.gather(feat, 1, _rows(idx, c)).reshape(b, n, 3, c).to(acc)
    w = weight.to(feat.dtype).to(acc)
    out = (g[:, :, 0] * w[..., 0:1] + g[:, :, 1] * w[..., 1:2]) \
        + g[:, :, 2] * w[..., 2:3]
    return out.to(feat.dtype)


def interpolate_rows_bwd_plain(gout: torch.Tensor, idx: torch.Tensor,
                               weight: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch backward of K6: (B, N, C) -> (B, M, C) in gout's
    dtype, w * gout summed in f32 (f64 for f64)."""
    b, n, c = gout.shape
    dt = _acc_dtype(gout)
    w = weight.to(gout.dtype).to(dt)
    contrib = gout.to(dt)[:, :, None, :] * w[..., None]  # (B, N, 3, C)
    acc = torch.zeros((b, m, c), dtype=dt, device=gout.device)
    acc.scatter_add_(1, _rows(idx, c), contrib.reshape(b, n * 3, c))
    return acc.to(gout.dtype)


def _check_interp(name, rows, idx, weight):
    _points.check_cuda(name, [
        ("rows", rows, _DTYPES), ("idx", idx, (torch.int32,)),
        ("weight", weight, (torch.float32,))])
    b, n = rows.shape[:2]
    if idx.shape != (b, n, 3) or weight.shape != (b, n, 3):
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, idx "
                         f"{tuple(idx.shape)}, weight {tuple(weight.shape)}")


def interpolate_rows_cuda(feat: torch.Tensor, idx: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """Launch K6's forward; counts in `interpolate_rows_cuda.launches`."""
    _points.check_cuda("interpolate_rows_cuda", [("feat", feat, _DTYPES)])
    b, m, c = feat.shape
    n = idx.shape[1]
    out = torch.empty((b, n, c), dtype=feat.dtype, device=feat.device)
    _check_interp("interpolate_rows_cuda", out, idx, weight)
    _points.launch("interp_fwd", feat.device, feat.data_ptr(),
                   idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b, m,
                   n, c, _dtype_code(feat))
    interpolate_rows_cuda.launches += 1
    return out


interpolate_rows_cuda.launches = 0


def interpolate_rows_bwd_cuda(gout: torch.Tensor, idx: torch.Tensor,
                              weight: torch.Tensor, m: int) -> torch.Tensor:
    """Launch K6's backward; counts in
    `interpolate_rows_bwd_cuda.launches`."""
    _check_interp("interpolate_rows_bwd_cuda", gout, idx, weight)
    b, n, c = gout.shape
    acc = torch.empty((b, m, c), dtype=torch.float32, device=gout.device)
    grad = acc if gout.dtype == torch.float32 else torch.empty(
        (b, m, c), dtype=gout.dtype, device=gout.device)
    _points.launch("interp_bwd", gout.device, gout.data_ptr(),
                   idx.data_ptr(), weight.data_ptr(), acc.data_ptr(),
                   grad.data_ptr(), b, m, n, c, _dtype_code(gout))
    interpolate_rows_bwd_cuda.launches += 1
    return grad


interpolate_rows_bwd_cuda.launches = 0


class _InterpolateRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, idx, weight):
        ctx.save_for_backward(idx, weight)
        ctx.m = feat.shape[1]
        if feat.is_cuda:
            return interpolate_rows_cuda(feat, idx, weight)
        return interpolate_rows_plain(feat, idx, weight)

    @staticmethod
    def backward(ctx, gout):
        idx, weight = ctx.saved_tensors
        gout = gout.contiguous()
        if gout.is_cuda:
            grad = interpolate_rows_bwd_cuda(gout, idx, weight, ctx.m)
        else:
            grad = interpolate_rows_bwd_plain(gout, idx, weight, ctx.m)
        return grad, None, None


def interpolate_rows(feat: torch.Tensor, idx: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """K6, differentiable in feat: (B, M, C), (B, N, 3) int32 in [0, M),
    (B, N, 3) f32 -> (B, N, C)."""
    return _InterpolateRows.apply(feat, idx, weight)
