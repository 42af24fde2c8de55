"""Row gathers of point features and their scatter-add gradients
(kernels K5 and K6).

K5, `group_rows`, is the counterpart of hcmoco_tpu/ops/pallas/
window_group.py::window_group: table (B, N, C), gidx (B, M, S) ->
table[b, gidx[b, m, s], :], with the gradient summed back into the table
rows in f32 and rounded once.  K6, `interpolate_rows`, is the counterpart
of hcmoco_tpu/ops/pallas/window_interp.py::window_interpolate: feat
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
directly, exact for every sample.

Both backwards are one function of a destination index: source position
r sends one gout row, times a weight, to destination row idx[b, r] (K5:
r = m*S + s, weight 1; K6: r = 3n + k, row n, weight w[b, n, k]).  On the
card they run as two kernels, shared by both: K56a, `dest_csr`, a stable
counting sort that lists each destination's sources in ascending order,
and K56b, `segment_rows_sum`, which adds each destination's sources in
that order in f32 and rounds once.  That is the order in which PyTorch's
CPU `scatter_add_` adds them, so the kernels' gradients equal the plain
versions on the CPU bit for bit, and equal themselves from run to run;
`dest_csr_plain` and `segment_rows_sum_plain` spell the two steps out.

Dispatch: a CPU tensor takes the plain PyTorch versions; a CUDA tensor
launches the kernels or raises.  Tables are float32 or bfloat16.
"""

from __future__ import annotations

import torch

from . import _points

_DTYPES = (torch.float32, torch.bfloat16)
_CSR_TILE = 8192  # sources a K56a block ranks (csrc/point_gather.cu kTile)


def _dtype_code(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: f32, or f64 for f64 input."""
    return torch.promote_types(t.dtype, torch.float32)


def _rows(idx: torch.Tensor, c: int) -> torch.Tensor:
    """(B, ...) indices -> (B, R, C) int64 for gather/scatter along dim 1."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return flat[..., None].expand(-1, -1, c)


# ---- K56a and K56b, the backwards' index and sum ----------------------------


def dest_csr_plain(idx: torch.Tensor, n_dest: int):
    """Plain PyTorch K56a: idx (B, R) int32 in [0, n_dest) -> start
    (B, n_dest + 1) int32 and src (B, R) int32, where src[b, start[b, d]:
    start[b, d + 1]] are the positions r with idx[b, r] == d, ascending."""
    key = idx.long()
    src = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = torch.zeros((idx.shape[0], n_dest), dtype=torch.int64,
                         device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    start = torch.zeros((idx.shape[0], n_dest + 1), dtype=torch.int32,
                        device=idx.device)
    start[:, 1:] = counts.cumsum(1)
    return start, src


def segment_rows_sum_plain(rows: torch.Tensor, start: torch.Tensor,
                           src: torch.Tensor, n_dest: int,
                           weight: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain PyTorch K56b: out[b, d] = the sum over src[b, start[b, d]:
    start[b, d + 1]], in that order, of source r's contribution: rows[b, r]
    (rows (B, R, C)), or rows[b, r // 3] * weight[b, r // 3, r % 3] with
    the weight first rounded to the rows' dtype (rows (B, N, C), weight
    (B, N, 3)).  Summed in f32 (f64 for f64) from 0, one add at a time,
    then rounded once to the rows' dtype."""
    b, c = rows.shape[0], rows.shape[-1]
    dt = _acc_dtype(rows)
    r = src.long()
    if weight is None:
        contrib = torch.gather(rows, 1, r[..., None].expand(-1, -1, c)).to(dt)
    else:
        k = weight.shape[-1]
        g = torch.gather(rows, 1, (r // k)[..., None].expand(-1, -1, c))
        w = weight.to(rows.dtype).to(dt).reshape(b, -1).gather(1, r)
        contrib = g.to(dt) * w[..., None]
    first = start[:, :-1].long()
    count = start[:, 1:].long() - first
    acc = torch.zeros((b, n_dest, c), dtype=dt, device=rows.device)
    for j in range(int(count.max()) if count.numel() else 0):
        live = count > j
        pos = torch.where(live, first + j, 0)
        add = torch.gather(contrib, 1, pos[..., None].expand(-1, -1, c))
        acc = torch.where(live[..., None], acc + add, acc)
    return acc.to(rows.dtype)


def dest_csr_cuda(idx: torch.Tensor, n_dest: int):
    """Launch K56a on idx (B, R) int32 in [0, n_dest), any n_dest >= 1;
    returns (start, src) as `dest_csr_plain` does, bit for bit; counts in
    `dest_csr_cuda.launches`.  Its scratch holds B * ceil(R / 8192) *
    n_dest int32 tile counts."""
    _points.check_cuda("dest_csr_cuda", [("idx", idx, (torch.int32,))])
    if idx.dim() != 2 or n_dest < 1:
        raise ValueError(f"dest_csr_cuda: idx {tuple(idx.shape)} must be "
                         f"(B, R) and n_dest {n_dest} at least 1")
    b, r = idx.shape
    start = torch.empty((b, n_dest + 1), dtype=torch.int32, device=idx.device)
    src = torch.empty((b, r), dtype=torch.int32, device=idx.device)
    n_tiles = -(-r // _CSR_TILE)
    tiles = torch.empty((b, n_tiles, n_dest), dtype=torch.int32,
                        device=idx.device)
    rel = torch.empty((b, r), dtype=torch.int16, device=idx.device)
    _points.launch("dest_csr", idx.device, idx.data_ptr(), start.data_ptr(),
                   src.data_ptr(), tiles.data_ptr(), rel.data_ptr(), b, r,
                   n_dest, n_tiles)
    dest_csr_cuda.launches += 1
    return start, src


dest_csr_cuda.launches = 0


def segment_rows_sum_cuda(rows: torch.Tensor, start: torch.Tensor,
                          src: torch.Tensor, n_dest: int,
                          weight: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Launch K56b; the function of `segment_rows_sum_plain`, bit for bit,
    with start and src from `dest_csr_cuda`; counts in
    `segment_rows_sum_cuda.launches`."""
    name = "segment_rows_sum_cuda"
    checks = [("rows", rows, _DTYPES), ("start", start, (torch.int32,)),
              ("src", src, (torch.int32,))]
    if weight is not None:
        checks.append(("weight", weight, (torch.float32,)))
    _points.check_cuda(name, checks)
    b, n_rows, c = rows.shape
    k = 1 if weight is None else 3
    if (start.shape != (b, n_dest + 1) or src.shape != (b, n_rows * k)
            or (weight is not None and weight.shape != (b, n_rows, 3))):
        raise ValueError(
            f"{name}: rows {tuple(rows.shape)}, start {tuple(start.shape)}, "
            f"src {tuple(src.shape)}, weight "
            f"{None if weight is None else tuple(weight.shape)}, "
            f"n_dest {n_dest}")
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    out = torch.empty((b, n_dest, c), dtype=rows.dtype, device=rows.device)
    work = torch.empty((b, n_dest + 1), dtype=torch.int32, device=rows.device)
    _points.launch("segment_sum", rows.device, rows.data_ptr(),
                   start.data_ptr(), src.data_ptr(),
                   None if weight is None else weight.data_ptr(),
                   out.data_ptr(), work.data_ptr(), b, n_rows * k, n_dest, c,
                   _dtype_code(rows))
    segment_rows_sum_cuda.launches += 1
    return out


segment_rows_sum_cuda.launches = 0


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
    """Launch K5's backward, K56a then K56b; counts in
    `group_rows_bwd_cuda.launches`."""
    _points.check_cuda("group_rows_bwd_cuda", [
        ("gout", gout, _DTYPES), ("gidx", gidx, (torch.int32,))])
    b, m, s, c = gout.shape
    if gidx.shape != (b, m, s):
        raise ValueError(f"group_rows_bwd_cuda: gout {tuple(gout.shape)}, "
                         f"gidx {tuple(gidx.shape)}")
    start, src = dest_csr_cuda(gidx.view(b, m * s), n)
    grad = segment_rows_sum_cuda(gout.view(b, m * s, c), start, src, n)
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
    """Launch K6's backward, K56a then K56b; counts in
    `interpolate_rows_bwd_cuda.launches`."""
    _check_interp("interpolate_rows_bwd_cuda", gout, idx, weight)
    b, n, c = gout.shape
    start, src = dest_csr_cuda(idx.view(b, n * 3), m)
    grad = segment_rows_sum_cuda(gout, start, src, m, weight)
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
