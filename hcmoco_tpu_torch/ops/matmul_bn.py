"""Fused 1x1-conv matmul with a BN-statistics epilogue (kernel K1) and the
BN apply from those statistics with its backward (kernels K1b).

Counterpart of hcmoco_tpu/ops/pallas/matmul_bn.py.  For a 1x1 stride-1
ConvBN site in training, `conv1x1_bn_stats` computes

    y = x2d @ w.T           (compute dtype, f32 accumulation)
    s1 = sum_rows f32(y)    over the ROUNDED y
    s2 = sum_rows f32(y)^2

in one pass, and `bn_apply_stats` normalises y from those sums, so the BN
statistics cost no second read of the activation.  Each direction of
`bn_apply_stats` is one pass over y on the card (K1b, the custom-VJP
companion that XLA fuses in the JAX package); its forward can also update
the BN running statistics in the same launch.

Layout: x2d is the (R, K) view of an NHWC (channels_last) activation and
w is the (C, K) view of the torch conv weight (C, K, 1, 1), both without a
copy.  The JAX function takes w as (K, C); the port takes the transpose
because that is the layout the torch weight already has.

Dispatch: a CPU tensor takes the plain PyTorch version.  A CUDA tensor
launches the hand-written Hopper kernel (csrc/matmul_bn.cu) or raises;
there is no fallback.  Each kernel wrapper counts its launches in its
`.launches`.
"""

from __future__ import annotations

import torch

from .. import _build

BF16, F32 = torch.bfloat16, torch.float32


def _check_cuda(fn: str, specs) -> int:
    """Raise unless every (name, tensor, dtype, shape) of `specs` is a
    contiguous CUDA tensor of that dtype and shape on one device; 2-D
    tensors (read in 16-byte vectors) must also be 16-byte aligned.
    Returns the device index."""
    idx = specs[0][1].get_device()
    for name, t, dtype, shape in specs:
        if (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                or (t.dim() == 2 and t.data_ptr() % 16)
                or t.get_device() != idx or idx < 0):
            _raise_bad(fn, name, t, dtype, shape, idx)
    return idx


def _raise_bad(fn: str, name: str, t: torch.Tensor, dtype, shape,
               idx: int) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous tensor of "
                         f"shape {tuple(shape)}, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.dim() == 2 and t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} is not on a CUDA device")
    raise ValueError(f"{fn}: {name} is on {t.device}, not cuda:{idx}")


def _rows_cols(fn: str, name: str, t: torch.Tensor) -> tuple:
    if t.dim() != 2:
        raise ValueError(f"{fn}: {name} must be 2-D, got shape "
                         f"{tuple(t.shape)}")
    r, c = t.shape
    if r == 0 or r * c >= 2 ** 31:
        raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} out of range")
    return r, c


def _stream(idx: int) -> int:
    """The raw current stream of CUDA device `idx`."""
    return torch._C._cuda_getCurrentRawStream(idx)


# --------------------------------------------------------------------------
# K1: y = x2d @ w.T with the channel sums of the rounded y


def mm_bn_stats_plain(x2d: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch version: (R, K) x (C, K) -> (y (R, C), s1 (C,), s2 (C,))."""
    y = torch.matmul(x2d, w.t())
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


# (K, C) of K1's fast path (csrc/matmul_bn.cu, K1_FAST_SHAPES): the layer1
# sites.  Every other shape takes the generic path, one launch a call.
FAST_SHAPES = ((64, 256), (256, 64), (64, 64))

# (device index, stream) -> K1's generic-path counter: one unsigned int,
# zeroed once here on that stream; each launch's last CTA sets it back to
# zero.  Launches on one stream run in order, so they share a counter
# safely; launches on two streams may overlap, so each stream has its own.
_counters: dict = {}


def _k1_counter(dev: int, stream: int) -> torch.Tensor:
    """The generic path's counter of (device, raw stream).  Refuses while
    the current stream is being captured into a CUDA graph: a replayed
    graph would reuse the captured counter's address beside eager
    launches, and how a graph keeps its own is ROADMAP.md S1's design."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "mm_bn_stats_cuda: K1 cannot be captured into a CUDA graph yet: "
            "its generic path keeps a completion counter per (device, "
            "stream), and a graph's own counter is ROADMAP.md S1's design")
    key = (dev, stream)
    if key not in _counters:
        _counters[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _counters[key]


def mm_bn_stats_cuda(x2d: torch.Tensor, w: torch.Tensor):
    """Launch K1 on x2d's device and current stream.  `.launches` counts
    every launch, `.generic_launches` those of the generic path.  Raises
    during CUDA graph capture (see _k1_counter)."""
    fn = "mm_bn_stats_cuda"
    r, k = _rows_cols(fn, "x2d", x2d)
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"{fn}: K mismatch, x2d {tuple(x2d.shape)} vs w "
                         f"{tuple(w.shape)}")
    c = w.shape[0]
    dev = _check_cuda(fn, [("x2d", x2d, BF16, (r, k)),
                           ("w", w, BF16, (c, k))])
    stream = _stream(dev)
    counter = _k1_counter(dev, stream)
    lib = _build.load()
    slots = lib.hcmoco_mm_bn_slots(dev, r, k, c)
    if slots <= 0:
        raise ValueError(f"{fn}: no launch for K={k}, C={c}: w and a "
                         "16-row tile of x exceed a block's shared memory")
    y = torch.empty((r, c), dtype=BF16, device=dev)
    s = torch.empty((2, c), dtype=F32, device=dev)
    partials = torch.empty((slots, 2, c), dtype=torch.float64, device=dev)
    rc = lib.hcmoco_mm_bn_stats(
        dev, x2d.data_ptr(), w.data_ptr(), y.data_ptr(), partials.data_ptr(),
        s.data_ptr(), counter.data_ptr(), r, k, c, stream)
    _build.check(lib, rc, fn)
    mm_bn_stats_cuda.launches += 1
    if (k, c) not in FAST_SHAPES:
        mm_bn_stats_cuda.generic_launches += 1
    return y, s[0], s[1]


mm_bn_stats_cuda.launches = 0
mm_bn_stats_cuda.generic_launches = 0


def mm_bn_stats(x2d: torch.Tensor, w: torch.Tensor):
    """Forward of K1: the kernel for CUDA tensors, the plain version for CPU."""
    if x2d.is_cuda:
        return mm_bn_stats_cuda(x2d, w)
    return mm_bn_stats_plain(x2d, w)


# K1's backward prologue: s1/s2 are sums of the rounded y, so their
# cotangents broadcast back onto every row, dyt = dy + ds1 + 2*y*ds2


def mm_bn_bwd_dyt_plain(dy: torch.Tensor, y: torch.Tensor,
                        ds1: torch.Tensor, ds2: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's backward prologue, in y's dtype."""
    return (dy.float() + ds1.float()[None, :]
            + 2.0 * y.float() * ds2.float()[None, :]).to(y.dtype)


def mm_bn_bwd_dyt_cuda(dy: torch.Tensor, y: torch.Tensor, ds1: torch.Tensor,
                       ds2: torch.Tensor) -> torch.Tensor:
    """Launch K1b's dyt kernel on y's device and current stream."""
    fn = "mm_bn_bwd_dyt_cuda"
    r, c = _rows_cols(fn, "y", y)
    dev = _check_cuda(fn, [("dy", dy, BF16, (r, c)), ("y", y, BF16, (r, c)),
                           ("ds1", ds1, F32, (c,)), ("ds2", ds2, F32, (c,))])
    lib = _build.load()
    dyt = torch.empty_like(y)
    rc = lib.hcmoco_mm_bn_dyt(dev, dy.data_ptr(), y.data_ptr(),
                              ds1.data_ptr(), ds2.data_ptr(),
                              dyt.data_ptr(), r, c, _stream(dev))
    _build.check(lib, rc, fn)
    mm_bn_bwd_dyt_cuda.launches += 1
    return dyt


mm_bn_bwd_dyt_cuda.launches = 0


def mm_bn_bwd_dyt(dy, y, ds1, ds2):
    if y.is_cuda:
        return mm_bn_bwd_dyt_cuda(dy, y, ds1, ds2)
    return mm_bn_bwd_dyt_plain(dy, y, ds1, ds2)


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
        dyt = mm_bn_bwd_dyt(dy.contiguous(), y, ds1.contiguous(),
                            ds2.contiguous())
        # the two plain matmul grads, outside any kernel as in JAX
        dx = torch.matmul(dyt, w)
        dw = torch.matmul(dyt.t(), x2d)
        return dx, dw


def conv1x1_bn_stats(x2d: torch.Tensor, w: torch.Tensor):
    """(R, K) x (C, K) -> (y (R, C), s1 (C,), s2 (C,)), differentiable."""
    return _Conv1x1BNStats.apply(x2d, w)


# --------------------------------------------------------------------------
# K1b: train-mode BN of y (R, C) from the channel sums


def _update_running(running, mean: torch.Tensor, var: torch.Tensor,
                    n: int) -> None:
    """nn.BatchNorm2d's running-stat update from a biased batch var."""
    if n < 2:
        raise ValueError("BatchNorm in training needs more than 1 value per "
                         f"channel, got {n}")
    run_mean, run_var, n_tracked, m = running
    with torch.no_grad():
        run_mean.mul_(1.0 - m).add_(mean, alpha=m)
        run_var.mul_(1.0 - m).add_(var * (n / (n - 1)), alpha=m)
        n_tracked.add_(1)


def bn_apply_fwd_plain(y, s1, s2, scale, bias, eps: float, running=None):
    """Plain version of K1b's forward: (out in y's dtype, mean, var, rstd);
    with `running`, also the running-stat update."""
    r = y.shape[0]
    mean = s1 / r
    var = torch.clamp(s2 / r - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    out = ((y.float() - mean) * (rstd * scale) + bias).to(y.dtype)
    if running is not None:
        _update_running(running, mean, var, r)
    return out, mean, var, rstd


def bn_apply_fwd_cuda(y, s1, s2, scale, bias, eps: float, running=None):
    """Launch K1b's forward kernel on y's device and current stream."""
    fn = "bn_apply_fwd_cuda"
    r, c = _rows_cols(fn, "y", y)
    specs = [("y", y, BF16, (r, c)), ("s1", s1, F32, (c,)),
             ("s2", s2, F32, (c,)), ("scale", scale, F32, (c,)),
             ("bias", bias, F32, (c,))]
    ptrs, momentum = [0, 0, 0], 0.0
    if running is not None:
        run_mean, run_var, n_tracked, momentum = running
        if r < 2:
            raise ValueError(f"{fn}: BatchNorm in training needs more than 1 "
                             f"value per channel, got {r}")
        specs += [("running_mean", run_mean, F32, (c,)),
                  ("running_var", run_var, F32, (c,)),
                  ("num_batches_tracked", n_tracked, torch.int64, ())]
        ptrs = [t.data_ptr() for t in (run_mean, run_var, n_tracked)]
    dev = _check_cuda(fn, specs)
    lib = _build.load()
    out = torch.empty_like(y)
    mean, var, rstd = (torch.empty((c,), dtype=F32, device=dev)
                       for _ in range(3))
    rc = lib.hcmoco_bn_fwd(
        dev, y.data_ptr(), s1.data_ptr(), s2.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(),
        rstd.data_ptr(), *ptrs, r, c, eps, momentum, 1.0 - momentum,
        r / (r - 1) if r > 1 else 1.0, _stream(dev))
    _build.check(lib, rc, fn)
    bn_apply_fwd_cuda.launches += 1
    return out, mean, var, rstd


bn_apply_fwd_cuda.launches = 0


def bn_apply_fwd(y, s1, s2, scale, bias, eps: float, running=None):
    if y.is_cuda:
        return bn_apply_fwd_cuda(y, s1, s2, scale, bias, eps, running)
    return bn_apply_fwd_plain(y, s1, s2, scale, bias, eps, running)


def bn_apply_bwd_stats_plain(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                             dvar_ct):
    """Plain version of K1b's backward pass 1: the column sums dscale,
    dbias and the cotangents ds1, ds2 of the channel sums."""
    dof = dout.float()
    yhat = (y.float() - mean) * rstd
    dbias = dof.sum(0)
    dscale = (dof * yhat).sum(0)
    # out = (y - s1/R) * rstd(var(s1, s2)) * scale + bias
    dmean = -rstd * scale * dbias + dmean_ct
    # var = max(0, s2/R - mean^2): where the clamp binds, nothing flows
    # through var (matches autodiff of the unfused path)
    dvar = (-0.5 * rstd * rstd * scale * dscale + dvar_ct) * (var > 0)
    # R as a Python float: R*R overflows 32-bit ints at real shapes
    rf = float(y.shape[0])
    ds1 = dmean / rf + dvar * (-2.0 * s1 / rf / rf)
    ds2 = dvar / rf
    return dscale, dbias, ds1, ds2


def bn_apply_bwd_stats_cuda(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                            dvar_ct):
    """Launch K1b's backward pass 1 (per-CTA column sums, then the
    per-channel tail) on y's device and current stream."""
    fn = "bn_apply_bwd_stats_cuda"
    r, c = _rows_cols(fn, "y", y)
    vec = [(name, t, F32, (c,)) for name, t in (
        ("s1", s1), ("mean", mean), ("var", var), ("rstd", rstd),
        ("scale", scale), ("dmean_ct", dmean_ct), ("dvar_ct", dvar_ct))]
    dev = _check_cuda(fn, [("dout", dout, BF16, (r, c)),
                           ("y", y, BF16, (r, c))] + vec)
    lib = _build.load()
    grads = torch.empty((4, c), dtype=F32, device=dev)  # one allocation
    dscale, dbias, ds1, ds2 = grads[0], grads[1], grads[2], grads[3]
    partials = torch.empty((lib.hcmoco_bn_bwd_slots(dev, r), 2, c),
                           dtype=torch.float64, device=dev)
    rc = lib.hcmoco_bn_bwd_stats(
        dev, dout.data_ptr(), y.data_ptr(), s1.data_ptr(), mean.data_ptr(),
        var.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        dmean_ct.data_ptr(), dvar_ct.data_ptr(), partials.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), ds1.data_ptr(),
        ds2.data_ptr(), r, c, _stream(dev))
    _build.check(lib, rc, fn)
    bn_apply_bwd_stats_cuda.launches += 1
    return dscale, dbias, ds1, ds2


bn_apply_bwd_stats_cuda.launches = 0


def bn_apply_bwd_stats(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                       dvar_ct):
    args = (dout, y, s1, mean, var, rstd, scale, dmean_ct, dvar_ct)
    if y.is_cuda:
        return bn_apply_bwd_stats_cuda(*args)
    return bn_apply_bwd_stats_plain(*args)


def bn_apply_bwd_dy_plain(dout, rstd, scale):
    """Plain version of K1b's backward pass 2, in dout's dtype."""
    return (dout.float() * (rstd * scale)).to(dout.dtype)


def bn_apply_bwd_dy_cuda(dout, rstd, scale):
    """Launch K1b's dy kernel on dout's device and current stream."""
    fn = "bn_apply_bwd_dy_cuda"
    r, c = _rows_cols(fn, "dout", dout)
    dev = _check_cuda(fn, [("dout", dout, BF16, (r, c)),
                           ("rstd", rstd, F32, (c,)),
                           ("scale", scale, F32, (c,))])
    lib = _build.load()
    dy = torch.empty_like(dout)
    rc = lib.hcmoco_bn_bwd_dy(dev, dout.data_ptr(), rstd.data_ptr(),
                              scale.data_ptr(), dy.data_ptr(), r, c,
                              _stream(dev))
    _build.check(lib, rc, fn)
    bn_apply_bwd_dy_cuda.launches += 1
    return dy


bn_apply_bwd_dy_cuda.launches = 0


def bn_apply_bwd_dy(dout, rstd, scale):
    if dout.is_cuda:
        return bn_apply_bwd_dy_cuda(dout, rstd, scale)
    return bn_apply_bwd_dy_plain(dout, rstd, scale)


class _BNApplyStats(torch.autograd.Function):
    """Custom VJP of hcmoco_tpu's bn_apply_stats (_bn_apply_fwd,
    _bn_apply_bwd)."""

    @staticmethod
    def forward(ctx, y, s1, s2, scale, bias, eps, running):
        out, mean, var, rstd = bn_apply_fwd(y, s1, s2, scale, bias, eps,
                                            running)
        ctx.save_for_backward(y, s1, mean, var, rstd, scale)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean_ct, dvar_ct):
        y, s1, mean, var, rstd, scale = ctx.saved_tensors
        dout = dout.contiguous()
        dscale, dbias, ds1, ds2 = bn_apply_bwd_stats(
            dout, y, s1, mean, var, rstd, scale, dmean_ct.contiguous(),
            dvar_ct.contiguous())
        dy = bn_apply_bwd_dy(dout, rstd, scale)
        return dy, ds1, ds2, dscale, dbias, None, None


def bn_apply_stats(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   running=None):
    """Train-mode BN of y (R, C) from precomputed channel sums.

    mean = s1/R, var = max(0, s2/R - mean^2) (biased).  Returns
    (out in y's dtype, mean, var).  `running`, if given, is
    (running_mean, running_var, num_batches_tracked, momentum) of an
    nn.BatchNorm, updated in place with torch semantics (unbiased running
    variance, var * R/(R-1))."""
    return _BNApplyStats.apply(y, s1, s2, scale, bias, eps, running)
