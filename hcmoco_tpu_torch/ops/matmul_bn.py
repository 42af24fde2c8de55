"""Fused 1x1-conv matmul with a BN-statistics epilogue (kernel K1) and the
BN apply from those statistics with its backward (kernels K1b).

Counterpart of hcmoco_tpu/ops/pallas/matmul_bn.py.  For a 1x1 stride-1
ConvBN site in training, `conv1x1_bn_stats` computes

    y = x2d @ w.T           (compute dtype, f32 accumulation)
    s1 = sum_rows f32(y)    over the ROUNDED y
    s2 = sum_rows f32(y)^2

in one pass, and `bn_apply_stats` normalises y from those sums, so the BN
statistics cost no second read of the activation.  Every other ConvBN site
of an HRNet in training (the 3x3 and strided convs) takes `conv_out_bn`:
train-mode BN(+ReLU) of the conv's bf16 output in one sums pass and one
apply pass forward and one sums pass and one dx pass backward, with f32
statistics (the batch_norm_* kernels).  Each direction of
`bn_apply_stats` is one pass over y on the card (K1b, the custom-VJP
companion that XLA fuses in the JAX package); its forward can also update
the BN running statistics in the same launch.

Layout: x2d is the (R, K) view of an NHWC (channels_last) activation and
w is the (C, K) view of the torch conv weight (C, K, 1, 1), both without a
copy.  The JAX function takes w as (K, C); the port takes the transpose
because that is the layout the torch weight already has.

Dispatch: a CPU tensor takes the plain PyTorch version.  A CUDA tensor
launches the hand-written Hopper kernel (csrc/matmul_bn.cu) or raises;
there is no fallback.  Each kernel wrapper counts its launches on the
host in its `.launches`: a launch captured into a CUDA graph counts
once, and the graph's replays not at all.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from .. import _build
from ..parallel.mesh import all_reduce_sum
from ..train import remat

BF16, F32 = torch.bfloat16, torch.float32


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in for t: f32, or float64 for a
    float64 t (a model run in float64, the CPU tests' reference)."""
    return torch.promote_types(t.dtype, F32)


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
    yf = y.to(_acc(y))
    return y, yf.sum(0), (yf * yf).sum(0)


# (K, C) of K1's fast path (csrc/matmul_bn.cu, K1_FAST_SHAPES): the layer1
# sites.  Every other shape takes the generic path, one launch a call.
FAST_SHAPES = ((64, 256), (256, 64), (64, 64))

# (device index, stream) -> K1's generic-path counter: one unsigned int,
# zeroed once here on that stream; each launch's last CTA sets it back to
# zero.  Launches on one stream run in order, so they share a counter
# safely; launches on two streams may overlap, so each stream has its own.
_counters: dict = {}
# the counter of the CUDA graph this thread is capturing (graph_counter)
_capture = threading.local()


def new_counter(device) -> torch.Tensor:
    """A zeroed generic-path counter on `device`: a stream's, or a CUDA
    graph's (graph_counter)."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


@contextlib.contextmanager
def graph_counter(counter: torch.Tensor):
    """K1's generic path takes `counter` in a CUDA graph that this thread
    captures inside this block: a graph's own, allocated and zeroed
    before its capture (new_counter).  Its launches replay in order on
    one stream and each launch's last CTA resets the counter, so a
    replay leaves it at zero, and eager launches, on their stream's
    counter, never share it."""
    before = getattr(_capture, "counter", None)
    _capture.counter = counter
    try:
        yield counter
    finally:
        _capture.counter = before


def _k1_counter(dev: int, stream: int) -> torch.Tensor:
    """The generic path's counter: while this thread captures a CUDA
    graph, the graph's own (graph_counter; a capture without one raises),
    else that of (device, raw stream)."""
    if torch.cuda.is_current_stream_capturing():
        counter = getattr(_capture, "counter", None)
        if counter is None:
            raise RuntimeError(
                "mm_bn_stats_cuda: a CUDA graph that captures K1 needs a "
                "generic-path counter of its own: capture inside "
                "matmul_bn.graph_counter(matmul_bn.new_counter(device))")
        return counter
    key = (dev, stream)
    if key not in _counters:
        _counters[key] = new_counter(dev)
    return _counters[key]


def mm_bn_stats_cuda(x2d: torch.Tensor, w: torch.Tensor):
    """Launch K1 on x2d's device and current stream.  `.launches` counts
    every launch on the host, `.generic_launches` those of the generic
    path.  Under
    CUDA graph capture the generic path takes the graph's counter
    (_k1_counter)."""
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
    acc = _acc(y)
    return (dy.to(acc) + ds1.to(acc)[None, :]
            + 2.0 * y.to(acc) * ds2.to(acc)[None, :]).to(y.dtype)


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
    """Custom VJP of hcmoco_tpu's conv1x1_bn_stats (_mm_bn_vjp_bwd).  In
    a region that recomputes under remat_policy 'conv_out'
    (train/remat.py), the recompute takes y and the sums back from the
    first run instead of launching K1 again."""

    @staticmethod
    def forward(ctx, x2d, w):
        y, s1, s2 = remat.kept(lambda: mm_bn_stats(x2d, w))
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


def _normaliser(y: torch.Tensor, n) -> int:
    """The rows that the channel sums cover: y's own, or `n` when they
    were all-reduced over the ranks of a global batch."""
    return y.shape[0] if n is None else int(n)


def bn_apply_fwd_plain(y, s1, s2, scale, bias, eps: float, running=None,
                       n=None):
    """Plain version of K1b's forward: (out in y's dtype, mean, var, rstd);
    with `running`, also the running-stat update.  `n`: the rows that s1
    and s2 sum over, y's by default."""
    r = _normaliser(y, n)
    mean = s1 / r
    var = torch.clamp(s2 / r - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    out = ((y.to(_acc(y)) - mean) * (rstd * scale) + bias).to(y.dtype)
    if running is not None:
        _update_running(running, mean, var, r)
    return out, mean, var, rstd


def bn_apply_fwd_cuda(y, s1, s2, scale, bias, eps: float, running=None,
                      n=None):
    """Launch K1b's forward kernel on y's device and current stream: it
    walks y's rows and normalises by `n` rows' sums (y's by default)."""
    fn = "bn_apply_fwd_cuda"
    rows, c = _rows_cols(fn, "y", y)
    r = _normaliser(y, n)
    if r <= 0 or r >= 2 ** 31:
        raise ValueError(f"{fn}: normaliser rows {r} out of range")
    specs = [("y", y, BF16, (rows, c)), ("s1", s1, F32, (c,)),
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
        rstd.data_ptr(), *ptrs, rows, c, r, eps, momentum, 1.0 - momentum,
        r / (r - 1) if r > 1 else 1.0, _stream(dev))
    _build.check(lib, rc, fn)
    bn_apply_fwd_cuda.launches += 1
    return out, mean, var, rstd


bn_apply_fwd_cuda.launches = 0


def bn_apply_fwd(y, s1, s2, scale, bias, eps: float, running=None, n=None):
    if y.is_cuda:
        return bn_apply_fwd_cuda(y, s1, s2, scale, bias, eps, running, n)
    return bn_apply_fwd_plain(y, s1, s2, scale, bias, eps, running, n)


def bn_apply_bwd_stats_plain(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                             dvar_ct, n=None):
    """Plain version of K1b's backward pass 1: the column sums dscale,
    dbias over y's rows and the cotangents ds1, ds2 of the channel sums
    of `n` rows (y's by default)."""
    dof = dout.to(_acc(y))
    yhat = (y.to(_acc(y)) - mean) * rstd
    dbias = dof.sum(0)
    dscale = (dof * yhat).sum(0)
    # out = (y - s1/R) * rstd(var(s1, s2)) * scale + bias
    dmean = -rstd * scale * dbias + dmean_ct
    # var = max(0, s2/R - mean^2): where the clamp binds, nothing flows
    # through var (matches autodiff of the unfused path)
    dvar = (-0.5 * rstd * rstd * scale * dscale + dvar_ct) * (var > 0)
    # R as a Python float: R*R overflows 32-bit ints at real shapes
    rf = float(_normaliser(y, n))
    ds1 = dmean / rf + dvar * (-2.0 * s1 / rf / rf)
    ds2 = dvar / rf
    return dscale, dbias, ds1, ds2


def bn_apply_bwd_stats_cuda(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                            dvar_ct, n=None):
    """Launch K1b's backward pass 1 (per-CTA column sums over y's rows,
    then the per-channel tail, normalised by `n` rows, y's by default) on
    y's device and current stream."""
    fn = "bn_apply_bwd_stats_cuda"
    r, c = _rows_cols(fn, "y", y)
    norm = _normaliser(y, n)
    if norm <= 0 or norm >= 2 ** 31:
        raise ValueError(f"{fn}: normaliser rows {norm} out of range")
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
        ds2.data_ptr(), r, c, norm, _stream(dev))
    _build.check(lib, rc, fn)
    bn_apply_bwd_stats_cuda.launches += 1
    return dscale, dbias, ds1, ds2


bn_apply_bwd_stats_cuda.launches = 0


def bn_apply_bwd_stats(dout, y, s1, mean, var, rstd, scale, dmean_ct,
                       dvar_ct, n=None):
    args = (dout, y, s1, mean, var, rstd, scale, dmean_ct, dvar_ct, n)
    if y.is_cuda:
        return bn_apply_bwd_stats_cuda(*args)
    return bn_apply_bwd_stats_plain(*args)


def bn_apply_bwd_dy_plain(dout, rstd, scale):
    """Plain version of K1b's backward pass 2, in dout's dtype."""
    return (dout.to(_acc(dout)) * (rstd * scale)).to(dout.dtype)


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
    def forward(ctx, y, s1, s2, scale, bias, eps, running, n):
        out, mean, var, rstd = bn_apply_fwd(y, s1, s2, scale, bias, eps,
                                            running, n)
        ctx.save_for_backward(y, s1, mean, var, rstd, scale)
        ctx.n = n
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean_ct, dvar_ct):
        y, s1, mean, var, rstd, scale = ctx.saved_tensors
        dout = dout.contiguous()
        dscale, dbias, ds1, ds2 = bn_apply_bwd_stats(
            dout, y, s1, mean, var, rstd, scale, dmean_ct.contiguous(),
            dvar_ct.contiguous(), ctx.n)
        dy = bn_apply_bwd_dy(dout, rstd, scale)
        return dy, ds1, ds2, dscale, dbias, None, None, None


def bn_apply_stats(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   running=None, n=None):
    """Train-mode BN of y (R, C) from precomputed channel sums.

    mean = s1/N, var = max(0, s2/N - mean^2) (biased), N = `n`, the rows
    that s1 and s2 sum over: R by default, the global batch's rows when
    the sums were all-reduced over the ranks.  Returns (out in y's dtype,
    mean, var).  `running`, if given, is (running_mean, running_var,
    num_batches_tracked, momentum) of an nn.BatchNorm, updated in place
    with torch semantics (unbiased running variance, var * N/(N-1))."""
    return _BNApplyStats.apply(y, s1, s2, scale, bias, eps, running, n)


# --------------------------------------------------------------------------
# BN(+ReLU) at the ConvBN sites that K1 does not take: train-mode BN of a
# conv's output y (R, C), one sums pass and one apply pass forward, one
# sums pass and one dx pass backward (the batch_norm_* kernels of
# csrc/matmul_bn.cu; hcmoco_tpu/models/hrnet.py::_bn_train_apply in the
# JAX package).  The plain versions compute in f32 for a bf16 y, as the
# kernels do, and in float64 otherwise (a model run in f32 or float64 on
# the CPU): their outputs take y's dtype, the sums and stats the acc's.


def _site_acc(y: torch.Tensor) -> torch.dtype:
    return F32 if y.dtype == BF16 else torch.float64


def _site_cols(fn: str, c: int) -> None:
    """Refuse a C whose chunk of lcm(8, C) elements is over 2048: a chunk's
    16-byte vectors must fit a 256-thread block."""
    if math.lcm(8, c) > 2048:
        raise ValueError(f"{fn}: C={c} out of range (lcm(8, C) must be at "
                         "most 2048)")


# device index -> f64 slots of the sums kernels' scratch
_site_slots: dict = {}


class _Site:
    """The BN-site kernels' launches for an (R, C) site on y's device and
    its current stream, on tensors the caller has checked: the kernel
    wrappers below check every argument and launch through it, and
    conv_out_bn checks its inputs once a call and launches through it
    (the tensors it makes itself need no check)."""

    def __init__(self, y: torch.Tensor):
        self.r, self.c = y.shape
        self.dev = y.get_device()
        self.lib = _build.load()

    def _call(self, fn: str, entry: str, *args) -> None:
        rc = getattr(self.lib, entry)(self.dev, *args, _stream(self.dev))
        _build.check(self.lib, rc, fn)

    def _vec(self, rows: int) -> torch.Tensor:
        return torch.empty((rows, self.c), dtype=F32, device=self.dev)

    def _partials(self) -> torch.Tensor:
        if self.dev not in _site_slots:
            _site_slots[self.dev] = self.lib.hcmoco_bn_site_slots(self.dev)
        return torch.empty((_site_slots[self.dev], 2, self.c),
                           dtype=torch.float64, device=self.dev)

    def sums(self, y) -> torch.Tensor:
        s = self._vec(2)
        self._call("bn_sums_cuda", "hcmoco_bn_site_sums", y.data_ptr(),
                   self._partials().data_ptr(), s.data_ptr(), self.r, self.c)
        bn_sums_cuda.launches += 1
        return s

    def fwd(self, y, s, scale, bias, eps: float, relu: bool, running, n):
        ptrs, momentum = [None, None, None], 0.0
        if running is not None:
            ptrs = [t.data_ptr() for t in running[:3]]
            momentum = running[3]
        out, stats = torch.empty_like(y), self._vec(3)
        self._call("bn_relu_fwd_cuda", "hcmoco_bn_site_fwd", y.data_ptr(),
                   s.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), stats.data_ptr(), *ptrs, self.r, self.c,
                   n, int(relu), eps, momentum, 1.0 - momentum,
                   n / (n - 1) if n > 1 else 1.0)
        bn_relu_fwd_cuda.launches += 1
        return out, stats

    def bwd_sums(self, dout, y, stats, scale, bias, relu: bool):
        sums = self._vec(2)
        self._call("bn_relu_bwd_sums_cuda", "hcmoco_bn_site_bwd_sums",
                   dout.data_ptr(), y.data_ptr(), stats.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(),
                   self._partials().data_ptr(), sums.data_ptr(), self.r,
                   self.c, int(relu))
        bn_relu_bwd_sums_cuda.launches += 1
        return sums

    def dx(self, dout, y, stats, scale, bias, sums, relu: bool, n,
           dmean_ct=None, dvar_ct=None):
        cts = [None if t is None else t.data_ptr()
               for t in (dmean_ct, dvar_ct)]
        dx = torch.empty_like(y)
        self._call("bn_relu_bwd_dx_cuda", "hcmoco_bn_site_bwd_dx",
                   dout.data_ptr(), y.data_ptr(), stats.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), sums.data_ptr(), *cts,
                   dx.data_ptr(), self.r, self.c, n, int(relu))
        bn_relu_bwd_dx_cuda.launches += 1
        return dx


def _site_checked(fn: str, y, vecs, running=None, n=None,
                  dout=None) -> int:
    """Check dout (if given) and y, (R, C) bf16, the (name, tensor, rows)
    per-channel f32 vectors `vecs` ((C,) for rows None, else (rows, C)),
    `running` and the normaliser `n` as the BN-site kernels take them;
    returns n."""
    r, c = _rows_cols(fn, "y", y)
    _site_cols(fn, c)
    norm = _normaliser(y, n)
    if norm <= 0 or norm >= 2 ** 31:
        raise ValueError(f"{fn}: normaliser rows {norm} out of range")
    specs = ([] if dout is None else [("dout", dout, BF16, (r, c))]) + [
        ("y", y, BF16, (r, c))] + [
        (name, t, F32, (c,) if rows is None else (rows, c))
        for name, t, rows in vecs]
    if running is not None:
        if norm < 2:
            raise ValueError(f"{fn}: BatchNorm in training needs more than 1 "
                             f"value per channel, got {norm}")
        specs += [("running_mean", running[0], F32, (c,)),
                  ("running_var", running[1], F32, (c,)),
                  ("num_batches_tracked", running[2], torch.int64, ())]
    _check_cuda(fn, specs)
    return norm


def _f64_sums(t1: torch.Tensor, t2: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """(2, C) [sum t1; sum t2] over the rows, added in float64 as the
    kernels add them, in `dtype`."""
    return torch.stack([t1.double().sum(0), t2.double().sum(0)]).to(dtype)


def bn_sums_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward sums: (2, C) [sum y; sum y^2]."""
    yf = y.to(_site_acc(y))
    return _f64_sums(yf, yf * yf, yf.dtype)


def bn_sums_cuda(y: torch.Tensor) -> torch.Tensor:
    """Launch the forward sums (per-CTA f64 slots, then their fixed-order
    reduction) on y's device and current stream."""
    _site_checked("bn_sums_cuda", y, [])
    return _Site(y).sums(y)


bn_sums_cuda.launches = 0


def _relu_passed(g, d, a, bias, relu: bool):
    """g where the site's ReLU passed its input d * a + bias (the
    forward's pre-activation, d = y - mean, a = rstd * scale), 0
    elsewhere; g itself at a site without ReLU."""
    return torch.where(d * a + bias > 0, g, 0.0) if relu else g


def bn_relu_fwd_plain(y, s, scale, bias, eps: float, relu: bool,
                      running=None, n=None):
    """Plain version of the apply: (out in y's dtype, stats (3, C) [mean;
    var; rstd]) from the sums s (2, C) of `n` rows (y's by default); with
    `running`, also the running-stat update."""
    r = _normaliser(y, n)
    mean = s[0] / r
    var = torch.clamp(s[1] / r - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    out = (y.to(_site_acc(y)) - mean) * (rstd * scale) + bias
    if relu:
        out = torch.where(out > 0, out, 0.0)
    if running is not None:
        _update_running(running, mean, var, r)
    return out.to(y.dtype), torch.stack([mean, var, rstd])


def bn_relu_fwd_cuda(y, s, scale, bias, eps: float, relu: bool,
                     running=None, n=None):
    """Launch the apply on y's device and current stream."""
    n = _site_checked("bn_relu_fwd_cuda", y, [
        ("s", s, 2), ("scale", scale, None), ("bias", bias, None)],
        running, n)
    return _Site(y).fwd(y, s, scale, bias, eps, relu, running, n)


bn_relu_fwd_cuda.launches = 0


def bn_relu_bwd_sums_plain(dout, y, stats, scale, bias, relu: bool):
    """Plain version of the backward sums: (2, C) [dbias; dscale] = [sum
    g; sum g * yhat] over y's rows, g = dout where the ReLU passed."""
    mean, rstd = stats[0], stats[2]
    d = y.to(_site_acc(y)) - mean
    g = _relu_passed(dout.to(_site_acc(y)), d, rstd * scale, bias, relu)
    return _f64_sums(g, g * (d * rstd), g.dtype)


def bn_relu_bwd_sums_cuda(dout, y, stats, scale, bias, relu: bool):
    """Launch the backward sums on y's device and current stream."""
    _site_checked("bn_relu_bwd_sums_cuda", y, [
        ("stats", stats, 3), ("scale", scale, None), ("bias", bias, None)],
        dout=dout)
    return _Site(y).bwd_sums(dout, y, stats, scale, bias, relu)


bn_relu_bwd_sums_cuda.launches = 0


def bn_relu_bwd_dx_plain(dout, y, stats, scale, bias, sums, relu: bool,
                         n=None, dmean_ct=None, dvar_ct=None):
    """Plain version of the dx pass, in y's dtype: _bn_train_bwd's dx from
    the backward sums [dbias; dscale] of `n` rows (y's by default), ReLU
    folded in; dmean_ct, dvar_ct: cotangents of the batch mean and var
    (None: zero)."""
    r = _normaliser(y, n)
    mean, rstd = stats[0], stats[2]
    a = rstd * scale
    b = a * sums[0] / r
    k = rstd * (a * sums[1] / r)
    if dmean_ct is not None:
        b = b - dmean_ct / r
    if dvar_ct is not None:
        k = k - 2.0 * dvar_ct / r
    d = y.to(_site_acc(y)) - mean
    g = _relu_passed(dout.to(_site_acc(y)), d, a, bias, relu)
    return ((a * g - b) - d * k).to(y.dtype)


def bn_relu_bwd_dx_cuda(dout, y, stats, scale, bias, sums, relu: bool,
                        n=None, dmean_ct=None, dvar_ct=None):
    """Launch the dx pass on y's device and current stream."""
    fn = "bn_relu_bwd_dx_cuda"
    cts = [(name, t, None) for name, t in (("dmean_ct", dmean_ct),
                                           ("dvar_ct", dvar_ct))
           if t is not None]
    n = _site_checked(fn, y, [("stats", stats, 3), ("scale", scale, None),
                              ("bias", bias, None), ("sums", sums, 2)]
                      + cts, None, n, dout)
    return _Site(y).dx(dout, y, stats, scale, bias, sums, relu, n, dmean_ct,
                       dvar_ct)


bn_relu_bwd_dx_cuda.launches = 0


class _ConvOutBN(torch.autograd.Function):
    """One ConvBN site's train-mode BN(+ReLU) of its conv output: sums
    and apply forward, sums and dx backward.  Saves y and the per-channel
    vectors, not the output: the ReLU's mask is recomputed from y.  Over
    `ranks` data-parallel ranks the forward's sums and the backward's are
    all-reduced (one all-reduce each), so BN takes the global batch's
    statistics; the parameters' gradients are this rank's share.  In a
    region that recomputes (train/remat.py), the recompute takes the
    all-reduced sums back from the first run.  On the card the inputs
    are checked once a call, and the kernels launch on the tensors made
    here without a second check."""

    @staticmethod
    def forward(ctx, y, scale, bias, eps, relu, running, ranks):
        n = y.shape[0] * ranks
        sums, fwd, site = bn_sums_plain, bn_relu_fwd_plain, None
        if y.is_cuda:
            _site_checked("conv_out_bn", y, [("scale", scale, None),
                                             ("bias", bias, None)],
                          running, n)
            site = _Site(y)
            sums, fwd = site.sums, site.fwd
        s = sums(y)
        if ranks > 1:
            s = all_reduce_sum(s)
        out, stats = fwd(y, s, scale, bias, eps, relu, running, n)
        ctx.save_for_backward(y, stats, scale, bias)
        ctx.site, ctx.relu, ctx.n, ctx.ranks = site, relu, n, ranks
        return out

    @staticmethod
    def backward(ctx, dout):
        y, stats, scale, bias = ctx.saved_tensors
        dout = dout.contiguous()
        site = ctx.site
        bwd_sums, dx = bn_relu_bwd_sums_plain, bn_relu_bwd_dx_plain
        if site is not None:
            _check_cuda("conv_out_bn", [("dout", dout, BF16,
                                         tuple(y.shape))])
            bwd_sums, dx = site.bwd_sums, site.dx
        sums = bwd_sums(dout, y, stats, scale, bias, ctx.relu)
        total = all_reduce_sum(sums) if ctx.ranks > 1 else sums
        dy = dx(dout, y, stats, scale, bias, total, ctx.relu, ctx.n)
        sums = sums.to(scale.dtype)
        return dy, sums[1], sums[0], None, None, None, None


def conv_out_bn(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float, relu: bool, running=None,
                ranks: int = 1) -> torch.Tensor:
    """Train-mode BN of a conv's output y (R, C), ReLU'd if `relu`, in y's
    dtype: mean = s1/N, var = max(0, s2/N - mean^2) (biased) over the N
    rows of the `ranks` data-parallel ranks' global batch.  `running`, if
    given, is (running_mean, running_var, num_batches_tracked, momentum)
    of an nn.BatchNorm, updated in place with torch semantics."""
    return _ConvOutBN.apply(y, scale, bias, eps, relu, running, ranks)
