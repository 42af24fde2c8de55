"""K1's and K1b's plain PyTorch versions and bn_apply_stats held against
hcmoco_tpu's ops/pallas/matmul_bn.py (Pallas in interpret mode) on the CPU,
conv_out_bn's (the BN-site kernels') against hcmoco_tpu/models/hrnet.py's
_bn_train_fwd / _bn_train_bwd and nn.relu, and the kernel wrappers'
dispatch and argument checks.

Tolerances: forward rtol/atol 1e-5; grads rtol 5e-4, atol 5e-5 (the
tolerance of tests/test_models.py::TestConvBNFuse), as only the summation
order differs; in bf16, one bf16 ulp.  The CUDA kernels themselves are
compared with these plain versions on the card by chip_smoke.py, by the
`cuda`-marked test below and by tests/test_torch_matmul_bn_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.models import hrnet as jax_hrnet
from hcmoco_tpu.ops.pallas import matmul_bn as jax_mm

from hcmoco_tpu_torch.ops import matmul_bn

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=5e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# 130 rows: not a multiple of the 64-row tile; 2*8*8 = 128 rows: a multiple
@pytest.mark.parametrize("rows", [130, 2 * 8 * 8])
def test_conv1x1_bn_stats_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 12)).astype(np.float32)
    w = rng.standard_normal((12, 20)).astype(np.float32)  # JAX (K, C)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((rows, 20), (20,), (20,))]

    (jy, js1, js2), vjp = jax.vjp(
        lambda a, b: jax_mm.conv1x1_bn_stats(a, b, 64), jnp.asarray(x),
        jnp.asarray(w))
    jdx, jdw = vjp(tuple(jnp.asarray(c) for c in cts))

    xt, wt = _t(x, True), _t(w.T.copy(), True)  # the port takes w as (C, K)
    y, s1, s2 = matmul_bn.conv1x1_bn_stats(xt, wt)
    torch.autograd.backward((y, s1, s2), tuple(_t(c) for c in cts))

    for got, want in ((y, jy), (s1, js1), (s2, js2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **GRAD)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(jdw), **GRAD)


def test_bn_apply_stats_matches_jax():
    """Forward and all five grads, with channel 0 constant so that the
    var >= 0 clamp binds (raw variance below zero)."""
    rng = np.random.default_rng(7)
    r, c = 2 * 8 * 8, 20
    y = rng.standard_normal((r, c)).astype(np.float32) * 1.3 + 0.2
    y[:, 0] = 0.5
    s1 = y.sum(0).astype(np.float32)
    s2 = (y * y).sum(0).astype(np.float32)
    s2[0] = np.float32(r * 0.25 * (1.0 - 1e-6))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((r, c), (c,), (c,))]

    outs, vjp = jax.vjp(
        lambda *a: jax_mm.bn_apply_stats(*a, 1e-5),
        *(jnp.asarray(a) for a in (y, s1, s2, scale, bias)))
    jgrads = vjp(tuple(jnp.asarray(ct) for ct in cts))

    ins = [_t(a, True) for a in (y, s1, s2, scale, bias)]
    got = matmul_bn.bn_apply_stats(*ins, 1e-5)
    assert float(got[2][0].detach()) == 0.0  # the clamp bound
    torch.autograd.backward(got, tuple(_t(ct) for ct in cts))

    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD)
    for t, w in zip(ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor never reaches the kernel: the launch count stays put."""
    before = matmul_bn.mm_bn_stats_cuda.launches
    x = torch.randn(70, 9, dtype=torch.bfloat16)
    w = torch.randn(5, 9, dtype=torch.bfloat16)
    y, s1, s2 = matmul_bn.mm_bn_stats(x, w)
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    torch.testing.assert_close(s1, y.float().sum(0))
    torch.testing.assert_close(s2, (y.float() ** 2).sum(0))
    assert matmul_bn.mm_bn_stats_cuda.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="not on a CUDA device"):
        matmul_bn.mm_bn_stats_cuda(torch.zeros(4, 3, dtype=torch.bfloat16),
                                   torch.zeros(2, 3, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Run on the card only (`python -m pytest -m cuda tests/`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for r, k, c in ((12800 + 37, 144, 72), (3200, 36, 18), (4096, 64, 256)):
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = torch.randn((c, k), generator=g, device="cuda").bfloat16()
        y, s1, s2 = matmul_bn.mm_bn_stats_cuda(x, w)
        yp, _, _ = matmul_bn.mm_bn_stats_plain(x, w)
        torch.cuda.synchronize()
        big = torch.maximum(yp.float().abs(), y.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
        assert bool(((y.float() - yp.float()).abs() <= ulp).all())
        yd = y.double()
        torch.testing.assert_close(s1.double(), yd.sum(0), rtol=1e-5,
                                   atol=1e-5 * float(yd.sum(0).abs().max()))
        torch.testing.assert_close(s2.double(), (yd * yd).sum(0), rtol=1e-5,
                                   atol=0.0)


# ---------------------------------------------------------------------------
# K1b: the split forward and backward of bn_apply_stats and K1's backward
# prologue, at a ragged R with K = C = 18, channel 0 constant so that the
# var >= 0 clamp binds

R_RAGGED, C18 = 12800 + 37, 18


def _bn_inputs(seed: int):
    rng = np.random.default_rng(seed)
    r, c = R_RAGGED, C18
    y = rng.standard_normal((r, c)).astype(np.float32) * 1.3 + 0.2
    y[:, 0] = 0.5
    s1 = y.sum(0, dtype=np.float64).astype(np.float32)
    s2 = (y.astype(np.float64) ** 2).sum(0).astype(np.float32)
    s2[0] = np.float32(r * 0.25 * (1.0 - 1e-6))  # raw variance below zero
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cts = [rng.standard_normal(sh).astype(np.float32)
           for sh in ((r, c), (c,), (c,))]
    return y, s1, s2, scale, bias, cts


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **FWD)
    else:  # one bf16 ulp of the larger magnitude
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = np.ldexp(1.0, np.frexp(big)[1] - 8)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_apply_fwd_plain_matches_jax(dtype):
    y, s1, s2, scale, bias, _ = _bn_inputs(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    yj = jnp.asarray(y).astype(jdt)
    (jout, jmean, jvar), res = jax_mm._bn_apply_fwd(
        yj, *(jnp.asarray(a) for a in (s1, s2, scale, bias)), 1e-5)
    jrstd = res[3]

    yt = _t(yj.astype(jnp.float32)).to(dtype)
    rm = torch.linspace(-1.0, 1.0, C18)
    rv = torch.linspace(0.5, 2.0, C18)
    nbt = torch.zeros((), dtype=torch.int64)
    out, mean, var, rstd = matmul_bn.bn_apply_fwd(
        yt, *(_t(a) for a in (s1, s2, scale, bias)), 1e-5,
        (rm, rv, nbt, 0.01))
    assert out.dtype == dtype and float(var[0]) == 0.0  # the clamp bound
    _close(out, np.asarray(jout.astype(jnp.float32)), dtype)
    for got, want in ((mean, jmean), (var, jvar), (rstd, jrstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # the running-stat update, torch semantics (unbiased running variance)
    n = R_RAGGED
    np.testing.assert_allclose(
        rm.numpy(), np.linspace(-1.0, 1.0, C18) * 0.99
        + 0.01 * np.asarray(jmean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        rv.numpy(), np.linspace(0.5, 2.0, C18) * 0.99
        + 0.01 * np.asarray(jvar) * n / (n - 1), rtol=1e-6, atol=1e-7)
    assert int(nbt) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_apply_bwd_plain_matches_jax(dtype):
    """Pass 1 (dscale, dbias, ds1, ds2) and pass 2 (dy) against
    _bn_apply_bwd, cotangents of mean and var included."""
    y, s1, s2, scale, bias, cts = _bn_inputs(4)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    yj = jnp.asarray(y).astype(jdt)
    _, res = jax_mm._bn_apply_fwd(
        yj, *(jnp.asarray(a) for a in (s1, s2, scale, bias)), 1e-5)
    dout = jnp.asarray(cts[0]).astype(jdt)
    jdy, jds1, jds2, jdscale, jdbias = jax_mm._bn_apply_bwd(
        1e-5, res, (dout, jnp.asarray(cts[1]), jnp.asarray(cts[2])))

    yt = _t(yj.astype(jnp.float32)).to(dtype)
    dt = _t(dout.astype(jnp.float32)).to(dtype)
    _, mean, var, rstd = matmul_bn.bn_apply_fwd(
        yt, *(_t(a) for a in (s1, s2, scale, bias)), 1e-5)
    dscale, dbias, ds1, ds2 = matmul_bn.bn_apply_bwd_stats(
        dt, yt, _t(s1), mean, var, rstd, _t(scale), _t(cts[1]), _t(cts[2]))
    dy = matmul_bn.bn_apply_bwd_dy(dt, rstd, _t(scale))
    assert dy.dtype == dtype and float(ds2[0]) == 0.0  # masked by the clamp
    for got, want in ((dscale, jdscale), (dbias, jdbias), (ds1, jds1),
                      (ds2, jds2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
    _close(dy, np.asarray(jdy.astype(jnp.float32)), dtype)


def test_mm_bn_bwd_dyt_plain_matches_jax():
    """K1's backward prologue, then the two matmuls, against _mm_bn_vjp_bwd
    on the residuals of conv1x1_bn_stats in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((R_RAGGED, C18)).astype(np.float32)
    w = rng.standard_normal((C18, C18)).astype(np.float32)  # JAX (K, C)
    cts = [rng.standard_normal(sh).astype(np.float32)
           for sh in ((R_RAGGED, C18), (C18,), (C18,))]
    (jy, _, _), res = jax_mm._mm_bn_vjp_fwd(jnp.asarray(x), jnp.asarray(w),
                                            512, True)
    jdx, jdw = jax_mm._mm_bn_vjp_bwd(512, True, res,
                                     tuple(jnp.asarray(c) for c in cts))

    xt, wt = _t(x), _t(w.T.copy())
    y, _, _ = matmul_bn.mm_bn_stats(xt, wt)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD)
    dyt = matmul_bn.mm_bn_bwd_dyt(_t(cts[0]), y, _t(cts[1]), _t(cts[2]))
    np.testing.assert_allclose(torch.matmul(dyt, wt).numpy(),
                               np.asarray(jdx), **GRAD)
    np.testing.assert_allclose(torch.matmul(dyt.t(), xt).numpy().T,
                               np.asarray(jdw), **GRAD)


def _k1b_args(r=40, c=24, dtype=torch.bfloat16):
    """Valid CPU arguments of every K1/K1b wrapper, by wrapper name."""
    g = torch.Generator().manual_seed(0)

    def act():
        return torch.randn((r, c), generator=g).to(dtype)

    def vec():
        return torch.rand((c,), generator=g) + 0.5

    y, dout = act(), act()
    stats = torch.stack([vec(), vec(), vec()])
    sums = torch.stack([vec(), vec()])
    return {
        "mm_bn_stats": (act(), torch.randn((c, c), generator=g).to(dtype)),
        "bn_apply_fwd": (y, vec(), vec() * r, vec(), vec(), 1e-5),
        "bn_apply_bwd_stats": (dout, y) + tuple(vec() for _ in range(7)),
        "bn_apply_bwd_dy": (dout, vec(), vec()),
        "mm_bn_bwd_dyt": (dout, y, vec(), vec()),
        "bn_sums": (y,),
        "bn_relu_fwd": (y, torch.stack([vec(), vec() * r]), vec(), vec(),
                        1e-5, True),
        "bn_relu_bwd_sums": (dout, y, stats, vec(), vec(), True),
        "bn_relu_bwd_dx": (dout, y, stats, vec(), vec(), sums, True, None,
                           vec(), vec()),
    }


@pytest.mark.parametrize("name", ["mm_bn_stats", "bn_apply_fwd",
                                  "bn_apply_bwd_stats", "bn_apply_bwd_dy",
                                  "mm_bn_bwd_dyt"])
def test_cpu_tensors_take_plain_versions(name):
    """Every K1/K1b dispatcher runs the plain version on CPU tensors: the
    same result, and the kernel's launch count stays put."""
    args = _k1b_args()[name]
    kernel = getattr(matmul_bn, name + "_cuda")
    before = kernel.launches
    got = getattr(matmul_bn, name)(*args)
    want = getattr(matmul_bn, name + "_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert kernel.launches == before


def _fault(args, fault):
    """args with its first tensor broken in one way."""
    t = args[0]
    if fault == "dtype":
        bad = t.float()
    elif fault == "non-contiguous":
        bad = t.t().contiguous().t()
    elif fault == "misaligned":  # one element past a 16-byte boundary
        flat = torch.empty(t.numel() + 1, dtype=t.dtype)
        bad = flat[1:].view(t.shape)
        bad.copy_(t)
    else:
        bad = t
    return (bad,) + tuple(args[1:])


@pytest.mark.parametrize("fault,match", [
    ("cpu", "not on a CUDA device"), ("dtype", "must be torch.bfloat16"),
    ("non-contiguous", "contiguous"), ("misaligned", "16-byte aligned")])
@pytest.mark.parametrize("name", ["mm_bn_stats", "bn_apply_fwd",
                                  "bn_apply_bwd_stats", "bn_apply_bwd_dy",
                                  "mm_bn_bwd_dyt", "bn_sums", "bn_relu_fwd",
                                  "bn_relu_bwd_sums", "bn_relu_bwd_dx"])
def test_kernel_wrappers_reject_bad_tensors(name, fault, match):
    """The wrappers raise on what the kernels do not take; none falls back
    to the plain version."""
    kernel = getattr(matmul_bn, name + "_cuda")
    before = kernel.launches
    with pytest.raises(ValueError, match=match):
        kernel(*_fault(_k1b_args()[name], fault))
    assert kernel.launches == before


@pytest.mark.parametrize("fn", ["bn_apply_stats", "bn_apply_fwd_cuda"])
def test_running_update_needs_two_rows(fn):
    """Like nn.BatchNorm2d in training, the running-stat update refuses a
    single row (its unbiased variance divides by R - 1), on the plain path
    and in the kernel wrapper."""
    c = 8
    y = torch.randn((1, c)).bfloat16()
    vec = torch.ones(c)
    running = (torch.zeros(c), torch.ones(c),
               torch.zeros((), dtype=torch.int64), 0.1)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        getattr(matmul_bn, fn)(y, vec, vec, vec, vec, 1e-5, running)
    assert int(running[2]) == 0


# ---------------------------------------------------------------------------
# conv_out_bn, BN(+ReLU) at the ConvBN sites that K1 does not take, against
# the JAX package's _bn_train_fwd / _bn_train_bwd followed by nn.relu.
# _bn_train_fwd casts its input to f32 whatever its dtype (also under x64),
# so the comparison is in f32 at this module's tolerances.

R_SITE = 1037  # no multiple of a chunk (72 or 64 elements) or a block


def _site_inputs(c: int, seed: int):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((R_SITE, c)) * 1.3 + 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.5).astype(np.float32)
    cts = [rng.standard_normal(sh).astype(np.float32)
           for sh in ((R_SITE, c), (c,), (c,))]
    return y, scale, bias, cts


def _jax_site_fwd(y, scale, bias, relu: bool):
    (jy, jmean, jvar), res = jax_hrnet._bn_train_fwd(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    return (jax.nn.relu(jy) if relu else jy), jy, jmean, jvar, res


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [18, 36, 64])
def test_bn_site_fwd_plain_matches_jax(c, relu):
    """The forward sums and the apply (+ReLU) against _bn_train_fwd, and
    the running-stat update with torch semantics (unbiased running
    variance, N/(N-1))."""
    y, scale, bias, _ = _site_inputs(c, c)
    jout, _, jmean, jvar, _ = _jax_site_fwd(y, scale, bias, relu)
    yt = _t(y)
    s = matmul_bn.bn_sums_plain(yt)
    y64 = y.astype(np.float64)
    np.testing.assert_allclose(s.numpy(), np.stack(
        [y64.sum(0), (y64 * y64).sum(0)]), rtol=1e-5)
    rm = torch.linspace(-1.0, 1.0, c)
    rv = torch.linspace(0.5, 2.0, c)
    nbt = torch.zeros((), dtype=torch.int64)
    out, stats = matmul_bn.bn_relu_fwd_plain(yt, s, _t(scale), _t(bias),
                                             1e-5, relu, (rm, rv, nbt, 0.01))
    assert out.dtype == torch.float32 and stats.shape == (3, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    for got, want in ((stats[0], jmean), (stats[1], jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(stats[2].numpy(),
                               1.0 / np.sqrt(np.asarray(jvar) + 1e-5),
                               **FWD)
    n = R_SITE
    np.testing.assert_allclose(
        rm.numpy(), np.linspace(-1.0, 1.0, c) * 0.99
        + 0.01 * np.asarray(jmean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        rv.numpy(), np.linspace(0.5, 2.0, c) * 0.99
        + 0.01 * np.asarray(jvar) * n / (n - 1), rtol=1e-6, atol=1e-7)
    assert int(nbt) == 1


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [18, 36, 64])
def test_bn_site_bwd_plain_matches_jax(c, relu):
    """The backward sums (dbias, dscale) and the dx pass against
    _bn_train_bwd after nn.relu's VJP, cotangents of the batch mean and
    var included; without them, the dx of a zero cotangent."""
    y, scale, bias, cts = _site_inputs(c, 100 + c)
    _, jy, _, _, res = _jax_site_fwd(y, scale, bias, relu)
    dy = cts[0] * (np.asarray(jy) > 0) if relu else cts[0]
    jdx, jdscale, jdbias = jax_hrnet._bn_train_bwd(
        1e-5, res, (jnp.asarray(dy), jnp.asarray(cts[1]),
                    jnp.asarray(cts[2])))
    jdx0, _, _ = jax_hrnet._bn_train_bwd(
        1e-5, res, (jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))
    yt, st, bt, dout = _t(y), _t(scale), _t(bias), _t(cts[0])
    _, stats = matmul_bn.bn_relu_fwd_plain(yt, matmul_bn.bn_sums_plain(yt),
                                           st, bt, 1e-5, relu)
    sums = matmul_bn.bn_relu_bwd_sums_plain(dout, yt, stats, st, bt, relu)
    np.testing.assert_allclose(sums[0].numpy(), np.asarray(jdbias), **GRAD)
    np.testing.assert_allclose(sums[1].numpy(), np.asarray(jdscale), **GRAD)
    dx = matmul_bn.bn_relu_bwd_dx_plain(dout, yt, stats, st, bt, sums, relu,
                                        None, _t(cts[1]), _t(cts[2]))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD)
    dx0 = matmul_bn.bn_relu_bwd_dx_plain(dout, yt, stats, st, bt, sums, relu)
    np.testing.assert_allclose(dx0.numpy(), np.asarray(jdx0), **GRAD)


@pytest.mark.parametrize("relu", [False, True])
def test_conv_out_bn_matches_jax(relu):
    """The autograd Function whole on CPU tensors (the plain versions; no
    kernel launches): out, dy, dscale and dbias against jax.vjp of
    _bn_train_apply (+ nn.relu), with one cotangent on the output."""
    c = 36
    y, scale, bias, cts = _site_inputs(c, 7)

    def f(a, s, b):
        out = jax_hrnet._bn_train_apply(a, s, b, 1e-5)[0]
        return jax.nn.relu(out) if relu else out

    jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (y, scale, bias)))
    jdy, jdscale, jdbias = vjp(jnp.asarray(cts[0]))
    yt, st, bt = _t(y, True), _t(scale, True), _t(bias, True)
    kernels = (matmul_bn.bn_sums_cuda, matmul_bn.bn_relu_fwd_cuda,
               matmul_bn.bn_relu_bwd_sums_cuda, matmul_bn.bn_relu_bwd_dx_cuda)
    before = [k.launches for k in kernels]
    out = matmul_bn.conv_out_bn(yt, st, bt, 1e-5, relu)
    out.backward(_t(cts[0]))
    assert [k.launches for k in kernels] == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    for got, want in ((yt.grad, jdy), (st.grad, jdscale), (bt.grad, jdbias)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
