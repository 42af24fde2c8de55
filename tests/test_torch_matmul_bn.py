"""K1's plain PyTorch version and bn_apply_stats held against hcmoco_tpu's
ops/pallas/matmul_bn.py (Pallas in interpret mode) in f32 on the CPU.

Tolerances: forward rtol/atol 1e-5; grads rtol 5e-4, atol 5e-5 (the
tolerance of tests/test_models.py::TestConvBNFuse), as only the summation
order differs.  The CUDA kernel itself is compared with this plain version
on the card by chip_smoke.py, and by the `cuda`-marked test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
