"""The pieces of the port's data parallelism that need no process group,
JAX-free so that the card-only case runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_parallel_kernels.py

* parallel/mesh.py: which rows of the global batch a rank holds (with and
  without microbatches), and that every collective is an identity in a
  world of one;
* K1b's normaliser: its plain version (and on the card its kernel) run on
  one rank's rows with the global batch's channel sums and row count,
  held to the one-process result on the whole batch.  The forward is the
  same arithmetic row by row, so it is equal bit for bit; the backward's
  column sums over the halves add up to the whole batch's within f32
  rounding (rtol 1e-6 of each channel's sum of magnitudes).
"""

import numpy as np
import pytest
import torch

from hcmoco_tpu_torch.ops import matmul_bn
from hcmoco_tpu_torch.parallel import mesh


@pytest.mark.parametrize("bsz,size,micro,want", [
    (8, 2, 1, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (8, 2, 2, [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (12, 3, 2, [[0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11]]),
    (4, 1, 2, [[0, 1, 2, 3]]),
])
def test_shard_positions(bsz, size, micro, want):
    """Rank r's i-th microbatch chunk is its share of global microbatch i
    (rows [i B/n, (i+1) B/n)); the ranks' rows partition the batch."""
    got = [mesh.shard_positions(bsz, r, size, micro).tolist()
           for r in range(size)]
    assert got == want
    assert sorted(sum(got, [])) == list(range(bsz))


def test_shard_positions_refuses_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_positions(6, 0, 4)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_positions(8, 0, 2, microbatch=8)


def test_shard_rows_numpy_and_torch():
    batch = {"a": np.arange(8).reshape(8, 1), "b": torch.arange(16).view(8, 2)}
    got = mesh.shard_rows(batch, 1, 2, microbatch=2)
    assert got["a"][:, 0].tolist() == [2, 3, 6, 7]
    assert got["b"][:, 0].tolist() == [4, 6, 12, 14]
    assert mesh.shard_rows(batch, 0, 1) is batch


def test_world_of_one_is_the_identity():
    """Without a process group every collective returns its input and the
    rank's share of a draw is all of it."""
    assert mesh.world() == (0, 1)
    t = torch.randn(4, 3, requires_grad=True)
    for fn in (mesh.all_reduce_sum, mesh.global_sum, mesh.gather_rows,
               mesh.gather_rows_grad):
        assert fn(t) is t
    assert mesh.my_rows(6) == slice(0, 6)
    mesh.broadcast_([t])
    mesh.barrier()


def _bn_inputs(r, c, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    y = (torch.randn((r, c), generator=g, device=device) * 1.3 + 0.2)
    y = y.bfloat16()
    scale = torch.rand((c,), generator=g, device=device) + 0.5
    bias = torch.randn((c,), generator=g, device=device)
    dout = torch.randn((r, c), generator=g, device=device).bfloat16()
    return y, scale, bias, dout


@pytest.mark.parametrize("r,c", [(64, 18), (96, 64)])
def test_k1b_plain_normaliser_matches_one_process(r, c):
    """Two ranks' halves of y with the all-reduced sums and n = R: the
    forward (out, mean, var, rstd and the running update) equals the
    one-process forward on the whole y bit for bit, and the backward's
    dscale, dbias, ds1, ds2 summed over the halves match the one-process
    ones."""
    y, scale, bias, dout = _bn_inputs(r, c)
    s1, s2 = y.float().sum(0), (y.float() ** 2).sum(0)
    whole = matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5)
    run_whole = (torch.zeros(c), torch.ones(c), torch.zeros((), dtype=torch.long), 0.1)
    matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5, run_whole)
    halves = y.chunk(2)
    outs = []
    for h in halves:
        run = (torch.zeros(c), torch.ones(c),
               torch.zeros((), dtype=torch.long), 0.1)
        got = matmul_bn.bn_apply_fwd_plain(h, s1, s2, scale, bias, 1e-5, run,
                                           n=r)
        for a, b in zip(got[1:], whole[1:]):
            assert torch.equal(a, b)
        for a, b in zip(run[:3], run_whole[:3]):
            assert torch.equal(a, b)
        outs.append(got[0])
    assert torch.equal(torch.cat(outs), whole[0])

    zero = torch.zeros(c)
    mean, var, rstd = whole[1:]
    want = matmul_bn.bn_apply_bwd_stats_plain(dout, y, s1, mean, var, rstd,
                                              scale, zero, zero)
    parts = [matmul_bn.bn_apply_bwd_stats_plain(d, h, s1, mean, var, rstd,
                                                scale, zero, zero, n=r)
             for d, h in zip(dout.chunk(2), halves)]
    mag = dout.double().abs().sum(0) + 1.0
    for i in range(4):
        total = parts[0][i].double() + parts[1][i].double()
        scale_i = mag if i < 2 else mag / r
        assert bool(((total - want[i].double()).abs()
                     <= 1e-6 * scale_i).all()), i


def test_bn_apply_stats_default_normaliser_is_the_rows():
    """n=None is y's row count: the parent's behaviour."""
    y, scale, bias, _ = _bn_inputs(40, 8)
    s1, s2 = y.float().sum(0), (y.float() ** 2).sum(0)
    a = matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5)
    b = matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5, n=40)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(102400, 64), (6400 + 37, 18)])
def test_k1b_kernel_normaliser_on_card(r, c):
    """Run on the card only: K1b's forward and backward-sums kernels on
    one rank's half of y (split rows) with the whole batch's sums and
    n = 2 * rows, against their plain versions on the same inputs (out
    within 1 bf16 ulp, mean/var/rstd within 1 f32 ulp, dbias/dscale within
    2e-5 of the sums of magnitudes, ds1/ds2 within 1e-4 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    y, scale, bias, dout = _bn_inputs(2 * r, c, device="cuda")
    s1, s2 = y.float().sum(0), (y.float() ** 2).sum(0)
    half, dhalf = y[:r].contiguous(), dout[:r].contiguous()
    got = matmul_bn.bn_apply_fwd_cuda(half, s1, s2, scale, bias, 1e-5, n=2 * r)
    want = matmul_bn.bn_apply_fwd_plain(half, s1, s2, scale, bias, 1e-5,
                                        n=2 * r)
    assert _ulp_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _ulp_close(a, b, bits=24)
    zero = torch.zeros(c, device="cuda")
    args = (dhalf, half, s1, want[1], want[2], want[3], scale, zero, zero)
    k = matmul_bn.bn_apply_bwd_stats_cuda(*args, n=2 * r)
    p = matmul_bn.bn_apply_bwd_stats_plain(*args, n=2 * r)
    mag = dhalf.double().abs().sum(0)
    for i in (0, 1):
        assert bool(((k[i].double() - p[i].double()).abs()
                     <= 2e-5 * mag + 1e-6).all())
    for i in (2, 3):
        torch.testing.assert_close(k[i], p[i], rtol=1e-4, atol=1e-9)


def _ulp_close(got, want, bits=8):
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - bits)
    return bool(((got.float() - want.float()).abs() <= ulp).all())
