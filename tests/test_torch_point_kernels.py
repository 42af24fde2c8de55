"""K2-K6's CUDA kernels held against their plain PyTorch versions on the
card (`cuda`-marked: they skip without a CUDA device; run on the card with
`python -m pytest -m cuda tests/test_torch_point_kernels.py`).  This file
imports no JAX, so it runs where only PyTorch is installed.

Inputs: N(0, 0.3^2) clouds of up to 4096 points with an all-zero sample
(the cloud of an image without depth).  Indices and distances equal (the
kernels compute d2 without FMA contraction, as the plain versions round
it); forward gathers exact; the f32 atomic scatter-adds within rtol/atol
1e-5 in f32 (the atomics add in another order on every run) and, in bf16,
within one bf16 rounding (rtol 1.6e-2).
"""

import pytest
import torch

from hcmoco_tpu_torch.ops import ball_query as bq
from hcmoco_tpu_torch.ops import fps as fp
from hcmoco_tpu_torch.ops import point_gather as pg
from hcmoco_tpu_torch.ops import point_ops
from hcmoco_tpu_torch.ops import three_nn as tn


def _card_cloud(b=4, n=4096, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3), generator=g, device="cuda") * 0.3
    x[-1] = 0.0
    return x


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")


@pytest.mark.cuda
def test_fps_kernel_matches_plain_on_card():
    _need_card()
    for n, m in ((4096, 1024), (1024, 256), (256, 64), (37, 5)):
        x = _card_cloud(n=n)
        assert torch.equal(fp.fps_cuda(x, m), fp.fps_plain(x, m))


@pytest.mark.cuda
def test_ball_query_kernel_matches_plain_on_card():
    _need_card()
    x = _card_cloud()
    for m, r, s in ((4096, 0.025, 16), (1024, 0.125, 32), (64, 1.0, 32)):
        c = x[:, :m].contiguous()
        assert torch.equal(bq.ball_query_cuda(x, c, r, s),
                           bq.ball_query_plain(x, c, r, s))


@pytest.mark.cuda
def test_three_nn_kernel_matches_plain_on_card():
    _need_card()
    x = _card_cloud()
    for m in (4096, 1024, 64, 2):
        k = x[:, :m].contiguous()
        d, i = tn.three_nn_cuda(x, k)
        pd, pi = tn.three_nn_plain(x, k)
        assert torch.equal(i, pi) and torch.equal(d, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_point_gather_kernels_match_plain_on_card(dtype):
    """Forwards exact; the f32 atomic scatter-adds within f32 summation
    order (then one rounding to bf16)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    b, n, m, s, c = 4, 1024, 256, 32, 64
    table = torch.randn((b, n, c), generator=g, device="cuda").to(dtype)
    gidx = torch.randint(0, n, (b, m, s), generator=g, device="cuda",
                         dtype=torch.int32)
    gidx[-1] = torch.arange(s, device="cuda", dtype=torch.int32)
    gout = torch.randn((b, m, s, c), generator=g, device="cuda").to(dtype)
    assert torch.equal(pg.group_rows_cuda(table, gidx),
                       pg.group_rows_plain(table, gidx))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(pg.group_rows_bwd_cuda(gout, gidx, n),
                               pg.group_rows_bwd_plain(gout, gidx, n), **tol)
    d, idx = tn.three_nn_cuda(_card_cloud(n=n), _card_cloud(n=m))
    w = point_ops.interpolation_weights(d)
    feat = table[:, :m].contiguous()
    assert torch.equal(pg.interpolate_rows_cuda(feat, idx, w),
                       pg.interpolate_rows_plain(feat, idx, w))
    go = gout[:, :, 0].reshape(b, m, c).repeat(1, n // m, 1).contiguous()
    torch.testing.assert_close(
        pg.interpolate_rows_bwd_cuda(go, idx, w, m),
        pg.interpolate_rows_bwd_plain(go, idx, w, m), **tol)
