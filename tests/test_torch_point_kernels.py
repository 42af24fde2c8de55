"""K2-K6's CUDA kernels held against their plain PyTorch versions on the
card (`cuda`-marked: they skip without a CUDA device; run on the card with
`python -m pytest -m cuda tests/test_torch_point_kernels.py`).  This file
imports no JAX, so it runs where only PyTorch is installed.

Inputs: N(0, 0.3^2) clouds of up to 4096 points with an all-zero sample
(the cloud of an image without depth).  Indices and distances equal (the
kernels compute d2 without FMA contraction, as the plain versions round
it); forward gathers exact; the backwards (K56a's destination index, then
K56b's sums in ascending source order) equal the plain versions computed
on CPU copies, bit for bit, and two launches equal each other.
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


def _equal_twice(fn, want):
    """fn() equals `want` (computed on the CPU) bit for bit, twice."""
    a, b = fn(), fn()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_point_gather_kernels_match_plain_on_card(dtype):
    """Forwards exact; backwards equal to the plain versions on the CPU and
    identical over two launches."""
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
    _equal_twice(lambda: pg.group_rows_bwd_cuda(gout, gidx, n),
                 pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(), n))
    d, idx = tn.three_nn_cuda(_card_cloud(n=n), _card_cloud(n=m))
    w = point_ops.interpolation_weights(d)
    feat = table[:, :m].contiguous()
    assert torch.equal(pg.interpolate_rows_cuda(feat, idx, w),
                       pg.interpolate_rows_plain(feat, idx, w))
    go = gout[:, :, 0].reshape(b, m, c).repeat(1, n // m, 1).contiguous()
    _equal_twice(lambda: pg.interpolate_rows_bwd_cuda(go, idx, w, m),
                 pg.interpolate_rows_bwd_plain(go.cpu(), idx.cpu(), w.cpu(),
                                               m))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty_buckets", "zero_cloud",
                                  "ragged_tile"])
def test_dest_csr_kernel_matches_plain_on_card(case):
    """K56a against `dest_csr_plain`: start and src equal."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    b, r, n = {"random": (4, 32768, 1024), "empty_buckets": (3, 5000, 4096),
               "zero_cloud": (2, 131072, 4096),
               "ragged_tile": (3, 3 * 4096 + 37, 1024)}[case]
    hi = n // 3 if case == "empty_buckets" else n
    idx = torch.randint(0, hi, (b, r), generator=g, device="cuda",
                        dtype=torch.int32)
    if case == "zero_cloud":  # K5 at sa0: every center's slots 0..31
        idx[-1] = torch.arange(r, device="cuda", dtype=torch.int32) % 32
    start, src = pg.dest_csr_cuda(idx, n)
    pstart, psrc = pg.dest_csr_plain(idx.cpu(), n)
    assert torch.equal(start.cpu(), pstart)
    assert torch.equal(src.cpu(), psrc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 18, 512])
def test_backward_kernels_match_plain_on_card(dtype, c):
    """K5's and K6's backwards (K56a + K56b) with a zero-cloud sample and
    empty buckets, at C = 32 (K5 at sa0: R = 131072 sources a sample), 18
    (the one-element path) and 512 (K6 at fp1's shapes): equal to the plain
    versions on the CPU and over two launches."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    b, n, m, s = 2, 4096, 4096, 32
    if c == 512:
        m, s = 1024, 4  # the fp1 shapes; R = 3 * 4096 for K6 below
    gidx = torch.randint(0, n - 64, (b, m, s), generator=g, device="cuda",
                         dtype=torch.int32)
    gidx[-1] = torch.arange(s, device="cuda", dtype=torch.int32)
    gout = torch.randn((b, m, s, c), generator=g, device="cuda")
    gout = (gout * 10.0 ** (6 * torch.rand(gout.shape, generator=g,
                                           device="cuda") - 3)).to(dtype)
    _equal_twice(lambda: pg.group_rows_bwd_cuda(gout, gidx, n),
                 pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(), n))
    k = 1024
    idx = torch.randint(0, k - 16, (b, n, 3), generator=g, device="cuda",
                        dtype=torch.int32)
    idx[-1] = torch.arange(3, device="cuda", dtype=torch.int32)
    w = torch.rand((b, n, 3), generator=g, device="cuda") + 1e-3
    w = w / w.sum(-1, keepdim=True)
    go = gout.reshape(b, -1, c)[:, :n].contiguous()
    _equal_twice(lambda: pg.interpolate_rows_bwd_cuda(go, idx, w, k),
                 pg.interpolate_rows_bwd_plain(go.cpu(), idx.cpu(), w.cpu(),
                                               k))
