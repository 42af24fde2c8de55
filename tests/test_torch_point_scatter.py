"""The plain versions of K56a and K56b, the two kernels that K5's and K6's
backwards share (hcmoco_tpu_torch/ops/point_gather.py): `dest_csr_plain`,
each destination's source positions in ascending order, and
`segment_rows_sum_plain`, each destination's sources added in that order
in f32 and rounded once.

Over `dest_csr_plain`, `segment_rows_sum_plain` equals the plain backwards
(`group_rows_bwd_plain`, `interpolate_rows_bwd_plain`, built on the CPU's
`scatter_add_`) bit for bit, in f32 and bf16: that pins the order of the
adds that the CUDA kernels follow, and so their exact equality with the
plain versions on the card (tests/test_torch_point_kernels.py).  The
inputs mix magnitudes from 1e-3 to 1e3, so that another order of the adds
would show, and hold an all-zero cloud's indices (every source on the
first S, or 3, table rows) and empty buckets.  Against the JAX package's
gradients of its XLA gather (another order of the f32 adds): rtol/atol
1e-5 of the summed magnitudes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.ops import point_ops as jax_ops

from hcmoco_tpu_torch.ops import point_gather as pg
from hcmoco_tpu_torch.ops import point_ops

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def _gidx(rng, b, m, s, n):
    """Ball-query-like indices; the last sample a zero cloud's: 0..S-1 for
    every center.  Rows n-8.. get no source (empty buckets)."""
    g = rng.integers(0, n - 8, (b, m, s))
    g[-1] = np.arange(s)
    return torch.from_numpy(g.astype(np.int32))


def _idx_w(rng, b, n, m):
    """Three-NN-like indices and weights; the last sample a zero cloud's:
    0, 1, 2 at weight 1/3."""
    idx = rng.integers(0, m - 4, (b, n, 3))
    w = rng.random((b, n, 3)) + 1e-3
    w = w / w.sum(-1, keepdims=True)
    idx[-1] = np.arange(3)
    w[-1] = 1 / 3
    return (torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(w.astype(np.float32)))


def _rows(rng, shape, dtype):
    """N(0, 1) scaled by 10^U(-3, 3): sums whose rounding depends on the
    order of the adds."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("case", ["random", "zero_cloud", "one_row"])
def test_dest_csr_plain_lists_sources_in_order(case):
    rng = np.random.default_rng(0)
    b, r, n = 3, 1000, 37
    idx = rng.integers(0, n - 5, (b, r))
    if case == "zero_cloud":
        idx[-1] = np.arange(r) % 4
    elif case == "one_row":
        idx[:] = 7
    idx = torch.from_numpy(idx.astype(np.int32))
    start, src = pg.dest_csr_plain(idx, n)
    assert start.dtype == src.dtype == torch.int32
    assert start.shape == (b, n + 1) and src.shape == (b, r)
    for i in range(b):
        counts = torch.bincount(idx[i].long(), minlength=n)
        assert torch.equal(start[i, 1:] - start[i, :-1], counts.int())
        assert int(start[i, 0]) == 0 and int(start[i, -1]) == r
        for d in range(n):
            bucket = src[i, start[i, d]:start[i, d + 1]].long()
            want = torch.nonzero(idx[i] == d).flatten()
            assert torch.equal(bucket, want)


def test_plain_scatter_adds_in_source_order():
    """The plain backward (the CPU's scatter_add_) adds each destination's
    sources one at a time in ascending source order, in f32: equal to a
    sequential loop of f32 adds."""
    rng = np.random.default_rng(1)
    gidx = _gidx(rng, 2, 64, 8, 16)
    gout = _rows(rng, (2, 64, 8, 3), torch.float32)
    got = pg.group_rows_bwd_plain(gout, gidx, 16).numpy()
    want = np.zeros((2, 16, 3), np.float32)
    g, idx = gout.reshape(2, -1, 3).numpy(), gidx.reshape(2, -1).numpy()
    for i in range(2):
        for r in range(idx.shape[1]):
            want[i, idx[i, r]] = want[i, idx[i, r]] + g[i, r]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,s,n,c", [(64, 16, 128, 8), (32, 32, 64, 18)])
def test_segment_sum_equals_group_rows_bwd_plain(dtype, m, s, n, c):
    rng = np.random.default_rng(2)
    gidx = _gidx(rng, 3, m, s, n)
    gout = _rows(rng, (3, m, s, c), dtype)
    start, src = pg.dest_csr_plain(gidx.reshape(3, -1), n)
    got = pg.segment_rows_sum_plain(gout.reshape(3, m * s, c), start, src, n)
    want = pg.group_rows_bwd_plain(gout, gidx, n)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not got[:, n - 8:].any()  # empty buckets are zeros


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,c", [(256, 64, 8), (128, 128, 18)])
def test_segment_sum_equals_interpolate_rows_bwd_plain(dtype, n, m, c):
    rng = np.random.default_rng(3)
    idx, w = _idx_w(rng, 3, n, m)
    gout = _rows(rng, (3, n, c), dtype)
    start, src = pg.dest_csr_plain(idx.reshape(3, -1), m)
    got = pg.segment_rows_sum_plain(gout, start, src, m, w)
    want = pg.interpolate_rows_bwd_plain(gout, idx, w, m)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not got[:, m - 4:].any()


def test_segment_sum_matches_jax_gradients():
    """K5's and K6's backwards, as K56a + K56b, against the gradients of
    the JAX package's XLA gathers on the same inputs."""
    rng = np.random.default_rng(4)
    b, m, s, n, c = 3, 64, 16, 128, 8
    gidx = _gidx(rng, b, m, s, n)
    table = rng.standard_normal((b, n, c)).astype(np.float32)
    cot = _rows(rng, (b, m, s, c), torch.float32)
    want = jax.grad(lambda t: jnp.sum(jax_ops.group_points(
        t, jnp.asarray(gidx.numpy())) * cot.numpy()))(jnp.asarray(table))
    start, src = pg.dest_csr_plain(gidx.reshape(b, -1), n)
    got = pg.segment_rows_sum_plain(cot.reshape(b, -1, c), start, src, n)
    scale = pg.group_rows_bwd_plain(cot.abs(), gidx, n).numpy()
    assert (np.abs(got.numpy() - np.asarray(want))
            <= 1e-5 * scale + 1e-5).all()

    idx, w = _idx_w(rng, b, n, m)
    feats = rng.standard_normal((b, m, c)).astype(np.float32)
    cot = _rows(rng, (b, n, c), torch.float32)
    want = jax.grad(lambda f: jnp.sum(jax_ops.three_interpolate(
        f, jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()))
        * cot.numpy()))(jnp.asarray(feats))
    start, src = pg.dest_csr_plain(idx.reshape(b, -1), m)
    got = pg.segment_rows_sum_plain(cot, start, src, m, w)
    scale = pg.interpolate_rows_bwd_plain(cot.abs(), idx, w, m).numpy()
    assert (np.abs(got.numpy() - np.asarray(want))
            <= 1e-5 * scale + 1e-5).all()


@pytest.mark.parametrize("kind", ["K5", "K6"])
@pytest.mark.parametrize("n_dest", [8193, 16384, 65537])
def test_plain_backwards_past_8192_destinations(n_dest, kind):
    """Past K56a's former 8192-destination limit (HRNetPN above 8192
    points): `dest_csr_plain` lists each destination's sources in
    ascending order, `segment_rows_sum_plain` over it equals the plain
    backward bit for bit, and both agree with the gradient of the JAX
    package's XLA gather.  Two samples: random indices (the last 8 rows
    get none) and a zero cloud's (K5: every center's slots 0..S-1; K6:
    every pixel's rows 0, 1 and 2)."""
    rng = np.random.default_rng(n_dest)
    b, c = 2, 2
    if kind == "K5":
        m, s = 512, 32
        idx = _gidx(rng, b, m, s, n_dest)
        cot = _rows(rng, (b, m, s, c), torch.float32)
        plain = pg.group_rows_bwd_plain(cot, idx, n_dest)
        rows, w = cot.reshape(b, -1, c), None
        table = rng.standard_normal((b, n_dest, c)).astype(np.float32)
        want = jax.grad(lambda t: jnp.sum(jax_ops.group_points(
            t, jnp.asarray(idx.numpy())) * cot.numpy()))(jnp.asarray(table))
        scale = pg.group_rows_bwd_plain(cot.abs(), idx, n_dest)
    else:
        n = 1024
        idx = torch.from_numpy(rng.integers(0, n_dest - 8, (b, n, 3)).astype(
            np.int32))
        idx[-1] = torch.arange(3, dtype=torch.int32)
        w = torch.from_numpy(rng.random((b, n, 3)).astype(np.float32) + 1e-3)
        w = w / w.sum(-1, keepdim=True)
        cot = _rows(rng, (b, n, c), torch.float32)
        plain = pg.interpolate_rows_bwd_plain(cot, idx, w, n_dest)
        rows = cot
        feats = rng.standard_normal((b, n_dest, c)).astype(np.float32)
        want = jax.grad(lambda f: jnp.sum(jax_ops.three_interpolate(
            f, jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()))
            * cot.numpy()))(jnp.asarray(feats))
        scale = pg.interpolate_rows_bwd_plain(cot.abs(), idx, w, n_dest)
    flat = idx.reshape(b, -1)
    start, src = pg.dest_csr_plain(flat, n_dest)
    r = flat.shape[1]
    for i in range(b):
        counts = torch.bincount(flat[i].long(), minlength=n_dest)
        assert torch.equal(start[i, 1:] - start[i, :-1], counts.int())
        # sorted by (destination, position): each bucket ascending
        key = flat[i].long()[src[i].long()] * r + src[i].long()
        assert bool((key[1:] > key[:-1]).all())
    got = pg.segment_rows_sum_plain(rows, start, src, n_dest, w)
    assert torch.equal(got, plain)
    assert not got[0, n_dest - 8:].any()
    assert (np.abs(got.numpy() - np.asarray(want))
            <= 1e-5 * scale.numpy() + 1e-5).all()


_IDX = torch.zeros((2, 12), dtype=torch.int32)
_ROWS = torch.zeros((2, 4, 8))
_START = torch.zeros((2, 9), dtype=torch.int32)
WRAPPERS = {
    "dest_csr": lambda: pg.dest_csr_cuda(_IDX, 8),
    "segment_rows_sum": lambda: pg.segment_rows_sum_cuda(
        torch.zeros((2, 12, 8)), _START, _IDX, 8),
    "segment_rows_sum weighted": lambda: pg.segment_rows_sum_cuda(
        _ROWS, _START, _IDX, 8, torch.zeros((2, 4, 3))),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_k56_wrappers_reject_cpu_tensors(name):
    with pytest.raises(ValueError, match="not on a CUDA device"):
        WRAPPERS[name]()


def test_cpu_backwards_launch_no_k56_kernel():
    rng = np.random.default_rng(5)
    before = (pg.dest_csr_cuda.launches, pg.segment_rows_sum_cuda.launches)
    t = _rows(rng, (2, 32, 4), torch.float32).requires_grad_()
    point_ops.group_points(t, _gidx(rng, 2, 8, 4, 32)).sum().backward()
    idx, w = _idx_w(rng, 2, 16, 32)
    f = _rows(rng, (2, 32, 4), torch.float32).requires_grad_()
    point_ops.three_interpolate(f, idx, w).sum().backward()
    assert (pg.dest_csr_cuda.launches,
            pg.segment_rows_sum_cuda.launches) == before
