"""The port's point ops (kernels K2-K6; on a CPU tensor each takes its plain
PyTorch version) held against hcmoco_tpu's point ops: its XLA formulations
and its Pallas kernels in interpret mode, at the shapes of
tests/test_point_ops.py, test_window_group.py and test_window_interp.py.

Every cloud batch holds an all-zero sample, the cloud depth2pts gives an
image without depth: FPS then picks index 0 every round, the ball query
fills 0..S-1 and three-NN returns 0, 1, 2 at distance 0 (weights 1/3).

Tolerances: indices and squared distances equal (both sides compute
((dx*dx + dy*dy) + dz*dz) in f32); forward gathers equal in f32 and within
one bf16 ulp in bf16 (the port and the Pallas kernel sum the three
weighted rows in f32, then round once); gradients (scatter-adds, f32 sums
in another order) rtol/atol 1e-6.  The CUDA kernels are held against
these plain versions on the card by the `cuda`-marked tests of
tests/test_torch_point_kernels.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.ops import point_ops as jax_ops
from hcmoco_tpu.ops.pallas.ball_query import ball_query_windowed
from hcmoco_tpu.ops.pallas.window_group import window_group
from hcmoco_tpu.ops.pallas.window_interp import window_interpolate

from hcmoco_tpu_torch.ops import ball_query as bq
from hcmoco_tpu_torch.ops import fps as fp
from hcmoco_tpu_torch.ops import point_gather as pg
from hcmoco_tpu_torch.ops import point_ops
from hcmoco_tpu_torch.ops import three_nn as tn

torch.set_num_threads(1)

GRAD = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(b=3, n=128, seed=0):
    """(b, n, 3) N(0, 1) points; the last sample all zeros."""
    c = np.random.default_rng(seed).standard_normal((b, n, 3)).astype(
        np.float32)
    c[-1] = 0.0
    return c


@pytest.fixture
def cloud():
    return _cloud()


# ---- K2 furthest point sampling ----------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("npoint", [16, 128])
def test_fps_matches_jax(cloud, impl, npoint):
    want = np.asarray(jax_ops.furthest_point_sample(jnp.asarray(cloud),
                                                    npoint, impl=impl))
    got = point_ops.furthest_point_sample(_t(cloud), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[-1].any()  # the zero cloud: index 0 every round


def test_fps_identity_shortcut_matches_jax(cloud):
    want = jax_ops.furthest_point_sample(jnp.asarray(cloud), 128,
                                         allow_identity=True)
    got = point_ops.furthest_point_sample(_t(cloud), 128,
                                          allow_identity=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- K3 ball query -----------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("radius,nsample", [(0.8, 8), (0.3, 16)])
def test_ball_query_matches_jax(cloud, impl, radius, nsample):
    """(0.3, 16) leaves most centers with fewer hits than slots."""
    centers = cloud[:, ::4]
    want = np.asarray(jax_ops.ball_query(jnp.asarray(cloud),
                                         jnp.asarray(centers), radius,
                                         nsample, impl=impl))
    got = point_ops.ball_query(_t(cloud), _t(centers), radius, nsample)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[-1] == torch.arange(nsample, dtype=torch.int32)).all()


def test_ball_query_no_hit_gives_zero():
    xyz = np.zeros((1, 8, 3), np.float32)
    centers = np.full((1, 2, 3), 5.0, np.float32)
    want = np.asarray(jax_ops.ball_query(jnp.asarray(xyz),
                                         jnp.asarray(centers), 1.0, 4))
    got = point_ops.ball_query(_t(xyz), _t(centers), 1.0, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_ball_query_matches_windowed_kernel():
    """The windowed Pallas pair on the raster-sorted cloud of
    tests/test_point_ops.py::TestBallQueryWindowed, plus a point that
    violates the window (its exact fallback)."""
    rng = np.random.default_rng(0)
    b, n = 2, 1024
    x = np.arange(n, dtype=np.float32)[None, :] * 0.01
    yz = rng.standard_normal((b, n, 2)).astype(np.float32) * 0.02
    cloud = np.concatenate([np.broadcast_to(x, (b, n))[..., None], yz], -1)
    for violate in (False, True):
        if violate:
            cloud[0, 900] = cloud[0, 10]
        centers = np.ascontiguousarray(cloud[:, ::2])
        want = np.asarray(ball_query_windowed(
            jnp.asarray(cloud), jnp.asarray(centers), 0.3, 8, 50))
        got = point_ops.ball_query(_t(cloud), _t(centers), 0.3, 8)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- K4 three nearest neighbours ---------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_three_nn_matches_jax(cloud, impl):
    known = np.ascontiguousarray(cloud[:, ::4])
    wd, wi = jax_ops.three_nn(jnp.asarray(cloud), jnp.asarray(known),
                              impl=impl)
    dist, idx = point_ops.three_nn(_t(cloud), _t(known))
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    # XLA:CPU contracts the interpreted kernel's d2 + diff*diff into FMAs,
    # which moves its distances by an ulp; the XLA path's are exact
    tol = dict(rtol=0, atol=0) if impl == "xla" else dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(dist.numpy(), np.asarray(wd), **tol)
    assert (idx[-1] == torch.arange(3, dtype=torch.int32)).all()
    assert not dist[-1].any()
    w = point_ops.interpolation_weights(dist)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jax_ops.interpolation_weights(wd)), **tol)
    torch.testing.assert_close(w[-1], torch.full_like(w[-1], 1 / 3))


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_pads_below_three_known(cloud, m):
    """M < 3: the missing neighbours at float32 max, index 0, weight 0."""
    known = np.ascontiguousarray(cloud[:, :m])
    wd, wi = jax_ops.three_nn(jnp.asarray(cloud), jnp.asarray(known))
    dist, idx = point_ops.three_nn(_t(cloud), _t(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(wd))
    assert (dist[..., m:] == tn.F32_MAX).all()
    w = point_ops.interpolation_weights(dist)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jax_ops.interpolation_weights(wd)))
    assert not w[..., m:].any()


def test_gather_points_matches_jax(cloud):
    idx = np.random.default_rng(1).integers(0, 128, (3, 40)).astype(np.int32)
    want = jax_ops.gather_points(jnp.asarray(cloud), jnp.asarray(idx))
    got = point_ops.gather_points(_t(cloud), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- K5 row gather (grouping) ------------------------------------------------


def _local_gidx(rng, b, m, s, n, spread):
    """Indices within +-spread of the linear center base (in the window of
    tests/test_window_group.py), the last sample's all 0..S-1 as a zero
    cloud's ball query gives them."""
    base = (np.arange(m) * (n // m))[None, :, None]
    g = np.clip(base + rng.integers(-spread, spread + 1, (b, m, s)), 0, n - 1)
    g[-1] = np.arange(s)
    return g.astype(np.int32)


def _check_rowuniform_grads(got, want_window, want_xla):
    """All samples' gradients against the XLA scatter-add; against the
    windowed kernel all but the last, row-uniform sample, whose gradient the
    kernel deposits on clamped rows (its per-row sum is kept)."""
    np.testing.assert_allclose(got, np.asarray(want_xla), **GRAD)
    want_window = np.asarray(want_window)
    np.testing.assert_allclose(got[:-1], want_window[:-1], **GRAD)
    np.testing.assert_allclose(got[-1].sum(0), want_window[-1].sum(0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,s,c", [(256, 256, 4, 8), (256, 64, 4, 24)])
def test_group_rows_matches_window_group(n, m, s, c):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((3, n, c)).astype(np.float32)
    table[-1] = table[-1, :1]  # a zero cloud's table: every row alike
    gidx = _local_gidx(rng, 3, m, s, n, spread=12)
    cot = rng.standard_normal((3, m, s, c)).astype(np.float32)

    def window(t):
        return window_group(t, jnp.asarray(gidx), window=16, tm=8,
                            force=True)

    def xla(t):
        return jax_ops.group_points(t, jnp.asarray(gidx))

    want = window(jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(xla(jnp.asarray(table))))
    grads = [jax.grad(lambda t: jnp.sum(fn(t) * cot))(jnp.asarray(table))
             for fn in (window, xla)]
    t = _t(table).requires_grad_()
    got = point_ops.group_points(t, _t(gidx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * _t(cot)).sum().backward()
    _check_rowuniform_grads(t.grad.numpy(), *grads)


def test_group_rows_bf16_gradient_sums_in_f32():
    """A bf16 table's gradient is summed in f32 and rounded once: equal to
    the f32 sum of the same bf16 cotangents, rounded to bf16."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((2, 64, 8)).astype(
        np.float32)).bfloat16().requires_grad_()
    gidx = torch.from_numpy(rng.integers(0, 64, (2, 32, 16)).astype(np.int32))
    cot = torch.from_numpy(rng.standard_normal((2, 32, 16, 8)).astype(
        np.float32)).bfloat16()
    (point_ops.group_points(table, gidx) * cot).sum().backward()
    want = pg.group_rows_bwd_plain(cot.float(), gidx, 64).bfloat16()
    assert table.grad.dtype == torch.bfloat16
    assert torch.equal(table.grad, want)


# ---- K6 weighted three-row gather (interpolation) ----------------------------


def _local_idx_wgt(rng, b, n, m, spread):
    """3-NN-like indices near floor(q*M/N) (test_window_interp.py), the last
    sample's all 0, 1, 2 at weight 1/3 as on a zero cloud."""
    base = ((np.arange(n) * m) // n)[None, :, None]
    idx = np.clip(base + rng.integers(-spread, spread + 1, (b, n, 3)), 0,
                  m - 1).astype(np.int32)
    w = rng.random((b, n, 3)).astype(np.float32) + 1e-3
    w = w / w.sum(-1, keepdims=True)
    idx[-1] = np.arange(3)
    w[-1] = np.float32(1 / 3)
    return idx, w


@pytest.mark.parametrize("n,m,c", [(256, 64, 8), (256, 256, 16)])
def test_interpolate_rows_matches_window_interpolate(n, m, c):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, m, c)).astype(np.float32)
    feats[-1] = feats[-1, :1]  # a zero cloud's features: every row alike
    idx, w = _local_idx_wgt(rng, 3, n, m, spread=10)
    cot = rng.standard_normal((3, n, c)).astype(np.float32)

    def window(f):
        return window_interpolate(f, jnp.asarray(idx), jnp.asarray(w),
                                  window=16, tn=64, force=True)

    def xla(f):
        return jax_ops.three_interpolate(f, jnp.asarray(idx), jnp.asarray(w))

    want = window(jnp.asarray(feats))
    grads = [jax.grad(lambda f: jnp.sum(fn(f) * cot))(jnp.asarray(feats))
             for fn in (window, xla)]
    f = _t(feats).requires_grad_()
    got = point_ops.three_interpolate(f, _t(idx), _t(w))
    for ref in (want, xla(jnp.asarray(feats))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)
    (got * _t(cot)).sum().backward()
    _check_rowuniform_grads(f.grad.numpy(), *grads)


def test_interpolate_rows_bf16_matches_kernel():
    """bf16 features: weights rounded to bf16, the three rows summed in
    f32, one rounding, as the Pallas kernel does: within one bf16 ulp."""
    rng = np.random.default_rng(5)
    n, m, c = 256, 64, 8
    feats = jnp.asarray(rng.standard_normal((2, m, c)).astype(
        np.float32)).astype(jnp.bfloat16)
    idx, w = _local_idx_wgt(rng, 2, n, m, spread=10)
    want = np.asarray(window_interpolate(feats, jnp.asarray(idx),
                                         jnp.asarray(w), window=16, tn=64,
                                         force=True), np.float32)
    got = point_ops.three_interpolate(
        torch.from_numpy(np.asarray(feats, np.float32)).bfloat16(), _t(idx),
        _t(w))
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(g), np.abs(want)))[1] - 8)
    assert (np.abs(g - want) <= ulp).all()


def test_interpolate_rows_gives_no_grad_to_idx_or_weight():
    rng = np.random.default_rng(2)
    feats = _t(rng.standard_normal((2, 16, 4)).astype(np.float32))
    idx, w = _local_idx_wgt(rng, 2, 32, 16, spread=4)
    wt = _t(w).requires_grad_()
    out = point_ops.three_interpolate(feats.requires_grad_(), _t(idx), wt)
    out.sum().backward()
    assert wt.grad is None


# ---- the wrappers ------------------------------------------------------------

_CPU = torch.zeros((2, 8, 3))
_IDX = torch.zeros((2, 4, 3), dtype=torch.int32)
WRAPPERS = {
    "fps": lambda: fp.fps_cuda(_CPU, 4),
    "ball_query": lambda: bq.ball_query_cuda(_CPU, _CPU, 0.5, 4),
    "three_nn": lambda: tn.three_nn_cuda(_CPU, _CPU),
    "group_rows": lambda: pg.group_rows_cuda(_CPU, _IDX),
    "group_rows_bwd": lambda: pg.group_rows_bwd_cuda(_CPU[:, :, None],
                                                     _IDX[:, :, :1], 8),
    "interpolate_rows": lambda: pg.interpolate_rows_cuda(_CPU, _IDX,
                                                         _CPU[:, :4]),
    "interpolate_rows_bwd": lambda: pg.interpolate_rows_bwd_cuda(
        _CPU[:, :4], _IDX, _CPU[:, :4], 8),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrappers_reject_cpu_tensors(name):
    with pytest.raises(ValueError, match="not on a CUDA device"):
        WRAPPERS[name]()


def test_cpu_route_launches_no_kernel(cloud):
    wrappers = (fp.fps_cuda, bq.ball_query_cuda, tn.three_nn_cuda,
                pg.group_rows_cuda, pg.group_rows_bwd_cuda,
                pg.interpolate_rows_cuda, pg.interpolate_rows_bwd_cuda)
    before = [f.launches for f in wrappers]
    x = _t(cloud)
    idx = point_ops.furthest_point_sample(x, 8)
    gidx = point_ops.ball_query(x, point_ops.gather_points(x, idx), 0.5, 4)
    t = x.clone().requires_grad_()
    point_ops.group_points(t, gidx).sum().backward()
    d, i = point_ops.three_nn(x, point_ops.gather_points(x, idx))
    f = torch.ones((3, 8, 2), requires_grad=True)
    point_ops.three_interpolate(f, i, point_ops.interpolation_weights(d)
                                ).sum().backward()
    assert [f.launches for f in wrappers] == before
