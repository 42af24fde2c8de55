"""The port's stage-2 losses and their building blocks held against
hcmoco_tpu's, in f32 on the CPU: the same numpy inputs through both, values
and gradients (jax.grad against torch autograd).

The JAX functions take NHWC maps, the port's NCHW ones; the inputs are
transposed on the way in.  Tolerance for values and gradients: rtol 1e-4,
atol 1e-5 (the stage-1 step's); the blur, the merge and the resize move no
arithmetic between the frameworks' orders beyond a convolution's, and are
held to atol 1e-6.

F2 (ROADMAP.md Queue 3): the nearest downsampling takes half-pixel centres,
as jax.image.resize(method='nearest') does; torch's mode 'nearest' takes
the top-left sample and fails test_nearest_resize_*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.contrast import losses as jl
from hcmoco_tpu.models.heads import gaussian_blur_nhwc as jax_blur
from hcmoco_tpu.models.hrnet import merge_all_res as jax_merge_all_res
from hcmoco_tpu.train.contrast_step import _scl_grouped as jax_scl_grouped

from hcmoco_tpu_torch.contrast import losses as pl
from hcmoco_tpu_torch.models.heads import gaussian_blur_nhwc
from hcmoco_tpu_torch.models.hrnet import merge_all_res
from hcmoco_tpu_torch.train.contrast_step import _scl_grouped

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
B, C, CROP, J, S, T = 4, 16, 32, 16, 24, 0.07
H = CROP // 4


def _nchw(a):
    """NHWC numpy -> NCHW torch tensor that requires grad."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).requires_grad_(True)


def _grad_nhwc(t):
    return np.transpose(t.grad.numpy(), (0, 2, 3, 1))


def _maps(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, H, C)).astype(np.float32),
            rng.standard_normal((B, H, H, C)).astype(np.float32))


def _masks(rng, case):
    mask = (rng.random((B, CROP, CROP)) < 0.6).astype(np.float32)
    use_depth = np.array([1, 0, 1, 1], np.int64)
    if case == "empty_mask":
        mask[2] = 0.0
    if case == "no_depth":
        use_depth[:] = 0
    return mask, use_depth


def _pinned_pixels(rng, mask):
    """Valid pixels of the half-pixel-centre downsampled mask (uniform over
    all pixels for an image with none)."""
    small = mask[:, 2::4, 2::4].reshape(B, H * H)
    out = np.zeros((B, S), np.int64)
    for b in range(B):
        cand = np.nonzero(small[b])[0]
        out[b] = rng.choice(cand if cand.size else np.arange(H * H), S)
    return out


def test_gaussian_blur_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 7, 5)).astype(
        np.float32)
    got = gaussian_blur_nhwc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_blur(
        jnp.asarray(x))), atol=1e-6)
    # constant maps stay constant (the kernel sums to 1, reflect padding)
    ones = gaussian_blur_nhwc(torch.ones((1, 6, 6, 2)))
    np.testing.assert_allclose(ones.numpy(), 1.0, atol=1e-6)


def test_merge_all_res_matches_jax():
    rng = np.random.default_rng(1)
    maps = [rng.standard_normal((2, 16 // 2 ** i, 16 // 2 ** i, 4 * 2 ** i))
            .astype(np.float32) for i in range(4)]
    got = merge_all_res([torch.from_numpy(np.ascontiguousarray(
        np.transpose(m, (0, 3, 1, 2)))) for m in maps])
    want = np.asarray(jax_merge_all_res([jnp.asarray(m) for m in maps]))
    assert got.shape == (2, 60, 16, 16)
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), want,
                               atol=1e-6)


def test_nearest_resize_takes_half_pixel_centres():
    x = torch.arange(16.0).reshape(1, 1, 16, 1).expand(1, 1, 16, 16)
    got = pl.nearest_resize(x, 4, 4)
    assert got[0, 0, :, 0].tolist() == [2.0, 6.0, 10.0, 14.0]
    assert got[0, 0, 0].tolist() == [2.0] * 4


@pytest.mark.parametrize("shape,size", [((3, 32, 32, 1), 8),
                                        ((2, 320, 320, 3), 80)],
                         ids=["mask_32_to_8", "map_320_to_80"])
def test_nearest_resize_matches_jax(shape, size):
    """The soft-Pri3D mask (H -> H/4) and linear_merge2 (320 -> 80)."""
    rng = np.random.default_rng(2)
    x = (rng.random(shape) < 0.5).astype(np.float32) * rng.standard_normal(
        shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], size, size, shape[3]),
                            method="nearest")
    got = pl.nearest_resize(_nchw(x).detach(), size, size)
    np.testing.assert_array_equal(np.transpose(got.numpy(), (0, 2, 3, 1)),
                                  np.asarray(want))


def test_sampler_draws_valid_pixels():
    mask = torch.zeros((3, 64))
    mask[0, ::3] = 1.0
    mask[1, 5] = 1.0
    g = torch.Generator().manual_seed(0)
    ind = pl.sample_valid_pixels(mask, 4000, g)
    assert ind.shape == (3, 4000) and ind.dtype == torch.int64
    assert bool((mask[0][ind[0]] == 1).all())
    assert bool((ind[1] == 5).all())
    counts = torch.bincount(ind[0], minlength=64)[::3].float()
    # 22 valid pixels, 4000 draws: each within 5 sigma of 4000/22
    p = 1 / 22
    sigma = (4000 * p * (1 - p)) ** 0.5
    assert float((counts - 4000 * p).abs().max()) < 5 * sigma


def test_sampler_is_uniform_on_an_empty_image():
    ind = pl.sample_valid_pixels(torch.zeros((1, 16)), 16000,
                                 torch.Generator().manual_seed(1))
    counts = torch.bincount(ind[0], minlength=16).float()
    assert counts.min() > 0
    assert float((counts - 1000).abs().max()) < 5 * (1000 * 15 / 16) ** .5


@pytest.mark.parametrize("case", ["plain", "empty_mask", "no_depth"])
def test_soft_pri3d_matches_jax(case):
    m1, m2 = _maps(3)
    rng = np.random.default_rng(4)
    mask, use_depth = _masks(rng, case)
    idx = _pinned_pixels(rng, mask)

    def jfn(a, b):
        losses, accs = jl.soft_pri3d_loss(
            None, a, b, jnp.asarray(mask), S, T,
            use_depth=jnp.asarray(use_depth), sample_ind=jnp.asarray(idx))
        return losses[0] + 2.0 * losses[1], (losses, accs)

    (_, (jlosses, jaccs)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(m1), jnp.asarray(m2))
    t1, t2 = _nchw(m1), _nchw(m2)
    losses, accs = pl.soft_pri3d_loss(
        t1, t2, torch.from_numpy(mask), S, T,
        use_depth=torch.from_numpy(use_depth),
        sample_ind=torch.from_numpy(idx))
    (losses[0] + 2.0 * losses[1]).backward()
    for got, want in zip(losses + accs, jlosses + jaccs):
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for t, g in zip((t1, t2), jgrads):
        np.testing.assert_allclose(_grad_nhwc(t), np.asarray(g), **TOL)
    if case == "no_depth":
        assert all(float(x.detach()) == 0.0 for x in losses + accs)
    else:
        assert float(losses[0].detach()) > 0.0


def test_soft_pri3d_draws_when_not_pinned():
    """Without sample_ind the loss draws from the generator: the same
    draw as passing that generator's pixels, and finite on an image with
    no valid pixel."""
    m1, m2 = _maps(5)
    mask, use_depth = _masks(np.random.default_rng(6), "empty_mask")
    args = (_nchw(m1).detach(), _nchw(m2).detach(), torch.from_numpy(mask),
            S, T)
    got, _ = pl.soft_pri3d_loss(*args, use_depth=torch.from_numpy(use_depth),
                                generator=torch.Generator().manual_seed(7))
    small = pl.nearest_resize(torch.from_numpy(mask)[:, None], H, H)
    ind = pl.sample_valid_pixels(small.reshape(B, -1), S,
                                 torch.Generator().manual_seed(7))
    want, _ = pl.soft_pri3d_loss(*args,
                                 use_depth=torch.from_numpy(use_depth),
                                 sample_ind=ind)
    assert [float(x) for x in got] == [float(x) for x in want]
    assert all(np.isfinite(float(x)) for x in got)


def _joints(rng, case):
    joints = rng.uniform(0, CROP, (B, J, 2)).astype(np.float32)
    vis = (rng.random((B, J)) < 0.8).astype(np.int64)
    use_depth = np.array([1, 1, 0, 1], np.int64)
    if case == "invisible":
        vis[1] = 0
        vis[3, :8] = 0
    if case == "clamp_edge":
        joints[0, :4] = [[-9.0, 3.0], [CROP + 7.0, 1.0], [2.0, CROP + 30.0],
                         [CROP - 0.5, -0.5]]
    if case == "no_depth":
        use_depth[:] = 0
    return joints, vis, use_depth


@pytest.mark.parametrize("case", ["plain", "invisible", "clamp_edge",
                                  "no_depth"])
def test_joints_pri3d_matches_jax(case):
    m1, m2 = _maps(8)
    rng = np.random.default_rng(9)
    joints, vis, use_depth = _joints(rng, case)
    q = rng.standard_normal((B, J, C)).astype(np.float32)

    def jfn(a, b, c):
        losses, accs = jl.joints_pri3d_loss(
            a, b, c, jnp.asarray(joints), jnp.asarray(vis), T,
            use_depth=jnp.asarray(use_depth))
        return losses[0] + 2.0 * losses[1], (losses, accs)

    (_, (jlosses, jaccs)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(q))
    t1, t2 = _nchw(m1), _nchw(m2)
    tq = torch.from_numpy(q).requires_grad_(True)
    losses, accs = pl.joints_pri3d_loss(
        t1, t2, tq, torch.from_numpy(joints), torch.from_numpy(vis), T,
        use_depth=torch.from_numpy(use_depth))
    (losses[0] + 2.0 * losses[1]).backward()
    for got, want in zip(losses + accs, jlosses + jaccs):
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for got, want in zip((_grad_nhwc(t1), _grad_nhwc(t2), tq.grad.numpy()),
                         jgrads):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if case == "no_depth":
        assert float(losses[1].detach()) == 0.0
        assert float(losses[0].detach()) > 0.0


def test_gather_joint_features_clamps_like_the_reference():
    """Coordinates // 4 clamped to [0, h) and flattened row * h + col."""
    feat = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
    joints = torch.tensor([[[-5.0, 3.0], [100.0, 9.0], [6.0, 100.0],
                            [15.9, 15.9]]])
    got = pl.gather_joint_features(feat, joints)[0, :, 0]
    assert got.tolist() == [0.0, 14.0, 7.0, 15.0]
    want = jl.gather_joint_features(
        jnp.asarray(feat.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(joints.numpy()))
    np.testing.assert_array_equal(pl.gather_joint_features(
        feat, joints).numpy(), np.asarray(want))


def test_gaussian_joint_pooling_matches_jax():
    m1, _ = _maps(10)
    joints, _, _ = _joints(np.random.default_rng(11), "clamp_edge")
    got = pl.gaussian_joint_pooling(_nchw(m1).detach(),
                                    torch.from_numpy(joints))
    want = jl.gaussian_joint_pooling(jnp.asarray(m1), jnp.asarray(joints))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("case,groups", [("plain", 1), ("plain", 2),
                                         ("no_depth", 1), ("no_rgb", 2),
                                         ("clamp_edge", 1)])
def test_scl_matches_jax(case, groups):
    m1, m2 = _maps(12)
    rng = np.random.default_rng(13)
    joints, _, use_depth = _joints(rng, "no_depth" if case == "no_depth"
                                   else "clamp_edge" if case == "clamp_edge"
                                   else "plain")
    use_rgb = np.array([1, 1, 1, 0] if case == "no_rgb" else [1] * B,
                       np.int64)

    def jfn(a, b):
        return jax_scl_grouped(a, b, jnp.asarray(joints),
                               jnp.asarray(use_depth), jnp.asarray(use_rgb),
                               T, groups)

    jloss, jgrads = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(m1), jnp.asarray(m2))
    t1, t2 = _nchw(m1), _nchw(m2)
    loss = _scl_grouped(t1, t2, torch.from_numpy(joints),
                        torch.from_numpy(use_depth),
                        torch.from_numpy(use_rgb), T, groups)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for t, g in zip((t1, t2), jgrads):
        np.testing.assert_allclose(_grad_nhwc(t), np.asarray(g), **TOL)
    if case == "no_depth":
        assert float(loss.detach()) == 0.0
    else:
        assert float(loss.detach()) > 0.0


def test_scl_groups_must_divide_the_batch():
    m = torch.zeros((3, C, H, H))
    one = torch.ones(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="does not divide"):
        _scl_grouped(m, m, torch.zeros((3, J, 2)), one, one, T, 2)


def test_losses_take_channels_last_maps():
    """The card's maps are channels_last: the same losses as contiguous."""
    m1, m2 = _maps(14)
    joints, vis, use_depth = _joints(np.random.default_rng(15), "plain")
    a, b = _nchw(m1).detach(), _nchw(m2).detach()
    args = (torch.from_numpy(joints), torch.from_numpy(vis), T)
    q = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (B, J, C)).astype(np.float32))
    want, _ = pl.joints_pri3d_loss(a, b, q, *args)
    got, _ = pl.joints_pri3d_loss(a.to(memory_format=torch.channels_last),
                                  b.to(memory_format=torch.channels_last), q,
                                  *args)
    assert [float(x) for x in got] == [float(x) for x in want]
