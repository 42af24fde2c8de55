"""The versatility segmentor's pieces in the port held against hcmoco_tpu's
on the same seeded numpy inputs, in f32 on the CPU: MaskedBatchNorm, the
FCN head with its x4 upsampling, the class-weighted CE, the IoU counts
and metrics, the validator's counts at width 4, and the FCN head's
reference names (tests/golden/fcn_torch_keys.txt).  The train step is
tests/test_torch_segment_step.py's.

Layouts: JAX NHWC, the port NCHW; tensors are permuted to compare.
Tolerances: rtol 1e-5, atol 1e-6 for the BN and head outputs and
statistics (f32, the same sums in another order); the CE rtol 1e-6;
counts exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.export.transfer import fcn_torch_to_flax
from hcmoco_tpu.models import heads as jheads
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train import segment_step as jseg

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import (fcn_flax_to_torch,
                                             flax_to_port_state_dict)
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.heads import FCNHead, MaskedBatchNorm
from hcmoco_tpu_torch.train import segment_step as seg

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
TOL = dict(rtol=1e-5, atol=1e-6)
N_CLASS = 25


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


MASKS = {"none": None, "ones": [1, 1, 1, 1], "mixed": [1, 0, 1, 0],
         "zeros": [0, 0, 0, 0]}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_masked_batchnorm_matches_jax(mask):
    """Training output and running statistics after two updates (torch
    momentum 0.1 = flax 0.9; the running variance unbiased over
    n = sum(mask) * H * W, n clamped at 1: an all-zero mask still moves
    the statistics), then the eval output from them."""
    rng = np.random.default_rng(0)
    c = 6
    xs = [(rng.standard_normal((4, 5, 3, c)) * 2 + 0.5).astype(np.float32)
          for _ in range(2)]
    scale = (rng.random(c) + 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    m = None if MASKS[mask] is None else np.asarray(MASKS[mask], np.int32)

    jbn = jheads.MaskedBatchNorm(momentum=0.9, epsilon=1e-5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), False)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = v["batch_stats"]
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    bn.train()
    for x in xs:
        want, mut = jbn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), True,
                              None if m is None else jnp.asarray(m),
                              mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = bn(_t(x).permute(0, 3, 1, 2), None if m is None else _t(m))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), **TOL)
    assert int(bn.num_batches_tracked) == 2
    if mask == "zeros":  # the batch statistics are 0, the running ones move
        assert float(bn.running_mean.abs().max()) == 0.0
        np.testing.assert_allclose(bn.running_var.numpy(), 0.81, rtol=1e-6)
    bn.eval()
    want = jbn.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(xs[0]), False)
    np.testing.assert_allclose(_nhwc(bn(_t(xs[0]).permute(0, 3, 1, 2))),
                               np.asarray(want), **TOL)


def _fcn_pair(seed=0, cin=128, n_class=N_CLASS, hw=8):
    """JAX's FCNHead initialised from a key and the port's loaded from its
    trees; an input map (NHWC) and the JAX variables."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, hw, hw, cin)).astype(np.float32)
    jhead = jheads.FCNHead(channels=128, num_classes=n_class, num_convs=1,
                           kernel_size=1)
    v = jhead.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]), train=False)
    # non-trivial BN state: scale/bias and running stats off their init
    v = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), dict(v))
    v["batch_stats"] = jax.tree_util.tree_map(jnp.abs, v["batch_stats"])
    head = FCNHead(128, n_class)
    head.load_state_dict(fcn_flax_to_torch(v["params"], v["batch_stats"]),
                         strict=True)
    return jhead, v, head, x


@pytest.mark.parametrize("train", [True, False])
def test_fcn_head_matches_jax(train):
    """Logits after the x4 bilinear upsampling (jax.image.resize
    'bilinear' = F.interpolate(align_corners=False) when upsampling), the
    input's gradient and, in training, the masked BN statistics."""
    jhead, v, head, x = _fcn_pair()
    mask = np.asarray([1, 0, 1, 1], np.int32)
    cot = np.random.default_rng(1).standard_normal(
        (4, 32, 32, N_CLASS)).astype(np.float32)

    def f(xx):
        out, mut = jhead.apply(v, xx, train=train,
                               sample_mask=jnp.asarray(mask) if train
                               else None, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (want, mut)), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    head.train(train)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = head(xt, _t(mask) if train else None)
    assert got.shape == (4, N_CLASS, 32, 32)
    (got * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(grad), rtol=1e-4,
                               atol=1e-5)
    if train:
        bn = head.convs[0].norm_name
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(
            mut["batch_stats"]["bn0"]["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(
            mut["batch_stats"]["bn0"]["var"]), **TOL)


def test_fcn_upsample_is_half_pixel_bilinear():
    """The head's x4 upsampling equals jax.image.resize's bilinear on the
    same map, edges included."""
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 20, 28), "bilinear")
    got = torch.nn.functional.interpolate(_t(x), size=(20, 28),
                                          mode="bilinear",
                                          align_corners=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_fcn_loads_the_reference_keys():
    """The crc32-seeded reference FCN state dict loads with strict=True,
    and the port's head computes what JAX's computes after the JAX
    package's fcn_torch_to_flax of the same dict."""
    keys = pc.read_keys_file(os.path.join(HERE, "golden",
                                          "fcn_torch_keys.txt"))
    sd = pc.synth_state_dict(keys)
    head = FCNHead(128, N_CLASS)
    assert [k for k, _ in keys] and set(head.state_dict()) == {
        k for k, _ in keys}
    head.load_state_dict({k: torch.from_numpy(v).to(
        torch.long if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in sd.items()}, strict=True)
    jhead = jheads.FCNHead(channels=128, num_classes=N_CLASS, num_convs=1,
                           kernel_size=1)
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 128)).astype(
        np.float32)
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    p, s, n = fcn_torch_to_flax(sd, v["params"], v["batch_stats"])
    assert n == 2
    want = jhead.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                       train=False)
    head.eval()
    np.testing.assert_allclose(
        _nhwc(head(_t(x).permute(0, 3, 1, 2))), np.asarray(want), rtol=1e-5,
        atol=1e-5)


# ---- the loss and the metrics -------------------------------------------------


@pytest.mark.parametrize("sample_mask", [None, [1, 0, 1], [0, 0, 0]])
def test_weighted_seg_ce_matches_jax(sample_mask):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 8, 8, N_CLASS)).astype(np.float32) * 3
    labels = rng.integers(0, N_CLASS, (3, 8, 8)).astype(np.int32)
    labels[0, :3] = 255
    w = np.asarray(seg.NTU_SEG_CLASS_WEIGHTS, np.float32)
    assert seg.NTU_SEG_CLASS_WEIGHTS == jseg.NTU_SEG_CLASS_WEIGHTS
    m = None if sample_mask is None else np.asarray(sample_mask, np.int32)
    want = jseg.weighted_seg_ce(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(w),
                                None if m is None else jnp.asarray(m))
    got = seg.weighted_seg_ce(_t(logits).permute(0, 3, 1, 2), _t(labels),
                              _t(w), None if m is None else _t(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    if sample_mask == [0, 0, 0]:
        assert float(got) == 0.0


def test_seg_counts_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 6, (3, 16, 16))
    label = rng.integers(0, 6, (3, 16, 16))
    label[1, :4] = 255
    label[2] = np.where(label[2] == 5, 3, label[2])  # a class never labelled
    want = jseg.seg_counts(jnp.asarray(pred), jnp.asarray(label), 7)
    got = seg.seg_counts(_t(pred), _t(label), 7)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f64 = [g.double() for g in got]
    want_m = jseg.calc_seg_metrics(*[np.asarray(x, np.float64)
                                     for x in want])
    for g, w in zip(seg.calc_seg_metrics(*f64), want_m):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ---- the validator ----------------------------------------------------------------


TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank+jointspri3d", linear_feat_map=True, nce_k=15,
            nce_t=0.07, temperature=0.07, pri3d_num_samples_per_image=16,
            batch_size=6, epochs=4, learning_rate=0.01, cosine=True,
            modality_missing=True, compute_dtype="float32", n_class=N_CLASS)


def test_validator_counts_match_jax():
    """Eval-mode forwards of model and classifier (running statistics)
    and the three heads' counts: the logits within 1e-4, the counts equal
    where the two argmaxes agree (every pixel here)."""
    cfg = resolve_config(TrainConfig(**TINY))
    jcfg = jax_resolve_config(JaxTrainConfig(**TINY))
    b = pc.synth_seg_batches(steps=1, bsz=6, crop=32, n_data=64, k=15,
                             n_class=N_CLASS)[0]
    jmodel = jax_build_model(jcfg)
    mv = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(b["rgbd"][:1]),
                     jnp.asarray(b["skeleton"][:1]), train=False,
                     return_fm=True)
    jhead, cv, head, _ = _fcn_pair(seed=3)
    params = {"model": mv["params"], "classifier": cv["params"]}
    stats = {"model": mv["batch_stats"], "classifier": cv["batch_stats"]}
    want = jseg.make_validate_fn(jcfg, jmodel, jhead)(
        params, stats, {k: jnp.asarray(b[k]) for k in ("rgbd", "skeleton",
                                                        "label")})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_port_state_dict(mv["params"],
                                                  mv["batch_stats"]),
                          strict=True)
    model.train()
    got = seg.make_validate_fn(cfg, model, head)(
        {k: _t(b[k]) for k in ("rgbd", "skeleton", "label")})
    assert model.training and head.training  # put back
    for head_name, g, w in zip(seg.SEG_HEADS, got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc),
                                          err_msg=head_name)
    assert int(got[2][3].sum()) == int((b["label"] != 255).sum())
