"""The port's stage-2 train step (`mem='bank+jointspri3d'`) and its
forwards held against hcmoco_tpu's, in f32 on the CPU at tiny size:
width-4 HRNet, 32^2 crops, NCE K=15, 16 soft-Pri3D pixels an image, and
for HRNetPN 64 depth points; and the HRNet step against the reference
trainer's stage-2 loss curve (tests/golden/ref_loss_curve_s2.npz).

Draws are pinned as in the stage-1 tests: the negatives (JAX takes
`neg_idx`, the port the counts of the same draw), the soft-Pri3D pixels
(`pix_idx`, both) and for HRNetPN the depth2pts uniforms (JAX's depth2pts
is handed a fixed key, the port the uniforms jax.random.uniform draws from
it).  Step 2 starts from JAX's step-1 parameters and banks, as in
tests/test_torch_train_step.py.

Tolerance: rtol 1e-4, atol 1e-5 (the stage-1 step's) for every metric,
parameter and bank of the HRNet step, with HCMOCO_CONVBN_FUSE on and off.

HRNetPN: the 64-point encoder (encoder2) is f32-ill-conditioned
(tests/test_torch_pointnet2.py), and in stage 2 its per-pixel features
feed the dense and joint losses, whose gradients reach every encoder: two
f32 implementations part there by ~1e-3 relative in the losses and ~1e-4
in encoder1's parameters.  So the step is compared with its point branch
(encoder2 and encoder2_linear) in float64 on both sides, JAX's under
jax.enable_x64: every metric, bank and parameter at rtol 1e-4, atol 1e-5,
except encoder2's parameters.  Those stay chaotic even so: the f32 losses'
rounding reaches the SA levels' gradients amplified many-fold (the test
prints how far they part, against the update: up to 1.2x at the SA
levels, below 1.3e-4 at the FP levels); encoder2's gradients
are held in float64 by tests/test_torch_pointnet2.py and its f32 step by
tests/test_torch_pn_train_step.py.  The port's f32 step runs beside it:
what the depth map does not feed at rtol 1e-4 against JAX, what it feeds
within F32_TOL of the float64-branch step.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu.models import pointnet2_model as jax_pn
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import RECIPES, TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models import pointnet2_model as pn
from hcmoco_tpu_torch.models.build import HCMoCoModel, build_model
from hcmoco_tpu_torch.train.contrast_step import (STAGE2_METRICS,
                                                  make_contrast_train_step)
from hcmoco_tpu_torch.train.state import create_train_state

from torch_parity_common import counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K, N_POINTS, PIX = 64, 6, 32, 15, 64, 16
TOL = dict(rtol=1e-4, atol=1e-5)
# the f32 64-point encoder's rounding, amplified (test_pointnet2_f32_is_
# ill_conditioned: f32 moves its parameter gradients by > 1e-2 relative)
F32_TOL = dict(rtol=1e-2, atol=1e-3)
METRICS = (("loss",) + tuple(f"nce_loss_{d}" for d in
                             ("12", "21", "23", "32", "13", "31"))
           + STAGE2_METRICS)
# the stage-2 metrics that the depth map does not feed
RGB_ONLY = ("loss_rgb2joint", "acc_rgb2joint")
POINTS_KEY = jax.random.PRNGKey(11)
KEYS_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                           "hcmoco_w18_torch_keys.txt")

TINY = dict(method="Customize", modal="RGBD2S", width=4,
            mem="bank+jointspri3d", linear_feat_map=True, nce_k=NCE_K,
            nce_t=0.07, temperature=0.07, pri3d_num_samples_per_image=PIX,
            batch_size=BSZ, epochs=4, learning_rate=0.01, cosine=True,
            modality_missing=True, compute_dtype="float32",
            pn_num_points=N_POINTS)


def _cfgs(arch):
    kw = dict(TINY, arch=arch)
    return (resolve_config(TrainConfig(**kw)),
            jax_resolve_config(JaxTrainConfig(**kw)))


def _t(a):
    return torch.from_numpy(np.array(a))


def pinned_pixels(depth_mask, rng):
    """PIX pixels an image, uniform over the valid pixels of its
    half-pixel-centre /4 mask, or over all pixels where it has none."""
    small = depth_mask[:, 2::4, 2::4].reshape(depth_mask.shape[0], -1)
    out = np.zeros((depth_mask.shape[0], PIX), np.int64)
    for b, row in enumerate(small):
        cand = np.nonzero(row)[0]
        out[b] = rng.choice(cand if cand.size else np.arange(row.size), PIX)
    return out


def hrnet_batches(n):
    """The reference-parity harness's stage-2 batches (N(0, 0.25) rgbd,
    use_depth/use_rgb masks, joints2d/joints_vis), with pinned pixels."""
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
            "depth_mask", "joints2d", "joints_vis", "neg_idx")
    bs = [{k: b[k] for k in keys} for b in pc.synth_batches(
        steps=n, bsz=BSZ, crop=CROP, n_data=N_DATA, k=NCE_K, stage2=True)]
    rng = np.random.default_rng(21)
    for b in bs:
        b["pix_idx"] = pinned_pixels(b["depth_mask"], rng)
    return bs


def pn_batches(n):
    """Synthetic-source batches (some samples without depth, so all-zero
    clouds and empty masks), pinned negatives and pixels."""
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
            "depth_mask", "grid_xy", "depth_mean", "joints2d", "joints_vis")
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        b = synthetic_contrast_batch(rng, BSZ, size=CROP, n_data=N_DATA)
        b = {k: b[k] for k in keys}
        neg = rng.integers(0, N_DATA, (BSZ, NCE_K + 1)).astype(np.int64)
        neg[:, 0] = b["index"]
        b["neg_idx"] = neg
        b["pix_idx"] = pinned_pixels(b["depth_mask"], rng)
        out.append(b)
    assert 0 < sum(int(b["use_depth"].sum()) for b in out) < n * BSZ
    return out


def to_port(b, arch):
    t = {k: _t(v) for k, v in b.items() if k != "neg_idx"}
    t["counts"] = counts_from_indices(_t(b["neg_idx"]), N_DATA)
    if arch == "HRNetPN":
        t["pts_u"] = _t(jax.random.uniform(POINTS_KEY, (BSZ, N_POINTS)))
    return t


def _fix_points_key(monkeypatch):
    orig = jax_pn.depth2pts
    monkeypatch.setattr(jax_pn, "depth2pts",
                        lambda *a: orig(*a[:6], POINTS_KEY, a[7]))


def _f64(state):
    """A copy of the train state whose encoder2 and encoder2_linear run in
    float64 (converted in place, so the copied optimizer keeps them)."""
    ref = copy.deepcopy(state)
    for mod in (ref.model.encoder2, ref.model.encoder2_linear):
        mod.double()
        for m in mod.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    return ref


# ---- forwards ----------------------------------------------------------------


def test_hrnet_return_fm_matches_jax():
    cfg, jcfg = _cfgs("HRNet")
    b = hrnet_batches(1)[0]
    jm = jax_build_model(jcfg)
    args = (jnp.asarray(b["rgbd"]), jnp.asarray(b["skeleton"]))
    v = jm.init(jax.random.PRNGKey(0), *args, train=False, return_fm=True)
    want, _ = jm.apply(v, *args, train=True, return_fm=True,
                       mutable=["batch_stats"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_port_state_dict(v["params"],
                                                  v["batch_stats"]),
                          strict=True)
    got = model(_t(b["rgbd"]).permute(0, 3, 1, 2), _t(b["skeleton"]),
                return_fm=True)
    for k in ("merge1", "merge2", "linear_merge1", "linear_merge2"):
        assert got[k].shape[1:] == (want[k].shape[3],) + want[k].shape[1:3]
        np.testing.assert_allclose(
            got[k].detach().permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
            atol=2e-4, err_msg=k)
    assert got["linear_merge1"].dtype == torch.float32
    np.testing.assert_allclose(got["fm3"].detach().numpy(),
                               np.asarray(want["fm3"]), atol=1e-4)
    for i in range(4):
        np.testing.assert_allclose(
            got["fm1"][i].detach().permute(0, 2, 3, 1).numpy(),
            np.asarray(want["fm1"][i]), atol=2e-4)
    # without return_fm only the stage-1 outputs
    assert set(model(_t(b["rgbd"]).permute(0, 3, 1, 2),
                     _t(b["skeleton"]))) == {
        "pooled1", "pooled2", "pooled3", "feat1", "feat2", "feat3"}


def test_hrnetpn_return_fm_matches_jax(monkeypatch):
    """linear_merge1 and fm3 against JAX's within 1e-4 of their largest
    magnitude.  merge2 (= fm2, the 64-point encoder's output) parts from
    JAX's by ~2% of its largest magnitude when one cloud of six is valid:
    that encoder is f32-ill-conditioned (tests/test_torch_pointnet2.py
    holds it in float64).  So linear_merge2 is held against JAX's stage-2
    point head (encoder2_linear, f32 cast, pts2depth, nearest resize)
    applied to the port's merge2 and depth2pts cloud (equal to JAX's,
    tests/test_torch_pointnet2.py), within 1e-4."""
    _fix_points_key(monkeypatch)
    cfg, jcfg = _cfgs("HRNetPN")
    b = pn_batches(1)[0]
    jm = jax_build_model(jcfg)
    keys = ("rgbd", "skeleton", "depth_mask", "grid_xy")
    jargs = [jnp.asarray(b[k]) for k in keys]
    mean = jnp.asarray(b["depth_mean"])
    v = jax.jit(lambda *a: jm.init(
        {"params": jax.random.PRNGKey(0), "points": POINTS_KEY}, *a, 424.0,
        512.0, mean, train=True, return_fm=True))(*jargs)
    want, _ = jax.jit(lambda *a: jm.apply(
        v, *a, 424.0, 512.0, mean, train=True, return_fm=True,
        rngs={"points": POINTS_KEY}, mutable=["batch_stats"]))(*jargs)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_port_state_dict(v["params"],
                                                  v["batch_stats"]),
                          strict=True)
    t = {k: _t(b[k]) for k in keys}
    u = to_port(b, "HRNetPN")["pts_u"]
    got = model(t["rgbd"].permute(0, 3, 1, 2), t["skeleton"],
                t["depth_mask"], t["grid_xy"], 424.0, 512.0,
                _t(b["depth_mean"]), u=u, return_fm=True)

    def close(g, w, what):
        w = np.asarray(w)
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=what)

    close(got["linear_merge1"].detach().permute(0, 2, 3, 1).numpy(),
          want["linear_merge1"], "linear_merge1")
    close(got["fm3"].detach().numpy(), want["fm3"], "fm3")
    sampled, all_pts, _, _ = pn.depth2pts(
        t["rgbd"][..., 3], t["depth_mask"], t["grid_xy"], 424.0, 512.0,
        _t(b["depth_mean"]), N_POINTS, u=u)
    head = jax_pn.SharedMLP((128,), dtype=jnp.float32)
    lm2, _ = head.apply({"params": v["params"]["encoder2_linear"],
                         "batch_stats": v["batch_stats"]["encoder2_linear"]},
                        jnp.asarray(got["merge2"].detach().numpy()), True,
                        mutable=["batch_stats"])
    lm2 = jax_pn.pts2depth(jnp.asarray(sampled.numpy()),
                           jnp.asarray(all_pts.numpy()),
                           lm2.astype(jnp.float32), CROP, CROP)
    lm2 = jax.image.resize(lm2, (BSZ, CROP // 4, CROP // 4, 128),
                           method="nearest")
    assert got["linear_merge2"].shape == (BSZ, 128, CROP // 4, CROP // 4)
    assert got["linear_merge2"].dtype == torch.float32
    close(got["linear_merge2"].detach().permute(0, 2, 3, 1).numpy(), lm2,
          "linear_merge2")
    assert got["merge2"].shape == want["merge2"].shape


def test_pts2depth_matches_jax_with_zero_clouds():
    """Every pixel of a zero cloud takes points 0, 1, 2 at a third each."""
    rng = np.random.default_rng(17)
    b, h, w, n, c = 3, 8, 6, 20, 5
    sampled = (rng.random((b, n, 3)) - 0.5).astype(np.float32)
    all_pts = (rng.random((b, h * w, 3)) - 0.5).astype(np.float32)
    sampled[1] = 0.0
    all_pts[1] = 0.0
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    want = jax_pn.pts2depth(jnp.asarray(sampled), jnp.asarray(all_pts),
                            jnp.asarray(feats), h, w)
    tf = _t(feats).requires_grad_(True)
    got = pn.pts2depth(_t(sampled), _t(all_pts), tf, h, w)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].detach().numpy(),
                               np.broadcast_to(feats[1, :3].mean(0),
                                               (h, w, c)), rtol=1e-5)
    gout = rng.standard_normal((b, h, w, c)).astype(np.float32)
    got.backward(_t(gout))
    jgrad = jax.grad(lambda f: jnp.sum(jax_pn.pts2depth(
        jnp.asarray(sampled), jnp.asarray(all_pts), f, h, w)
        * jnp.asarray(gout)))(jnp.asarray(feats))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgrad), **TOL)
    assert not tf.grad[1, 3:].any()  # a zero cloud feeds points 0-2 only


# ---- two steps against the JAX package ---------------------------------------


def _jax_setup(jcfg, b0):
    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, jax.random.PRNGKey(0), b0,
                              n_data=N_DATA, steps_per_epoch=1)
    return jstate, jax_make_step(jcfg, jmodel, steps_per_epoch=1)


def _port_setup(cfg, jstate):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        flax_to_port_state_dict(jstate.params, jstate.batch_stats),
        strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=1)
    state.banks.copy_(_t(jstate.memory.banks))
    return state, make_contrast_train_step(cfg, model, steps_per_epoch=1)


def _sync(state, jstate):
    """Step 2 starts from JAX's step-1 parameters and banks."""
    sync = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.copy_(sync[name])
        state.banks.copy_(_t(jstate.memory.banks))


@pytest.mark.parametrize("fuse", [False, True])
def test_hrnet_two_steps_match_jax(monkeypatch, fuse):
    if fuse:
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1")
    else:
        monkeypatch.delenv("HCMOCO_CONVBN_FUSE", raising=False)
    cfg, jcfg = _cfgs("HRNet")
    bs = hrnet_batches(2)
    jstate, jstep = _jax_setup(jcfg, bs[0])
    state, step = _port_setup(cfg, jstate)
    for i, b in enumerate(bs):
        if i:
            _sync(state, jstate)
        start = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step(state, to_port(b, "HRNet"))
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
        assert 0.0 < float(m["loss_scl"]) and 0.0 < float(
            m["loss_rgb2depth"])
        np.testing.assert_allclose(state.banks.numpy(),
                                   np.asarray(jstate.memory.banks), **TOL)
        want = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **TOL, err_msg=f"step {i} {name}")
            assert not torch.equal(want[name], start[name]), name
    assert state.step == int(jstate.step) == 2


def _f64_module(cls):
    """A subclass of a flax module class that computes in float64."""
    class F64(cls):
        def __post_init__(self):
            object.__setattr__(self, "dtype", jnp.float64)
            super().__post_init__()
    F64.__name__, F64.__qualname__ = cls.__name__, cls.__qualname__
    return F64


def test_hrnetpn_two_steps_match_jax(monkeypatch):
    """The step whose point branch (encoder2, encoder2_linear) runs in
    float64 against JAX's with the same branch in float64 (jax.enable_x64;
    the depth2pts uniforms still drawn in f32): every metric, bank and
    parameter at TOL but encoder2's.  The port's f32 step beside it: the
    metrics and banks the depth map does not feed at TOL against JAX, the
    ones it feeds within F32_TOL of the float64-branch step."""
    _fix_points_key(monkeypatch)
    monkeypatch.setattr(jax_pn, "Pointnet2MSG",
                        _f64_module(jax_pn.Pointnet2MSG))
    monkeypatch.setattr(jax_pn, "SharedMLP", _f64_module(jax_pn.SharedMLP))
    uniform = jax.random.uniform
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=None, *a, **kw: uniform(
                            key, shape, jnp.float32, *a, **kw))
    cfg, jcfg = _cfgs("HRNetPN")
    bs = pn_batches(2)
    with jax.enable_x64():
        jstate, jstep = _jax_setup(jcfg, bs[0])
        state, step = _port_setup(cfg, jstate)
        ref = _f64(state)
        ref_step = make_contrast_train_step(cfg, ref.model, steps_per_epoch=1)
        for i, b in enumerate(bs):
            if i:
                _sync(state, jstate)
                _sync(ref, jstate)
            pb = to_port(b, "HRNetPN")
            start = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
            jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
            m, mr = step(state, pb), ref_step(ref, pb)
            jbanks = np.asarray(jstate.memory.banks)
            for k in METRICS:
                np.testing.assert_allclose(float(mr[k]), float(jm[k]), **TOL,
                                           err_msg=f"step {i} {k}")
                if k in RGB_ONLY or k in ("nce_loss_12", "nce_loss_13",
                                          "nce_loss_31"):
                    np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                               **TOL, err_msg=f"f32 {k}")
                else:
                    np.testing.assert_allclose(float(m[k]), float(mr[k]),
                                               **F32_TOL, err_msg=f"f32 {k}")
            print(f"step {i}: f32 step vs float64 branch, relative: " + ", ".join(
                f"{k} {abs(float(m[k]) / float(mr[k]) - 1):.2g}"
                for k in METRICS if float(mr[k])))
            for mod in range(3):
                np.testing.assert_allclose(ref.banks[mod].numpy(),
                                           jbanks[mod], **TOL)
                np.testing.assert_allclose(
                    state.banks[mod].numpy(),
                    ref.banks[mod].numpy() if mod == 1 else jbanks[mod],
                    **(F32_TOL if mod == 1 else TOL), err_msg=f"bank {mod}")
            want = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
            enc2 = {"SA": [], "FP": []}
            for name, p in ref.model.named_parameters():
                assert not torch.equal(p.detach().float(), start[name]), name
                assert bool(torch.isfinite(p).all()), name
                if not name.startswith("encoder2."):
                    np.testing.assert_allclose(
                        p.detach().numpy(), want[name].numpy(), **TOL,
                        err_msg=f"step {i} {name}")
                    continue
                # how far encoder2 parts from JAX, against its update
                upd = float((want[name] - start[name]).double().norm())
                off = float((p.detach().double() - want[name].double())
                            .norm())
                enc2[name.split(".")[1][:2]].append(off / upd)
            print(f"step {i}: encoder2 |port - JAX| / |update| per tensor: "
                  + ", ".join(f"{k} {min(v):.2g}-{max(v):.2g}"
                              for k, v in enc2.items()))
    assert state.step == ref.step == int(jstate.step) == 2


def test_step_draws_pixels_from_the_generator():
    """Without pix_idx the step draws the soft-Pri3D pixels from its
    generator: the same generator state gives the same step, and the
    stage-2 metrics are finite."""
    cfg, _ = _cfgs("HRNet")
    b = {k: v for k, v in to_port(hrnet_batches(1)[0], "HRNet").items()
         if k != "pix_idx"}
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    runs = []
    for _ in range(2):
        st = create_train_state(cfg, copy.deepcopy(model),
                                torch.Generator().manual_seed(1),
                                n_data=N_DATA, steps_per_epoch=1)
        step = make_contrast_train_step(cfg, st.model, steps_per_epoch=1)
        runs.append(step(st, b, torch.Generator().manual_seed(2)))
    for k in STAGE2_METRICS:
        assert np.isfinite(float(runs[0][k])), k
        assert float(runs[0][k]) == float(runs[1][k]), k


def test_stage2_needs_linear_feat_map():
    cfg = resolve_config(TrainConfig(**dict(TINY, arch="HRNet",
                                            linear_feat_map=False)))
    with pytest.raises(ValueError, match="linear_feat_map"):
        make_contrast_train_step(cfg, torch.nn.Linear(1, 1), 1)


@pytest.mark.parametrize("name", sorted(k for k in RECIPES
                                        if k.startswith("second_stage/")))
def test_second_stage_recipes_build_a_stage2_step(name):
    """Each second-stage recipe, at width 4 on the CPU, builds a model
    with the stage-2 heads and a step."""
    cfg = dataclasses.replace(RECIPES[name], width=4,
                              compute_dtype="float32", pn_num_points=64)
    model = build_model(cfg, device="cpu")
    assert cfg.mem == "bank+jointspri3d" and cfg.linear_feat_map
    assert hasattr(model, "encoder1_linear") and hasattr(model,
                                                         "encoder2_linear")
    assert callable(make_contrast_train_step(cfg, model, 1))


# ---- the reference trainer's loss curve ---------------------------------------


@pytest.mark.slow
def test_stage2_loss_curve_matches_reference():
    """The port's HRNet-W18 stage-2 step against the reference trainer
    (`_train_bank_joints_pri3d_cmc3`) on the golden's pinned weights,
    banks, batches, negatives and pixels, by the criteria of
    tests/test_ref_parity.py::test_stage2_loss_curve_matches_reference:
    step 0 within rtol 1e-3, then the mean deviation within twice the
    reference's own perturbation envelope or 2% of the loss's scale.
    100 W18 steps take ~100 s on one CPU thread: marked slow, as the JAX
    package's counterpart is."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "ref_loss_curve_s2.npz"))
    steps = int(golden["steps"])
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGBD2S", arch="HRNet", width=18,
        mem="bank+jointspri3d", linear_feat_map=True, nce_k=pc.NCE_K,
        nce_m=pc.NCE_M, nce_t=pc.NCE_T, temperature=0.07,
        pri3d_num_samples_per_image=8, batch_size=pc.BSZ, epochs=100,
        learning_rate=pc.LR, momentum=pc.MOMENTUM,
        weight_decay=pc.WEIGHT_DECAY, cosine=False, warm=False,
        modality_missing=True, compute_dtype="float32", crop_size=pc.CROP))
    batches = pc.synth_batches(steps=steps, stage2=True)
    pix = pc.stage2_pixel_indices(batches, cfg.pri3d_num_samples_per_image)
    model = HCMoCoModel(width=18, linear_feat_map=True, dtype=torch.float32)
    sd = pc.synth_state_dict(pc.read_keys_file(KEYS_GOLDEN))
    model.load_state_dict({k: torch.from_numpy(v).to(
        torch.long if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in sd.items()}, strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=pc.N_DATA, steps_per_epoch=steps)
    state.banks.copy_(_t(pc.synth_banks()))
    step = make_contrast_train_step(cfg, model, steps_per_epoch=steps)
    keys = ("loss", "loss_rgb2depth", "loss_depth2rgb", "loss_rgb2joint",
            "loss_d2joint", "loss_scl")
    got = {k: [] for k in keys}
    for b, p in zip(batches, pix):
        tb = {k: _t(v) for k, v in b.items() if k != "neg_idx"}
        tb["counts"] = counts_from_indices(_t(b["neg_idx"]), pc.N_DATA)
        tb["pix_idx"] = _t(p)
        m = step(state, tb)
        for k in keys:
            got[k].append(float(m[k]))
    for key in keys:
        ours, ref = np.asarray(got[key]), golden[key]
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-3,
                                   err_msg=f"{key} step 0")
        env = np.abs(golden["pert_" + key] - ref).mean()
        dev = np.abs(ours - ref).mean()
        scale = np.abs(ref).mean()
        assert dev <= max(2.0 * env, 0.02 * scale), (
            f"{key}: mean dev {dev:.4f} vs envelope {env:.4f} "
            f"(scale {scale:.3f})")
