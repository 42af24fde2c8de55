"""The port's versatility train step (train/segment_step.py) held against
hcmoco_tpu's, two steps in f32 on the CPU at tiny size (width-4 HRNet,
32^2 crops, NCE K=15, 16 soft-Pri3D pixels an image, 25 classes), for
supervise_type 0-3 with HCMOCO_CONVBN_FUSE on and off, and a batch
without a labelled frame; then the W18 step against the reference
trainer's 12-step loss curve (tests/golden/ref_loss_curve_sseg.npz),
marked slow as the JAX package's replay of it is.

Draws are pinned on both sides: the negatives (`neg_idx`, the index form
in 'dense' mode, the JAX step's formulation) and the soft-Pri3D pixels
(`pix_idx`).  Step 2 starts from JAX's step-1 parameters and banks, as
in tests/test_torch_stage2_step.py.

Tolerance: rtol 1e-4, atol 1e-5 (the stage-2 step tests') for every
metric, bank, parameter (model and classifier) and the classifier's BN
running statistics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.contrast.memory import init_memory as jax_init_memory
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.models.heads import FCNHead as JaxFCNHead
from hcmoco_tpu.train import segment_step as jseg
from hcmoco_tpu.train.state import TrainState as JaxTrainState
from hcmoco_tpu.train.state import make_optimizer as jax_make_optimizer

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import (fcn_flax_to_torch,
                                             flax_to_port_state_dict)
from hcmoco_tpu_torch.models.build import HCMoCoModel, build_model
from hcmoco_tpu_torch.models.heads import FCNHead
from hcmoco_tpu_torch.train import segment_step as seg
from hcmoco_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
N_DATA, BSZ, CROP, NCE_K, PIX, N_CLASS = 64, 6, 32, 15, 16, 25
TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = (("loss",) + seg.SEGMENT_METRICS
           + tuple(f"nce_loss_{d}" for d in ("12", "21", "23", "32", "13",
                                             "31")))
TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank+jointspri3d", linear_feat_map=True, nce_k=NCE_K,
            nce_t=0.07, temperature=0.07, pri3d_num_samples_per_image=PIX,
            batch_size=BSZ, epochs=4, learning_rate=0.01, cosine=True,
            modality_missing=True, compute_dtype="float32", n_class=N_CLASS,
            cmc_loss_weights=0.5, other_loss_weights=2.0)


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


def seg_batches(n):
    """The reference-parity harness's versatility batches (stage-2 fields,
    labels with ignored regions, true_label on at least two frames) with
    pinned pixels."""
    bs = pc.synth_seg_batches(steps=n, bsz=BSZ, crop=CROP, n_data=N_DATA,
                              k=NCE_K, n_class=N_CLASS)
    rng = np.random.default_rng(22)
    for b in bs:
        b.pop("scale")
        b["pix_idx"] = pinned_pixels(b["depth_mask"], rng)
    return bs


def _setup(supervise_type):
    kw = dict(TINY, supervise_type=supervise_type)
    cfg = resolve_config(TrainConfig(**kw))
    jcfg = jax_resolve_config(JaxTrainConfig(**kw))
    b0 = seg_batches(1)[0]
    jmodel = jax_build_model(jcfg)
    mv = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(b0["rgbd"][:1]),
                     jnp.asarray(b0["skeleton"][:1]), train=False,
                     return_fm=True)
    jhead = JaxFCNHead(channels=128, num_classes=N_CLASS, num_convs=1,
                       kernel_size=1)
    cv = jhead.init(jax.random.PRNGKey(1),
                    jnp.zeros((1, CROP // 4, CROP // 4, 128)), train=False)
    params = {"model": mv["params"], "classifier": cv["params"]}
    stats = {"model": mv["batch_stats"], "classifier": cv["batch_stats"]}
    tx, _ = jax_make_optimizer(jcfg, 1)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params),
        memory=jax_init_memory(jax.random.PRNGKey(2), 3, N_DATA, 128))
    jstep = jseg.make_segment_train_step(jcfg, jmodel, jhead,
                                         steps_per_epoch=1)

    model = build_model(cfg, device="cpu")
    head = FCNHead(128, N_CLASS)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=1,
                               classifier=head)
    _sync(state, jstate)
    step = seg.make_segment_train_step(cfg, model, head, steps_per_epoch=1)
    return state, step, jstate, jstep


def _want(jstate):
    """JAX's model and classifier trees as the port's state dicts."""
    p, s = jstate.params, jstate.batch_stats
    return (flax_to_port_state_dict(p["model"], s["model"]),
            fcn_flax_to_torch(p["classifier"], s["classifier"]))


def _sync(state, jstate, stats=True):
    """The port's params (and BN statistics) and banks from JAX's."""
    model_sd, head_sd = _want(jstate)
    with torch.no_grad():
        if stats:
            state.model.load_state_dict(model_sd, strict=True)
            state.classifier.load_state_dict(head_sd, strict=True)
        else:
            for mod, sd in ((state.model, model_sd),
                            (state.classifier, head_sd)):
                for name, p in mod.named_parameters():
                    p.copy_(sd[name])
        state.banks.copy_(_t(jstate.memory.banks))


def _compare(state, m, jstate, jm, sup, label):
    keys = METRICS + (("loss_seg",) if sup else ())
    assert ("loss_seg" in m) == sup and set(keys) <= set(m)
    for k in keys:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                   err_msg=f"{label} {k}")
    np.testing.assert_allclose(state.banks.numpy(),
                               np.asarray(jstate.memory.banks), **TOL)
    model_sd, head_sd = _want(jstate)
    for mod, sd in ((state.model, model_sd), (state.classifier, head_sd)):
        for name, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), sd[name].numpy(),
                                       **TOL, err_msg=f"{label} {name}")
    got = state.classifier.state_dict()
    for name in ("convs.0.norm_name.running_mean",
                 "convs.0.norm_name.running_var"):
        np.testing.assert_allclose(got[name].numpy(), head_sd[name].numpy(),
                                   **TOL, err_msg=f"{label} {name}")


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("supervise_type", [0, 1, 2, 3])
def test_two_segment_steps_match_jax(monkeypatch, supervise_type, fuse):
    """With supervise_type 3 the classifier is not in the loss: its
    parameters still decay and run their momentum, as JAX's do."""
    if fuse:
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1")
    else:
        monkeypatch.delenv("HCMOCO_CONVBN_FUSE", raising=False)
    state, step, jstate, jstep = _setup(supervise_type)
    head_start = {k: v.clone() for k, v in state.classifier.state_dict()
                  .items()}
    sup = supervise_type != 3
    for i, b in enumerate(seg_batches(2)):
        if i:
            _sync(state, jstate, stats=False)
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step(state, {k: _t(v) for k, v in b.items()})
        _compare(state, m, jstate, jm, sup, f"step {i}")
    assert state.step == int(jstate.step) == 2
    head_now = state.classifier.state_dict()
    assert not torch.equal(head_now["conv_seg.weight"],
                           head_start["conv_seg.weight"])
    moved = not torch.equal(head_now["convs.0.norm_name.running_mean"],
                            head_start["convs.0.norm_name.running_mean"])
    assert moved == sup


def test_segment_step_without_labelled_frames():
    """true_label all 0: loss_seg is 0 (no host sync), and the head's BN
    still updates its running statistics with n clamped to 1 (mean and
    variance 0), as JAX's does."""
    state, step, jstate, jstep = _setup(0)
    b = seg_batches(1)[0]
    b["true_label"] = np.zeros_like(b["true_label"])
    jstate, jm = jstep(jstate, b, jax.random.PRNGKey(0))
    m = step(state, {k: _t(v) for k, v in b.items()})
    assert float(m["loss_seg"]) == float(jm["loss_seg"]) == 0.0
    _compare(state, m, jstate, jm, True, "no labels")
    bn = state.classifier.convs[0].norm_name
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9, rtol=1e-6)
    assert float(bn.running_mean.abs().max()) == 0.0


def test_segment_step_draws_from_the_generator():
    """Without neg_idx and pix_idx the step draws both from its
    generator: the same generator state gives the same step."""
    cfg = resolve_config(TrainConfig(**TINY))
    b = {k: _t(v) for k, v in seg_batches(1)[0].items()
         if k not in ("neg_idx", "pix_idx")}
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
        head = FCNHead(128, N_CLASS)
        st = create_train_state(cfg, model, torch.Generator().manual_seed(1),
                                n_data=N_DATA, steps_per_epoch=1,
                                classifier=head)
        step = seg.make_segment_train_step(cfg, model, head, 1)
        runs.append(step(st, b, torch.Generator().manual_seed(2)))
    for k in METRICS + ("loss_seg",):
        assert np.isfinite(float(runs[0][k])), k
        assert float(runs[0][k]) == float(runs[1][k]), k


@pytest.mark.slow
def test_seg_trainer_loss_curve_matches_reference():
    """The port's W18 versatility step (supervise_type 0, cmc 0.5, other
    2.0) against the reference trainer (`train_soft_joint_pri3d`) on the
    golden's pinned weights (model and FCN head), banks, batches,
    negatives and pixels, by the criteria of tests/test_ref_parity.py::
    test_seg_trainer_loss_curve_matches_reference: step 0 within rtol
    1e-3, then the mean deviation within twice the reference's own
    perturbation envelope or 2% of the loss's scale."""
    golden = np.load(os.path.join(HERE, "golden", "ref_loss_curve_sseg.npz"))
    steps = int(golden["steps"])
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGBD2S", arch="HRNet", width=18,
        mem="bank+jointspri3d", linear_feat_map=True, nce_k=pc.NCE_K,
        nce_m=pc.NCE_M, nce_t=pc.NCE_T, temperature=0.07,
        pri3d_num_samples_per_image=8, batch_size=pc.BSZ, epochs=100,
        learning_rate=pc.LR, momentum=pc.MOMENTUM,
        weight_decay=pc.WEIGHT_DECAY, cosine=False, warm=False,
        modality_missing=True, compute_dtype="float32", crop_size=pc.CROP,
        n_class=25, supervise_type=0, cmc_loss_weights=0.5,
        other_loss_weights=2.0))
    batches = pc.synth_seg_batches(steps=steps, n_class=cfg.n_class)
    pix = pc.stage2_pixel_indices(batches, cfg.pri3d_num_samples_per_image)

    def load(module, keys_file):
        sd = pc.synth_state_dict(pc.read_keys_file(
            os.path.join(HERE, "golden", keys_file)))
        module.load_state_dict({k: torch.from_numpy(v).to(
            torch.long if k.endswith("num_batches_tracked")
            else torch.float32) for k, v in sd.items()}, strict=True)

    model = HCMoCoModel(width=18, linear_feat_map=True, dtype=torch.float32)
    load(model, "hcmoco_w18_torch_keys.txt")
    head = FCNHead(128, cfg.n_class)
    load(head, "fcn_torch_keys.txt")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=pc.N_DATA, steps_per_epoch=steps,
                               classifier=head)
    state.banks.copy_(_t(pc.synth_banks()))
    step = seg.make_segment_train_step(cfg, model, head, steps)
    keys = ("loss", "loss_rgb2depth", "loss_depth2rgb", "loss_rgb2joint",
            "loss_d2joint", "loss_scl", "loss_seg")
    got = {k: [] for k in keys}
    for b, p in zip(batches, pix):
        tb = {k: _t(v) for k, v in b.items() if k != "scale"}
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
