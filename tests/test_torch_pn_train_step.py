"""Two stage-1 HRNetPN train steps of hcmoco_tpu_torch held against
hcmoco_tpu's jitted step, in f32 on the CPU at tiny size: width-4 HRNet,
32^2 crops, 64 depth points, NCE K=15.

Both start from the JAX package's initial weights and banks, and step 2
from JAX's step-1 weights and banks (as tests/test_torch_train_step.py
does).  The draws are pinned: the negatives (JAX takes `neg_idx`, the
port the counts of the same draw) and the depth2pts uniforms (JAX's
depth2pts is handed a fixed key, the port the uniforms
`jax.random.uniform` draws from it, as the batch's `pts_u`).  The batches
come from the synthetic source, so some samples have no depth and their
clouds are all zeros.

Compared after each step, at rtol 1e-4, atol 1e-5 (the HRNet step's
tolerance): the loss, the per-direction losses of modalities 1 and 3, the
learning rate, banks 1 and 3, every parameter and BN running statistic
outside the point encoder (encoder2), and head2.  The point encoder is
f32-ill-conditioned at this size (tests/test_torch_pointnet2.py): its
forward parts from any other f32 implementation by ~1e-4 relative, so the
four losses of directions with modality 2 and bank 2 are held to rtol
1e-3, atol 5e-4 (the test prints how far they part: 3.9e-4 relative and
1.4e-4 at most).  The NCE loss reaches it
through a mean over the points, whose gradient each BN's backward nearly
cancels, so its gradient is the remainder of that cancellation and two f32
steps part by about the size of the update itself.  Its gradients are
held against JAX in float64 by test_torch_pointnet2.py.  Here encoder2 is
held to the float64 truth instead: the same port step with encoder2 in
float64.  Over the whole encoder, the port's f32 parameters must lie
within twice the distance of JAX's f32 ones from it (measured: 0.48 vs
1.0 after step 1, 0.014 vs 0.63 after step 2), every parameter must move,
and its BN running means and variances (forward statistics) must match
JAX's within 1e-3 of each tensor's largest magnitude.
"""

import copy

import jax
import numpy as np
import torch

from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu.models import pointnet2_model as jax_pn
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

from torch_parity_common import bn_rows, counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K, N_POINTS = 64, 6, 32, 15, 64
TOL = dict(rtol=1e-4, atol=1e-5)
PN_TOL = dict(rtol=1e-3, atol=5e-4)  # what the point cloud's feature feeds
METRICS = ["loss"] + [f"nce_loss_{d}" for d in
                      ("12", "21", "23", "32", "13", "31")]
POINTS_KEY = jax.random.PRNGKey(11)

TINY = dict(method="Customize", modal="RGBD2S", arch="HRNetPN", width=4,
            mem="bank", nce_k=NCE_K, nce_t=0.07, batch_size=BSZ, epochs=4,
            learning_rate=0.01, cosine=True, modality_missing=True,
            compute_dtype="float32", pn_num_points=N_POINTS)
KEYS = ("rgbd", "index", "skeleton", "use_depth", "use_rgb", "depth_mask",
        "grid_xy", "depth_mean")


def batches(n):
    out = []
    rng = np.random.default_rng(3)
    for _ in range(n):
        b = synthetic_contrast_batch(rng, BSZ, size=CROP, n_data=N_DATA)
        neg = rng.integers(0, N_DATA, (BSZ, NCE_K + 1)).astype(np.int64)
        neg[:, 0] = b["index"]
        b["neg_idx"] = neg
        out.append({k: b[k] for k in KEYS + ("neg_idx",)})
    assert 0 < sum(int(b["use_depth"].sum()) for b in out) < n * BSZ
    return out


def to_port(b):
    t = {k: torch.from_numpy(v) for k, v in b.items() if k != "neg_idx"}
    t["counts"] = counts_from_indices(torch.from_numpy(b["neg_idx"]), N_DATA)
    t["pts_u"] = torch.from_numpy(np.array(
        jax.random.uniform(POINTS_KEY, (BSZ, N_POINTS))))
    return t


def f64_reference(state):
    """A copy of the train state whose model's encoder2 runs in float64
    (its parameters converted in place, so the copied optimizer keeps
    them)."""
    ref = copy.deepcopy(state)
    ref.model.encoder2.double()
    for mod in ref.model.encoder2.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return ref


def _sq(d):
    return sum(float(((a.double() - b.double()) ** 2).sum())
               for a, b in d)


def test_two_steps_match_jax(monkeypatch):
    two_steps_match_jax(monkeypatch)


def two_steps_match_jax(monkeypatch, **fields):
    """The comparison of test_two_steps_match_jax, with the TrainConfig
    `fields` on both sides (tests/test_torch_remat.py: pn_remat)."""
    orig = jax_pn.depth2pts
    monkeypatch.setattr(jax_pn, "depth2pts",
                        lambda *a: orig(*a[:6], POINTS_KEY, a[7]))
    cfg = resolve_config(TrainConfig(**TINY, **fields))
    jcfg = jax_resolve_config(JaxTrainConfig(**TINY, **fields))
    bs = batches(2)

    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, jax.random.PRNGKey(0), bs[0],
                              n_data=N_DATA, steps_per_epoch=1)
    jstep = jax_make_step(jcfg, jmodel, steps_per_epoch=1)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        flax_to_port_state_dict(jstate.params, jstate.batch_stats),
        strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=1)
    state.banks.copy_(torch.from_numpy(np.array(jstate.memory.banks)))
    step = make_contrast_train_step(cfg, model, steps_per_epoch=1)
    pb0 = to_port(bs[0])
    rows = bn_rows(model, pb0["rgbd"].permute(0, 3, 1, 2), pb0["skeleton"],
                   pb0["depth_mask"], pb0["grid_xy"], cfg.pn_ori_h,
                   cfg.pn_ori_w, pb0["depth_mean"], None, pb0["pts_u"])
    enc2_rows = {k for k in rows if k.startswith("encoder2.")}
    assert len(enc2_rows) == 24 and len(rows) > 24
    bn_momentum = {k: mod.momentum for k, mod in model.named_modules()
                   if k in rows}

    for i, b in enumerate(bs):
        if i:
            sync = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(sync[name])
                state.banks.copy_(torch.from_numpy(
                    np.array(jstate.memory.banks)))
        pb = to_port(b)
        # the float64 truth for encoder2: the same step from the same state
        ref = f64_reference(state)
        ref_step = make_contrast_train_step(cfg, ref.model,
                                            steps_per_epoch=1)
        jstats_before = jstate.batch_stats
        jparams_before = jstate.params
        before = {k: v.clone() for k, v in model.state_dict().items()}
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step(state, pb)
        ref_step(ref, pb)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **(PN_TOL if "2" in k else TOL),
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["learning_rate"],
                                   float(jm["learning_rate"]), rtol=1e-6)
        apart = max(abs(float(m[k]) / float(jm[k]) - 1)
                    for k in METRICS if "2" in k)
        bank2 = np.abs(state.banks[1].numpy()
                       - np.asarray(jstate.memory.banks)[1]).max()
        print(f"step {i}: modality-2 losses apart by at most {apart:.3g} "
              f"relative, bank 2 by {bank2:.3g}")
        for mod, bank in enumerate(np.asarray(jstate.memory.banks)):
            np.testing.assert_allclose(state.banks[mod].numpy(), bank,
                                       **(PN_TOL if mod == 1 else TOL),
                                       err_msg=f"step {i} bank {mod + 1}")
        want = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
        start = flax_to_port_state_dict(jparams_before, jstate.batch_stats)
        truth = dict(ref.model.named_parameters())
        enc2 = []
        for name, p in model.named_parameters():
            assert not torch.equal(p.detach(), start[name]), name
            if name.startswith("encoder2."):
                enc2.append((name, p.detach(), want[name],
                             truth[name].detach()))
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **TOL, err_msg=f"step {i} {name}")
        port_err = _sq((p, t) for _, p, _, t in enc2)
        jax_err = _sq((w, t) for _, _, w, t in enc2)
        print(f"step {i}: encoder2 |port - f64| {port_err ** 0.5:.4g}, "
              f"|jax - f64| {jax_err ** 0.5:.4g}, update "
              f"{_sq((w, start[n]) for n, _, w, _ in enc2) ** 0.5:.4g}")
        assert port_err ** 0.5 <= 2 * jax_err ** 0.5, (port_err, jax_err)
        # BN running stats: torch's unbiased variance (see
        # torch_parity_common.check_bn_stats); encoder2's at 1e-3
        jbefore = flax_to_port_state_dict(jparams_before, jstats_before)
        got = model.state_dict()
        for name, n in rows.items():
            keep = 1.0 - bn_momentum[name]
            w_var = (keep * before[f"{name}.running_var"].double()
                     + (want[f"{name}.running_var"].double()
                        - keep * jbefore[f"{name}.running_var"].double())
                     * n / (n - 1))
            for stat, w in (("running_mean",
                             want[f"{name}.running_mean"].double()),
                            ("running_var", w_var)):
                tol = (dict(rtol=1e-3, atol=1e-3 * float(w.abs().max()))
                       if name in enc2_rows else TOL)
                np.testing.assert_allclose(
                    got[f"{name}.{stat}"].double().numpy(), w.numpy(),
                    **tol, err_msg=f"step {i} {name}.{stat}")
    assert state.step == int(jstate.step) == 2
