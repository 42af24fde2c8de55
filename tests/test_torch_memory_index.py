"""The index form of the port's bank NCE (contrast/memory.py:
sample_negative_indices, memory_logits, cmc3_forward in its 'dense',
'hybrid' and 'gather' modes) and the contrast step's mode switch and
--microbatch, held against hcmoco_tpu's on the same seeded numpy inputs
and pinned draws, in f32 on the CPU.

Tolerances: the NCE functions' logits, feature gradients and banks
within rtol 1e-5 plus 1e-6 of the tensor's largest magnitude (the same
f32 products summed in another order: a gradient sums K+1 terms of
either sign, so its small elements carry the rounding of the large
ones); the modes against each other the same; the train steps rtol 1e-4,
atol 1e-5, the stage-1 step tests' (tests/test_torch_train_step.py), at
lr 0.01.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.contrast import memory as jmem
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.contrast import memory as mem
from hcmoco_tpu_torch.contrast.losses import per_sample_nce
from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import (make_contrast_train_step,
                                                  nce_mode)
from hcmoco_tpu_torch.train.state import create_train_state

from parity_common import synth_batches
from torch_parity_common import bn_rows, check_bn_stats, counts_from_indices

torch.set_num_threads(1)

def close(got, want, what=""):
    """Within rtol 1e-5 and 1e-6 of want's largest magnitude."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = (want.detach().numpy() if torch.is_tensor(want)
            else np.asarray(want))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


STEP_TOL = dict(rtol=1e-4, atol=1e-5)
MODES = ("dense", "hybrid", "gather")
N_DATA, BSZ, CROP, NCE_K = 64, 6, 32, 15
METRICS = ["loss"] + [f"nce_loss_{d}" for d in
                      ("12", "21", "23", "32", "13", "31")]


def _nce_inputs(bsz=5, n_data=300, k=2100, dim=16, seed=0):
    """feats (3, bsz, dim) unit rows, banks (3, n_data, dim) unit rows, y,
    a pinned (bsz, K+1) draw with the positive in column 0 (K+1 above one
    1024-column chunk, and not a multiple of it), and cotangents."""
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    feats, banks = unit(3, bsz, dim), unit(3, n_data, dim)
    y = rng.choice(n_data, bsz, replace=False).astype(np.int64)
    idx = rng.integers(0, n_data, (bsz, k + 1)).astype(np.int64)
    idx[:, 0] = y
    cot = rng.standard_normal((6, bsz, k + 1)).astype(np.float32)
    return feats, banks, y, idx, cot


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_forward(feats, banks, y, idx, cot, mode, m=0.5, t=0.07):
    f = _t(feats).requires_grad_(True)
    b = _t(banks)
    logits, commit = mem.cmc3_forward(b, f, _t(y), f, _t(y), k=idx.shape[1]
                                      - 1, temperature=t, m=m,
                                      neg_idx=_t(idx), mode=mode)
    torch.sum(torch.stack(logits) * _t(cot)).backward()
    commit()
    return torch.stack(logits).detach(), f.grad, b


def _jax_forward(feats, banks, y, idx, cot, mode, m=0.5, t=0.07):
    state = jmem.MemoryState(banks=jnp.asarray(banks))

    def f(x):
        logits, new = jmem.cmc3_forward(
            state, x, jnp.asarray(y), x, jnp.asarray(y),
            jax.random.PRNGKey(0), k=idx.shape[1] - 1, temperature=t, m=m,
            neg_idx=jnp.asarray(idx), mode=mode)
        return jnp.sum(jnp.stack(logits) * cot), (jnp.stack(logits), new)

    (_, (logits, new)), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(feats))
    return np.asarray(logits), np.asarray(grad), np.asarray(new.banks)


# ---- the sampler ---------------------------------------------------------------


def test_sample_negative_indices_positive_first_and_uniform():
    g = torch.Generator().manual_seed(0)
    y = torch.tensor([3, 17, 0, 99])
    n_data, k = 100, 20000
    idx = mem.sample_negative_indices(g, y, n_data, k)
    assert idx.shape == (4, k + 1) and idx.dtype == torch.int64
    assert torch.equal(idx[:, 0], y)
    assert int(idx.min()) >= 0 and int(idx.max()) < n_data
    # every row's negatives uniform over the bank: chi-square with 99
    # degrees of freedom, its 1e-6 tail at 185
    for row in idx[:, 1:]:
        hist = torch.bincount(row, minlength=n_data).double()
        chi2 = float(((hist - k / n_data) ** 2 / (k / n_data)).sum())
        assert chi2 < 185.0, chi2
    again = mem.sample_negative_indices(torch.Generator().manual_seed(0), y,
                                        n_data, k)
    assert torch.equal(idx, again)


# ---- logits and gradients against the JAX package ----------------------------------


@pytest.mark.parametrize("dense", [True, False])
def test_memory_logits_match_jax(dense):
    feats, banks, _, idx, cot = _nce_inputs()
    x = _t(feats[0]).requires_grad_(True)
    got = mem.memory_logits(x, _t(banks[1]), _t(idx), 0.07,
                            dense_scores=dense)
    (got * _t(cot[0])).sum().backward()

    def f(xx):
        lg = jmem.memory_logits(xx, jnp.asarray(banks[1]), jnp.asarray(idx),
                                0.07, dense_scores=dense)
        return jnp.sum(lg * cot[0]), lg

    (_, want), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(feats[0]))
    close(got, want, "logits")
    close(x.grad, grad, "grad")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [15, 2100])
def test_cmc3_forward_matches_jax(mode, k):
    """Logits, the features' gradient of a cotangent and the banks after
    the EMA update (duplicate indices in y: the last wins), at K+1 within
    one chunk and across three ragged ones."""
    feats, banks, y, idx, cot = _nce_inputs(k=k)
    y[1] = y[3]  # a duplicate bank row
    idx[:, 0] = y
    got_l, got_g, got_b = _port_forward(feats, banks, y, idx, cot, mode)
    want_l, want_g, want_b = _jax_forward(feats, banks, y, idx, cot, mode)
    close(got_l, want_l, "logits")
    close(got_g, want_g, "grad")
    close(got_b, want_b, "banks")


def test_cmc3_modes_agree():
    feats, banks, y, idx, cot = _nce_inputs(seed=4)
    ref_l, ref_g, ref_b = _port_forward(feats, banks, y, idx, cot, "dense")
    for mode in ("hybrid", "gather"):
        l, g, b = _port_forward(feats, banks, y, idx, cot, mode)
        close(l, ref_l, mode)
        close(g, ref_g, mode)
        assert torch.equal(b, ref_b)


def test_cmc3_forward_mode_default_and_draw():
    """mode None: 'dense' with dense_scores, else 'hybrid' (the same
    logits); without neg_idx the generator draws, with the positive in
    column 0 (its logit is the positive score)."""
    feats, banks, y, idx, cot = _nce_inputs(k=40)
    f, b = _t(feats), _t(banks)
    a, _ = mem.cmc3_forward(b, f, _t(y), f, _t(y), 40, 0.07,
                            neg_idx=_t(idx))
    h, _ = mem.cmc3_forward(b, f, _t(y), f, _t(y), 40, 0.07,
                            neg_idx=_t(idx), dense_scores=False)
    close(torch.stack(h), torch.stack(a))
    drawn, _ = mem.cmc3_forward(b, f, _t(y), f, _t(y), 40, 0.07,
                                generator=torch.Generator().manual_seed(1))
    assert drawn[0].shape == (5, 41)
    pos = (f[0] * b[1][_t(y)]).sum(-1) / 0.07
    close(drawn[0][:, 0], pos)
    with pytest.raises(ValueError, match="neg_idx or a generator"):
        mem.cmc3_forward(b, f, _t(y), f, _t(y), 40, 0.07)


def test_counts_form_equals_index_form():
    """On the same draw the count-weighted NCE is the index form's CE to
    column 0, loss and top-1 alike, and so are their feature gradients."""
    feats, banks, y, idx, _ = _nce_inputs(k=40, seed=7)
    f1 = _t(feats).requires_grad_(True)
    per_counts = mem.cmc3_losses_counts(
        f1, _t(banks), _t(y), k=40, temperature=0.07,
        counts=counts_from_indices(_t(idx), banks.shape[1]))
    f2 = _t(feats).requires_grad_(True)
    logits, _ = mem.cmc3_forward(_t(banks), f2, _t(y), f2, _t(y), 40, 0.07,
                                 neg_idx=_t(idx), mode="gather")
    per_index = [per_sample_nce(lg) for lg in logits]
    for (ce_c, ok_c), (ce_i, ok_i) in zip(per_counts, per_index):
        close(ce_c, ce_i)
        assert torch.equal(ok_c, ok_i)
    sum(ce.sum() for ce, _ in per_counts).backward()
    sum(ce.sum() for ce, _ in per_index).backward()
    close(f1.grad, f2.grad)


# ---- the contrast step ------------------------------------------------------------


def test_nce_mode_switch():
    cfg = TrainConfig()
    assert nce_mode(cfg, 1000, False) == "counts"
    assert nce_mode(cfg, 1000, True) == "dense"
    assert nce_mode(cfg, cfg.counts_max_n_data + 1, False) == "gather"
    assert nce_mode(cfg, cfg.counts_max_n_data + 1, True) == "gather"
    for mode in ("dense", "hybrid"):
        c = dataclasses.replace(cfg, bank_logits=mode)
        assert nce_mode(c, 1000, False) == mode
        assert nce_mode(c, cfg.counts_max_n_data + 1, False) == "gather"
    assert nce_mode(dataclasses.replace(cfg, dense_scores=True), 10,
                    False) == "dense"
    with pytest.raises(ValueError, match="unknown mode"):
        nce_mode(dataclasses.replace(cfg, bank_logits="nope"), 10, False)


TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank", nce_k=NCE_K, nce_t=0.07, batch_size=BSZ, epochs=4,
            learning_rate=0.01, cosine=True, modality_missing=True,
            compute_dtype="float32")
# each step mode as the config that selects it
STEP_MODES = {"dense": dict(bank_logits="dense"),
              "hybrid": dict(bank_logits="hybrid"),
              "gather": dict(counts_max_n_data=N_DATA - 1)}


def _batches(n, bsz=BSZ):
    return [{k: b[k] for k in ("rgbd", "index", "skeleton", "use_depth",
                               "use_rgb", "neg_idx")}
            for b in synth_batches(steps=n, bsz=bsz, crop=CROP,
                                   n_data=N_DATA, k=NCE_K)]


def _two_steps(kw, bsz=BSZ):
    """Two steps of the port's and of JAX's stage-1 step on pinned draws
    (neg_idx on both sides); step 2 from JAX's step-1 params and banks."""
    kw = dict(TINY, batch_size=bsz, **kw)
    cfg = resolve_config(TrainConfig(**kw))
    jcfg = jax_resolve_config(JaxTrainConfig(**kw))
    bs = _batches(2, bsz)
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
    state.banks.copy_(_t(jstate.memory.banks))
    step = make_contrast_train_step(cfg, model, steps_per_epoch=1)
    n_micro = cfg.microbatch
    rows = bn_rows(model, _t(bs[0]["rgbd"][:bsz // n_micro]).permute(
        0, 3, 1, 2), _t(bs[0]["skeleton"][:bsz // n_micro]))
    n_bn = sum(k.endswith("running_var") for k in model.state_dict())
    for i, b in enumerate(bs):
        if i:
            sync = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(sync[name])
                state.banks.copy_(_t(jstate.memory.banks))
        jstats_before = jstate.batch_stats
        before = {k: v.clone() for k, v in model.state_dict().items()}
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step(state, {k: _t(v) for k, v in b.items()})
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(state.banks.numpy(),
                                   np.asarray(jstate.memory.banks),
                                   **STEP_TOL)
        want = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **STEP_TOL, err_msg=f"step {i} {name}")
        # BN running statistics, chained through the microbatches: a
        # training forward never reads them, so only this catches them
        assert check_bn_stats(model, before, jstate.params, jstats_before,
                              jstate.batch_stats, rows, **STEP_TOL,
                              updates=n_micro) == n_bn
    assert state.step == int(jstate.step) == 2
    return state


@pytest.mark.parametrize("mode", sorted(STEP_MODES))
def test_step_in_each_mode_matches_jax(mode):
    """'gather' is reached as the JAX step reaches it: n_data above
    counts_max_n_data."""
    cfg = resolve_config(TrainConfig(**dict(TINY, **STEP_MODES[mode])))
    assert nce_mode(cfg, N_DATA, True) == mode
    _two_steps(STEP_MODES[mode])


def test_microbatch_two_steps_match_jax():
    """--microbatch 2: JAX's train_step_microbatch (grads averaged over
    the two halves, BN statistics and banks chained, metrics the halves'
    mean) against the port's, two steps.  Batch 12, so that each half's
    BN sees the 6 samples of the other step tests (at 3 a half the tiny
    model's 1x1-spatial branch leaves BN too ill-conditioned to compare
    two f32 implementations)."""
    _two_steps(dict(microbatch=2), bsz=2 * BSZ)


def test_microbatch_equals_its_halves_by_hand():
    """A microbatch-2 step is two half-batch forward/backward passes of
    loss/2 with the banks updated after each, then one SGD step."""
    from hcmoco_tpu_torch.train.contrast_step import (fill_missing_grads,
                                                      make_contrast_loss_fn)
    from hcmoco_tpu_torch.train.schedules import learning_rate_fn
    cfg = resolve_config(TrainConfig(**dict(TINY, microbatch=2)))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    b = {k: _t(v) for k, v in _batches(1)[0].items()}
    runs = []
    for by_hand in (False, True):
        st = create_train_state(cfg, copy.deepcopy(model),
                                torch.Generator().manual_seed(1),
                                n_data=N_DATA, steps_per_epoch=1)
        if not by_hand:
            make_contrast_train_step(cfg, st.model, 1)(st, b)
        else:
            loss_fn = make_contrast_loss_fn(cfg, st.model)
            for g in st.optimizer.param_groups:
                g["lr"] = learning_rate_fn(cfg, 1)(0)
            st.optimizer.zero_grad(set_to_none=True)
            for half in range(2):
                part = {k: v[half * 3:(half + 1) * 3] for k, v in b.items()}
                loss, _, commit = loss_fn(st, part)
                (loss / 2).backward()
                commit()
            fill_missing_grads(st.optimizer)
            st.optimizer.step()
        runs.append(st)
    for (name, p), q in zip(runs[0].model.named_parameters(),
                            runs[1].model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
    for (name, p), q in zip(runs[0].model.named_buffers(),
                            runs[1].model.buffers()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
    assert torch.equal(runs[0].banks, runs[1].banks)
    with pytest.raises(ValueError, match="does not divide"):
        make_contrast_train_step(
            resolve_config(TrainConfig(**dict(TINY, microbatch=4))),
            model, 1)(runs[0], b)


def test_index_mode_refuses_pinned_counts():
    cfg = resolve_config(TrainConfig(**dict(TINY, bank_logits="hybrid")))
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=1)
    b = {k: _t(v) for k, v in _batches(1)[0].items() if k != "neg_idx"}
    b["counts"] = torch.ones((BSZ, N_DATA))
    with pytest.raises(ValueError, match="neg_idx, not counts"):
        make_contrast_train_step(cfg, model, 1)(state, b)
