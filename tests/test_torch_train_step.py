"""Two stage-1 train steps of hcmoco_tpu_torch held against hcmoco_tpu's
jitted step, in f32 on the CPU at tiny size, with HCMOCO_CONVBN_FUSE on
and off on both sides.

Both start from the JAX package's initial weights and banks, and step 2
from JAX's step-1 weights and banks (see the comment in the test).  The
negative draw is pinned: JAX takes `neg_idx` (its parity-harness route), the port
the counts of the same draw.  Compared after each step: loss, the six
per-direction losses, the banks, every parameter (which carries the SGD
momentum of step 1 into step 2) and the BN running statistics.

Tolerance rtol 1e-4, atol 1e-5, at lr 0.01: with lr 0.03 the first step
moves the tiny encoders far enough that the second step's f32 rounding
differences reach 4e-5 relative in the loss.  One known, bounded difference: the JAX
SemGCN stores its bias as reference bias + 1/sqrt(128) and its weight decay
acts on that shifted value, so those biases differ by lr * wd * 0.088
(< 1e-6 over two steps), inside the tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.contrast_step import device_normalize as jax_normalize
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import (device_normalize,
                                                  make_contrast_train_step)
from hcmoco_tpu_torch.train.state import create_train_state

from parity_common import synth_batches
from torch_parity_common import bn_rows, check_bn_stats, counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K = 64, 6, 32, 15
TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ["loss"] + [f"nce_loss_{d}" for d in
                      ("12", "21", "23", "32", "13", "31")]


TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank", nce_k=NCE_K, nce_t=0.07, batch_size=BSZ, epochs=4,
            learning_rate=0.01, cosine=True, modality_missing=True,
            compute_dtype="float32")


def tiny_cfg():
    return resolve_config(TrainConfig(**TINY))


def jax_tiny_cfg():
    return jax_resolve_config(JaxTrainConfig(**TINY))


def batches(n):
    """The reference-parity harness's batches: pinned neg_idx, use_depth
    and use_rgb masks.  (Its rgbd is N(0, 0.25) in every channel; the
    synthetic source's all-zero depth samples leave the tiny depth encoder
    so ill-conditioned that the two frameworks' f32 maps part by ~5e-4.)"""
    return [{k: b[k] for k in ("rgbd", "index", "skeleton", "use_depth",
                               "use_rgb", "neg_idx")}
            for b in synth_batches(steps=n, bsz=BSZ, crop=CROP,
                                   n_data=N_DATA, k=NCE_K)]


def to_port(b):
    t = {k: torch.from_numpy(v) for k, v in b.items() if k != "neg_idx"}
    t["counts"] = counts_from_indices(torch.from_numpy(b["neg_idx"]), N_DATA)
    return t


@pytest.mark.parametrize("fuse", [False, True])
def test_two_steps_match_jax(monkeypatch, fuse):
    if fuse:
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1")
    else:
        monkeypatch.delenv("HCMOCO_CONVBN_FUSE", raising=False)
    cfg, jcfg = tiny_cfg(), jax_tiny_cfg()
    bs = batches(2)

    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, jax.random.PRNGKey(0), bs[0],
                              n_data=N_DATA, steps_per_epoch=1)
    jstep = jax_make_step(jcfg, jmodel, steps_per_epoch=1)

    model = build_model(cfg)
    model.load_state_dict(
        flax_to_port_state_dict(jstate.params, jstate.batch_stats),
        strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=1)
    state.banks.copy_(torch.from_numpy(np.array(jstate.memory.banks)))
    step = make_contrast_train_step(cfg, model, steps_per_epoch=1)
    rows = bn_rows(model, torch.from_numpy(bs[0]["rgbd"]).permute(0, 3, 1, 2),
                   torch.from_numpy(bs[0]["skeleton"]))

    n_bn = sum(k.endswith("running_var") for k in model.state_dict())
    for i, b in enumerate(bs):
        if i:
            # Start step 2 from JAX's params and banks (the port keeps its
            # own momentum buffers and BN stats): the 4e-7 by which step 1
            # leaves the params apart puts an element of the 1x1-spatial
            # branch on the other side of a ReLU kink, which moves the
            # depth encoder's step-2 grads by 2.5%.
            sync = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(sync[name])
                state.banks.copy_(torch.from_numpy(
                    np.array(jstate.memory.banks)))
        jstats_before = jstate.batch_stats
        jparams_before = jstate.params
        before = {k: v.clone() for k, v in model.state_dict().items()}
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step(state, to_port(b))
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["learning_rate"],
                                   float(jm["learning_rate"]), rtol=1e-6)
        np.testing.assert_allclose(state.banks.numpy(),
                                   np.asarray(jstate.memory.banks), **TOL)
        want = flax_to_port_state_dict(jstate.params, jstate.batch_stats)
        start = flax_to_port_state_dict(jparams_before, jstate.batch_stats)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **TOL, err_msg=f"step {i} {name}")
            assert not torch.equal(want[name], start[name]), name
        assert check_bn_stats(model, before, jstate.params, jstats_before,
                              jstate.batch_stats, rows, **TOL) == n_bn
    assert state.step == int(jstate.step) == 2


def test_step_samples_negatives_with_generator():
    """Without pinned counts the step draws them from the generator; the
    loss is finite, params move, touched bank rows stay unit-norm."""
    cfg = tiny_cfg()
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    state = create_train_state(cfg, model, g, n_data=N_DATA,
                               steps_per_epoch=1)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=1)
    b = {k: v for k, v in to_port(batches(1)[0]).items() if k != "counts"}
    w0 = model.head1[0].weight.detach().clone()
    banks0 = state.banks.clone()
    m = step(state, b, g)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(w0, model.head1[0].weight)
    rows = b["index"].long().unique()
    assert not torch.equal(banks0[:, rows], state.banks[:, rows])
    torch.testing.assert_close(state.banks.norm(dim=-1),
                               torch.ones(state.banks.shape[:2]))


def test_device_normalize_matches_jax():
    """Raw uint8 rgb + uint16 depth-mm become the same normalised rgbd."""
    rng = np.random.default_rng(5)
    raw = {"rgb_u8": rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
           "depth_mm": rng.integers(0, 6000, (2, 8, 8)).astype(np.uint16),
           "index": np.arange(2)}
    want = jax_normalize(dict(raw))
    got = device_normalize({k: torch.from_numpy(v.astype(np.int32))
                            if v.dtype == np.uint16 else torch.from_numpy(v)
                            for k, v in raw.items()})
    assert set(got) == set(want) == {"rgbd", "index"}
    np.testing.assert_allclose(got["rgbd"].numpy(), np.asarray(want["rgbd"]),
                               rtol=1e-6, atol=1e-6)
    batch = {"rgbd": torch.zeros(1)}
    assert device_normalize(batch) is batch
