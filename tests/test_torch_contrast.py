"""hcmoco_tpu_torch's memory bank, NCE and LR schedule held against
hcmoco_tpu's (and the reference golden), in f32 on the CPU.

The port's sampler draws with torch's generator, so it is tested for its
distribution; the loss is compared with JAX's on the same counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.contrast import losses as jax_losses
from hcmoco_tpu.contrast import memory as jax_memory
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.train.schedules import learning_rate_fn as jax_lr_fn

from hcmoco_tpu_torch.contrast.losses import masked_six_way, per_sample_nce
from hcmoco_tpu_torch.contrast.memory import (
    cmc3_losses_counts, init_memory, sample_negative_counts, update_memory)
from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.train.schedules import learning_rate_fn

from torch_parity_common import counts_from_indices

torch.set_num_threads(1)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "contrast_golden.npz"))


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_cmc3_losses_counts_matches_jax():
    rng = np.random.default_rng(0)
    n_data, bsz, k, dim = 64, 6, 15, 16
    banks = _unit(rng, (3, n_data, dim))
    feats = _unit(rng, (3, bsz, dim))
    y = rng.choice(n_data, bsz, replace=False)
    counts = np.zeros((bsz, n_data), np.float32)
    for b in range(bsz):
        np.add.at(counts[b], rng.integers(0, n_data, k), 1.0)
    counts[0, y[0]] += 1.0  # the positive also drawn as a negative

    def jloss(f):
        out = jax_memory.cmc3_losses_counts(
            f, jnp.asarray(banks), jnp.asarray(y), None, k=k,
            temperature=0.07, counts=jnp.asarray(counts))
        return sum(jnp.sum(ce) for ce, _ in out), out

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(feats))

    ft = torch.from_numpy(feats).requires_grad_(True)
    out = cmc3_losses_counts(ft, torch.from_numpy(banks), torch.from_numpy(y),
                             k=k, temperature=0.07,
                             counts=torch.from_numpy(counts))
    sum(ce.sum() for ce, _ in out).backward()
    for (ce, cor), (jce, jcor) in zip(out, jout):
        np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(cor.numpy(), np.asarray(jcor))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-5)


def test_counts_form_equals_logits_form():
    """counts_from_indices + cmc3_losses_counts == per_sample_nce over the
    gathered (bsz, K+1) logits with the positive in column 0."""
    rng = np.random.default_rng(1)
    n_data, bsz, k, dim = 32, 5, 9, 8
    banks = torch.from_numpy(_unit(rng, (3, n_data, dim)))
    feats = torch.from_numpy(_unit(rng, (3, bsz, dim)))
    y = torch.from_numpy(rng.choice(n_data, bsz, replace=False))
    idx = torch.from_numpy(rng.integers(0, n_data, (bsz, k + 1)))
    idx[:, 0] = y
    idx[1, 3] = y[1]  # a drawn negative equal to the positive: a tie
    out = cmc3_losses_counts(feats, banks, y, k, 0.07,
                             counts=counts_from_indices(idx, n_data))
    for (ce, cor), (qi, bi) in zip(out, ((0, 1), (1, 0), (1, 2), (2, 1),
                                         (0, 2), (2, 0))):
        logits = torch.einsum("bkd,bd->bk", banks[bi][idx], feats[qi]) / 0.07
        ce_ref, cor_ref = per_sample_nce(logits)
        torch.testing.assert_close(ce, ce_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cor, cor_ref)


def test_per_sample_nce_matches_jax():
    logits = GOLDEN["ca_logits"]
    for lg in logits:
        jce, jcor = jax_losses.per_sample_nce(jnp.asarray(lg))
        ce, cor = per_sample_nce(torch.from_numpy(lg))
        np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(cor.numpy(), np.asarray(jcor))


def test_update_memory_matches_reference_with_duplicates():
    """Golden from the reference torch math: y holds a duplicate index and
    the last write wins."""
    bank = torch.from_numpy(GOLDEN["bank0"].copy())
    update_memory(bank, torch.from_numpy(GOLDEN["x"]),
                  torch.from_numpy(GOLDEN["y"]), m=0.5)
    np.testing.assert_allclose(bank.numpy(), GOLDEN["bank_updated"],
                               rtol=1e-5, atol=1e-6)


def test_update_memory_matches_jax():
    rng = np.random.default_rng(2)
    bank = _unit(rng, (40, 8))
    x = rng.standard_normal((9, 8)).astype(np.float32)
    y = np.array([3, 7, 3, 39, 0, 7, 7, 12, 3])
    want = jax_memory.update_memory(jnp.asarray(bank), jnp.asarray(x),
                                    jnp.asarray(y), 0.5)
    got = torch.from_numpy(bank.copy())
    update_memory(got, torch.from_numpy(x), torch.from_numpy(y), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_depth,use_rgb", [
    ([1, 0, 1, 1, 0, 1], None),
    ([0, 0, 0, 0, 0, 0], None),
    ([1, 0, 1, 1, 0, 1], [1, 1, 0, 1, 1, 1]),
    ([0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1]),
    (None, None),
])
def test_masked_six_way_matches_jax(use_depth, use_rgb):
    rng = np.random.default_rng(3)
    per = [(rng.uniform(0, 5, 6).astype(np.float32),
            (rng.random(6) < 0.5).astype(np.float32)) for _ in range(6)]

    def arr(v, mod):
        return None if v is None else mod(np.asarray(v))

    jl, ja = jax_losses.masked_six_way(
        [(jnp.asarray(c), jnp.asarray(a)) for c, a in per],
        arr(use_depth, jnp.asarray), arr(use_rgb, jnp.asarray))
    tl, ta = masked_six_way(
        [(torch.from_numpy(c), torch.from_numpy(a)) for c, a in per],
        arr(use_depth, torch.from_numpy), arr(use_rgb, torch.from_numpy))
    for got, want in zip(tl + ta, jl + ja):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_sample_negative_counts_distribution():
    g = torch.Generator().manual_seed(0)
    bsz, n_data, k = 8, 64, 4096
    c = sample_negative_counts(g, bsz, n_data, k)
    assert c.shape == (bsz, n_data) and c.dtype == torch.float32
    np.testing.assert_array_equal(c.sum(1).numpy(), np.full(bsz, k))
    assert bool((c == c.round()).all()) and bool((c >= 0).all())
    # Multinomial(k, uniform): mean k/n_data = 64, sd sqrt(k/n(1-1/n)) ~ 7.9
    mean = float(c.mean())
    assert mean == k / n_data
    sd = float(c.std())
    assert 6.5 < sd < 9.5, sd
    # different draws per row and per call
    assert not torch.equal(c[0], c[1])
    assert not torch.equal(c, sample_negative_counts(g, bsz, n_data, k))


def test_init_memory_rows_unit_norm():
    g = torch.Generator().manual_seed(1)
    banks = init_memory(g, 3, 50, 16)
    assert banks.shape == (3, 50, 16)
    torch.testing.assert_close(banks.norm(dim=-1), torch.ones(3, 50))


@pytest.mark.parametrize("kw", [
    dict(cosine=True, epochs=100),
    dict(cosine=False, epochs=200, lr_decay_epochs=(2, 4)),
    dict(cosine=True, epochs=100, warm=True, batch_size=512),
])
def test_learning_rate_matches_jax(kw):
    jcfg = jax_resolve_config(JaxTrainConfig(learning_rate=0.03, **kw))
    cfg = resolve_config(TrainConfig(learning_rate=0.03, **kw))
    want, got = jax_lr_fn(jcfg, 7), learning_rate_fn(cfg, 7)
    for step in (0, 1, 6, 7, 20, 34, 35, 36, 70, 699):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
