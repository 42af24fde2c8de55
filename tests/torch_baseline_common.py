"""Helpers of the tests that hold the port's baseline methods (ResNet
encoders, banks and the MoCo queue) against hcmoco_tpu.

float64: in f32 a train-mode ResNet at test sizes is too ill-conditioned
for a 1e-4 comparison (BN over a handful of values a channel in layer3/4
amplifies the two frameworks' rounding: ResNet-18's pooled feature parts
by 1.4e-2 at 32^2 bs4, 5e-4 at 96^2 bs8, and by 2.4e-7 in float64).  So
the train-mode comparisons run the encoders in float64 on both sides, as
the PointNet++ tests do: JAX under jax.enable_x64 with modules of dtype
float64 and float64 parameters, the port's encoders moved to float64
(`port_f64`, torch_dp_worker's, which the data-parallel ranks share).
The projection heads run in f32 on both sides (the JAX ProjectionHead
casts to f32; the port's heads take f32).
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hcmoco_tpu.contrast.memory import init_memory as jax_init_memory
from hcmoco_tpu.contrast.memory import init_moco as jax_init_moco
from hcmoco_tpu.contrast.memory import sample_negative_indices
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import TrainState as JaxTrainState
from hcmoco_tpu.train.state import make_optimizer as jax_make_optimizer

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import baseline_flax_to_torch
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

from torch_dp_worker import port_f64  # shared with the data-parallel ranks


def port_to_flax(sd: dict, shapes: dict, convert) -> dict:
    """The flax {'params', 'batch_stats'} trees of the shapes `shapes`
    (jax.eval_shape of a module's init: no compile) that `convert` (flax
    trees -> the port's names, e.g. baseline_flax_to_torch) maps to the
    port's state dict `sd`: convert is run once on trees of element ids,
    and each id is given the value the port holds at its place.  Float64,
    exact for the f32 weights."""
    ids, leaves, offset = {}, {}, 0
    for tree in ("params", "batch_stats"):
        def fill(leaf):
            nonlocal offset
            a = np.arange(offset, offset + int(np.prod(leaf.shape)),
                          dtype=np.float64).reshape(leaf.shape)
            offset += a.size
            return a
        ids[tree] = jax.tree_util.tree_map(fill, shapes.get(tree, {}))
    flat = np.zeros(offset, np.float64)
    seen = np.zeros(offset, bool)
    for k, v in convert(ids["params"], ids["batch_stats"]).items():
        if k.endswith("num_batches_tracked"):
            continue
        pos = v.numpy().astype(np.int64).reshape(-1)
        flat[pos] = sd[k].detach().double().numpy().reshape(-1)
        seen[pos] = True
    assert seen.all(), "the port's state dict does not cover every leaf"
    for tree in ids:
        leaves[tree] = jax.tree_util.tree_map(
            lambda a: flat[a.astype(np.int64)], ids[tree])
    return leaves


def jax_f64(tree):
    """A flax tree with every float leaf in float64 (call under
    jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
        tree)


TOL = dict(rtol=1e-4, atol=1e-5)
N_DATA, BSZ, CROP, PATCH = 32, 4, 32, 16


def family_batch(cfg, seed: int = 0) -> dict:
    """The JAX tests' batch (tests/test_baseline_methods.py): bs4 32^2, two
    3-channel crops on channels for moco, a (4, 9, 16, 16, 3) patch stack
    for jigsaw."""
    rng = np.random.default_rng(seed)
    c = 6 if cfg.mem == "moco" else 3
    b = {"rgbd": rng.standard_normal((BSZ, CROP, CROP, c)).astype(np.float32),
         "index": np.array([5, 17, 5, 30], np.int32)}
    if cfg.jigsaw:
        b["rgbd_jig"] = rng.standard_normal(
            (BSZ, 9, PATCH, PATCH, 3)).astype(np.float32)
    return b


def jax_pins(jcfg, key, batch: dict) -> dict:
    """The draws the JAX step makes from `key` (contrast_step.py: the bank
    branches split it in 3, negatives from the first, jigsaw orders from
    the third; moco splits it in 2, jigsaw orders from the second), as the
    port's pins.  The first half of moco's key draws ShuffleBN's
    permutation, which the port does not make: under global BN it only
    reorders a sum (ROADMAP.md Queue 3, F12)."""
    bsz = batch["index"].shape[0]
    pins = {}
    if jcfg.mem == "moco":
        _, jig_rng = jax.random.split(key)
    else:
        rngs = jax.random.split(key, 3)
        jig_rng = rngs[2]
        pins["neg_idx"] = sample_negative_indices(
            rngs[0], jnp.asarray(batch["index"]), N_DATA, jcfg.nce_k)
    if jcfg.jigsaw and "rgbd_jig" in batch:
        pins["jig_perm"] = jax.vmap(lambda k: jax.random.permutation(k, 9))(
            jax.random.split(jig_rng, bsz))
    return {k: torch.from_numpy(np.array(v)) for k, v in pins.items()}


@contextmanager
def bn_passes(model: torch.nn.Module):
    """{BN name: [(biased batch variance (f64), rows)]}, one entry per
    train-mode call of each BN layer of `model` while inside."""
    rec = {}
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            def hook(mod, args, name=name):
                if mod.training:
                    x = args[0].detach().double()
                    dims = [0] + list(range(2, x.dim()))
                    rec.setdefault(name, []).append(
                        (x.var(dims, unbiased=False), x.numel() // x.shape[1]))
            hooks.append(mod.register_forward_pre_hook(hook))
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()


def check_bn_passes(model, port_before: dict, jax_before: dict,
                    jax_after: dict, rec: dict, tol: dict = None) -> int:
    """BN running statistics after chained train-mode passes (the jigsaw
    models' encoders normalise the batch, then the patches).  The running
    means against JAX's; JAX's running variances (flax: biased) against
    the replay of the passes' biased batch variances from JAX's before;
    the port's (unbiased, ROADMAP F1) against the replay of the same
    variances times n / (n - 1) from its own before.  `tol` (None: TOL
    against JAX, rtol 1e-10 / atol 1e-12 against the replay, for a float64
    model) holds every comparison of an f32 model.  Returns the layers
    compared."""
    got = model.state_dict()
    mods = {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert set(rec) == set(mods), set(rec) ^ set(mods)
    for name, passes in rec.items():
        mom = mods[name].momentum
        np.testing.assert_allclose(
            got[f"{name}.running_mean"].double().numpy(),
            jax_after[f"{name}.running_mean"].double().numpy(),
            **(tol or TOL), err_msg=name)
        flax = jax_before[f"{name}.running_var"].double()
        port = port_before[f"{name}.running_var"].double()
        for var, n in passes:
            flax = (1 - mom) * flax + mom * var
            port = (1 - mom) * port + mom * var * n / (n - 1)
        np.testing.assert_allclose(
            jax_after[f"{name}.running_var"].double().numpy(),
            flax.numpy(), **(tol or TOL), err_msg=name)
        np.testing.assert_allclose(
            got[f"{name}.running_var"].double().numpy(), port.numpy(),
            **(tol or dict(rtol=1e-10, atol=1e-12)), err_msg=name)
    return len(rec)


def _params(sd: dict, model: torch.nn.Module) -> dict:
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in sd.items() if k in names}


def close_dicts(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(
            got[k].detach().double().numpy(),
            want[k].detach().double().numpy() if torch.is_tensor(want[k])
            else np.asarray(want[k], np.float64), **TOL, err_msg=f"{what} {k}")


def run_family(kw: dict, key_seed: int = 1) -> dict:
    """One step of the baseline configuration `kw` (TrainConfig fields) on
    both sides from the port's initial weights (carried into JAX's trees,
    the jig heads included), JAX's initial banks or queue, and the JAX
    step's draws pinned in the port; the encoders in float64 on both
    sides.  Compares the metrics, the parameters after
    SGD, the BN running statistics, the banks or the queue and pointer
    (exactly), and moco's EMA parameters.  Returns the port's metrics, the
    JAX metrics, and the port's state."""
    cfg, jcfg = resolve_config(TrainConfig(**kw)), jax_resolve(
        JaxTrainConfig(**kw))
    batch = family_batch(cfg)
    moco = cfg.mem == "moco"
    n_modal = {"RGB": 1, "CMC": 2}[cfg.modal]
    x = batch["rgbd"]
    if moco:
        x = x[..., :x.shape[-1] // 2]
    init_kw = {}
    if cfg.jigsaw:
        init_kw = dict(x_jig=batch["rgbd_jig"][:1].reshape(-1, PATCH, PATCH,
                                                           3),
                       shuffle_ids=np.arange(9))
    key = jax.random.PRNGKey(key_seed)
    # the port's initial weights on both sides: JAX's trees are built
    # from them (port_to_flax; a flax init would cost a compile a family)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    with jax.enable_x64():
        jmodel = jax_build_model(jcfg).clone(dtype=jnp.float64)
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), x[:1].astype(np.float64), train=False,
            **init_kw))
        v = port_to_flax(model.state_dict(), shapes, baseline_flax_to_torch)
        p64, bs64 = v["params"], v["batch_stats"]
        tx, _ = jax_make_optimizer(jcfg, 2)
        mem_key = jax.random.PRNGKey(7)
        # jitted: eager, each small op compiles on its own
        if moco:
            mem = {"moco": jax.jit(lambda k: jax_init_moco(
                k, n_modal, cfg.nce_k, cfg.feat_dim))(mem_key)}
        else:
            mem = {"memory": jax.jit(lambda k: jax_init_memory(
                k, n_modal, N_DATA, cfg.feat_dim))(mem_key)}
        jstate = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=p64, batch_stats=bs64,
            opt_state=jax.jit(tx.init)(p64),
            params_ema=p64 if moco else None, **mem)
        jbatch = dict(batch, rgbd=batch["rgbd"].astype(np.float64))
        if "rgbd_jig" in jbatch:
            jbatch["rgbd_jig"] = jbatch["rgbd_jig"].astype(np.float64)
        pins = jax_pins(jcfg, key, batch)
        jstep = jax_make_step(jcfg, jmodel, steps_per_epoch=2)
        jnew, jmetrics = jax.device_get(jstep(jstate, jbatch, key))

    port_f64(model)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=2)
    with torch.no_grad():
        if moco:
            state.moco.queues.copy_(torch.from_numpy(
                np.array(jstate.moco.queues)))
        else:
            state.banks.copy_(torch.from_numpy(np.array(
                jstate.memory.banks)))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_contrast_train_step(cfg, model, steps_per_epoch=2)
    tbatch = {k: torch.from_numpy(np.asarray(b, np.float64)
                                  if b.dtype == np.float32 else b)
              for k, b in batch.items()}
    tbatch.update(pins)
    with bn_passes(model) as rec:
        metrics = step(state, tbatch, None)

    assert set(metrics) == set(jmetrics), set(metrics) ^ set(jmetrics)
    for k, val in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(val), **TOL,
                                   err_msg=k)
    want = baseline_flax_to_torch(jnew.params, jnew.batch_stats)
    close_dicts(_params(model.state_dict(), model), _params(want, model),
                "params")
    assert check_bn_passes(model, before, baseline_flax_to_torch(
        v["params"], v["batch_stats"]), want, rec) > 0
    if moco:
        ema = baseline_flax_to_torch(jnew.params_ema, jnew.batch_stats)
        close_dicts(dict(state.key_model.named_parameters()),
                    _params(ema, model), "ema")
        np.testing.assert_allclose(state.moco.queues.numpy(),
                                   np.asarray(jnew.moco.queues), **TOL)
        assert state.moco.ptr == int(jnew.moco.ptr) == BSZ % cfg.nce_k
    else:
        np.testing.assert_allclose(state.banks.numpy(),
                                   np.asarray(jnew.memory.banks), **TOL)
    return {"metrics": metrics, "jax_metrics": jmetrics, "state": state,
            "cfg": cfg, "batch": tbatch}
