"""The port's data parallelism (parallel/mesh.py over torch.distributed)
held against the JAX package's 2-device mesh step on the CPU, stage 1.

Each case runs three ways on the same initial weights, banks and pinned
draws, at a global batch of 8 (width-4 HRNet, 32^2 crops, f32):
  * the JAX package's make_contrast_train_step(..., mesh=make_mesh(2)) on
    2 of conftest's 8 virtual CPU devices (global BN, global losses);
  * the port on two gloo ranks, 4 rows each (tests/torch_dp_worker.py:
    fresh processes that import torch and the port only);
  * the port in this process, all 8 rows (no process group), its BN
    with the ranks' E[x^2] - E[x]^2 (torch_dp_worker.one_process).
Two steps each; step 2 starts from JAX's step-1 parameters and banks on
both port sides (tests/test_torch_train_step.py says why).  Cases: the
plain and the fused ConvBN path (HCMOCO_CONVBN_FUSE's, the JAX side
unfused: in f32 the same math), rank 1's rows all without depth (the
global-denominator trap), and sample indices that collide across ranks
(tests/test_train_step.py::TestBankCollisions' [7,7,7,1,1,9,9,9]).  Also
each BN layer kind alone (nn.BatchNorm2d/1d's global versions and
MaskedBatchNorm with a mask split unevenly) against flax's BN over the
concatenated batch.

Tolerances.  Against JAX: rtol 1e-4, atol 1e-5, the one-process step
tests' (tests/test_torch_train_step.py), after both steps.  Against the
port's own one-process run of the same math: rtol 1e-5, atol 3e-6 (f32
rounding: the two differ by the order of their f32 sums).  That run
takes the ranks' variance formula because the second step is sensitive
to it: from JAX's step-1 parameters, torch's two-pass variance moves the
collisions case's SemGCN input update 2.5x the JAX tolerance from
JAX's.  The two ranks: parameters, BN statistics, banks and metrics
equal bit for bit after every step.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.models.heads import MaskedBatchNorm as JaxMaskedBatchNorm
from hcmoco_tpu.parallel.mesh import make_mesh
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.build import build_model

from torch_dp_common import ranks_running
from torch_dp_jax import (TOL, W1_TOL, check_steps, close, jax_steps,
                          t)
from torch_dp_worker import one_process
from torch_parity_common import bn_rows, counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K = 64, 8, 32, 15
DIRS = ("12", "21", "23", "32", "13", "31")
METRICS = ["loss"] + [f"nce_{m}_{d}" for m in ("loss", "acc") for d in DIRS]
TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank", nce_k=NCE_K, nce_t=0.07, batch_size=BSZ, epochs=4,
            learning_rate=0.01, cosine=True, modality_missing=True,
            compute_dtype="float32")
STAGE1_CASES = ("plain", "fused", "uneven_depth", "collisions")


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """Multi-device XLA:CPU executables reloaded from the persistent cache
    can deadlock (tests/test_train_step.py)."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def stage1_batches(case):
    bs = [{k: b[k] for k in ("rgbd", "index", "skeleton", "use_depth",
                             "use_rgb", "neg_idx")}
          for b in pc.synth_batches(steps=2, bsz=BSZ, crop=CROP,
                                    n_data=N_DATA, k=NCE_K)]
    for b in bs:
        if case == "uneven_depth":
            b["use_depth"][BSZ // 2:] = 0
            b["use_depth"][0] = 1
        if case == "collisions":
            b["index"] = np.array([7, 7, 7, 1, 1, 9, 9, 9], np.int64)
            b["neg_idx"][:, 0] = b["index"]
    return bs


def to_port(b):
    out = {k: t(v) for k, v in b.items() if k != "neg_idx"}
    out["counts"] = counts_from_indices(t(b["neg_idx"]), N_DATA)
    return out


def port_case(name, jstates, bs, **kw):
    """A worker case starting from JAX's initial state, step 2 from JAX's
    step-1 parameters and banks."""
    s0, s1 = jstates[0], jstates[1]
    return dict(name=name, kind="contrast", cfg=TINY, n_data=N_DATA,
                model=flax_to_port_state_dict(s0.params, s0.batch_stats),
                banks=t(s0.memory.banks), batches=[to_port(b) for b in bs],
                sync=[None, {"model": flax_to_port_state_dict(
                    s1.params, s1.batch_stats), "banks": t(s1.memory.banks)}],
                **kw)


def bn_cases():
    """BN layers alone: rows, their cotangent, a mask that keeps 3 of rank
    0's 4 frames and 1 of rank 1's."""
    rng = np.random.default_rng(4)
    out = {}
    for name, shape in (("bn2d", (8, 6, 5, 5)), ("bn1d", (8, 16, 7)),
                        ("masked", (8, 6, 4, 4))):
        x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
        c = shape[1]
        out[name] = dict(
            name=f"bn_{name}", kind="bn", module=name, x=t(x),
            g=t(rng.standard_normal(shape).astype(np.float32)),
            weight=t(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            bias=t(rng.standard_normal(c).astype(np.float32)),
            mask=(t(np.array([1, 0, 1, 1, 0, 0, 0, 1], np.int32))
                  if name == "masked" else None))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: JAX's mesh step, the port's two ranks and one process."""
    cfg_j = jax_resolve_config(JaxTrainConfig(**TINY))
    jmodel = jax_build_model(cfg_j)
    base = stage1_batches("plain")
    jstate = jax_create_state(cfg_j, jmodel, jax.random.PRNGKey(0), base[0],
                              n_data=N_DATA, steps_per_epoch=1)
    mesh = make_mesh(n_data=2)
    jstep = jax_make_step(cfg_j, jmodel, steps_per_epoch=1, mesh=mesh)
    jax_runs, cases = {}, []
    for name in STAGE1_CASES:
        bs = stage1_batches(name)
        jax_runs[name] = jax_steps(jstep, jstate, bs, mesh)
        cases.append(port_case(name, jax_runs[name][0], bs,
                               fuse=name == "fused"))
    cases += list(bn_cases().values())
    with ranks_running(cases, str(tmp_path_factory.mktemp("dp"))) as got:
        one = {c["name"]: one_process(c, 2) for c in cases}
        ranks = got()
    return dict(jax=jax_runs, ranks=ranks, one=one,
                cases={c["name"]: c for c in cases})


@pytest.mark.parametrize("name", STAGE1_CASES)
def test_stage1_two_ranks_match_jax_mesh(runs, name):
    """Loss, metrics, banks, parameters and BN running statistics after
    each of two steps; ranks equal bit for bit."""
    case = runs["cases"][name]
    model = build_model(resolve_config(TrainConfig(**TINY)), device="cpu")
    b0 = case["batches"][0]
    rows = bn_rows(model, b0["rgbd"].permute(0, 3, 1, 2), b0["skeleton"])
    check_steps(name, [r[name] for r in runs["ranks"]], runs["one"][name],
                *runs["jax"][name], METRICS, model, rows, case["model"])


def test_uneven_depth_is_a_global_mean(runs):
    """With every row of rank 1 without depth, the depth directions'
    masked means are over the global count of depth rows: a per-rank mean
    averaged over the ranks is another number."""
    r0 = runs["ranks"][0]["uneven_depth"]
    jm = runs["jax"]["uneven_depth"][1][0]
    close(r0["metrics"][0]["nce_loss_12"], jm["nce_loss_12"], TOL, "12")
    assert r0["metrics"][0]["loss"] != runs["ranks"][0]["plain"][
        "metrics"][0]["loss"]


def test_cross_rank_collisions_last_write_wins(runs):
    """Index 7 on rank 0 and 9 on rank 1, 1 across the boundary: every
    rank writes the last occurrence in global order, rows stay unit-norm,
    and rows no index touches keep their bits."""
    r0 = runs["ranks"][0]["collisions"]
    case = runs["cases"]["collisions"]
    banks = r0["banks"][0]
    torch.testing.assert_close(banks.norm(dim=-1),
                               torch.ones(banks.shape[:2]))
    untouched = [i for i in range(N_DATA) if i not in (1, 7, 9)]
    assert torch.equal(banks[:, untouched], case["banks"][:, untouched])


def _flax_bn(x, g, weight, bias, mask):
    """flax's BN in training over the whole batch (channels last): its
    output, grads and running statistics after one update."""
    xl = jnp.asarray(np.moveaxis(x.numpy(), 1, -1))
    gl = jnp.asarray(np.moveaxis(g.numpy(), 1, -1))
    if mask is None:
        mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5, use_fast_variance=True)
        kw = {}
    else:
        mod = JaxMaskedBatchNorm(momentum=0.9, epsilon=1e-5)
        kw = dict(train=True, sample_mask=jnp.asarray(mask.numpy()))
    stats = mod.init(jax.random.PRNGKey(0), xl, **kw)["batch_stats"]
    params = {"scale": jnp.asarray(weight.numpy()),
              "bias": jnp.asarray(bias.numpy())}

    def f(p, xx):
        return mod.apply({"params": p, "batch_stats": stats}, xx, **kw,
                         mutable=["batch_stats"])

    out, pull = jax.vjp(lambda p, xx: f(p, xx)[0], params, xl)
    dparams, dx = pull(gl)
    upd = f(params, xl)[1]["batch_stats"]

    def back(a):
        return np.moveaxis(np.asarray(a), -1, 1)

    return dict(out=back(out), dx=back(dx),
                dweight=np.asarray(dparams["scale"]),
                dbias=np.asarray(dparams["bias"]),
                mean=np.asarray(upd["mean"]), var=np.asarray(upd["var"]))


@pytest.mark.parametrize("kind", ["bn2d", "bn1d", "masked"])
def test_global_batch_norm_matches_flax(runs, kind):
    """A BN layer on two ranks' rows equals flax's BN on the concatenated
    batch (out and dx row for row, dweight/dbias summed over the ranks)
    and the port's one-process BN; the running statistics equal across
    ranks and match flax's (F1: the port's running var is unbiased)."""
    name = f"bn_{kind}"
    r0, r1 = (r[name] for r in runs["ranks"])
    one = runs["one"][name]
    case = runs["cases"][name]
    want = _flax_bn(case["x"], case["g"], case["weight"], case["bias"],
                    case["mask"])
    for k in ("running_mean", "running_var"):
        assert torch.equal(r0[k], r1[k])
        close(r0[k], one[k], W1_TOL, k)
    for k in ("out", "dx"):
        got = torch.cat([r0[k], r1[k]])
        close(got, one[k], W1_TOL, f"{k} vs one process")
        close(got, want[k], TOL, k)
    for k in ("dweight", "dbias"):
        got = r0[k] + r1[k]
        close(got, one[k], W1_TOL, f"{k} vs one process")
        close(got, want[k], TOL, k)
    x = case["x"]
    if kind == "masked":
        kept = int(case["mask"].sum()) * x[0, 0].numel()
        var = want["var"]  # MaskedBatchNorm's running var is unbiased
    else:
        kept = x.numel() // x.shape[1]
        var = 0.9 + (want["var"] - 0.9) * kept / (kept - 1)
    close(r0["running_mean"], want["mean"], TOL, "running_mean")
    close(r0["running_var"], var, TOL, "running_var")
