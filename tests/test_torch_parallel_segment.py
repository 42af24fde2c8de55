"""The port's data-parallel versatility segmentor step and `--microbatch
2` step held against the JAX package's 2-device mesh steps on the CPU.

As tests/test_torch_parallel.py (its module docstring gives the set-up
and the tolerances, tests/torch_dp_jax.py the comparisons): width-4
HRNet, 32^2 crops, f32, a global batch of 8 on two gloo ranks, two steps
from JAX's initial state, step 2 from JAX's step-1 parameters and banks,
draws pinned.

* The segmentor (supervise_type 0, 25 classes, 16 soft-Pri3D pixels an
  image): its labelled frames fall unevenly on the ranks, so the
  classifier's masked BN statistics and the segmentation CE's weight sum
  are global ones.  Compared as the stage-2 steps, plus the classifier's
  parameters and its BN running statistics; the parameters are held to
  JAX's after step 1 and to the one-process run after both: from JAX's
  step-1 parameters the second step's encoder1 update is sensitive to
  the BN variance formula (one process with E[x^2] - E[x]^2 and one with
  torch's two-pass variance part by 4x the JAX tolerance; the ranks
  match the first at f32 rounding).
* Stage 1 with microbatch 2: rank r's i-th chunk is its share of the
  global microbatch i (mesh.shard_positions), two BN updates a step.
"""

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
from hcmoco_tpu.parallel.mesh import make_mesh
from hcmoco_tpu.train import segment_step as jseg
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import TrainState as JaxTrainState
from hcmoco_tpu.train.state import create_train_state as jax_create_state
from hcmoco_tpu.train.state import make_optimizer as jax_make_optimizer

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import (fcn_flax_to_torch,
                                             flax_to_port_state_dict)
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.heads import FCNHead
from hcmoco_tpu_torch.train.segment_step import SEGMENT_METRICS

from torch_dp_common import ranks_running
from torch_dp_jax import TOL, check_steps, close, jax_steps, t
from torch_dp_worker import one_process
from torch_parity_common import bn_rows, counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K, PIX, N_CLASS = 64, 8, 32, 15, 16, 25
DIRS = ("12", "21", "23", "32", "13", "31")
SEG_METRICS = (["loss", "loss_seg"] + list(SEGMENT_METRICS)
               + [f"nce_loss_{d}" for d in DIRS])
MB_METRICS = ["loss"] + [f"nce_loss_{d}" for d in DIRS]
SEG = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
           mem="bank+jointspri3d", linear_feat_map=True, nce_k=NCE_K,
           nce_t=0.07, temperature=0.07, pri3d_num_samples_per_image=PIX,
           batch_size=BSZ, epochs=4, learning_rate=0.01, cosine=True,
           modality_missing=True, compute_dtype="float32", n_class=N_CLASS,
           cmc_loss_weights=0.5, other_loss_weights=2.0, supervise_type=0)
MB = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
          mem="bank", nce_k=NCE_K, nce_t=0.07, batch_size=BSZ, epochs=4,
          learning_rate=0.01, cosine=True, modality_missing=True,
          compute_dtype="float32", microbatch=2)


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """Multi-device XLA:CPU executables reloaded from the persistent cache
    can deadlock (tests/test_train_step.py)."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def seg_batches():
    bs = pc.synth_seg_batches(steps=2, bsz=BSZ, crop=CROP, n_data=N_DATA,
                              k=NCE_K, n_class=N_CLASS)
    rng = np.random.default_rng(22)
    for b in bs:
        b.pop("scale")
        small = b["depth_mask"][:, 2::4, 2::4].reshape(BSZ, -1)
        b["pix_idx"] = np.stack([
            rng.choice(np.nonzero(r)[0] if r.any() else np.arange(r.size),
                       PIX) for r in small]).astype(np.int64)
        b["true_label"][BSZ // 2:] = 0
        b["true_label"][BSZ // 2] = 1
    return bs


def _seg_jax(mesh, b0):
    jcfg = jax_resolve_config(JaxTrainConfig(**SEG))
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
                                         steps_per_epoch=1, mesh=mesh)
    return jstate, jstep


def _port_sds(state):
    p, s = state.params, state.batch_stats
    return (flax_to_port_state_dict(p["model"], s["model"]),
            fcn_flax_to_torch(p["classifier"], s["classifier"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mesh = make_mesh(n_data=2)
    sbs = seg_batches()
    assert 1 <= sbs[0]["true_label"][BSZ // 2:].sum() \
        < sbs[0]["true_label"][:BSZ // 2].sum()
    jstate, jstep = _seg_jax(mesh, sbs[0])
    seg = jax_steps(jstep, jstate, sbs, mesh)
    m0, c0 = _port_sds(seg[0][0])
    m1, c1 = _port_sds(seg[0][1])
    cases = [dict(name="segment", kind="segment", cfg=SEG, n_data=N_DATA,
                  model=m0, classifier=c0, banks=t(seg[0][0].memory.banks),
                  batches=[{k: t(v) for k, v in b.items()} for b in sbs],
                  sync=[None, {"model": m1, "classifier": c1,
                               "banks": t(seg[0][1].memory.banks)}])]

    bs = [{k: b[k] for k in ("rgbd", "index", "skeleton", "use_depth",
                             "use_rgb", "neg_idx")}
          for b in pc.synth_batches(steps=2, bsz=BSZ, crop=CROP,
                                    n_data=N_DATA, k=NCE_K)]
    jcfg = jax_resolve_config(JaxTrainConfig(**MB))
    jmodel = jax_build_model(jcfg)
    jstate = jax_create_state(jcfg, jmodel, jax.random.PRNGKey(0), bs[0],
                              n_data=N_DATA, steps_per_epoch=1)
    mb = jax_steps(jax_make_step(jcfg, jmodel, steps_per_epoch=1,
                                 mesh=mesh), jstate, bs, mesh)
    s0, s1 = mb[0][0], mb[0][1]

    def to_port(b):
        out = {k: t(v) for k, v in b.items() if k != "neg_idx"}
        out["counts"] = counts_from_indices(t(b["neg_idx"]), N_DATA)
        return out

    cases.append(dict(
        name="microbatch", kind="contrast", cfg=MB, n_data=N_DATA,
        model=flax_to_port_state_dict(s0.params, s0.batch_stats),
        banks=t(s0.memory.banks), batches=[to_port(b) for b in bs],
        sync=[None, {"model": flax_to_port_state_dict(
            s1.params, s1.batch_stats), "banks": t(s1.memory.banks)}]))
    with ranks_running(cases, str(tmp_path_factory.mktemp("dp3"))) as got:
        one = {c["name"]: one_process(c, 2) for c in cases}
        ranks = got()
    return dict(jax={"segment": seg, "microbatch": mb}, ranks=ranks,
                one=one, cases={c["name"]: c for c in cases})


def test_segment_step_two_ranks_match_jax_mesh(runs):
    """Every metric, banks, the model's parameters and BN statistics, the
    classifier's parameters and masked-BN statistics, after each of two
    steps; ranks equal bit for bit."""
    case = runs["cases"]["segment"]
    ranks = [r["segment"] for r in runs["ranks"]]
    jstates, jmetrics = runs["jax"]["segment"]
    cfg = resolve_config(TrainConfig(**SEG))
    model = build_model(cfg, device="cpu")
    b0 = case["batches"][0]
    rows = bn_rows(model, b0["rgbd"].permute(0, 3, 1, 2), b0["skeleton"])
    check_steps("segment", ranks, runs["one"]["segment"], jstates, jmetrics,
                SEG_METRICS, model, rows, case["model"],
                params_of=lambda p: p["model"], stats_of=lambda s: s["model"],
                jax_param_steps=1)
    check_steps("classifier", ranks, runs["one"]["segment"], jstates,
                jmetrics, SEG_METRICS, FCNHead(128, N_CLASS), None,
                case["classifier"], convert=fcn_flax_to_torch,
                key="classifier", params_of=lambda p: p["classifier"],
                stats_of=lambda s: s["classifier"], jax_param_steps=1)
    for s in range(1):
        want = _port_sds(jstates[s + 1])[1]
        for k in ("convs.0.norm_name.running_mean",
                  "convs.0.norm_name.running_var"):
            close(ranks[0]["classifier"][s][k], want[k], TOL,
                  f"step {s} {k}")


def test_microbatch_two_ranks_match_jax_mesh(runs):
    """--microbatch 2 at a world of two: metrics, banks, parameters and
    the two chained BN updates of each step."""
    case = runs["cases"]["microbatch"]
    model = build_model(resolve_config(TrainConfig(**MB)), device="cpu")
    b0 = case["batches"][0]
    rows = bn_rows(model, b0["rgbd"][:BSZ // 2].permute(0, 3, 1, 2),
                   b0["skeleton"][:BSZ // 2])
    check_steps("microbatch", [r["microbatch"] for r in runs["ranks"]],
                runs["one"]["microbatch"], *runs["jax"]["microbatch"],
                MB_METRICS, model, rows, case["model"], updates=2)
