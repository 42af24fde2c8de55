"""The port's data-parallel stage-2 step (mem='bank+jointspri3d') held
against the JAX package's 2-device mesh step on the CPU, and the ranks'
own draws against one process's.

As tests/test_torch_parallel.py (its module docstring gives the set-up and
the tolerances, tests/torch_dp_jax.py the comparisons): width-4 HRNet,
32^2 crops, f32, a global batch of 8 on two gloo ranks, two steps from
JAX's initial state, step 2 from JAX's step-1 parameters and banks, the
negatives and the 16 soft-Pri3D pixels an image pinned.  Cases:
scl_groups 0 (one SCL group a rank: JAX's mesh makes it 2 groups) and
scl_groups 1 (one group over both ranks: each rank gathers the other's
joint features, with their gradient).

Draws: with nothing pinned, the ranks draw the negatives (the counts
form), the soft-Pri3D pixels (over the gathered depth masks) and, for
HRNetPN, depth2pts' uniforms for the global batch from one seed, each
keeping its rows; one step on two ranks then matches one process's:
rtol 1e-5, atol 3e-6 for HRNet; rtol 1e-4, atol 1e-5 for HRNetPN, and
for its f32 64-point encoder's parameters (and its linear head's) rtol
1e-2, atol 1e-3, the
tolerance tests/test_torch_stage2_step.py gives that encoder in f32 (it
is ill-conditioned: f32 moves its parameter gradients by more than 1e-2
relative, test_pointnet2_f32_is_ill_conditioned).  The
batches are the parity harness's: the synthetic source's all-zero depth
samples leave the tiny depth encoder ill-conditioned (as
tests/test_torch_train_step.py notes), which parts two f32 reduction
orders by more than their rounding.
"""

import jax
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.parallel.mesh import make_mesh
from hcmoco_tpu.train.contrast_step import (
    make_contrast_train_step as jax_make_step)
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import STAGE2_METRICS

from torch_dp_common import ranks_running
from torch_dp_jax import TOL, W1_TOL, check_steps, close, jax_steps, t
from torch_dp_worker import one_process
from torch_parity_common import bn_rows, counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K, PIX = 64, 8, 32, 15, 16
DIRS = ("12", "21", "23", "32", "13", "31")
METRICS = (["loss"] + [f"nce_loss_{d}" for d in DIRS]
           + list(STAGE2_METRICS))
TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank+jointspri3d", linear_feat_map=True, nce_k=NCE_K,
            nce_t=0.07, temperature=0.07, pri3d_num_samples_per_image=PIX,
            batch_size=BSZ, epochs=4, learning_rate=0.01, cosine=True,
            modality_missing=True, compute_dtype="float32",
            pn_num_points=64)
SCL = (0, 1)
PN_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """Multi-device XLA:CPU executables reloaded from the persistent cache
    can deadlock (tests/test_train_step.py)."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def pinned_pixels(depth_mask, rng):
    """PIX pixels an image, uniform over the valid pixels of its
    half-pixel-centre /4 mask, or over all pixels where it has none."""
    small = depth_mask[:, 2::4, 2::4].reshape(depth_mask.shape[0], -1)
    out = np.zeros((depth_mask.shape[0], PIX), np.int64)
    for b, row in enumerate(small):
        cand = np.nonzero(row)[0]
        out[b] = rng.choice(cand if cand.size else np.arange(row.size), PIX)
    return out


def batches():
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
            "depth_mask", "joints2d", "joints_vis", "neg_idx")
    bs = [{k: b[k] for k in keys} for b in pc.synth_batches(
        steps=2, bsz=BSZ, crop=CROP, n_data=N_DATA, k=NCE_K, stage2=True)]
    rng = np.random.default_rng(21)
    for b in bs:
        b["pix_idx"] = pinned_pixels(b["depth_mask"], rng)
    return bs


def to_port(b):
    out = {k: t(v) for k, v in b.items() if k != "neg_idx"}
    out["counts"] = counts_from_indices(t(b["neg_idx"]), N_DATA)
    return out


def draw_cases(arch):
    """A case whose step draws everything from the generator (seed 5), on
    the parity harness's batch (with the synthetic source's pixel grid
    and depth means for HRNetPN's clouds)."""
    cfg = resolve_config(TrainConfig(**dict(TINY, arch=arch)))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
            "depth_mask", "joints2d", "joints_vis", "grid_xy", "depth_mean")
    b = pc.synth_batches(steps=1, bsz=BSZ, crop=CROP, n_data=N_DATA,
                         k=NCE_K, stage2=True)[0]
    syn = synthetic_contrast_batch(np.random.default_rng(3), BSZ, size=CROP,
                                   n_data=N_DATA)
    b.update(grid_xy=syn["grid_xy"], depth_mean=syn["depth_mean"])
    assert 0 < b["use_depth"].sum() < BSZ
    banks = torch.nn.functional.normalize(
        torch.randn((3, N_DATA, 128), generator=torch.Generator()
                    .manual_seed(1)), dim=-1)
    return dict(name=f"draws_{arch}", kind="contrast",
                cfg=dict(TINY, arch=arch), n_data=N_DATA,
                model=model.state_dict(), banks=banks,
                batches=[{k: t(b[k]) for k in keys}], gen_seed=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    bs = batches()
    jax_runs, cases = {}, []
    for groups in SCL:
        kw = dict(TINY, scl_groups=groups)
        jcfg = jax_resolve_config(JaxTrainConfig(**kw))
        jmodel = jax_build_model(jcfg)
        jstate = jax_create_state(jcfg, jmodel, jax.random.PRNGKey(0), bs[0],
                                  n_data=N_DATA, steps_per_epoch=1)
        mesh = make_mesh(n_data=2)
        jstep = jax_make_step(jcfg, jmodel, steps_per_epoch=1, mesh=mesh)
        states, metrics = jax_steps(jstep, jstate, bs, mesh)
        jax_runs[groups] = (states, metrics)
        s0, s1 = states[0], states[1]
        cases.append(dict(
            name=f"scl{groups}", kind="contrast", cfg=kw, n_data=N_DATA,
            model=flax_to_port_state_dict(s0.params, s0.batch_stats),
            banks=t(s0.memory.banks), batches=[to_port(b) for b in bs],
            sync=[None, {"model": flax_to_port_state_dict(
                s1.params, s1.batch_stats), "banks": t(s1.memory.banks)}]))
    cases += [draw_cases("HRNet"), draw_cases("HRNetPN")]
    with ranks_running(cases, str(tmp_path_factory.mktemp("dp2"))) as got:
        one = {c["name"]: one_process(c, 2) for c in cases}
        ranks = got()
    return dict(jax=jax_runs, ranks=ranks, one=one,
                cases={c["name"]: c for c in cases})


@pytest.mark.parametrize("groups", SCL)
def test_stage2_two_ranks_match_jax_mesh(runs, groups):
    """Every stage-2 metric, banks, parameters and BN statistics after
    each of two steps; ranks equal bit for bit."""
    name = f"scl{groups}"
    case = runs["cases"][name]
    model = build_model(resolve_config(TrainConfig(**case["cfg"])),
                        device="cpu")
    b0 = case["batches"][0]
    rows = bn_rows(model, b0["rgbd"].permute(0, 3, 1, 2), b0["skeleton"])
    check_steps(name, [r[name] for r in runs["ranks"]], runs["one"][name],
                *runs["jax"][groups], METRICS, model, rows, case["model"])
    assert runs["ranks"][0][name]["metrics"][0]["loss_scl"] > 0


def test_scl_groups_differ(runs):
    """One group a rank and one over both are different losses."""
    a = runs["ranks"][0]["scl0"]["metrics"][0]["loss_scl"]
    b = runs["ranks"][0]["scl1"]["metrics"][0]["loss_scl"]
    assert abs(a - b) > 1e-4


@pytest.mark.parametrize("arch", ["HRNet", "HRNetPN"])
def test_ranks_draw_what_one_process_draws(runs, arch):
    """Negatives, pixels (and depth2pts' points) drawn for the global
    batch: one step on two ranks is one process's step."""
    name = f"draws_{arch}"
    r0, r1 = (r[name] for r in runs["ranks"])
    one = runs["one"][name]
    tol = W1_TOL if arch == "HRNet" else TOL
    assert torch.equal(r0["banks"][0], r1["banks"][0])
    for k in METRICS:
        close(r0["metrics"][0][k], one["metrics"][0][k], tol, k)
    close(r0["banks"][0], one["banks"][0], tol, "banks")
    for k, v in one["model"][0].items():
        if v.is_floating_point():
            assert torch.equal(r0["model"][0][k], r1["model"][0][k]), k
            pn = arch == "HRNetPN" and k.startswith("encoder2")
            close(r0["model"][0][k], v, PN_TOL if pn else tol, k)
