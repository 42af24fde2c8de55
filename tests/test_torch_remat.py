"""Recomputation in the backward (train/remat.py) on the CPU at tiny size:
TrainConfig.remat with remat_policy 'conv_out' and 'dots' on the HRNet
step, pn_remat on the HRNetPN step.

* Against the same step without recomputation, bit for bit, over two
  steps from one state: metrics, parameters, their gradients, BN running
  statistics and num_batches_tracked, banks; stages 1 and 2, the plain
  and the fused ConvBN path, both policies, --microbatch 2; HRNetPN with
  pn_remat.
* (tests/test_torch_remat_jax.py: against the JAX package's remat=True
  and pn_remat=True steps.)
* 'conv_out' runs no convolution and no K1 twice (aten.convolution calls
  and K1's plain-version calls over forward and backward); 'dots' runs
  them again.
* The bytes the forward leaves for the backward fall under either
  policy.
* pn_remat gathers (K5's forward) once more at each scale of SA levels 0
  and 1 in the backward.
* Two gloo ranks with remat against one process, and their collectives a
  step against the step without recomputation.
* --remat, --remat_policy and --pn_remat reach the step from the CLI.
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import parity_common as pc
import test_torch_pn_train_step as pn_step
import test_torch_train_step as hr_step
from hcmoco_tpu_torch.cli import main_contrast
from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.hrnet import fused_sites, set_convbn_fuse
from hcmoco_tpu_torch.ops import matmul_bn, point_gather
from hcmoco_tpu_torch.train import remat
from hcmoco_tpu_torch.train.contrast_step import (make_contrast_loss_fn,
                                                  make_contrast_train_step)
from hcmoco_tpu_torch.train.state import create_train_state

from torch_dp_common import ranks_running
from torch_dp_worker import one_process
from torch_parity_common import counts_from_indices

torch.set_num_threads(1)

N_DATA, BSZ, CROP, NCE_K = 64, 6, 32, 15
TINY = dict(hr_step.TINY)
STAGE2 = dict(mem="bank+jointspri3d", linear_feat_map=True,
              pri3d_num_samples_per_image=8)
# the data-parallel comparison's tolerance (tests/test_torch_parallel.py:
# the ranks and one process differ by the order of their f32 sums)
DP_TOL = dict(rtol=1e-5, atol=3e-6)


def _batches(n, stage2=False, bsz=BSZ):
    out = []
    for b in pc.synth_batches(steps=n, bsz=bsz, crop=CROP, n_data=N_DATA,
                              k=NCE_K, stage2=stage2):
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
             if k not in ("neg_idx", "scale")}
        t["counts"] = counts_from_indices(torch.from_numpy(b["neg_idx"]),
                                          N_DATA)
        out.append(t)
    return out


def _state(cfg, fuse=False):
    torch.manual_seed(0)
    model = set_convbn_fuse(build_model(cfg, device="cpu"), fuse)
    return create_train_state(cfg, model, torch.Generator().manual_seed(0),
                              n_data=N_DATA, steps_per_epoch=1)


def _run(cfg, base, batches):
    """The steps from a copy of `base`: each step's metrics, then every
    parameter, gradient, buffer, momentum buffer and the banks."""
    st = copy.deepcopy(base)
    step = make_contrast_train_step(cfg, st.model, steps_per_epoch=1)
    metrics = [{k: float(v) for k, v in
                step(st, b, torch.Generator().manual_seed(i)).items()}
               for i, b in enumerate(batches)]
    model = st.model
    parts = {f"param {k}": p.detach() for k, p in model.named_parameters()}
    parts.update({f"grad {k}": p.grad for k, p in model.named_parameters()})
    parts.update({f"buffer {k}": b for k, b in model.named_buffers()})
    parts.update({f"momentum {i}": s["momentum_buffer"] for i, s in
                  enumerate(st.optimizer.state.values())})
    parts["banks"] = st.banks
    return metrics, parts


def _assert_same(a, b):
    assert a[0] == b[0]
    assert a[1].keys() == b[1].keys()
    for k, t in a[1].items():
        assert torch.equal(t, b[1][k]), k


CASES = ([("stage1", fuse, policy, 1) for fuse in (False, True)
          for policy in remat.POLICIES]
         + [("stage2", fuse, policy, 1) for fuse in (False, True)
            for policy in remat.POLICIES]
         + [("stage1", fuse, "conv_out", 2) for fuse in (False, True)])


@pytest.mark.parametrize("stage,fuse,policy,micro", CASES)
def test_remat_steps_equal_plain(stage, fuse, policy, micro):
    """Two steps with remat equal two without, bit for bit."""
    fields = dict(TINY, microbatch=micro,
                  **(STAGE2 if stage == "stage2" else {}))
    cfg = resolve_config(TrainConfig(**fields))
    base = _state(cfg, fuse)
    batches = _batches(2, stage2=stage == "stage2")
    want = _run(cfg, base, batches)
    got = _run(resolve_config(TrainConfig(**fields, remat=True,
                                          remat_policy=policy)),
               base, batches)
    assert base.model.encoder1.layer1[0].convbn_fuse == fuse
    _assert_same(want, got)


class _Counted(TorchDispatchMode):
    """Counts the dispatched calls of a set of ops."""

    def __init__(self, ops):
        super().__init__()
        self.ops, self.n = ops, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.ops
        return func(*args, **(kwargs or {}))


def _fwd_bwd_counts(monkeypatch, cfg, fuse):
    """aten.convolution calls and K1 plain-version calls over one loss
    forward and its backward."""
    base = _state(cfg, fuse)
    k1 = {"n": 0}
    plain = matmul_bn.mm_bn_stats_plain

    def counted(x2d, w):
        k1["n"] += 1
        return plain(x2d, w)

    monkeypatch.setattr(matmul_bn, "mm_bn_stats_plain", counted)
    loss_fn = make_contrast_loss_fn(cfg, base.model)
    with _Counted({torch.ops.aten.convolution.default}) as convs:
        loss, _, _ = loss_fn(base, _batches(1)[0])
        loss.backward()
    sites = sum(fused_sites(e) for e in (base.model.encoder1,
                                         base.model.encoder2))
    return convs.n, k1["n"], sites


@pytest.mark.parametrize("fuse", [False, True])
def test_conv_out_runs_no_conv_twice(monkeypatch, fuse):
    cfg = resolve_config(TrainConfig(**TINY))
    off = _fwd_bwd_counts(monkeypatch, cfg, fuse)
    conv_out = _fwd_bwd_counts(monkeypatch, resolve_config(
        TrainConfig(**TINY, remat=True)), fuse)
    dots = _fwd_bwd_counts(monkeypatch, resolve_config(
        TrainConfig(**TINY, remat=True, remat_policy="dots")), fuse)
    assert off[1] == (off[2] if fuse else 0)  # K1 once a 1x1 site
    assert conv_out == off
    assert dots[0] > off[0]
    assert dots[1] == 2 * off[1]


def _kept_bytes(cfg, fuse):
    """Bytes one loss forward leaves allocated for its backward: the sum
    of the profiler's CPU allocations less frees over the forward, its
    results held.  (saved_tensors_hooks cannot count them: a region keeps
    its policy's outputs outside any saved tensor, and its first run
    packs tensors that it frees again.)"""
    base = _state(cfg, fuse)
    loss_fn = make_contrast_loss_fn(cfg, base.model)
    batch = _batches(1)[0]
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        held = loss_fn(base, batch)
    del held
    return sum(e.self_cpu_memory_usage for e in prof.events())


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("fuse", [False, True])
def test_remat_keeps_fewer_bytes(fuse, policy):
    off = _kept_bytes(resolve_config(TrainConfig(**TINY)), fuse)
    on = _kept_bytes(resolve_config(TrainConfig(
        **TINY, remat=True, remat_policy=policy)), fuse)
    print(f"fuse {fuse} {policy}: {on} of {off} bytes kept "
          f"({on / off:.3f})")
    assert on < off


# ---- pn_remat -------------------------------------------------------------

PN_TINY = dict(pn_step.TINY)


def _pn_batches(n):
    return [pn_step.to_port(b) for b in pn_step.batches(n)]


def test_pn_remat_steps_equal_plain(monkeypatch):
    """Two HRNetPN steps with pn_remat equal two without, bit for bit; the
    backward gathers again at each scale of SA levels 0 and 1 (K5's
    forward: a step gathers each SA scale's coordinates, 8 calls, and
    the projected features of levels 1-3, 6; pn_remat adds level 0's 2
    and level 1's 4: 14 calls a step, 20 with pn_remat)."""
    calls = {"n": 0}
    plain = point_gather.group_rows_plain

    def counted(table, gidx):
        calls["n"] += 1
        return plain(table, gidx)

    monkeypatch.setattr(point_gather, "group_rows_plain", counted)
    cfg = resolve_config(TrainConfig(**PN_TINY))
    base = _state(cfg)
    batches = _pn_batches(2)
    want = _run(cfg, base, batches)
    off_calls, calls["n"] = calls["n"], 0
    cfg = resolve_config(TrainConfig(**PN_TINY, pn_remat=True))
    got = _run(cfg, _state(cfg), batches)  # the same seeded weights
    _assert_same(want, got)
    assert (off_calls, calls["n"]) == (2 * 14, 2 * 20)


def test_remat_leaves_other_steps_alone(monkeypatch):
    """remat acts on the HRNet step alone: HRNetPN's step with remat runs
    no region (pn_remat is its own switch), as in the JAX step."""
    regions = {"n": 0}
    run_region = remat.run_region

    def counted(*a, **kw):
        regions["n"] += 1
        return run_region(*a, **kw)

    monkeypatch.setattr(remat, "run_region", counted)
    cfg = resolve_config(TrainConfig(**PN_TINY, remat=True))
    base = _state(cfg)
    m = make_contrast_train_step(cfg, base.model, 1)(base,
                                                     _pn_batches(1)[0])
    assert np.isfinite(float(m["loss"])) and regions["n"] == 0
    with pytest.raises(ValueError, match="remat_policy"):
        make_contrast_train_step(resolve_config(TrainConfig(
            **TINY, remat=True, remat_policy="everything")), base.model, 1)


# ---- data parallelism -----------------------------------------------------

DP_BSZ = 8


def _dp_case(name, fuse, sync=None, **fields):
    cfg = dict(TINY, batch_size=DP_BSZ, **fields)
    base = _state(resolve_config(TrainConfig(**cfg)), fuse)
    return dict(name=name, kind="contrast", cfg=cfg, n_data=N_DATA,
                fuse=fuse, model=base.model.state_dict(),
                banks=base.banks.clone(), batches=_batches(2, bsz=DP_BSZ),
                sync=sync)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Each case on two ranks and in one process; step 2 starts every run
    from one process's step-1 parameters and banks without recomputation
    (as tests/test_torch_parallel.py starts it from JAX's)."""
    ref = one_process(_dp_case("ref", True), 2)
    sync = [None, {"model": ref["model"][0], "banks": ref["banks"][0]}]
    cases = [_dp_case("fused", True, sync),
             _dp_case("fused-remat", True, sync, remat=True),
             _dp_case("plain-dots", False, sync, remat=True,
                      remat_policy="dots")]
    with ranks_running(cases, str(tmp_path_factory.mktemp("remat"))) as got:
        one = {c["name"]: one_process(c, 2) for c in cases}
        ranks = got()
    return ranks, one


@pytest.mark.parametrize("name", ["fused-remat", "plain-dots"])
def test_remat_two_ranks_equal_one_process(dp_runs, name):
    """The ranks equal each other bit for bit and one process within the
    data-parallel tolerance; a remat step issues the collectives of the
    step without recomputation (the recompute takes its forward's BN
    sums back)."""
    ranks, one = dp_runs
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    for s in range(2):
        for k, v in r0["model"][s].items():
            assert torch.equal(v, r1["model"][s][k]), k
        assert torch.equal(r0["banks"][s], r1["banks"][s])
        for k, v in one[name]["metrics"][s].items():
            np.testing.assert_allclose(r0["metrics"][s][k], v, **DP_TOL,
                                       err_msg=f"step {s} {k}")
        for k, v in one[name]["model"][s].items():
            np.testing.assert_allclose(r0["model"][s][k].double().numpy(),
                                       v.double().numpy(), **DP_TOL,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(r0["banks"][s].numpy(),
                                   one[name]["banks"][s].numpy(), **DP_TOL)
    plain = ranks[0]["fused"]["collectives"]
    print(f"{name}: {r0['collectives']} collectives a step, {plain} "
          "without recomputation")
    assert r0["collectives"] == plain and min(plain) > 0
    if name == "fused-remat":  # one process: recomputation changes no bit
        for s in range(2):
            for k, v in one["fused"]["model"][s].items():
                assert torch.equal(v, one[name]["model"][s][k]), k


# ---- the CLI --------------------------------------------------------------

def test_cli_remat_flags_reach_the_step(monkeypatch, tmp_path):
    """--remat --remat_policy dots: the step's forward runs under 'dots';
    --pn_remat reaches TrainConfig."""
    args = main_contrast.build_argparser().parse_args(["--pn_remat"])
    cfg = main_contrast.config_from_args(args)
    assert cfg.pn_remat and not cfg.remat
    seen = []
    recompute = remat.recompute

    def spy(policy):
        seen.append(policy)
        return recompute(policy)

    monkeypatch.setattr("hcmoco_tpu_torch.train.contrast_step.recompute",
                        spy)
    main_contrast.main([
        "--device", "cpu", "--synthetic", "16",
        "--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18", "--width", "4",
        "--crop_size", "32", "--batch_size", "4", "--nce_k", "15",
        "--compute_dtype", "float32", "--epochs", "1", "--max_steps", "2",
        "--num_workers", "1", "--remat", "--remat_policy", "dots",
        "--model_path", str(tmp_path)])
    assert seen == ["dots", "dots"]
