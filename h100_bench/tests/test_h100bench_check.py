"""CPU tests of the check that decides `correct`: the plain reference
against the program's step, and a run of the harness with the timed path
broken underneath, at tiny sizes (h100bench_common)."""

import os
import time

import pytest
import torch

from h100bench_common import PN, REPO, port_model_f64, tiny_root

from h100_bench import cells, checks, session, weights
from h100_bench.reference import models, step as ref_step

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def keep_env():
    before = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(before)


@pytest.mark.parametrize("train", [{}, PN], ids=["HRNet", "HRNetPN"])
def test_reference_keys_are_the_programs(train):
    """Every state-dict key and shape of the reference is the program's,
    at the stage-1 recipe's sizes (W18; HRNetPN at 4096 points)."""
    from hcmoco_tpu_torch.models.build import build_model

    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run, **train)
    port = build_model(session.train_config(run), device="meta")
    ref = models.build(run, models.Numerics(), device="meta")
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}


def _port_steps(run, pool, seed):
    """The program's first three steps in float64 (its encoders; SemGCN,
    the heads and the NCE stay float32), read as the harness reads them."""
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cfg = session.train_config(run)
    spe = ref_step.steps_per_epoch(run)
    model = port_model_f64(build_model(cfg, device="cpu"))
    init = {k: v.to(model.state_dict()[k].dtype)
            for k, v in weights.make_state(run, seed, "cpu").items()}
    model.load_state_dict(init)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=run["n_data"], steps_per_epoch=spe)
    banks0 = weights.make_banks(run, seed, "cpu")
    state.banks.copy_(banks0)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=spe)
    losses = []
    for i, batch in enumerate(pool):
        losses.append(float(step(state, batch, None)["loss"]))
        if i == 0:
            grads = session.first_gradients(model, state.optimizer, init,
                                            cfg.weight_decay)
    out = session.program_readings(model, state, init, banks0, grads)
    out["loss"] = losses
    return out


@pytest.mark.parametrize("workload", ["tiny.t8", "tinypn.p64"])
def test_reference_agrees_with_the_program_in_float64(root, workload):
    """The program's plain path (fused ConvBN off) against the reference,
    both encoders in float64 (HRNetPN's PointNet++ searching on float32
    coordinates on both sides), the NCE on the cell's 'gather' path, for
    the first three steps: the loss, every leaf's first gradient and
    change, the BN statistics and the banks.

    Limits: every leaf's gap under 5e-4, the loss's under 5e-6.  What is
    left is the float32 rounding of SemGCN and the NCE, which the program
    keeps in float32, grown by BN over 8 tiny samples.  HRNetPN read at
    most 2.2e-6, 1.3e-6, 4.2e-6 and 4.5e-5 at the leaves (the last a BN of
    SA level 3, whose one center's 32 rows a sample make the smallest BN)
    and 3e-7 at the loss over four seeds: the same limits hold it with
    room, and a reference that leaves the FPS centers unsorted, or fills
    a ball's empty slots with its last hit, reads 0.27-0.77 there."""
    os.environ["HCMOCO_CONVBN_FUSE"] = "0"
    run = cells.load_cell(root, workload).run
    assert run["n_data"] > run["counts_max_n_data"]
    pool = session.make_pool(run, SEED, "cpu")
    prog = _port_steps(run, pool, SEED)
    model = models.build(run, models.Numerics(checkpoint=False))
    model.encoder1.double()
    model.encoder2.double()
    model.load_state_dict(weights.make_state(run, SEED, "cpu"))
    ref = ref_step.reference_steps(model, weights.make_banks(run, SEED,
                                                             "cpu"),
                                   pool, run)
    for key in ("grad", "change", "state"):
        gaps = checks.leaf_gaps(prog[key], ref[key], list(ref[key]))
        worst = max(gaps, key=lambda k: abs(gaps[k]))
        assert abs(gaps[worst]) < 5e-4, (key, worst, gaps[worst])
    assert checks.gaps(prog, ref, checks.leaf_groups(run))["loss_gap"][0] \
        < 5e-6


def _run(root, workload, seconds=0.5):
    out = session.run_cell(root, session.Args(
        workload=workload, seed=SEED, seconds=seconds, trace=False,
        device="cpu"), time.perf_counter())
    return out["window"], session.check(out, SEED)


@pytest.mark.parametrize("workload", ["tiny.t8", "tinypn.p64"])
def test_a_sound_run_reads_below_every_limit(root, workload):
    window, found = _run(root, workload)
    assert window.steps >= 2 and window.failed == 0
    assert all(c.ok for c in found), found


def _frozen(step, model, run):
    """The step with SGD's update left out: the parameters stay."""
    def call(state, batch, generator=None):
        state.optimizer.step = lambda *a, **k: None
        return step(state, batch, generator)
    return call


def _half_batch(step, model, run):
    """The step over the first half of the batch's rows, its mean taken
    over them."""
    def call(state, batch, generator=None):
        rows = batch["index"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()},
                    generator)
    return call


def _group_gradient_halved(group):
    """The step with the gradient of one layer group's parameters halved
    before SGD takes it: a fault in a few leaves of one layer."""
    def fault(step, model, run):
        groups = checks.leaf_groups(run)
        params = [p for k, p in model.named_parameters()
                  if groups[k] == group]

        def call(state, batch, generator=None):
            opt = state.optimizer
            if not getattr(opt, "halved", False):
                take = opt.step

                def halved(*a, **k):
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(0.5)
                    return take(*a, **k)
                opt.step, opt.halved = halved, True
            return step(state, batch, generator)
        return call
    return fault


BROKEN = [
    ("tiny.t8", _frozen, "frozen"), ("tiny.t8", _half_batch, "half_batch"),
    ("tiny.t8", _group_gradient_halved("encoder3"),
     "semgcn_gradient_halved"),
    ("tiny.t8", _group_gradient_halved("encoder1.convbn"),
     "fused_sites_gradient_halved"),
    ("tiny.t8", _group_gradient_halved("heads"), "heads_gradient_halved"),
    ("tinypn.p64", _frozen, "pn_frozen"),
    ("tinypn.p64", _half_batch, "pn_half_batch"),
    ("tinypn.p64", _group_gradient_halved("encoder2.sa"),
     "pn_set_abstraction_gradient_halved"),
    ("tinypn.p64", _group_gradient_halved("encoder2.fp"),
     "pn_feature_propagation_gradient_halved")]


@pytest.mark.parametrize("workload,fault", [b[:2] for b in BROKEN],
                         ids=[b[2] for b in BROKEN])
def test_a_broken_step_is_not_correct(root, monkeypatch, workload, fault):
    """The harness's run, its check included, with the timed call broken
    underneath: the state left unchanged; half of the batch left out and
    the mean taken over the rest; or the gradient of one layer group
    halved (SemGCN's 48 leaves, one encoder's fused ConvBN sites, the six
    head leaves; PointNet++'s 48 set-abstraction or 24 feature-propagation
    leaves), which a median over all the parameters would outvote."""
    from hcmoco_tpu_torch.train import contrast_step

    run = cells.load_cell(root, workload).run
    make = contrast_step.make_contrast_train_step
    monkeypatch.setattr(contrast_step, "make_contrast_train_step",
                        lambda cfg, model, **k: fault(make(cfg, model, **k),
                                                      model, run))
    window, found = _run(root, workload)
    assert not all(c.ok for c in found), found


@pytest.mark.parametrize("workload", ["tiny.t8", "tinypn.p64"])
def test_the_float8_control_is_not_correct(root, workload):
    """The reference in the program's place with every convolution (and
    PointNet++'s shared-MLP product) reading float8 (e4m3) inputs and
    weights, one step below the configuration's bfloat16: it fails the
    cell's limits."""
    cell = cells.load_cell(root, workload)
    ref = session.reference_readings(cell.run, SEED, "cpu")
    low = session.reference_readings(cell.run, SEED, "cpu",
                                     lowp=torch.float8_e4m3fn)
    found = checks.compare(low, ref, cell.limits,
                           checks.leaf_groups(cell.run))
    assert not all(c.ok for c in found), found
