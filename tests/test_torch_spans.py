"""The port's span recorder (hcmoco_tpu_torch/utils/spans.py) and the
spans the program places: off by default at the cost of a check, on
under spans.recording() and under torch.profiler, on the profiler's
clock, and the stage-1 step's phases in their order (plain, under
--microbatch 2, under remat).  The card test at the end holds the
markers to the kernels of a traced step:

    python -m pytest -m cuda tests/test_torch_spans.py
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state
from hcmoco_tpu_torch.utils import span_place, spans

N_DATA = 64
TINY = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
            mem="bank", nce_k=15, nce_t=0.07, batch_size=4, epochs=4,
            learning_rate=0.01, cosine=True, modality_missing=True,
            compute_dtype="float32", crop_size=32)
PART = ["forward", "nce", "backward", "bank_update"]
TAIL = ["optimizer", "metrics"]


@pytest.fixture(autouse=True)
def _clean():
    spans.clear()
    yield
    spans.clear()


def _tree(recs):
    """(name, parent's name, step) of each span, in the order they
    opened."""
    return [(s.name, s.parent.name if s.parent else None, s.step)
            for s in recs]


def test_off_returns_the_shared_null_context_and_records_nothing():
    a, b = spans.span("forward"), spans.span("backward", step=3)
    assert a is b is spans._NULL
    with a:
        pass
    assert spans.phase("data_wait", step=1) > 0
    spans.phase(None)
    assert spans.recorded() == [] and spans._offset is None


@pytest.mark.parametrize("on", ["recording", "profiler"])
def test_on_records_names_parents_steps_and_counts(on):
    ctx = (spans.recording() if on == "recording"
           else profile(activities=[ProfilerActivity.CPU]))
    before = time.time_ns()
    with ctx:
        assert spans.span("forward") is not spans._NULL
        spans.phase("data_wait", step=7)
        spans.phase("train_step", step=7)
        with spans.span("train_step", step=7):  # the loop's own: one span
            with spans.span("forward"):
                pass
            with spans.span("optimizer"):
                with spans.span("grad_sync"):
                    pass
        spans.phase(None)
    after = time.time_ns()
    assert spans.span("forward") is spans._NULL
    recs = spans.recorded()
    assert _tree(recs) == [("data_wait", None, 7), ("train_step", None, 7),
                           ("forward", "train_step", 7),
                           ("optimizer", "train_step", 7),
                           ("grad_sync", "optimizer", 7)]
    assert all(s.t0 <= s.t1 for s in recs)
    assert recs[0].t1 == recs[1].t0  # one clock read a boundary
    # host times on time.time_ns(), the profiler's clock
    assert before <= recs[0].t0 and recs[-1].t1 <= after
    assert all(s.marks is None and s.device_ns is None for s in recs)


def test_a_profiled_op_lies_inside_its_span_on_the_shared_clock():
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mm"):
            a @ a
    (rec,) = spans.recorded()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert rec.t0 <= e.start_ns() <= e.end_ns() <= rec.t1


def _step(**kw):
    cfg = resolve_config(TrainConfig(**{**TINY, **kw}))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=4)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=4)
    b = synthetic_contrast_batch(np.random.default_rng(0), cfg.batch_size,
                                 size=cfg.crop_size, num_joints=16,
                                 n_data=N_DATA)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    return step, state, batch


@pytest.mark.parametrize("kw,parts", [({}, 1), ({"microbatch": 2}, 2),
                                      ({"remat": True}, 1)],
                         ids=["plain", "microbatch2", "remat"])
def test_stage1_step_spans_its_phases_in_order(kw, parts):
    step, state, batch = _step(**kw)
    step(state, batch, torch.Generator().manual_seed(1))  # unrecorded
    assert spans.recorded() == []
    with spans.recording():
        step(state, batch, torch.Generator().manual_seed(2))
    recs = spans.recorded()
    want = ([("train_step", None, 1)]
            + [(n, "train_step", 1) for n in PART] * parts
            + [("optimizer", "train_step", 1), ("grad_sync", "optimizer", 1),
               ("metrics", "train_step", 1)])
    assert _tree(recs) == want
    root = recs[0]
    kids = [s for s in recs if s.parent is root]
    assert [s.name for s in kids] == PART * parts + TAIL
    for a, b in zip(kids, kids[1:]):
        assert root.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= root.t1


POINT = ["depth2pts", "pn_sa", "pn_fp"]


def test_hrnetpn_step_spans_its_point_branch_inside_forward():
    """HRNetPN's point branch (models/pointnet2_model.py) records
    `depth2pts`, then `pn_sa` and `pn_fp`, each inside the step's
    `forward` and in its time; an unrecorded step records nothing.  A
    span that moved out of `forward`, or one missing, fails here, and
    the benchmark's point_fwd_ms would read it wrongly."""
    step, state, batch = _step(arch="HRNetPN", pn_num_points=64)
    step(state, batch, torch.Generator().manual_seed(1))  # unrecorded
    assert spans.recorded() == []
    with spans.recording():
        step(state, batch, torch.Generator().manual_seed(2))
    recs = spans.recorded()
    fwd = [s for s in recs if s.name == "forward"]
    assert len(fwd) == 1
    kids = [s for s in recs if s.parent is fwd[0]]
    assert [s.name for s in kids] == POINT
    assert [(s.name, s.step) for s in recs if s.name in POINT] == \
        [(n, 1) for n in POINT]
    for a, b in zip(kids, kids[1:]):
        assert fwd[0].t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= fwd[0].t1


def test_hrnetpn_stage2_forward_spans_pts2depth():
    """With return_fm and linear_feat_map (stage 2) the point features
    carried back onto the pixels record `pts2depth` after the encoder's
    spans, inside the caller's `forward`."""
    from hcmoco_tpu_torch.models.pointnet2_model import HCMoCoPNModel

    torch.manual_seed(0)
    model = HCMoCoPNModel(width=4, linear_feat_map=True, n_points=64,
                          dtype=torch.float32)
    _, _, batch = _step()
    args = (batch["rgbd"].permute(0, 3, 1, 2), batch["skeleton"],
            batch["depth_mask"], batch["grid_xy"], 424.0, 512.0,
            batch["depth_mean"])
    model(*args, generator=torch.Generator().manual_seed(0),
          return_fm=True)
    assert spans.recorded() == []
    with spans.recording():
        with spans.span("forward"):
            model(*args, generator=torch.Generator().manual_seed(0),
                  return_fm=True)
    assert _tree(spans.recorded()) == [("forward", None, None)] + [
        (n, "forward", None) for n in POINT + ["pts2depth"]]


def _drifting(roots=12, gaps=2000, ppm=20, seed=0):
    """Kernels back to back 2 us apart on a trace's clock, and spans whose
    markers sit in the gaps, their device times drifting by `ppm` from
    the trace's clock: (spans, kernels, the true offset)."""
    rng = np.random.default_rng(seed)
    ks, mids, t = [], [], 10 ** 12
    for _ in range(roots * gaps):
        d = int(rng.integers(5_000, 200_000))
        ks.append((t, t + d))
        mids.append(t + d + 1_000)
        t += d + 2_000
    true = 10 ** 12 - 5_000_000
    recs = []

    def dev(x):  # the device's clock
        return x - true + int((x - 10 ** 12) * ppm * 1e-6)

    for r in range(roots):
        at = mids[r * gaps:(r + 1) * gaps:gaps // 8][:8]
        root = spans.Span("train_step", None, r, 0, 1, dev0=dev(at[0]),
                          dev1=dev(at[-1]))
        recs.append(root)
        recs += [spans.Span("forward", root, r, 0, 1, dev0=dev(a),
                            dev1=dev(b)) for a, b in zip(at, at[1:])]
    return recs, ks, true


def test_place_takes_out_a_coarse_anchor_and_drift():
    """span_place.place against the trace's kernels: from a coarse
    placement 0.9 ms off (anchor()'s error on the card), every marker
    lands in its gap with clocks that drift 5 ppm apart, and within 2 us
    of it at 20 ppm (4 us over a root span here)."""
    for ppm, err in ((5, 0), (20, 2_000)):
        recs, ks, true = _drifting(ppm=ppm)
        busy = span_place._union(ks)
        for s in recs:
            s.at0, s.at1 = s.dev0 + true + 900_000, s.dev1 + true + 900_000
        marks = [v for s in recs for v in (s.at0, s.at1)]
        assert span_place._misplaced(marks, busy) > 10_000
        got = span_place.place(recs, ks)
        assert got <= err
        assert span_place._misplaced(
            [v for s in recs for v in (s.at0, s.at1)], busy) == got
    # a marker 5 ns inside a kernel
    assert span_place._misplaced([ks[3][0] + 5], span_place._union(ks)) == 5


def test_place_holds_a_marker_inside_an_overlapped_long_kernel():
    """A long kernel that a later, shorter one overlaps (two streams, or
    the profiler's clock snapping back): a marker inside the long one
    after the short one has ended lies inside the kernels, and place
    moves it out."""
    us = 1000
    ks = [(0, 100 * us), (10 * us, 20 * us), (103 * us, 400 * us)]
    busy = span_place._union(ks)
    assert busy.tolist() == [[0, 100 * us], [103 * us, 400 * us]]
    assert span_place._misplaced([60 * us], busy) == 40 * us
    assert span_place._misplaced([15 * us], busy) == 15 * us
    assert span_place._misplaced([101 * us], busy) == 0
    root = spans.Span("train_step", None, 0, 0, 1, dev0=0, dev1=0,
                      at0=60 * us, at1=60 * us)
    assert span_place.place([root], ks) == 0
    assert 100 * us <= root.at0 <= 103 * us


def test_breakdown_splits_phases_and_names_gaps_by_span():
    """tools/phase_breakdown.py on spans and kernels made here (in us):
    the spans placed against the kernels, each phase's device time split
    into busy and idle, the share the phases tile, and each idle gap
    named by the innermost span open at its midpoint."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import phase_breakdown as pb
    from h100_bench.devtrace import Trace

    us = 1000
    root = spans.Span("train_step", None, 0, 0, 1, dev0=0, dev1=100 * us)
    recs = [root] + [spans.Span(n, root, 0, 0, 1, dev0=a * us, dev1=b * us)
                     for n, a, b in (("forward", 0, 40), ("nce", 40, 60),
                                     ("backward", 60, 100))]
    for s in recs:  # a coarse placement 3 us late
        s.at0, s.at1 = s.dev0 + 3 * us, s.dev1 + 3 * us
    ops = [("mm_bn_fast_kernel", 0, 30 * us),
           ("k1b_bwd_dy_kernel", 45 * us, 10 * us),
           ("Memcpy DtoH", 70 * us, 30 * us)]
    out = pb.breakdown(recs, Trace(ops=ops, window_s=100e-6), steps=1)
    assert [(s.at0, s.at1) for s in recs[1:]] == [
        (0, 40 * us), (40 * us, 60 * us), (60 * us, 100 * us)]
    assert out["forward"] == pytest.approx(
        {"device_ms": 0.04, "busy_ms": 0.03, "idle_ms": 0.01})
    assert out["nce"]["busy_ms"] == pytest.approx(0.01)
    assert out["backward"]["idle_ms"] == pytest.approx(0.01)
    assert out["tiled_share"] == pytest.approx(1.0)
    assert out["launches"] == 2 and out["anchor_error_us"] == 0
    assert out["idle_gaps_ms"] == [["forward", 0.015], ["backward", 0.015]]


@pytest.mark.cuda
def test_markers_hold_the_kernels_of_their_phases_on_card():
    """On the card, over a traced window of a small fused stage-1 step,
    the markers placed against the trace's kernels (span_place.place): they
    lie inside no kernel by more than 0.1 ms, every K1 `mm_bn` kernel
    lies inside a `forward` device interval, every K1b backward kernel
    (dy, dyt, sums) inside a `backward` one, and the markers' record
    calls launch no device operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the markers are CUDA events")
    import os

    from torch.autograd import DeviceType

    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse

    dev = torch.device("cuda")
    cfg = resolve_config(TrainConfig(**{
        **TINY, "width": 18, "crop_size": 128, "batch_size": 16,
        "compute_dtype": "bfloat16"}))
    torch.manual_seed(0)
    os.environ["HCMOCO_CONVBN_FUSE"] = "1"
    try:
        model = set_convbn_fuse(build_model(cfg, device=dev), True).to(
            memory_format=torch.channels_last)
    finally:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    state = create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=4)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=4)
    b = synthetic_contrast_batch(np.random.default_rng(0), cfg.batch_size,
                                 size=cfg.crop_size, num_joints=16,
                                 n_data=N_DATA)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in b.items()}

    for i in range(2):  # warm-up
        step(state, batch, torch.Generator(dev).manual_seed(i))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(state, batch, torch.Generator(dev).manual_seed(i))
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation() and e.duration_ns() > 0]
    on = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in ops]
    recs = spans.recorded()
    assert len(recs) == 3 * (1 + len(PART) + 3)
    # every marker's record call is in the trace, and none ran on the card
    records = {e.correlation_id() for e in events
               if e.name().startswith("cudaEventRecord")}
    assert len(records) >= 2 * len(recs), sorted(
        {e.name() for e in events if e.device_type() != DeviceType.CUDA})
    assert not [e.name() for e in ops if e.correlation_id() in records]

    err = span_place.place(recs, [(a, z) for _, a, z in on])
    print(f"markers inside kernels by at most {err / 1e3:.2f} us")
    assert err < 100_000

    def inside(name, keys):
        ivs = [(s.at0, s.at1) for s in recs if s.name == name]
        ks = [(a, z) for n, a, z in on if any(k in n for k in keys)]
        assert ks, keys
        return sum(any(a0 <= a and z <= a1 for a0, a1 in ivs)
                   for a, z in ks) / len(ks)

    assert inside("forward", ("mm_bn_fast", "mm_bn_generic")) == 1.0
    assert inside("backward", ("k1b_bwd", "k1b_dyt")) == 1.0
