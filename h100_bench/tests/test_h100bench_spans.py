"""The readers of the program's spans (forward_ms, backward_ms,
nce_bank_ms, optimizer_ms) on spans the test makes: each sums the device
interval of its spans over the window and divides by its steps, and
reads None with no span recorded, with no traced window, and where the
program has no span recorder."""

import sys

import pytest

import hcmoco_tpu_torch.utils

from h100bench_common import REPO

from h100_bench import cells
from h100_bench.context import Context
from h100_bench.devtrace import Trace
from hcmoco_tpu_torch.utils import spans

READERS = {"forward_ms": ("forward",), "backward_ms": ("backward",),
           "nce_bank_ms": ("nce", "bank_update"),
           "optimizer_ms": ("optimizer",)}


def _ctx(steps=2, traced=True):
    return Context(trace=Trace(ops=[], window_s=1.0) if traced else None,
                   steps=steps, samples=8 * steps, window_s=1.0, rows=8,
                   run={}, forward_flops=lambda: 0)


def _window(steps):
    """Spans of `steps` steps as the recorder resolves them: each phase
    of step i lasts (its index + 1) ms + i us on the device; grad_sync
    inside optimizer."""
    out, t = [], 0
    for i in range(steps):
        root = spans.Span("train_step", None, i, t0=0, t1=1)
        out.append(root)
        for j, name in enumerate(["forward", "nce", "backward",
                                  "bank_update", "optimizer", "grad_sync",
                                  "metrics"]):
            d = (j + 1) * 10 ** 6 + i * 10 ** 3
            out.append(spans.Span(name, root, i, t0=0, t1=1, dev0=t,
                                  dev1=t + d))
            t += d
    return out


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_its_spans_device_ms_a_step(monkeypatch, metric):
    recs = _window(3)
    monkeypatch.setattr(spans, "recorded", lambda: recs)
    got = cells.reader(REPO, metric)(_ctx(steps=3))
    want = sum(s.dev1 - s.dev0 for s in recs
               if s.name in READERS[metric]) / 1e6 / 3
    assert got == pytest.approx(want, rel=1e-12)
    # forward 1 ms, nce 2 + bank_update 4, backward 3, optimizer 5
    # (grad_sync's 6 is inside it), each span i us longer in step i: 1 us
    # a span on the mean of steps 0-2
    base = {"forward_ms": 1, "nce_bank_ms": 6, "backward_ms": 3,
            "optimizer_ms": 5}[metric]
    assert got == pytest.approx(base + len(READERS[metric]) * 1e-3)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_none_without_spans(monkeypatch, metric):
    read = cells.reader(REPO, metric)
    spans.clear()
    assert read(_ctx()) is None
    monkeypatch.setattr(spans, "recorded", lambda: _window(1))
    assert read(_ctx(traced=False)) is None
    # a program without the recorder (the port before it had one)
    monkeypatch.delattr(hcmoco_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "hcmoco_tpu_torch.utils.spans", None)
    assert read(_ctx()) is None
