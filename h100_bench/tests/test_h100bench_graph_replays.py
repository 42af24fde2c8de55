"""The reader of graph_replays_per_step on spans the test makes: it
counts the program's `encoder_graph` spans over the window's steps, and
reads None with no such span, with no traced window, and where the
program has no span recorder."""

import sys

import pytest

import hcmoco_tpu_torch.utils

from h100bench_common import REPO

from h100_bench import cells
from h100_bench.context import Context
from h100_bench.devtrace import Trace
from hcmoco_tpu_torch.utils import spans


def _ctx(steps=2, traced=True):
    return Context(trace=Trace(ops=[], window_s=1.0) if traced else None,
                   steps=steps, samples=8 * steps, window_s=1.0, rows=8,
                   run={}, forward_flops=lambda: 0)


def _window(steps, replays):
    """`steps` steps, each a forward holding `replays` encoder_graph
    spans, then a backward."""
    out = []
    for i in range(steps):
        root = spans.Span("train_step", None, i, t0=0, t1=1)
        fwd = spans.Span("forward", root, i, t0=0, t1=1)
        out += [root, fwd]
        out += [spans.Span("encoder_graph", fwd, i, t0=0, t1=1)
                for _ in range(replays)]
        out.append(spans.Span("backward", root, i, t0=0, t1=1))
    return out


@pytest.mark.parametrize("replays", [1, 2])
def test_reader_counts_encoder_graph_spans_a_step(monkeypatch, replays):
    monkeypatch.setattr(spans, "recorded", lambda: _window(3, replays))
    got = cells.reader(REPO, "graph_replays_per_step")(_ctx(steps=3))
    assert got == replays


def test_reader_reads_none_without_encoder_graph_spans(monkeypatch):
    read = cells.reader(REPO, "graph_replays_per_step")
    monkeypatch.setattr(spans, "recorded", lambda: _window(3, 0))
    assert read(_ctx(steps=3)) is None
    monkeypatch.setattr(spans, "recorded", lambda: _window(1, 2))
    assert read(_ctx(traced=False)) is None
    # a program without the recorder
    monkeypatch.delattr(hcmoco_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "hcmoco_tpu_torch.utils.spans", None)
    assert read(_ctx()) is None
