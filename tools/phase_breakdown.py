"""Where a traced window of a benchmark cell spends the card's time, by
the program's own spans (hcmoco_tpu_torch/utils/spans.py).

    python3 tools/phase_breakdown.py --workload hrnet_w18_s1.b224 \
        --seed 7 [--seconds 30]

Runs the cell's set-up and traced window as the benchmark's `--trace 1`
run does (h100_bench/session.py), then prints one JSON line: for each
phase of the train step, its device ms a step (between its markers), the
ms of it in which a kernel ran (busy) and the rest (idle); the share of
the window's ms a step that the step's phases tile, and the rest; the
launches a step; the longest idle gaps, each named by the innermost span
open on the device timeline at its midpoint; and how far any marker
lies inside a kernel once placed (the anchor's error,
`span_place.place`).  Needs a CUDA card; the card's name and power
limit are in the line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the train step's phases; grad_sync lies inside optimizer, and
# HRNetPN's point branch (depth2pts, pn_sa, pn_fp; pts2depth in stage 2)
# and the HRNet encoders' graph replays (encoder_graph) inside forward
PHASES = ("forward", "nce", "backward", "bank_update", "optimizer",
          "grad_sync", "metrics", "depth2pts", "pn_sa", "pn_fp",
          "pts2depth", "encoder_graph")
TILE = ("forward", "nce", "backward", "bank_update", "optimizer", "metrics")


def _overlap(a0: int, a1: int, busy, starts) -> int:
    """ns of [a0, a1) covered by the merged intervals `busy`."""
    i = max(bisect.bisect_right(starts, a0) - 1, 0)
    got = 0
    while i < len(busy) and busy[i][0] < a1:
        got += max(0, min(a1, busy[i][1]) - max(a0, busy[i][0]))
        i += 1
    return got


def _nesting(s) -> int:
    d = 0
    while s.parent is not None:
        s, d = s.parent, d + 1
    return d


def breakdown(recs, trace, steps: int, k: int = 10) -> dict:
    """The window's phases and gaps from the recorded spans `recs`
    (spans.recorded()), placed by span_place.place against the device's
    operations of `trace` (h100_bench.devtrace.Trace) over `steps`
    steps."""
    from h100_bench.devtrace import is_launch
    from hcmoco_tpu_torch.utils import span_place

    error = span_place.place(recs, [(s, s + d) for _, s, d in trace.ops])
    busy = trace.busy_intervals()
    starts = [a for a, _ in busy]
    placed = [s for s in recs if s.at0 is not None]
    out = {"window_ms": trace.window_s * 1e3 / steps,
           "launches": trace.count_where(is_launch) / steps}
    for name in PHASES:
        ivs = [(s.at0, s.at1) for s in placed if s.name == name]
        dev = sum(b - a for a, b in ivs)
        on = sum(_overlap(a, b, busy, starts) for a, b in ivs)
        out[name] = {"device_ms": dev / 1e6 / steps,
                     "busy_ms": on / 1e6 / steps,
                     "idle_ms": (dev - on) / 1e6 / steps}
    tiled = sum(out[n]["device_ms"] for n in TILE)
    out["tiled_share"] = tiled / out["window_ms"]
    out["untiled_ms"] = out["window_ms"] - tiled
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:k]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        open_ = [s for s in placed if s.at0 <= mid < s.at1]
        inner = max(open_, key=_nesting, default=None)
        named.append([inner.name if inner else "outside the program's spans",
                      (b - a) / 1e6])
    out["idle_gaps_ms"] = named
    out["anchor_error_us"] = error / 1e3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    from h100_bench import run as bench_run, session
    from hcmoco_tpu_torch.utils import spans

    if not torch.cuda.is_available():
        print("phase_breakdown.py needs a CUDA card", file=sys.stderr)
        return 2
    bench_run.cache_dirs()
    spans.clear()
    out = session.run_cell(ROOT, session.Args(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=True), t_start)
    w = out["window"]
    line = breakdown(spans.recorded(), w.trace, w.steps)
    line.update(workload=args.workload, seed=args.seed, steps=w.steps,
                card=torch.cuda.get_device_name(out["device"]),
                power_limit=bench_run.power_limit())
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
