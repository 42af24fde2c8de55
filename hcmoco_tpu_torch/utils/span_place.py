"""Place the recorded spans' device markers (utils/spans.py) on the clock
of a profiler trace, against the trace's kernels, and say how far they
are misplaced after.

A marker is ordered with its stream's kernels, so placed right it lies
inside none of them, and placed d off it lies up to d inside the kernels
beside it.  How deep a marker lies is measured against the union of the
trace's kernels (copies and fills included), so a marker inside a long
kernel that a later, shorter one overlaps counts as inside it.  The
placing takes the offset from device to trace time that puts a step's
deepest marker least deep.  Used by `--profile_dir`'s trace
(cli/main_contrast.py::add_spans) and tools/phase_breakdown.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# how far from anchor()'s placement the first step's offset is sought
REACH_NS = 3_000_000
# how far a step's offset is sought from the step's before it: a trace's
# kernel times drift from the device's event clock by tens of µs a step
# at times (the profiler's conversion to host time)
DRIFT_NS = 1_000_000
# the offsets' spacing
RES_NS = 500


def _union(kernels: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The union of the intervals `kernels` (start, end ns): (n, 2)
    disjoint, start-sorted (start, end)."""
    ks = np.asarray(sorted(kernels), dtype=np.int64).reshape(-1, 2)
    if len(ks) < 2:
        return ks
    ends = np.maximum.accumulate(ks[:, 1])
    # a kernel starts a new interval where it starts after every earlier
    # one has ended
    new = np.ones(len(ks), dtype=bool)
    new[1:] = ks[1:, 0] >= ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(ks) - 1)
    return np.stack([ks[first, 0], ends[last]], axis=1)


def _depth(marks: np.ndarray, busy: np.ndarray) -> np.ndarray:
    """How deep each of `marks` (ns) lies inside the disjoint, start-sorted
    intervals `busy` (_union), 0 outside them."""
    i = np.searchsorted(busy[:, 0], marks, side="right") - 1
    j = np.maximum(i, 0)
    inside = np.minimum(marks - busy[j, 0], busy[j, 1] - marks)
    return np.where(i >= 0, np.maximum(inside, 0), 0)


def _misplaced(marks: Sequence[int], busy: np.ndarray) -> int:
    """How far the markers at `marks` (ns) lie inside `busy` at most."""
    if not len(busy) or not len(marks):
        return 0
    return int(_depth(np.asarray(marks, dtype=np.int64), busy).max())


def place(recs, kernels: Sequence[Tuple[int, int]]) -> int:
    """Place the markers of `recs` (spans.recorded()) on the clock of the
    trace whose device operations (start, end ns) are `kernels`, and
    return how deep the deepest of them lies inside them after, in ns:
    the placement's error.  Each root span (a step) takes the offset
    that puts its deepest marker least deep: of those within REACH_NS of
    anchor()'s for the first root and within DRIFT_NS of the last root's
    after it, the nearest to the last."""
    busy = _union(kernels)
    marked = [s for s in recs if s.dev0 is not None]
    if not len(busy) or not marked:
        return 0
    groups = {}
    for s in marked:
        root = s
        while root.parent is not None:
            root = root.parent
        groups.setdefault(id(root), []).append(s)
    c, reach = marked[0].at0 - marked[0].dev0, REACH_NS
    for group in groups.values():
        t = np.array([v for s in group for v in (s.dev0, s.dev1)],
                     dtype=np.int64)
        cand = c + np.arange(-reach, reach + 1, RES_NS, dtype=np.int64)
        cost = np.concatenate([
            _depth(t[None, :] + block[:, None], busy).max(axis=1)
            for block in np.array_split(cand, max(1, len(cand) // 256))])
        best = cand[cost == cost.min()]
        c, reach = int(best[np.argmin(np.abs(best - c))]), DRIFT_NS
        for s in group:
            s.at0, s.at1 = s.dev0 + c, s.dev1 + c
    return _misplaced([v for s in marked for v in (s.at0, s.at1)], busy)
