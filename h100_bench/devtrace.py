"""The traced window: torch.profiler with CUDA activity only, its device
events reduced in memory to what the per-layer readers take.

Host activity is not recorded, so the tracer adds no host time to the
steps and the idle share is the program's.  The harness marks its own
spans on the host clock (each step call, and the loop between calls), and
each idle gap on the device is named after the span that was open on the
host when it began.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# (class, substrings of the lower-cased kernel name), first match wins:
# the port's step-profile classes (tools/profile_torch_step.py), with the
# collectives first
_CLASSES = (
    ("NCCL collectives", ("nccl",)),
    ("K1b BN apply, its backward, K1's dyt prologue", ("k1b_",)),
    ("K1 mm_bn (fused 1x1 conv + BN stats)", ("mm_bn",)),
    ("cuDNN batch norm", ("batchnorm", "batch_norm", "welford")),
    ("bilinear upsample", ("upsample", "interp")),
    ("cuDNN convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                           "dgrad", "sm90_", "nhwc")),
    ("cuBLAS gemm", ("gemm", "cutlass", "matmul")),
    ("reductions", ("reduce",)),
    ("copies, casts, fills", ("copy", "memcpy", "memset", "fill")),
    ("elementwise arithmetic", ("mul", "add", "sub", "rsqrt", "div", "clamp",
                                "where", "threshold", "relu")),
)
CONV = "cuDNN convolution"
BN_AND_CASTS = ("cuDNN batch norm", "copies, casts, fills")


def kernel_class(name: str) -> str:
    k = name.lower()
    for cls, keys in _CLASSES:
        if any(s in k for s in keys):
            return cls
    return "other elementwise"


def is_launch(name: str) -> bool:
    """A kernel launched by the program, not a copy or fill the driver
    runs."""
    return not name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """Device operations of a traced window: (name, start ns, duration
    ns), start-ordered, on the profiler's clock; the window on the host
    clock; and the harness's host spans."""
    ops: List[Tuple[str, int, int]]
    window_s: float
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, d in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds_where(self, pred) -> float:
        return sum(d for n, _, d in self.ops if pred(n)) / 1e9

    def count_where(self, pred) -> int:
        return sum(1 for n, _, _ in self.ops if pred(n))

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for n, _, d in self.ops:
            tot[n] = tot.get(n, 0) + d
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], d / 1e9] for n, d in best]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest gaps between busy intervals, each named after the
        harness span open on the host when it began."""
        iv = self.busy_intervals()
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        starts = [s for _, s, _ in self.spans]
        out = []
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = self.spans[i][0] if i >= 0 and a <= self.spans[i][2] \
                else "outside the harness's spans"
            out.append([name, (b - a) / 1e9])
        return out


class Tracer:
    """Profiles the device during a window, or does nothing (trace 0).
    Spans are marked either way, at the cost of a clock read each."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.spans: List[Tuple[str, int, int]] = []
        self._open: Optional[Tuple[str, int]] = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def span(self, name: str) -> None:
        """Close the open span and open `name` (None closes only)."""
        now = time.time_ns()
        if self._open is not None:
            self.spans.append((self._open[0], self._open[1], now))
        self._open = None if name is None else (name, now)

    def trace(self, window_s: float) -> Optional[Trace]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        ops = sorted(((e.name(), e.start_ns(), e.duration_ns())
                      for e in self.prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA
                      and not e.is_user_annotation()
                      and e.duration_ns() > 0), key=lambda o: o[1])
        spans = self.spans
        if ops and spans:
            # the profiler's clock against the host's: if they disagree by
            # more than a second, take the first device op as starting
            # with the first span
            shift = ops[0][1] - spans[0][1]
            if abs(shift) > 10 ** 9:
                spans = [(n, a + shift, b + shift) for n, a, b in spans]
        return Trace(ops=ops, window_s=window_s, spans=spans)
