"""The port's span recorder: named spans at the layer boundaries of the
program (the train step's phases, the collectives, the CLI loop), kept in
memory.

    with spans.span("forward"):
        ...

Off is the normal state: `span` then costs one check and hands back a
shared null context (no allocation, no clock read).  Recording is on
inside `recording()`, and while a torch.profiler session is active, so
that any profile of the program (the benchmark's traced window, an
operator's own) carries its spans.

A span records its name, the span it opened inside (`parent`), the
global step it belongs to (`step=` on a root span, else its parent's),
and its host start and end on the clock that the profiler stamps its
events with, `time.time_ns()`: read as `time.perf_counter_ns()` plus one
offset taken at the first span after `clear()`, so that `phase()` hands
its caller a monotonic time from the same read.  Where CUDA is in use a
span also records a CUDA event on the current stream when it opens and
when it closes.  The two markers are ordered with the stream's kernels:
their interval on the device is the span's device time, and on a
one-stream step consecutive spans tile the device timeline, so a gap in
which the device waited lies inside the span whose kernels it waited
for.  The markers are events, not kernels: they add no device operation.

`recorded()` resolves the markers (after a synchronize) into device
start and end, relative to the first marker and placed on the host's
clock (`anchor`, within a ms or so); `span_place.place` places them on a
trace's clock against its kernels.  `clear()` drops every record.  A
span opened directly inside an open span of the same name is that span
(the CLI loop's `train_step` around the step's own).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
# depth of open recording() blocks
_recording = 0
# every span opened since the last clear(), in the order they opened
_records: List["Span"] = []
# the open spans, innermost last
_stack: List["Span"] = []
# the span phase() opened last, while it is open
_phase: Optional["Span"] = None
# time.time_ns() less time.perf_counter_ns(), taken at the first span
# after clear()
_offset: Optional[int] = None
# the first marker that recorded() resolved, and where it lies on the
# host's clock: the origin of every span's device times
_origin: Optional[Tuple[torch.cuda.Event, int]] = None


@dataclass(eq=False)
class Span:
    """One span: host times in ns on time.time_ns(); device times in ns,
    relative to the first marker (`dev0`, `dev1`) and placed (`at0`,
    `at1`: on the host's clock by recorded(), on a trace's by
    span_place.place()), where markers were recorded."""
    name: str
    parent: Optional["Span"]
    step: Optional[int]
    t0: int
    t1: Optional[int] = None
    marks: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    dev0: Optional[int] = None
    dev1: Optional[int] = None
    at0: Optional[int] = None
    at1: Optional[int] = None

    @property
    def device_ns(self) -> Optional[int]:
        """The span's interval on the device, close marker less open."""
        return None if self.dev0 is None else self.dev1 - self.dev0


def _host(t: int) -> int:
    """The time.perf_counter_ns() reading `t` on time.time_ns()."""
    global _offset
    if _offset is None:
        _offset = time.time_ns() - time.perf_counter_ns()
    return t + _offset


def _marker() -> Optional[torch.cuda.Event]:
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _open(name: str, step: Optional[int], t: int) -> Span:
    parent = _stack[-1] if _stack else None
    if step is None and parent is not None:
        step = parent.step
    rec = Span(name, parent, step, _host(t))
    m = _marker()
    if m is not None:
        rec.marks = (m, None)
    _records.append(rec)
    _stack.append(rec)
    return rec


def _close(rec: Span, t: int) -> None:
    if rec.marks is not None:
        rec.marks = (rec.marks[0], _marker())
    rec.t1 = _host(t)
    if _stack and _stack[-1] is rec:
        _stack.pop()
    elif rec in _stack:
        _stack.remove(rec)


class _Open:
    __slots__ = ("name", "step", "rec")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step, self.rec = name, step, None

    def __enter__(self) -> Span:
        self.rec = _open(self.name, self.step, time.perf_counter_ns())
        return self.rec

    def __exit__(self, *exc) -> None:
        _close(self.rec, time.perf_counter_ns())


def span(name: str, step: Optional[int] = None):
    """A context that records the span `name` while recording is on
    (`step=` gives a root span its global step)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    if _stack and _stack[-1].name == name:
        return _NULL
    return _Open(name, step)


def phase(name: Optional[str] = None, step: Optional[int] = None) -> int:
    """Close the span that phase() opened last, if it is open, and open
    `name` (None opens none): consecutive parts of a loop as spans, from
    one clock read a boundary, which is returned (time.perf_counter_ns())
    for the caller's own timing.  Recording off, only the clock is
    read."""
    global _phase
    now = time.perf_counter_ns()
    if _phase is not None:
        _close(_phase, now)
        _phase = None
    if name is not None and (_recording or
                             _profiler._is_profiler_enabled):
        _phase = _open(name, step, now)
    return now


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def clear() -> None:
    """Drop every record (open spans close unrecorded)."""
    global _phase, _origin, _offset
    _records.clear()
    _stack.clear()
    _phase = _origin = _offset = None


def recorded() -> List[Span]:
    """The closed spans since the last clear(), in the order they opened,
    their markers resolved: device times relative to the first marker,
    and placed on the host's clock by anchor()."""
    global _origin
    done = [s for s in _records if s.t1 is not None]
    todo = [s for s in done if s.marks is not None and s.dev0 is None]
    if todo:
        torch.cuda.synchronize()
        if _origin is None:
            first = todo[0].marks[0]
            _origin = (first, anchor(first))
        first, at = _origin
        for s in todo:
            s.dev0 = round(first.elapsed_time(s.marks[0]) * 1e6)
            s.dev1 = round(first.elapsed_time(s.marks[1]) * 1e6)
            s.at0, s.at1 = at + s.dev0, at + s.dev1
    return done


def anchor(first: torch.cuda.Event) -> int:
    """Where `first` lies on the host's clock (time.time_ns()), in ns: a
    marker recorded on the idle device completes when it reaches the
    device, so its host time lies between the clock reads around its
    record and synchronize, and its distance from `first` on the device
    places `first`.  A coarse placement: the profiler's kernel times
    and the device's events part by up to a ms over a window, which
    span_place.place takes out against a trace's kernels."""
    torch.cuda.synchronize()
    h0 = time.time_ns()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    e.synchronize()
    h1 = time.time_ns()
    return (h0 + h1) // 2 - round(first.elapsed_time(e) * 1e6)
