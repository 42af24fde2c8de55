"""The program's own spans in the traced window, as its span recorder
(hcmoco_tpu_torch/utils/spans.py) kept them: the recorder is on while
the profiler is, so the window's steps are recorded and the set-up
steps are not.  A program without the recorder has none to read."""

from __future__ import annotations

from typing import Iterable, Optional


def device_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """Device ms a step in the spans named `names`: each span's close
    marker less its open marker, summed over the window, over its steps;
    None where no such span was recorded."""
    if ctx.trace is None:
        return None
    try:
        from hcmoco_tpu_torch.utils import spans
    except ImportError:
        return None
    names = set(names)
    ns = [s.device_ns for s in spans.recorded()
          if s.name in names and s.device_ns is not None]
    return sum(ns) / 1e6 / ctx.steps if ns else None
