"""What a per-layer reader (h100_bench/metrics/<metric>.py) is given: the
traced window and the counts of the run.  A reader returns its metric's
value, or None where it finds nothing to read."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .devtrace import Trace


@dataclass
class Context:
    trace: Optional[Trace]     # the device's operations in the window
    steps: int                 # steps in the window
    samples: int               # samples in the window
    window_s: float            # the window's wall time
    rows: int                  # samples a step
    run: dict                  # the cell's configuration and traffic
    forward_flops: Callable[[], int]  # model FLOPs of a sample's forward
