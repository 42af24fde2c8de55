"""Metric averaging + stdout/TSV/tensorboard logging (counterpart of
hcmoco_tpu/utils/meters.py: the same stdout lines and the same TSV).

Reference: `pycontrast/learning/util.py:6-40` (AverageMeter, accuracy) and
the rank-0 tensorboard_logger usage (base_trainer.py:75-78,
HRNet-Semantic-Segmentation lib/utils/utils.py:83-115).  MetricLogger writes
machine-readable TSV next to the checkpoints plus the familiar formatted
stdout lines, and — when tensorboardX or torch.utils.tensorboard imports —
browsable tensorboard event files under <log_dir>/tb, matching the
reference's per-epoch scalar logging.  Under data parallelism the metrics
are global and rank 0 alone prints and writes, as the reference's rank 0
does."""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

from ..parallel.mesh import world


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _summary_writer(path: str):
    """A tensorboard SummaryWriter from tensorboardX, else from
    torch.utils.tensorboard; None if neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except Exception:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:  # optional dependency
            return None
    try:
        return SummaryWriter(path)
    except Exception:
        return None


class MetricLogger:
    """Scalar logger: stdout every print_freq + append-only TSV file +
    tensorboard event file (same per-epoch averages the reference logs via
    `self.logger.log_value(..., epoch)`, base_trainer.py:75-78)."""

    def __init__(self, log_dir: Optional[str] = None,
                 print_freq: int = 10, tensorboard: bool = True):
        self.print_freq = print_freq
        self.meters: Dict[str, AverageMeter] = {}
        self._tsv = None
        self._tsv_keys = None
        self._tb = None
        # only rank 0 prints and writes
        self.quiet = world()[0] != 0
        if log_dir and not self.quiet:
            os.makedirs(log_dir, exist_ok=True)
            self._tsv_path = os.path.join(log_dir, "metrics.tsv")
            if tensorboard:
                self._tb = _summary_writer(os.path.join(log_dir, "tb"))

    def update(self, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def log_step(self, epoch: int, it: int, total: int,
                 metrics: Dict[str, float], n: int = 1):
        self.update(metrics, n)
        if (it + 1) % self.print_freq == 0 and not self.quiet:
            parts = " ".join(
                f"{k} {m.val:.4f} ({m.avg:.4f})"
                for k, m in sorted(self.meters.items()))
            print(f"Train: [{epoch}][{it + 1}/{total}] {parts}")
            sys.stdout.flush()

    def write_epoch(self, epoch: int):
        if getattr(self, "_tsv_path", None):
            keys = sorted(self.meters)
            new_file = not os.path.exists(self._tsv_path)
            with open(self._tsv_path, "a") as f:
                if new_file:
                    f.write("epoch\t" + "\t".join(keys) + "\n")
                f.write(f"{epoch}\t" + "\t".join(
                    f"{self.meters[k].avg:.6f}" for k in keys) + "\n")
        if self._tb is not None:
            for k in sorted(self.meters):
                self._tb.add_scalar(k, self.meters[k].avg, epoch)
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def reset(self):
        for m in self.meters.values():
            m.reset()
