"""LR schedule (counterpart of hcmoco_tpu/train/schedules.py).

Reference: pycontrast/learning/base_trainer.py:80-103 -- per-EPOCH cosine
or step decay (epochs count from 1), plus per-ITERATION linear warmup over
the first warm_epochs epochs; warmup_to as in train_options.py:49-64.
"""

from __future__ import annotations

import math
from typing import Callable

from ..core.config import TrainConfig


def learning_rate_fn(cfg: TrainConfig,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """f(step) -> lr for the 0-based global step."""
    lr0 = cfg.learning_rate
    eta_min = lr0 * (cfg.lr_decay_rate ** 3)
    warm = cfg.warm or cfg.batch_size > 256
    warm_epochs = 10 if cfg.epochs > 500 else 5
    warmup_to = lr0
    if warm and cfg.cosine:
        warmup_to = eta_min + (lr0 - eta_min) * (
            1 + math.cos(math.pi * warm_epochs / cfg.epochs)) / 2

    def fn(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        if cfg.cosine:
            lr = eta_min + (lr0 - eta_min) * (
                1 + math.cos(math.pi * epoch / cfg.epochs)) / 2
        else:
            n_decay = sum(epoch > e for e in cfg.lr_decay_epochs)
            lr = lr0 * (cfg.lr_decay_rate ** n_decay)
        if warm and epoch <= warm_epochs:
            p = step / (warm_epochs * steps_per_epoch)
            lr = cfg.warmup_from + p * (warmup_to - cfg.warmup_from)
        return lr

    return fn
