"""Train state: model (+ the segmentor's classifier) + optimizer + memory
banks + step (counterpart of hcmoco_tpu/train/state.py).

The JAX package keeps these in one immutable pytree (the versatility
segmentor's as {'model': ..., 'classifier': ...}); here they are the usual
stateful torch objects, updated in place by the train step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from ..contrast.memory import init_memory
from ..core.config import TrainConfig
from ..parallel.mesh import broadcast_
from .schedules import learning_rate_fn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    banks: torch.Tensor  # (n_modal, n_data, dim) f32, rows L2-normalised
    step: int = 0        # global iteration
    # the versatility segmentor's FCN head, under the same optimizer
    classifier: Optional[nn.Module] = None


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor],
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """SGD with heavy-ball momentum and L2 on every param, the same update
    as the JAX package's optax add_decayed_weights -> trace ->
    scale_by_learning_rate.  The caller sets the lr from the returned
    schedule before each step."""
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)
    opt = torch.optim.SGD(params, lr=lr_fn(0), momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay, nesterov=False)
    return opt, lr_fn


def create_train_state(cfg: TrainConfig, model: nn.Module,
                       generator: torch.Generator, n_data: int,
                       steps_per_epoch: int,
                       classifier: Optional[nn.Module] = None) -> TrainState:
    """One optimizer over all of model's params (and the classifier's,
    after them) and randomly initialised banks drawn from `generator`, on
    the model's device.  Under data parallelism every rank then takes rank
    0's parameters, BN statistics and banks, so the replicas start equal."""
    if not cfg.mem.startswith("bank"):
        raise NotImplementedError(
            f"mem {cfg.mem} is not ported yet: ROADMAP.md Queue 1 item 11")
    device = next(model.parameters()).device
    params = list(model.parameters())
    if classifier is not None:
        params += list(classifier.parameters())
    opt, _ = make_optimizer(cfg, params, steps_per_epoch)
    n_modal = {"RGB": 1, "CMC": 2, "RGBD2S": 3}[cfg.modal]
    banks = init_memory(generator, n_modal, n_data, cfg.feat_dim,
                        device=device)
    modules = [model] + ([classifier] if classifier is not None else [])
    broadcast_([t for m in modules for t in (*m.parameters(), *m.buffers())]
               + [banks])
    return TrainState(model=model, optimizer=opt, banks=banks,
                      classifier=classifier)
