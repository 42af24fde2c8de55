"""Train state: model (+ the segmentor's classifier) + optimizer + memory
banks, or for mem='moco' the key encoder and the queue, + step
(counterpart of hcmoco_tpu/train/state.py).

The JAX package keeps these in one immutable pytree (the versatility
segmentor's as {'model': ..., 'classifier': ...}); here they are the usual
stateful torch objects, updated in place by the train step.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from ..contrast.memory import MoCoState, init_memory, init_moco
from ..core.config import TrainConfig
from ..parallel.mesh import broadcast_
from .schedules import learning_rate_fn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    # (n_modal, n_data, dim) f32, rows L2-normalised; None for mem='moco'
    banks: Optional[torch.Tensor]
    step: int = 0        # global iteration
    # the versatility segmentor's FCN head, under the same optimizer
    classifier: Optional[nn.Module] = None
    # mem='moco': the key encoder, a copy of the model whose parameters are
    # the EMA of the model's (the JAX package's params_ema) and under no
    # optimizer, and the queue
    key_model: Optional[nn.Module] = None
    moco: Optional[MoCoState] = None


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
    the model's device; for mem='moco' instead the key encoder (a copy of
    the model, its parameters frozen) and a queue of cfg.nce_k rows drawn
    from `generator`.  Under data parallelism every rank then takes rank
    0's parameters, BN statistics and banks or queue, so the replicas
    start equal (the key encoder is copied from the model once it is
    rank 0's)."""
    if not (cfg.mem.startswith("bank") or cfg.mem == "moco"):
        raise NotImplementedError(f"mem {cfg.mem}")
    device = next(model.parameters()).device
    params = list(model.parameters())
    if classifier is not None:
        params += list(classifier.parameters())
    opt, _ = make_optimizer(cfg, params, steps_per_epoch)
    n_modal = {"RGB": 1, "CMC": 2, "RGBD2S": 3}[cfg.modal]
    banks, moco = None, None
    if cfg.mem == "moco":
        moco = init_moco(generator, n_modal, cfg.nce_k, cfg.feat_dim,
                         device=device)
        replicated = [moco.queues]
    else:
        banks = init_memory(generator, n_modal, n_data, cfg.feat_dim,
                            device=device)
        replicated = [banks]
    modules = [model] + ([classifier] if classifier is not None else [])
    broadcast_([t for m in modules for t in (*m.parameters(), *m.buffers())]
               + replicated)
    key_model = None
    if moco is not None:
        key_model = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model=model, optimizer=opt, banks=banks,
                      classifier=classifier, key_model=key_model, moco=moco)


def copy_to_key_model(state: TrainState) -> None:
    """The key encoder's parameters := the model's, once weights have been
    loaded into the model (--IN_Pretrain, --pretrain): the reference's
    momentum_update(model, model_ema, 0).  No-op without a key encoder."""
    if state.key_model is None:
        return
    with torch.no_grad():
        for e, p in zip(state.key_model.parameters(),
                        state.model.parameters()):
            e.copy_(p)
