"""The plain reference of HCMoCo's stage-1 training step: the six-way
memory-bank NCE of CMCMem3 with the modality masks of
`_compute_loss_accuracy`, SGD with momentum and L2 on every parameter, the
per-epoch cosine learning rate, and the banks' momentum update
(pycontrast's `_train_mem_skeleton3d`, `mem_bank.py`, `base_trainer.py`).

`reference_steps` runs the first steps of a training run from the
benchmark's weights, banks and batches and returns what the correctness
check compares: each step's loss, every parameter's first gradient, and
every parameter's, BN statistic's and bank's change over the steps, as
norms a leaf.  It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import models

# (query modality, bank) of the six directions 12, 21, 23, 32, 13, 31
DIRECTIONS = ((0, 1), (1, 0), (1, 2), (2, 1), (0, 2), (2, 0))


def learning_rate(cfg: dict, step: int) -> float:
    """Per-epoch cosine from learning_rate down to it times 0.1^3, epochs
    counted from 1 (no warm-up at a batch of 256 or less)."""
    if cfg["batch_size"] > 256:
        raise ValueError("the reference has no warm-up; batch > 256")
    lr0 = cfg["learning_rate"]
    eta_min = lr0 * 0.1 ** 3
    epoch = step // steps_per_epoch(cfg) + 1
    return eta_min + (lr0 - eta_min) * (
        1 + math.cos(math.pi * epoch / cfg["epochs"])) / 2


def steps_per_epoch(cfg: dict) -> int:
    return max(cfg["n_data"] // cfg["batch_size"], 1)


def nce_losses(feats: torch.Tensor, banks: torch.Tensor,
               idx: torch.Tensor, t: float) -> List[torch.Tensor]:
    """Per-sample CE of each direction over its K+1 logits
    <bank[idx[b, k]], feat[b]> / t, the positive in column 0
    (CMCMem3.forward and the zero labels of `_compute_loss_accuracy`).
    Each bank's rows are gathered once for the two directions that read
    it."""
    out = [None] * len(DIRECTIONS)
    for b in range(banks.shape[0]):
        w = banks[b][idx]
        for d, (q, bank) in enumerate(DIRECTIONS):
            if bank == b:
                s = torch.bmm(w, feats[q][:, :, None])[:, :, 0] / t
                out[d] = torch.logsumexp(s, dim=1) - s[:, 0]
    return out


def masked_loss(ce: List[torch.Tensor], use_depth: torch.Tensor,
                use_rgb: torch.Tensor) -> torch.Tensor:
    """Sum of the six direction means: every direction over the samples
    that have both modalities; with none, the four that touch depth give
    0 and the RGB-skeleton pair takes the whole batch."""
    both = ((use_depth == 1) & (use_rgb == 1)).float()
    n = both.sum()
    total = 0.0
    for i, c in enumerate(ce):
        m = (c * both).sum() / n.clamp(min=1.0)
        if i >= 4:
            m = torch.where(n > 0, m, c.mean())
        total = total + m
    return total


@torch.no_grad()
def update_banks(banks: torch.Tensor, feats: torch.Tensor, y: torch.Tensor,
                 m: float) -> None:
    """row y <- normalised(m row + (1 - m) feat), every new row from the
    old bank; of duplicate indices the later sample is written last."""
    for i in range(banks.shape[0]):
        new = models.l2n(m * banks[i][y] + (1 - m) * feats[i])
        for r in range(y.shape[0]):
            banks[i, y[r]] = new[r]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def bn_statistics(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The BN running statistics, the state the step moves besides the
    parameters and the banks (clones)."""
    return {k: b.detach().clone() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def reference_steps(model: torch.nn.Module, banks: torch.Tensor,
                    batches: List[dict], cfg: dict) -> dict:
    """len(batches) steps of the reference from its current weights and
    banks (both changed in place).  Returns {'loss': [each step's loss],
    'grad': {param: norm of its first gradient}, 'change': {param: norm of
    its change}, 'state': {buffer or bank: norm of its change}}."""
    num = model.num
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    stats0 = bn_statistics(model)
    # only the rows of the batches' samples can move: the banks' change
    # is read over them, and no copy of a whole bank is kept
    rows = torch.unique(torch.cat([b["index"].long() for b in batches]))
    rows0 = banks[:, rows].clone()
    opt = torch.optim.SGD(params.values(), lr=0.0, momentum=cfg["momentum"],
                          weight_decay=cfg["weight_decay"])
    losses, grad = [], {}
    for s, batch in enumerate(batches):
        for g in opt.param_groups:
            g["lr"] = learning_rate(cfg, s)
        opt.zero_grad(set_to_none=True)
        y = batch["index"].long()
        num.update_stats = True
        feats = model(batch)
        ce = nce_losses(feats, banks, batch["neg_idx"].long(), cfg["nce_t"])
        loss = masked_loss(ce, batch["use_depth"], batch["use_rgb"])
        num.update_stats = False
        loss.backward()
        num.update_stats = True
        update_banks(banks, feats.detach(), y, cfg["nce_m"])
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if s == 0:
            grad = _norms({k: p.grad for k, p in params.items()})
        opt.step()
        losses.append(float(loss.detach()))
    change = _norms({k: p.detach() - start[k] for k, p in params.items()})
    moved = {k: v - stats0[k] for k, v in bn_statistics(model).items()}
    for i in range(banks.shape[0]):
        moved[f"bank{i}"] = banks[i, rows] - rows0[i]
    return {"loss": losses, "grad": grad, "change": change,
            "state": _norms(moved)}
