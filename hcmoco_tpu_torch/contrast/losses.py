"""HCMoCo NCE masking (counterpart of hcmoco_tpu/contrast/losses.py,
stage-1 part).

Behavioural spec: `_compute_loss_accuracy` (contrast_trainer.py:212-253).
The reference's data-dependent early returns become masked means with
clamped denominators, as in the JAX package, so the step never syncs with
the host on the masks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean of x over rows where mask, 0 if the mask is empty."""
    mask = mask.float()
    total = mask.sum()
    return torch.sum(x * mask) / torch.clamp(total, min=1.0) \
        * torch.sign(total)


def per_sample_nce(logits: torch.Tensor):
    """Per-sample CE-to-class-0 and top-1 indicator of (bsz, K+1) logits
    (the positive in column 0 wins ties, as torch argmax does)."""
    logits = logits.float()
    ce = torch.logsumexp(logits, dim=-1) - logits[:, 0]
    correct = (logits.argmax(dim=-1) == 0).float()
    return ce, correct


def masked_six_way(per_sample: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   use_depth: Optional[torch.Tensor] = None,
                   use_rgb: Optional[torch.Tensor] = None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Modality masking over six per-sample (ce, correct) pairs, order
    (12, 21, 23, 32, 13, 31).

    use_depth only: the four pairs touching depth are restricted to depth
    rows, the rgb<->skeleton pairs are not.  Both masks: all six are
    restricted to rows with both modalities; when there is none, the first
    four are 0 and the last two fall back to the whole batch."""
    losses, accs = [], []
    if use_rgb is not None:
        if use_depth is None:
            raise ValueError("masked_six_way: use_rgb needs use_depth")
        together = (use_depth == 1) & (use_rgb == 1)
        any_together = together.sum() > 0
        for i, (ce, cor) in enumerate(per_sample):
            loss, acc = _masked_mean(ce, together), _masked_mean(cor, together)
            if i >= 4:
                loss = torch.where(any_together, loss, ce.mean())
                acc = torch.where(any_together, acc, cor.mean())
            losses.append(loss)
            accs.append(acc)
    elif use_depth is not None:
        depth_ok = use_depth == 1
        for i, (ce, cor) in enumerate(per_sample):
            if i <= 3:
                losses.append(_masked_mean(ce, depth_ok))
                accs.append(_masked_mean(cor, depth_ok))
            else:
                losses.append(ce.mean())
                accs.append(cor.mean())
    else:
        for ce, cor in per_sample:
            losses.append(ce.mean())
            accs.append(cor.mean())
    return losses, accs
