"""Segmentation criteria, the poly LR and the confusion-matrix metrics
(counterpart of hcmoco_tpu/downstream/seg/criterion.py).

Behavioral spec: `HRNet-Semantic-Segmentation/lib/core/criterion.py` —
`CrossEntropy` (:11-27, logits bilinearly upsampled to the label size,
class-weighted CE with ignore_index) and `OhemCrossEntropy` (:29-57,
hard-pixel mining: keep pixels whose predicted target-class prob is below
max(threshold, prob of the min_kept-th hardest pixel)).

Logits are NCHW; labels (B, H, W) integers.  The upsampling is bilinear
with half-pixel centres (`align_corners=False`), in f32, as the JAX
package's jax.image.resize upsamples.  OHEM selects its threshold with
`torch.kthvalue` over the target-class probabilities, the JAX package's
top_k selection (ignored pixels at +inf, never selected).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _upsample_logits(logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if logits.shape[2] == h and logits.shape[3] == w:
        return logits
    return F.interpolate(logits.float(), size=(h, w), mode="bilinear",
                         align_corners=False)


def _target_logp(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_label: int):
    """(log p of each pixel's label (B, H, W), valid mask, safe labels)
    over the logits upsampled to the label size."""
    logits = _upsample_logits(logits, labels.shape[1], labels.shape[2])
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=1)
    return logp.gather(1, safe[:, None])[:, 0], valid, safe


def cross_entropy_seg(logits: torch.Tensor, labels: torch.Tensor,
                      class_weights: Optional[torch.Tensor] = None,
                      ignore_label: int = 255) -> torch.Tensor:
    """Class-weighted mean CE over the pixels not `ignore_label`."""
    lp, valid, safe = _target_logp(logits, labels, ignore_label)
    w = valid.float()
    if class_weights is not None:
        w = class_weights[safe] * w
    return torch.sum(-lp * w) / torch.clamp(w.sum(), min=1e-12)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       ignore_label: int = 255, thres: float = 0.7,
                       min_kept: int = 100000) -> torch.Tensor:
    """Mean class-weighted CE over the valid pixels whose label's
    probability is below max(thres, the (min_kept+1)-th smallest)."""
    lp, valid, safe = _target_logp(logits, labels, ignore_label)
    ce = -lp
    if class_weights is not None:
        ce = ce * class_weights[safe]
    ce, valid = ce.reshape(-1), valid.reshape(-1)
    prob = torch.where(valid, torch.exp(lp.detach()).reshape(-1),
                       torch.full_like(ce, float("inf")))
    k = min(min_kept, prob.numel() - 1)
    kth = torch.kthvalue(prob, k + 1).values
    threshold = torch.clamp(kth, min=thres)
    keep = (valid & (prob < threshold)).float()
    return torch.sum(ce * keep) / torch.clamp(keep.sum(), min=1.0)


def poly_lr(base_lr: float, cur_iter, max_iter: int,
            power: float = 0.9) -> float:
    """lib/utils/utils.py:142-146, evaluated in f32 as the JAX package
    does."""
    frac = torch.tensor(cur_iter, dtype=torch.float32) / max_iter
    return float(base_lr * (1.0 - frac) ** power)


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, n_class: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """(n_class, n_class) int64 confusion counts (utils.py:117-140
    semantics: rows = gt, cols = pred); pixels labelled `ignore_label`
    count nowhere."""
    valid = label != ignore_label
    g = torch.where(valid, label, torch.full_like(label, n_class)).long()
    p = torch.where(valid, pred.long(), torch.full_like(g, n_class))
    flat = torch.bincount((g * (n_class + 1) + p).reshape(-1),
                          minlength=(n_class + 1) ** 2)
    return flat.reshape(n_class + 1, n_class + 1)[:n_class, :n_class]


def miou_from_confusion(conf: torch.Tensor):
    """(mean IoU, per-class IoU) in f32; a class absent from both the
    labels and the predictions has IoU 0."""
    conf = conf.float()
    tp = torch.diagonal(conf)
    union = conf.sum(1) + conf.sum(0) - tp
    iou = torch.where(union > 0, tp / torch.clamp(union, min=1e-12),
                      torch.zeros_like(tp))
    return iou.mean(), iou
