"""Versatility training: joint contrastive + cross-modal supervised
segmentation, and the per-modality mIoU validator (counterpart of
hcmoco_tpu/train/segment_step.py).

Behavioural spec: pycontrast/learning/segment_trainer.py
`train_soft_joint_pri3d` (:617-824): the stage-2 losses weighted by
cmc_loss_weights (the six-way NCE) and other_loss_weights (soft-Pri3D,
joints, SCL), plus an FCN head on the L2-normalised linear_merge maps,
`supervise_type` picking the supervised modality (0: the elementwise max
of rgb and depth, 1: rgb, 2: depth, 3: none), its class-weighted CE
(ignore 255) on the labelled frames scaled x10 (:747); and `validate`
(:826-934): three heads (rgb / d / rgbd) with per-class IoU and accuracy
from intersection / union counts summed over the validation set.

The six NCE directions are masked by both use_depth and use_rgb (the
stage-2 pre-training step masks by use_depth only).  The NCE takes the
JAX package's formulation here, the index form in 'dense' mode
(contrast/memory.py::cmc3_forward with mode None).

Batch dict (tensors on the model's device): the stage-2 fields (rgbd,
index, skeleton, use_depth, use_rgb, depth_mask, joints2d, joints_vis),
label (B, H, W) int (255 = ignore) and true_label (B,) int (1 = a labelled
frame); optional neg_idx (B, K+1) and pix_idx (B, S) pin the draws.
NTU-RGBD-Parsing-4K class weights from main_segmentor.py:76-79.

Under data parallelism the step is the global one, as the pre-training
step's (train/contrast_step.py): the classifier's masked BN, the
segmentation CE's weight sum and its labelled-frame gate are global too,
and the validator's counts are summed over the ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..contrast.losses import (joints_pri3d_loss, masked_six_way,
                               per_sample_nce, soft_pri3d_loss)
from ..contrast.memory import cmc3_forward
from ..core.config import TrainConfig
from ..parallel.mesh import gather_rows, global_sum
from .contrast_step import (_DIRECTIONS, _scl_grouped, device_normalize,
                            fill_missing_grads, global_metrics, sync_grads)
from .schedules import learning_rate_fn
from .state import TrainState

# main_segmentor.py:76-79
NTU_SEG_CLASS_WEIGHTS = (
    1.448, 49.234, 49.483, 48.030, 49.247, 49.492, 48.018, 49.704, 50.052,
    49.369, 49.694, 50.090, 49.425, 49.459, 45.846, 47.156, 45.868, 47.197,
    44.167, 42.789, 44.341, 48.632, 48.873, 48.644, 49.004)
SEG_HEADS = ("rgb", "d", "rgbd")
SUPERVISED_HEAD = {0: "rgbd", 1: "rgb", 2: "d", 3: None}
TEST_HEAD = {0: "rgbd", 1: "rgb", 2: "d"}
SEGMENT_METRICS = ("loss_rgb2depth", "loss_depth2rgb", "loss_rgb2joint",
                   "loss_d2joint", "loss_scl")


def _l2norm_channels(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise the channels (dim 1) of an NCHW map."""
    n = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def weighted_seg_ce(logits: torch.Tensor, labels: torch.Tensor,
                    class_weights: torch.Tensor,
                    sample_mask: Optional[torch.Tensor] = None,
                    ignore_index: int = 255) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=w, ignore_index=255) of (B, C, H, W)
    logits: sum(w[t] * ce) / sum(w[t]) over the pixels that are not
    ignored (and, with sample_mask, of the kept frames); 0 when none.
    The weight sum is the global batch's (this rank's share of the CE)."""
    labels = labels.long()
    valid = labels != ignore_index
    if sample_mask is not None:
        valid = valid & (sample_mask[:, None, None] > 0)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=1)
    ce = -logp.gather(1, safe[:, None])[:, 0]
    w = class_weights[safe] * valid.float()
    return torch.sum(ce * w) / torch.clamp(global_sum(torch.sum(w)),
                                           min=1e-12)


def seg_logits(classifier: torch.nn.Module, lm1: torch.Tensor,
               lm2: torch.Tensor, mode: str,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FCN head on the channel-normalised linear_merge maps
    (segment_trainer.py:723-744, :908-920); mode 'rgbd' (their max),
    'rgb' or 'd'.  sample_mask: the frames whose training BN statistics
    count (the reference classifies the labelled frames alone)."""
    n1, n2 = _l2norm_channels(lm1), _l2norm_channels(lm2)
    feats = {"rgbd": torch.maximum(n1, n2), "rgb": n1, "d": n2}[mode]
    return classifier(feats, sample_mask)


def make_segment_train_step(cfg: TrainConfig, model: torch.nn.Module,
                            classifier: torch.nn.Module,
                            steps_per_epoch: int
                            ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build step(state, batch, generator=None) -> metrics for the
    versatility segmentor.  The step updates `state` in place (model and
    classifier params under one optimizer, BN statistics, banks, step);
    `generator` draws the negatives unless the batch carries `neg_idx`,
    then the soft-Pri3D pixels unless it carries `pix_idx`.  A parameter
    the loss does not reach (the classifier's, with supervise_type 3)
    still decays and runs its momentum, as in the JAX package.
    Metrics: loss, SEGMENT_METRICS, nce_loss_* / nce_acc_*, loss_seg when
    a head is supervised, as 0-d tensors; learning_rate a float."""
    if cfg.mem != "bank+jointspri3d" or not cfg.linear_feat_map \
            or cfg.arch != "HRNet":
        raise ValueError("the versatility segmentor is the HRNet stage-2 "
                         "model: mem='bank+jointspri3d', linear_feat_map")
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)
    sup_mode = SUPERVISED_HEAD[cfg.supervise_type]
    class_weights = torch.tensor(NTU_SEG_CLASS_WEIGHTS[:cfg.n_class],
                                 dtype=torch.float32,
                                 device=next(classifier.parameters()).device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        batch = device_normalize(batch)
        model.train()
        classifier.train()
        y = batch["index"].long()
        use_depth, use_rgb = batch["use_depth"], batch["use_rgb"]
        out = model(batch["rgbd"].permute(0, 3, 1, 2), batch["skeleton"],
                    return_fm=True)
        feats = torch.stack([out["feat1"], out["feat2"], out["feat3"]])
        logits, commit = cmc3_forward(
            state.banks, feats, y,
            gather_rows(feats.transpose(0, 1)).transpose(0, 1),
            gather_rows(y), k=cfg.nce_k,
            temperature=cfg.nce_t, m=cfg.nce_m, generator=generator,
            neg_idx=batch.get("neg_idx"))
        losses, accs = masked_six_way([per_sample_nce(lg) for lg in logits],
                                      use_depth=use_depth, use_rgb=use_rgb)
        lm1, lm2 = out["linear_merge1"], out["linear_merge2"]
        sp_losses, _ = soft_pri3d_loss(
            lm1, lm2, batch["depth_mask"], cfg.pri3d_num_samples_per_image,
            cfg.temperature, use_depth=use_depth,
            sample_ind=batch.get("pix_idx"), generator=generator)
        j_losses, _ = joints_pri3d_loss(
            lm1, lm2, out["fm3"], batch["joints2d"], batch["joints_vis"],
            cfg.temperature, use_depth=use_depth)
        scl = _scl_grouped(lm1, lm2, batch["joints2d"], use_depth, use_rgb,
                           cfg.temperature, cfg.scl_groups)
        loss = (sum(losses) * cfg.cmc_loss_weights
                + (sum(sp_losses) + sum(j_losses) + scl)
                * cfg.other_loss_weights)
        metrics: Dict[str, torch.Tensor] = {}
        if sup_mode is not None:
            true_label = batch["true_label"]
            seg = seg_logits(classifier, lm1, lm2, sup_mode,
                             sample_mask=true_label)
            loss_seg = weighted_seg_ce(seg, batch["label"], class_weights,
                                       sample_mask=true_label)
            # zero when the batch has no labelled frame (:750-752)
            loss_seg = torch.where(global_sum(true_label.sum()) > 0, loss_seg,
                                   torch.zeros_like(loss_seg))
            loss = loss + loss_seg * 10.0
            metrics["loss_seg"] = loss_seg.detach()

        lr = lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        commit()
        fill_missing_grads(state.optimizer)
        sync_grads(state.optimizer)
        state.optimizer.step()
        state.step += 1

        values = (*sp_losses, *j_losses, scl)
        metrics.update({k: v.detach() for k, v in zip(SEGMENT_METRICS,
                                                      values)})
        for name, l, a in zip(_DIRECTIONS, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        metrics = global_metrics(metrics)
        metrics["learning_rate"] = lr
        return metrics

    return train_step


# ---------------------------------------------------------------------------
# validation


def seg_counts(pred: torch.Tensor, label: torch.Tensor, n_class: int,
               ignore_index: int = 255) -> Tuple[torch.Tensor, ...]:
    """(intersect, union, pred_area, label_area), each (n_class,) int64,
    of one batch (intersection_and_union, segment_trainer.py:334-345);
    torch.bincount on the tensors' device."""
    label = label.long()
    valid = label != ignore_index
    pred = torch.where(valid, pred.long(), n_class)  # ignored: out of range
    label = torch.where(valid, label, n_class)
    inter = torch.where(pred == label, pred, n_class)

    def hist(x):
        return torch.bincount(x.reshape(-1), minlength=n_class + 1)[:n_class]

    ai, ap, al = hist(inter), hist(pred), hist(label)
    return ai, ap + al - ai, ap, al


def calc_seg_metrics(intersect: torch.Tensor, union: torch.Tensor,
                     pred_area: torch.Tensor, label_area: torch.Tensor):
    """(aacc, miou, macc, iou, acc), NaN taken as 0 (calc_metrics
    :366-375), in the counts' dtype (float64 as the validator sums)."""
    aacc = intersect.sum() / torch.clamp(label_area.sum(), min=1e-12)
    iou = torch.where(union > 0,
                      intersect / torch.clamp(union, min=1e-12),
                      torch.zeros_like(intersect))
    acc = torch.where(label_area > 0,
                      intersect / torch.clamp(label_area, min=1e-12),
                      torch.zeros_like(intersect))
    return aacc, iou.mean(), acc.mean(), iou, acc


def make_validate_fn(cfg: TrainConfig, model: torch.nn.Module,
                     classifier: torch.nn.Module
                     ) -> Callable[[Dict[str, torch.Tensor]], List[tuple]]:
    """eval_batch(batch) -> [seg_counts of the rgb, d and rgbd heads]: one
    forward with model and classifier in eval mode (running BN
    statistics; the fused ConvBN path is a training path and is not
    reached), which are put back in the mode they were in.  The caller
    sums the counts over batches, in float64 on the host."""

    @torch.no_grad()
    def eval_batch(batch: Dict[str, torch.Tensor]) -> List[tuple]:
        batch = device_normalize(batch)
        modes = (model.training, classifier.training)
        model.eval()
        classifier.eval()
        try:
            out = model(batch["rgbd"].permute(0, 3, 1, 2),
                        batch["skeleton"], return_fm=True)
            counts = []
            for mode in SEG_HEADS:
                logits = seg_logits(classifier, out["linear_merge1"],
                                    out["linear_merge2"], mode)
                counts.append(seg_counts(logits.argmax(dim=1),
                                         batch["label"], cfg.n_class))
        finally:
            model.train(modes[0])
            classifier.train(modes[1])
        return counts

    return eval_batch
