"""The contrastive pre-training step, stages 1 and 2 (counterpart of
hcmoco_tpu/train/contrast_step.py, `mem='bank'` and
`mem='bank+jointspri3d'`, `modal='RGBD2S'`).

Behavioural spec: pycontrast/learning/contrast_trainer.py
`_train_mem_skeleton3d` (:532-640, stage 1): forward the tri-modal model,
six-way NCE against three memory banks, SGD step, bank EMA update; and
`_train_bank_joints_pri3d_cmc3` (:894-1039, stage 2), which adds the dense
soft-Pri3D, joint and cross-subject (SCL) losses over the stage-2 maps at
unit weight.  One process, one device; BN statistics are those of the
whole batch, and SCL's group is the whole batch (`scl_groups` 0 or 1).

Batch dict (the JAX package's field names; tensors on the model's device):
  rgbd (B, H, W, 6) f32 NHWC | index (B,) int | skeleton (B, J, 2) f32 |
  use_depth (B,) int | use_rgb (B,) int (optional) |
  counts (B, n_data) f32 (optional, the counts form: pins the negative
  draw as how often each bank row was drawn) | neg_idx (B, K+1) int
  (optional, the index form: pins the drawn rows, the positive in column
  0)
arch 'HRNetPN' also reads (dataset.py:1105-1118):
  depth_mask (B, H, W) f32 | grid_xy (B, H, W, 2) f32 | depth_mean (B,) f32 |
  pts_u (B, pn_num_points) f32 in [0, 1) (optional: pins the depth2pts
  draw; else the step's generator draws it)
stage 2 also reads, for both archs:
  joints2d (B, J, 2) f32 full-resolution (row, col) | joints_vis (B, J) int |
  depth_mask (B, H, W) f32 | pix_idx (B, S) int (optional: pins the
  soft-Pri3D pixel draw, S = pri3d_num_samples_per_image; else the step's
  generator draws it)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..contrast.losses import (cross_subject_scl_loss, joints_pri3d_loss,
                               masked_six_way, per_sample_nce,
                               soft_pri3d_loss)
from ..contrast.memory import cmc3_forward, cmc3_losses_counts, update_memory
from ..core.config import TrainConfig
from .schedules import learning_rate_fn
from .state import TrainState

_DIRECTIONS = ("12", "21", "23", "32", "13", "31")
# torchvision's ImageNet statistics, as hcmoco_tpu/data/transforms.py
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGE2_METRICS = ("loss_rgb2depth", "loss_depth2rgb", "acc_rgb2depth",
                  "acc_depth2rgb", "loss_rgb2joint", "loss_d2joint",
                  "acc_rgb2joint", "acc_d2joint", "loss_scl")


def device_normalize(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw uint8 rgb + uint16 depth-mm -> normalised f32 rgbd on device
    (transforms.normalize_rgb + depth/1000 x3, dataset.py:139-160)."""
    if "rgb_u8" not in batch:
        return batch
    batch = dict(batch)
    rgb = batch.pop("rgb_u8").float() / 255.0
    dev = rgb.device
    rgb = ((rgb - torch.as_tensor(IMAGENET_MEAN, device=dev))
           / torch.as_tensor(IMAGENET_STD, device=dev))
    d = batch.pop("depth_mm").float() / 1000.0
    batch["rgbd"] = torch.cat([rgb, d[..., None].expand(*d.shape, 3)], dim=-1)
    return batch


def _scl_grouped(lm1: torch.Tensor, lm2: torch.Tensor,
                 joints2d: torch.Tensor, use_depth: torch.Tensor,
                 use_rgb: torch.Tensor, temperature: float,
                 groups: int) -> torch.Tensor:
    """Cross-subject SCL, averaged over `groups` equal slices of the batch
    (the reference computes it on each GPU's local batch)."""
    if groups <= 1:
        return cross_subject_scl_loss(lm1, lm2, joints2d, use_depth, use_rgb,
                                      temperature)
    if lm1.shape[0] % groups:
        raise ValueError(f"scl_groups={groups} does not divide the batch of "
                         f"{lm1.shape[0]}")
    parts = zip(*(x.chunk(groups) for x in (lm1, lm2, joints2d, use_depth,
                                            use_rgb)))
    return torch.stack([cross_subject_scl_loss(*p, temperature)
                        for p in parts]).mean()


def nce_mode(cfg: TrainConfig, n_data: int, pinned_idx: bool) -> str:
    """The bank NCE's formulation for a step (the JAX step's choice,
    hcmoco_tpu/train/contrast_step.py:206-223): cfg.bank_logits ('dense'
    if cfg.dense_scores); any mode but 'gather' builds (bsz, n_data)
    intermediates, so above counts_max_n_data the step takes 'gather';
    a pinned index draw (`neg_idx`) turns 'counts' into 'dense'."""
    mode = "dense" if cfg.dense_scores else cfg.bank_logits
    if mode not in ("counts", "dense", "hybrid", "gather"):
        raise ValueError(f"bank_logits: unknown mode {mode!r}")
    if mode != "gather" and n_data > cfg.counts_max_n_data:
        mode = "gather"
    if mode == "counts" and pinned_idx:
        mode = "dense"
    return mode


def _split(batch: Dict[str, torch.Tensor], n: int):
    """n equal microbatches of a batch dict, along dim 0."""
    bsz = batch["index"].shape[0]
    if bsz % n:
        raise ValueError(f"microbatch={n} does not divide the batch of "
                         f"{bsz}")
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero grad for every parameter that the loss did not reach, so
    that SGD still decays it and runs its momentum, as the JAX package's
    optax chain (add_decayed_weights -> trace) does for every leaf."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_contrast_loss_fn(cfg: TrainConfig, model: torch.nn.Module
                          ) -> Callable[..., tuple]:
    """Build loss_fn(state, batch, generator=None) -> (loss, metrics,
    commit): one forward of the train step, with commit() the bank EMA
    update, to be called after the loss's backward (its graph holds the
    banks as they were).  Metrics are 0-d tensors, detached."""
    if (cfg.modal != "RGBD2S" or cfg.mem not in ("bank", "bank+jointspri3d")
            or cfg.arch not in ("HRNet", "HRNetPN")):
        raise NotImplementedError(
            f"train step for modal={cfg.modal} mem={cfg.mem} arch={cfg.arch}"
            " is not ported yet: ROADMAP.md Queue 1 item 11")
    stage2 = cfg.mem == "bank+jointspri3d"
    if stage2 and not cfg.linear_feat_map:
        raise ValueError("mem='bank+jointspri3d' needs linear_feat_map: its "
                         "losses read the linear_merge maps")
    scl_groups = max(cfg.scl_groups, 1)  # 0: one group a process
    if cfg.remat or cfg.pn_remat:
        raise NotImplementedError(
            "remat and pn_remat are not ported: ROADMAP.md Queue 1 item 15")

    def loss_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> tuple:
        batch = device_normalize(batch)
        model.train()
        y = batch["index"].long()
        # NHWC -> NCHW: a view, channels_last in memory
        rgbd = batch["rgbd"].permute(0, 3, 1, 2)
        if cfg.arch == "HRNetPN":
            # the point-cloud branch needs the crop-tracked pixel coords
            # and the per-sample depth mean (_train_mem_skeleton3d
            # :557-561)
            out = model(rgbd, batch["skeleton"], batch["depth_mask"],
                        batch["grid_xy"], cfg.pn_ori_h, cfg.pn_ori_w,
                        batch["depth_mean"], generator=generator,
                        u=batch.get("pts_u"), return_fm=stage2)
        else:
            out = model(rgbd, batch["skeleton"], return_fm=stage2)
        feats = torch.stack([out["feat1"], out["feat2"], out["feat3"]])
        use_depth = batch.get("use_depth") if cfg.modality_missing else None
        # stage 2 masks the six directions by use_depth only
        use_rgb = None if stage2 else batch.get("use_rgb")
        mode = nce_mode(cfg, state.banks.shape[1], "neg_idx" in batch)
        if mode == "counts":
            per_sample = cmc3_losses_counts(
                feats, state.banks, y, k=cfg.nce_k, temperature=cfg.nce_t,
                counts=batch.get("counts"), generator=generator)

            def commit() -> None:
                for i in range(state.banks.shape[0]):
                    update_memory(state.banks[i], feats[i], y, cfg.nce_m)
        else:
            if "counts" in batch:
                raise ValueError(f"NCE mode {mode!r} draws indices: pin them "
                                 "with neg_idx, not counts")
            logits, commit = cmc3_forward(
                state.banks, feats, y, feats, y, k=cfg.nce_k,
                temperature=cfg.nce_t, m=cfg.nce_m, generator=generator,
                neg_idx=batch.get("neg_idx"), mode=mode)
            per_sample = [per_sample_nce(lg) for lg in logits]
        losses, accs = masked_six_way(per_sample, use_depth=use_depth,
                                      use_rgb=use_rgb)
        loss = torch.stack(losses).sum()
        metrics: Dict[str, torch.Tensor] = {}
        if stage2:
            lm1, lm2 = out["linear_merge1"], out["linear_merge2"]
            sp_losses, sp_accs = soft_pri3d_loss(
                lm1, lm2, batch["depth_mask"],
                cfg.pri3d_num_samples_per_image, cfg.temperature,
                use_depth=use_depth, sample_ind=batch.get("pix_idx"),
                generator=generator)
            j_losses, j_accs = joints_pri3d_loss(
                lm1, lm2, out["fm3"], batch["joints2d"], batch["joints_vis"],
                cfg.temperature, use_depth=use_depth)
            ones = torch.ones_like(y)
            scl = _scl_grouped(
                lm1, lm2, batch["joints2d"],
                ones if use_depth is None else use_depth,
                ones if batch.get("use_rgb") is None else batch["use_rgb"],
                cfg.temperature, scl_groups)
            # unit weights (contrast_trainer.py:980)
            loss = loss + sum(sp_losses) + sum(j_losses) + scl
            values = (*sp_losses, *sp_accs, *j_losses, *j_accs, scl)
            metrics.update({k: v.detach()
                            for k, v in zip(STAGE2_METRICS, values)})
        for name, l, a in zip(_DIRECTIONS, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics, commit

    return loss_fn


def make_contrast_train_step(cfg: TrainConfig, model: torch.nn.Module,
                             steps_per_epoch: int
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build step(state, batch, generator=None) -> metrics.

    The step updates `state` in place (params, optimizer, banks, step).
    `generator` draws, in this order: for HRNetPN the depth2pts uniforms
    unless the batch carries `pts_u`, the negatives unless it carries
    `counts` (the counts form) or `neg_idx` (the index form), and in
    stage 2 the soft-Pri3D pixels unless it carries `pix_idx`.
    The NCE's formulation is `nce_mode`'s.
    cfg.microbatch = n > 1 runs n forward/backward passes of batch/n
    samples against the same parameters (train_step_microbatch of the JAX
    package): the grads are averaged over n, BN running statistics and
    the banks chain through the microbatches (each sees the previous
    one's update), one optimizer step at the end, and each metric is the
    mean over the microbatches.
    Metrics: nce_loss_*/nce_acc_* for the six directions, loss and
    learning_rate, and in stage 2 STAGE2_METRICS, as 0-d tensors
    (learning_rate a float)."""
    loss_fn = make_contrast_loss_fn(cfg, model)
    n_micro = max(cfg.microbatch, 1)
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        parts = [batch] if n_micro == 1 else _split(batch, n_micro)
        lr = lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        per_part = []
        for part in parts:
            loss, metrics, commit = loss_fn(state, part, generator)
            (loss / n_micro if n_micro > 1 else loss).backward()
            commit()
            per_part.append(metrics)
        fill_missing_grads(state.optimizer)
        state.optimizer.step()
        state.step += 1
        if n_micro == 1:
            metrics = per_part[0]
        else:
            metrics = {k: torch.stack([m[k] for m in per_part]).mean()
                       for k in per_part[0]}
        metrics["learning_rate"] = lr
        return metrics

    return train_step
