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
  counts (B, n_data) f32 (optional: pins the negative draw; how often each
  bank row was drawn as a negative)
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
                               masked_six_way, soft_pri3d_loss)
from ..contrast.memory import cmc3_losses_counts, update_memory
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


def make_contrast_train_step(cfg: TrainConfig, model: torch.nn.Module,
                             steps_per_epoch: int
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build step(state, batch, generator=None) -> metrics.

    The step updates `state` in place (params, optimizer, banks, step).
    `generator` draws, in this order: for HRNetPN the depth2pts uniforms
    unless the batch carries `pts_u`, the negatives unless it carries
    `counts`, and in stage 2 the soft-Pri3D pixels unless it carries
    `pix_idx`.
    Metrics: nce_loss_*/nce_acc_* for the six directions, loss and
    learning_rate, and in stage 2 STAGE2_METRICS, as 0-d tensors
    (learning_rate a float)."""
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
    if cfg.remat or cfg.microbatch > 1 or cfg.pn_remat:
        raise NotImplementedError(
            "remat, pn_remat and microbatch are not ported yet: ROADMAP.md "
            "Queue 1 items 9 and 15")
    lr_fn = learning_rate_fn(cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        batch = device_normalize(batch)
        if state.banks.shape[1] > cfg.counts_max_n_data:
            raise NotImplementedError(
                "n_data above counts_max_n_data needs the row-gather NCE, "
                "not ported yet")
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
        per_sample = cmc3_losses_counts(
            feats, state.banks, y, k=cfg.nce_k, temperature=cfg.nce_t,
            counts=batch.get("counts"), generator=generator)
        use_depth = batch.get("use_depth") if cfg.modality_missing else None
        use_rgb = batch.get("use_rgb")
        # stage 2 masks the six directions by use_depth only
        losses, accs = masked_six_way(per_sample, use_depth=use_depth,
                                      use_rgb=None if stage2 else use_rgb)
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
                ones if use_rgb is None else use_rgb, cfg.temperature,
                scl_groups)
            # unit weights (contrast_trainer.py:980)
            loss = loss + sum(sp_losses) + sum(j_losses) + scl
            values = (*sp_losses, *sp_accs, *j_losses, *j_accs, scl)
            metrics.update({k: v.detach()
                            for k, v in zip(STAGE2_METRICS, values)})

        lr = lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        # after backward: the loss's graph holds the old banks
        for i in range(state.banks.shape[0]):
            update_memory(state.banks[i], feats[i], y, cfg.nce_m)
        state.step += 1

        for name, l, a in zip(_DIRECTIONS, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        metrics["learning_rate"] = lr
        return metrics

    return train_step
