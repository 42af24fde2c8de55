"""The stage-1 contrastive pre-training step (counterpart of
hcmoco_tpu/train/contrast_step.py, `mem='bank'`, `modal='RGBD2S'`).

Behavioural spec: pycontrast/learning/contrast_trainer.py
`_train_mem_skeleton3d` (:532-640): forward the tri-modal model, six-way
NCE against three memory banks, SGD step, bank EMA update.  One process,
one device; BN statistics are those of the whole batch.

Batch dict (the JAX package's field names; tensors on the model's device):
  rgbd (B, H, W, 6) f32 NHWC | index (B,) int | skeleton (B, J, 2) f32 |
  use_depth (B,) int | use_rgb (B,) int (optional) |
  counts (B, n_data) f32 (optional: pins the negative draw; how often each
  bank row was drawn as a negative)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..contrast.losses import masked_six_way
from ..contrast.memory import cmc3_losses_counts, update_memory
from ..core.config import TrainConfig
from .schedules import learning_rate_fn
from .state import TrainState

_DIRECTIONS = ("12", "21", "23", "32", "13", "31")
# torchvision's ImageNet statistics, as hcmoco_tpu/data/transforms.py
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def make_contrast_train_step(cfg: TrainConfig, model: torch.nn.Module,
                             steps_per_epoch: int
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build step(state, batch, generator=None) -> metrics for stage 1.

    The step updates `state` in place (params, optimizer, banks, step).
    `generator` draws the negatives unless the batch carries `counts`.
    Metrics: nce_loss_*/nce_acc_* for the six directions, loss and
    learning_rate, as 0-d tensors (learning_rate a float)."""
    if cfg.modal != "RGBD2S" or cfg.mem != "bank" or cfg.arch != "HRNet":
        raise NotImplementedError(
            f"train step for modal={cfg.modal} mem={cfg.mem} arch={cfg.arch}"
            " is not ported yet: ROADMAP.md Queue 1 items 7, 8 and 11")
    if cfg.remat or cfg.microbatch > 1:
        raise NotImplementedError(
            "remat and microbatch are not ported yet: ROADMAP.md Queue 1 "
            "items 9 and 15")
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
        out = model(batch["rgbd"].permute(0, 3, 1, 2), batch["skeleton"])
        feats = torch.stack([out["feat1"], out["feat2"], out["feat3"]])
        per_sample = cmc3_losses_counts(
            feats, state.banks, y, k=cfg.nce_k, temperature=cfg.nce_t,
            counts=batch.get("counts"), generator=generator)
        use_depth = batch.get("use_depth") if cfg.modality_missing else None
        losses, accs = masked_six_way(per_sample, use_depth=use_depth,
                                      use_rgb=batch.get("use_rgb"))
        loss = torch.stack(losses).sum()

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

        metrics: Dict[str, torch.Tensor] = {}
        for name, l, a in zip(_DIRECTIONS, losses, accs):
            metrics[f"nce_loss_{name}"] = l.detach()
            metrics[f"nce_acc_{name}"] = a.detach()
        metrics["loss"] = loss.detach()
        metrics["learning_rate"] = lr
        return metrics

    return train_step
