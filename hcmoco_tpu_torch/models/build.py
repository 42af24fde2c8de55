"""Model assembly (counterpart of hcmoco_tpu/models/build.py).

The flagship tri-modal model, the reference's CMC3HRNetSGCNSingleHead
(build_backbone.py:186-303): HRNet(RGB) + HRNet(depth copied to 3
channels) + SemGCN, each globally pooled and projected to an L2-normalised
128-d feature.  Keys match tests/golden/hcmoco_w18_torch_keys.txt.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..core.config import HRNET_CONFIGS, TrainConfig
from .heads import ProjectionHead
from .hrnet import HRNet
from .sgcn import SemGCN

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _pool(feats: Sequence[torch.Tensor], method: str) -> torch.Tensor:
    """Pool each NCHW HRNet map globally in f32 and concat (270-d at W18);
    build_backbone.py:266-281."""
    pooled = []
    for f in feats:
        f32 = f.float()
        pooled.append(f32.mean(dim=(2, 3)) if method == "mean"
                      else f32.amax(dim=(2, 3)))
    return torch.cat(pooled, dim=-1)


class HCMoCoModel(nn.Module):
    """rgbd (B, 6, H, W) + skeleton (B, J, 2) -> dict of pooled1..3 and
    feat1..3.

    With linear_feat_map the stage-2 1x1 heads encoder{1,2}_linear exist
    (so reference stage-2 checkpoints load), but the stage-2 forward that
    uses them is not ported yet (ROADMAP.md Queue 1 item 8)."""

    def __init__(self, width: int = 18, feat_dim: int = 128,
                 head: str = "linear",
                 in_channel_list: Tuple[int, ...] = (3, 3),
                 linear_feat_map: bool = False, pool_method: str = "mean",
                 skeleton_meta: str = "mpii", sgcn_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hr_cfg = HRNET_CONFIGS[width]
        self.in_channel_list = tuple(in_channel_list)
        self.pool_method = pool_method
        self.encoder1 = HRNet(hr_cfg, in_channel_list[0], dtype)
        self.encoder2 = HRNet(hr_cfg, in_channel_list[1], dtype)
        self.encoder3 = SemGCN(sgcn_dim, 4, skeleton_meta)
        total = hr_cfg.total_channels
        self.head1 = ProjectionHead(total, feat_dim, head)
        self.head2 = ProjectionHead(total, feat_dim, head)
        self.head3 = ProjectionHead(sgcn_dim, feat_dim, head)
        if linear_feat_map:
            self.encoder1_linear = nn.Conv2d(total, sgcn_dim, 1)
            self.encoder2_linear = nn.Conv2d(total, sgcn_dim, 1)

    def forward(self, rgbd: torch.Tensor,
                skeleton: torch.Tensor) -> Dict[str, torch.Tensor]:
        c1, c2 = self.in_channel_list
        fm1 = self.encoder1(rgbd[:, :c1])
        fm2 = self.encoder2(rgbd[:, c1:c1 + c2])
        fj = self.encoder3(skeleton)
        out = {
            "pooled1": _pool(fm1, self.pool_method),
            "pooled2": _pool(fm2, self.pool_method),
            "pooled3": fj.float().mean(dim=1),
        }
        out["feat1"] = self.head1(out["pooled1"])
        out["feat2"] = self.head2(out["pooled2"])
        out["feat3"] = self.head3(out["pooled3"])
        return out


def build_model(cfg: TrainConfig, device=None) -> nn.Module:
    """Registry dispatch on modal + arch (build_backbone.py:516-546); the
    model's parameters are created on `device`."""
    if cfg.modal == "RGBD2S" and cfg.arch == "HRNet":
        model = HCMoCoModel(
            width=cfg.width,
            feat_dim=cfg.feat_dim,
            head=cfg.head,
            in_channel_list=tuple(cfg.in_channel_list[:2]) or (3, 3),
            linear_feat_map=cfg.linear_feat_map,
            pool_method=cfg.pool_method,
            skeleton_meta=cfg.skeleton_meta_name,
            dtype=_DTYPES[cfg.compute_dtype],
        )
        return model.to(device)
    if cfg.modal == "RGBD2S" and cfg.arch == "HRNetPN":
        raise NotImplementedError(
            "arch HRNetPN is not ported yet: ROADMAP.md Queue 1 item 7")
    if cfg.modal in ("CMC", "RGB"):
        raise NotImplementedError(
            f"modal {cfg.modal} is not ported yet: ROADMAP.md Queue 1 item 11")
    raise NotImplementedError(f"modal {cfg.modal} arch {cfg.arch}")
