"""Model assembly (counterpart of hcmoco_tpu/models/build.py).

`build_model` dispatches to HCMoCoModel (arch 'HRNet', below) or
HCMoCoPNModel (arch 'HRNetPN', models/pointnet2_model.py).  The flagship
tri-modal model, the reference's CMC3HRNetSGCNSingleHead
(build_backbone.py:186-303): HRNet(RGB) + HRNet(depth copied to 3
channels) + SemGCN, each globally pooled and projected to an L2-normalised
128-d feature.  Keys match tests/golden/hcmoco_w18_torch_keys.txt.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..core.config import HRNET_CONFIGS, TrainConfig
from ..ops.point_gather import MAX_DEST
from .heads import ProjectionHead
from .hrnet import HRNet, pool_maps
from .pointnet2_model import HCMoCoPNModel
from .sgcn import SemGCN

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
            "pooled1": pool_maps(fm1, self.pool_method),
            "pooled2": pool_maps(fm2, self.pool_method),
            "pooled3": fj.float().mean(dim=1),
        }
        out["feat1"] = self.head1(out["pooled1"])
        out["feat2"] = self.head2(out["pooled2"])
        out["feat3"] = self.head3(out["pooled3"])
        return out


def check_card_limits(cfg: TrainConfig, device="cuda") -> None:
    """Refuse a configuration that a card kernel of its path does not take,
    so that it fails here and not inside a backward.  On the card, K5's
    backward at SA0 ranks pn_num_points destinations with K56a
    (`dest_csr_cuda`), whose histograms hold at most MAX_DEST; the CPU
    path, like the JAX package, takes any pn_num_points."""
    if (torch.device(device).type == "cuda" and cfg.arch == "HRNetPN"
            and cfg.pn_num_points > MAX_DEST):
        raise ValueError(
            f"build_model: pn_num_points={cfg.pn_num_points} exceeds the "
            f"{MAX_DEST} destinations that kernel K56a (dest_csr, the "
            "destination index of the K5/K6 backwards) takes on the card; "
            "lifting that limit is ROADMAP.md Queue 2, K56a.  Use "
            f"pn_num_points <= {MAX_DEST} on the card, or device='cpu'")


def build_model(cfg: TrainConfig, device="cuda") -> nn.Module:
    """Registry dispatch on modal + arch (build_backbone.py:516-546); the
    model's parameters are created on `device`: the card unless the
    caller asks for another device, as the CPU tests do.  Raises for a
    configuration the card's kernels do not take (`check_card_limits`)."""
    device = torch.device(device)
    check_card_limits(cfg, device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device is available; pass "
                           "device='cpu' to build on the CPU")
    dtype = _DTYPES[cfg.compute_dtype]
    if cfg.modal == "RGBD2S" and cfg.arch == "HRNet":
        model = HCMoCoModel(
            width=cfg.width,
            feat_dim=cfg.feat_dim,
            head=cfg.head,
            in_channel_list=tuple(cfg.in_channel_list[:2]) or (3, 3),
            linear_feat_map=cfg.linear_feat_map,
            pool_method=cfg.pool_method,
            skeleton_meta=cfg.skeleton_meta_name,
            dtype=dtype,
        )
        return model.to(device)
    if cfg.modal == "RGBD2S" and cfg.arch == "HRNetPN":
        if cfg.pn_remat:
            raise NotImplementedError(
                "pn_remat is not ported yet: ROADMAP.md Queue 1 item 15")
        # stage 1: the linear_feat_map heads belong to the stage-2 forward
        # (return_fm), which is not ported; the JAX package creates them
        # only there
        model = HCMoCoPNModel(
            width=cfg.width,
            feat_dim=cfg.feat_dim,
            head=cfg.head,
            pool_method=cfg.pool_method,
            skeleton_meta=cfg.skeleton_meta_name,
            n_points=cfg.pn_num_points,
            dtype=dtype,
        )
        return model.to(device)
    if cfg.modal in ("CMC", "RGB"):
        raise NotImplementedError(
            f"modal {cfg.modal} is not ported yet: ROADMAP.md Queue 1 item 11")
    raise NotImplementedError(f"modal {cfg.modal} arch {cfg.arch}")
