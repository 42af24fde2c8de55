"""Model assembly (counterpart of hcmoco_tpu/models/build.py).

`build_model` dispatches to HCMoCoModel (modal 'RGBD2S', arch 'HRNet',
below), HCMoCoPNModel (arch 'HRNetPN', models/pointnet2_model.py), and
the baselines' ResNet models (modal 'RGB': SingleModalModel; 'CMC':
CMCDualModel, or CMCSharedModel for an arch '<resnet>cmc').  The flagship
tri-modal model, the reference's CMC3HRNetSGCNSingleHead
(build_backbone.py:186-303): HRNet(RGB) + HRNet(depth copied to 3
channels) + SemGCN, each globally pooled and projected to an L2-normalised
128-d feature.  Keys match tests/golden/hcmoco_w18_torch_keys.txt.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import HRNET_CONFIGS, TrainConfig
from ..train.remat import region
from .heads import JigsawHead, ProjectionHead, linear_1x1
from .hrnet import HRNet, merge_all_res, pool_maps
from .pointnet2_model import HCMoCoPNModel
from .resnet import make_cmc_resnet, make_resnet
from .sgcn import SemGCN

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class HCMoCoModel(nn.Module):
    """rgbd (B, 6, H, W) + skeleton (B, J, 2) -> dict of pooled1..3 and
    feat1..3.

    return_fm (stage 2) adds the encoders' maps: fm1 and fm2 (HRNet's four
    NCHW maps each) and fm3 (SemGCN's (B, J, 128) joint features).  With
    linear_feat_map also merge1/merge2 (`merge_all_res`, 270 channels at
    W18, stride 4) and linear_merge1/linear_merge2, their 1x1 heads
    encoder{1,2}_linear run in the compute dtype, as (B, 128, H/4, W/4)
    f32.  Under train/remat.py's `recompute`, SemGCN and the heads are
    regions recomputed in the backward, as the encoders' blocks are."""

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
        self.linear_feat_map = linear_feat_map
        self.dtype = dtype
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

    def forward(self, rgbd: torch.Tensor, skeleton: torch.Tensor,
                return_fm: bool = False) -> Dict[str, torch.Tensor]:
        c1, c2 = self.in_channel_list
        fm1 = self.encoder1(rgbd[:, :c1])
        fm2 = self.encoder2(rgbd[:, c1:c1 + c2])
        fj = region(self.encoder3, skeleton)
        out = region(self._heads, return_fm, len(fm1), *fm1, *fm2, fj)
        if return_fm:
            out.update(fm1=fm1, fm2=fm2, fm3=fj)
        return out

    def _heads(self, return_fm: bool, n: int, *maps: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """The pooled features and their heads, and with return_fm and
        linear_feat_map the merges; maps: fm1's n maps, fm2's, then fj."""
        fm1, fm2, fj = list(maps[:n]), list(maps[n:2 * n]), maps[-1]
        out = {
            "pooled1": pool_maps(fm1, self.pool_method),
            "pooled2": pool_maps(fm2, self.pool_method),
            "pooled3": fj.float().mean(dim=1),
        }
        out["feat1"] = self.head1(out["pooled1"])
        out["feat2"] = self.head2(out["pooled2"])
        out["feat3"] = self.head3(out["pooled3"])
        if return_fm and self.linear_feat_map:
            out["merge1"] = merge_all_res(fm1)
            out["merge2"] = merge_all_res(fm2)
            out["linear_merge1"] = linear_1x1(
                self.encoder1_linear, out["merge1"], self.dtype)
            out["linear_merge2"] = linear_1x1(
                self.encoder2_linear, out["merge2"], self.dtype)
        return out


class SingleModalModel(nn.Module):
    """RGBSingleHead / RGBMultiHeads (build_backbone.py:14-83): a ResNet
    `encoder`, a projection `head`, and with jigsaw PIRL's `head_jig` over
    the patch stack, which runs through the same encoder (its BN sees the
    patches as a batch of their own).  Keys match
    tests/golden/rgb_moco_torch_keys.txt.  Input NCHW."""

    def __init__(self, arch: str = "resnet50", feat_dim: int = 128,
                 head: str = "linear", in_channel: int = 3,
                 jigsaw: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = make_resnet(arch, in_channel, dtype)
        dim = self.encoder.out_channels
        self.head = ProjectionHead(dim, feat_dim, head)
        self.head_jig = (JigsawHead(dim, feat_dim, 9, head) if jigsaw
                         else None)

    def forward(self, x: torch.Tensor, project: bool = True,
                x_jig: Optional[torch.Tensor] = None,
                shuffle_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x (B, C, H, W); x_jig (B*9, C, h, w) patches with their
        shuffle_ids (JigsawHead).  -> pooled, feat, feat_jig."""
        out = {"pooled": self.encoder(x)}
        if project:
            out["feat"] = self.head(out["pooled"])
        if self.head_jig is not None and x_jig is not None:
            out["feat_jig"] = self.head_jig(self.encoder(x_jig), shuffle_ids)
        return out


class CMCDualModel(nn.Module):
    """CMCSingleHead / CMCMultiHeads (build_backbone.py:85-184): the input
    split on channels, its first in_channel_list[0] to `encoder1` and the
    rest to `encoder2`, two ResNets, `head1`/`head2`, and with jigsaw the
    patch stack through the same encoders, split alike, into
    `head1_jig`/`head2_jig`.  Input NCHW."""

    def __init__(self, arch: str = "resnet50", feat_dim: int = 128,
                 head: str = "linear",
                 in_channel_list: Tuple[int, ...] = (1, 2),
                 jigsaw: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.c1 = in_channel_list[0]
        self.encoder1 = make_resnet(arch, in_channel_list[0], dtype)
        self.encoder2 = make_resnet(arch, in_channel_list[1], dtype)
        dim = self.encoder1.out_channels
        self.head1 = ProjectionHead(dim, feat_dim, head)
        self.head2 = ProjectionHead(dim, feat_dim, head)
        self.head1_jig = self.head2_jig = None
        if jigsaw:
            self.head1_jig = JigsawHead(dim, feat_dim, 9, head)
            self.head2_jig = JigsawHead(dim, feat_dim, 9, head)

    def forward(self, x: torch.Tensor, project: bool = True,
                x_jig: Optional[torch.Tensor] = None,
                shuffle_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        c1 = self.c1
        out = {"pooled1": self.encoder1(x[:, :c1]),
               "pooled2": self.encoder2(x[:, c1:])}
        if project:
            out["feat1"] = self.head1(out["pooled1"])
            out["feat2"] = self.head2(out["pooled2"])
        if self.head1_jig is not None and x_jig is not None:
            out["feat1_jig"] = self.head1_jig(self.encoder1(x_jig[:, :c1]),
                                              shuffle_ids)
            out["feat2_jig"] = self.head2_jig(self.encoder2(x_jig[:, c1:]),
                                              shuffle_ids)
        return out


class CMCSharedModel(nn.Module):
    """The legacy shared-trunk CMC model, arch '<resnet>cmc': one
    CMCResNet `encoder` whose pooled halves (L, ab) go to `head1`/`head2`.
    The reference ships the trunk unwired (resnet_cmc.py:234-238); it has
    no jigsaw.  Input NCHW, 3 channels (L, a, b)."""

    def __init__(self, arch: str = "resnet50", feat_dim: int = 128,
                 head: str = "linear", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder = make_cmc_resnet(arch, dtype)
        dim = self.encoder.out_channels // 2
        self.head1 = ProjectionHead(dim, feat_dim, head)
        self.head2 = ProjectionHead(dim, feat_dim, head)

    def forward(self, x: torch.Tensor, project: bool = True,
                x_jig: Optional[torch.Tensor] = None,
                shuffle_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        p1, p2 = self.encoder(x)
        out = {"pooled1": p1, "pooled2": p2}
        if project:
            out["feat1"] = self.head1(p1)
            out["feat2"] = self.head2(p2)
        return out


def build_model(cfg: TrainConfig, device="cuda") -> nn.Module:
    """Registry dispatch on modal + arch (build_backbone.py:516-546); the
    model's parameters are created on `device`: the card unless the
    caller asks for another device, as the CPU tests do."""
    device = torch.device(device)
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
        model = HCMoCoPNModel(
            width=cfg.width,
            feat_dim=cfg.feat_dim,
            head=cfg.head,
            linear_feat_map=cfg.linear_feat_map,
            pool_method=cfg.pool_method,
            skeleton_meta=cfg.skeleton_meta_name,
            n_points=cfg.pn_num_points,
            pn_remat=cfg.pn_remat,
            dtype=dtype,
        )
        return model.to(device)
    if cfg.modal == "CMC" and cfg.arch.endswith("cmc"):
        if cfg.jigsaw:
            raise NotImplementedError(
                "jigsaw/PIRL is not defined for the legacy shared-trunk CMC "
                "ResNet (resnet_cmc.py has no jigsaw integration); use the "
                "dual-encoder CMC archs")
        model = CMCSharedModel(arch=cfg.arch[:-3], feat_dim=cfg.feat_dim,
                               head=cfg.head, dtype=dtype)
    elif cfg.modal == "CMC":
        model = CMCDualModel(arch=cfg.arch, feat_dim=cfg.feat_dim,
                             head=cfg.head,
                             in_channel_list=tuple(cfg.in_channel_list),
                             jigsaw=cfg.jigsaw, dtype=dtype)
    elif cfg.modal == "RGB":
        model = SingleModalModel(arch=cfg.arch, feat_dim=cfg.feat_dim,
                                 head=cfg.head, jigsaw=cfg.jigsaw,
                                 dtype=dtype)
    else:
        raise NotImplementedError(f"modal {cfg.modal} arch {cfg.arch}")
    return model.to(device)
