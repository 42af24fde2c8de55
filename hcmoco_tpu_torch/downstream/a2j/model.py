"""A2J depth 3D-pose model: HRNet backbone + anchor heads (counterpart of
hcmoco_tpu/downstream/a2j/model.py).

Behavioral spec: `A2J/model.py` — `A2J_HRNet_model` (:191-236): single-
channel depth expanded to 3ch, HRNet multi-res features merged at stride 4
(merge_all_res), then three 4-conv heads (Classification / Regression /
DepthRegression, :7-144) over `num_anchors` anchors per stride-4 cell.
Parameter names are the reference's: `Backbone.*` (the HRNet names),
`classificationModel`, `regressionModel`, `DepthRegressionModel`, each
with conv1-4, bn1-4 and `output`.

Output layout: the reference permutes NCHW to (N, W, H, C) before it
flattens, so anchors are enumerated W-major, the ravel order of
anchors.shift_anchors; the heads do the same permute here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import HRNET_CONFIGS
from ...models.hrnet import HRNet, merge_all_res, stat_dtype
from ...parallel.batchnorm import GlobalBatchNorm2d
from ..seg.model import merged_channels


class AnchorHead(nn.Module):
    """4x (conv3x3 + BN + ReLU) + conv3x3 output (model.py:7-144).  The
    convs run in `dtype` with their bias, BN in f32 (flax momentum 0.9,
    torch 0.1), the output conv in f32 (the parameters' dtype)."""

    def __init__(self, in_channels: int, out_per_anchor: int,
                 num_anchors: int, num_classes: int, feature_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_per_anchor = out_per_anchor
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        self.compute_dtype = dtype
        for i in range(1, 5):
            cin = in_channels if i == 1 else feature_size
            setattr(self, f"conv{i}",
                    nn.Conv2d(cin, feature_size, 3, padding=1))
            setattr(self, f"bn{i}", GlobalBatchNorm2d(feature_size,
                                                      momentum=0.1))
        self.output = nn.Conv2d(
            feature_size, num_anchors * num_classes * out_per_anchor, 3,
            padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        for i in range(1, 5):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            x = F.conv2d(x.to(d), conv.weight.to(d), conv.bias.to(d),
                         padding=1)
            x = F.relu(bn(x.to(stat_dtype(d)))).to(d)
        w = self.output.weight
        x = F.conv2d(x.to(w.dtype), w, self.output.bias, padding=1)
        b = x.shape[0]
        # the reference flattens W-major: permute(0, 3, 2, 1) first
        x = x.permute(0, 3, 2, 1)
        if self.out_per_anchor == 1:
            return x.reshape(b, -1, self.num_classes)
        return x.reshape(b, -1, self.num_classes, 2)


class A2JHRNet(nn.Module):
    """Depth (B, H, W), (B, 1, H, W) -> (cls (B, N, P), reg (B, N, P, 2)
    [, depth (B, N, P)]), N = (H/4)(W/4) x num_anchors."""

    def __init__(self, num_classes: int = 15, num_anchors: int = 9,
                 width: int = 18, is_3d: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.is_3d = is_3d
        self.compute_dtype = dtype
        self.Backbone = HRNet(HRNET_CONFIGS[width], 3, dtype)
        c = merged_channels(width)
        self.classificationModel = AnchorHead(c, 1, num_anchors, num_classes,
                                              dtype=dtype)
        self.regressionModel = AnchorHead(c, 2, num_anchors, num_classes,
                                          dtype=dtype)
        if is_3d:
            self.DepthRegressionModel = AnchorHead(c, 1, num_anchors,
                                                   num_classes, dtype=dtype)

    def forward(self, depth: torch.Tensor):
        if depth.dim() == 3:
            depth = depth[:, None]
        x = depth.to(self.compute_dtype).expand(-1, 3, -1, -1)
        merged = merge_all_res(self.Backbone(x))
        cls = self.classificationModel(merged)
        reg = self.regressionModel(merged)
        if not self.is_3d:
            return cls, reg
        return cls, reg, self.DepthRegressionModel(merged)


class A2JResNet(nn.Module):
    """The legacy ResNet50 A2J (`A2J_model`, A2J/model.py:177-195): not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "A2JResNet (--arch resnet50) needs models/resnet.py's "
            "ResBottleneck, which is not ported yet: ROADMAP.md Queue 1 "
            "item 11")
