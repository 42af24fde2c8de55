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

`A2JResNet` is the legacy ResNet50 variant (`A2J_model`,
A2J/model.py:155-195): its backbone's names are the reference's
`Backbone.model.*` (ResNetBackBone wraps torchvision's resnet50 as
`model`: conv1, bn1, layer{s}.{b}.conv{k}/bn{k}, downsample.{0,1}),
without the classifier `fc` that the forward never reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import HRNET_CONFIGS
from ...models.hrnet import HRNet, conv_bn, merge_all_res, stat_dtype
from ...models.resnet import ResBottleneck, _bn, _max_pool
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


# (planes, blocks, stride, dilation of the non-first blocks) a stage
A2J_RESNET_STAGES = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 2, 1),
                     (512, 3, 1, 2))


class _ResNet50Trunk(nn.Module):
    """torchvision's resnet50 trunk as A2J/resnet.py builds it: 7x7 stem,
    a single max-pool, layer4 at stride 1 whose non-first blocks are
    dilated 2 (its first block is built without the dilation,
    A2J/resnet.py:142-145)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes = 64
        for stage, (planes, n, stride, dil) in enumerate(A2J_RESNET_STAGES):
            blocks = []
            for b in range(n):
                blocks.append(ResBottleneck(
                    inplanes, planes, stride if b == 0 else 1, b == 0,
                    dilation=1 if b == 0 else dil, dtype=dtype))
                inplanes = planes * ResBottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class A2JResNetBackbone(nn.Module):
    """ResNetBackBone (A2J/model.py:155-173): (x3, x4), layer3's 1024- and
    layer4's 2048-channel maps, both at stride 16."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.model = _ResNet50Trunk(dtype)

    def forward(self, x: torch.Tensor):
        m = self.model
        d = m.compute_dtype
        x = x.to(dtype=d, memory_format=torch.channels_last)
        x = _max_pool(conv_bn(m.conv1, m.bn1, x, True, d))
        x3 = m.layer3(m.layer2(m.layer1(x)))
        return x3, m.layer4(x3)


class A2JResNet(nn.Module):
    """The legacy ResNet50 A2J (`A2J_model`, A2J/model.py:177-195; the
    original A2J configuration, main.py:296-300): the classification head
    on layer3 (1024 channels), the regression and depth heads on layer4
    (2048 channels), `num_anchors` (16, anchors.generate_anchors(None,
    None)) per stride-16 cell.  Depth (B, H, W), (B, 1, H, W) -> (cls
    (B, N, P), reg (B, N, P, 2) [, depth (B, N, P)]), N = (H/16)(W/16) x
    num_anchors."""

    def __init__(self, num_classes: int = 15, num_anchors: int = 16,
                 is_3d: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.is_3d = is_3d
        self.compute_dtype = dtype
        self.Backbone = A2JResNetBackbone(dtype)
        self.classificationModel = AnchorHead(1024, 1, num_anchors,
                                              num_classes, dtype=dtype)
        self.regressionModel = AnchorHead(2048, 2, num_anchors, num_classes,
                                          dtype=dtype)
        if is_3d:
            self.DepthRegressionModel = AnchorHead(
                2048, 1, num_anchors, num_classes, dtype=dtype)

    def forward(self, depth: torch.Tensor):
        if depth.dim() == 3:
            depth = depth[:, None]
        x = depth.to(self.compute_dtype).expand(-1, 3, -1, -1)
        x3, x4 = self.Backbone(x)
        cls = self.classificationModel(x3)
        reg = self.regressionModel(x4)
        if not self.is_3d:
            return cls, reg
        return cls, reg, self.DepthRegressionModel(x4)
