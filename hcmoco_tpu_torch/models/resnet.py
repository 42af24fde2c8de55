"""ResNet / ResNeXt and the CMC shared-trunk ResNet (counterpart of
hcmoco_tpu/models/resnet.py), the encoders of the InsDis/PIRL/MoCo/CMC
baselines.

Torch module names are the reference's (pycontrast/networks/resnet.py,
resnet_cmc.py): conv1/bn1 (CMCResNet: conv1_v1, conv1_v2, bn1),
layer{s}.{b}.conv{k}/bn{k}, layer{s}.{b}.downsample.{0,1}, so reference
state dicts (tests/golden/rgb_moco_torch_keys.txt under `encoder.`,
cmc_resnet50_torch_keys.txt) load with strict=True.

As in the JAX package every ResNet, resnet18 and resnet34 included, is
built of bottleneck blocks (expansion 4, a 2048 * width pooled feature),
and ResNet's forward applies the stem max-pool twice, as the reference
forward does (resnet.py:215-219); CMCResNet applies it once.

Input NCHW (channels_last in memory); convs run in `dtype` (bf16 on the
card), BN math in f32 over the global batch of the data-parallel ranks
(parallel/batchnorm.py), the pooled feature in f32, as the port's HRNet.
BN momentum 0.1 (flax 0.9), eps 1e-5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.batchnorm import GlobalBatchNorm2d
from .hrnet import conv_bn, stat_dtype

# flax momentum 0.9 (resnet.py) == torch momentum 0.1
BN_MOMENTUM = 0.1


def _bn(c: int) -> GlobalBatchNorm2d:
    return GlobalBatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """Global mean of an NCHW map in f32 (float64 for a float64 map)."""
    return x.to(stat_dtype(x.dtype)).mean(dim=(2, 3))


class ResBottleneck(nn.Module):
    """1x1-3x3-1x1 bottleneck with groups, base_width and dilation
    (ResBottleneck of the JAX package; expansion 4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16, conv_groups: int = 1):
        super().__init__()
        g = conv_groups  # 2 in every conv of the CMC shared trunk
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False, groups=g)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=dilation,
                               dilation=dilation, groups=groups * g,
                               bias=False)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False, groups=g)
        self.bn3 = _bn(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False, groups=g),
            _bn(out)) if downsample else None)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        out = conv_bn(self.conv1, self.bn1, x, True, d)
        out = conv_bn(self.conv2, self.bn2, out, True, d)
        out = conv_bn(self.conv3, self.bn3, out, False, d)
        res = x if self.downsample is None else conv_bn(
            self.downsample[0], self.downsample[1], x, False, d)
        return F.relu(out + res)


def _make_layers(module: nn.Module, inplanes: int, base: int,
                 layers: Tuple[int, ...], dtype: torch.dtype,
                 **block_kw) -> int:
    """layer1..layer4 of bottlenecks on `module`, each stage's first block
    with a downsample (stride 2 from layer2); returns the out channels."""
    planes = base
    for stage, n_blocks in enumerate(layers):
        stride = 1 if stage == 0 else 2
        blocks = []
        for b in range(n_blocks):
            blocks.append(ResBottleneck(
                inplanes, planes, stride if b == 0 else 1, b == 0,
                dtype=dtype, **block_kw))
            inplanes = planes * ResBottleneck.expansion
        setattr(module, f"layer{stage + 1}", nn.Sequential(*blocks))
        planes *= 2
    return inplanes


class ResNet(nn.Module):
    """ResNet-v1 backbone: the pooled (B, 2048 * width_mult) f32 feature,
    or with return_fm the last NCHW map in `dtype`."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 width_mult: int = 1, in_channel: int = 3, groups: int = 1,
                 base_width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        base = 64 * width_mult
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(in_channel, base, 7, 2, 3, bias=False)
        self.bn1 = _bn(base)
        self.out_channels = _make_layers(self, base, base, layers, dtype,
                                         groups=groups,
                                         base_width=base_width)

    def forward(self, x: torch.Tensor,
                return_fm: bool = False) -> torch.Tensor:
        d = self.compute_dtype
        x = x.to(dtype=d, memory_format=torch.channels_last)
        x = conv_bn(self.conv1, self.bn1, x, True, d)
        # the reference forward max-pools twice (/8 before layer1)
        x = _max_pool(_max_pool(x))
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return x if return_fm else _pool(x)


class CMCResNet(nn.Module):
    """The legacy CMC shared-trunk ResNet (resnet_cmc.py): 7x7 stems for
    the L (1-channel) and ab (2-channel) inputs, concatenated to 128
    channels through one BN, one max-pool, then a trunk of bottlenecks
    whose every conv is groups=2 from inplanes 128, so the two halves of
    the channels never mix; returns the pooled feature's halves (L's,
    ab's), f32.  `width_mult` scales the stages, not the stems."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 width_mult: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1_v1 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.conv1_v2 = nn.Conv2d(2, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(128)
        self.out_channels = _make_layers(self, 128, 64 * width_mult, layers,
                                         dtype, conv_groups=2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.compute_dtype
        x = x.to(dtype=d, memory_format=torch.channels_last)
        h1 = F.conv2d(x[:, :1], self.conv1_v1.weight.to(d), None, 2, 3)
        h2 = F.conv2d(x[:, 1:3], self.conv1_v2.weight.to(d), None, 2, 3)
        h = torch.cat([h1, h2], dim=1)
        h = F.relu(self.bn1(h.to(stat_dtype(d))).to(d))
        h = _max_pool(h)
        for s in range(1, 5):
            h = getattr(self, f"layer{s}")(h)
        pooled = _pool(h)
        half = pooled.shape[-1] // 2
        return pooled[:, :half], pooled[:, half:]


# cmc_model_dict (resnet_cmc.py:234-238)
CMC_RESNET_SPECS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

# model_dict (resnet.py:424-437): name -> constructor kwargs
RESNET_SPECS = {
    "resnet18": dict(layers=(2, 2, 2, 2)),
    "resnet34": dict(layers=(3, 4, 6, 3)),
    "resnet50": dict(layers=(3, 4, 6, 3)),
    "resnet101": dict(layers=(3, 4, 23, 3)),
    "resnet152": dict(layers=(3, 8, 36, 3)),
    "resnext50": dict(layers=(3, 4, 6, 3), groups=32, base_width=4),
    "resnext101": dict(layers=(3, 4, 23, 3), groups=32, base_width=8),
    "resnext152": dict(layers=(3, 8, 36, 3), groups=32, base_width=4),
}


def parse_arch(name: str) -> Tuple[str, int]:
    """'resnet50x2' -> ('resnet50', 2) (_parse_width,
    build_backbone.py:40-47)."""
    if name.endswith("x4"):
        return name[:-2], 4
    if name.endswith("x2"):
        return name[:-2], 2
    return name, 1


def make_resnet(name: str, in_channel: int = 3,
                dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A RESNET_SPECS ResNet, or a ResNeSt (models/resnest.py) for
    resnest50/resnest101, at the width of an x2/x4 suffix."""
    base, width = parse_arch(name)
    if base.startswith("resnest"):
        from .resnest import RESNEST_SPECS, ResNeSt

        if base not in RESNEST_SPECS:
            raise NotImplementedError(f"arch {name}")
        layers, stem = RESNEST_SPECS[base]
        return ResNeSt(layers=layers, stem_width=stem, in_channel=in_channel,
                       width_mult=width, dtype=dtype)
    if base not in RESNET_SPECS:
        raise NotImplementedError(f"arch {name}")
    return ResNet(in_channel=in_channel, width_mult=width, dtype=dtype,
                  **RESNET_SPECS[base])


def make_cmc_resnet(name: str,
                    dtype: torch.dtype = torch.bfloat16) -> CMCResNet:
    base, width = parse_arch(name)
    return CMCResNet(layers=CMC_RESNET_SPECS[base], width_mult=width,
                     dtype=dtype)
