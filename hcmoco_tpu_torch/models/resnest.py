"""ResNeSt (split-attention ResNet) in PyTorch, counterpart of
hcmoco_tpu/models/resnest.py.

Behavioral spec: `pycontrast/networks/resnest.py` — `SplAtConv2d`
(radix-2 split attention with an r-softmax over the radix axis, a sigmoid
gate at radix 1), the ResNeSt bottleneck (avd average pool, avg-down
shortcut), the deep stem, and `resnest50/101` (radix 2, cardinality 1,
stem width 32/64, deep stem, avg_down, avd).

Module names follow the public ResNeSt code, which the reference copies:
SplAtConv2d's conv, bn0, fc1, bn1, fc2; the deep stem as one Sequential
`conv1` (convs at 0, 3, 6, BNs at 1, 4) and `bn1` after it; a block's
conv1/bn1, conv2 (the SplAtConv2d), conv3/bn3 and `downsample` (the
avg-down pool at 0, its conv at 1 and BN at 2).

As in the JAX package (ROADMAP.md Queue 3, F13a): the avd pool runs
*before* the split-attention conv (the public resnest50/101 build with
avd_first=False, which pools after it), and the avg-down shortcut pools
with floor and counts padding (the public code: ceil_mode=True,
count_include_pad=False); the two differ only on maps of odd size.

Input NCHW (channels_last in memory); convs run in `dtype` (bf16 on the
card), BN math in f32 over the global batch of the data-parallel ranks,
the radix softmax in f32, the pooled feature in f32, as models/resnet.py.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .hrnet import conv_bn, stat_dtype
from .resnet import _bn, _max_pool, _pool


def _avd_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The avd position's 3x3 average pool, padding 1, the padded zeros
    counted (JAX's avg_pool).  On a CUDA tensor in channels_last,
    PyTorch's gradient of this pool is wrong (ROADMAP.md Queue 3, F14: the
    input gradient off by about its own magnitude in f32, bf16 and
    float64, the forward right), so there it pools an NCHW copy and hands
    back channels_last."""
    if x.is_cuda and not x.is_contiguous():
        y = F.avg_pool2d(x.contiguous(), 3, stride, 1)
        return y.contiguous(memory_format=torch.channels_last)
    return F.avg_pool2d(x, 3, stride, 1)


def _conv(cin: int, cout: int, kernel: int = 1, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
                     bias=False)


class SplAtConv2d(nn.Module):
    """Split-attention conv: a grouped conv to `radix` branches of
    `channels`, their sum pooled to a (B, C) vector, fc1 + BN + ReLU +
    fc2 to per-branch logits, an r-softmax over the branches (a sigmoid
    at radix 1), and the gated sum of the branches."""

    def __init__(self, in_channels: int, channels: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, radix: int = 2,
                 reduction_factor: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inter = max(in_channels * radix // reduction_factor, 32)
        self.radix, self.channels = radix, channels
        self.compute_dtype = dtype
        self.conv = _conv(in_channels, channels * radix, kernel, stride,
                          groups * radix)
        self.bn0 = _bn(channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = _bn(inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        r, c = self.radix, self.channels
        h = conv_bn(self.conv, self.bn0, x, True, d)
        b, _, hh, ww = h.shape
        split = h.view(b, r, c, hh, ww)
        gap = split.sum(1) if r > 1 else split[:, 0]
        gap = gap.to(stat_dtype(d)).mean(dim=(2, 3), keepdim=True).to(d)
        g = F.conv2d(gap, self.fc1.weight.to(d), self.fc1.bias.to(d),
                     groups=self.fc1.groups)
        g = F.relu(self.bn1(g.to(stat_dtype(d)))).to(d)
        att = F.conv2d(g, self.fc2.weight.to(d), self.fc2.bias.to(d),
                       groups=self.fc2.groups).view(b, r, c)
        if r > 1:
            att = F.softmax(att.to(stat_dtype(d)), dim=1).to(d)
            return (split * att[..., None, None]).sum(1)
        return split[:, 0] * torch.sigmoid(att[:, 0])[..., None, None]


class ResNeStBottleneck(nn.Module):
    """1x1 conv, avd pool (stride > 1 or the first block), SplAtConv2d,
    1x1 conv, and the avg-down shortcut; expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, radix: int = 2,
                 cardinality: int = 1, bottleneck_width: int = 64,
                 avd: bool = True, is_first: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        gw = int(planes * (bottleneck_width / 64.0)) * cardinality
        out = planes * self.expansion
        self.stride = stride
        self.use_avd = avd and (stride > 1 or is_first)
        self.compute_dtype = dtype
        self.conv1 = _conv(inplanes, gw)
        self.bn1 = _bn(gw)
        self.conv2 = SplAtConv2d(gw, gw, 3, 1 if self.use_avd else stride,
                                 cardinality, radix, dtype=dtype)
        self.conv3 = _conv(gw, out)
        self.bn3 = _bn(out)
        self.downsample = (nn.Sequential(
            nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity(),
            _conv(inplanes, out), _bn(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        out = conv_bn(self.conv1, self.bn1, x, True, d)
        if self.use_avd:
            # the stride moves into a 3x3 average pool before the conv
            out = _avd_pool(out, self.stride)
        out = self.conv2(out)
        out = conv_bn(self.conv3, self.bn3, out, False, d)
        res = x
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            res = conv_bn(conv, bn, pool(x), False, d)
        return F.relu(out + res)


class ResNeSt(nn.Module):
    """ResNeSt backbone: deep stem (three 3x3 convs), one max-pool, four
    stages of ResNeStBottleneck; the pooled (B, 2048 * width_mult) f32
    feature, or with return_fm the last NCHW map in `dtype`."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 stem_width: int = 32, in_channel: int = 3,
                 width_mult: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        sw = stem_width
        self.compute_dtype = dtype
        self.conv1 = nn.Sequential(
            _conv(in_channel, sw, 3, 2), _bn(sw), nn.ReLU(),
            _conv(sw, sw, 3), _bn(sw), nn.ReLU(), _conv(sw, 2 * sw, 3))
        self.bn1 = _bn(2 * sw)
        inplanes, planes = 2 * sw, 64 * width_mult
        for stage, n_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(ResNeStBottleneck(
                    inplanes, planes, stride if b == 0 else 1,
                    downsample=b == 0, is_first=(b == 0 and stage == 0),
                    dtype=dtype))
                inplanes = planes * ResNeStBottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor,
                return_fm: bool = False) -> torch.Tensor:
        d = self.compute_dtype
        x = x.to(dtype=d, memory_format=torch.channels_last)
        s = self.conv1
        x = conv_bn(s[0], s[1], x, True, d)
        x = conv_bn(s[3], s[4], x, True, d)
        x = _max_pool(conv_bn(s[6], self.bn1, x, True, d))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x if return_fm else _pool(x)


# resnest50/101 (resnest.py:376-390): (layers, stem width)
RESNEST_SPECS = {
    "resnest50": ((3, 4, 6, 3), 32),
    "resnest101": ((3, 4, 23, 3), 64),
}
