"""HRNetV2 backbone in PyTorch.

Counterpart of hcmoco_tpu/models/hrnet.py, with the reference torch module
names (official_hrnet.py: conv1/bn1, layer1.{b}.conv{k}/bn{k},
transition{t}.{i}, stage{s}.{m}.branches / fuse_layers), so reference state
dicts load with strict=True.

Activations are NCHW tensors held in torch.channels_last memory, so a 1x1
site views its input as the (B*H*W, C) matrix that kernel K1 takes, without
a copy.  Convs run in `dtype` (bf16 on the card); BN math in f32; params and
BN statistics are f32 (a model moved to float64 with dtype float64 runs
every op in float64, the CPU tests' reference).

HCMOCO_CONVBN_FUSE=1, read when the model is built, routes every HRNet
ConvBN site in training through the port's own BN kernels
(ops/matmul_bn.py): a 1x1 stride-1 site through conv1x1_bn_stats +
bn_apply_stats, which compute the BN channel sums in the conv's epilogue
and normalise with them in one pass each way (on the card, kernels K1 and
K1b); every other site (the 3x3 and strided convs) through conv_out_bn,
BN(+ReLU) of the bf16 conv output in one sums and one apply pass forward
and one sums and one dx pass backward, with nothing cast to f32.
`set_convbn_fuse` switches a built model.  Both paths update the BN
running statistics with torch semantics (unbiased running variance); the
fused paths do it inside their apply.

Under TrainConfig.remat (train/remat.py) the stem, each residual block,
each standalone ConvBN and each fused output of an HRModule is a region
recomputed in the backward; conv_bn is where 'conv_out' keeps the conv
output (K1's y and sums on the fused path).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import HRNetConfig, HRNetStageSpec
from ..ops.matmul_bn import bn_apply_stats, conv1x1_bn_stats, conv_out_bn
from ..parallel.batchnorm import GlobalBatchNorm2d
from ..parallel.mesh import all_reduce_sum, world_size
from ..train import remat
from ..train.remat import region

# flax momentum 0.99 (hrnet.py bn_momentum) == torch momentum 0.01
BN_MOMENTUM = 0.01


def convbn_fuse_enabled() -> bool:
    """HCMOCO_CONVBN_FUSE=1: every HRNet ConvBN site in training takes the
    port's BN kernels (K1/K1b at a 1x1 stride-1 site, conv_out_bn at the
    others) instead of nn.BatchNorm on an f32 cast."""
    return os.environ.get("HCMOCO_CONVBN_FUSE", "0") == "1"


def set_convbn_fuse(module: nn.Module, on: bool) -> nn.Module:
    """Switch every HRNet ConvBN site under `module` to the fused (on) or
    the plain path, whatever HCMOCO_CONVBN_FUSE was when it was built."""
    for m in module.modules():
        if isinstance(m, (ConvBN, BasicBlock, Bottleneck, HRNet)):
            m.convbn_fuse = on
    return module


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of BN and resize math for activations in `dtype`: f32,
    or float64 in a model run in float64 (the CPU tests' reference)."""
    return torch.promote_types(dtype, torch.float32)


def _is_fusable(conv: nn.Conv2d) -> bool:
    return conv.kernel_size == (1, 1) and conv.stride == (1, 1)


class _KeptConv(torch.autograd.Function):
    """A ConvBN site's bias-free conv in a region that recomputes under
    remat_policy 'conv_out' (train/remat.py): the recompute takes the
    output back from the first run instead of convolving again.  The
    backward is autograd's own for F.conv2d."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, groups)
        return remat.kept(lambda: F.conv2d(x, w, None, stride, padding,
                                           dilation, groups))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, stride, padding, dilation, False, (0, 0),
            groups, (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                     False))
        return dx, dw, None, None, None, None


def _running(bn: nn.BatchNorm2d):
    """The running statistics a fused site's apply updates: none in a
    recompute, which leaves them as the first run set them."""
    if remat.replaying():
        return None
    return (bn.running_mean, bn.running_var, bn.num_batches_tracked,
            bn.momentum)


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
            relu: bool, dtype: torch.dtype, fuse: bool = False
            ) -> torch.Tensor:
    """One ConvBN site: conv in `dtype`, BN statistics in f32, output in
    `dtype`.  With `fuse`, a site in training takes a fused path: a 1x1
    stride-1 site K1 + K1b, every other site conv_out_bn on the conv's
    output.  Under data parallelism BN takes the global batch's
    statistics: the fused paths all-reduce their channel sums (one
    all-reduce of the packed (2C,) sums) and normalise by the global row
    count, the plain path through GlobalBatchNorm2d.  The conv's output
    (K1's y and sums on the 1x1 path) is what remat_policy 'conv_out'
    keeps for the recompute (train/remat.py), where JAX's
    checkpoint_name(y, "conv_out") anchors."""
    w = conv.weight.to(dtype)
    if fuse and bn.training and _is_fusable(conv):
        b, cin, h, wd = x.shape
        x2d = x.to(dtype).permute(0, 2, 3, 1).reshape(-1, cin)
        y2d, s1, s2 = conv1x1_bn_stats(x2d, w.reshape(w.shape[0], cin))
        n = None
        size = world_size()
        if size > 1:
            # K1 ran on this rank's rows.  The all-reduce's backward sums
            # ds1/ds2 over the ranks before K1's dyt prologue takes them,
            # which makes each rank's dyt its share of the global loss's.
            c = s1.shape[0]
            sums = all_reduce_sum(torch.cat([s1, s2]))
            s1, s2 = sums[:c], sums[c:]
            n = y2d.shape[0] * size
        out2d, _, _ = bn_apply_stats(y2d, s1, s2, bn.weight, bn.bias, bn.eps,
                                     running=_running(bn), n=n)
        y = out2d.view(b, h, wd, -1).permute(0, 3, 1, 2)
    else:
        xd = x.to(dtype)
        conf = (conv.stride, conv.padding, conv.dilation, conv.groups)
        y = (_KeptConv.apply(xd, w, *conf) if remat.keeps_conv_out()
             else F.conv2d(xd, w, None, *conf))
        if fuse and bn.training:
            b, c, h, wd = y.shape
            out2d = conv_out_bn(y.permute(0, 2, 3, 1).reshape(-1, c),
                                bn.weight, bn.bias, bn.eps, relu,
                                _running(bn), world_size())
            return out2d.view(b, h, wd, c).permute(0, 3, 1, 2)
        y = bn(y.to(stat_dtype(y.dtype))).to(dtype)
    return F.relu(y) if relu else y


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


class ConvBN(nn.Sequential):
    """conv + BN (+ReLU) as children "0"/"1": the reference's Sequential."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 relu: bool, dtype: torch.dtype):
        super().__init__(_conv(cin, cout, kernel, stride),
                         GlobalBatchNorm2d(cout, momentum=BN_MOMENTUM))
        self.relu = relu
        self.compute_dtype = dtype
        self.convbn_fuse = convbn_fuse_enabled()

    def forward(self, x):
        return region(self._forward, x)

    def _forward(self, x):
        return conv_bn(self[0], self[1], x, self.relu, self.compute_dtype,
                       self.convbn_fuse)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (official_hrnet.py:32-61); expansion 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = GlobalBatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = _conv(planes, planes, 3, 1)
        self.bn2 = GlobalBatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.downsample = (ConvBN(inplanes, planes, 1, stride, False, dtype)
                           if downsample else None)
        self.compute_dtype = dtype
        self.convbn_fuse = convbn_fuse_enabled()

    def forward(self, x):
        return region(self._forward, x)

    def _forward(self, x):
        d, fuse = self.compute_dtype, self.convbn_fuse
        out = conv_bn(self.conv1, self.bn1, x, True, d, fuse)
        out = conv_bn(self.conv2, self.bn2, out, False, d, fuse)
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual block (official_hrnet.py:64-102); expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, dtype: torch.dtype):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, 1)
        self.bn1 = GlobalBatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = GlobalBatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv3 = _conv(planes, out, 1, 1)
        self.bn3 = GlobalBatchNorm2d(out, momentum=BN_MOMENTUM)
        self.downsample = (ConvBN(inplanes, out, 1, stride, False, dtype)
                           if downsample else None)
        self.compute_dtype = dtype
        self.convbn_fuse = convbn_fuse_enabled()

    def forward(self, x):
        return region(self._forward, x)

    def _forward(self, x):
        d, fuse = self.compute_dtype, self.convbn_fuse
        out = conv_bn(self.conv1, self.bn1, x, True, d, fuse)
        out = conv_bn(self.conv2, self.bn2, out, True, d, fuse)
        out = conv_bn(self.conv3, self.bn3, out, False, d, fuse)
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _make_blocks(block_name: str, inplanes: int, planes: int, n: int,
                 dtype: torch.dtype) -> nn.Sequential:
    block = _BLOCKS[block_name]
    out = planes * block.expansion
    layers = []
    for b in range(n):
        cin = inplanes if b == 0 else out
        layers.append(block(cin, planes, 1, b == 0 and cin != out, dtype))
    return nn.Sequential(*layers)


def pool_maps(feats: Sequence[torch.Tensor], method: str) -> torch.Tensor:
    """Pool each NCHW HRNet map globally in f32 and concat (270-d at W18);
    build_backbone.py:266-281."""
    pooled = []
    for f in feats:
        f32 = f.float()
        pooled.append(f32.mean(dim=(2, 3)) if method == "mean"
                      else f32.amax(dim=(2, 3)))
    return torch.cat(pooled, dim=-1)


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize on NCHW in f32 (float64 for a float64 map),
    align_corners=False."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    out = F.interpolate(x.to(stat_dtype(x.dtype)), size=(h, w),
                        mode="bilinear", align_corners=False)
    return out.to(x.dtype)


def nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of an NCHW map with half-pixel centres
    ('nearest-exact'): 16 -> 4 samples rows 2, 6, 10, 14, as
    jax.image.resize(method='nearest') does.  The original torch reference
    used mode 'nearest', which samples 0, 4, 8, 12 (ROADMAP.md Queue 3,
    F2)."""
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def merge_all_res(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Maps 1-3 resized to map 0's size (bilinear, align_corners=False, in
    f32) and concatenated on channels with map 0: 270 channels at W18
    (build_backbone.py:247-254)."""
    h, w = feats[0].shape[2], feats[0].shape[3]
    return torch.cat([feats[0]] + [_resize_bilinear(f, h, w)
                                   for f in feats[1:]], dim=1)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch residual blocks + full fusion.

    Fusion (official_hrnet.py:177-249): j>i upsample = 1x1 conv+BN then
    bilinear; j<i downsample = chained stride-2 3x3 conv+BN(+ReLU except
    the last); diagonal identity; SUM-fused then ReLU.
    """

    def __init__(self, spec: HRNetStageSpec, in_channels: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        nb = spec.num_branches
        expansion = _BLOCKS[spec.block].expansion
        out_ch = [c * expansion for c in spec.num_channels]
        self.branches = nn.ModuleList(
            _make_blocks(spec.block, in_channels[i], spec.num_channels[i],
                         spec.num_blocks[i], dtype) for i in range(nb))
        self.fuse_layers = None
        if nb > 1:
            fuse = []
            for i in range(nb):
                row = []
                for j in range(nb):
                    if j > i:
                        row.append(ConvBN(out_ch[j], out_ch[i], 1, 1, False,
                                          dtype))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.Sequential(*(
                            ConvBN(out_ch[j],
                                   out_ch[i] if k == i - j - 1 else out_ch[j],
                                   3, 2, k != i - j - 1, dtype)
                            for k in range(i - j))))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        return [region(self._fuse, i, *ys)
                for i in range(len(self.fuse_layers))]

    def _fuse(self, i: int, *ys: torch.Tensor) -> torch.Tensor:
        """Fused output i: the sum of every branch brought to branch i's
        resolution, ReLU."""
        h, w = ys[i].shape[2], ys[i].shape[3]
        acc = ys[i]
        for j, layer in enumerate(self.fuse_layers[i]):
            if j > i:
                acc = acc + _resize_bilinear(layer(ys[j]), h, w)
            elif j < i:
                acc = acc + layer(ys[j])
        return F.relu(acc)


class HRNet(nn.Module):
    """HRNetV2 backbone.  Input NCHW; returns the 4 feature maps (NCHW)."""

    def __init__(self, config: HRNetConfig, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.convbn_fuse = convbn_fuse_enabled()
        stem = config.stem_channels
        self.conv1 = _conv(in_channels, stem, 3, 2)
        self.bn1 = GlobalBatchNorm2d(stem, momentum=BN_MOMENTUM)
        self.conv2 = _conv(stem, stem, 3, 2)
        self.bn2 = GlobalBatchNorm2d(stem, momentum=BN_MOMENTUM)

        s1 = config.stage1
        self.layer1 = _make_blocks(s1.block, stem, s1.num_channels[0],
                                   s1.num_blocks[0], dtype)
        pre = [s1.num_channels[0] * _BLOCKS[s1.block].expansion]
        for si, spec in ((2, config.stage2), (3, config.stage3),
                         (4, config.stage4)):
            cur = [c * _BLOCKS[spec.block].expansion
                   for c in spec.num_channels]
            trans = []
            for i in range(spec.num_branches):
                if i < len(pre):
                    trans.append(ConvBN(pre[i], cur[i], 3, 1, True, dtype)
                                 if pre[i] != cur[i] else None)
                else:
                    chain = []
                    for j in range(i + 1 - len(pre)):
                        cin = pre[-1]
                        cout = cur[i] if j == i - len(pre) else cin
                        chain.append(ConvBN(cin, cout, 3, 2, True, dtype))
                    trans.append(nn.Sequential(*chain))
            setattr(self, f"transition{si - 1}", nn.ModuleList(trans))
            setattr(self, f"stage{si}", nn.Sequential(*(
                HRModule(spec, cur, dtype)
                for _ in range(spec.num_modules))))
            pre = cur

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        d = self.compute_dtype
        x = x.to(dtype=d, memory_format=torch.channels_last)
        xs = [self.layer1(region(self._stem, x))]
        for si in (2, 3, 4):
            new = []
            for i, t in enumerate(getattr(self, f"transition{si - 1}")):
                # a new branch grows from the lowest-resolution map
                src = xs[i] if i < len(xs) else xs[-1]
                new.append(src if t is None else t(src))
            xs = getattr(self, f"stage{si}")(new)
        return xs

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        d, fuse = self.compute_dtype, self.convbn_fuse
        x = conv_bn(self.conv1, self.bn1, x, True, d, fuse)
        return conv_bn(self.conv2, self.bn2, x, True, d, fuse)


def fused_sites(encoder: HRNet) -> int:
    """Number of ConvBN sites of an HRNet that HCMOCO_CONVBN_FUSE=1 routes
    through K1 (one K1 launch each per training forward)."""
    return sum(1 for m in encoder.modules()
               if isinstance(m, nn.Conv2d) and _is_fusable(m))


def bn_sites(encoder: HRNet) -> int:
    """Number of ConvBN sites of an HRNet that HCMOCO_CONVBN_FUSE=1 routes
    through conv_out_bn (the 3x3 and strided convs; one launch of each of
    its four kernel wrappers per site and training step)."""
    return sum(1 for m in encoder.modules()
               if isinstance(m, nn.Conv2d) and not _is_fusable(m))
