"""Projection and segmentation heads (counterpart of
hcmoco_tpu/models/heads.py).

Reference: `Normalize` (pycontrast/networks/util.py:74-81) and the linear /
mlp heads of build_backbone.py:225-242, kept as an nn.Sequential so the
keys are the reference's `head{i}.0.weight`, ...; the gaussian blur of
the stage-2 joint pooling (util.py:28-43); and the versatility
segmentor's FCN head (networks/fcn.py:35-111) with its masked BN.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import batchnorm as global_bn


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics: x / max(||x||, eps), norm in f32."""
    return F.normalize(x.float(), p=2.0, dim=dim, eps=eps).to(x.dtype)


class ProjectionHead(nn.Sequential):
    """linear (or mlp) projection + L2 norm to the contrastive sphere; f32."""

    def __init__(self, in_dim: int, feat_dim: int = 128,
                 head: str = "linear"):
        if head == "linear":
            layers = [nn.Linear(in_dim, feat_dim)]
        elif head == "mlp":
            layers = [nn.Linear(in_dim, in_dim), nn.ReLU(),
                      nn.Linear(in_dim, feat_dim)]
        else:
            raise NotImplementedError(f"head: {head}")
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(super().forward(x.float()))


def linear_1x1(conv: nn.Conv2d, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """A stage-2 1x1 head (encoder{1,2}_linear, conv with bias) on an NCHW
    map, run in `dtype`, output f32."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype),
                    conv.bias.to(dtype)).float()


def gaussian_kernel_2d(kernel_size: int, sigma: float) -> torch.Tensor:
    """(k, k) gaussian, the outer product of a 1-D one, normalised to sum 1,
    in f32 (util.py:28-43)."""
    ax = np.arange(kernel_size, dtype=np.float32)
    g = np.exp(-(((ax - (kernel_size - 1) / 2.0) / sigma) ** 2) / 2.0)
    k = np.outer(g, g)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def gaussian_blur_nhwc(x: torch.Tensor, kernel_size: int = 5,
                       sigma: float = 1.0) -> torch.Tensor:
    """Depthwise gaussian blur of an NHWC map with reflect padding of
    kernel_size // 2 (GaussianSmoothing in `_gaussian_joint_pooling`,
    contrast_trainer.py:725-731); output NHWC, x's dtype."""
    pad = kernel_size // 2
    c = x.shape[-1]
    k = gaussian_kernel_2d(kernel_size, sigma).to(x.device, x.dtype)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(xp, k.expand(c, 1, kernel_size, kernel_size), groups=c)
    return out.permute(0, 2, 3, 1)


class MaskedBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose training statistics can leave samples out.

    The reference feeds only the labelled (`true_label`) frames through the
    segmentor's classifier (segment_trainer.py:747-769), so the head's BN
    statistics are those of the labelled subset.  Here every frame runs
    and the statistics are weighted by a per-sample 0/1 `sample_mask`:
    n = max(sum(mask) * H * W, 1), mean and biased var over the kept
    rows; the running variance takes the unbiased var * n / max(n - 1, 1)
    (torch momentum 0.1).  With no kept frame n is 1, the batch mean and
    var are 0 and the running statistics still move, as the JAX package's
    do.  No host sync.  The buffers and keys are nn.BatchNorm2d's.
    Under data parallelism the kept rows and their count are the global
    batch's (one all-reduce of the masked sums, var = E[x^2] - E[x]^2)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            red = (0, 2, 3)
            hw = x.shape[2] * x.shape[3]
            if sample_mask is None:
                w = torch.ones((x.shape[0], 1, 1, 1), device=x.device)
            else:
                w = sample_mask.float().view(-1, 1, 1, 1)
            if global_bn.global_stats_active():
                mean, var, n = global_bn.masked_global_stats(xf, w)
            else:
                n = torch.clamp(w.sum() * hw, min=1.0)
                mean = (xf * w).sum(red) / n
                var = ((xf - mean[None, :, None, None]) ** 2 * w).sum(red) / n
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    unbiased, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


class _ConvModule(nn.Module):
    """conv + BN + ReLU under the reference's names `conv`, `norm_name`."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size,
                              padding=kernel_size // 2)
        self.norm_name = MaskedBatchNorm(cout)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.relu(self.norm_name(self.conv(x), sample_mask))


class FCNHead(nn.Module):
    """FCN segmentation head (networks/fcn.py:35-111), NCHW f32:
    num_convs ConvModules (conv with bias, MaskedBatchNorm, ReLU), the 1x1
    classifier `conv_seg`, then x4 bilinear upsampling with half-pixel
    centres (F.interpolate, align_corners=False: jax.image.resize's
    'bilinear' when upsampling).  build_segmentor uses channels = 128,
    num_convs 1, kernel_size 1 (build_linear.py:4-15); num_convs and
    kernel_size mirror the JAX module's fields.  Keys
    `convs.{i}.conv`, `convs.{i}.norm_name`, `conv_seg`
    (tests/golden/fcn_torch_keys.txt).

    sample_mask: per-sample 0/1; training BN statistics leave masked
    frames out (see MaskedBatchNorm)."""

    def __init__(self, channels: int, num_classes: int, num_convs: int = 1,
                 kernel_size: int = 1):
        super().__init__()
        self.convs = nn.ModuleList(
            _ConvModule(channels, channels, kernel_size)
            for _ in range(num_convs))
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float()
        for m in self.convs:
            x = m(x, sample_mask)
        logits = self.conv_seg(x)
        h, w = logits.shape[2:]
        return F.interpolate(logits, size=(h * 4, w * 4), mode="bilinear",
                             align_corners=False)
