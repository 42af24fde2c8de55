"""Projection heads (counterpart of hcmoco_tpu/models/heads.py).

Reference: `Normalize` (pycontrast/networks/util.py:74-81) and the linear /
mlp heads of build_backbone.py:225-242, kept as an nn.Sequential so the
keys are the reference's `head{i}.0.weight`, ...; and the gaussian blur of
the stage-2 joint pooling (util.py:28-43).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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
