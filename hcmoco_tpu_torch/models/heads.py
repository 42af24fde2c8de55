"""Projection heads (counterpart of hcmoco_tpu/models/heads.py).

Reference: `Normalize` (pycontrast/networks/util.py:74-81) and the linear /
mlp heads of build_backbone.py:225-242, kept as an nn.Sequential so the
keys are the reference's `head{i}.0.weight`, ...
"""

from __future__ import annotations

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
