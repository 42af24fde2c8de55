"""Arch 'HRNet': HCMoCo with depth as an image (the published
CMC3HRNetSGCNSingleHead, build_backbone.py:186-303): HRNet on RGB, HRNet
on the depth copied to three channels, SemGCN on the 2D joints
(models.HCMoCo)."""

from torch import nn

from .. import models

# the batch reads only traffic.py's own fields
FIELDS = ()


def build(run: dict, num: models.Numerics) -> nn.Module:
    return models.HCMoCo(run["width"], num)


def groups(model: nn.Module) -> dict:
    """Each encoder's fused 1x1 ConvBN sites and its other leaves,
    SemGCN, and the heads."""
    return models.hrnet_groups(model, ("encoder1", "encoder2"))
