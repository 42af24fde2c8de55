"""HRNetV2 segmentation model for downstream human parsing (counterpart of
hcmoco_tpu/downstream/seg/model.py).

Behavioral spec: `HRNet-Semantic-Segmentation/lib/models/seg_hrnet.py` —
the backbone, then `last_layer`: all four branches upsampled to 1/4
resolution and concatenated (270 channels at W18), 1x1 conv -> BN -> ReLU
-> 1x1 conv to NUM_CLASSES (:310-327, forward :443-454).  The backbone's
parameters sit at the top level under the reference names (conv1,
layer1, ..., stage4) and the head's under `last_layer.0/1/3`, as in
seg_hrnet.py, so a reference state dict loads by name.

The backbone is the port's HRNet (its 1x1 stride-1 ConvBN sites take the
fused K1/K1b path under HCMOCO_CONVBN_FUSE=1); the head's 1x1 conv is a
plain conv with a bias, as in the JAX package, and the last conv runs in
f32 (the parameters' dtype).  `last_layer.1` has flax momentum 0.99,
torch momentum 0.01.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import HRNET_CONFIGS
from ...export.transfer import load_hrnet_state, read_state_dict
from ...models.hrnet import HRNet, merge_all_res, stat_dtype
from ...parallel.batchnorm import GlobalBatchNorm2d


def merged_channels(width: int) -> int:
    """Channels of merge_all_res at HRNet-W`width` (270 at W18)."""
    return sum(HRNET_CONFIGS[width].stage4.num_channels)


class SegHRNet(HRNet):
    """NCHW image -> NCHW f32 logits at 1/4 of the input size."""

    def __init__(self, num_classes: int = 25, width: int = 18,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(HRNET_CONFIGS[width], 3, dtype)
        c = merged_channels(width)
        self.last_layer = nn.Sequential(
            nn.Conv2d(c, c, 1), GlobalBatchNorm2d(c, momentum=0.01), nn.ReLU(),
            nn.Conv2d(c, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        h = merge_all_res(super().forward(x))
        conv1, bn, _, conv2 = self.last_layer
        h = F.conv2d(h.to(d), conv1.weight.to(d), conv1.bias.to(d))
        h = F.relu(bn(h.to(stat_dtype(d))).to(d))
        return F.conv2d(h.to(conv2.weight.dtype), conv2.weight, conv2.bias)


def load_pretrained(path: str, model: SegHRNet) -> int:
    """Load a transfer_ckpt-exported (or reference) HRNet state dict into
    the model's backbone, in place: `model.` stripped from the keys, then
    the filtered load (seg_hrnet.py:456-480); the head keeps its init.
    Returns the number of conv weights loaded, as the JAX package's
    load_pretrained counts them."""
    sd = {k.replace("model.", ""): v for k, v in read_state_dict(path).items()}
    return load_hrnet_state(sd, model, skip=("last_layer",))
