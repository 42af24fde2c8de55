"""Model FLOPs of a sample: torch's FlopCounterMode over one forward pass
of the plain reference at batch 1 and the cell's shapes (two FLOPs a
multiply-add, every convolution tap).  It counts products and
convolutions only: a point cloud's searches (FPS, ball query, three-NN)
are elementwise in the reference and count nothing, whatever kernel
runs them.  Three times that count stands for the forward and backward
passes; recomputed work is not counted."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import traffic, weights
from .reference import models


def forward_flops(run: dict, device="cpu") -> int:
    """FLOPs of one sample's forward pass through the reference."""
    one = dict(run, batch_size=1, pool=1, depth_ratio=1.0)
    batch = traffic.make_pool(one, 0, device,
                              models.arch(run["arch"]).FIELDS)[0]
    model = models.build(run, models.Numerics(checkpoint=False),
                         device=device)
    model.load_state_dict(weights.make_state(run, 0, device))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(batch)
    return int(counter.get_total_flops())
