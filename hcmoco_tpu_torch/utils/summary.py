"""Model summary: a parameter table grouped by module, and the FLOPs of one
forward (counterpart of hcmoco_tpu/utils/summary.py).

Reference: `HRNet-Semantic-Segmentation/lib/utils/modelsummary.py`
(`get_model_summary`, the layer-wise params/FLOPs dump that
tools/train.py:88 prints).  The FLOPs come from
torch.utils.flop_counter.FlopCounterMode, which counts by operator and
shape: 2 x the multiply-adds of each matmul, convolution and attention,
every tap of a convolution included, and nothing else.  The JAX
package's `compiled_flops` asks XLA's cost analysis of the compiled
program, which leaves out a convolution's taps on its zero padding and
adds the elementwise work (BN, ReLU, adds, pooling): the two differ by
the model and the map size (the port's count of a one-block-a-stage
ResNet at 32^2 is 1.279 x XLA's, of a two-block one at 64^2 1.150 x;
tests/test_torch_summary.py holds the first).  FlopCounterMode counts
shapes, not devices: a model's count is the same on the card and on the
CPU.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def param_table(model: nn.Module, max_depth: int = 2) -> str:
    """A table of parameter counts grouped by the dotted module path cut to
    `max_depth` names, sorted, with a TOTAL row (the JAX package's layout,
    whose paths join with '/')."""
    rows: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:max_depth])
        rows[key] = rows.get(key, 0) + p.numel()
    total = sum(rows.values())
    width = max((len(k) for k in rows), default=10) + 2
    lines = [f"{'module':<{width}} params"]
    for k in sorted(rows):
        lines.append(f"{k:<{width}} {rows[k]:,}")
    lines.append(f"{'TOTAL':<{width}} {total:,}")
    return "\n".join(lines)


def count_params(model: nn.Module) -> int:
    """The number of parameter elements (BN statistics are buffers, not
    counted, as flax's batch_stats are not)."""
    return sum(p.numel() for p in model.parameters())


def forward_flops(model: nn.Module, *example_args, **kwargs) -> int:
    """FLOPs of one eval-mode forward model(*example_args, **kwargs) under
    no_grad, counted by FlopCounterMode (module docstring); the model's
    training mode is restored after."""
    from torch.utils.flop_counter import FlopCounterMode

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(*example_args, **kwargs)
    finally:
        model.train(was_training)
    return counter.get_total_flops()


def model_summary(model: nn.Module, *example_args, **kwargs) -> str:
    """get_model_summary's counterpart: the parameter table, then
    `forward FLOPs: ... G`."""
    flops = forward_flops(model, *example_args, **kwargs)
    return "\n".join([param_table(model), f"forward FLOPs: {flops / 1e9:.3f} G"])
