"""Initial weights and memory banks, made on the device from the seed.

One normal draw covers every random leaf, split and scaled a leaf:
convolutions He-normal over their fan-in, linear layers and graph
weights 1/sqrt(fan-in), SemGCN's edge weights and BN scales 1, biases and
BN shifts and statistics at their usual starts.  Names and shapes come
from the plain reference model (built on the meta device), whose keys the
program shares, so the same dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import models


def _scale(name: str, shape: torch.Size) -> float:
    """The std of a random leaf, by its name and shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "W":  # SemGraphConv (2, in, out): Xavier, gain 1.414
        return 1.414 * math.sqrt(2.0 / (shape[1] + shape[2]))
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    if len(shape) == 4:
        return math.sqrt(2.0 / fan_in)
    return 1.0 / math.sqrt(fan_in)


def _is_random(name: str, model: torch.nn.Module) -> bool:
    module = model.get_submodule(name.rsplit(".", 1)[0])
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(module, models.BN):
        return False
    if isinstance(module, models.SemGraphConv):
        return leaf in ("W", "bias")
    return leaf in ("weight", "bias")


def make_state(run: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's initial state dict (params and buffers) for a cell."""
    ref = models.build(run, models.Numerics(), device="meta")
    shapes = ref.state_dict()
    random = [k for k in shapes if _is_random(k, ref)]
    total = sum(shapes[k].numel() for k in random)
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, t in shapes.items():
        if k in random:
            n = t.numel()
            out[k] = draw[at:at + n].view(t.shape) * _scale(k, t.shape)
            at += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(("running_var", ".weight", ".e")):
            out[k] = torch.ones(t.shape, device=device)
        else:
            out[k] = torch.zeros(t.shape, device=device)
    return out


def make_banks(run: dict, seed: int, device) -> torch.Tensor:
    """(3, n_data, 128) bank rows, L2-normalised, from their own stream."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    banks = torch.randn((3, run["n_data"], run["feat_dim"]), generator=g,
                        device=device)
    return models.l2n(banks)
