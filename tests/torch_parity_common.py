"""Helpers shared by the tests that hold hcmoco_tpu_torch against hcmoco_tpu.

Inputs come from numpy with a seed and go through both packages; JAX-side
weights are carried to the port with flax_to_port_state_dict.

BN running variance (ROADMAP.md Queue 3, F1): flax tracks the biased batch
variance, the port torch's unbiased one.  `check_bn_stats` therefore
compares running_mean directly and the batch contribution to running_var
after scaling the JAX one by n/(n-1), n the rows each BN normalised over.
"""

import copy

import numpy as np
import torch

from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse


def counts_from_indices(neg_idx: torch.Tensor, n_data: int) -> torch.Tensor:
    """Counts of a pinned (bsz, K+1) draw whose column 0 is the positive
    (the JAX parity harness's `neg_idx`): the bincount of columns 1..K,
    the form in which the port's step takes a pinned draw."""
    neg = neg_idx[:, 1:].long()
    counts = torch.zeros((neg.shape[0], n_data), dtype=torch.float32)
    return counts.scatter_add_(1, neg, torch.ones(neg.shape))


def bn_rows(model: torch.nn.Module, *inputs) -> dict:
    """{BN module name: rows it normalises over}, from a train-mode forward
    of a copy of `model` with the plain ConvBN path."""
    m = set_convbn_fuse(copy.deepcopy(model).train(), False)
    rows = {}
    hooks = []
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            def hook(mod, args, name=name):
                rows[name] = args[0].numel() // args[0].shape[1]
            hooks.append(mod.register_forward_pre_hook(hook))
    with torch.no_grad():
        m(*inputs)
    for h in hooks:
        h.remove()
    return rows


def check_bn_stats(model: torch.nn.Module, port_before: dict,
                   jax_params: dict, jax_before: dict, jax_after: dict,
                   rows: dict, atol: float, rtol: float = 0.0,
                   updates: int = 1, convert=flax_to_port_state_dict) -> int:
    """Compare the port model's BN running stats with JAX's.

    port_before / jax_before are the stats before the compared updates:
    `updates` chained ones (a microbatch step's, one a microbatch) of
    `rows` each.  `convert` maps the JAX trees to the port's state dict
    (an HCMoCo model's by default).  Returns the number of BN layers
    compared."""
    want_before = convert(jax_params, jax_before)
    want_after = convert(jax_params, jax_after)
    got = model.state_dict()
    moms = {n: mod.momentum for n, mod in model.named_modules()
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)}
    assert set(moms) == set(rows), set(moms) ^ set(rows)
    for name, mom in moms.items():
        n = rows[name]
        keep = (1.0 - mom) ** updates
        np.testing.assert_allclose(
            got[f"{name}.running_mean"].numpy(),
            want_after[f"{name}.running_mean"].numpy(), rtol=rtol, atol=atol,
            err_msg=name)
        jax_var = (want_after[f"{name}.running_var"].double()
                   - keep * want_before[f"{name}.running_var"].double())
        expect = (keep * port_before[f"{name}.running_var"].double()
                  + jax_var * n / (n - 1))
        np.testing.assert_allclose(
            got[f"{name}.running_var"].double().numpy(), expect.numpy(),
            rtol=rtol, atol=atol, err_msg=name)
    return len(moms)
