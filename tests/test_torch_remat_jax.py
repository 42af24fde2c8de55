"""The port's recomputing train steps (train/remat.py) against the JAX
package's on the CPU at tiny size: TrainConfig.remat under both
remat_policy values against JAX's jax.checkpoint step, and pn_remat
against JAX's nn.remat of SA levels 0 and 1, through the comparisons of
tests/test_torch_train_step.py and tests/test_torch_pn_train_step.py at
their tolerances.  tests/test_torch_remat.py holds the same steps to the
port's own without recomputation, bit for bit.
"""

import pytest
import torch

import test_torch_pn_train_step as pn_step
import test_torch_train_step as hr_step

torch.set_num_threads(1)


@pytest.mark.parametrize("fuse,policy", [(True, "conv_out"),
                                         (False, "dots")])
def test_remat_matches_jax(monkeypatch, fuse, policy):
    """The port's remat step against JAX's remat=True step
    (jax.checkpoint under the same policy), as
    test_torch_train_step.py holds the step without it."""
    hr_step.two_steps_match_jax(monkeypatch, fuse, remat=True,
                                remat_policy=policy)


def test_pn_remat_matches_jax(monkeypatch):
    """The port's pn_remat step against JAX's pn_remat=True step, as
    test_torch_pn_train_step.py holds the step without it."""
    pn_step.two_steps_match_jax(monkeypatch, pn_remat=True)
