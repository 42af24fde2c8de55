"""The port's own copy of the JAX package's HRNet name tables
(hcmoco_tpu_torch/export/transfer.py) against the original
(hcmoco_tpu/export/transfer.py): the same torch-named dict, key for key
and array for array, from the W4 and the W18 HRNet trees; and the stage-2
trees of both models through flax_to_port_state_dict."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.core.config import HRNET_TINY as JAX_HRNET_TINY
from hcmoco_tpu.core.config import HRNET_W18 as JAX_HRNET_W18
from hcmoco_tpu.export import transfer as jax_transfer
from hcmoco_tpu.models.build import HCMoCoModel as JaxHCMoCo
from hcmoco_tpu.models.hrnet import HRNet as JaxHRNet
from hcmoco_tpu.models.pointnet2_model import HCMoCoPNModel as JaxPN

from hcmoco_tpu_torch.export import transfer
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.models.pointnet2_model import HCMoCoPNModel

from parity_common import read_keys_file

KEYS_W18 = os.path.join(os.path.dirname(__file__), "golden",
                        "hcmoco_w18_torch_keys.txt")


def _trees(tree):
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("hr_cfg", [JAX_HRNET_TINY, JAX_HRNET_W18],
                         ids=["w4", "w18"])
def test_hrnet_flax_to_torch_matches_jax_package(hr_cfg):
    shapes = jax.eval_shape(lambda: JaxHRNet(hr_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = jax_transfer.hrnet_flax_to_torch(tree["params"],
                                            tree["batch_stats"])
    got = transfer.hrnet_flax_to_torch(tree["params"], tree["batch_stats"])
    assert list(got) == list(want)
    assert len(got) > 100
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _random_tree(init):
    """Random numpy arrays in the shape of a flax init's variables."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_stage2_hrnet_tree_keeps_the_reference_layout():
    """A W18 HCMoCoModel tree with the stage-2 heads converts to exactly
    the reference checkpoint's keys and shapes: the stage-1 layout plus
    encoder{1,2}_linear's weight and bias."""
    def tree(return_fm):
        m = JaxHCMoCo(width=18, linear_feat_map=True)
        return _random_tree(lambda: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)),
            jnp.zeros((1, 16, 2)), train=False, return_fm=return_fm))

    s1 = flax_to_port_state_dict(**_trees(tree(False)))
    s2 = flax_to_port_state_dict(**_trees(tree(True)))
    heads = {f"encoder{i}_linear.{p}" for i in (1, 2)
             for p in ("weight", "bias")}
    assert set(s2) - set(s1) == heads and set(s1) <= set(s2)
    want = dict(read_keys_file(KEYS_W18))
    assert len(s2) == len(want) == 3745
    assert {k: tuple(v.shape) for k, v in s2.items()} == want


def test_stage2_hrnetpn_tree_loads_strict():
    """HCMoCoPNModel's stage-2 tree: encoder2_linear is a SharedMLP
    (dense0/bn0), carried to layer0.conv / layer0.bn.bn; the port's model
    loads the whole dict with strict=True."""
    m = JaxPN(width=4, linear_feat_map=True, n_points=64, dtype=jnp.float32)
    b = 2
    tree = _random_tree(lambda: m.init(
        {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)},
        jnp.zeros((b, 32, 32, 6)), jnp.zeros((b, 16, 2)),
        jnp.ones((b, 32, 32)), jnp.zeros((b, 32, 32, 2)), 424.0, 512.0,
        jnp.ones((b,)), train=True, return_fm=True))
    sd = flax_to_port_state_dict(**_trees(tree))
    model = HCMoCoPNModel(width=4, linear_feat_map=True, n_points=64,
                          dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    head = tree["params"]["encoder2_linear"]
    stats = tree["batch_stats"]["encoder2_linear"]
    np.testing.assert_array_equal(
        model.encoder2_linear.layer0.conv.weight.detach().numpy(),
        head["dense0"]["kernel"].T[:, :, None, None])
    bn = model.encoder2_linear.layer0.bn.bn
    for got, want in ((bn.weight, head["bn0"]["scale"]),
                      (bn.bias, head["bn0"]["bias"]),
                      (bn.running_mean, stats["bn0"]["mean"]),
                      (bn.running_var, stats["bn0"]["var"])):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(
        model.encoder1_linear.weight.detach().numpy(),
        np.transpose(tree["params"]["encoder1_linear"]["kernel"],
                     (3, 2, 0, 1)))
