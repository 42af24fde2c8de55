"""The port's own copy of the JAX package's HRNet name tables
(hcmoco_tpu_torch/export/transfer.py) against the original
(hcmoco_tpu/export/transfer.py): the same torch-named dict, key for key
and array for array, from the W4 and the W18 HRNet trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmoco_tpu.core.config import HRNET_TINY as JAX_HRNET_TINY
from hcmoco_tpu.core.config import HRNET_W18 as JAX_HRNET_W18
from hcmoco_tpu.export import transfer as jax_transfer
from hcmoco_tpu.models.hrnet import HRNet as JaxHRNet

from hcmoco_tpu_torch.export import transfer


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
