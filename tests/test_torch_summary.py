"""The port's model summary (hcmoco_tpu_torch/utils/summary.py) held
against hcmoco_tpu/utils/summary.py on the CPU: param_table's layout and
count_params (the JAX test's 12 + 4 + 8 case, tests/test_segment_step.py),
count_params against the JAX init's parameter count (jax.eval_shape, no
compile) for HCMoCo W4 and ResNeSt-50, forward_flops against an analytic
2 x multiply-add count, and its ratio to the JAX package's
compiled_flops (XLA's cost analysis, which leaves out a convolution's
taps on padding and counts elementwise work) on a small ResNet, within a
bound around the reading (1.279)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.models.resnet import ResNet as JaxResNet
from hcmoco_tpu.models.resnet import make_resnet as jax_make_resnet
from hcmoco_tpu.utils.summary import compiled_flops
from hcmoco_tpu.utils.summary import count_params as jax_count_params
from hcmoco_tpu.utils.summary import param_table as jax_param_table

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.resnet import ResNet, make_resnet
from hcmoco_tpu_torch.utils.summary import (count_params, forward_flops,
                                            model_summary, param_table)

torch.set_num_threads(1)


def test_param_table_and_count():
    """enc: a (3 -> 4) linear with bias (12 + 4), head: a bias-free (4 ->
    2) one (8): the JAX test's counts, and the JAX table of the same
    names line for line ('/' joins its paths, '.' the port's)."""
    model = nn.Module()
    model.enc = nn.Linear(3, 4)
    model.head = nn.Linear(4, 2, bias=False)
    assert count_params(model) == 12 + 4 + 8
    table = param_table(model)
    assert "TOTAL" in table and "24" in table
    tree = {"enc": {"weight": np.zeros((4, 3)), "bias": np.zeros(4)},
            "head": {"weight": np.zeros((2, 4))}}
    assert jax_count_params(tree) == 24
    assert table == jax_param_table(tree).replace("/", ".")
    assert param_table(model, max_depth=1).splitlines()[1:] == [
        "enc    16", "head   8", "TOTAL  24"]


def _jax_params(model, *args, **kwargs) -> int:
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               train=False, **kwargs))
    return jax_count_params(shapes["params"])


def test_count_params_match_jax_init():
    """HCMoCo W4 (two HRNets, the SemGCN, the heads) and ResNeSt-50,
    whose 25,434,240 are the public ResNeSt-50's 27,483,240 less its
    1000-class fc (2,049,000)."""
    kw = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
              mem="bank", compute_dtype="float32")
    model = build_model(resolve_config(TrainConfig(**kw)), device="cpu")
    jmodel = jax_build_model(jax_resolve(JaxTrainConfig(**kw)))
    want = _jax_params(jmodel, jnp.zeros((1, 32, 32, 6)),
                       jnp.zeros((1, 16, 2)))
    assert count_params(model) == want
    want = _jax_params(jax_make_resnet("resnest50", dtype=jnp.float32),
                       jnp.zeros((1, 64, 64, 3)))
    assert count_params(make_resnet("resnest50")) == want
    assert want == 27483240 - (2048 * 1000 + 1000)


def test_forward_flops_is_two_multiply_adds():
    """A 3x3 pad-1 conv (3 -> 8 channels) at 16^2, bs2, ReLU, and a
    linear (2048 -> 10): 2 x (2 x 16 x 16 x 8 x 3 x 9 + 2 x 2048 x 10);
    the ReLU and the biases count nothing.  The model's training mode is
    restored."""
    model = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                          nn.Flatten(), nn.Linear(8 * 16 * 16, 10))
    model.train()
    got = forward_flops(model, torch.zeros(2, 3, 16, 16))
    assert got == 2 * (2 * 16 * 16 * 8 * 3 * 9 + 2 * 2048 * 10)
    assert model.training
    out = model_summary(model, torch.zeros(2, 3, 16, 16))
    assert out.splitlines()[-1] == f"forward FLOPs: {got / 1e9:.3f} G"
    assert "TOTAL" in out


def test_forward_flops_against_xla_cost_analysis():
    """One bottleneck a stage (double max-pool), 32^2, bs2, eval, f32:
    the port's count over XLA's is 1.279 (reading), held within
    [1.25, 1.31].  The conv taps on padding dominate at this size: a
    3x3 pad-1 conv alone at 8x8 counts 294912 here and 247808 in XLA."""
    jm = JaxResNet(layers=(1, 1, 1, 1), dtype=jnp.float32)
    x = np.zeros((2, 32, 32, 3), np.float32)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(0), x,
                                                  train=False)
    xla = compiled_flops(lambda v, x: jm.apply(v, x, train=False), v, x)
    port = forward_flops(ResNet(layers=(1, 1, 1, 1), dtype=torch.float32),
                         torch.zeros(2, 3, 32, 32))
    assert 1.25 <= port / xla <= 1.31, (port, xla, port / xla)
    conv = nn.Conv2d(8, 16, 3, padding=1, bias=False)
    assert forward_flops(conv, torch.zeros(2, 8, 8, 8)) == 294912
