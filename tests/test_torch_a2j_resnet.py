"""The port's legacy ResNet50 A2J (downstream/a2j/model.py::A2JResNet,
`downstream/a2j/train.py --arch resnet50`) held against hcmoco_tpu's on
the CPU, from the port's seeded weights carried into JAX's float64 trees
(torch_baseline_common.port_to_flax), at 64^2 (maps 32, 16, 8, 4, 4 and
4, so layer3 and layer4 sit at stride 16): its names, heads and
stride-16 grid of 16 anchors a cell, its eval forward in f32, an
Adam/StepLR train step in float64 on both sides (test_torch_a2j.py's
_adam_steps_match_jax), the CLI on synthetic data with an evaluation,
and the refusal of --pretrained_pth (ROADMAP.md Queue 3, F13b), which the
JAX trainer loads into nothing.

Tolerances: test_torch_a2j.py's TOL (rtol 1e-4, atol 1e-5).  The train
step is one Adam step: in a second, an element whose two gradients
nearly cancel in Adam's first moment turns the reference's f32 loss noise
(a2j_loss computes in f32 under x64: 6.3e-7 of the largest gradient of
layer1.0.conv2 here) into a step difference above TOL (2 of 36856 of
that tensor's elements, 2.3e-5).
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.downstream.a2j import anchors as janchors
from hcmoco_tpu.downstream.a2j.model import A2JResNet as JaxA2JResNet

from hcmoco_tpu_torch.core.config import HRNET_CONFIGS
from hcmoco_tpu_torch.downstream.a2j import data, train
from hcmoco_tpu_torch.downstream.a2j.model import A2JResNet
from hcmoco_tpu_torch.export.convert import a2j_flax_to_torch
from hcmoco_tpu_torch.models.hrnet import HRNet

from test_torch_a2j import (CROP, TOL, WIDTH, _adam_steps_match_jax,
                            _small_crop, _t)
from torch_baseline_common import port_to_flax

torch.set_num_threads(1)

RES_CROP = 64


@pytest.fixture(scope="module")
def a2j_resnet_pair():
    """The port's f32 A2JResNet (seeded init, BN statistics moved off
    theirs), JAX's float64 one with the same weights (port_to_flax: exact
    for f32 values), and a seeded (2, 64, 64, 1) depth."""
    torch.manual_seed(0)
    model = A2JResNet(num_classes=15, num_anchors=16, dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.num_features,
                                                generator=gen) - 0.5)
                m.running_var.copy_(torch.rand(m.num_features,
                                               generator=gen) + 0.5)
    jmodel = JaxA2JResNet(num_classes=15, num_anchors=16, dtype=jnp.float64)
    with jax.enable_x64():
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, RES_CROP, RES_CROP, 1),
                                             jnp.float64), train=False))
        v = port_to_flax(model.state_dict(), shapes, a2j_flax_to_torch)
    x = np.random.default_rng(6).standard_normal(
        (2, RES_CROP, RES_CROP, 1)).astype(np.float32)
    return jmodel, v["params"], v["batch_stats"], model, x


def test_a2jresnet_heads_and_stride16_grid(a2j_resnet_pair):
    """The reference's names (Backbone.model.* as torchvision's resnet50,
    without its unused fc), the classification head on layer3's 1024
    channels and the regression and depth heads on layer4's 2048, layer4
    at stride 1 (dilation 2 after its first block), and 16 anchors per
    stride-16 cell: the heads' rows equal the anchor grid's, which equals
    the JAX trainer's."""
    _, _, _, model, _ = a2j_resnet_pair
    sd = model.state_dict()
    assert "Backbone.model.conv1.weight" in sd and not any(
        ".fc." in k for k in sd)
    assert "Backbone.model.layer4.0.downsample.0.weight" in sd
    assert model.Backbone.model.layer4[0].conv2.dilation == (1, 1)
    assert model.Backbone.model.layer4[1].conv2.dilation == (2, 2)
    assert model.Backbone.model.layer4[0].conv2.stride == (1, 1)
    for head, cin, out in (("classificationModel", 1024, 16 * 15),
                           ("regressionModel", 2048, 16 * 15 * 2),
                           ("DepthRegressionModel", 2048, 16 * 15)):
        assert tuple(sd[f"{head}.conv1.weight"].shape) == (256, cin, 3, 3)
        assert tuple(sd[f"{head}.output.weight"].shape) == (out, 256, 3, 3)
    grid = train.a2j_anchors("resnet50", RES_CROP, "cpu")
    want = janchors.shift_anchors((RES_CROP // 16, RES_CROP // 16), 16,
                                  janchors.generate_anchors(None, None))
    np.testing.assert_array_equal(grid.numpy(), want)
    with torch.no_grad():
        cls, reg, dep = model.eval()(torch.zeros(2, 1, RES_CROP, RES_CROP))
    n = (RES_CROP // 16) ** 2 * 16
    assert grid.shape[0] == n
    assert (cls.shape, reg.shape, dep.shape) == (
        (2, n, 15), (2, n, 15, 2), (2, n, 15))


def test_a2jresnet_eval_forward_matches_jax(a2j_resnet_pair):
    """The three heads in eval mode, both sides in f32, at 64^2."""
    jmodel, params, stats, model, x = a2j_resnet_pair
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        {"params": params, "batch_stats": stats})
    want = jax.jit(lambda d: jmodel.clone(dtype=jnp.float32).apply(
        variables, d, train=False))(x)
    with torch.no_grad():
        got = copy.deepcopy(model).eval()(_t(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_a2jresnet_train_step_matches_jax(a2j_resnet_pair):
    """_adam_steps_match_jax on A2JResNet at 64^2 over its stride-16 grid
    (layer3 and layer4's BN over 2 x 4 x 4 rows a channel), one step
    (module docstring)."""
    _adam_steps_match_jax(a2j_resnet_pair,
                          train.a2j_anchors("resnet50", RES_CROP, "cpu"),
                          RES_CROP, steps=1)


def test_cli_resnet50_synthetic_with_eval(tmp_path, capsys, monkeypatch):
    """--arch resnet50 --synthetic 4: two steps, then PCK@10cm on an ITOP
    fixture's test set at crop 32 (2 x 2 cells of 16 anchors)."""
    _small_crop(monkeypatch, CROP)
    _, te, _, bte = data.make_itop_fixture(str(tmp_path / "itop"),
                                           n_train=4, n_test=4)
    run = train.main(["--arch", "resnet50", "--device", "cpu",
                      "--synthetic", "4", "--crop", str(CROP),
                      "--batch_size", "2", "--epochs", "1", "--print_freq",
                      "1", "--test_dir", te, "--bndbox_test", bte])
    out = capsys.readouterr().out
    assert isinstance(run.model, A2JResNet)
    assert len(run.step_s) == 2 and len(run.scores) == 1
    assert all(np.isfinite(m["loss"]) for m in run.metrics)
    assert re.search(r"epoch 1: PCK@10cm \d\.\d+", out)


def test_resnet50_pretrained_pth_raises_naming_f13b(tmp_path):
    """The JAX trainer loads --pretrained_pth through hrnet_torch_to_flax,
    which maps no name of A2JResNet's backbone (its convs are c{k}_conv,
    not conv): from an HRNet export or from the reference resnet50's own
    names it loads 0 conv tensors and trains from scratch.  The port
    refuses the combination, naming F13b."""
    from hcmoco_tpu.export.transfer import hrnet_torch_to_flax

    src = HRNet(HRNET_CONFIGS[WIDTH], 3, torch.float32)
    pth = str(tmp_path / "encoder2.pth")
    torch.save(src.state_dict(), pth)
    with pytest.raises(ValueError, match="F13b"):
        train.main(["--arch", "resnet50", "--device", "cpu", "--synthetic",
                    "4", "--pretrained_pth", pth])
    shapes = jax.eval_shape(lambda: JaxA2JResNet(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    resnet = {k[len("Backbone.model."):]: v.numpy() for k, v in
              A2JResNet(dtype=torch.float32).state_dict().items()
              if k.startswith("Backbone.model.")}
    for sd in ({k: v.numpy() for k, v in src.state_dict().items()}, resnet):
        assert hrnet_torch_to_flax(sd, zeros["params"]["Backbone"],
                                   zeros["batch_stats"]["Backbone"])[2] == 0
