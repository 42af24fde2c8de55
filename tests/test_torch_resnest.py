"""The port's ResNeSt (hcmoco_tpu_torch/models/resnest.py) held against
hcmoco_tpu/models/resnest.py on the CPU, on the same seeded numpy inputs
and the same weights (the JAX package's carried over by
export/convert.py, or the port's carried into flax trees by
torch_baseline_common.port_to_flax).

  * SplAtConv2d at radix 2 (the r-softmax) and radix 1 (the sigmoid
    gate), in training: the output, the input's gradient and the BN
    running statistics, float64 on both sides;
  * a small ResNeSt (one block a stage, ResNeSt-50's stem) at 32^2, whose
    maps are even at every pooling (the avg-down shortcut pools with
    floor in the JAX package and with ceil in the public code, ROADMAP.md
    Queue 3, F13a): its eval forward in f32, and one MoCo and one CMC train step as
    the baselines' encoder through torch_baseline_common.run_family, float64
    on both sides (in f32 a train-mode ResNet at test sizes parts the two
    frameworks by more than the tolerance, torch_baseline_common says by
    how much);
  * make_resnet('resnest50' / 'resnest101' / 'resnest50x2'): every
    parameter and BN statistic's shape against jax.eval_shape of the JAX
    init (no compile), through the converter, loading strict; and the
    --IN_Pretrain load of a ResNeSt state dict by its names.

Tolerances: the eval forward atol 1e-4 (the port's model tests'); the
rest torch_baseline_common's TOL (rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.models import build as jax_build
from hcmoco_tpu.models.resnest import ResNeSt as JaxResNeSt
from hcmoco_tpu.models.resnest import SplAtConv2d as JaxSplAt
from hcmoco_tpu.models.resnet import make_resnet as jax_make_resnet

from hcmoco_tpu_torch.export.convert import _bn, _conv
from hcmoco_tpu_torch.export.transfer import (load_imagenet_pretrained,
                                              resnet_flax_to_torch)
from hcmoco_tpu_torch.models.resnest import ResNeSt, SplAtConv2d
from hcmoco_tpu_torch.models.resnet import make_resnet

from torch_baseline_common import (TOL, bn_passes, check_bn_passes,
                                   port_to_flax, run_family)
from torch_dp_worker import SMALL_RESNEST, small_resnest

torch.set_num_threads(1)


def _f64_model(model: torch.nn.Module) -> torch.nn.Module:
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def splat_flax_to_torch(params, stats) -> dict:
    """A flax SplAtConv2d's trees -> the port's SplAtConv2d names (the two
    share conv, bn0, fc1, bn1, fc2)."""
    out = {}
    for conv in ("conv", "fc1", "fc2"):
        _conv(out, conv, params[conv])
    for bn in ("bn0", "bn1"):
        _bn(out, bn, params[bn], stats[bn])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("radix", [2, 1])
def test_splat_conv_matches_jax(radix):
    """SplAtConv2d(64 -> 64 x radix branches, stride 2) in training on a
    (4, 8, 8, 64) input, float64: the output, the input gradient of
    sum(out * g) and the BN running statistics (the port's unbiased,
    ROADMAP F1).  inter = max(64 * radix // 4, 32)."""
    rng = np.random.default_rng(radix)
    x = rng.standard_normal((4, 8, 8, 64))
    g = rng.standard_normal((4, 4, 4, 64))
    port = SplAtConv2d(64, 64, 3, 2, radix=radix, dtype=torch.float32)
    with torch.no_grad():  # BN away from its init
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    assert port.fc1.out_channels == max(64 * radix // 4, 32)
    jmod = JaxSplAt(64, 3, 2, radix=radix, dtype=jnp.float64)
    with jax.enable_x64():
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64), jnp.float64),
            train=False))
        v = port_to_flax(port.state_dict(), shapes, splat_flax_to_torch)

        def f(x):
            out, mut = jmod.apply(v, x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * g), (out, mut["batch_stats"])

        (_, (want, stats)), dx = jax.jit(jax.value_and_grad(
            f, has_aux=True))(x)
        want, stats, dx = jax.device_get((want, stats, dx))
    port = _f64_model(port).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    with bn_passes(port) as rec:
        out = port(xt)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), dx,
                               **TOL)
    assert check_bn_passes(port, before, splat_flax_to_torch(
        v["params"], v["batch_stats"]), splat_flax_to_torch(
        v["params"], stats), rec) == 2


def test_small_resnest_eval_forward_matches_jax():
    """One block a stage at 32^2 (maps 16, 8, 8, 4, 2, 1), eval mode,
    f32: the pooled (4, 2048) feature, from JAX's initial weights with
    its BN statistics moved off their init."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jmod = JaxResNeSt(dtype=jnp.float32, **SMALL_RESNEST)
    v = jax.jit(jmod.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape)).astype(np.float32), v["batch_stats"])
    port = ResNeSt(dtype=torch.float32, **SMALL_RESNEST)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          resnet_flax_to_torch(v["params"], stats).items()},
                         strict=True)
    want = jax.jit(lambda d: jmod.apply(
        {"params": v["params"], "batch_stats": stats}, d, train=False))(x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (4, 2048) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(method="MoCo", nce_k=16),
                                dict(method="CMC", nce_k=7)],
                         ids=["MoCo", "CMC"])
def test_small_resnest_baseline_step_matches_jax(monkeypatch, kw):
    """One step with the small ResNeSt as the encoder (run_family:
    metrics, parameters after SGD, the BN running statistics of every
    site, SplAt's (B, 1, 1, C) ones included, and MoCo's queue, pointer
    and EMA or CMC's banks; CMC's two encoders take 1 and 2 channels),
    both packages' build_model building arch 'resnest50' as the small
    ResNeSt."""
    make = jax_build.make_resnet

    def jax_small(name, in_channel=3, dtype=jnp.bfloat16):
        if name != "resnest50":
            return make(name, in_channel, dtype)
        return JaxResNeSt(in_channel=in_channel, dtype=dtype,
                          **SMALL_RESNEST)

    monkeypatch.setattr(jax_build, "make_resnet", jax_small)
    with small_resnest():
        out = run_family(dict(kw, arch="resnest50", batch_size=4,
                              epochs=2, compute_dtype="float32"))
    encoders = [m for n, m in out["state"].model.named_children()
                if n.startswith("encoder")]
    assert encoders and all(isinstance(e, ResNeSt) for e in encoders)
    assert np.isfinite(float(out["metrics"]["loss"]))


@pytest.mark.parametrize("arch,stem,feat", [
    ("resnest50", 32, 2048), ("resnest101", 64, 2048),
    ("resnest50x2", 32, 4096)])
def test_make_resnet_shapes_and_strict_load(arch, stem, feat):
    """Every parameter and BN statistic of the port's make_resnet(arch)
    has the shape jax.eval_shape gives the JAX package's, through
    resnet_flax_to_torch, which covers the state dict exactly (strict);
    in_channel reaches the stem (CMC's 1- and 2-channel encoders)."""
    port = make_resnet(arch, in_channel=2, dtype=torch.float32)
    shapes = jax.eval_shape(lambda: jax_make_resnet(
        arch, in_channel=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = resnet_flax_to_torch(zeros["params"], zeros["batch_stats"])
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    assert tuple(port.conv1[0].weight.shape) == (stem, 2, 3, 3)
    assert port.out_channels == feat
    assert tuple(port.layer1[0].conv2.fc1.weight.shape) == (
        32 if feat == 2048 else 64, 64 * feat // 2048, 1, 1)


def test_in_pretrain_loads_a_resnest_by_name(tmp_path):
    """--IN_Pretrain into a ResNeSt encoder: every conv (weights, and
    fc1/fc2's biases) and BN of a ResNeSt-50 state dict under the public
    code's names; the JAX package's HRNet-name loader maps none of them
    into its ResNeSt (it has no ResNeSt names)."""
    from hcmoco_tpu.export.transfer import hrnet_torch_to_flax

    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
    from hcmoco_tpu_torch.models.build import build_model

    torch.manual_seed(1)
    src = make_resnet("resnest50", dtype=torch.float32)
    path = str(tmp_path / "resnest50.pth")
    torch.save(src.state_dict(), path)
    cfg = resolve_config(TrainConfig(method="MoCo", arch="resnest50"))
    torch.manual_seed(2)
    model = build_model(cfg, device="cpu")
    n = load_imagenet_pretrained(path, model, encoder_names=("encoder",))
    convs = sum(1 for m in src.modules() if isinstance(m, torch.nn.Conv2d))
    assert n == convs
    got = model.encoder.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    shapes = jax.eval_shape(lambda: jax_make_resnet(
        "resnest50", dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    assert hrnet_torch_to_flax(sd, zeros["params"],
                               zeros["batch_stats"])[2] == 0
