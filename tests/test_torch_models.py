"""hcmoco_tpu_torch models held against hcmoco_tpu's, in f32 on the CPU.

Same numpy inputs and the JAX package's initialised weights (carried over
with flax_to_port_state_dict) on both sides, train mode, with and without
HCMOCO_CONVBN_FUSE=1.  JAX's fused ConvBN runs its Pallas kernel in
interpret mode, as tests/test_models.py does.

Tolerance: atol 1e-4 on pooled and projected features and on BN
statistics; the two frameworks' f32 convolutions sum in different orders,
and train-mode BN over a few rows (the tiny HRNet's 32x-downsampled branch
is 1x1 at crop 32) amplifies that rounding.  The raw HRNet maps (|v| up to
~11) get atol 2e-4: at these inputs each framework's f32 maps lie up to
8e-5 from the port run in f64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.core.config import HRNET_TINY as JAX_HRNET_TINY
from hcmoco_tpu.core.config import HRNET_W18 as JAX_HRNET_W18
from hcmoco_tpu.export.transfer import hrnet_flax_to_torch
from hcmoco_tpu.models.build import HCMoCoModel as JaxHCMoCo
from hcmoco_tpu.models.heads import ProjectionHead as JaxProjectionHead
from hcmoco_tpu.models.hrnet import ConvBN as JaxConvBN
from hcmoco_tpu.models.hrnet import HRNet as JaxHRNet
from hcmoco_tpu.models.sgcn import SemGCN as JaxSemGCN

from hcmoco_tpu_torch.core.config import HRNET_TINY, HRNET_W18
from hcmoco_tpu_torch.export.convert import (flax_to_port_state_dict,
                                             head_flax_to_torch,
                                             sgcn_flax_to_torch)
from hcmoco_tpu_torch.models.build import HCMoCoModel
from hcmoco_tpu_torch.models.heads import ProjectionHead
from hcmoco_tpu_torch.models import hrnet as hrnet_mod
from hcmoco_tpu_torch.models.hrnet import (ConvBN, HRNet, fused_sites,
                                           set_convbn_fuse)
from hcmoco_tpu_torch.models.sgcn import SemGCN

from parity_common import read_keys_file, synth_state_dict
from torch_parity_common import bn_rows, check_bn_stats

torch.set_num_threads(1)

ATOL = 1e-4
MAP_ATOL = 2e-4
BSZ, CROP = 4, 32


def _fuse(monkeypatch, on: bool):
    if on:
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1")
    else:
        monkeypatch.delenv("HCMOCO_CONVBN_FUSE", raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


class TestConvBNFuse:
    """Mirror of tests/test_models.py::TestConvBNFuse on the port: the fused
    1x1 site equals the plain conv + BatchNorm site in forward, running
    stats and grads."""

    def _run(self, monkeypatch, fuse: bool, kernel: int = 1):
        _fuse(monkeypatch, fuse)
        torch.manual_seed(0)
        cb = ConvBN(12, 20, kernel, 1, True, torch.float32).train()
        g = torch.Generator().manual_seed(2)
        x = (torch.randn((2, 12, 8, 8), generator=g) * 1.5 + 0.3)
        x.requires_grad_(True)
        y = cb(x)
        (y * y).sum().backward()
        grads = [p.grad.clone() for p in cb.parameters()] + [x.grad.clone()]
        return y.detach(), cb.state_dict(), grads

    def test_fused_matches_unfused(self, monkeypatch):
        y0, s0, g0 = self._run(monkeypatch, fuse=False)
        y1, s1, g1 = self._run(monkeypatch, fuse=True)
        np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-5,
                                   atol=2e-5)
        assert s0.keys() == s1.keys()
        for k in s0:
            np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-4,
                                       atol=5e-5)

    def test_3x3_sites_unaffected(self, monkeypatch):
        y0, _, _ = self._run(monkeypatch, fuse=False, kernel=3)
        y1, _, _ = self._run(monkeypatch, fuse=True, kernel=3)
        np.testing.assert_array_equal(y1.numpy(), y0.numpy())

    @pytest.mark.parametrize("fuse", [False, True])
    def test_matches_jax_convbn(self, monkeypatch, fuse):
        """One 1x1 site vs the JAX ConvBN, both in train mode."""
        _fuse(monkeypatch, fuse)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 6, 5, 12)).astype(np.float32) + 0.2
        jcb = JaxConvBN(20, 1, 1, use_relu=True, dtype=jnp.float32)
        v = jcb.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
        jy, mut = jcb.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        cb = ConvBN(12, 20, 1, 1, True, torch.float32).train()
        kern = np.asarray(v["params"]["conv"]["kernel"])
        cb.load_state_dict(_tensors({
            "0.weight": np.transpose(kern, (3, 2, 0, 1)),
            "1.weight": v["params"]["bn"]["scale"],
            "1.bias": v["params"]["bn"]["bias"],
            "1.running_mean": v["batch_stats"]["bn"]["mean"],
            "1.running_var": v["batch_stats"]["bn"]["var"],
            "1.num_batches_tracked": np.asarray(0)}))
        y = cb(_nchw(x))
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jy), atol=1e-5, rtol=1e-5)
        n = 3 * 6 * 5
        np.testing.assert_allclose(
            cb[1].running_mean.numpy(),
            np.asarray(mut["batch_stats"]["bn"]["mean"]), atol=1e-6)
        jvar = np.asarray(mut["batch_stats"]["bn"]["var"])
        np.testing.assert_allclose(
            cb[1].running_var.numpy(),
            0.99 + (jvar - 0.99) * n / (n - 1), atol=1e-6)


class TestFuseSwitch:
    """HCMOCO_CONVBN_FUSE is read when a model is built, and only then;
    set_convbn_fuse switches a built model.  Counted: the fused sites a
    train forward routes through conv1x1_bn_stats."""

    @pytest.mark.parametrize("env,switch,train,want", [
        ("0", None, True, False), ("1", None, True, True),
        ("0", True, True, True), ("1", False, True, False),
        ("1", None, False, False)])
    def test_switch(self, monkeypatch, env, switch, train, want):
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", env)
        model = HRNet(HRNET_TINY, 3, torch.float32)
        # a later change of the variable does not reach the built model
        monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1" if env == "0" else "0")
        if switch is not None:
            assert set_convbn_fuse(model, switch) is model
        calls = []
        real = hrnet_mod.conv1x1_bn_stats
        monkeypatch.setattr(hrnet_mod, "conv1x1_bn_stats",
                            lambda *a: calls.append(1) or real(*a))
        x = torch.randn((2, 3, 32, 32),
                        generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.train(train)(x)
        assert len(calls) == (fused_sites(model) if want else 0)
        assert fused_sites(model) == 13  # 3 in layer1, 1+3+6 fuse layers


@pytest.fixture(scope="module")
def tiny_inputs():
    rng = np.random.default_rng(0)
    rgbd = (rng.standard_normal((BSZ, CROP, CROP, 6)) * 0.5).astype(
        np.float32)
    skel = rng.uniform(-1, 1, (BSZ, 16, 2)).astype(np.float32)
    return rgbd, skel


class TestHRNet:
    @pytest.mark.parametrize("fuse", [False, True])
    def test_train_forward_matches_jax(self, monkeypatch, tiny_inputs,
                                       fuse):
        _fuse(monkeypatch, fuse)
        x = tiny_inputs[0][..., :3]
        jm = JaxHRNet(JAX_HRNET_TINY, dtype=jnp.float32)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
        jout, mut = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        model = HRNet(HRNET_TINY, 3, torch.float32)
        model.load_state_dict(
            _tensors(hrnet_flax_to_torch(v["params"], v["batch_stats"])))
        before = {k: t.clone() for k, t in model.state_dict().items()}
        rows = bn_rows(model, _nchw(x))
        out = model.train()(_nchw(x))
        assert len(out) == 4
        for a, b in zip(out, jout):
            np.testing.assert_allclose(a.detach().permute(0, 2, 3, 1),
                                       np.asarray(b), atol=MAP_ATOL)
        got = _tensors(hrnet_flax_to_torch(v["params"], mut["batch_stats"]))
        want0 = _tensors(hrnet_flax_to_torch(v["params"], v["batch_stats"]))
        sd = model.state_dict()
        for k in sd:
            if k.endswith("running_mean"):
                np.testing.assert_allclose(sd[k], got[k], atol=ATOL,
                                           err_msg=k)
            elif k.endswith("running_var"):
                n = rows[k[:-len(".running_var")]]
                expect = (0.99 * before[k]
                          + (got[k] - 0.99 * want0[k]) * n / (n - 1))
                np.testing.assert_allclose(sd[k], expect, atol=ATOL,
                                           err_msg=k)

    def test_w18_fused_site_count_matches_jax(self):
        """HCMOCO_CONVBN_FUSE=1 routes exactly the JAX package's 1x1 conv
        sites through K1: 40 per W18 encoder (9 in layer1, 1+12+18 fuse
        layers), 80 launches per step for the two encoders."""
        shapes = jax.eval_shape(
            lambda: JaxHRNet(JAX_HRNET_W18).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                train=False))
        n_jax = sum(1 for p in jax.tree_util.tree_leaves(shapes["params"])
                    if p.ndim == 4 and p.shape[:2] == (1, 1))
        with torch.device("meta"):
            port = HRNet(HRNET_W18)
        assert fused_sites(port) == n_jax == 40


class TestSemGCN:
    def test_train_forward_matches_jax(self, tiny_inputs):
        skel = tiny_inputs[1]
        jm = JaxSemGCN(128, 4, "mpii")
        v = jm.init(jax.random.PRNGKey(3), jnp.asarray(skel[:1]),
                    train=False)
        # non-trivial edge weights and biases
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
                np.float32) * 0.1, v["params"])
        jout, mut = jm.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(skel), train=True,
                             mutable=["batch_stats"])
        model = SemGCN(128, 4, "mpii")
        model.load_state_dict(
            _tensors(sgcn_flax_to_torch(params, v["batch_stats"])))
        before = {k: t.clone() for k, t in model.state_dict().items()}
        out = model.train()(_t(skel))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   atol=ATOL)
        got = _tensors(sgcn_flax_to_torch(params, mut["batch_stats"]))
        want0 = _tensors(sgcn_flax_to_torch(params, v["batch_stats"]))
        n = BSZ * 16
        sd = model.state_dict()
        for k in sd:
            if k.endswith("running_mean"):
                np.testing.assert_allclose(sd[k], got[k], atol=ATOL)
            elif k.endswith("running_var"):
                expect = (0.9 * before[k]
                          + (got[k] - 0.9 * want0[k]) * n / (n - 1))
                np.testing.assert_allclose(sd[k], expect, atol=ATOL)


@pytest.mark.parametrize("head", ["linear", "mlp"])
def test_projection_head_matches_jax(head):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    jh = JaxProjectionHead(16, head)
    v = jh.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ph = ProjectionHead(24, 16, head)
    ph.load_state_dict(_tensors(head_flax_to_torch(v["params"])),
                       strict=True)
    out = ph(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jh.apply(v, jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(out.norm(dim=-1).detach().numpy(), 1.0,
                               rtol=1e-6)


class TestHCMoCoModel:
    @pytest.mark.parametrize("fuse", [False, True])
    def test_train_forward_matches_jax(self, monkeypatch, tiny_inputs,
                                       fuse):
        _fuse(monkeypatch, fuse)
        rgbd, skel = tiny_inputs
        jm = JaxHCMoCo(width=4, dtype=jnp.float32)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(rgbd[:1]),
                    jnp.asarray(skel[:1]), train=False)
        jout, mut = jm.apply(v, jnp.asarray(rgbd), jnp.asarray(skel),
                             train=True, mutable=["batch_stats"])
        model = HCMoCoModel(width=4, dtype=torch.float32)
        model.load_state_dict(
            flax_to_port_state_dict(v["params"], v["batch_stats"]),
            strict=True)
        before = {k: t.clone() for k, t in model.state_dict().items()}
        inputs = (_nchw(rgbd), _t(skel))
        rows = bn_rows(model, *inputs)
        out = model.train()(*inputs)
        for key in ("pooled1", "pooled2", "pooled3", "feat1", "feat2",
                    "feat3"):
            np.testing.assert_allclose(out[key].detach().numpy(),
                                       np.asarray(jout[key]), atol=ATOL,
                                       err_msg=key)
        n_bn = check_bn_stats(model, before, v["params"], v["batch_stats"],
                              mut["batch_stats"], rows, atol=ATOL)
        assert n_bn > 100

    def test_w18_loads_reference_keys_strict(self):
        keys = read_keys_file(os.path.join(
            os.path.dirname(__file__), "golden", "hcmoco_w18_torch_keys.txt"))
        sd = {k: torch.from_numpy(v).to(
            torch.long if k.endswith("num_batches_tracked") else torch.float32)
            for k, v in synth_state_dict(keys).items()}
        model = HCMoCoModel(width=18, linear_feat_map=True)
        model.load_state_dict(sd, strict=True)
        assert len(model.state_dict()) == len(keys) == 3745
        np.testing.assert_array_equal(
            model.encoder1.conv1.weight.detach().numpy(),
            sd["encoder1.conv1.weight"].numpy())


@pytest.mark.parametrize("arch", ["HRNet", "HRNetPN"])
def test_build_model_defaults_to_the_card(monkeypatch, arch):
    """With no device given build_model places the model on CUDA, and
    raises when CUDA is hidden; the CPU is used only when asked for."""
    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
    from hcmoco_tpu_torch.models.build import build_model

    cfg = resolve_config(TrainConfig(method="Customize", modal="RGBD2S",
                                     arch=arch, width=4, mem="bank",
                                     compute_dtype="float32",
                                     pn_num_points=64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
