"""The port's non-local SemGCN blocks (hcmoco_tpu_torch/models/sgcn.py:
GraphNonLocal, group_orders, GroupedNonLocal, SemGCN(nodes_group=...))
held against hcmoco_tpu/models/sgcn.py on the CPU, on the same seeded
numpy inputs and weights (the port's carried into flax trees by
torch_baseline_common.port_to_flax through export/convert.py's
converters).

The block's output BN starts with a zero scale (a zero W without BN), so
at init it is the identity and a comparison there proves nothing: every
comparison carries a nonzero W_bn scale (and W) into both packages.

  * GraphNonLocal at sub_sample 1 and 2, bn_layer True and False, in
    training, float64: the output, the input's gradient, W_bn's running
    statistics (the port's unbiased, ROADMAP F1);
  * group_orders against the JAX package's;
  * SemGCN(128, 2, 'mpii', nodes_group=SemGCN's Human3.6M pairs) in
    training and in eval, f32 (SemGraphConv computes in f32): the output,
    the input's gradient and every BN's running statistics;
  * the block and the grouped SemGCN are the identity / the plain path at
    init, and nodes_group=None keeps the plain SemGCN's state-dict keys.

Tolerances: float64 rtol 1e-4 / atol 1e-5 (torch_baseline_common's TOL);
f32 atol 1e-4 (the port's SemGCN test, tests/test_torch_models.py) and
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.models.sgcn import GraphNonLocal as JaxGraphNonLocal
from hcmoco_tpu.models.sgcn import SemGCN as JaxSemGCN
from hcmoco_tpu.models.sgcn import group_orders as jax_group_orders

from hcmoco_tpu_torch.export.convert import (nonlocal_flax_to_torch,
                                             sgcn_flax_to_torch)
from hcmoco_tpu_torch.models.sgcn import (GraphNonLocal, GroupedNonLocal,
                                          SemGCN, group_orders)

from torch_baseline_common import (TOL, bn_passes, check_bn_passes,
                                   port_to_flax)

torch.set_num_threads(1)

# SemGCN's Human3.6M joint pairs (16 joints, groups of 2)
GROUPS = ((2, 3), (5, 6), (1, 4), (0, 7), (8, 9), (14, 15), (11, 12),
          (10, 13))
F32 = dict(rtol=1e-4, atol=1e-4)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _nonzero_w(model: torch.nn.Module, seed: int) -> None:
    """Every non-local block's W (its conv, and W_bn's scale and bias)
    drawn away from the zero init, BN statistics off theirs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GraphNonLocal):
                for p in m.W.parameters():
                    p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.rand(m.num_features,
                                                generator=gen) - 0.5)
                m.running_var.copy_(torch.rand(m.num_features,
                                               generator=gen) + 0.5)


@pytest.mark.parametrize("sub_sample", [1, 2])
@pytest.mark.parametrize("bn_layer", [True, False])
def test_graph_non_local_matches_jax(sub_sample, bn_layer):
    """(4, 16, 24) joints, ic = 12, training, float64."""
    rng = np.random.default_rng(sub_sample + 2 * bn_layer)
    x = rng.standard_normal((4, 16, 24))
    g = rng.standard_normal((4, 16, 24))
    torch.manual_seed(0)
    port = GraphNonLocal(24, sub_sample=sub_sample, bn_layer=bn_layer)
    _nonzero_w(port, 1)
    jmod = JaxGraphNonLocal(sub_sample=sub_sample, bn_layer=bn_layer)

    def convert(p, s):
        return _tensors(nonlocal_flax_to_torch(p, s, "", sub_sample > 1))

    with jax.enable_x64():
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 24), jnp.float64),
            train=False))
        v = port_to_flax(port.state_dict(), shapes, convert)

        def f(x):
            out, mut = jmod.apply(v, x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * g), (out, mut["batch_stats"])

        (_, (want, stats)), dx = jax.device_get(jax.jit(jax.value_and_grad(
            f, has_aux=True))(x))
    port.double().train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with bn_passes(port) as rec:
        out = port(xt)
    (out * torch.from_numpy(g)).sum().backward()
    assert not torch.allclose(out, xt)  # W carries the block
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), dx, **TOL)
    if bn_layer:
        assert check_bn_passes(port, before, convert(
            v["params"], v["batch_stats"]), convert(v["params"], stats),
            rec) == 1
    else:
        assert "W.1.weight" not in port.state_dict()


def test_group_orders_match_jax():
    for groups in (GROUPS, ((0, 1, 2), (5, 4, 3)), ((3, 1), (0, 2))):
        assert group_orders(groups) == jax_group_orders(groups)
        grouped, restored = group_orders(groups)
        assert [grouped[i] for i in restored] == list(range(len(grouped)))


def _grouped_pair(seed: int):
    """JAX's grouped SemGCN(128, 2) from its init, with every non-local
    block's W_bn scale and bias drawn away from zero and every BN's
    statistics off their init, and the port's loaded from the same trees
    (strict).  (The SemGCN converter shifts the graph convs' bias by a
    constant, so the ids of port_to_flax cannot cross it.)"""
    jm = JaxSemGCN(128, 2, "mpii", nodes_group=GROUPS)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 2)), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.array, v["params"])
    for name in ("nl_input", "nl0", "nl1"):
        for k in ("scale", "bias"):
            a = params[name]["nonlocal"]["W_bn"][k]
            a[...] = rng.uniform(-0.5, 0.5, a.shape)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape)).astype(np.float32), v["batch_stats"])
    model = SemGCN(128, 2, "mpii", nodes_group=GROUPS)
    model.load_state_dict(_tensors(sgcn_flax_to_torch(params, stats)),
                          strict=True)
    return model, jm, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_grouped_sem_gcn_matches_jax(mode):
    """bs8 MPII joints through the grouped SemGCN: output, input gradient
    of sum(out * g), and in training every BN's running statistics (the
    graph convs' and the non-local blocks' W_bn)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 16, 2)).astype(np.float32)
    g = rng.standard_normal((8, 16, 128)).astype(np.float32)
    model, jm, v = _grouped_pair(3)
    train = mode == "train"

    def f(x):
        if train:
            out, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
            stats = mut["batch_stats"]
        else:
            out, stats = jm.apply(v, x, train=False), v["batch_stats"]
        return jnp.sum(out * g), (out, stats)

    (_, (want, stats)), dx = jax.device_get(jax.jit(jax.value_and_grad(
        f, has_aux=True))(x))
    model.train(train)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with bn_passes(model) as rec:
        out = model(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **F32)
    np.testing.assert_allclose(xt.grad.numpy(), dx, **F32)
    if train:
        conv = lambda s: _tensors(sgcn_flax_to_torch(v["params"], s))
        # the input block's BN, 2 in each of 2 residual blocks, and the 3
        # non-local blocks' W_bn
        assert check_bn_passes(model, before, conv(v["batch_stats"]),
                               conv(stats), rec, tol=F32) == 1 + 2 * 2 + 3
    else:
        assert not rec


def test_identity_at_init_and_plain_keys():
    """At init every grouped non-local block returns its input (W_bn's zero
    scale; W's zero weight without BN) in training and in eval; the
    grouped SemGCN's blocks sit at gconv_input.1 and gconv_layers.{1, 3},
    and nodes_group=None keeps the plain SemGCN's keys."""
    x = torch.randn(8, 16, 128)
    block = GroupedNonLocal(128, GROUPS)
    for train in (True, False):
        assert torch.equal(block.train(train)(x), x)
    assert torch.equal(GraphNonLocal(128, bn_layer=False)(x), x)
    grouped = SemGCN(128, 2, "mpii", nodes_group=GROUPS).state_dict()
    plain = SemGCN(128, 2, "mpii").state_dict()
    extra = {k.split(".non_local.")[0] for k in grouped
             if ".non_local." in k}
    assert extra == {"gconv_input.1", "gconv_layers.1", "gconv_layers.3"}
    renamed = {k.replace("gconv_layers.2.", "gconv_layers.1.")
               for k in grouped if ".non_local." not in k}
    assert renamed == set(plain)
    assert "gconv_input.1.non_local.concat_project.0.weight" in grouped
    assert "gconv_layers.1.non_local.g.0.weight" in grouped
