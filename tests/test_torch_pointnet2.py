"""The port's PointNet++ MSG encoder, depth2pts and HRNetPN model held
against hcmoco_tpu's (its XLA point ops; the Pallas ones are held against
the port's in tests/test_torch_point_ops.py).

SharedMLP, SAModuleMSG, FPModule and Pointnet2MSG are compared in float64:
JAX under jax.enable_x64 with dtype float64, the port's modules in
float64, both from the same weights.  The geometry (FPS, ball query,
three-NN, the interpolation weights) stays f32 on both sides, so both take
the same indices.  Why not f32: at these sizes the encoder is
ill-conditioned.  Its first layer sees (W x_k) - (W c), differences much
smaller than the terms at the 0.025 radius, and every BN divides by a
batch variance that a few rows dominate, so a 1e-7 relative change of the
input points moves its output and gradients by orders of magnitude more
than 1e-7, and f32 rounding alike (test_pointnet2_f32_is_ill_conditioned
measures both).  Two f32 implementations then part by far more than their
rounding.  In f64 the two agree to flax's f32 BN reductions and f32
parameter gradients: outputs, gradients and BN running statistics within
1e-5 of each tensor's largest magnitude (the whole encoder's gradients
within 1e-4), the running variance after torch's unbiased n/(n-1)
(ROADMAP.md Queue 3 F1).

depth2pts and HCMoCoPNModel are compared in f32, as the train step runs:
depth2pts exactly, from the same pinned uniforms; the model's pooled and
projected features within 1e-4 of the largest magnitude for the HRNet and
SemGCN branches (as the HRNet model's tests) and within 2e-3 for the
PointNet++ branch, whose f32 conditioning is described above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu.models import pointnet2_model as jpn
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.ops import point_ops as jax_ops

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import (flax_to_port_state_dict,
                                             pointnet2_flax_to_torch)
from hcmoco_tpu_torch.models import pointnet2_model as pn
from hcmoco_tpu_torch.models.build import build_model

from torch_parity_common import bn_rows

torch.set_num_threads(1)

F64 = 1e-5


def close(got, want, rel=F64, what=""):
    """Within `rel` of want's largest magnitude."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, b, n, side=0.3):
    """(b, n, 3) f32 points in a cube; the last sample an all-zero cloud."""
    c = ((rng.random((b, n, 3)) - 0.5) * side).astype(np.float32)
    c[-1] = 0.0
    return c


def _jax_train(module, variables):
    """run(params, *args) -> (output, new batch stats): a train-mode apply
    of `module` from `variables`' batch stats."""
    def run(params, *xs, **kw):
        return module.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            *xs, mutable=["batch_stats"], **kw)
    return run


def _port_names(tree_params, tree_stats, wrap):
    """A module-level flax tree -> the port's names, through
    pointnet2_flax_to_torch with the tree wrapped as sa0 or fp0's mlp."""
    if wrap == "sa":
        sd = pointnet2_flax_to_torch({"sa0": tree_params},
                                     {"sa0": tree_stats})
        prefix = "SA_modules.0."
    else:
        sd = pointnet2_flax_to_torch({"fp0": {"mlp": tree_params}},
                                     {"fp0": {"mlp": tree_stats}})
        prefix = "FP_modules.0.mlp."
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in sd.items()}


def _check_bn(module, before, after_sd, rows, keep=0.9):
    """The port module's running stats against JAX's after one train
    forward from the same initial stats `before` (port names)."""
    got = module.state_dict()
    for name, n in rows.items():
        close(got[f"{name}.running_mean"], after_sd[f"{name}.running_mean"],
              what=name)
        jax_var = (after_sd[f"{name}.running_var"].double()
                   - keep * before[f"{name}.running_var"].double())
        close(got[f"{name}.running_var"],
              keep * before[f"{name}.running_var"].double()
              + jax_var * n / (n - 1), what=name)


def _grads_close(port_module, jax_grads, stats, wrap):
    """Parameter gradients; `stats` (any batch stats) completes the tree."""
    want = _port_names(jax_grads, stats, wrap)
    for name, p in port_module.named_parameters():
        close(p.grad, want[name], what=name)


# ---- modules in float64 ------------------------------------------------------


@pytest.mark.parametrize("grouped", [False, True])
def test_shared_mlp_matches_jax(grouped):
    """Plain (FP-style, rows of features) and project-then-group with the
    center term (SA-style: a (B, N, 3+C) table, ball-query indices)."""
    rng = np.random.default_rng(0)
    b, n, c = 3, 64, 6
    xyz = _cloud(rng, b, n)
    feats = rng.standard_normal((b, n, c))
    x = np.concatenate([xyz.astype(np.float64), feats], -1)
    kw = {}
    if grouped:
        centers = np.ascontiguousarray(xyz[:, ::4])
        gidx = np.asarray(jax_ops.ball_query(jnp.asarray(xyz),
                                             jnp.asarray(centers), 0.1, 8))
        kw = dict(gidx=gidx, center=centers)
        cot = rng.standard_normal((b, n // 4, 8, 32))
    else:
        cot = rng.standard_normal((b, n, 32))
    with jax.enable_x64():
        jm = jpn.SharedMLP((16, 32), dtype=jnp.float64)
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True, **jkw)
        run = _jax_train(jm, v)

        def loss(params, xx):
            out, st = run(params, xx, True, **jkw)
            return jnp.sum(out * cot), (out, st)
        (_, (jout, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
        jout, jgx = np.asarray(jout), np.asarray(jgx)
    m = pn.SharedMLP((3 + c, 16, 32), torch.float64)
    m.load_state_dict(_port_names(v["params"], v["batch_stats"], "fp"),
                      strict=True)
    m.double()
    before = {k: t.clone() for k, t in m.state_dict().items()}
    rows = bn_rows(m, _t(x), *[_t(a) for a in kw.values()])
    xt = _t(x).requires_grad_()
    out = m(xt, *[_t(a) for a in kw.values()])
    (out * _t(cot)).sum().backward()
    close(out.detach(), jout)
    close(xt.grad, jgx)
    _grads_close(m, jgp, v["batch_stats"], "fp")
    _check_bn(m, before, _port_names(v["params"], jst["batch_stats"], "fp"),
              rows)


@pytest.mark.parametrize("level", [0, 1])
def test_sa_module_matches_jax(level):
    """SA0's shape (xyz only, npoint == N: the identity shortcut) and SA1's
    (features, FPS centers sorted ascending), radii and MLPs of the
    encoder's first two levels."""
    rng = np.random.default_rng(1)
    b, n = 3, 128
    xyz = _cloud(rng, b, n)
    npoint = n if level == 0 else n // 4
    cin = 0 if level == 0 else 32
    feats = rng.standard_normal((b, n, cin)) if cin else None
    width = sum(m[-1] for m in pn.MLPS[level])
    cot = rng.standard_normal((b, npoint, width))
    with jax.enable_x64():
        jm = jpn.SAModuleMSG(npoint=npoint, radii=pn.RADIUS[level],
                             nsamples=pn.NSAMPLE[level],
                             mlps=pn.MLPS[level], dtype=jnp.float64)
        jf = None if feats is None else jnp.asarray(feats)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jf, True)
        run = _jax_train(jm, v)

        def loss(params, ff):
            (nx, out), st = run(params, jnp.asarray(xyz), ff, True)
            return jnp.sum(out * cot), (nx, out, st)
        # op by op: jitted, JAX's own gradients of this module alone do
        # not agree with its op-by-op ones; the op-by-op ones agree with
        # the port's, as the jitted whole encoder's do in
        # test_pointnet2_matches_jax
        if feats is None:
            (_, (jnx, jout, jst)), jgp = jax.value_and_grad(
                loss, has_aux=True)(v["params"], None)
            jgf = None
        else:
            (_, (jnx, jout, jst)), (jgp, jgf) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(v["params"], jf)
            jgf = np.asarray(jgf)
        jnx, jout = np.asarray(jnx), np.asarray(jout)
    m = pn.SAModuleMSG(npoint, pn.RADIUS[level], pn.NSAMPLE[level],
                       pn.MLPS[level], cin, torch.float64)
    m.load_state_dict(_port_names(v["params"], v["batch_stats"], "sa"),
                      strict=True)
    m.double()
    before = {k: t.clone() for k, t in m.state_dict().items()}
    ft = None if feats is None else _t(feats).requires_grad_()
    rows = bn_rows(m, _t(xyz), ft)
    nx, out = m(_t(xyz), ft)
    (out * _t(cot)).sum().backward()
    np.testing.assert_array_equal(nx.numpy(), jnx)
    assert not nx[-1].any()  # the zero cloud's centers
    close(out.detach(), jout)
    if ft is not None:
        close(ft.grad, jgf)
    _grads_close(m, jgp, v["batch_stats"], "sa")
    _check_bn(m, before, _port_names(v["params"], jst["batch_stats"], "sa"),
              rows)


def test_fp_module_matches_jax():
    """FP1's shape: 64 unknown points from 16 known, skip features."""
    rng = np.random.default_rng(2)
    b, n, m_ = 3, 64, 16
    unknown = _cloud(rng, b, n)
    known = np.ascontiguousarray(unknown[:, ::4])
    uf = rng.standard_normal((b, n, 8))
    kf = rng.standard_normal((b, m_, 12))
    cot = rng.standard_normal((b, n, 24))
    with jax.enable_x64():
        jm = jpn.FPModule((32, 24), dtype=jnp.float64)
        args = [jnp.asarray(a) for a in (unknown, known, uf, kf)]
        v = jm.init(jax.random.PRNGKey(0), *args, True)
        run = _jax_train(jm, v)

        def loss(params, u_f, k_f):
            out, st = run(params, args[0], args[1], u_f, k_f, True)
            return jnp.sum(out * cot), (out, st)
        (_, (jout, jst)), (jgp, jgu, jgk) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(v["params"], args[2],
                                                    args[3])
        jout, jgu, jgk = map(np.asarray, (jout, jgu, jgk))
    mlp_params = v["params"]["mlp"]
    mlp_stats = v["batch_stats"]["mlp"]
    m = pn.FPModule((12 + 8, 32, 24), torch.float64)
    m.mlp.load_state_dict(_port_names(mlp_params, mlp_stats, "fp"),
                          strict=True)
    m.double()
    before = {k: t.clone() for k, t in m.mlp.state_dict().items()}
    ut, kt = _t(uf).requires_grad_(), _t(kf).requires_grad_()
    rows = bn_rows(m.mlp, torch.zeros((b * n, 20), dtype=torch.float64))
    out = m(_t(unknown), _t(known), ut, kt)
    (out * _t(cot)).sum().backward()
    close(out.detach(), jout)
    close(ut.grad, jgu)
    close(kt.grad, jgk)
    _grads_close(m.mlp, jgp["mlp"], mlp_stats, "fp")
    _check_bn(m.mlp, before,
              _port_names(mlp_params, jst["batch_stats"]["mlp"], "fp"), rows)


def _depth_cloud(n_points, b=4, seed=3):
    """A cloud of the synthetic source's depth through JAX's depth2pts,
    with a sample that has no depth (all zeros)."""
    batch = synthetic_contrast_batch(np.random.default_rng(seed), b, size=32,
                                     n_data=64)
    mask = batch["depth_mask"]
    mask[:-1] = (np.random.default_rng(seed).random(mask[:-1].shape)
                 > 0.4).astype(np.float32)
    mask[-1] = 0.0
    out = jpn.depth2pts(jnp.asarray(batch["rgbd"][..., 3]), jnp.asarray(mask),
                        jnp.asarray(batch["grid_xy"]), 424.0, 512.0,
                        jnp.asarray(batch["depth_mean"]),
                        jax.random.PRNGKey(5), n_points)
    assert list(np.asarray(out[3])) == [True] * (b - 1) + [False]
    return np.asarray(out[0])


def test_pointnet2_matches_jax():
    """The whole encoder (4 SA + 4 FP levels, npoints 64/16/4/1) on a
    depth2pts cloud: output, every parameter gradient, every BN's stats."""
    pc = _depth_cloud(64)
    b, n = pc.shape[:2]
    npoints = tuple(max(n // 4 ** k, 1) for k in range(4))
    cot = np.random.default_rng(4).standard_normal((b, n, 128))
    with jax.enable_x64():
        jm = jpn.Pointnet2MSG(npoints=npoints, dtype=jnp.float64)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pc), True)
        run = _jax_train(jm, v)

        def loss(params):
            out, st = run(params, jnp.asarray(pc), True)
            return jnp.sum(out * cot), (out, st)
        (_, (jout, jst)), jg = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
        jout = np.asarray(jout)
    m = pn.Pointnet2MSG(npoints=npoints, dtype=torch.float64)
    sd = {k: _t(a) for k, a in pointnet2_flax_to_torch(
        v["params"], v["batch_stats"]).items()}
    m.load_state_dict(sd, strict=True)
    m.double()
    rows = bn_rows(m, _t(pc))
    out = m(_t(pc))
    (out * _t(cot)).sum().backward()
    close(out.detach(), jout)
    grads = pointnet2_flax_to_torch(jg, v["batch_stats"])
    for name, p in m.named_parameters():
        # 1e-4: flax's f32 BN reductions, through the encoder's conditioning
        close(p.grad, grads[name], rel=1e-4, what=name)
    after = {k: _t(a) for k, a in pointnet2_flax_to_torch(
        v["params"], jst["batch_stats"]).items()}
    _check_bn(m, sd, after, rows)
    assert len(rows) == 24


def test_pointnet2_f32_is_ill_conditioned():
    """Why the module tests run in f64.  On the cloud of
    test_pointnet2_matches_jax the encoder itself (computed in f64) moves
    its output by more than 1e-4 relative and a parameter gradient by more
    than 1e-2 relative when the points change by 1e-7 relative; f32
    rounding (6e-8) is amplified alike, so the f32 and f64 encoders on the
    same input part by as much."""
    pc = _depth_cloud(64)
    noise = np.random.default_rng(8).standard_normal(pc.shape)
    pert = (pc * (1 + 1e-7 * noise)).astype(np.float32)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (pc.shape[0], pc.shape[1], 128)))
    torch.manual_seed(0)
    base = pn.Pointnet2MSG(npoints=(64, 16, 4, 1))

    def run(dtype, x):
        m = pn.Pointnet2MSG(npoints=(64, 16, 4, 1), dtype=dtype)
        m.load_state_dict(base.state_dict())
        m.to(dtype)
        out = m(_t(x))
        (out * cot.to(dtype)).sum().backward()
        return out.detach().double(), {n: p.grad.double()
                                       for n, p in m.named_parameters()}

    def apart(a, b):
        return (float((a[0] - b[0]).abs().max() / b[0].abs().max()),
                max(float((a[1][n] - b[1][n]).norm() / b[1][n].norm())
                    for n in b[1]))

    f64 = run(torch.float64, pc)
    moved = apart(run(torch.float64, pert), f64)
    rounding = apart(run(torch.float32, pc), f64)
    print(f"1e-7 input change moves (output, worst grad) by {moved}; "
          f"f32 vs f64 on one input: {rounding}")
    assert moved[0] > 1e-4 and moved[1] > 1e-2
    assert rounding[0] > 1e-4 and rounding[1] > 1e-2


# ---- depth2pts and the model in float32 ------------------------------------


def test_depth2pts_matches_jax():
    """Pinned uniforms (the ones JAX's depth2pts draws from its key): the
    same samples, all points, indices and validity; the zero-depth sample
    gives an all-zero cloud and valid False."""
    batch = synthetic_contrast_batch(np.random.default_rng(6), 4, size=32,
                                     n_data=64)
    batch["depth_mask"][0] = 0.0
    batch["depth_mask"][1] = 1.0
    key = jax.random.PRNGKey(9)
    args = [batch["rgbd"][..., 3], batch["depth_mask"], batch["grid_xy"]]
    want = jpn.depth2pts(*map(jnp.asarray, args), 424.0, 512.0,
                         jnp.asarray(batch["depth_mean"]), key, 200)
    u = _t(jax.random.uniform(key, (4, 200)))
    got = pn.depth2pts(*map(_t, args), 424.0, 512.0,
                       _t(batch["depth_mean"]), 200, u=u)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][0].any() and not bool(got[3][0])
    assert (got[2][1:].diff(dim=-1) >= 0).all()  # raster order
    # drawn from a generator instead: the same law, sorted, valid pixels
    s, _, ind, valid = pn.depth2pts(*map(_t, args), 424.0, 512.0,
                                    _t(batch["depth_mean"]), 200,
                                    generator=torch.Generator().manual_seed(0))
    assert s.shape == (4, 200, 3) and torch.equal(valid, got[3])
    mask = _t(batch["depth_mask"]).reshape(4, -1)[valid]
    assert bool((mask.gather(1, ind[valid].long()) == 1).all())
    assert (ind.diff(dim=-1) >= 0).all()


TINY = dict(method="Customize", modal="RGBD2S", arch="HRNetPN", width=4,
            mem="bank", nce_k=15, batch_size=6, epochs=4, learning_rate=0.01,
            modality_missing=True, compute_dtype="float32", pn_num_points=64)


def test_hcmoco_pn_model_forward_matches_jax(monkeypatch):
    """JAX's depth2pts is handed a fixed key, the port the uniforms
    jax.random.uniform draws from it."""
    pkey = jax.random.PRNGKey(11)
    orig = jpn.depth2pts
    monkeypatch.setattr(jpn, "depth2pts", lambda *a: orig(*a[:6], pkey,
                                                         a[7]))
    cfg = resolve_config(TrainConfig(**TINY))
    jcfg = jax_resolve_config(JaxTrainConfig(**TINY))
    batch = synthetic_contrast_batch(np.random.default_rng(7), 6, size=32,
                                     n_data=64)
    assert 0 < batch["use_depth"].sum() < 6
    jm = jax_build_model(jcfg)
    keys = ("rgbd", "skeleton", "depth_mask", "grid_xy")
    jargs = [jnp.asarray(batch[k]) for k in keys]
    mean = jnp.asarray(batch["depth_mean"])
    v = jax.jit(lambda *a: jm.init(
        {"params": jax.random.PRNGKey(0), "points": pkey}, *a, 424.0, 512.0,
        mean, train=True))(*jargs)
    want, _ = jax.jit(lambda *a: jm.apply(
        v, *a, 424.0, 512.0, mean, train=True, rngs={"points": pkey},
        mutable=["batch_stats"]))(*jargs)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_port_state_dict(v["params"],
                                                  v["batch_stats"]),
                          strict=True)
    u = _t(jax.random.uniform(pkey, (6, 64)))
    t = {k: _t(batch[k]) for k in keys}
    args = (t["rgbd"].permute(0, 3, 1, 2), t["skeleton"], t["depth_mask"],
            t["grid_xy"], 424.0, 512.0, _t(batch["depth_mean"]))
    got = model(*args, u=u)
    for k in ("pooled1", "feat1", "pooled3", "feat3"):
        close(got[k].detach(), want[k], rel=1e-4, what=k)
    for k in ("pooled2", "feat2"):
        close(got[k].detach(), want[k], rel=2e-3, what=k)
    # return_fm adds the encoders' maps; without linear_feat_map no heads
    fm = model(*args, u=u, return_fm=True)
    assert set(fm) - set(got) == {"fm1", "fm2", "fm3"}
    close(fm["fm2"].detach().mean(dim=1), want["pooled2"], rel=2e-3,
          what="fm2")


def test_build_model_hrnetpn_knobs():
    cfg = resolve_config(TrainConfig(**TINY))
    model = build_model(cfg, device="cpu")
    assert isinstance(model, pn.HCMoCoPNModel)
    assert [sa.npoint for sa in model.encoder2.SA_modules] == [64, 16, 4, 1]
    with pytest.raises(NotImplementedError, match="pn_remat"):
        build_model(resolve_config(TrainConfig(**TINY, pn_remat=True)),
                    device="cpu")
