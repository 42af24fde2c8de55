"""The port's A2J stack (hcmoco_tpu_torch/downstream/a2j) held against
hcmoco_tpu's on the same seeded numpy inputs, on the CPU: the anchor grid,
post_process and a2j_loss (tests/golden/a2j_golden.npz, and JAX with
gradients), AnchorHead's W-major output on a non-square map, A2JHRNet at
crop 32 in training and eval with its BN statistics, two Adam/StepLR
steps (the legacy A2JResNet's, --arch resnet50, are
tests/test_torch_a2j_resnet.py's), the ITOP data path (samples equal
bit for bit), the fixture writer, and the CLI.

Layouts: JAX NHWC, the port NCHW.  Tolerances: the anchor math rtol 1e-5
/ atol 1e-6 (f32 sums in another order); the model, its statistics and
its steps the port's TOL (rtol 1e-4, atol 1e-5; width 4), the JAX side in
float64 (jax.enable_x64).  The eval forward runs the port in f32; the
training forward and the Adam steps run it in float64 too: there the
heads' BN normalises over 128 rows a channel, JAX's own f32 forward is
6.5e-5 off its float64 one and the port's f32 2.1e-5, and Adam turns the
rounding noise of the gradient of a conv bias ahead of a training BN
(zero in exact arithmetic) into steps of up to lr.  The golden as the JAX
package's own test holds it (rtol 1e-4, atol 1e-5); data exact.  BN
running variance: F1 (tests/torch_parity_common.py).
"""

import copy
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as scio
import torch

import torch_parity_common as tpc
from hcmoco_tpu.downstream.a2j import anchors as janchors
from hcmoco_tpu.downstream.a2j import data as jdata
from hcmoco_tpu.downstream.a2j.model import A2JHRNet as JaxA2JHRNet
from hcmoco_tpu.downstream.a2j.model import AnchorHead as JaxAnchorHead

from hcmoco_tpu_torch.core.config import HRNET_CONFIGS
from hcmoco_tpu_torch.downstream.a2j import anchors, data, train
from hcmoco_tpu_torch.downstream.a2j.model import A2JHRNet, AnchorHead
from hcmoco_tpu_torch.export.convert import (a2j_flax_to_torch,
                                             anchor_head_flax_to_torch)
from hcmoco_tpu_torch.models.hrnet import HRNet

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
GOLDEN = np.load(os.path.join(HERE, "golden", "a2j_golden.npz"))
MATH_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
P_HW = np.array([1, 2, 3])
CROP, WIDTH = 32, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_heads(heads):
    return tuple(jnp.asarray(h) for h in heads)


# ---- anchors ----------------------------------------------------------------

def test_anchor_grids_match_golden_and_jax():
    got = anchors.shift_anchors((8, 8), 4, anchors.generate_anchors(P_HW,
                                                                   P_HW))
    np.testing.assert_array_equal(got, GOLDEN["anchors"])
    for shape, stride, p in (((6, 5), 4, P_HW), ((4, 4), 16, None)):
        np.testing.assert_array_equal(
            anchors.shift_anchors(shape, stride,
                                  anchors.generate_anchors(p, p)),
            janchors.shift_anchors(shape, stride,
                                   janchors.generate_anchors(p, p)))


def test_post_process_and_loss_match_golden():
    heads = (_t(GOLDEN["cls"]), _t(GOLDEN["reg"]), _t(GOLDEN["dep"]))
    a = _t(GOLDEN["anchors"]).float()
    np.testing.assert_allclose(anchors.post_process(heads, a).numpy(),
                               GOLDEN["keys"], rtol=1e-4, atol=1e-5)
    cls_l, reg_l = anchors.a2j_loss(heads, _t(GOLDEN["ann"]), a,
                                    spatial_factor=0.5)
    np.testing.assert_allclose(float(cls_l), GOLDEN["cls_loss"], rtol=1e-4)
    np.testing.assert_allclose(float(reg_l), GOLDEN["reg_loss"], rtol=1e-4)


@pytest.mark.parametrize("is_3d", [True, False])
def test_post_process_and_loss_match_jax_with_gradients(is_3d):
    """Random heads over a 6x5 grid of 9 anchors, targets spread so both
    smooth-L1 branches (beta 1 and the reference's literal beta-3 one)
    are taken: keypoints, both losses, and their gradients wrt each
    head."""
    rng = np.random.default_rng(0)
    grid = anchors.shift_anchors((6, 5), 4, anchors.generate_anchors(P_HW,
                                                                     P_HW))
    n, p = grid.shape[0], 15
    heads = [(rng.standard_normal((2, n, p)) * 2).astype(np.float32),
             (rng.standard_normal((2, n, p, 2)) * 3).astype(np.float32),
             (rng.standard_normal((2, n, p)) * 4).astype(np.float32)]
    heads = heads if is_3d else heads[:2]
    ann = np.concatenate([rng.uniform(0, 24, (2, p, 2)),
                          rng.standard_normal((2, p, 1)) * 5],
                         -1).astype(np.float32)
    ja = jnp.asarray(grid, jnp.float32)
    pa = _t(grid).float()

    np.testing.assert_allclose(
        anchors.post_process([_t(h) for h in heads], pa, is_3d).numpy(),
        np.asarray(janchors.post_process(_jax_heads(heads), ja, is_3d)),
        **MATH_TOL)

    def jloss(hs):
        c, r = janchors.a2j_loss(hs, jnp.asarray(ann), ja, 0.5, is_3d)
        return c + 3.0 * r, (c, r)

    (_, (jc, jr)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        _jax_heads(heads))
    ph = [_t(h).requires_grad_() for h in heads]
    c, r = anchors.a2j_loss(ph, _t(ann), pa, 0.5, is_3d)
    (c + 3.0 * r).backward()
    np.testing.assert_allclose(c.item(), float(jc), **MATH_TOL)
    np.testing.assert_allclose(r.item(), float(jr), **MATH_TOL)
    for h, g in zip(ph, jgrads):
        np.testing.assert_allclose(h.grad.numpy(), np.asarray(g), **MATH_TOL)


# ---- the model ----------------------------------------------------------------

def _perturbed_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.abs(a + 0.1 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32))), stats)


@pytest.mark.parametrize("out_per_anchor", [1, 2])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_anchor_head_w_major_matches_jax(out_per_anchor, mode):
    """On a 5x7 (H x W) map the anchors come out W-major, as JAX's
    swapaxes and the reference's permute(0, 3, 2, 1) enumerate them."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    jhead = JaxAnchorHead(out_per_anchor, 9, 15)
    v = jax.jit(jhead.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    stats = _perturbed_stats(v["batch_stats"], 2)
    head = AnchorHead(12, out_per_anchor, 9, 15)
    head.load_state_dict({k: _t(a) for k, a in anchor_head_flax_to_torch(
        v["params"], stats).items()}, strict=True)
    head.train(mode == "train")
    variables = {"params": v["params"], "batch_stats": stats}
    if mode == "train":
        want, _ = jhead.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    else:
        want = jhead.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = head(_t(x).permute(0, 3, 1, 2))
    shape = (2, 7 * 5 * 9, 15) + ((2,) if out_per_anchor == 2 else ())
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert head.bn1.momentum == 0.1


def _f64(tree):
    """A tree of f32 arrays as float64 numpy arrays (the JAX side of the
    model's comparisons runs under jax.enable_x64)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def a2j_pair():
    """JAX's width-4 float64 A2JHRNet (its f32 init's weights, BN state
    moved off its init), the port's f32 one loaded from the same trees
    (strict), and a seeded (2, 32, 32, 1) depth."""
    v = jax.jit(JaxA2JHRNet(num_classes=15, num_anchors=9, width=WIDTH,
                            dtype=jnp.float32).init,
                static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 1)), train=False)
    params, stats = v["params"], _perturbed_stats(v["batch_stats"], 3)
    model = A2JHRNet(num_classes=15, num_anchors=9, width=WIDTH,
                     dtype=torch.float32)
    model.load_state_dict(a2j_flax_to_torch(params, stats), strict=True)
    x = np.random.default_rng(4).standard_normal(
        (2, CROP, CROP, 1)).astype(np.float32)
    jmodel = JaxA2JHRNet(num_classes=15, num_anchors=9, width=WIDTH,
                         dtype=jnp.float64)
    return jmodel, _f64(params), _f64(stats), model, x


def _float64(model):
    """A copy of the port's model that computes in float64 throughout."""
    model = copy.deepcopy(model).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def test_reference_names():
    model = A2JHRNet(width=18)
    sd = model.state_dict()
    assert {k[len("Backbone."):] for k in sd if k.startswith("Backbone.")} \
        == set(HRNet(HRNET_CONFIGS[18], 3).state_dict())
    for head, out in (("classificationModel", 9 * 15),
                      ("regressionModel", 9 * 15 * 2),
                      ("DepthRegressionModel", 9 * 15)):
        assert tuple(sd[f"{head}.conv1.weight"].shape) == (256, 270, 3, 3)
        assert tuple(sd[f"{head}.output.weight"].shape) == (out, 256, 3, 3)
        assert f"{head}.bn4.running_var" in sd
    assert "DepthRegressionModel.output.bias" not in A2JHRNet(
        width=4, is_3d=False).state_dict()


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_a2jhrnet_forward_matches_jax(a2j_pair, mode):
    """Crop 32: the three heads over 8x8x9 anchors (the port in f32 in
    eval, in float64 in training); in training also every BN's running
    statistics after the forward (F1-scaled)."""
    jmodel, params, stats, model, x = a2j_pair
    model = copy.deepcopy(model) if mode == "eval" else _float64(model)
    xt = _t(x).permute(0, 3, 1, 2)
    if mode == "train":
        xt = xt.double()
    variables = {"params": params, "batch_stats": stats}
    if mode == "eval":
        with jax.enable_x64():
            want = _f64(jax.jit(lambda d: jmodel.apply(
                variables, d, train=False))(np.asarray(x, np.float64)))
        with torch.no_grad():
            got = model.eval()(xt)
    else:
        rows = tpc.bn_rows(model, xt)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with jax.enable_x64():
            want, mut = _f64(jax.jit(lambda d: jmodel.apply(
                variables, d, train=True, mutable=["batch_stats"]))(
                np.asarray(x, np.float64)))
        with torch.no_grad():
            got = model.train()(xt)
        n = tpc.check_bn_stats(model, before, params, stats,
                               mut["batch_stats"], rows,
                               convert=a2j_flax_to_torch, **TOL)
        assert n == len(rows) > 0
    assert tuple(got[1].shape) == (2, 8 * 8 * 9, 15, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_step_lr_matches_optax():
    """The staircase at lr_step x steps optimizer steps, optax's
    exponential_decay(staircase=True), within one f32 rounding."""
    fn = train.step_lr_fn(3.5e-4, 10 * 3, 0.2)
    want = optax.exponential_decay(3.5e-4, transition_steps=30,
                                   decay_rate=0.2, staircase=True)
    for step in (0, 1, 29, 30, 31, 59, 60, 95):
        np.testing.assert_allclose(fn(step), float(want(step)),
                                   rtol=2.5e-7, err_msg=str(step))
    assert fn(29) == fn(0) and fn(30) < fn(29)


def _adam_steps_match_jax(pair, grid: torch.Tensor, crop: int,
                          steps: int = 2) -> None:
    """`steps` steps of the CLI's train step (the StepLR decaying after one
    step, cls + 3 x reg loss, Adam with the L2 term in the gradient), both
    sides in float64, against the JAX CLI's optax chain, from `pair`
    (jmodel, params, stats, model, x) over the anchors `grid` at `crop`:
    every parameter and BN statistic within TOL, and the losses; Adam's
    few elements whose input is within 1e-5 of its tensor's largest
    gradient, where the reference's gradient noise moves the step by more
    than TOL, are held only to a step of at most a few lr (and must be
    under 1e-3 of all)."""
    jmodel, params, stats, model, x = pair
    model = _float64(model)
    rng = np.random.default_rng(5)
    labels = np.concatenate([rng.uniform(0, crop, (2, 2, 15, 2)),
                             rng.standard_normal((2, 2, 15, 1)) * 5],
                            -1).astype(np.float32)
    lr, wd = 3.5e-4, 1e-4
    lr_fn = optax.exponential_decay(lr, transition_steps=1, decay_rate=0.2,
                                    staircase=True)
    tx = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(),
                     optax.scale_by_learning_rate(lr_fn))
    want = []  # (loss, lr, stats before, stats after) a step; params at end
    with jax.enable_x64():
        ja = jnp.asarray(grid.numpy(), jnp.float64)

        @jax.jit
        def grad_fn(p, bs, lab):
            def loss_fn(p):
                heads, mut = jmodel.apply(
                    {"params": p, "batch_stats": bs},
                    jnp.asarray(x, jnp.float64), train=True,
                    mutable=["batch_stats"])
                c, r = janchors.a2j_loss(heads, lab, ja, spatial_factor=0.5)
                return c + r * 3.0, mut["batch_stats"]
            return jax.value_and_grad(loss_fn, has_aux=True)(p)

        jp, js = params, stats
        opt_state = tx.init(jp)
        floor = None
        for s in range(steps):
            (jl, js2), g = grad_fn(jp, js, jnp.asarray(labels[s],
                                                       jnp.float64))
            # Adam's input g + wd p, where JAX's loss gradient noise (its
            # a2j_loss computes in f32 even under x64: 3.1e-7 of a
            # tensor's largest gradient, measured) is above 3% of it, so
            # that lr x 3% exceeds TOL's atol
            # (an exact zero, a ReLU's dead input, is exact on both sides)
            near_zero = jax.tree_util.tree_map(
                lambda gr, p: (np.asarray(gr) != 0) & (np.abs(
                    np.asarray(gr) + wd * np.asarray(p))
                    < 1e-5 * np.abs(np.asarray(gr)).max()), g, jp)
            floor = near_zero if floor is None else jax.tree_util.tree_map(
                np.logical_or, floor, near_zero)
            upd, opt_state = tx.update(g, opt_state, jp)
            jp = optax.apply_updates(jp, upd)
            want.append((float(jl), float(lr_fn(s)), js, _f64(js2)))
            js = want[-1][3]
        jp = _f64(jp)

    args = train.build_argparser().parse_args([])
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=wd)
    step = train.make_train_step(model, opt, train.step_lr_fn(lr, 1, 0.2),
                                 grid.double(), args)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    depth = _t(x).double()
    rows = tpc.bn_rows(model, depth.permute(0, 3, 1, 2))
    for s, (loss, step_lr, js_before, js_after) in enumerate(want):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        m = step({"depth": depth, "label": _t(labels[s]).double()}, s)
        np.testing.assert_allclose(float(m["loss"]), loss, **TOL)
        np.testing.assert_allclose(m["learning_rate"], step_lr, rtol=2.5e-7)
        tpc.check_bn_stats(model, before, jp, js_before, js_after, rows,
                           convert=a2j_flax_to_torch, **TOL)
    # where Adam's input is within the reference's gradient noise, its
    # step lr g / (|g| + eps) is noise too: there each side moves by at
    # most a few lr, elsewhere the two agree within TOL
    got = model.state_dict()
    masks = a2j_flax_to_torch(jax.tree_util.tree_map(
        lambda m: m.astype(np.float64), floor), js)
    n_masked = n_all = 0
    for k, v in a2j_flax_to_torch(jp, js).items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            continue
        m = masks[k].numpy().astype(bool)
        n_masked, n_all = n_masked + int(m.sum()), n_all + m.size
        np.testing.assert_allclose(got[k].numpy()[~m], v.numpy()[~m],
                                   **TOL, err_msg=k)
        moved = np.abs(got[k].numpy() - start[k].numpy())[m]
        assert moved.size == 0 or moved.max() <= 3 * lr, k
    print(f"{n_masked} of {n_all} elements at the noise floor")
    assert n_masked <= 1e-3 * n_all, (n_masked, n_all)


def test_adam_steplr_steps_match_jax(a2j_pair):
    """_adam_steps_match_jax on A2JHRNet at crop 32, two steps."""
    _adam_steps_match_jax(a2j_pair, train.a2j_anchors("hrnet", CROP, "cpu"),
                          CROP)


# ---- the ITOP data path -------------------------------------------------------

def test_constants_and_helpers_match_jax():
    for name in ("KEYPOINTS", "CROP_H", "CROP_W", "DEPTH_FACTOR",
                 "RAND_CROP_SHIFT", "RAND_ROTATE", "RAND_SCALE",
                 "RANDSHIFT_DEPTH"):
        assert getattr(data, name) == getattr(jdata, name), name
    rng = np.random.default_rng(6)
    x, y, z = rng.uniform(0, 320, 5), rng.uniform(0, 240, 5), \
        rng.uniform(1, 4, 5)
    for a, b in zip(data.pixel2world(x, y, z), jdata.pixel2world(x, y, z)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(data.world2pixel(x, y, z), jdata.world2pixel(x, y, z)):
        np.testing.assert_array_equal(a, b)
    d = rng.uniform(0, 3, (20, 30)).astype(np.float32)
    d[:5] = 0
    for a, b in zip(data.crop_human_pcd(d, np.array([1.5, 2.0])),
                    jdata.crop_human_pcd(d, np.array([1.5, 2.0]))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def itop(tmp_path_factory):
    """The JAX package's ITOP fixture (8 train, 4 test frames) and the
    port's from the same seed in another directory."""
    root = tmp_path_factory.mktemp("itop")
    want = jdata.make_itop_fixture(str(root / "jax"), n_train=8, n_test=4,
                                   seed=2)
    got = data.make_itop_fixture(str(root / "port"), n_train=8, n_test=4,
                                 seed=2)
    return got, want


def test_itop_fixture_matches_jax(itop):
    """Every .mat array and both bounding-box pickles equal."""
    got, want = itop
    for g_dir, w_dir in ((got[0], want[0]), (got[1], want[1])):
        names = sorted(os.listdir(w_dir))
        assert sorted(os.listdir(g_dir)) == names and names
        for name in names:
            a, b = (scio.loadmat(os.path.join(d, name))
                    for d in (g_dir, w_dir))
            for k in ("DepthNormal", "keypointsPixel", "keypointsWorld"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        with open(g, "rb") as f1, open(w, "rb") as f2:
            np.testing.assert_array_equal(pickle.load(f1), pickle.load(f2))


@pytest.mark.parametrize("augment", [True, False])
def test_itop_samples_match_jax(itop, augment):
    """ITOPDataset (crop, depth filter and mean, rotation/scale
    augmentation from the shared generator) twice over, in order."""
    got_dirs, want_dirs = itop
    with open(want_dirs[2], "rb") as f:
        bnd = pickle.load(f)
    got = data.ITOPDataset(want_dirs[0], bnd, augment=augment, seed=3)
    want = jdata.ITOPDataset(want_dirs[0], bnd, augment=augment, seed=3)
    assert len(got) == 8
    for _ in range(2):
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_itop_batches_match_jax(itop):
    """Two batches of each package's DataSource over its augmenting
    ITOPDataset, one decode thread, equal bit for bit."""
    from hcmoco_tpu.data.pipeline import DataSource as JaxDataSource

    from hcmoco_tpu_torch.data.pipeline import DataSource

    _, want_dirs = itop
    with open(want_dirs[2], "rb") as f:
        bnd = pickle.load(f)
    its = [iter(src(ds(want_dirs[0], bnd, augment=True, seed=6), 3,
                    np.ones(8), seed=7, num_workers=1))
           for src, ds in ((DataSource, data.ITOPDataset),
                           (JaxDataSource, jdata.ITOPDataset))]
    try:
        for _ in range(2):
            a, b = next(its[0]), next(its[1])
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        for it in its:
            it.close()


def test_preprocess_and_random_erasing_match_jax():
    rng = np.random.default_rng(7)
    img = rng.uniform(2, 4, (240, 320)).astype(np.float32)
    kp_pix = rng.uniform(100, 200, (15, 2)).astype(np.float32)
    kp_world = np.concatenate([rng.uniform(-1, 1, (15, 2)),
                               rng.uniform(2.5, 3.0, (15, 1))],
                              -1).astype(np.float32)
    for seed in (None, 0, 1):
        g = None if seed is None else np.random.default_rng(seed)
        w = None if seed is None else np.random.default_rng(seed)
        a = data.preprocess_frame(img, kp_pix, kp_world, (60, 40),
                                  (260, 220), g)
        b = jdata.preprocess_frame(img, kp_pix, kp_world, (60, 40),
                                   (260, 220), w)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    crop = rng.standard_normal((64, 64, 1)).astype(np.float32)
    for seed in range(6):
        np.testing.assert_array_equal(
            data.random_erasing(crop, np.random.default_rng(seed)),
            jdata.random_erasing(crop, np.random.default_rng(seed)))


@pytest.mark.parametrize("per_joint", [False, True])
def test_evaluation_10cm_matches_jax(per_joint):
    rng = np.random.default_rng(8)
    n, p = 5, 15
    pred = np.concatenate([rng.uniform(0, 288, (n, p, 2)),
                           rng.standard_normal((n, p, 1)) * 3], -1)
    world = np.concatenate([rng.uniform(-1, 1, (n, p, 2)),
                            rng.uniform(2, 3, (n, p, 1))], -1)
    bnd = np.tile(np.array([40.0, 20.0, 200.0, 230.0]), (n, 1))
    means = rng.uniform(2, 3, n)
    got = data.evaluation_10cm(pred, world, bnd, means, per_joint)
    want = jdata.evaluation_10cm(pred, world, bnd, means, per_joint)
    for a, b in zip(np.atleast_1d(got) if not per_joint else got,
                    np.atleast_1d(want) if not per_joint else want):
        np.testing.assert_array_equal(a, b)


def test_convert_itop_h5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(9)
    paths = [str(tmp_path / "depth.h5"), str(tmp_path / "labels.h5")]
    with h5py.File(paths[0], "w") as f:
        f["data"] = rng.uniform(0, 4, (5, 240, 320)).astype(np.float16)
    with h5py.File(paths[1], "w") as f:
        f["is_valid"] = np.array([1, 0, 1, 1, 0])
        f["image_coordinates"] = rng.integers(0, 240, (5, 15, 2))
        f["real_world_coordinates"] = rng.standard_normal((5, 15, 3))
    n = data.convert_itop_h5(*paths, str(tmp_path / "port"), limit=2)
    assert n == jdata.convert_itop_h5(*paths, str(tmp_path / "jax"),
                                      limit=2) == 2
    for name in ("1.mat", "2.mat"):
        a = scio.loadmat(str(tmp_path / "port" / name))
        b = scio.loadmat(str(tmp_path / "jax" / name))
        for k in ("DepthNormal", "keypointsPixel", "keypointsWorld"):
            np.testing.assert_array_equal(a[k], b[k])


# ---- the CLI ------------------------------------------------------------------

def _small_crop(monkeypatch, crop):
    """The data path at a crop the CPU trains quickly (as the JAX
    package's drive test does)."""
    monkeypatch.setattr(data, "CROP_H", crop)
    monkeypatch.setattr(data, "CROP_W", crop)


def test_cli_two_steps_with_eval(tmp_path, capsys, monkeypatch):
    """Two steps on an ITOP fixture from an exported encoder, evaluated
    before training and after the epoch: the conv count, finite losses,
    PCK@10cm for epochs 0 and 1."""
    _small_crop(monkeypatch, CROP)
    tr, te, btr, bte = data.make_itop_fixture(str(tmp_path / "itop"),
                                              n_train=8, n_test=4)
    src = HRNet(HRNET_CONFIGS[WIDTH], 3, torch.float32)
    pth = str(tmp_path / "encoder2.pth")
    torch.save(src.state_dict(), pth)
    run = train.main(["--device", "cpu", "--train_dir", tr, "--test_dir",
                      te, "--bndbox_train", btr, "--bndbox_test", bte,
                      "--pretrained_pth", pth, "--width", str(WIDTH),
                      "--crop", str(CROP), "--batch_size", "4", "--epochs",
                      "1", "--max_steps", "2", "--print_freq", "1",
                      "--eval_first"])
    out = capsys.readouterr().out
    convs = sum(1 for m in src.modules() if isinstance(m, torch.nn.Conv2d))
    assert f"=> loaded {convs} conv tensors" in out
    assert re.search(r"Train: \[1\]\[2/2\] .*reg_loss", out)
    assert [int(e) for e in re.findall(r"epoch (\d): PCK@10cm", out)] \
        == [0, 1]
    assert len(run.step_s) == 2 and len(run.scores) == 2
    assert all(np.isfinite(m["loss"]) for m in run.metrics)
    # trained past the loaded weights
    assert not torch.equal(run.model.Backbone.conv1.weight, src.conv1.weight)


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--synthetic", "4", "--crop", "32", "--width", "4"])


@pytest.mark.slow
def test_a2j_fixture_train_improves_pck(tmp_path, capsys, monkeypatch):
    """The counterpart of tests/test_a2j_drive.py's slow test: ten epochs
    on a 32-frame fixture at crop 64 with gentle augmentation, warm-started
    from a tiny stage-2 model's exported depth encoder; PCK@10cm improves
    over the untrained epoch-0 baseline."""
    _small_crop(monkeypatch, 64)
    monkeypatch.setattr(data, "RAND_ROTATE", 15)
    monkeypatch.setattr(data, "RAND_SCALE", (0.1, 0.95))
    tr, te, btr, bte = data.make_itop_fixture(str(tmp_path / "itop"),
                                              n_train=32, n_test=12)
    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
    from hcmoco_tpu_torch.export.transfer import export_encoder
    from hcmoco_tpu_torch.models.build import build_model

    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGBD2S", arch="HRNet", width=WIDTH,
        mem="bank+jointspri3d", linear_feat_map=True,
        compute_dtype="float32"))
    pth = str(tmp_path / "encoder2.pth")
    export_encoder(build_model(cfg, device="cpu").state_dict(), "encoder2",
                   pth)
    train.main(["--device", "cpu", "--train_dir", tr, "--test_dir", te,
                "--bndbox_train", btr, "--bndbox_test", bte,
                "--pretrained_pth", pth, "--width", str(WIDTH), "--crop",
                "64", "--epochs", "10", "--batch_size", "8",
                "--learning_rate", "2e-3", "--print_freq", "2", "--seed",
                "0", "--eval_first"])
    out = capsys.readouterr().out
    assert re.search(r"=> loaded \d+ conv tensors", out)
    pcks = [float(m) for m in re.findall(r"PCK@10cm (\d\.\d+)", out)]
    assert len(pcks) == 11, out
    assert np.mean(pcks[-3:]) > pcks[0], pcks
    assert max(pcks[1:]) >= 0.15, pcks
