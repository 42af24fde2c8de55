"""The port's downstream parsing stack (hcmoco_tpu_torch/downstream/seg)
held against hcmoco_tpu's on the same seeded numpy inputs, on the CPU:
the criteria (values and gradients), the poly LR, the confusion matrix and
mIoU, the numpy metrics, the datasets and legacy loaders (samples equal
bit for bit), SegHRNet at an odd crop (33: branches 9/5/3/2) in training
and eval with its BN statistics, two SGD poly steps, load_pretrained's
count, the sliding-window inference with flip TTA, and the CLI.

Layouts: JAX NHWC, the port NCHW; tensors are permuted to compare.
Tolerances: the criteria rtol 1e-5 / atol 1e-6 (f32, the same sums in
another order); the model, its statistics and its steps the port's TOL
(rtol 1e-4, atol 1e-5; width 4, f32); the golden as the JAX package's own
test holds it (rtol 2e-3); counts, samples and metrics exact.  BN running
variance: F1 (tests/torch_parity_common.py).
"""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_parity_common as tpc
from hcmoco_tpu.data import fixtures as jfixtures
from hcmoco_tpu.downstream.seg import criterion as jcrit
from hcmoco_tpu.downstream.seg import datasets as jdatasets
from hcmoco_tpu.downstream.seg import legacy as jlegacy
from hcmoco_tpu.downstream.seg import metric as jmetric
from hcmoco_tpu.downstream.seg.inference import \
    sliding_window_inference as jax_sliding_window
from hcmoco_tpu.downstream.seg.model import SegHRNet as JaxSegHRNet
from hcmoco_tpu.downstream.seg.model import \
    load_pretrained as jax_load_pretrained

from hcmoco_tpu_torch.downstream.seg import criterion as crit
from hcmoco_tpu_torch.downstream.seg import datasets, legacy, metric, train
from hcmoco_tpu_torch.downstream.seg.inference import \
    sliding_window_inference
from hcmoco_tpu_torch.downstream.seg.model import SegHRNet, load_pretrained
from hcmoco_tpu_torch.export.convert import seg_flax_to_torch
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.core.config import HRNET_CONFIGS

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
GOLDEN = np.load(os.path.join(HERE, "golden", "seg_golden.npz"))
CRIT_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
CROP, WIDTH, N_CLASS = 33, 4, 25


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


# ---- criteria, schedule, confusion metrics --------------------------------

@pytest.mark.parametrize("kind", ["ce", "ohem"])
def test_criteria_match_golden(kind):
    """The reference torch values of seg_golden.npz, and JAX's on the same
    NCHW score."""
    score, target = GOLDEN["score"], GOLDEN["target"]
    weight = GOLDEN["weight"]
    if kind == "ce":
        got = crit.cross_entropy_seg(_t(score), _t(target), _t(weight))
        want = jcrit.cross_entropy_seg(
            jnp.asarray(score.transpose(0, 2, 3, 1)), jnp.asarray(target),
            jnp.asarray(weight))
    else:
        got = crit.ohem_cross_entropy(_t(score), _t(target), _t(weight),
                                      thres=0.7, min_kept=50)
        want = jcrit.ohem_cross_entropy(
            jnp.asarray(score.transpose(0, 2, 3, 1)), jnp.asarray(target),
            jnp.asarray(weight), thres=0.7, min_kept=50)
    np.testing.assert_allclose(float(got), GOLDEN[kind], rtol=2e-3)
    np.testing.assert_allclose(float(got), float(want), **CRIT_TOL)


@pytest.mark.parametrize("kind", ["ce", "ohem"])
@pytest.mark.parametrize("weighted", [True, False])
def test_criteria_match_jax_with_gradients(kind, weighted):
    """Random logits at 7x7 upsampled to 15x15 labels, a quarter of them
    ignored (255): values and gradients wrt the logits."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 6, 7, 7)) * 2).astype(np.float32)
    labels = rng.integers(0, 6, (2, 15, 15)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.25] = 255
    w = (rng.random(6) + 0.5).astype(np.float32) if weighted else None
    kw = dict(thres=0.7, min_kept=60) if kind == "ohem" else {}
    jfn = {"ce": jcrit.cross_entropy_seg, "ohem": jcrit.ohem_cross_entropy}
    pfn = {"ce": crit.cross_entropy_seg, "ohem": crit.ohem_cross_entropy}

    def jloss(x):
        return jfn[kind](x, jnp.asarray(labels),
                         None if w is None else jnp.asarray(w), **kw)

    want, jgrad = jax.value_and_grad(jloss)(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    x = _t(logits).requires_grad_()
    got = pfn[kind](x, _t(labels), None if w is None else _t(w), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **CRIT_TOL)
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(jgrad), **CRIT_TOL)


def test_poly_lr_matches_jax():
    """poly_lr and the CLI's lr_fn (min(step, max_iters - 1) / max_iters)
    against the JAX package's, past the last iteration: both in f32, equal
    but for the last bit of f32's pow (XLA's and torch's round it
    differently), so within rtol 2.5e-7."""
    for it in (0, 1, 37, 99, 100):
        np.testing.assert_allclose(crit.poly_lr(7e-3, it, 100),
                                   float(jcrit.poly_lr(7e-3, it, 100)),
                                   rtol=2.5e-7)
    assert crit.poly_lr(7e-3, 100, 100) == 0.0
    max_iters = 12
    fn = train.poly_lr_fn(7e-3, max_iters)
    for step in range(max_iters + 3):
        want = 7e-3 * (1.0 - jnp.minimum(jnp.int32(step), max_iters - 1)
                       / max_iters) ** 0.9
        np.testing.assert_allclose(fn(step), float(want), rtol=2.5e-7,
                                   err_msg=str(step))
    assert fn(max_iters + 2) == fn(max_iters - 1) > 0.0


def test_confusion_and_miou_match_jax():
    rng = np.random.default_rng(4)
    label = rng.integers(0, 5, (3, 9, 11)).astype(np.int32)
    label[rng.random(label.shape) < 0.2] = 255
    pred = rng.integers(0, 5, label.shape).astype(np.int64)
    pred[label == 1] = 1  # one class nearly perfect
    got = crit.confusion_matrix(_t(pred), _t(label), 5)
    want = jcrit.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    conf = got.numpy().astype(np.float64)
    conf[3] = conf[:, 3] = 0  # a class absent from labels and predictions
    m, iou = crit.miou_from_confusion(_t(conf))
    jm, jiou = jcrit.miou_from_confusion(jnp.asarray(conf, jnp.float32))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    np.testing.assert_allclose(float(m), float(jm), rtol=1e-6)
    assert float(iou[3]) == 0.0


@pytest.mark.parametrize("fn", ["scores", "batch_pix_accuracy",
                                "batch_intersection_union", "pixel_accuracy",
                                "intersection_and_union"])
def test_metric_module_matches_jax(fn):
    rng = np.random.default_rng(5)
    n = 5
    label = rng.integers(0, n, (2, 8, 8))
    logits = rng.standard_normal((2, 8, 8, n)).astype(np.float32)
    pred = logits.argmax(-1)
    args = {"scores": ([label[0], label[1]], [pred[0], pred[1]], n),
            "batch_pix_accuracy": (logits, label - 1),
            "batch_intersection_union": (logits, label - 1, n),
            "pixel_accuracy": (pred, label),
            "intersection_and_union": (pred, label, n)}[fn]
    got, want = getattr(metric, fn)(*args), getattr(jmetric, fn)(*args)
    if fn == "scores":
        assert got.keys() == want.keys()
        for k in got:
            if k == "Class IoU":
                np.testing.assert_array_equal(list(got[k].values()),
                                              list(want[k].values()))
            else:
                np.testing.assert_array_equal(got[k], want[k])
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---- datasets -------------------------------------------------------------

def test_label_helpers_match_jax():
    np.testing.assert_array_equal(datasets.label_mapper(),
                                  jdatasets.label_mapper())
    np.testing.assert_array_equal(datasets.mapped_pairs(),
                                  jdatasets.mapped_pairs())
    rng = np.random.default_rng(6)
    lab = rng.integers(0, 25, (9, 7))
    np.testing.assert_array_equal(datasets.swap_label_pairs(lab),
                                  jdatasets.swap_label_pairs(lab))
    d = rng.integers(0, 4000, (12, 10)).astype(np.uint16)
    d[:3] = 0
    np.testing.assert_array_equal(datasets.process_depth(d),
                                  jdatasets.process_depth(d))
    assert datasets.CLASS_WEIGHTS_25 == jdatasets.CLASS_WEIGHTS_25
    assert datasets.crop_human_pcd.__module__.endswith("a2j.data")


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    """A Parsing-4K tree of 6 frames at the fixture's 96x128, written by
    the JAX package's writer (tests/test_torch_data.py holds the port's
    writer to it byte for byte); train and val lists of 4 and 2."""
    root = str(tmp_path_factory.mktemp("seg"))
    ntu = os.path.join(root, "ntu")
    jfixtures.make_ntu_fixture(ntu, n_frames=1)
    seg_root, lst = jfixtures.make_seg_fixture(os.path.join(root, "seg"),
                                               ntu, n_frames=6)
    lines = open(lst).read().split()
    for name, part in (("train.txt", lines[:4]), ("val.txt", lines[4:])):
        with open(os.path.join(seg_root, name), "w") as f:
            f.write("\n".join(part) + "\n")
    return seg_root


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cls,modality,is_train", [
    ("ParsingDataset", "depth", True), ("ParsingDataset", "depth", False),
    ("ParsingDataset", "rgb", True), ("Human36MParsing", "rgb", True)])
def test_parsing_samples_match_jax(seg_tree, cls, modality, is_train):
    """Each sample of the same seed, drawn in the same order, bit for
    bit: flips with the label-pair swap, scale jitter, crop, depth
    normalisation; val's 1000x1000 labels."""
    kw = dict(modality=modality, crop_size=(CROP, CROP), base_size=CROP,
              is_train=is_train, seed=7)
    lst = os.path.join(seg_tree, "train.txt")
    got = getattr(datasets, cls)(seg_tree, lst, **kw)
    want = getattr(jdatasets, cls)(seg_tree, lst, **kw)
    assert len(got) == len(want) == 4
    for _ in range(2):
        for i in range(len(got)):
            _same_sample(got[i], want[i])


def test_parsing_batches_match_jax(seg_tree):
    """Two batches of each package's DataSource over its ParsingDataset,
    one decode thread (the datasets share one generator, as
    tests/test_torch_data.py holds the pre-training sources), equal bit
    for bit."""
    from hcmoco_tpu.data.pipeline import DataSource as JaxDataSource

    from hcmoco_tpu_torch.data.pipeline import DataSource

    lst = os.path.join(seg_tree, "train.txt")
    kw = dict(crop_size=(CROP, CROP), base_size=CROP, seed=4)
    its = [iter(src(ds(seg_tree, lst, **kw), 2, np.ones(4), seed=5,
                    num_workers=1))
           for src, ds in ((DataSource, datasets.ParsingDataset),
                           (JaxDataSource, jdatasets.ParsingDataset))]
    try:
        for _ in range(2):
            _same_sample(next(its[0]), next(its[1]))
    finally:
        for it in its:
            it.close()


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def legacy_root(tmp_path_factory):
    """One Cityscapes, LIP and PASCAL-Context image each (the layout of
    tests/test_legacy_seg.py)."""
    root = str(tmp_path_factory.mktemp("legacy"))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)
    lab = rng.choice(list(jlegacy.CITYSCAPES_ID_TO_TRAIN) + [0, 29],
                     (40, 60)).astype(np.uint8)
    _write_png(os.path.join(root, "cityscapes", "leftImg8bit", "a.png"), img)
    _write_png(os.path.join(root, "cityscapes", "gtFine", "a.png"), lab)
    _write_png(os.path.join(root, "lip", "TrainVal_images", "b.jpg"), img)
    _write_png(os.path.join(root, "lip", "TrainVal_parsing_annotations",
                            "b.png"),
               rng.integers(0, 20, (40, 60)).astype(np.uint8))
    _write_png(os.path.join(root, "pascal_ctx", "JPEGImages", "c.jpg"), img)
    _write_png(os.path.join(root, "pascal_ctx", "masks", "c.png"),
               rng.integers(0, 60, (40, 60)).astype(np.uint8))
    for name, line in (("cs.lst", "leftImg8bit/a.png gtFine/a.png"),
                       ("lip.lst", "b.jpg b.png"),
                       ("ctx.lst", "JPEGImages/c.jpg masks/c.png")):
        with open(os.path.join(root, name), "w") as f:
            f.write(line + "\n")
    return root


@pytest.mark.parametrize("cls,lst,kw", [
    ("CityscapesParsing", "cs.lst", dict(crop_size=(24, 32), base_size=48)),
    ("LIPParsing", "lip.lst", dict(crop_size=(24, 24), base_size=24)),
    ("PascalContextParsing", "ctx.lst", dict(crop_size=(24, 24),
                                             base_size=24))])
@pytest.mark.parametrize("is_train", [True, False])
def test_legacy_samples_match_jax(legacy_root, cls, lst, kw, is_train):
    got = getattr(legacy, cls)(legacy_root, lst, is_train=is_train, seed=3,
                               **kw)
    want = getattr(jlegacy, cls)(legacy_root, lst, is_train=is_train,
                                 seed=3, **kw)
    for _ in range(3):
        _same_sample(got[0], want[0])


def test_legacy_helpers_match_jax():
    rng = np.random.default_rng(8)
    raw = rng.choice(list(jlegacy.CITYSCAPES_ID_TO_TRAIN) + [0, 29],
                     (6, 7)).astype(np.int32)
    for inverse in (False, True):
        x = raw if not inverse else rng.integers(0, 19, (6, 7))
        np.testing.assert_array_equal(
            legacy.cityscapes_convert_label(x, -1, inverse),
            jlegacy.cityscapes_convert_label(x, -1, inverse))
    lip = rng.integers(0, 20, (6, 7))
    np.testing.assert_array_equal(legacy.lip_swap_flip_labels(lip),
                                  jlegacy.lip_swap_flip_labels(lip))
    ids = rng.choice(legacy.PASCAL_CTX_MAPPING, (6, 7))
    np.testing.assert_array_equal(legacy.pascal_ctx_class_to_index(ids),
                                  jlegacy.pascal_ctx_class_to_index(ids))
    for n in (59, 60):
        np.testing.assert_array_equal(
            legacy.pascal_ctx_label_transform(ids % 60, n),
            jlegacy.pascal_ctx_label_transform(ids % 60, n))
    assert legacy.seg_palette(256) == jlegacy.seg_palette(256)
    np.testing.assert_array_equal(legacy.CITYSCAPES_CLASS_WEIGHTS,
                                  jlegacy.CITYSCAPES_CLASS_WEIGHTS)


# ---- the model, its step, load_pretrained, inference ----------------------

def _jax_model():
    """JAX's width-4 f32 SegHRNet and its variables, BN state moved off
    its init so the eval forward reads real statistics."""
    rng = np.random.default_rng(0)
    model = JaxSegHRNet(num_classes=N_CLASS, width=WIDTH, dtype=jnp.float32)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), train=False)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.abs(a + 0.1 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32))),
        v["batch_stats"])
    return model, v["params"], stats


@pytest.fixture(scope="module")
def seg_pair():
    """JAX's model and the port's, loaded from its trees (strict), and a
    seeded (2, 33, 33, 3) input."""
    jmodel, params, stats = _jax_model()
    model = SegHRNet(num_classes=N_CLASS, width=WIDTH, dtype=torch.float32)
    model.load_state_dict(seg_flax_to_torch(params, stats), strict=True)
    x = np.random.default_rng(1).standard_normal(
        (2, CROP, CROP, 3)).astype(np.float32)
    return jmodel, params, stats, model, x


def test_reference_names_and_shapes():
    """The backbone at the top level under the HRNet names, the head as
    seg_hrnet.py's last_layer.0/1/3; momentum 0.01 on last_layer.1."""
    model = SegHRNet(num_classes=N_CLASS, width=18)
    sd = model.state_dict()
    bare = HRNet(HRNET_CONFIGS[18], 3).state_dict()
    head = {k for k in sd if k.startswith("last_layer.")}
    assert set(sd) - head == set(bare)
    assert sorted(head) == sorted(
        ["last_layer.0.weight", "last_layer.0.bias", "last_layer.3.weight",
         "last_layer.3.bias"] + [f"last_layer.1.{t}" for t in (
             "weight", "bias", "running_mean", "running_var",
             "num_batches_tracked")])
    assert tuple(sd["last_layer.0.weight"].shape) == (270, 270, 1, 1)
    assert tuple(sd["last_layer.3.weight"].shape) == (N_CLASS, 270, 1, 1)
    assert model.last_layer[1].momentum == 0.01


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_seghrnet_forward_matches_jax(seg_pair, mode):
    """Crop 33 (branches 9/5/3/2, fuse-layer and merge resizes at
    non-integer ratios): the 9x9 logits; in training also every BN's
    running statistics after the forward (F1-scaled)."""
    jmodel, params, stats, model, x = seg_pair
    model = copy.deepcopy(model)
    xt = _t(x).permute(0, 3, 1, 2)
    if mode == "eval":
        want = jmodel.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model.eval()(xt)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
        return
    rows = tpc.bn_rows(model, xt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want, mut = jmodel.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = model.train()(xt)
    assert tuple(got.shape) == (2, N_CLASS, 9, 9)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    n = tpc.check_bn_stats(model, before, params, stats, mut["batch_stats"],
                           rows, convert=seg_flax_to_torch, **TOL)
    assert n == len(rows) > 0


def test_sgd_poly_steps_match_jax(seg_pair):
    """Two steps of the CLI's train step (poly lr at max_iters 4, class-
    weighted CE, SGD momentum 0.9 + L2) against the JAX CLI's optax chain:
    every parameter and BN statistic within TOL, and the losses."""
    jmodel, params, stats, model, x = seg_pair
    model = copy.deepcopy(model)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, N_CLASS, (2, 2, CROP, CROP)).astype(np.int32)
    labels[:, :, :4] = 255
    weights = np.asarray(datasets.CLASS_WEIGHTS_25, np.float32)
    max_iters, lr, wd, mom = 4, 7e-3, 5e-4, 0.9

    lr_fn = lambda step: lr * (  # noqa: E731
        1.0 - jnp.minimum(step, max_iters - 1) / max_iters) ** 0.9
    tx = optax.chain(optax.add_decayed_weights(wd), optax.trace(decay=mom),
                     optax.scale_by_learning_rate(lr_fn))
    opt_state = tx.init(params)

    def loss_fn(p, bs, lab):
        logits, mut = jmodel.apply({"params": p, "batch_stats": bs},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return jcrit.cross_entropy_seg(logits, lab, jnp.asarray(weights)), \
            mut["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=mom,
                          weight_decay=wd)
    step = train.make_train_step(
        model, opt, train.poly_lr_fn(lr, max_iters),
        lambda lo, la: crit.cross_entropy_seg(lo, la, _t(weights)))
    rows = tpc.bn_rows(model, _t(x).permute(0, 3, 1, 2))
    jp, js = params, stats
    for s in range(2):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        js_before = js
        (jl, js), g = grad_fn(jp, js, jnp.asarray(labels[s]))
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        m = step({"image": _t(x), "label": _t(labels[s])}, s)
        np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
        np.testing.assert_allclose(m["learning_rate"], float(lr_fn(s)),
                                   rtol=2.5e-7)
        tpc.check_bn_stats(model, before, jp, js_before, js, rows,
                           convert=seg_flax_to_torch, **TOL)
    want = seg_flax_to_torch(jp, js)
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                       err_msg=k)


@pytest.mark.parametrize("prefix", ["", "model."])
def test_load_pretrained_matches_jax(seg_pair, tmp_path, prefix):
    """An exported HRNet state dict (the reference's `model.` prefix or
    none) loads into both: the same conv count, every backbone conv (and
    no head conv), and equal eval forwards after."""
    jmodel, params, stats, model, x = seg_pair
    torch.manual_seed(3)
    src = HRNet(HRNET_CONFIGS[WIDTH], 3, torch.float32)
    with torch.no_grad():
        for name, b in src.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    path = str(tmp_path / "enc.pth")
    torch.save({prefix + k: v for k, v in src.state_dict().items()}, path)

    jp, js, jn = jax_load_pretrained(path, params, stats)
    port = copy.deepcopy(model)
    n = load_pretrained(path, port)
    convs = sum(1 for m in src.modules() if isinstance(m, torch.nn.Conv2d))
    assert n == jn == convs
    assert torch.equal(port.conv1.weight, src.conv1.weight)
    assert torch.equal(port.last_layer[0].weight, model.last_layer[0].weight)
    want = jmodel.apply({"params": jp, "batch_stats": js}, jnp.asarray(x),
                        train=False)
    with torch.no_grad():
        got = port.eval()(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_sliding_window_flip_tta_matches_jax(seg_pair):
    """A 40x56 image at scales 0.75 and 1.0 with a 24x24 crop (several
    overlapping windows), flip TTA with the depth sets' class-pair swap,
    through JAX's and the port's model on the same weights."""
    jmodel, params, stats, model, _ = seg_pair
    img = np.random.default_rng(9).standard_normal(
        (40, 56, 3)).astype(np.float32)
    pairs = datasets.mapped_pairs()

    @jax.jit
    def apply_fn(x):
        return jmodel.apply({"params": params, "batch_stats": stats}, x,
                            train=False)

    kw = dict(crop_size=(24, 24), scales=(0.75, 1.0), flip=True,
              flip_pairs=pairs)
    want = jax_sliding_window(apply_fn, img, N_CLASS, **kw)
    got = sliding_window_inference(model.eval(), img, N_CLASS, **kw,
                                   device="cpu")
    assert got.shape == (40, 56, N_CLASS)
    np.testing.assert_allclose(got, want, **TOL)


# ---- the CLI ---------------------------------------------------------------

def test_cli_trains_validates_and_tests(seg_tree, tmp_path, capsys):
    """One step on the fixture tree from an exported encoder, its
    validation's mIoU and the best weights written; then --test_only
    from them with flip TTA at two scales."""
    src = HRNet(HRNET_CONFIGS[WIDTH], 3, torch.float32)
    pth = str(tmp_path / "encoder2.pth")
    torch.save(src.state_dict(), pth)
    best = str(tmp_path / "best.pt")
    argv = ["--device", "cpu", "--root", seg_tree, "--train_list",
            os.path.join(seg_tree, "train.txt"), "--val_list",
            os.path.join(seg_tree, "val.txt"), "--crop", str(CROP),
            "--width", str(WIDTH), "--batch_size", "2", "--epochs", "1",
            "--max_steps", "1", "--print_freq", "1", "--restore", best]
    run = train.main(argv + ["--pretrained", pth])
    out = capsys.readouterr().out
    convs = sum(1 for m in src.modules() if isinstance(m, torch.nn.Conv2d))
    assert f"=> loaded {convs} conv tensors" in out
    assert re.search(r"Train: \[1\]\[1/2\] .*loss", out)
    assert re.search(r"epoch 1: mIoU \d\.\d+ \(best\)", out)
    assert len(run.step_s) == 1 and np.isfinite(run.metrics[0]["loss"])
    assert os.path.exists(best)
    run = train.main(argv + ["--test_only", "--eval_flip", "--test_scales",
                             "0.75,1.0"])
    out = capsys.readouterr().out
    assert "=> restored weights" in out
    assert re.search(r"testval mIoU: \d\.\d+", out)
    assert len(run.scores) == 1 and 0.0 <= run.scores[0] <= 1.0


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--synthetic", "4", "--crop", "32", "--width", "4"])
