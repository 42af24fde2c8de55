"""The downstream trainers (downstream/seg/train.py, downstream/a2j/
train.py) on two gloo ranks, held to one process.

* Their datasets' row sharding: a rank's DataSource decodes its rows of
  each global batch and consumes the other rows' augmentation draws
  (`skip_draws`), so the ranks' batches put back in row order are the
  one-process batch bit for bit (one decode thread): the Parsing-4K
  training set (flip, scale jitter, random crop), the ITOP set (shift,
  rotation, scale) and the legacy Cityscapes, LIP and PASCAL-Context
  sets on images of several sizes (their crop ranges follow from each
  label's size).
* Each trainer's CLI on two ranks (`--multihost --device cpu`, synthetic
  data, width 4, f32, 2 steps; A2J 1; the parsing trainer also on the
  legacy LIP set, `--dataset lip`, one step: off synthetic data its model
  runs in bf16, whose rounding under the ranks' other order of the BN
  sums moves a second step's loss by 4e-5 relative): the ranks end equal
  bit for bit, and
  within rtol 1e-5, atol 3e-6 (f32 rounding: the sums' order) of the same
  CLI in one process with the ranks' BN formula
  (torch_dp_common.ranks_formula), step losses included; the
  parsing trainer with the class-weighted CE and with OHEM, whose
  threshold is the global batch's (the ranks' probabilities gathered).
  A2J trains with Adam, whose first step turns a gradient at the f32
  noise floor into a full lr step of either sign: there (at most 1e-3 of
  the elements) its parameters are held to 2 lr, as
  tests/test_torch_a2j.py holds them against JAX.
  The one-process trainers are held to the JAX package by
  tests/test_torch_downstream_seg.py and tests/test_torch_a2j.py.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hcmoco_tpu_torch.data import fixtures
from hcmoco_tpu_torch.data.pipeline import DataSource
from hcmoco_tpu_torch.downstream.a2j import data as a2j_data
from hcmoco_tpu_torch.downstream.seg import legacy
from hcmoco_tpu_torch.downstream.seg.datasets import ParsingDataset
from hcmoco_tpu_torch.downstream.seg import train as seg_train
from hcmoco_tpu_torch.parallel import mesh
from hcmoco_tpu_torch.parallel.mesh import shard_positions

from torch_dp_common import ranks_formula, ranks_running
from torch_dp_worker import run_downstream

torch.set_num_threads(1)

BSZ = 4
TOL = dict(rtol=1e-5, atol=3e-6)
# Adam's first step moves an element by lr * g / (|g| + eps): where g is
# at the f32 rounding of the sums, so is the step's sign.  Such elements
# (at most 1e-3 of them; 0.07% measured) may part by 2 lr.  One step:
# from those, the second step's Adam moments part 29% of the elements by
# more than the tolerance.
A2J_LR = 3.5e-4


def _batches(make, rows, n=3):
    it = iter(make(rows))
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _check_sharded(make):
    want = _batches(make, None)
    rows = [shard_positions(BSZ, r, 2) for r in range(2)]
    got = [_batches(make, r) for r in rows]
    for i, w in enumerate(want):
        for k, v in w.items():
            whole = np.concatenate([g[i][k] for g in got])
            assert whole.dtype == v.dtype, k
            np.testing.assert_array_equal(whole, v, err_msg=f"{i} {k}")


def test_parsing_rows_decode_bit_for_bit(tmp_path):
    ntu = str(tmp_path / "ntu")
    fixtures.make_ntu_fixture(ntu, n_frames=1)
    seg, lst = fixtures.make_seg_fixture(str(tmp_path / "seg"), ntu,
                                         n_frames=6)

    def make(rows):
        ds = ParsingDataset(seg, lst, crop_size=(33, 33), base_size=33,
                            seed=5)
        return DataSource(ds, BSZ, np.ones(len(ds)), seed=2, num_workers=1,
                          rows=rows)

    _check_sharded(make)


def test_itop_rows_decode_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(a2j_data, "CROP_H", 32)
    monkeypatch.setattr(a2j_data, "CROP_W", 32)
    tr, _, btr, _ = a2j_data.make_itop_fixture(str(tmp_path / "itop"),
                                               n_train=8, n_test=2)
    import pickle
    with open(btr, "rb") as f:
        bnd = np.asarray(pickle.load(f))

    def make(rows):
        ds = a2j_data.ITOPDataset(tr, bnd, augment=True, seed=4)
        return DataSource(ds, BSZ, np.ones(len(ds)), seed=2, num_workers=1,
                          rows=rows)

    _check_sharded(make)


# (h, w) of the legacy sets' training images and labels: wider, taller,
# smaller and larger than the crops below
LEGACY_SIZES = ((40, 60), (60, 40), (20, 28), (52, 70), (33, 33), (70, 48),
                (36, 44), (28, 56))
LEGACY = {"cityscapes": (legacy.CityscapesParsing, "cs.lst",
                         dict(crop_size=(24, 32), base_size=48)),
          "lip": (legacy.LIPParsing, "lip.lst",
                  dict(crop_size=(24, 24), base_size=24)),
          "pascal_ctx": (legacy.PascalContextParsing, "ctx.lst",
                         dict(crop_size=(24, 24), base_size=24))}


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def legacy_root(tmp_path_factory):
    """The three legacy sets' layouts (downstream/seg/legacy.py) with an
    image and label of each LEGACY_SIZES size, Cityscapes with one
    image-only (test split) entry too, and a LIP validation list of 33^2
    images."""
    root = str(tmp_path_factory.mktemp("legacy"))
    rng = np.random.default_rng(0)
    lines = {"cs.lst": [], "lip.lst": [], "ctx.lst": [], "lip_val.lst": []}
    cs_ids = list(legacy.CITYSCAPES_ID_TO_TRAIN) + [0, 29]
    sizes = [(hw, "lip.lst") for hw in LEGACY_SIZES] + [
        ((33, 33), "lip_val.lst")] * 4
    for i, ((h, w), lip_list) in enumerate(sizes):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        name = f"{i}.png"
        _png(os.path.join(root, "lip", "TrainVal_images", name), img)
        _png(os.path.join(root, "lip", "TrainVal_parsing_annotations", name),
             rng.integers(0, 20, (h, w)).astype(np.uint8))
        lines[lip_list].append(f"{name} {name}")
        if lip_list == "lip_val.lst":
            continue
        _png(os.path.join(root, "cityscapes", "img", name), img)
        _png(os.path.join(root, "cityscapes", "gt", name),
             rng.choice(cs_ids, (h, w)).astype(np.uint8))
        _png(os.path.join(root, "pascal_ctx", "img", name), img)
        _png(os.path.join(root, "pascal_ctx", "masks", name),
             rng.integers(0, 60, (h, w)).astype(np.uint8))
        lines["cs.lst"].append(f"img/{name} gt/{name}")
        lines["ctx.lst"].append(f"img/{name} masks/{name}")
    lines["cs.lst"].append("img/0.png")
    for name, entries in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(entries) + "\n")
    return root


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_rows_decode_bit_for_bit(legacy_root, name):
    cls, lst, kw = LEGACY[name]

    def make(rows):
        ds = cls(legacy_root, lst, seed=5, **kw)
        return DataSource(ds, BSZ, np.ones(len(ds)), seed=2, num_workers=1,
                          rows=rows)

    _check_sharded(make)


SEG = ["--device", "cpu", "--synthetic", "8", "--crop", "33", "--width",
       "4", "--batch_size", str(BSZ), "--epochs", "1", "--max_steps", "2",
       "--print_freq", "1", "--seed", "0"]
A2J = ["--device", "cpu", "--synthetic", "8", "--crop", "32", "--width",
       "4", "--batch_size", str(BSZ), "--epochs", "1", "--max_steps", "1",
       "--print_freq", "1", "--seed", "0"]


# the legacy LIP set of legacy_root ({root}), 33^2 crops; one decode
# thread, whose draws from the set's generator follow the batch order
SEG_LIP = ["--device", "cpu", "--dataset", "lip", "--root", "{root}",
           "--train_list", "lip.lst", "--val_list", "lip_val.lst",
           "--crop", "33", "--width", "4", "--batch_size", str(BSZ),
           "--epochs", "1", "--max_steps", "1", "--print_freq", "1",
           "--seed", "0", "--num_workers", "1"]


TRAINERS = {"seg": ("seg", SEG),
            "seg-ohem": ("seg", SEG + ["--ohem", "--ohem_keep", "300"]),
            "seg-lip": ("seg", SEG_LIP),
            "a2j": ("a2j", A2J)}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, legacy_root):
    """One pair of ranks runs every TRAINERS CLI in turn while this
    process runs each alone; by name, (the ranks' results, this
    process's)."""
    clis = [(which, [a.replace("{root}", legacy_root) for a in argv])
            for which, argv in TRAINERS.values()]
    with ranks_running(None, str(tmp_path_factory.mktemp("trainers")),
                       clis=[(which, argv + ["--multihost"])
                             for which, argv in clis]) as ranks:
        with ranks_formula():
            one = [run_downstream(which, argv) for which, argv in clis]
        got = ranks()
    return {name: ([r[i] for r in got], one[i])
            for i, name in enumerate(TRAINERS)}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_on_two_ranks_is_one_process(trainer_runs, name):
    which = TRAINERS[name][0]
    ranks, one = trainer_runs[name]
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert len(one["metrics"]) == len(ranks[0]["metrics"]) \
        == (2 if name in ("seg", "seg-ohem") else 1)
    for s, (a, b) in enumerate(zip(ranks[0]["metrics"], one["metrics"])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **TOL,
                                       err_msg=f"step {s} {k}")
    n_out = n_all = 0
    for k, v in one["model"].items():
        if not v.is_floating_point():
            continue
        got, want = ranks[0]["model"][k].numpy(), v.numpy()
        if which == "seg":
            np.testing.assert_allclose(got, want, **TOL, err_msg=k)
            continue
        out = ~np.isclose(got, want, **TOL)
        n_out, n_all = n_out + int(out.sum()), n_all + out.size
        assert np.abs(got - want)[out].max(initial=0.0) <= 2 * A2J_LR \
            * (1 + 1e-3), k
    assert n_out <= 1e-3 * max(n_all, 1), (n_out, n_all)


def test_multihost_without_torchrun_raises(monkeypatch):
    """With neither torchrun's nor a SLURM job step's environment,
    --multihost raises and names both launchers."""
    for k in mesh.TORCHRUN_ENV + mesh.SLURM_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun.*SLURM.*srun"):
        seg_train.main(SEG + ["--multihost"])
