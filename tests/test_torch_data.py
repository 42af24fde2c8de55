"""The port's host data pipeline (hcmoco_tpu_torch/data/) held against the
JAX package's (hcmoco_tpu/data/) on the fixture trees that both write.

Both are the same numpy/PIL code, so every comparison is exact
(np.array_equal, dtypes equal).  Datasets draw from their own seeded
numpy Generators: the same seed gives the same stream on both sides.
DataSource batches are compared at num_workers=1, where both consume the
stream in submission order (with more workers the shared per-dataset
generator makes the draws depend on thread timing, on both sides).
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from hcmoco_tpu.core import config as jax_config
from hcmoco_tpu.data import combined as jax_combined
from hcmoco_tpu.data import fixtures as jax_fixtures
from hcmoco_tpu.data import ntu as jax_ntu
from hcmoco_tpu.data import pipeline as jax_pipeline
from hcmoco_tpu.data import transforms as jax_transforms

from hcmoco_tpu_torch.core import config
from hcmoco_tpu_torch.data import combined, fixtures, ntu, pipeline, transforms

SIZE = 32


def assert_same(got, want, label=""):
    """Equal dicts (or arrays, tuples, scalars) of numpy values, exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), label
        for k in want:
            assert_same(got[k], want[k], f"{label}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{label}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (label, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=label)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """NTU, MPII, COCO and Parsing-4K trees, written by the port's
    writers (test_fixture_files_match_jax holds them to the JAX ones)."""
    root = str(tmp_path_factory.mktemp("trees"))
    ntu_root, ntu_list = fixtures.make_ntu_fixture(
        os.path.join(root, "ntu"), n_frames=6)
    mpii = fixtures.make_mpii_fixture(os.path.join(root, "mpii"))
    coco = fixtures.make_coco_fixture(os.path.join(root, "coco"))
    seg_root, seg_list = fixtures.make_seg_fixture(
        os.path.join(root, "seg"), ntu_root)
    return dict(ntu=ntu_root, ntu_list=ntu_list, mpii=mpii, coco=coco,
                seg=seg_root, seg_list=seg_list)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("writer,kw", [
    ("make_ntu_fixture", dict(n_frames=3)),
    ("make_mpii_fixture", dict(n_images=3)),
    ("make_coco_fixture", dict(n_images=3)),
    ("make_seg_fixture", dict(n_frames=3)),
])
def test_fixture_files_match_jax(tmp_path, writer, kw):
    """At their default sizes the port's writers write the JAX package's
    files, byte for byte."""
    trees_ = {}
    for name, mod in (("port", fixtures), ("jax", jax_fixtures)):
        root = str(tmp_path / name / "main")
        if writer == "make_seg_fixture":
            getattr(mod, writer)(root, str(tmp_path / name / "ntu"), **kw)
        else:
            getattr(mod, writer)(root, **kw)
        trees_[name] = str(tmp_path / name)
    files = _tree_files(trees_["jax"])
    assert files and _tree_files(trees_["port"]) == files
    for f in files:
        a, b = (os.path.join(trees_[n], f) for n in ("port", "jax"))
        if f.endswith(".txt"):  # file lists name their own tree
            assert (open(a).read().replace(trees_["port"], "")
                    == open(b).read().replace(trees_["jax"], "")), f
        else:
            assert filecmp.cmp(a, b, shallow=False), f


@pytest.mark.parametrize("h,w", [(96, 128), (424, 512), (60, 80)])
def test_fixture_frame_size(tmp_path, h, w):
    """The writers take the frame size; the datasets read it back."""
    root, lst = fixtures.make_ntu_fixture(str(tmp_path / "ntu"), n_frames=2,
                                          h=h, w=w)
    mpii = fixtures.make_mpii_fixture(str(tmp_path / "mpii"), n_images=2,
                                      h=h, w=w)
    ds = ntu.NTUSkeleton3D(root, lst, size=SIZE, random_resized_crop=True)
    assert ds._frame_hw(0) == (h, w)
    img = np.asarray(ntu.Image.open(os.path.join(mpii, "images",
                                                 "000000000.jpg")))
    assert img.shape == (h, w, 3)
    s = combined.NTUMPIIGCN(root, lst, mpii, "train", size=SIZE)[0]
    assert s["rgbd"].shape == (SIZE, SIZE, 6)


@pytest.mark.parametrize("h,w", [(96, 128), (424, 512)])
def test_seg_fixture_frame_size(tmp_path, h, w):
    """The Parsing-4K writer takes the frame size; NTUSegJoint reads its
    frames, labels and skeletons back (one labelled frame, the label
    cropped with the rgb-depth pair)."""
    root, lst = fixtures.make_ntu_fixture(str(tmp_path / "ntu"), n_frames=2,
                                          h=h, w=w)
    seg, seg_list = fixtures.make_seg_fixture(str(tmp_path / "seg"), root,
                                              n_frames=2, h=h, w=w)
    img = np.asarray(ntu.Image.open(os.path.join(
        seg, "png_annotation_v2", "S001C001P001R001A001F001.png")))
    assert img.shape == (h, w)
    ds = combined.NTUSegJoint(root, lst, seg, seg_list, size=SIZE,
                              only_seg=True)
    assert len(ds) == 2
    s = ds[1]
    assert s["rgbd"].shape == (SIZE, SIZE, 6) and int(s["true_label"]) == 1
    assert s["label"].shape == (SIZE, SIZE)


# (class, constructor kwargs) for every NTU dataset class
NTU_CASES = {
    "pairs": ("NTURGBDPairs", dict(random_flip=True,
                                   random_resized_crop=True)),
    "pairs_plain": ("NTURGBDPairs", dict()),
    "skeleton": ("NTUSkeleton3D", dict(random_flip=True,
                                       random_resized_crop=True)),
    "skeleton_full_frame": ("NTUSkeleton3D", dict(random_flip=True)),
    "heatmap": ("NTUHeatmap", dict(random_flip=True,
                                   random_resized_crop=True)),
}


@pytest.mark.parametrize("case", sorted(NTU_CASES))
def test_ntu_items_match_jax(trees, case):
    cls, kw = NTU_CASES[case]
    got = getattr(ntu, cls)(trees["ntu"], trees["ntu_list"], size=SIZE,
                            seed=3, **kw)
    want = getattr(jax_ntu, cls)(trees["ntu"], trees["ntu_list"], size=SIZE,
                                 seed=3, **kw)
    for i in (0, 3, 1, 5, 0):
        assert_same(got[i], want[i], f"{case}[{i}]")


@pytest.mark.parametrize("raw_output", [False, True])
def test_load_raw_matches_jax(trees, raw_output):
    """load_raw's (rgbd, joints3d, skeleton dict, crop params), and with
    out_pair the slots it writes."""
    kw = dict(size=SIZE, random_flip=True, random_resized_crop=True, seed=4)
    got = ntu.NTUSkeleton3D(trees["ntu"], trees["ntu_list"], **kw)
    want = jax_ntu.NTUSkeleton3D(trees["ntu"], trees["ntu_list"], **kw)
    for i in range(4):
        g, w = got.load_raw(i, raw_output=raw_output), want.load_raw(
            i, raw_output=raw_output)
        assert_same(g[0], w[0], f"rgbd[{i}]")
        assert_same(g[1], w[1], f"joints3d[{i}]")
        assert g[3] == w[3]
        assert_same(g[2]["joints"][0]["d_loc"], w[2]["joints"][0]["d_loc"])
    if raw_output:
        slots = [(np.zeros((SIZE, SIZE, 3), np.uint8),
                  np.zeros((SIZE, SIZE), np.uint16)) for _ in range(2)]
        g = got.load_raw(2, raw_output=True, out_pair=slots[0])
        w = want.load_raw(2, raw_output=True, out_pair=slots[1])
        assert_same(slots[0], slots[1], "out_pair")
        assert_same(g[0], w[0], "out_pair rgbd")


def test_raw_output_items_match_jax(trees):
    kw = dict(size=SIZE, random_flip=True, random_resized_crop=True, seed=2)
    got = ntu.NTUSkeleton3D(trees["ntu"], trees["ntu_list"], **kw)
    want = jax_ntu.NTUSkeleton3D(trees["ntu"], trees["ntu_list"], **kw)
    got.raw_output = want.raw_output = True
    for i in (1, 4):
        item = got[i]
        assert_same(item, want[i], f"raw[{i}]")
        assert item["rgb_u8"].dtype == np.uint8


COMBINED_CASES = {
    "ntumpii": ("NTUMPIIGCN", "mpii", "train", dict()),
    "ntumpii_grid": ("NTUMPIIGCN", "mpii", "train", dict(with_grid=True)),
    "ntumpii_flip": ("NTUMPIIGCN", "mpii", "train",
                     dict(random_flip=True, with_grid=True)),
    "ntucoco": ("NTUCOCOGCN", "coco", "train2014", dict()),
    "ntucoco_grid": ("NTUCOCOGCN", "coco", "train2014",
                     dict(random_flip=True, with_grid=True)),
}


@pytest.mark.parametrize("case", sorted(COMBINED_CASES))
def test_combined_items_match_jax(trees, case):
    """MPII/COCO samples first, then NTU; with and without with_grid."""
    cls, aux, image_set, kw = COMBINED_CASES[case]
    args = (trees["ntu"], trees["ntu_list"], trees[aux], image_set)
    got = getattr(combined, cls)(*args, size=SIZE, seed=5, **kw)
    want = getattr(jax_combined, cls)(*args, size=SIZE, seed=5, **kw)
    assert len(got) == len(want) and got.aux_len == want.aux_len
    for i in list(range(len(want))) + [0, got.aux_len]:
        assert_same(got[i], want[i], f"{case}[{i}]")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mask_seg_depth=True),
    dict(mask_seg_rgb=True),
    dict(only_seg=True),
], ids=["plain", "mask_depth", "mask_rgb", "only_seg"])
def test_seg_joint_items_match_jax(trees, kw):
    args = (trees["ntu"], trees["ntu_list"], trees["seg"], trees["seg_list"])
    got = combined.NTUSegJoint(*args, size=SIZE, random_resized_crop=True,
                               seed=6, skeleton_root=trees["ntu"], **kw)
    want = jax_combined.NTUSegJoint(*args, size=SIZE,
                                    random_resized_crop=True, seed=6,
                                    skeleton_root=trees["ntu"], **kw)
    assert (len(got), got.split, got.aux_len) == (len(want), want.split,
                                                  want.aux_len)
    for i in range(len(want)):
        assert_same(got[i], want[i], f"seg[{i}]")
    assert_same(combined.seg_label_mapper(), jax_combined.seg_label_mapper())


@pytest.mark.parametrize("total,first,second", [(10, 4, 6), (100, 90, 10),
                                                (7, 7, 7), (9, 0, 9)])
def test_mixing_weights_match_jax(total, first, second):
    assert_same(pipeline.mixing_weights(total, first, second),
                jax_pipeline.mixing_weights(total, first, second))


@pytest.mark.parametrize("seed", [0, 11])
def test_weighted_sampler_draws_match_jax(seed):
    w = pipeline.mixing_weights(100, 90, 10)
    got = pipeline.WeightedBatchSampler(w, seed=seed)
    want = jax_pipeline.WeightedBatchSampler(w, seed=seed)
    for bsz in (4, 512, 3):
        assert_same(got.draw(bsz), want.draw(bsz))
    # uniform weights and all-zero weights (p=None) too
    for weights in (np.ones(9), np.zeros(9)):
        assert_same(pipeline.WeightedBatchSampler(weights, seed).draw(16),
                    jax_pipeline.WeightedBatchSampler(weights, seed).draw(16))


def test_collate_matches_jax(trees):
    ds = combined.NTUMPIIGCN(trees["ntu"], trees["ntu_list"], trees["mpii"],
                             "train", size=SIZE)
    samples = [ds[i] for i in (0, 4, 7)]
    assert_same(pipeline.collate(samples), jax_pipeline.collate(samples))


@pytest.mark.parametrize("with_grid", [False, True])
def test_data_source_batches_match_jax(trees, with_grid):
    """Three batches of the weighted, prefetching DataSource, one worker."""
    sources = []
    for mod, cmod in ((pipeline, combined), (jax_pipeline, jax_combined)):
        ds = cmod.NTUMPIIGCN(trees["ntu"], trees["ntu_list"], trees["mpii"],
                             "train", size=SIZE, random_flip=True, seed=1,
                             with_grid=with_grid)
        w = mod.mixing_weights(len(ds), ds.aux_len, len(ds) - ds.aux_len)
        sources.append(iter(mod.DataSource(ds, 4, w, seed=2,
                                           num_workers=1)))
    try:
        for k in range(3):
            got, want = next(sources[0]), next(sources[1])
            assert got["rgbd"].shape == (4, SIZE, SIZE, 6)
            assert_same(got, want, f"batch {k}")
    finally:
        for s in sources:
            s.close()


STAGE_RECIPES = sorted(config.RECIPES)


@pytest.mark.parametrize("name", STAGE_RECIPES)
def test_build_contrast_source_matches_jax(trees, name):
    """Each stage and versatility recipe (at batch 4, crop 32) on the
    fixture trees: the same n_data, steps_per_epoch and first batch."""
    kw = dict(batch_size=4, crop_size=SIZE, data_folder=trees["ntu"],
              train_file_list=trees["ntu_list"], mpii_root=trees["mpii"],
              coco_root=trees["coco"], seg_root=trees["seg"],
              seg_file_list=trees["seg_list"], seed=3)
    got = pipeline.build_contrast_source(
        dataclasses.replace(config.RECIPES[name], **kw), num_workers=1)
    want = jax_pipeline.build_contrast_source(
        dataclasses.replace(jax_config.RECIPES[name], **kw))
    want[0].num_workers = 1
    assert got[1:] == want[1:]
    # NTU frames, then MPII or COCO people or Parsing-4K frames
    assert got[1] == 6 + 3
    its = [iter(got[0]), iter(want[0])]
    try:
        b = next(its[0])
        assert_same(b, next(its[1]), name)
        # NTUSegJoint always tracks the crop's pixel coordinates
        assert ("grid_xy" in b) and (b["grid_xy"].any() == (
            "hrnetpn" in name or name.startswith("versatility/")))
    finally:
        for it in its:
            it.close()


@pytest.mark.parametrize("dataset", ["NTUSeg", "NTURGBD", "folder"])
def test_build_contrast_source_other_keys(trees, dataset, tmp_path):
    """The versatility (NTUSeg), single-NTU and ImageFolder-baseline keys
    match the JAX package's; the last on a fixture tree with InfoMin's
    data (two crops of policy D on channels and the jigsaw stack)."""
    base = dict(batch_size=2, crop_size=SIZE, data_folder=trees["ntu"],
                train_file_list=trees["ntu_list"], seg_root=trees["seg"],
                seg_file_list=trees["seg_list"], dataset=dataset, seed=1,
                modal="RGBD2S" if dataset != "NTURGBD" else "")
    if dataset == "folder":
        root = fixtures.make_image_folder_fixture(str(tmp_path), 2, 3)
        base = dict(batch_size=2, crop_size=SIZE, dataset=dataset, seed=1,
                    data_folder=os.path.join(root, "train"), modal="RGB",
                    mem="moco", jigsaw=True, aug="D")
    cfg = config.TrainConfig(**base)
    got = pipeline.build_contrast_source(cfg, num_workers=1)
    want = jax_pipeline.build_contrast_source(jax_config.TrainConfig(**base))
    want[0].num_workers = 1
    assert got[1:] == want[1:]
    its = [iter(got[0]), iter(want[0])]
    try:
        assert_same(next(its[0]), next(its[1]), dataset)
    finally:
        for it in its:
            it.close()


def test_to_device_cpu_shares_host_arrays():
    """On the CPU the batch is wrapped, not copied; dtypes are kept."""
    batch = {"rgbd": np.ones((2, 4, 4, 6), np.float32),
             "index": np.arange(2, dtype=np.int32),
             "rgb_u8": np.full((2, 4, 4, 3), 7, np.uint8)}
    out = pipeline.to_device(batch, "cpu")
    assert out.keys() == batch.keys()
    for k, v in batch.items():
        assert out[k].device.type == "cpu"
        assert out[k].numpy().dtype == v.dtype
        assert np.shares_memory(out[k].numpy(), v)


@pytest.mark.cuda
def test_to_device_cuda_pinned_upload():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch = {"rgbd": np.random.default_rng(0).standard_normal(
        (2, 8, 8, 6)).astype(np.float32)}
    out = pipeline.to_device(batch, "cuda")
    torch.cuda.synchronize()
    assert out["rgbd"].is_cuda
    np.testing.assert_array_equal(out["rgbd"].cpu().numpy(), batch["rgbd"])


# the transforms, on seeded inputs
def _transform_cases():
    rng = np.random.default_rng(0)
    joints = rng.uniform(0, 100, (16, 2)).astype(np.float32)
    vis = rng.integers(0, 2, 16)
    img = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
    return {
        "random_resized_crop_params": lambda m: [
            m.random_resized_crop_params(np.random.default_rng(s), 96, 128,
                                         (0.08, 1.2), (0.75, 4 / 3))
            for s in range(20)],
        "crop_pad": lambda m: [m.crop_pad(img, i, j, 10, 40)
                               for i, j in ((-5, -5), (3, 4), (20, 25))],
        "normalize_rgb": lambda m: m.normalize_rgb(img),
        "get_affine_transform": lambda m: [
            m.get_affine_transform(np.array([50.0, 40.0]), s, r, (32, 32),
                                   inv=inv)
            for s in (0.6, np.array([0.5, 0.7])) for r in (0.0, 30.0)
            for inv in (False, True)],
        "heatmap": lambda m: m.transform_heatmap(
            m.joint_heatmap_rgb(joints[:, :2] / 4, 24, 30,
                                m.positional_encoding(16)),
            2, 3, 18, 20, (16, 16), True, True),
        "normalize_joints": lambda m: [m.normalize_joints(joints),
                                       m.flip_normalized_joints(
                                           m.normalize_joints(joints))],
        "joint_pairwise_scale": lambda m: [
            m.joint_pairwise_scale(joints, vis),
            m.joint_pairwise_scale(joints, np.zeros(16))],
    }


@pytest.mark.parametrize("name", sorted(_transform_cases()))
def test_transforms_match_jax(name):
    fn = _transform_cases()[name]
    assert_same(fn(transforms), fn(jax_transforms), name)
