"""The port's packed (decode-free) NTU dataset and its native resample held
against the JAX package's and against the file pipeline.

Exact throughout: pack_ntu's files equal the JAX package's byte for byte,
PackedNTUSkeleton items equal the file pipeline's (the native resample is
bit-exact to Pillow) and the JAX pack's, and the slot-writer batches equal
the collate ones.  The native libraries build with g++ into
build/hcmoco_tpu_torch/native/, never into the package directory.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hcmoco_tpu.data import packed as jax_packed
from hcmoco_tpu.data import pipeline as jax_pipeline

from hcmoco_tpu_torch import native
from hcmoco_tpu_torch.data import combined, pipeline
from hcmoco_tpu_torch.data.fixtures import (make_mpii_fixture,
                                            make_ntu_fixture)
from hcmoco_tpu_torch.data.ntu import NTUSkeleton3D
from hcmoco_tpu_torch.data.packed import PackedNTUSkeleton, pack_ntu
from hcmoco_tpu_torch.data.transforms import crop_pad, normalize_rgb
from hcmoco_tpu_torch.train.contrast_step import device_normalize

LIB = native.resample_lib()
SIZE = 32
PACK_FILES = ("rgb.npy", "depth.npy", "joints3d.npy", "joints_d.npy",
              "meta.json")


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root, lst = make_ntu_fixture(str(tmp_path_factory.mktemp("ntu")),
                                 n_frames=5)
    out = str(tmp_path_factory.mktemp("pack"))
    jax_out = str(tmp_path_factory.mktemp("jax_pack"))
    return root, lst, out, pack_ntu(root, lst, out), jax_out, \
        jax_packed.pack_ntu(root, lst, jax_out)


def test_native_libraries_build_outside_the_package():
    assert LIB is not None and native.native_lib() is not None
    for name in ("resample", "preproc"):
        path = native.library_path(name)
        assert path.exists() and native.BUILD_DIR in path.parents
        assert native.library_route(name) == f"native {path}"
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_pack_files_match_jax(packed):
    _, _, out, meta, jax_out, jax_meta = packed
    assert meta == jax_meta
    assert meta["n"] == 5 and (meta["h"], meta["w"]) == (96, 128)
    for f in PACK_FILES:
        assert filecmp.cmp(os.path.join(out, f), os.path.join(jax_out, f),
                           shallow=False), f
    assert json.load(open(os.path.join(out, "meta.json"))) == meta


@pytest.mark.parametrize("flip,rrc", [(True, True), (False, True),
                                      (True, False)])
def test_packed_items_match_file_pipeline_and_jax(packed, flip, rrc):
    """load_raw over the pack (native resample) equals the file pipeline's
    (PIL) and the JAX pack's: the same crop decisions, the same pixels."""
    root, lst, out, _, jax_out, _ = packed
    kw = dict(size=SIZE, random_flip=flip, random_resized_crop=rrc, seed=5)
    dsets = [NTUSkeleton3D(root, lst, **kw), PackedNTUSkeleton(out, **kw),
             jax_packed.PackedNTUSkeleton(jax_out, **kw)]
    for i in (0, 4, 2, 2):
        (ra, ja, _, pa), (rb, jb, _, pb), (rc, jc, _, pc) = (
            d.load_raw(i) for d in dsets)
        assert pa == pb == pc
        for x, y in ((rb, ra), (rb, rc), (jb, ja), (jb, jc)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_combined_dataset_on_pack(packed, tmp_path):
    root, lst, out, _, _, _ = packed
    mpii = make_mpii_fixture(str(tmp_path / "mpii"))
    ds = combined.NTUMPIIGCN(root, lst, mpii, "train", size=SIZE,
                             ntu_dataset=PackedNTUSkeleton(
                                 out, size=SIZE, random_resized_crop=True),
                             with_grid=True)
    s = ds[len(ds.db)]  # an NTU sample through the pack
    assert s["rgbd"].shape == (SIZE, SIZE, 6)
    assert int(s["use_depth"]) == 1 and s["grid_xy"].any()


def _sources(pack_dir, cls, slot_writer: bool, n: int):
    ds = cls(pack_dir, size=SIZE, random_flip=True, random_resized_crop=True,
             seed=7, raw_output=True)
    if not slot_writer:
        ds.getitem_into = None  # the submit-collate path
    mod = pipeline if cls is PackedNTUSkeleton else jax_pipeline
    return iter(mod.DataSource(ds, 4, np.ones(n), seed=3, num_workers=1))


def test_slot_writer_path_matches_collate_and_jax(packed):
    """DataSource's getitem_into path (the native resample writes each
    batch row in place) equals the collate path and the JAX package's slot
    path, one worker."""
    _, _, out, meta, jax_out, _ = packed
    its = [_sources(out, PackedNTUSkeleton, True, meta["n"]),
           _sources(out, PackedNTUSkeleton, False, meta["n"]),
           _sources(jax_out, jax_packed.PackedNTUSkeleton, True, meta["n"])]
    try:
        for _ in range(3):
            a, b, c = (next(it) for it in its)
            assert set(a) == set(b) == set(c) >= {"rgb_u8", "depth_mm"}
            for k in a:
                for other in (b, c):
                    assert a[k].dtype == other[k].dtype, k
                    np.testing.assert_array_equal(a[k], other[k])
    finally:
        for it in its:
            it.close()


def test_raw_output_matches_host_normalize(packed):
    """The step's device_normalize of the raw uint8/uint16 sample equals
    the host-normalised f32 rgbd of the same crop (rtol, atol 1e-6, as the
    JAX package's test)."""
    _, _, out, _, _, _ = packed
    kw = dict(size=64, random_flip=True, random_resized_crop=True, seed=7)
    a = PackedNTUSkeleton(out, **kw)[3]
    b = PackedNTUSkeleton(out, raw_output=True, **kw)[3]
    assert b["rgb_u8"].dtype == np.uint8 and b["depth_mm"].dtype == np.uint16
    got = device_normalize({"rgb_u8": torch.from_numpy(b["rgb_u8"][None]),
                            "depth_mm": torch.from_numpy(b["depth_mm"][None])})
    np.testing.assert_allclose(got["rgbd"][0].numpy(), a["rgbd"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(normalize_rgb(b["rgb_u8"]), a["rgbd"][..., :3])


def pil_resized_crop(frame, i, j, h, w, size, flip, nearest):
    img = Image.fromarray(crop_pad(frame, i, j, h, w))
    img = img.resize(size, Image.NEAREST if nearest else Image.BILINEAR)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img)


BOXES = [
    # (i, j, h, w): in bounds, negative offsets, overhanging, the identity
    # box, tiny (an upscale), partial overlap
    (10, 20, 200, 300),
    (-30, -10, 250, 180),
    (400, 500, 300, 300),
    (0, 0, 480, 640),
    (100, 100, 17, 23),
    (-50, 600, 400, 200),
]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("kind", ["rgb_bilinear", "depth_nearest"])
def test_native_resample_bit_exact_to_pil(kind, box, flip):
    """The cases of tests/test_native_resample.py on the port's library."""
    rng = np.random.default_rng(0 if kind == "rgb_bilinear" else 1)
    if kind == "rgb_bilinear":
        frame = rng.integers(0, 256, (480, 640, 3), np.uint8)
        fn = LIB.resized_crop_u8
    else:
        frame = rng.integers(0, 5000, (480, 640), np.uint16)
        fn = LIB.resized_crop_nearest_u16
    i, j, h, w = box
    for size in ((320, 320), (64, 96)):
        want = pil_resized_crop(frame, i, j, h, w, size, flip,
                                kind == "depth_nearest")
        got = fn(frame, i, j, h, w, (size[1], size[0]), flip)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{box} {size}")


def test_native_resample_single_channel_and_slot():
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (100, 120), np.uint8)
    want = pil_resized_crop(frame, 5, 5, 60, 70, (32, 48), False, False)
    got = LIB.resized_crop_u8(frame, 5, 5, 60, 70, (48, 32), False)
    np.testing.assert_array_equal(got[..., 0], want)
    slot = np.zeros((48, 32, 1), np.uint8)
    assert LIB.resized_crop_u8(frame, 5, 5, 60, 70, (48, 32), False,
                               out=slot) is slot
    np.testing.assert_array_equal(slot, got)


def test_packed_fallback_equals_native(packed, monkeypatch):
    """Without the native library the pack takes PIL, pixel for pixel the
    same."""
    _, _, out, _, _, _ = packed
    kw = dict(size=SIZE, random_flip=True, random_resized_crop=True, seed=9)
    want = [PackedNTUSkeleton(out, **kw).load_raw(i)[0] for i in range(3)]
    monkeypatch.setattr(native, "resample_lib", lambda: None)
    got = [PackedNTUSkeleton(out, **kw).load_raw(i)[0] for i in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
