"""The port's offline NTU preprocessing (data/preprocess.py over its
native/preproc.cpp) held against the JAX package's: the cases of
tests/test_preprocess.py, run through both.

Both sides are the same numpy code and the same C++ source, so the
comparisons are exact, for the native route and for the numpy fallback
(forced by taking the native library away on both sides).
"""

import os
import pickle

import numpy as np
import pytest

from hcmoco_tpu.data import preprocess as jax_pre

from hcmoco_tpu_torch.data import preprocess as pre
from hcmoco_tpu_torch.native import native_lib


def make_skeleton_file(tmp, n_frames=3, n_joints=25, n_bodies=1, seed=0):
    rng = np.random.default_rng(seed)
    lines = [str(n_frames)]
    for _ in range(n_frames):
        lines.append(str(n_bodies))
        for _ in range(n_bodies):
            lines.append("72057 0 0 0 0 0 0 0 0 2")  # body info
            lines.append(str(n_joints))
            for _ in range(n_joints):
                v = rng.uniform(0, 400, 7)
                lines.append(" ".join(f"{x:.4f}" for x in v) + " 0 0 0 0 2")
    path = os.path.join(tmp, f"S001C001P001R001A00{seed % 10}.skeleton")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages on their native core, or both on numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(pre, "native_lib", lambda: None)
        monkeypatch.setattr(jax_pre, "native_lib", lambda: None)
    else:
        assert native_lib() is not None
    return request.param


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa["frame_idx"] == fb["frame_idx"]
        assert len(fa["joints"]) == len(fb["joints"])
        for ja, jb in zip(fa["joints"], fb["joints"]):
            assert ja["body_idx"] == jb["body_idx"]
            for k in ("3d_loc", "d_loc", "rgb_loc"):
                np.testing.assert_array_equal(np.asarray(ja[k]),
                                              np.asarray(jb[k]))


@pytest.mark.parametrize("n_bodies", [1, 2])
def test_parse_skeleton_matches_jax(tmp_path, route, n_bodies):
    path = make_skeleton_file(str(tmp_path), n_frames=4, n_bodies=n_bodies,
                              seed=n_bodies)
    got = pre.parse_skeleton_file(path)
    _same_frames(got, jax_pre.parse_skeleton_file(path))
    assert len(got) == 4 and len(got[0]["joints"]) == n_bodies
    assert len(got[0]["joints"][0]["3d_loc"]) == 25


def test_native_parse_matches_python(tmp_path):
    """The C++ parser reads what the python one does (rtol 1e-5, as
    tests/test_preprocess.py: the python loop rounds through f32)."""
    path = make_skeleton_file(str(tmp_path), seed=1)
    a, b = pre.parse_skeleton_file(path), pre._parse_skeleton_py(path)
    _same_frames(pre._parse_skeleton_py(path), jax_pre._parse_skeleton_py(path))
    for fa, fb in zip(a, b):
        for ja, jb in zip(fa["joints"], fb["joints"]):
            for k in ("3d_loc", "d_loc", "rgb_loc"):
                np.testing.assert_allclose(ja[k], jb[k], rtol=1e-5)


def test_write_parsed_pkls_match_jax(tmp_path, route):
    path = make_skeleton_file(str(tmp_path))
    out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert pre.write_parsed_skeletons(path, out) == 3
    assert jax_pre.write_parsed_skeletons(path, jax_out) == 3
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jax_out)) == [
        f"Skeleton-{i:08d}.pkl" for i in range(3)]
    for n in names:
        _same_frames([pickle.load(open(os.path.join(out, n), "rb"))],
                     [pickle.load(open(os.path.join(jax_out, n), "rb"))])


def _homography_case(seed=0, outliers=True):
    rng = np.random.default_rng(seed)
    h = np.array([[1.2, 0.1, 30], [0.05, 0.9, -20], [1e-4, 2e-4, 1.0]])
    src = rng.uniform(0, 400, (400, 2))
    dst = jax_pre.apply_homography(h, src)
    noisy = dst + rng.normal(0, 0.3, dst.shape)
    if outliers:
        noisy[::8] += rng.uniform(60, 120, (50, 2))
    return h, src, dst, noisy


def test_dlt_matches_jax_and_is_exact():
    h, src, dst, _ = _homography_case(outliers=False)
    est = pre.homography_dlt(src, dst)
    np.testing.assert_array_equal(est, jax_pre.homography_dlt(src, dst))
    np.testing.assert_allclose(est, h / h[2, 2], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pre.apply_homography(h, src), dst)


@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_matches_jax(route, seed):
    h, src, dst, noisy = _homography_case(seed)
    est = pre.find_homography_ransac(src, noisy, thresh=3.0, iters=300,
                                     seed=seed)
    np.testing.assert_array_equal(est, jax_pre.find_homography_ransac(
        src, noisy, thresh=3.0, iters=300, seed=seed))
    err = np.linalg.norm(pre.apply_homography(est, src) - dst, axis=1)
    assert err.mean() < 1.0


@pytest.mark.parametrize("shape", [(100, 150, 3), (60, 80)])
def test_warp_matches_jax_and_cv2(route, shape):
    import cv2

    rng = np.random.default_rng(0)
    h = _homography_case()[0]
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    got = pre.warp_perspective(img, h, (128, 96))
    np.testing.assert_array_equal(got, jax_pre.warp_perspective(
        img, h, (128, 96)))
    ref = cv2.warpPerspective(img, h, (128, 96))
    # interior pixels: sub-quantization agreement with cv2 (its edge and
    # fixed-point rules differ), as tests/test_preprocess.py holds it
    diff = np.abs(got[4:-4, 4:-4].astype(int) - ref[4:-4, 4:-4].astype(int))
    assert np.quantile(diff, 0.999) <= 2


def test_fit_video_set_matches_jax(tmp_path, route):
    paths = [make_skeleton_file(str(tmp_path), n_frames=30, seed=s)
             for s in (4, 5)]
    h = pre.fit_video_set_homography(paths, seed=0, sample_prob=0.7)
    np.testing.assert_array_equal(h, jax_pre.fit_video_set_homography(
        paths, seed=0, sample_prob=0.7))
    assert h.shape == (3, 3) and abs(h[2, 2] - 1.0) < 1e-9


def test_preprocess_cli_skeletons_match_jax(tmp_path):
    """cli/preprocess_ntu.py skeletons writes what the JAX CLI writes."""
    from hcmoco_tpu.cli import preprocess_ntu as jax_cli

    from hcmoco_tpu_torch.cli import preprocess_ntu

    skel = tmp_path / "skel"
    skel.mkdir()
    for s in (1, 2):
        make_skeleton_file(str(skel), n_frames=2, seed=s)
    for mod, name in ((preprocess_ntu, "port"), (jax_cli, "jax")):
        mod.main(["skeletons", "--skeleton_dir", str(skel), "--out_dir",
                  str(tmp_path / name), "--workers", "2"])
    tags = sorted(os.listdir(tmp_path / "jax"))
    assert tags == sorted(os.listdir(tmp_path / "port")) and len(tags) == 2
    for t in tags:
        for f in sorted(os.listdir(tmp_path / "jax" / t)):
            _same_frames(
                [pickle.load(open(tmp_path / "port" / t / f, "rb"))],
                [pickle.load(open(tmp_path / "jax" / t / f, "rb"))])
