"""K3's tile skip and the build-time refusal of K56a's limit, on the CPU.

K3 (csrc/ball_query.cu) skips a 32-point tile when the bound of its box,
((g_x^2 + g_y^2) + g_z^2) with g = max(lo - c, c - hi, 0) per axis, every
op rounded in f32, is >= radius^2.  The skip is exact if the bound never
exceeds the rounded d2 of a point in the box: a property test checks
that on random and near-boundary boxes, centers and points, with the
bound and d2 in f32 torch ops in the kernel's order
(`ball_query.tile_bounds`, `_points.sq_dists`), and a scan that skips
tiles as the kernel does returns `ball_query_plain`'s indices.

`build_model` takes any cloud size, on the card as on the CPU: K56a
(csrc/point_gather.cu) ranks any number of destinations, so nothing is
refused before the device check.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.ops import ball_query as bq
from hcmoco_tpu_torch.ops._points import sq_dists

_F32 = np.float32


def _tile(seed: int, lo: np.ndarray, size: np.ndarray) -> np.ndarray:
    """32 points in the box [lo, lo + size], the box's corners among them,
    so that its faces are points' coordinates."""
    rng = np.random.default_rng(seed)
    hi = (lo + size).astype(_F32)
    pts = (lo + rng.random((32, 3)) * size).astype(_F32)
    pts = np.clip(pts, lo, hi)
    pts[0], pts[1] = lo, hi
    for i in range(2, 8):  # points on single faces
        axis = i % 3
        pts[i, axis] = lo[axis] if i < 5 else hi[axis]
    return pts


def _near(v: np.ndarray, steps: np.ndarray) -> np.ndarray:
    """v moved by `steps` ulps per coordinate."""
    out = v.astype(_F32).copy()
    for i, k in enumerate(steps):
        for _ in range(abs(int(k))):
            out[i] = np.nextafter(out[i], _F32(np.inf if k > 0 else -np.inf))
    return out


coord = st.floats(-4.0, 4.0, width=32, allow_nan=False, allow_infinity=False)
extent = st.floats(0.0, 1.0, width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None)
@given(lo=st.tuples(coord, coord, coord),
       size=st.tuples(extent, extent, extent),
       seed=st.integers(0, 2 ** 31 - 1),
       where=st.sampled_from(["free", "face", "corner", "inside"]),
       off=st.tuples(coord, coord, coord),
       steps=st.tuples(*[st.integers(-3, 3)] * 3))
def test_box_bound_never_exceeds_a_points_d2(lo, size, seed, where, off,
                                             steps):
    lo = np.array(lo, _F32)
    size = np.array(size, _F32)
    pts = _tile(seed, lo, size)
    blo, bhi = pts.min(0), pts.max(0)
    if where == "free":
        c = np.array(off, _F32)
    elif where == "face":
        # a point on the box's lo face of `axis`, moved out along the axis
        # and a few ulps: that point's d2 is the bound or close to it
        axis = seed % 3
        c = pts[2 + (axis + 1) % 3].copy()
        c[axis] = blo[axis] - abs(off[0])
        c = _near(c, np.array(steps))
    elif where == "corner":
        c = _near(bhi, np.array(steps))
    else:
        c = _near(pts[seed % 32], np.array(steps))
    x = torch.from_numpy(pts)[None]
    cen = torch.from_numpy(c.astype(_F32)).reshape(1, 1, 3)
    bound = bq.tile_bounds(x, cen)[0, 0, 0]
    d2 = sq_dists(cen, x)[0, 0]
    assert bool((bound <= d2).all()), (float(bound), float(d2.min()))


def _skip_scan(xyz, centers, radius, s):
    """K3's algorithm in Python: tiles in index order, a tile whose bound is
    >= r2 skipped unseen, the scan stopped at S hits, first-hit fill."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    bounds = bq.tile_bounds(xyz, centers)
    d2 = sq_dists(centers, xyz)
    b, m = centers.shape[:2]
    n = xyz.shape[1]
    out = torch.zeros((b, m, s), dtype=torch.int32)
    for i in range(b):
        for j in range(m):
            hits = []
            for t in range(bounds.shape[-1]):
                if len(hits) >= s:
                    break
                if not bool(bounds[i, j, t] < r2):
                    continue
                for k in range(t * bq.TILE, min(n, (t + 1) * bq.TILE)):
                    if bool(d2[i, j, k] < r2):
                        hits.append(k)
            hits = hits[:s]
            fill = hits[0] if hits else 0
            out[i, j] = torch.tensor(hits + [fill] * (s - len(hits)))
    return out


@pytest.mark.parametrize("order", ["raster", "random"])
def test_skip_scan_equals_plain(order):
    """Skipping tiles by the bound changes no index, on a cloud in raster
    order (where the skip fires) and one in random order, with a ragged
    last tile and an all-zero sample."""
    rng = np.random.default_rng(7)
    b, n, m = 3, 300, 24
    xy = rng.random((b, n, 2)) - 0.5
    if order == "raster":
        key = np.floor(xy[..., 1] * 40) * 4 + xy[..., 0]
        xy = np.take_along_axis(xy, np.argsort(key, -1)[..., None], 1)
    z = 0.05 * rng.standard_normal((b, n, 1))
    x = torch.from_numpy(np.concatenate([xy, z], -1).astype(_F32))
    x[-1] = 0.0
    c = x[:, ::n // m][:, :m].contiguous()
    for radius, s in ((0.05, 8), (0.125, 16), (0.3, 32)):
        assert torch.equal(_skip_scan(x, c, radius, s),
                           bq.ball_query_plain(x, c, radius, s))
    if order == "raster":
        assert float((bq.tile_bounds(x[:-1], c[:-1]) >= 0.05 ** 2).float()
                     .mean()) > 0.5


def _pn_cfg(points: int) -> TrainConfig:
    return resolve_config(TrainConfig(method="CMCRGBD2S", arch="HRNetPN",
                                      width=4, pn_num_points=points))


def test_build_model_refuses_k56a_limit_on_card(monkeypatch):
    """Past K56a's former 8192-destination limit, build_model on the card
    refuses nothing before its device check: without a card it raises
    only that no CUDA device is available (with one, it builds:
    chip_smoke.py::check_build_wide)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for points in (8193, 16384):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            build_model(_pn_cfg(points), device="cuda")


def test_build_model_takes_large_cloud_on_cpu():
    model = build_model(_pn_cfg(8193), device="cpu")
    assert model.n_points == 8193
    assert model.encoder2.SA_modules[0].npoint == 8193
