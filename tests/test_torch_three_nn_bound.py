"""K4's tile walk on the CPU, and the build hash of the kernels' headers.

K4 (csrc/three_nn.cu) gives a warp 32 consecutive unknowns and visits the
32-point known tiles best first by (bound, tile index), where the bound is
that of the warp's box against the tile's box: ((g_x^2 + g_y^2) + g_z^2)
with g = max(lo_t - hi_w, lo_w - hi_t, 0) per axis, every op rounded in
f32.  It stops at the first tile whose bound is above the lanes' largest
third distance B3, or equal to it with a first index above I3, the largest
third index among the lanes at B3; a lane inserts a point by (d2, index).

- A property test: the bound (`three_nn.tile_bounds`) never exceeds the
  rounded d2 of a pair of points of the two boxes (`_points.sq_dists`), on
  random boxes and on boxes that touch or overlap to a few ulps.
- A Python model of the walk returns `three_nn_plain`'s distances and
  indices on raster and shuffled clouds, duplicates, zero clouds, a grid
  of exact ties, M in {1, 2, 3, 33} and N not a multiple of 32; with the
  tie clause dropped, or the bound one ulp higher, it does not.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hcmoco_tpu_torch import _build
from hcmoco_tpu_torch.ops import three_nn as tn
from hcmoco_tpu_torch.ops._points import TILE, sq_dists
from test_torch_ball_query_bound import _near, _tile

_F32 = np.float32
F32_MAX = float(tn.F32_MAX)

coord = st.floats(-4.0, 4.0, width=32, allow_nan=False, allow_infinity=False)
extent = st.floats(0.0, 1.0, width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None)
@given(lo=st.tuples(coord, coord, coord),
       size=st.tuples(extent, extent, extent),
       size_b=st.tuples(extent, extent, extent),
       seed=st.integers(0, 2 ** 31 - 1),
       where=st.sampled_from(["free", "above", "below", "corner",
                              "inside"]),
       off=st.tuples(coord, coord, coord),
       steps=st.tuples(*[st.integers(-3, 3)] * 3))
def test_box_to_box_bound_never_exceeds_a_pairs_d2(lo, size, size_b, seed,
                                                   where, off, steps):
    lo = np.array(lo, _F32)
    size_b = np.array(size_b, _F32)
    unknown = _tile(seed, lo, np.array(size, _F32))
    ulo, uhi = unknown.min(0), unknown.max(0)
    axis = seed % 3
    if where == "free":
        lo_b = np.array(off, _F32)
    elif where == "above":
        # the tile's lo face on `axis` at the warp's hi face, a few ulps
        # off: the pair across the faces has d2 at the bound or near it
        lo_b = np.array(off, _F32)
        lo_b[axis] = uhi[axis]
        lo_b = _near(lo_b, np.array(steps))
    elif where == "below":
        lo_b = np.array(off, _F32)
        lo_b[axis] = _near(ulo, np.array(steps))[axis] - size_b[axis]
    elif where == "corner":
        lo_b = _near(uhi, np.array(steps))
    else:
        lo_b = _near(unknown[seed % 32], np.array(steps)) - size_b / 2
    tile = _tile(seed + 1, lo_b.astype(_F32), size_b)
    u = torch.from_numpy(unknown)[None]
    k = torch.from_numpy(tile)[None]
    bound = tn.tile_bounds(u, k)[0, 0, 0]
    d2 = sq_dists(u, k)[0]
    assert bool((bound <= d2).all()), (float(bound), float(d2.min()))


def _walk(unknown, known, tie_clause=True, ulps=0, seen=None):
    """K4's walk in Python: per warp, the tiles in increasing (bound, tile
    index), the walk stopped at the first tile that holds no new
    neighbour, points inserted by (d2, index).  `tie_clause=False` skips a
    tile whose bound equals B3 whatever its index; `ulps` raises every
    bound by that many ulps.  `seen` gets each warp's count of visited
    tiles."""
    bounds = tn.tile_bounds(unknown, known)
    for _ in range(ulps):
        bounds = torch.nextafter(bounds, torch.tensor(float("inf")))
    d2 = sq_dists(unknown, known)
    b, n, _ = unknown.shape
    m = known.shape[1]
    dist = torch.full((b, n, 3), F32_MAX)
    idx = torch.zeros((b, n, 3), dtype=torch.int32)
    for i in range(b):
        for w in range(bounds.shape[1]):
            lanes = range(w * TILE, min(n, (w + 1) * TILE))
            best = {lane: [(F32_MAX, 0)] * 3 for lane in lanes}
            row = bounds[i, w].tolist()
            visits = 0
            for t in sorted(range(len(row)), key=lambda t: (row[t], t)):
                b3 = max(v[2][0] for v in best.values())
                i3 = max(v[2][1] for v in best.values() if v[2][0] == b3)
                f = t * TILE
                if row[t] > b3 or (row[t] == b3
                                   and (f > i3 or not tie_clause)):
                    break
                visits += 1
                block = d2[i, lanes.start:lanes.stop, f:f + TILE].tolist()
                for lane, ds in zip(lanes, block):
                    for k, d in enumerate(ds, f):
                        if (d, k) < best[lane][2]:
                            best[lane] = sorted(best[lane] + [(d, k)])[:3]
            if seen is not None:
                seen.append(visits)
            for lane, v in best.items():
                dist[i, lane] = torch.tensor([d for d, _ in v])
                idx[i, lane] = torch.tensor([k for _, k in v],
                                            dtype=torch.int32)
    return dist, idx


def _raster(rng, b, n):
    """A depth-image-like cloud in raster order (sorted by row, then
    column), the last sample all zeros."""
    xy = rng.random((b, n, 2)) - 0.5
    key = np.floor(xy[..., 1] * 40) * 4 + xy[..., 0]
    xy = np.take_along_axis(xy, np.argsort(key, -1)[..., None], 1)
    z = 0.1 * np.sin(6 * xy[..., :1]) + 0.02 * rng.standard_normal(
        (b, n, 1))
    x = np.concatenate([xy, z], -1).astype(_F32)
    x[-1] = 0.0
    return x


def _case(name):
    """(unknown, known) as numpy f32 arrays."""
    rng = np.random.default_rng(11)
    if name == "raster":  # an FP call: known a sorted subset
        x = _raster(rng, 3, 1024)
        keep = np.sort(rng.choice(1024, 256, replace=False))
        return x, x[:, keep]
    if name == "shuffled":  # no raster coherence: the first tiles are wrong
        x = _raster(rng, 2, 300)
        return (x[:, rng.permutation(300)],
                x[:, np.sort(rng.choice(300, 90, replace=False))][
                    :, rng.permutation(90)])
    if name == "duplicates":  # FP0: known is the cloud, drawn with repeats
        pool = _raster(rng, 2, 40)
        x = pool[:, np.sort(rng.integers(0, 40, 200))]
        return x, x
    if name == "zero":
        return np.zeros((2, 100, 3), _F32), np.zeros((2, 70, 3), _F32)
    if name == "grid":  # exact ties: integer points, many at equal d2
        ax = np.arange(5, dtype=_F32)
        g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(
            1, 125, 3)
        return g + _F32(0.5), g[:, ::2]
    m = int(name.split("=")[1])  # few known points, ragged warps
    x = _raster(rng, 2, 45)
    return x, x[:, :m]


@pytest.mark.parametrize("name", ["raster", "shuffled", "duplicates", "zero",
                                  "grid", "M=1", "M=2", "M=3", "M=33"])
def test_walk_equals_plain(name):
    u, k = (torch.from_numpy(np.ascontiguousarray(a)) for a in _case(name))
    want_d, want_i = tn.three_nn_plain(u, k)
    got_d, got_i = _walk(u, k)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)


def test_walk_skips_tiles_on_raster_and_zero_clouds():
    """The walk leaves most tiles unseen where the clouds are in raster
    order, and visits one tile a warp of a zero cloud."""
    u, k = (torch.from_numpy(np.ascontiguousarray(a))
            for a in _case("raster"))
    seen = []
    _walk(u, k, seen=seen)
    w, t = tn.tile_bounds(u, k).shape[1:]
    per_sample = torch.tensor(seen).view(u.shape[0], w).sum(1)
    assert per_sample[-1] == w
    assert bool((per_sample[:-1] < 0.5 * w * t).all()), per_sample


def _tie_case():
    """One unknown at the origin.  Tile 1's box holds it (bound 0) and
    three points at d2 = 1; tile 0 lies at x >= 1 (bound exactly 1) and its
    first point, at d2 = 1 with the lower index, is a neighbour."""
    rng = np.random.default_rng(3)
    t0 = np.concatenate([[[1.0, 0.0, 0.0]],
                         [2.0, 0.0, 0.0] + rng.random((31, 3))], 0)
    t1 = np.concatenate([[[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                          [0.0, -1.0, 0.0]],
                         3.0 * (rng.random((29, 3)) - 0.5) + [0, 0, 3.0]], 0)
    t1[-1] = [0.0, 0.0, -2.0]  # the box of tile 1 holds the origin
    known = np.concatenate([t0, t1], 0)[None].astype(_F32)
    return torch.zeros((1, 1, 3)), torch.from_numpy(known)


@pytest.mark.parametrize("broken", [dict(tie_clause=False), dict(ulps=1)])
def test_walk_has_teeth(broken):
    """Without the tie clause, or with the bound one ulp high, the walk
    skips tile 0 and misses index 0."""
    u, k = _tie_case()
    want_d, want_i = tn.three_nn_plain(u, k)
    assert want_i[0, 0].tolist() == [0, 32, 33]
    assert float(tn.tile_bounds(u, k)[0, 0, 0]) == 1.0
    got = _walk(u, k)
    assert torch.equal(got[0], want_d) and torch.equal(got[1], want_i)
    bad_d, bad_i = _walk(u, k, **broken)
    assert bad_i[0, 0].tolist() == [32, 33, 34]
    assert not torch.equal(bad_i, want_i)


def test_build_hash_sees_headers(tmp_path, monkeypatch):
    """A change to a header under csrc/ changes the library's name, so the
    kernels are rebuilt."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in Path(_build._PKG_DIR, "csrc").iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "_PKG_DIR", tmp_path)
    before = _build.library_path().name
    header = csrc / "point_bounds.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path().name != before
