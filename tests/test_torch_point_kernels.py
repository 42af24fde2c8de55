"""K2-K6's CUDA kernels held against their plain PyTorch versions on the
card (`cuda`-marked: they skip without a CUDA device; run on the card with
`python -m pytest -m cuda tests/test_torch_point_kernels.py`).  This file
imports no JAX, so it runs where only PyTorch is installed.

Inputs: N(0, 0.3^2) clouds of up to 4096 points with an all-zero sample
(the cloud of an image without depth); for K3's tile skip also clouds in
raster order, points on the sphere and on the faces of a tile's box; for
K2 clouds of 4097 to 8192 points (512 threads), past 16384 points
(streamed) and clouds of exact ties; for K4's tile walk depth2pts clouds
at the FP calls and pts2depth's shape, shuffled, and known sets of 1 to
20000 points.  Indices and
distances equal (the kernels compute d2 without FMA contraction, as the
plain versions round it); forward gathers exact; the backwards (K56a's
destination index, then K56b's sums in ascending source order) equal the
plain versions computed on CPU copies, bit for bit, and two launches equal
each other.
"""

import numpy as np
import pytest
import torch

from hcmoco_tpu_torch.ops import ball_query as bq
from hcmoco_tpu_torch.ops import fps as fp
from hcmoco_tpu_torch.ops import point_gather as pg
from hcmoco_tpu_torch.ops import point_ops
from hcmoco_tpu_torch.ops import three_nn as tn


def _card_cloud(b=4, n=4096, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3), generator=g, device="cuda") * 0.3
    x[-1] = 0.0
    return x


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")


@pytest.mark.cuda
def test_fps_kernel_matches_plain_on_card():
    _need_card()
    for n, m in ((4096, 1024), (1024, 256), (256, 64), (37, 5)):
        x = _card_cloud(n=n)
        assert torch.equal(fp.fps_cuda(x, m), fp.fps_plain(x, m))


@pytest.mark.cuda
def test_ball_query_kernel_matches_plain_on_card():
    _need_card()
    x = _card_cloud()
    for m, r, s in ((4096, 0.025, 16), (1024, 0.125, 32), (64, 1.0, 32)):
        c = x[:, :m].contiguous()
        assert torch.equal(bq.ball_query_cuda(x, c, r, s),
                           bq.ball_query_plain(x, c, r, s))


def _raster_cloud(b=4, n=4096, seed=0):
    """Points of a depth image in raster order (sorted by y, then x), as
    depth2pts gives them, with an all-zero last sample."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xy = torch.rand((b, n, 2), generator=g, device="cuda") - 0.5
    key = torch.floor(xy[..., 1] * 320) * 4 + xy[..., 0]
    xy = torch.gather(xy, 1, key.argsort(-1)[..., None].expand(-1, -1, 2))
    z = 0.1 * torch.sin(6 * xy[..., :1]) + 0.05 * torch.randn(
        (b, n, 1), generator=g, device="cuda")
    x = torch.cat([xy, z], -1).contiguous()
    x[-1] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(0.025, 16), (0.125, 32), (0.25, 16),
                                 (0.5, 32)])
def test_ball_query_kernel_raster_cloud_on_card(r, s):
    """The path's radii on a raster-ordered cloud, where the tile skip
    fires, with centers sorted as the SA levels sort them."""
    _need_card()
    x = _raster_cloud()
    for m in (4096, 1024, 256):
        c = x[:, torch.linspace(0, 4095, m, device="cuda").long()]
        c = c.contiguous()
        skipped = float((bq.tile_bounds(x[:-1], c[:-1]) >= r * r).float()
                        .mean())
        assert skipped > 0.2  # the skip is what this case exercises
        assert torch.equal(bq.ball_query_cuda(x, c, r, s),
                           bq.ball_query_plain(x, c, r, s))


def _edge_cloud(r, n=4096):
    """A center c and tiles of points at |p - c| = r and r(1 +- 1 ulp) along
    each axis, each tile on one face of its box (the face at that offset),
    the rest of the cloud far away; one sample."""
    c = torch.tensor([0.25, -0.125, 0.5])
    r32 = torch.tensor(r, dtype=torch.float32)
    offs = [torch.nextafter(r32, torch.tensor(0.0)), r32,
            torch.nextafter(r32, torch.tensor(1.0))]
    pts = torch.full((n, 3), 10.0)
    g = torch.Generator().manual_seed(4)
    t = 1
    for o in offs:
        for axis in range(3):
            for sign in (1.0, -1.0):
                tile = c.repeat(32, 1)
                # spread over the face, one point exactly on the axis
                tile[1:, (axis + 1) % 3] += (torch.rand(31, generator=g)
                                             - 0.5) * 0.5 * r
                tile[:, axis] = c[axis] + sign * o
                pts[32 * t:32 * t + 32] = tile
                t += 2
    return pts[None].cuda(), c.reshape(1, 1, 3).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0.025, 0.125, 0.3])
def test_ball_query_kernel_sphere_and_box_faces_on_card(r):
    """Points on the sphere and on their tile's box face: the kernel's
    in/out and skip decisions agree with the plain version's d2 < r2."""
    _need_card()
    x, c = _edge_cloud(r)
    for s in (8, 32, 64):
        assert torch.equal(bq.ball_query_cuda(x, c, r, s),
                           bq.ball_query_plain(x, c, r, s))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4005, 9000])
def test_ball_query_kernel_last_tile_hit_on_card(n):
    """A center whose S-th hit is the cloud's last point (a ragged last
    tile at N = 4005, a second shared-memory chunk at N = 9000), and one
    with fewer than S hits."""
    _need_card()
    s = 16
    x = torch.full((2, n, 3), 5.0, device="cuda")
    hits = torch.linspace(0, n - 1, s, device="cuda").long()
    x[0, hits] = 0.01 * torch.arange(s, device="cuda",
                                     dtype=torch.float32)[:, None]
    x[1, hits[:-3]] = 0.0
    c = torch.zeros((2, 1, 3), device="cuda")
    got = bq.ball_query_cuda(x, c, 0.5, s)
    assert torch.equal(got, bq.ball_query_plain(x, c, 0.5, s))
    assert int(got[0, 0, -1]) == n - 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(4097, 1024), (8192, 2048), (20000, 512),
                                 (70000, 128)])
def test_fps_kernel_large_n_on_card(n, m):
    """Past 4096 points: 512 threads with 16 points a thread up to 8192,
    then the points streamed from device memory (past the 16384 points of
    the shared-memory design)."""
    _need_card()
    x = _card_cloud(b=2, n=n)
    assert torch.equal(fp.fps_cuda(x, m), fp.fps_plain(x, m))


@pytest.mark.cuda
@pytest.mark.parametrize("cloud,n", [("grid", 4096), ("duplicates", 4096),
                                     ("duplicates", 8192),
                                     ("duplicates", 16384)])
def test_fps_kernel_exact_ties_on_card(cloud, n):
    """Many points at equal min-distance: the lowest index must win every
    round, as in the plain version's argmax (8192 points: 512 threads;
    16384: streamed, where lanes do not own ordered indices)."""
    _need_card()
    if cloud == "grid":
        ax = torch.arange(16, device="cuda", dtype=torch.float32) * 0.125
        x = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
        x = x.reshape(1, 4096, 3).repeat(2, 1, 1)
    else:
        base = _card_cloud(b=2, n=n // 8)
        x = base.repeat(1, 8, 1)  # every point 8 times
    x = x.contiguous()
    for m in (1024, 256):
        assert torch.equal(fp.fps_cuda(x, m), fp.fps_plain(x, m))


def _depth_clouds():
    """depth2pts's 4096-point cloud (raster order, drawn with repeats) and
    its all_pts of a synthetic bs4 320^2 batch whose samples 1 and 3 have
    no depth (zero clouds)."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.pointnet2_model import depth2pts

    batch = synthetic_contrast_batch(np.random.default_rng(3), 4, size=320)
    t = {k: torch.from_numpy(batch[k]).cuda()
         for k in ("rgbd", "depth_mask", "grid_xy", "depth_mean")}
    cloud, all_pts, _, valid = depth2pts(
        t["rgbd"][..., 3], t["depth_mask"], t["grid_xy"], 424.0, 512.0,
        t["depth_mean"], 4096,
        generator=torch.Generator("cuda").manual_seed(0))
    assert valid.tolist() == [True, False, True, False]
    return cloud, all_pts


def _fp_calls(cloud):
    """The (unknown, known) of the four FP levels of a PointNet++ MSG over
    `cloud`: SA0 keeps it, SA1-3 take sorted FPS centers."""
    levels = [cloud, cloud]
    for m in (1024, 256, 64):
        idx = torch.sort(fp.fps_plain(levels[-1], m), dim=-1).values
        levels.append(point_ops.gather_points(levels[-1], idx))
    return [(levels[i], levels[i + 1]) for i in range(4)]


def _three_nn_calls(case):
    if case == "random":
        x = _card_cloud()
        return [(x, x[:, :m].contiguous()) for m in (4096, 1024, 64, 2)]
    if case == "fp_calls":
        return _fp_calls(_depth_clouds()[0])
    if case == "shuffled":
        g = torch.Generator(device="cuda").manual_seed(6)
        calls = []
        for u, k in _fp_calls(_depth_clouds()[0]):
            pu = torch.randperm(u.shape[1], generator=g, device="cuda")
            pk = torch.randperm(k.shape[1], generator=g, device="cuda")
            calls.append((u[:, pu].contiguous(), k[:, pk].contiguous()))
        return calls
    if case == "pts2depth":
        cloud, all_pts = _depth_clouds()
        return [(all_pts, cloud)]
    # M known points of a raster cloud against 4096 + 5 unknowns
    m = int(case.split("=")[1])
    known = _raster_cloud(n=m, seed=7)
    return [(_raster_cloud(n=4101, seed=8), known)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "fp_calls", "shuffled",
                                  "pts2depth", "M=1", "M=2", "M=3", "M=33",
                                  "M=8192", "M=20000"])
def test_three_nn_kernel_matches_plain_on_card(case):
    """K4 equal to the plain version, distances and indices, and over two
    launches: the FP calls of depth2pts clouds (raster order, repeats and
    zero clouds), the same in shuffled order (no raster coherence, so the
    least-bound tiles come first only by chance), few known points, known
    sets streamed in chunks (8192, 20000), N not a multiple of 32, and
    pts2depth's (4, 102400 <- 4096)."""
    _need_card()
    for u, k in _three_nn_calls(case):
        d, i = tn.three_nn_cuda(u, k)
        d2, i2 = tn.three_nn_cuda(u, k)
        pd, pi = tn.three_nn_plain(u, k)
        assert torch.equal(d, d2) and torch.equal(i, i2)
        assert torch.equal(i, pi) and torch.equal(d, pd), (
            case, tuple(u.shape), tuple(k.shape), int((i != pi).sum()))


def _equal_twice(fn, want):
    """fn() equals `want` (computed on the CPU) bit for bit, twice."""
    a, b = fn(), fn()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_point_gather_kernels_match_plain_on_card(dtype):
    """Forwards exact; backwards equal to the plain versions on the CPU and
    identical over two launches."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    b, n, m, s, c = 4, 1024, 256, 32, 64
    table = torch.randn((b, n, c), generator=g, device="cuda").to(dtype)
    gidx = torch.randint(0, n, (b, m, s), generator=g, device="cuda",
                         dtype=torch.int32)
    gidx[-1] = torch.arange(s, device="cuda", dtype=torch.int32)
    gout = torch.randn((b, m, s, c), generator=g, device="cuda").to(dtype)
    assert torch.equal(pg.group_rows_cuda(table, gidx),
                       pg.group_rows_plain(table, gidx))
    _equal_twice(lambda: pg.group_rows_bwd_cuda(gout, gidx, n),
                 pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(), n))
    d, idx = tn.three_nn_cuda(_card_cloud(n=n), _card_cloud(n=m))
    w = point_ops.interpolation_weights(d)
    feat = table[:, :m].contiguous()
    assert torch.equal(pg.interpolate_rows_cuda(feat, idx, w),
                       pg.interpolate_rows_plain(feat, idx, w))
    go = gout[:, :, 0].reshape(b, m, c).repeat(1, n // m, 1).contiguous()
    _equal_twice(lambda: pg.interpolate_rows_bwd_cuda(go, idx, w, m),
                 pg.interpolate_rows_bwd_plain(go.cpu(), idx.cpu(), w.cpu(),
                                               m))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty_buckets", "zero_cloud",
                                  "ragged_tile", "windows_8193",
                                  "windows_65537", "windows_zero_cloud"])
def test_dest_csr_kernel_matches_plain_on_card(case):
    """K56a against `dest_csr_plain`: start and src equal; past 8192
    destinations (windows_*) each tile is ranked by one block a window of
    8192 destinations."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    b, r, n = {"random": (4, 32768, 1024), "empty_buckets": (3, 5000, 4096),
               "zero_cloud": (2, 131072, 4096),
               "ragged_tile": (3, 3 * 4096 + 37, 1024),
               "windows_8193": (3, 8193 * 4 + 11, 8193),
               "windows_65537": (2, 200000, 65537),
               "windows_zero_cloud": (2, 16384 * 32, 16384)}[case]
    hi = n // 3 if case == "empty_buckets" else n
    idx = torch.randint(0, hi, (b, r), generator=g, device="cuda",
                        dtype=torch.int32)
    if case.endswith("zero_cloud"):  # K5 at sa0: every center's slots 0..31
        idx[-1] = torch.arange(r, device="cuda", dtype=torch.int32) % 32
    start, src = pg.dest_csr_cuda(idx, n)
    pstart, psrc = pg.dest_csr_plain(idx.cpu(), n)
    assert torch.equal(start.cpu(), pstart)
    assert torch.equal(src.cpu(), psrc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 18, 512])
def test_backward_kernels_match_plain_on_card(dtype, c):
    """K5's and K6's backwards (K56a + K56b) with a zero-cloud sample and
    empty buckets, at C = 32 (K5 at sa0: R = 131072 sources a sample), 18
    (the one-element path) and 512 (K6 at fp1's shapes): equal to the plain
    versions on the CPU and over two launches."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    b, n, m, s = 2, 4096, 4096, 32
    if c == 512:
        m, s = 1024, 4  # the fp1 shapes; R = 3 * 4096 for K6 below
    gidx = torch.randint(0, n - 64, (b, m, s), generator=g, device="cuda",
                         dtype=torch.int32)
    gidx[-1] = torch.arange(s, device="cuda", dtype=torch.int32)
    gout = torch.randn((b, m, s, c), generator=g, device="cuda")
    gout = (gout * 10.0 ** (6 * torch.rand(gout.shape, generator=g,
                                           device="cuda") - 3)).to(dtype)
    _equal_twice(lambda: pg.group_rows_bwd_cuda(gout, gidx, n),
                 pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(), n))
    k = 1024
    idx = torch.randint(0, k - 16, (b, n, 3), generator=g, device="cuda",
                        dtype=torch.int32)
    idx[-1] = torch.arange(3, device="cuda", dtype=torch.int32)
    w = torch.rand((b, n, 3), generator=g, device="cuda") + 1e-3
    w = w / w.sum(-1, keepdim=True)
    go = gout.reshape(b, -1, c)[:, :n].contiguous()
    _equal_twice(lambda: pg.interpolate_rows_bwd_cuda(go, idx, w, k),
                 pg.interpolate_rows_bwd_plain(go.cpu(), idx.cpu(), w.cpu(),
                                               k))
