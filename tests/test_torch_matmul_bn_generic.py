"""K1's generic path (csrc/matmul_bn.cu, mm_bn_generic_kernel): a torch
model of its index map and of its fixed summation order, held to
mm_bn_stats_plain on the CPU at every HRNet W18/W32/W48 fuse-layer (K, C)
off the fast path; the model's teeth (without its mask the partial k16
step counts k twice, or reads the next row for K < 16); the port against
the JAX Pallas kernel in interpret mode at a fuse shape; and card cases
(`cuda` marker, skipped without a GPU):

    python -m pytest -m cuda tests/test_torch_matmul_bn_generic.py

The model's data are small integers, so every product and partial sum is
exact in f32 and the model must equal the plain version bit for bit,
whatever order either adds in.
"""

import math

import numpy as np
import pytest
import torch

from hcmoco_tpu_torch.ops import matmul_bn

# the generic kernel's launch constants (csrc/matmul_bn.cu)
CTAS_PER_SM, CLUSTER, STAGES = 4, 8, 2
SMEM_MAX = 232448 - 1024
NTWS = (1, 2, 3, 5, 9)
H100_SMS = 132


def fuse_shapes(width: int) -> list:
    """(K, C) of an HRNet's fuse-layer 1x1 sites (branch j's channels to
    branch i's, j > i) that take K1's generic path."""
    ch = [width * 2 ** i for i in range(4)]
    return [(ch[j], ch[i]) for i in range(4) for j in range(i + 1, 4)
            if (ch[j], ch[i]) not in matmul_bn.FAST_SHAPES]


FUSE = sorted({kc for wd in (18, 32, 48) for kc in fuse_shapes(wd)})


def ru(a: int, b: int) -> int:
    return -(-a // b) * b


def packed(rows: int, k: int) -> int:
    return ru(rows * k + 16, 8)


def smem_bytes(tm: int, ntw: int, k: int, c: int, grid: int) -> int:
    c_pad = ru(c, (4 // (tm // 16)) * ntw * 8)
    b = 2 * packed(c_pad, k) + 2 * STAGES * packed(tm, k)
    b += 2 * ru(tm * c_pad, 8) + 8 * (tm // 16) * 2 * c
    return b + 16 * c * max(-(-(grid // CLUSTER) // 8), CLUSTER)


def launch(r: int, k: int, c: int, sms: int = H100_SMS):
    """gen_launch: (tm, ntw, grid), or None where nothing fits."""
    pick = None
    grid_max = ru(CTAS_PER_SM * sms, CLUSTER)
    for tm in (64, 32, 16):
        n_wc = 4 // (tm // 16)
        need = -(-(-(-c // 8)) // n_wc)
        ntw = 9 if k % 2 else next((n for n in NTWS if n >= need), 9)
        while ntw > 1 and smem_bytes(tm, ntw, k, c, grid_max) > SMEM_MAX:
            ntw = 5 if ntw > 5 else 3 if ntw > 3 else ntw - 1
        too_big = smem_bytes(tm, ntw, k, c, grid_max) > SMEM_MAX
        if k % 2 and ntw != 9 or too_big:
            continue
        pick = (tm, ntw)
        if -(-r // tm) >= sms:
            break
    if pick is None:
        return None
    tm, ntw = pick
    tiles = -(-r // tm)
    per = -(-tiles // (CTAS_PER_SM * sms))
    return tm, ntw, ru(-(-tiles // per), CLUSTER)


# ---------------------------------------------------------------------------
# the m16n8k16 fragments as the kernel reads them (ld_pair at pitch K)


def a_coords() -> np.ndarray:
    """(lane, register, half) -> (row, k) of the A fragment: a[0] row g,
    a[1] row g + 8, a[2] and a[3] the same at k + 8, k = 2 * t4 + half."""
    out = np.zeros((32, 4, 2, 2), dtype=np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for reg in range(4):
            for h in range(2):
                out[lane, reg, h] = (g + 8 * (reg & 1),
                                     2 * t4 + 8 * (reg >> 1) + h)
    return out


def b_coords() -> np.ndarray:
    """(lane, register, half) -> (k, n) of the B fragment: channel g of
    the n8 tile, b[0] at k = 2 * t4 + half, b[1] at k + 8."""
    out = np.zeros((32, 2, 2, 2), dtype=np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for reg in range(2):
            for h in range(2):
                out[lane, reg, h] = (2 * t4 + 8 * reg + h, g)
    return out


def c_coords() -> np.ndarray:
    """(lane, q) -> (row, col) of the accumulator: q 0-1 row g, q 2-3 row
    g + 8, col 2 * t4 + (q & 1)."""
    out = np.zeros((32, 4, 2), dtype=np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for q in range(4):
            out[lane, q] = (g + 8 * (q >> 1), 2 * t4 + (q & 1))
    return out


def test_fragments_cover_their_tiles_once():
    """The kernel's fragment reads are bijections onto the 16x16 A, 16x8 B
    and 16x8 accumulator tiles, and one mma through them is A @ B."""
    for coords, shape in ((a_coords(), (16, 16)), (b_coords(), (16, 8)),
                          (c_coords(), (16, 8))):
        flat = coords.reshape(-1, 2)
        seen = np.zeros(shape, dtype=np.int64)
        np.add.at(seen, (flat[:, 0], flat[:, 1]), 1)
        assert (seen == 1).all()
    rng = np.random.default_rng(0)
    a = rng.integers(-3, 4, (16, 16)).astype(np.float32)
    b = rng.integers(-3, 4, (16, 8)).astype(np.float32)
    ac, bc, cc = a_coords(), b_coords(), c_coords()
    a_regs = a[ac[..., 0], ac[..., 1]]  # what each lane holds
    b_regs = b[bc[..., 0], bc[..., 1]]
    a2 = np.zeros_like(a)
    a2[ac[..., 0], ac[..., 1]] = a_regs
    b2 = np.zeros_like(b)
    b2[bc[..., 0], bc[..., 1]] = b_regs
    d = a2 @ b2
    assert np.array_equal(d[cc[..., 0], cc[..., 1]],
                          (a @ b)[cc[..., 0], cc[..., 1]])


# ---------------------------------------------------------------------------
# the kernel's index map and summation order, in torch


def butterfly(p: torch.Tensor) -> torch.Tensor:
    """The kernel's shuffle butterfly over the eight row groups (dim -2):
    ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))."""
    for _ in range(3):
        p = p[..., 0::2, :] + p[..., 1::2, :]
    return p[..., 0, :]


def generic_model(x: torch.Tensor, w: torch.Tensor, cfg, mask: bool = True,
                  overrun: float = float("nan")):
    """y (x's dtype), s1, s2 as mm_bn_generic_kernel computes them for the
    launch cfg = (tm, ntw, grid); f32 accumulation.

    Each row tile is the packed byte range x[row0 * K : (row0 + tm) * K],
    zero past R, followed by `overrun` (whatever shared memory holds past
    the tile); w is packed at pitch K, its rows zero to whole column tiles.
    A row's partial k16 step comes first and reads k in [0, 16) at pitch K:
    past K % 16 that is the row's later elements, or for K < 16 the next
    row's.  `mask` zeroes them, as the kernel does; the whole steps then
    read k in [K % 16, K)."""
    tm, ntw, grid = cfg
    r, k = x.shape
    c = w.shape[0]
    res = k % 16
    n_wr = tm // 16
    ct_cols = (4 // n_wr) * ntw * 8
    c_pad = ru(c, ct_cols)
    tiles = -(-r // tm)
    xf = torch.zeros(tiles * tm * k, dtype=torch.float32)
    xf[:r * k] = x.float().reshape(-1)
    buf = torch.cat([xf.view(tiles, tm * k),
                     torch.full((tiles, 16), overrun)], 1)
    wf = torch.cat([w.float().reshape(-1),
                    torch.zeros((c_pad - c) * k + 16)])
    # the k each step reads, in order, and whether it counts
    kk = torch.cat([torch.arange(16) if res else torch.arange(0),
                    torch.arange(res, k)])
    keep = torch.cat([torch.arange(16) < res if res else
                      torch.zeros(0, dtype=torch.bool),
                      torch.ones(k - res, dtype=torch.bool)])
    a = buf[:, torch.arange(tm)[:, None] * k + kk[None, :]]  # (tiles, tm, ·)
    b = wf[torch.arange(c_pad)[:, None] * k + kk[None, :]]  # (C_pad, ·)
    if mask:
        a = torch.where(keep, a, torch.zeros(()))
        b = torch.where(keep, b, torch.zeros(()))
    acc = torch.matmul(a, b.t())[..., :c]  # (tiles, tm, C)
    yt = acc.to(x.dtype)
    y = yt.reshape(-1, c)[:r]
    yf = yt.float().view(tiles, n_wr, 2, 8, c)  # tile, warp row, h, g, col
    # a thread's rows g and g + 8: one f32 add, then f64 over its tiles
    p1 = (yf[:, :, 0] + yf[:, :, 1]).double()
    p2 = (yf[:, :, 0] * yf[:, :, 0] + yf[:, :, 1] * yf[:, :, 1]).double()
    slots = []
    for cl in range(grid // CLUSTER):
        ranks = []
        for cta in range(cl * CLUSTER, (cl + 1) * CLUSTER):
            mine = list(range(cta, tiles, grid))
            t = torch.zeros((2, n_wr, 8, c), dtype=torch.float64)
            for i in mine:  # the CTA's tiles in order
                t[0] += p1[i]
                t[1] += p2[i]
            warp_rows = butterfly(t)  # (2, n_wr, C)
            tot = torch.zeros((2, c), dtype=torch.float64)
            for wr in range(n_wr):
                tot = tot + warp_rows[:, wr]
            ranks.append(tot)
        slot = torch.zeros((2, c), dtype=torch.float64)
        for t in ranks:
            slot = slot + t
        slots.append(slot)
    if len(slots) == 1:
        s = slots[0].float()
    else:  # groups of eight slots in order, then the groups in order
        s = torch.zeros((2, c), dtype=torch.float64)
        for g0 in range(0, len(slots), 8):
            g_sum = torch.zeros((2, c), dtype=torch.float64)
            for sl in slots[g0:g0 + 8]:
                g_sum = g_sum + sl
            s = s + g_sum
        s = s.float()
    return y, s[0], s[1]


def int_inputs(seed: int, r: int, k: int, c: int, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, (r, k)).astype(np.float32)
    w = rng.integers(-1, 2, (c, k)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


@pytest.mark.parametrize("k,c", FUSE)
@pytest.mark.parametrize("r", [40, 1000 + 37, 12800 + 37])
def test_model_equals_plain(r, k, c):
    """The index map (packed tiles, masked partial k16 step, ragged last tile,
    zero rows of w) and the summation order (per-thread, butterfly, warp
    rows, cluster ranks, slot groups) give the plain version's y, s1, s2
    exactly on integer data, under the launch the card would pick."""
    cfg = launch(r, k, c)
    assert cfg is not None, f"K={k} C={c} has no launch"
    x, w = int_inputs(r * 7 + k + c, r, k, c)
    got = generic_model(x, w, cfg)
    want = matmul_bn.mm_bn_stats_plain(x, w)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


@pytest.mark.parametrize("cfg", [(64, 3, 200), (32, 2, 48), (16, 1, 16)])
def test_model_equals_plain_under_other_launches(cfg):
    """The same at 36 -> 18 under launches a card with another SM count
    would pick: the result does not depend on tm, the warp columns or the
    grid."""
    x, w = int_inputs(3, 3200 + 37, 36, 18)
    got = generic_model(x, w, cfg)
    want = matmul_bn.mm_bn_stats_plain(x, w)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def test_every_fuse_shape_has_a_launch():
    """Every W18/W32/W48 fuse (K, C) fits a block's shared memory, the
    largest (384 -> 192) at 16-row tiles; the W18 shapes cover roundup8(C)
    with one column tile of 64-row tiles."""
    for k, c in FUSE:
        assert launch(3200, k, c) is not None
    assert launch(3200, 384, 192)[0] == 16
    for k, c in fuse_shapes(18):
        tm, ntw, _ = launch(51200, k, c)
        assert tm == 64 and ntw * 8 >= c and (ntw - 1) * 8 < c


def test_unmasked_model_reads_the_next_row():
    """Teeth: at K = 12 the partial k16 step reads 4 k past each row.  With
    the mask an Inf in row 18 stays in row 18; without it row 17, which
    shares its tile, reads row 18's first elements and turns non-finite."""
    x, w = int_inputs(5, 64 * 3, 12, 18)
    x[18, :4] = float("inf")
    cfg = launch(64 * 3, 12, 18)
    for mask in (True, False):
        y, _, _ = generic_model(x, w, cfg, mask=mask, overrun=0.0)
        finite = torch.isfinite(y).all(1)
        assert not bool(finite[18])
        others = torch.cat([finite[:18], finite[19:]])
        assert bool(others.all()) == mask
        if not mask:
            assert not bool(finite[17])


def test_unmasked_model_counts_k_twice():
    """Teeth at a fuse shape: at K = 36 the partial step's k in [4, 16) are
    the whole steps' too; without the mask y is off."""
    x, w = int_inputs(7, 256, 36, 18)
    cfg = launch(256, 36, 18)
    want = matmul_bn.mm_bn_stats_plain(x, w)[0]
    assert torch.equal(generic_model(x, w, cfg)[0], want)
    assert not torch.equal(generic_model(x, w, cfg, mask=False)[0], want)


def test_overrun_past_the_tile_is_masked():
    """At K < 16 the last row of a tile reads past the tile into whatever
    shared memory holds; a NaN there reaches y only without the mask."""
    x, w = int_inputs(6, 64, 12, 18)
    cfg = (64, 3, 8)
    y, _, _ = generic_model(x, w, cfg, mask=True)
    assert bool(torch.isfinite(y).all())
    y, _, _ = generic_model(x, w, cfg, mask=False)
    assert not bool(torch.isfinite(y[63]).all())


def test_conv1x1_bn_stats_matches_jax_kernel_in_bf16():
    """The port's conv1x1_bn_stats (plain version on the CPU) and the
    generic path's model against the JAX Pallas kernel in interpret mode, at
    the 36 -> 18 fuse shape and a ragged R, in bf16: y within 1 bf16 ulp,
    s1/s2 within 1e-5 of the channels' sums of magnitudes."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from hcmoco_tpu.ops.pallas import matmul_bn as jax_mm

    r, k, c = 1000 + 37, 36, 18
    rng = np.random.default_rng(11)
    x = rng.standard_normal((r, k)).astype(np.float32)
    w = (rng.standard_normal((c, k)) / math.sqrt(k)).astype(np.float32)
    jy, js1, js2 = jax_mm.conv1x1_bn_stats(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16), 64,
        True)
    jy = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    model = generic_model(xt, wt, launch(r, k, c))
    for y, s1, s2 in (matmul_bn.conv1x1_bn_stats(xt, wt), model):
        yf = y.detach().float()
        big = torch.maximum(yf.abs(), jy.abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
        assert bool(((yf - jy).abs() <= ulp).all())
        mag = yf.double().abs().sum(0)
        for got, want, scale in ((s1, js1, mag),
                                 (s2, js2, (yf.double() ** 2).sum(0))):
            err = (got.detach().double()
                   - torch.from_numpy(np.array(want)).double()).abs()
            assert bool((err <= 1e-5 * scale).all())


# ---------------------------------------------------------------------------
# on the card: the kernel itself


def _ulp_close(got, want):
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


CARD_SHAPES = [(51200, 36, 18), (12800, 72, 18), (12800, 72, 36),
               (3200, 144, 18), (3200, 144, 36), (3200, 144, 72),
               (12800 + 37, 144, 72), (40, 72, 36), (3200, 384, 48),
               (3200, 384, 192), (1000 + 37, 37, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c", CARD_SHAPES)
def test_generic_kernel_on_card(r, k, c):
    """Run on the card only: y within 1 bf16 ulp of the plain version, s1/s2
    within 1e-5 of f64 sums of its own y, the same bits over three launches
    with another shape's launch between them, and an Inf in one row of x
    confined to that row of y."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(r + k + c)
    x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
    w = (torch.randn((c, k), generator=g, device="cuda") / k ** 0.5
         ).bfloat16()
    other = (torch.randn((999, 20), generator=g, device="cuda").bfloat16(),
             torch.randn((10, 20), generator=g, device="cuda").bfloat16())
    runs = []
    for _ in range(3):
        runs.append(matmul_bn.mm_bn_stats_cuda(x, w))
        matmul_bn.mm_bn_stats_cuda(*other)
    y, s1, s2 = runs[0]
    for y2, a1, a2 in runs[1:]:
        assert torch.equal(y, y2) and torch.equal(s1, a1)
        assert torch.equal(s2, a2)
    assert _ulp_close(y, matmul_bn.mm_bn_stats_plain(x, w)[0])
    yd = y.double()
    assert bool(((s1.double() - yd.sum(0)).abs()
                 <= 1e-5 * yd.abs().sum(0)).all())
    assert bool(((s2.double() - (yd * yd).sum(0)).abs()
                 <= 1e-5 * (yd * yd).sum(0)).all())
    row = min(17, r - 1)
    xi = x.clone()
    xi[row] = float("inf")
    yi = matmul_bn.mm_bn_stats_cuda(xi, w)[0]
    keep = torch.ones(r, dtype=torch.bool, device="cuda")
    keep[row] = False
    assert bool(torch.isfinite(yi[keep].float()).all())


@pytest.mark.cuda
def test_generic_kernel_refuses_what_does_not_fit():
    """Run on the card only: a (K, C) whose packed w and one 16-row tile
    exceed a block's shared memory raises, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    before = matmul_bn.mm_bn_stats_cuda.launches
    x = torch.zeros((64, 1024), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((1024, 1024), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="no launch"):
        matmul_bn.mm_bn_stats_cuda(x, w)
    assert matmul_bn.mm_bn_stats_cuda.launches == before
