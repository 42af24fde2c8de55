"""K1's and K1b's CUDA kernels against their plain PyTorch versions on the
card, and the run-to-run determinism of their sums.  Card-only (`cuda`
marker; they skip without a GPU) and JAX-free, so they run on a machine
without JAX:

    python -m pytest -m cuda tests/test_torch_matmul_bn_kernels.py

The plain versions are held against the JAX package on the CPU by
tests/test_torch_matmul_bn.py.
"""

import pytest
import torch

from hcmoco_tpu_torch.ops import matmul_bn

R_RAGGED, C18 = 12800 + 37, 18


def _ulp_close(got, want, bits=8):
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - bits)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(204800, 256), (204800, 64),
                                 (R_RAGGED, C18)])
def test_k1b_kernels_match_plain_on_card(r, c):
    """Run on the card only: each K1b kernel against its plain version on
    the same inputs (out, dy, dyt within 1 bf16 ulp, mean/var within 1 f32
    ulp, dbias/dscale within 1e-5 of the sums of magnitudes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    y = (torch.randn((r, c), generator=g, device="cuda") * 1.3
         + 0.2).bfloat16()
    y[:, 0] = 0.5
    s1, s2 = y.float().sum(0), (y.float() ** 2).sum(0)
    scale = torch.rand((c,), generator=g, device="cuda") + 0.5
    bias = torch.randn((c,), generator=g, device="cuda")
    got = matmul_bn.bn_apply_fwd_cuda(y, s1, s2, scale, bias, 1e-5)
    want = matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5)
    assert _ulp_close(got[0], want[0])
    for a, b in zip(got[1:3], want[1:3]):
        assert _ulp_close(a, b, bits=24)
    dout = torch.randn((r, c), generator=g, device="cuda").bfloat16()
    cts = (torch.randn((c,), generator=g, device="cuda") * 1e-3,
           torch.randn((c,), generator=g, device="cuda") * 1e-3)
    args = (dout, y, s1, want[1], want[2], want[3], scale) + cts
    k = matmul_bn.bn_apply_bwd_stats_cuda(*args)
    p = matmul_bn.bn_apply_bwd_stats_plain(*args)
    mag = dout.double().abs().sum(0)
    assert bool(((k[1].double() - p[1].double()).abs() <= 2e-5 * mag).all())
    assert float(k[3][0]) == 0.0
    assert _ulp_close(matmul_bn.bn_apply_bwd_dy_cuda(dout, want[3], scale),
                      matmul_bn.bn_apply_bwd_dy_plain(dout, want[3], scale))
    assert _ulp_close(matmul_bn.mm_bn_bwd_dyt_cuda(dout, y, p[2], p[3]),
                      matmul_bn.mm_bn_bwd_dyt_plain(dout, y, p[2], p[3]))


@pytest.mark.cuda
def test_sums_are_deterministic_on_card():
    """Run on the card only: K1's s1/s2 and K1b's backward sums are the
    same bits from launch to launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for r, k, c in ((204800, 64, 256), (51200, 36, 18)):
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = torch.randn((c, k), generator=g, device="cuda").bfloat16()
        a, b = (matmul_bn.mm_bn_stats_cuda(x, w) for _ in range(2))
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        y, s1, s2 = a
        _, mean, var, rstd = matmul_bn.bn_apply_fwd_cuda(
            y, s1, s2, torch.ones(c, device="cuda"),
            torch.zeros(c, device="cuda"), 1e-5)
        dout = torch.randn((r, c), generator=g, device="cuda").bfloat16()
        zero = torch.zeros(c, device="cuda")
        args = (dout, y, s1, mean, var, rstd, torch.ones(c, device="cuda"),
                zero, zero)
        p, q = (matmul_bn.bn_apply_bwd_stats_cuda(*args) for _ in range(2))
        assert all(torch.equal(u, v) for u, v in zip(p, q))


@pytest.mark.cuda
def test_generic_path_on_two_streams_at_once():
    """Run on the card only: K1's generic path launched alternately on two
    streams, so that their launches overlap, gives on each stream the sums
    of a lone launch bit for bit, and its plain version's y and sums (y
    equal to torch.matmul's, the sums within 1e-5 of each channel's sum
    of magnitudes).  Each stream has its own completion counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    shapes = ((51200, 36, 18), (12800, 72, 36))
    inputs = [(torch.randn((r, k), generator=g, device="cuda").bfloat16(),
               torch.randn((c, k), generator=g, device="cuda").bfloat16())
              for r, k, c in shapes]
    alone = [matmul_bn.mm_bn_stats_cuda(x, w) for x, w in inputs]
    for (x, w), (y, s1, s2) in zip(inputs, alone):
        py, p1, p2 = matmul_bn.mm_bn_stats_plain(x, w)
        assert torch.equal(y, py)
        mag1 = py.float().abs().sum(0)
        mag2 = (py.float() ** 2).sum(0)
        assert bool(((s1 - p1).abs() <= 1e-5 * mag1 + 1e-6).all())
        assert bool(((s2 - p2).abs() <= 1e-5 * mag2 + 1e-6).all())
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(50):
        for i, (s, (x, w)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                outs[i].append(matmul_bn.mm_bn_stats_cuda(x, w))
    torch.cuda.synchronize()
    for (_, want1, want2), got in zip(alone, outs):
        for _, s1, s2 in got:
            assert torch.equal(s1, want1) and torch.equal(s2, want2)
    keys = {(torch.cuda.current_device(), s.cuda_stream) for s in streams}
    assert keys <= set(matmul_bn._counters)


@pytest.mark.cuda
def test_k1_refuses_graph_capture():
    """Run on the card only: K1's wrapper refuses a CUDA graph capture
    without a generic-path counter of the graph's own; with one
    (matmul_bn.graph_counter), its generic path is captured and replayed
    between eager launches on the same stream, on new contents of the
    captured x, with y and the sums equal to the eager launch's bit for
    bit, the graph's counter back at zero after each replay and the
    stream's eager counter untouched; the wrapper counts the capture as
    one launch and a replay as none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((3200, 144), generator=g, device="cuda").bfloat16()
    w = torch.randn((18, 144), generator=g, device="cuda").bfloat16()
    matmul_bn.mm_bn_stats_cuda(x, w)  # built and warmed outside the capture
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="counter of its own"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            matmul_bn.mm_bn_stats_cuda(x, w)
    eager = dict(matmul_bn._counters)
    counter = matmul_bn.new_counter(x.device)
    graph = torch.cuda.CUDAGraph()
    fn = matmul_bn.mm_bn_stats_cuda
    n0 = (fn.launches, fn.generic_launches)
    with matmul_bn.graph_counter(counter), torch.cuda.graph(graph):
        got = fn(x, w)
    assert dict(matmul_bn._counters) == eager
    # host launches: the capture counts once, a replay not at all
    assert (fn.launches, fn.generic_launches) == (n0[0] + 1, n0[1] + 1)
    for i in range(3):
        x.copy_(torch.randn((3200, 144), generator=g,
                            device="cuda").bfloat16())
        before = fn(x, w)
        graph.replay()
        after = fn(x, w)
        torch.cuda.synchronize()
        for a, b, c in zip(got, before, after):
            assert torch.equal(a, b) and torch.equal(a, c), f"replay {i}"
        assert int(counter) == 0
        assert all(int(c) == 0 for c in matmul_bn._counters.values())
        assert fn.launches == n0[0] + 1 + 2 * (i + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c", [(566440, 64, 256), (566440, 256, 64),
                                   (566440, 64, 64), (972, 144, 72),
                                   (972, 144, 18)])
def test_k1_and_k1b_at_downstream_rows_on_card(r, k, c):
    """Run on the card only: K1 and K1b at the downstream trainers' row
    counts, none a whole number of the fast path's row blocks: 566440,
    the parsing model's layer1 at 473^2 bs40 (fast path), and 972, A2J's
    9x9 branch at 288^2 bs12 (generic path).  K1's y within 1 bf16 ulp of
    the plain version, its sums within 1e-5 of each channel's sum of
    magnitudes and the same bits over two launches; K1b's forward and
    backward as test_k1b_kernels_match_plain_on_card holds them.  (At
    other row counts cuBLAS, the plain version, may stray from the exact
    product on cancelling sums, by up to its f32 accumulation bound;
    chip_smoke.py's k1_exact_check holds y to the exact product there.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
    w = (torch.randn((c, k), generator=g, device="cuda") / k ** 0.5).bfloat16()
    y, s1, s2 = matmul_bn.mm_bn_stats_cuda(x, w)
    y2, a1, a2 = matmul_bn.mm_bn_stats_cuda(x, w)
    assert torch.equal(y, y2) and torch.equal(s1, a1) and torch.equal(s2, a2)
    assert _ulp_close(y, matmul_bn.mm_bn_stats_plain(x, w)[0])
    yd = y.double()
    assert bool(((s1.double() - yd.sum(0)).abs()
                 <= 1e-5 * yd.abs().sum(0)).all())
    assert bool(((s2.double() - (yd * yd).sum(0)).abs()
                 <= 1e-5 * (yd * yd).sum(0)).all())

    scale = torch.rand((c,), generator=g, device="cuda") + 0.5
    bias = torch.randn((c,), generator=g, device="cuda")
    got = matmul_bn.bn_apply_fwd_cuda(y, s1, s2, scale, bias, 1e-5)
    want = matmul_bn.bn_apply_fwd_plain(y, s1, s2, scale, bias, 1e-5)
    assert _ulp_close(got[0], want[0])
    for a, b in zip(got[1:3], want[1:3]):
        assert _ulp_close(a, b, bits=24)
    dout = torch.randn((r, c), generator=g, device="cuda").bfloat16()
    cts = (torch.randn((c,), generator=g, device="cuda") * 1e-3,
           torch.randn((c,), generator=g, device="cuda") * 1e-3)
    args = (dout, y, s1, want[1], want[2], want[3], scale) + cts
    kb = matmul_bn.bn_apply_bwd_stats_cuda(*args)
    pb = matmul_bn.bn_apply_bwd_stats_plain(*args)
    mag = dout.double().abs().sum(0)
    assert bool(((kb[1].double() - pb[1].double()).abs() <= 2e-5 * mag).all())
    assert _ulp_close(matmul_bn.bn_apply_bwd_dy_cuda(dout, want[3], scale),
                      matmul_bn.bn_apply_bwd_dy_plain(dout, want[3], scale))
    assert _ulp_close(matmul_bn.mm_bn_bwd_dyt_cuda(dout, y, pb[2], pb[3]),
                      matmul_bn.mm_bn_bwd_dyt_plain(dout, y, pb[2], pb[3]))


# The BN-site kernels' (R, C) at the benchmark cell's batch of 224 at
# 320^2: the stem's conv1 (the largest call), the stem's conv2 and layer1,
# the four branches, and a ragged R whose stream ends inside a chunk
BN_SITES = [(224 * 160 * 160, 64), (224 * 80 * 80, 64), (224 * 80 * 80, 18),
            (224 * 40 * 40, 36), (224 * 20 * 20, 72), (224 * 10 * 10, 144),
            (R_RAGGED, C18)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("r,c", BN_SITES)
def test_bn_site_kernels_match_plain_on_card(r, c, relu):
    """Run on the card only: conv_out_bn's four kernels against their
    plain versions on the same inputs.  The apply's out and dx equal the
    plain versions bit for bit (fed the kernels' sums), mean/var/rstd
    within 1 f32 ulp, also normalised by a data-parallel global batch's
    rows; the forward and backward sums lie within 1e-5 of the f64 sums
    of their terms' magnitudes and are the same bits over two
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    y = (torch.randn((r, c), generator=g, device="cuda") * 1.3
         + 0.2).bfloat16()
    y[:, 0] = 0.5
    yd = y.double()
    s = matmul_bn.bn_sums_cuda(y)
    assert torch.equal(s, matmul_bn.bn_sums_cuda(y))
    assert bool(((s[0].double() - yd.sum(0)).abs()
                 <= 1e-5 * yd.abs().sum(0)).all())
    assert bool(((s[1].double() - (yd * yd).sum(0)).abs()
                 <= 1e-5 * (yd * yd).sum(0)).all())
    scale = torch.rand((c,), generator=g, device="cuda") + 0.5
    bias = torch.randn((c,), generator=g, device="cuda")
    out, st = matmul_bn.bn_relu_fwd_cuda(y, s, scale, bias, 1e-5, relu)
    pout, pst = matmul_bn.bn_relu_fwd_plain(y, s, scale, bias, 1e-5, relu)
    assert torch.equal(out, pout)
    assert _ulp_close(st, pst, bits=24)
    dout = torch.randn((r, c), generator=g, device="cuda").bfloat16()
    sums = matmul_bn.bn_relu_bwd_sums_cuda(dout, y, pst, scale, bias, relu)
    assert torch.equal(sums, matmul_bn.bn_relu_bwd_sums_cuda(
        dout, y, pst, scale, bias, relu))
    d = y.float() - pst[0]
    gm = dout.float()
    if relu:
        gm = torch.where(d * (pst[2] * scale) + bias > 0, gm, 0.0)
    terms = (gm * (d * pst[2])).double()
    gd = gm.double()
    assert bool(((sums[0].double() - gd.sum(0)).abs()
                 <= 1e-5 * gd.abs().sum(0)).all())
    assert bool(((sums[1].double() - terms.sum(0)).abs()
                 <= 1e-5 * terms.abs().sum(0)).all())
    cts = (torch.randn((c,), generator=g, device="cuda") * 1e-3,
           torch.randn((c,), generator=g, device="cuda") * 1e-3)
    for dm, dv in ((None, None), cts):
        args = (dout, y, pst, scale, bias, sums, relu, None, dm, dv)
        assert torch.equal(matmul_bn.bn_relu_bwd_dx_cuda(*args),
                           matmul_bn.bn_relu_bwd_dx_plain(*args))
    # a data-parallel rank's rows, normalised by twice as many: the sums
    # stand for the global batch's
    n = 2 * r
    out, st = matmul_bn.bn_relu_fwd_cuda(y, 2 * s, scale, bias, 1e-5, relu,
                                         None, n)
    pout, pst = matmul_bn.bn_relu_fwd_plain(y, 2 * s, scale, bias, 1e-5,
                                            relu, None, n)
    assert torch.equal(out, pout)
    assert _ulp_close(st, pst, bits=24)
    args = (dout, y, pst, scale, bias, 2 * sums, relu, n) + cts
    assert torch.equal(matmul_bn.bn_relu_bwd_dx_cuda(*args),
                       matmul_bn.bn_relu_bwd_dx_plain(*args))


@pytest.mark.cuda
def test_conv_out_bn_on_card_matches_cpu():
    """Run on the card only: conv_out_bn (the four kernels under one
    autograd Function) against the same Function on the CPU (the plain
    versions) for a bf16 site with ReLU: out within 1 bf16 ulp, dy, dscale,
    dbias and the running statistics within 1e-2 of their norms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator().manual_seed(5)
    r, c = 4 * 40 * 40 + 3, 36
    y0 = (torch.randn((r, c), generator=g) * 0.8 - 0.1).bfloat16()
    dout = torch.randn((r, c), generator=g).bfloat16()
    res = {}
    for dev in ("cpu", "cuda"):
        y = y0.to(dev, copy=True).requires_grad_()
        scale = (torch.rand((c,), generator=torch.Generator().manual_seed(6))
                 + 0.5).to(dev).requires_grad_()
        bias = torch.linspace(-0.5, 0.5, c, device=dev).requires_grad_()
        running = (torch.zeros(c, device=dev), torch.ones(c, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev), 0.01)
        out = matmul_bn.conv_out_bn(y, scale, bias, 1e-5, True, running)
        out.backward(dout.to(dev))
        res[dev] = [t.detach().cpu() for t in (out, y.grad, scale.grad,
                                               bias.grad) + running[:2]]
    cpu, card = res["cpu"], res["cuda"]
    assert _ulp_close(card[0], cpu[0])
    for a, b in zip(card[1:], cpu[1:]):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 1e-2, rel
