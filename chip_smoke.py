"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the main paths'
shapes, and drives the two stage-1 train steps the port has:

  * HCMoCo (HRNet-W18 x2 + SemGCN, 320^2 crops, bank NCE with K=16384,
    bs32) with HCMOCO_CONVBN_FUSE=1, the path of kernels K1 (its fast path
    at the layer1 sites, its generic path at the 62 fuse-layer sites) and
    K1b;
  * HRNetPN (HRNet-W18 + PointNet++ MSG on 4096 depth points + SemGCN,
    320^2, K=16384, bs64), the path of kernels K2-K6, then two more of its
    steps under torch.profiler (device ms per kernel class).

    python3 chip_smoke.py

Needs CUDA; raises without it.  Every phase raises on failure, so the exit
code is non-zero unless all of them passed.  The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and the line before it a JSON object with each kernel's launches on its
main path, its error against the plain version, its time, the plain
version's, the least time the card could take for the same work (`bound_ms`,
from this run's shapes and data and the H100 SXM's published peaks) and,
where one PyTorch call computes the same function, that call's time.
TF32 is off for matmuls and cuDNN convs: f32 means f32 here.  Nothing of
JAX or of the JAX package (hcmoco_tpu) is imported; the script checks that
before it prints its last line.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 5
BATCH = 32
PN_BATCH = 64
N_DATA = 8192
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12  # outside the tensor cores
# f32 arithmetic that may not be contracted into FMAs (K2's and K4's
# distances, which must round as the plain versions do): one op a lane a
# cycle, 132 SMs x 128 f32 lanes x 1.98 GHz boost clock; the 67e12 above
# counts an FMA as two
F32_NOFMA_OPS_S = 132 * 128 * 1.98e9
SPIN_CYCLES_S = 2e9  # torch.cuda._sleep cycles a second, at least


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one fn(), in ms: the mean over `iters` back-to-back
    calls between two CUDA events.  The card first spins (torch.cuda._sleep)
    for twice as long as the host took to enqueue the calls, so the events
    time the card's work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_CYCLES_S))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time for `nbytes` of device memory traffic and `ops`
    operations at the card's peaks: the larger of the two, and which."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


# K1's fast-path shapes and its generic path's (R, K, C, site, sites a
# fused W18 bs32 step); R = 32 x H x W of the site's input
K1_FAST = ((204800, 64, 256, "layer1 conv3/downsample 80x80", 10),
           (204800, 256, 64, "layer1 conv1 of blocks 2-4 80x80", 6),
           (204800, 64, 64, "layer1 conv1 of block 1 80x80", 2))
K1_GENERIC = ((51200, 36, 18, "fuse 36->18 at 40x40", 16),
              (12800, 72, 18, "fuse 72->18 at 20x20", 14),
              (12800, 72, 36, "fuse 72->36 at 20x20", 14),
              (3200, 144, 18, "fuse 144->18 at 10x10", 6),
              (3200, 144, 36, "fuse 144->36 at 10x10", 6),
              (3200, 144, 72, "fuse 144->72 at 10x10", 6),
              (12800 + 37, 144, 72, "ragged R", 0),
              (40, 72, 36, "R below one 64-row tile", 0),
              (3200, 384, 48, "W48 fuse 384->48 at 10x10", 0))


def k1_kernel_count(calls) -> int:
    """Device kernels that torch.profiler records over `calls`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def check_k1(card: str) -> list:
    """K1 against its plain version at the W18 main-path shapes (bs32,
    320^2), fast path and generic path, plus a ragged R, an R below one
    row tile and a W48 fuse shape: y within 1 bf16 ulp, s1/s2 within 1e-5
    of f64 sums of the kernel's own y (relative to each channel's sum of
    magnitudes) and bit-identical over repeated launches (three, at
    alternating shapes, on the generic path, whose one launch resets a
    device counter), dx/dw through the autograd.Function within rel 1e-2 of
    plain autograd (bf16 operands: the two round dy_total at different
    points).  On the generic path also: an Inf in one row of x leaves the
    other rows of y finite (its packed tiles read past a row's end in the
    last k16 step), and torch.profiler counts one device kernel a call.
    Returns the JSON entries of both paths (at their first shapes)."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    g = torch.Generator(device="cuda").manual_seed(0)
    floor = cuda_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor (an empty back-to-back kernel): {floor:.4f} ms "
          f"[{card}]")
    errs, entries, inputs = {}, {}, []
    step_ms = {"fast": 0.0, "generic": 0.0}
    prev = None
    for r, k, c, site, sites in K1_FAST + K1_GENERIC:
        path = "fast" if (k, c) in mb.FAST_SHAPES else "generic"
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = (torch.randn((c, k), generator=g, device="cuda")
             / k ** 0.5).bfloat16()
        y, s1, s2 = mb.mm_bn_stats_cuda(x, w)
        runs = [(y, s1, s2), mb.mm_bn_stats_cuda(x, w)]
        if path == "generic":  # alternate with the previous shape
            mb.mm_bn_stats_cuda(*prev)
            runs.append(mb.mm_bn_stats_cuda(x, w))
            mb.mm_bn_stats_cuda(*prev)
            runs.append(mb.mm_bn_stats_cuda(x, w))
        yp, _, _ = mb.mm_bn_stats_plain(x, w)
        torch.cuda.synchronize()
        for y2, a1, a2 in runs[1:]:
            if not (torch.equal(s1, a1) and torch.equal(s2, a2)
                    and torch.equal(y, y2)):
                raise AssertionError(f"K1 differs between launches at {site}")
        yf, ypf = y.float(), yp.float()
        err = (yf - ypf).abs()
        bad = err > bf16_ulp(torch.maximum(yf.abs(), ypf.abs()))
        if bool(bad.any()):
            raise AssertionError(f"K1 y off by more than 1 bf16 ulp at {site}"
                                 f": {int(bad.sum())} elements")
        errs[path] = max(errs.get(path, 0.0), float(err.max()))
        yd = y.double()
        for name, got, want, scale in (
                ("s1", s1, yd.sum(0), yd.abs().sum(0)),
                ("s2", s2, (yd * yd).sum(0), (yd * yd).sum(0))):
            # rel 1e-5 of each channel's sum of magnitudes (s1 of a
            # zero-mean channel cancels, so its own size is no scale)
            if bool(((got.double() - want).abs() > 1e-5 * scale).any()):
                raise AssertionError(f"K1 {name} off at {site}: max err "
                                     f"{float((got.double() - want).abs().max())}")
        # gradients: custom VJP vs plain autograd, same cotangents
        cts = (torch.randn((r, c), generator=g, device="cuda").bfloat16(),
               torch.randn((c,), generator=g, device="cuda") * 1e-3,
               torch.randn((c,), generator=g, device="cuda") * 1e-4)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.backward(mb.conv1x1_bn_stats(xa, wa), cts)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.autograd.backward(mb.mm_bn_stats_plain(xb, wb), cts)
        for name, a, b in (("dx", xa.grad, xb.grad), ("dw", wa.grad, wb.grad)):
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            if not rel < 1e-2:
                raise AssertionError(f"K1 {name} rel err {rel} at {site}")
        note = ""
        if path == "generic":
            # an Inf in a row whose predecessor shares its row tile
            rows = sorted({min(17, r - 1), r // 2 + 3} & set(range(r)))
            xi = x.clone()
            xi[rows] = float("inf")
            yi = mb.mm_bn_stats_cuda(xi, w)[0]
            keep = torch.ones(r, dtype=torch.bool, device="cuda")
            keep[rows] = False
            if not bool(torch.isfinite(yi[keep].float()).all()):
                raise AssertionError(f"K1 at {site}: an Inf in x rows {rows} "
                                     "leaked into other rows of y")
            if bool(torch.isfinite(yi[rows].float()).all()):
                raise AssertionError(f"K1 at {site}: the Inf rows {rows} "
                                     "came out finite")
            inputs.append((x, w))
            note = ", Inf rows stay in their rows, 3 launches identical"
        ms = cuda_ms(lambda: mb.mm_bn_stats_cuda(x, w))
        plain_ms = cuda_ms(lambda: mb.mm_bn_stats_plain(x, w))
        # y only, no sums: one cuBLAS call
        lib_ms = cuda_ms(lambda: torch.matmul(x, w.t()))
        # x and w read, y and the two f32 sums written; 2RKC bf16 ops
        bnd = bound(2 * (r * k + c * k + r * c) + 8 * c, 2 * r * k * c,
                    BF16_OPS_S)
        step_ms[path] += sites * ms
        print(f"K1 {path} R={r} K={k} C={c} ({site}, {sites} sites a step): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
              f"(y only) {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), y max|err| {float(err.max()):.6g}, "
              f"s1/s2 deterministic, dx/dw ok{note} [{card}]")
        if path not in entries:
            entries[path] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 **bnd)
        prev = (x, w)
    n = k1_kernel_count([lambda x=x, w=w: mb.mm_bn_stats_cuda(x, w)
                         for x, w in inputs])
    if n != len(inputs):
        raise AssertionError(f"K1 generic: {n} device kernels for "
                             f"{len(inputs)} calls")
    print(f"K1 generic: torch.profiler counts {n} device kernels for "
          f"{len(inputs)} calls [{card}]")
    print(f"K1 by call times, a fused W18 bs32 step: fast path "
          f"{step_ms['fast']:.4f} ms (18 sites), generic path "
          f"{step_ms['generic']:.4f} ms (62 sites) [{card}]")
    return [{"name": "mm_bn_stats (fused 1x1 conv + BN stats)",
             "route": "cuda",
             "source": "hcmoco_tpu_torch/csrc/matmul_bn.cu",
             "replaces": "hcmoco_tpu/ops/pallas/matmul_bn.py:34",
             "max_abs_err": errs["fast"], **entries["fast"]},
            {"name": "mm_bn_stats generic (fuse-layer shapes)",
             "route": "cuda",
             "source": "hcmoco_tpu_torch/csrc/matmul_bn.cu",
             "replaces": "hcmoco_tpu/ops/pallas/matmul_bn.py:34",
             "max_abs_err": errs["generic"], **entries["generic"]}]


def f32_ulp(v: torch.Tensor) -> torch.Tensor:
    """One f32 ulp at |v| (24 significant bits)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 24)


def within(name: str, got: torch.Tensor, want: torch.Tensor,
           tol: torch.Tensor) -> float:
    err = (got.double() - want.double()).abs()
    bad = err > tol
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"err {float(err.max())}")
    return float(err.max())


def check_k1b(card: str) -> list:
    """K1b (bn_apply_stats forward and backward, K1's dyt prologue) against
    the plain versions on the same inputs, at the layer1 shapes and a ragged
    R with C=18.  Channel 0 of y is constant, so the var >= 0 clamp binds
    there.  Tolerances: out, dy, dyt within 1 bf16 ulp; mean, var within 1
    f32 ulp and the running statistics within 2 (the update's add may
    contract into an FMA in PyTorch's kernel); dbias, dscale within 1e-5 of
    the f64 sums of their terms' magnitudes; ds1, ds2 within 1 bf16 ulp plus
    the error that 1e-5 of those magnitudes, in both the kernel's and the
    plain version's sums, carries into them."""
    import torch.nn.functional as F

    from hcmoco_tpu_torch.ops import matmul_bn as mb

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    errs = [0.0] * 4
    main = None
    for r, c, site in ((204800, 256, "layer1 conv3/downsample"),
                       (204800, 64, "layer1 conv1"),
                       (12800 + 37, 18, "ragged R, C=18")):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)

        y = (rnd(r, c) * 1.3 + 0.2).bfloat16()
        y[:, 0] = 0.5
        yf = y.float()
        s1, s2 = yf.sum(0), (yf * yf).sum(0)
        scale = torch.rand((c,), generator=g, device=dev) + 0.5
        bias = rnd(c)
        rm0, rv0 = rnd(c), rnd(c).abs() + 0.5

        def running():
            return (rm0.clone(), rv0.clone(),
                    torch.zeros((), dtype=torch.int64, device=dev), 0.01)

        run_k, run_p = running(), running()
        out, mean, var, rstd = mb.bn_apply_fwd_cuda(y, s1, s2, scale, bias,
                                                    1e-5, run_k)
        pout, pmean, pvar, prstd = mb.bn_apply_fwd_plain(y, s1, s2, scale,
                                                         bias, 1e-5, run_p)
        if not (float(pvar[0]) == 0.0 == float(var[0])):
            raise AssertionError(f"K1b fwd at {site}: the clamp did not bind "
                                 f"on the constant channel")
        big = torch.maximum(out.float().abs(), pout.float().abs())
        errs[0] = max(errs[0], within(f"K1b fwd out at {site}", out, pout,
                                      bf16_ulp(big)))
        for name, a, b in (("mean", mean, pmean), ("var", var, pvar)):
            within(f"K1b fwd {name} at {site}", a, b,
                   f32_ulp(torch.maximum(a.abs(), b.abs())))
        for name, a, b in (("running_mean", run_k[0], run_p[0]),
                           ("running_var", run_k[1], run_p[1])):
            within(f"K1b fwd {name} at {site}", a, b,
                   2 * f32_ulp(torch.maximum(a.abs(), b.abs())))
        if not int(run_k[2]) == int(run_p[2]) == 1:
            raise AssertionError(f"K1b fwd num_batches_tracked at {site}")

        dout = rnd(r, c).bfloat16()
        dm, dv = rnd(c) * 1e-3, rnd(c) * 1e-3
        args = (dout, y, s1, pmean, pvar, prstd, scale, dm, dv)
        got = mb.bn_apply_bwd_stats_cuda(*args)
        want = mb.bn_apply_bwd_stats_plain(*args)
        terms = dout.float() * ((yf - pmean) * prstd)
        mag_b = dout.double().abs().sum(0)
        mag_s = terms.double().abs().sum(0)
        for i, (name, ref, mag) in enumerate((
                ("dscale", terms.double().sum(0), mag_s),
                ("dbias", dout.double().sum(0), mag_b))):
            errs[1] = max(errs[1], within(f"K1b bwd {name} at {site}",
                                          got[i], ref, 1e-5 * mag))
        rs, sc, rf = prstd.double(), scale.double(), float(r)
        e_b, e_s = 2e-5 * mag_b, 2e-5 * mag_s
        prop = (rs * sc / rf * e_b
                + 0.5 * rs * rs * sc * (2 * s1.double().abs() / rf / rf)
                * e_s,
                0.5 * rs * rs * sc / rf * e_s)
        for i, name in ((2, "ds1"), (3, "ds2")):
            big = torch.maximum(got[i].abs(), want[i].abs())
            errs[1] = max(errs[1], within(f"K1b bwd {name} at {site}",
                                          got[i], want[i],
                                          bf16_ulp(big) + prop[i - 2]))
        if float(got[3][0]) != 0.0:
            raise AssertionError(f"K1b bwd at {site}: ds2 not masked on the "
                                 "constant channel")
        dy = mb.bn_apply_bwd_dy_cuda(dout, prstd, scale)
        pdy = mb.bn_apply_bwd_dy_plain(dout, prstd, scale)
        errs[2] = max(errs[2], within(
            f"K1b bwd dy at {site}", dy, pdy,
            bf16_ulp(torch.maximum(dy.float().abs(), pdy.float().abs()))))
        dyt = mb.mm_bn_bwd_dyt_cuda(pdy, y, want[2], want[3])
        pdyt = mb.mm_bn_bwd_dyt_plain(pdy, y, want[2], want[3])
        errs[3] = max(errs[3], within(
            f"K1b dyt at {site}", dyt, pdyt,
            bf16_ulp(torch.maximum(dyt.float().abs(), pdyt.float().abs()))))

        fwd_args = (y, s1, s2, scale, bias, 1e-5)
        calls = (
            (lambda: mb.bn_apply_fwd_cuda(*fwd_args, run_k),
             lambda: mb.bn_apply_fwd_plain(*fwd_args, run_p)),
            (lambda: mb.bn_apply_bwd_stats_cuda(*args),
             lambda: mb.bn_apply_bwd_stats_plain(*args)),
            (lambda: mb.bn_apply_bwd_dy_cuda(dout, prstd, scale),
             lambda: mb.bn_apply_bwd_dy_plain(dout, prstd, scale)),
            (lambda: mb.mm_bn_bwd_dyt_cuda(pdy, y, want[2], want[3]),
             lambda: mb.mm_bn_bwd_dyt_plain(pdy, y, want[2], want[3])))
        times = [(cuda_ms(k), cuda_ms(p)) for k, p in calls]
        # one PyTorch call each: train-mode batch_norm on the same (R, C)
        # channels_last tensor, and its backward
        shape4 = ((r // 6400, 80, 80, c) if r % 6400 == 0
                  else (1, 1, r, c))
        y4 = y.view(shape4).permute(0, 3, 1, 2)
        d4 = dout.view(shape4).permute(0, 3, 1, 2)
        rm, rv = run_k[0].clone(), run_k[1].clone()
        lib_f = cuda_ms(lambda: F.batch_norm(y4, rm, rv, scale, bias,
                                             True, 0.01, 1e-5))
        _, smean, sinv = torch.ops.aten.native_batch_norm(
            y4, scale, bias, rm, rv, True, 0.01, 1e-5)
        lib_b = cuda_ms(lambda: torch.ops.aten.native_batch_norm_backward(
            d4, y4, scale, rm, rv, smean, sinv, True, 1e-5,
            [True, True, True]))
        print(f"K1b R={r} C={c} ({site}): fwd {times[0][0]:.4f} ms (plain "
              f"{times[0][1]:.4f}, F.batch_norm {lib_f:.4f}), bwd sums "
              f"{times[1][0]:.4f} (plain {times[1][1]:.4f}, "
              f"native_batch_norm_backward {lib_b:.4f}), dy "
              f"{times[2][0]:.4f} (plain {times[2][1]:.4f}), dyt "
              f"{times[3][0]:.4f} (plain {times[3][1]:.4f}); within "
              f"tolerance [{card}]")
        if main is None:
            rc = r * c
            # bf16 (R, C) tensors read and written once; f32 ops per element
            main = [(times[0], bound(4 * rc + 36 * c, 3 * rc, F32_OPS_S),
                     lib_f),
                    (times[1], bound(4 * rc + 52 * c, 6 * rc, F32_OPS_S),
                     lib_b),
                    (times[2], bound(4 * rc + 8 * c, rc, F32_OPS_S), None),
                    (times[3], bound(6 * rc + 8 * c, 4 * rc, F32_OPS_S),
                     None)]
    names = (("bn_apply_stats fwd (K1b: one-pass BN apply + running stats)",
              "hcmoco_tpu/ops/pallas/matmul_bn.py:138"),
             ("bn_apply_stats bwd sums (K1b: dbias, dscale, ds1, ds2)",
              "hcmoco_tpu/ops/pallas/matmul_bn.py:138"),
             ("bn_apply_stats bwd dy (K1b)",
              "hcmoco_tpu/ops/pallas/matmul_bn.py:138"),
             ("conv1x1_bn_stats bwd prologue dyt (K1b)",
              "hcmoco_tpu/ops/pallas/matmul_bn.py:111"))
    return [kernel_entry(n, "matmul_bn.cu", rep, err, t[0], t[1], bnd, lib)
            for (n, rep), err, (t, bnd, lib) in zip(names, errs, main)]


def depth_clouds(dev, batch_size: int, size: int, n_points: int):
    """depth2pts on one synthetic batch: the sampled cloud (B, n_points, 3)
    in raster order, all_pts (B, size^2, 3), the pixels that pts2depth
    interpolates onto, and the clouds' validity.  About half the samples
    have no depth, so their clouds are all zeros."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.pointnet2_model import depth2pts

    b = synthetic_contrast_batch(np.random.default_rng(0), batch_size,
                                 size=size, n_data=N_DATA)
    t = {k: torch.from_numpy(b[k]).to(dev)
         for k in ("rgbd", "depth_mask", "grid_xy", "depth_mean")}
    cloud, all_pts, _, valid = depth2pts(
        t["rgbd"][..., 3], t["depth_mask"], t["grid_xy"], 424.0, 512.0,
        t["depth_mean"], n_points, generator=torch.Generator(dev).manual_seed(0))
    if bool(valid.all()) or not bool(valid.any()):
        raise AssertionError("the batch must hold valid and zero clouds")
    return cloud, all_pts, valid


def point_levels(dev, batch_size: int, size: int, n_points: int):
    """The point sets of the HRNetPN path for one synthetic batch, through
    the plain versions: depth2pts's cloud and the sorted FPS centers of the
    four SA levels (l_xyz[0..4] of Pointnet2MSG), and the clouds'
    validity."""
    from hcmoco_tpu_torch.ops.fps import fps_plain
    from hcmoco_tpu_torch.ops.point_ops import gather_points

    cloud, _, valid = depth_clouds(dev, batch_size, size, n_points)
    levels = [cloud]
    for k in range(4):
        xyz = levels[-1]
        m = max(n_points // 4 ** k, 1)
        idx = (torch.arange(m, device=dev, dtype=torch.int32).expand(
            batch_size, m) if m == xyz.shape[1] else fps_plain(xyz, m))
        levels.append(gather_points(xyz, torch.sort(idx, dim=-1).values))
    return levels, valid


def kernel_entry(name: str, source: str, replaces: str, err: float,
                 ms: float, plain_ms: float, bnd: dict,
                 library_ms=None) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"hcmoco_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bnd}


def scatter_exact(name: str, fn, want: torch.Tensor) -> float:
    """A backward kernel's gradient, launched twice: the two launches equal
    each other bit for bit, and `want`, the plain version computed on the
    CPU (both add each destination's sources in ascending order in f32,
    then round once).  Returns the max abs error, 0.0."""
    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two launches differ at "
                             f"{int((a != b).sum())} elements")
    a = a.cpu()
    if not torch.equal(a, want):
        err = float((a.float() - want.float()).abs().max())
        raise AssertionError(f"{name}: {int((a != want).sum())} elements "
                             f"differ from the plain version on the CPU, "
                             f"max err {err}")
    return 0.0


def check_csr(name: str, idx: torch.Tensor, n_dest: int) -> None:
    """K56a against its plain version on the same card: start and src
    equal."""
    from hcmoco_tpu_torch.ops import point_gather as pg

    start, src = pg.dest_csr_cuda(idx, n_dest)
    pstart, psrc = pg.dest_csr_plain(idx, n_dest)
    if not (torch.equal(start, pstart) and torch.equal(src, psrc)):
        raise AssertionError(f"K56a dest_csr at {name}: "
                             f"{int((src != psrc).sum())} sources misplaced")


def k3_scan(xyz: torch.Tensor, centers: torch.Tensor, r: float, s: int,
            chunk: int = 256) -> dict:
    """What a first-hit ball query of radius r and S slots must test on
    these points, and what K3's tile skip leaves of it.  Per center, `pos`
    is the index of its S-th hit plus one (N if it has fewer hits): the
    points a blind scan tests.  K3 tests the boxes of the 32-tile groups
    up to the group of the S-th hit (all of them without S hits) and the
    points of the tiles among them whose bound (`tile_bounds`) is below
    r^2.  Raises if a hit lies in a tile that the bound skips."""
    from hcmoco_tpu_torch.ops.ball_query import TILE, tile_bounds
    from hcmoco_tpu_torch.ops._points import sq_dists

    b, n, _ = xyz.shape
    m = centers.shape[1]
    t = -(-n // TILE)
    r2 = torch.tensor(r * r, dtype=torch.float32, device=xyz.device)
    tile = torch.arange(t, device=xyz.device)
    pos, reach, tiles, boxes = [], 0, 0, 0
    for c0 in range(0, m, chunk):
        cen = centers[:, c0:c0 + chunk]
        hit = sq_dists(cen, xyz) < r2  # (B, C, N)
        cs = hit.cumsum(-1, dtype=torch.int32)
        p = torch.where(cs[..., -1] >= s, (cs >= s).int().argmax(-1) + 1, n)
        ok = tile_bounds(xyz, cen) < r2  # (B, C, T)
        pad = torch.zeros(hit.shape[:2] + (t * TILE - n,), dtype=torch.bool,
                          device=xyz.device)
        held = torch.cat([hit, pad], -1).view(*ok.shape, TILE).any(-1)
        if bool((held & ~ok).any()):
            raise AssertionError(f"K3 r={r}: a tile with hits was skipped")
        last = (p - 1) // TILE
        tiles += int((ok & (tile <= last[..., None])).sum())
        boxes += int(torch.clamp((last // 32 + 1) * 32, max=t).sum())
        reach += int(ok.sum())
        pos.append(p.reshape(-1))
    pos = torch.cat(pos).double()
    q = torch.quantile(pos, torch.tensor([0.25, 0.5, 0.75], device=pos.device,
                                         dtype=torch.float64)).tolist()
    return {"q1": q[0], "median": q[1], "q3": q[2],
            "all_n": float((pos >= n).double().mean()),
            "blind_tests": int(pos.sum()), "pairs": b * m * n,
            "reach": reach / (b * m * t), "kernel_tests": TILE * tiles,
            "box_tests": boxes}


def print_k3_scan(label: str, st: dict, card: str) -> None:
    print(f"  K3 {label} scan: S-th hit at index+1 quartiles {st['q1']:.0f} /"
          f" {st['median']:.0f} / {st['q3']:.0f}, {st['all_n']:.4f} of "
          f"centers scan all N; {st['reach']:.4f} of tiles reachable; "
          f"blind scan {st['blind_tests']} point tests "
          f"({st['blind_tests'] / st['pairs']:.4f} of pairs), K3 "
          f"{st['kernel_tests']} point tests + {st['box_tests']} box tests "
          f"[{card}]")


def k4_scan(unknown: torch.Tensor, known: torch.Tensor, dist: torch.Tensor,
            idx: torch.Tensor, valid: torch.Tensor) -> dict:
    """What K4's tile walk visits on these points, given the plain
    version's answer (dist, idx).  A warp of 32 unknowns visits the tiles
    whose (bound, first index) is at most its final (B3, I3): B3 its
    lanes' largest third distance, I3 their largest third index at B3
    (csrc/three_nn.cu).  Shares of (warp, tile) pairs visited, over all
    samples and over the valid and the zero clouds apart.  Raises if a
    tile that the walk skips holds one of the plain version's three
    neighbours."""
    from hcmoco_tpu_torch.ops._points import TILE
    from hcmoco_tpu_torch.ops.three_nn import F32_MAX, tile_bounds

    b, n, _ = unknown.shape
    bounds = tile_bounds(unknown, known)  # (B, W, T)
    w, t = bounds.shape[1:]
    pad = w * TILE - n
    d3 = torch.cat([dist[..., 2], dist.new_zeros((b, pad))], 1).view(b, w,
                                                                     TILE)
    i3 = torch.cat([idx[..., 2], idx.new_full((b, pad), -1)], 1).view(b, w,
                                                                     TILE)
    b3 = d3.amax(-1, keepdim=True)
    top = torch.where(d3 == b3, i3, -1).amax(-1, keepdim=True)
    first = TILE * torch.arange(t, device=bounds.device)
    skip = (bounds > b3) | ((bounds == b3) & (first > top))
    warp = (torch.arange(n, device=idx.device) // TILE)[None, :, None]
    held = skip[torch.arange(b, device=idx.device)[:, None, None], warp,
                idx.long() // TILE]
    if bool((held & (dist < F32_MAX)).any()):
        raise AssertionError("K4: a skipped tile holds a neighbour")
    seen = (~skip).float()
    return {"all": float(seen.mean()), "valid": float(seen[valid].mean()),
            "zero": float(seen[~valid].mean()),
            "tests": int(seen.sum()) * TILE * TILE, "pairs": b * n *
            known.shape[1]}


def print_k4_scan(label: str, st: dict, card: str) -> None:
    print(f"  K4 {label} scan: {st['all']:.4f} of (warp, tile) pairs visited"
          f" (valid clouds {st['valid']:.4f}, zero clouds {st['zero']:.4f});"
          f" {st['tests']} point tests, a blind scan {st['pairs']}; no "
          f"neighbour in a skipped tile [{card}]")


def check_three_nn(name: str, unknown: torch.Tensor, known: torch.Tensor,
                   zero: torch.Tensor):
    """K4 against its plain version: distances and indices equal, two
    launches equal, the zero clouds' neighbours 0, 1, 2.  Returns the
    plain version's (dist, idx)."""
    from hcmoco_tpu_torch.ops import three_nn as tn

    dist, idx = tn.three_nn_cuda(unknown, known)
    dist2, idx2 = tn.three_nn_cuda(unknown, known)
    pdist, pidx = tn.three_nn_plain(unknown, known)
    if not (torch.equal(dist, dist2) and torch.equal(idx, idx2)):
        raise AssertionError(f"K4 three-NN {name}: two launches differ")
    if (not torch.equal(idx, pidx) or not torch.equal(dist, pdist)
            or not bool((idx[zero] == torch.arange(
                3, device=idx.device, dtype=torch.int32)).all())):
        raise AssertionError(f"K4 three-NN {name}: "
                             f"{int((idx != pidx).sum())} indices off")
    return pdist, pidx


def check_pts2depth(card: str, batch_size: int = 8) -> None:
    """K4 at pts2depth's call (every pixel of the 320^2 crop against the
    4096 sampled points; hcmoco_tpu/models/pointnet2_model.py:414), bs8
    with zero clouds: equal to the plain version, and its scan."""
    from hcmoco_tpu_torch.ops import three_nn as tn

    cloud, all_pts, valid = depth_clouds("cuda", batch_size, 320, 4096)
    dist, idx = check_three_nn("pts2depth", all_pts, cloud, ~valid)
    ms = cuda_ms(lambda: tn.three_nn_cuda(all_pts, cloud), iters=5)
    print(f"K4 three-NN pts2depth ({batch_size},{all_pts.shape[1]}<-"
          f"{cloud.shape[1]}): kernel {ms:.4f} ms, indices and distances "
          f"equal, two launches equal [{card}]")
    print_k4_scan("pts2depth", k4_scan(all_pts, cloud, dist, idx, valid),
                  card)


def check_points(card: str, dev="cuda", batch_size: int = PN_BATCH,
                 size: int = 320, n_points: int = 4096) -> list:
    """K2-K6 against their plain versions at every call of one HRNetPN step
    (the path's shapes, bs64), inputs from a synthetic batch with zero
    clouds.  Indices and distances equal, gathers exact, the backwards'
    destination index (K56a) equal and their gradients bit for bit equal to
    the plain versions on the CPU and over two launches (`scatter_exact`);
    kernel times for every call, the plain versions' (and K5's PyTorch
    call) at each kernel's largest call."""
    from hcmoco_tpu_torch.models.pointnet2_model import (MLPS, NSAMPLE,
                                                         RADIUS)
    from hcmoco_tpu_torch.ops import ball_query as bq
    from hcmoco_tpu_torch.ops import fps as fp
    from hcmoco_tpu_torch.ops import point_gather as pg
    from hcmoco_tpu_torch.ops import three_nn as tn
    from hcmoco_tpu_torch.ops.point_ops import interpolation_weights

    levels, valid = point_levels(dev, batch_size, size, n_points)
    zero = ~valid
    b = batch_size
    g = torch.Generator(device=dev).manual_seed(0)
    out = []

    # K2: sa1-sa3 (sa0 takes the identity)
    for k in (1, 2, 3):
        xyz, m = levels[k], levels[k + 1].shape[1]
        got, want = fp.fps_cuda(xyz, m), fp.fps_plain(xyz, m)
        if not torch.equal(got, want) or bool(got[zero].any()):
            raise AssertionError(f"K2 fps {tuple(xyz.shape)}->{m}: "
                                 f"{int((got != want).sum())} indices off")
        ms = cuda_ms(lambda: fp.fps_cuda(xyz, m))
        print(f"K2 fps ({b},{xyz.shape[1]},3)->{m}: kernel {ms:.4f} ms, "
              f"{ms * 1e3 / (m - 1):.4f} us a round, indices equal [{card}]")
        if k == 1:
            n = xyz.shape[1]
            # 10 f32 ops a point a round: 3 sub, 3 mul, 2 add, min, compare
            k2 = kernel_entry(
                "fps (furthest point sampling)", "fps.cu",
                "hcmoco_tpu/ops/pallas/fps.py:26", 0.0, ms,
                cuda_ms(lambda: fp.fps_plain(xyz, m)),
                bound(b * n * 12 + b * m * 4, 10 * b * n * (m - 1),
                      F32_NOFMA_OPS_S))

    # K2 past 16384 points, where a shared-memory design ran out: the kernel
    # streams the points from device memory
    gb = torch.Generator(device=dev).manual_seed(5)
    big = torch.randn((4, 20000, 3), generator=gb, device=dev) * 0.3
    big[-1] = 0.0
    if not torch.equal(fp.fps_cuda(big, 512), fp.fps_plain(big, 512)):
        raise AssertionError("K2 fps (4,20000,3)->512: indices off")
    print(f"K2 fps (4,20000,3)->512: kernel "
          f"{cuda_ms(lambda: fp.fps_cuda(big, 512), iters=5):.4f} ms, "
          f"indices equal [{card}]")
    del big

    # K3: every SA level and scale; the largest call is sa0 scale 1
    gidxs = []
    for k in range(4):
        xyz, centers = levels[k], levels[k + 1]
        n, m = xyz.shape[1], centers.shape[1]
        for i, (r, s) in enumerate(zip(RADIUS[k], NSAMPLE[k])):
            got = bq.ball_query_cuda(xyz, centers, r, s)
            want = bq.ball_query_plain(xyz, centers, r, s)
            # a zero cloud: every point hits, so the slots take 0..S-1
            first = torch.arange(s, device=dev, dtype=torch.int32)
            first = torch.where(first < n, first, 0)
            if not torch.equal(got, want) or not bool(
                    (got[zero] == first).all()):
                raise AssertionError(f"K3 ball query sa{k} scale {i}: "
                                     f"{int((got != want).sum())} off")
            gidxs.append((k, i, got))
            ms = cuda_ms(lambda: bq.ball_query_cuda(xyz, centers, r, s))
            print(f"K3 ball query sa{k}.{i} N={n} M={m} S={s} r={r}: kernel "
                  f"{ms:.4f} ms, indices equal [{card}]")
            if k == 0:
                print_k3_scan(f"sa0.{i}", k3_scan(xyz, centers, r, s), card)
            if (k, i) == (0, 1):
                # K3 skips tests, so its bound is the bytes: points and
                # centers read once, idx written once
                k3 = kernel_entry(
                    "ball_query (first-hit fill)", "ball_query.cu",
                    "hcmoco_tpu/ops/pallas/ball_query.py:24", 0.0, ms,
                    cuda_ms(lambda: bq.ball_query_plain(xyz, centers, r, s)),
                    bound(b * (n + m) * 12 + b * m * s * 4, 0, F32_OPS_S))

    # K4: every FP level; the largest call is fp0, 4096 x 4096
    nns = []
    for i in range(4):
        unknown, known = levels[i], levels[i + 1]
        n, m = unknown.shape[1], known.shape[1]
        dist, idx = check_three_nn(f"fp{i}", unknown, known, zero)
        w = interpolation_weights(dist)
        if not torch.allclose(w[zero], torch.full_like(w[zero], 1 / 3)):
            raise AssertionError(f"K4 three-NN fp{i}: zero-cloud weights")
        nns.append((idx, w))
        ms = cuda_ms(lambda: tn.three_nn_cuda(unknown, known))
        print(f"K4 three-NN fp{i} N={n} M={m}: kernel {ms:.4f} ms, indices "
              f"and distances equal, two launches equal [{card}]")
        print_k4_scan(f"fp{i}", k4_scan(unknown, known, dist, idx, valid),
                      card)
        if i == 0:
            # K4 skips tests, so its bound is the bytes: points read once,
            # dist and idx written once.  A blind scan's 9 f32 ops a pair
            # (3 sub, 3 mul, 2 add, compare), uncontracted, for reference
            blind = 9 * b * n * m / F32_NOFMA_OPS_S * 1e3
            print(f"  K4 fp0: a blind scan needs {blind:.4f} ms at "
                  f"{F32_NOFMA_OPS_S:.4g} f32 ops/s [{card}]")
            k4 = kernel_entry(
                "three_nn", "three_nn.cu",
                "hcmoco_tpu/ops/pallas/three_nn.py:25", 0.0, ms,
                cuda_ms(lambda: tn.three_nn_plain(unknown, known)),
                bound(b * (n + m) * 12 + b * n * 24, 0, F32_OPS_S))
    check_pts2depth(card)

    # K5: the grouping of every SA scale, forward and backward; the
    # largest call is sa0 scale 1, (64, 4096, 32, 32) bf16 out
    err5b = 0.0
    for k, i, gidx in gidxs:
        n, c = levels[k].shape[1], MLPS[k][i][0]
        _, m, s = gidx.shape
        table = torch.randn((b, n, c), generator=g, device=dev).bfloat16()
        gout = torch.randn((b, m, s, c), generator=g, device=dev).bfloat16()
        got = pg.group_rows_cuda(table, gidx)
        if not torch.equal(got, pg.group_rows_plain(table, gidx)):
            raise AssertionError(f"K5 group fwd sa{k}.{i}: not exact")
        check_csr(f"K5 sa{k}.{i}", gidx.view(b, m * s), n)
        err5b = max(err5b, scatter_exact(
            f"K5 group bwd sa{k}.{i}",
            lambda: pg.group_rows_bwd_cuda(gout, gidx, n),
            pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(), n)))
        ms_f = cuda_ms(lambda: pg.group_rows_cuda(table, gidx))
        ms_b = cuda_ms(lambda: pg.group_rows_bwd_cuda(gout, gidx, n))
        print(f"K5 group sa{k}.{i} ({b},{n},{c})->({m},{s}): fwd {ms_f:.4f} "
              f"ms exact, bwd {ms_b:.4f} ms equal to the CPU's, "
              f"deterministic [{card}]")
        if (k, i) != (0, 1):
            continue
        rows, out_b = b * m * s, b * m * s * c * 2
        # one PyTorch call each: advanced indexing; index_add_ (in bf16)
        bidx = torch.arange(b, device=dev)[:, None, None]
        flat = (gidx + (torch.arange(b, device=dev, dtype=torch.int32)
                        * n)[:, None, None]).reshape(-1)
        acc = torch.zeros((b * n, c), dtype=torch.bfloat16, device=dev)
        k5f = kernel_entry(
            "group_rows fwd (row gather)", "point_gather.cu",
            "hcmoco_tpu/ops/pallas/window_group.py:108", 0.0, ms_f,
            cuda_ms(lambda: pg.group_rows_plain(table, gidx)),
            bound(b * n * c * 2 + rows * 4 + out_b, 0, F32_OPS_S),
            cuda_ms(lambda: table[bidx, gidx]))
        k5b = kernel_entry(
            "group_rows bwd (K56a + K56b, ordered segment sum)",
            "point_gather.cu",
            "hcmoco_tpu/ops/pallas/window_group.py:125", 0.0, ms_b,
            cuda_ms(lambda: pg.group_rows_bwd_plain(gout, gidx, n)),
            bound(out_b + rows * 4 + b * n * c * 2, rows * c, F32_OPS_S),
            cuda_ms(lambda: acc.index_add_(0, flat, gout.reshape(-1, c))))
        # K56a and K56b alone at this call
        idx2 = gidx.view(b, m * s)
        start, src = pg.dest_csr_cuda(idx2, n)
        rows3 = gout.view(b, m * s, c)
        k56a = kernel_entry(
            "dest_csr (K56a, destination index of K5/K6 bwd)",
            "point_gather.cu",
            "hcmoco_tpu/ops/pallas/window_group.py:125, "
            "window_interp.py:100 (part of both backwards)", 0.0,
            cuda_ms(lambda: pg.dest_csr_cuda(idx2, n)),
            cuda_ms(lambda: pg.dest_csr_plain(idx2, n)),
            bound(rows * 8 + b * (n + 1) * 4, 0, F32_OPS_S))
        k56b = kernel_entry(
            "segment_rows_sum (K56b, ordered sum of K5/K6 bwd)",
            "point_gather.cu",
            "hcmoco_tpu/ops/pallas/window_group.py:125, "
            "window_interp.py:100 (part of both backwards)", 0.0,
            cuda_ms(lambda: pg.segment_rows_sum_cuda(rows3, start, src, n)),
            cuda_ms(lambda: pg.segment_rows_sum_plain(rows3, start, src, n),
                    iters=2, warmup=1),
            bound(out_b + rows * 4 + b * (n + 1) * 4 + b * n * c * 2,
                  rows * c, F32_OPS_S))
        print(f"  K56a {k56a['ms']:.4f} ms (plain {k56a['plain_ms']:.4f}), "
              f"K56b {k56b['ms']:.4f} ms (plain {k56b['plain_ms']:.4f}) "
              f"[{card}]")
        # the zero clouds' rows all land on their first S table rows
        for label, sel in (("valid", valid), ("zero-cloud", zero)):
            gs, gi = gout[sel].contiguous(), gidx[sel].contiguous()
            t = cuda_ms(lambda: pg.group_rows_bwd_cuda(gs, gi, n))
            print(f"  K5 bwd on the {int(sel.sum())} {label} samples alone: "
                  f"{t:.4f} ms, {t / int(sel.sum()):.5f} ms a sample")

    # K6: the interpolation of every FP level, forward and backward; the
    # largest call is fp1, (64, 4096, 512) bf16 out from 1024 rows
    err6b = 0.0
    for i, (idx, w) in enumerate(nns):
        m = levels[i + 1].shape[1]
        c = (256, 512, 512, 1024)[i]  # the known features' width
        n = idx.shape[1]
        feat = torch.randn((b, m, c), generator=g, device=dev).bfloat16()
        gout = torch.randn((b, n, c), generator=g, device=dev).bfloat16()
        if not torch.equal(pg.interpolate_rows_cuda(feat, idx, w),
                           pg.interpolate_rows_plain(feat, idx, w)):
            raise AssertionError(f"K6 interpolate fwd fp{i}: not exact")
        check_csr(f"K6 fp{i}", idx.view(b, n * 3), m)
        err6b = max(err6b, scatter_exact(
            f"K6 interpolate bwd fp{i}",
            lambda: pg.interpolate_rows_bwd_cuda(gout, idx, w, m),
            pg.interpolate_rows_bwd_plain(gout.cpu(), idx.cpu(), w.cpu(),
                                          m)))
        ms_f = cuda_ms(lambda: pg.interpolate_rows_cuda(feat, idx, w))
        ms_b = cuda_ms(lambda: pg.interpolate_rows_bwd_cuda(gout, idx, w, m))
        print(f"K6 interpolate fp{i} ({b},{m},{c})->{n}: fwd {ms_f:.4f} ms "
              f"exact, bwd {ms_b:.4f} ms equal to the CPU's, deterministic "
              f"[{card}]")
        if i != 1:
            continue
        small = b * m * c * 2 + b * n * 24  # feat or grad, idx and weights
        k6f = kernel_entry(
            "interpolate_rows fwd (weighted 3-row gather)", "point_gather.cu",
            "hcmoco_tpu/ops/pallas/window_interp.py:80", 0.0, ms_f,
            cuda_ms(lambda: pg.interpolate_rows_plain(feat, idx, w)),
            bound(small + b * n * c * 2, 5 * b * n * c, F32_OPS_S))
        k6b = kernel_entry(
            "interpolate_rows bwd (K56a + K56b, ordered segment sum)",
            "point_gather.cu", "hcmoco_tpu/ops/pallas/window_interp.py:100",
            0.0, ms_b,
            cuda_ms(lambda: pg.interpolate_rows_bwd_plain(gout, idx, w, m)),
            bound(small + b * n * c * 2, 6 * b * n * c, F32_OPS_S))
        for label, sel in (("valid", valid), ("zero-cloud", zero)):
            gs, ii, ww = (x[sel].contiguous() for x in (gout, idx, w))
            t = cuda_ms(lambda: pg.interpolate_rows_bwd_cuda(gs, ii, ww, m))
            print(f"  K6 bwd on the {int(sel.sum())} {label} samples alone: "
                  f"{t:.4f} ms, {t / int(sel.sum()):.5f} ms a sample")
    k5b["max_abs_err"], k6b["max_abs_err"] = err5b, err6b
    return [k2, k3, k4, k5f, k5b, k6f, k6b, k56a, k56b]


def make_cfg(**kw):
    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config

    base = dict(method="CMCRGBD2S", arch="HRNet", width=18,
                batch_size=BATCH, epochs=100, learning_rate=0.03,
                cosine=True, nce_k=16384, modality_missing=True,
                crop_size=320, compute_dtype="bfloat16")
    base.update(kw)
    return resolve_config(TrainConfig(**base))


BATCH_KEYS = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
              "depth_mask", "grid_xy", "depth_mean", "pts_u")


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS
            if k in batch}


def small_reference_check(card: str, arch: str = "HRNet") -> None:
    """One f32 train step of the tiny (width-4, 32^2; HRNetPN: 64 points)
    model on the card vs the same step on the CPU (the CPU path is held
    against the JAX package by tests/test_torch_*.py): losses, updated
    params and banks within rel 1e-4.  Plain ConvBN path: K1 is bf16-only,
    and the tiny model in bf16 moves its features by 2% between any two
    bf16 implementations, so K1 is held against its plain version by
    check_k1 and, at W18, by the fused-vs-unfused step in drive_slice.

    The HRNetPN step runs K2-K6 on the card and their plain versions on
    the CPU, with the depth2pts uniforms pinned and zero clouds in the
    batch.  Its point encoder (encoder2) is f32-ill-conditioned at this
    size (tests/test_torch_pn_train_step.py): what the point cloud's
    feature feeds (the losses of the directions with modality 2, bank 2)
    is held to rel 1e-3, atol 5e-4, and encoder2's parameters to the same
    step with encoder2 in float64 on the CPU: the card's f32 parameters
    must lie within 3x the CPU f32 step's distance from it."""
    from hcmoco_tpu_torch.contrast.memory import sample_negative_counts
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cfg = make_cfg(arch=arch, width=4, crop_size=32, batch_size=6, nce_k=15,
                   compute_dtype="float32", pn_num_points=64)
    rng = np.random.default_rng(1)
    batch = synthetic_contrast_batch(rng, 6, size=32, n_data=64)
    if arch == "HRNet":
        # depth of every sample non-zero: the synthetic all-zero depth
        # samples leave the tiny depth encoder too ill-conditioned to
        # compare
        batch["rgbd"] = (rng.standard_normal((6, 32, 32, 6)) * 0.5).astype(
            np.float32)
    else:
        batch["pts_u"] = rng.random((6, 64), dtype=np.float32)
        if not 0 < int(batch["use_depth"].sum()) < 6:
            raise AssertionError("the batch must hold valid and zero clouds")
    counts = sample_negative_counts(torch.Generator().manual_seed(2), 6, 64,
                                    15)
    torch.manual_seed(0)
    model = set_convbn_fuse(build_model(cfg, device="cpu"), False)
    banks = None
    res = {}
    runs = ["cpu", "cuda"] + (["cpu-f64"] if arch == "HRNetPN" else [])
    for run in runs:
        dev = run.split("-")[0]
        m = copy.deepcopy(model).to(dev)
        if run == "cpu-f64":  # encoder2 in float64: the reference
            m.encoder2.double()
            for mod in m.encoder2.modules():
                if hasattr(mod, "compute_dtype"):
                    mod.compute_dtype = torch.float64
        st = create_train_state(cfg, m, torch.Generator(dev).manual_seed(3),
                                n_data=64, steps_per_epoch=10)
        if banks is None:
            banks = st.banks.clone()
        st.banks = banks.to(dev, copy=True)  # the step updates it in place
        b = to_device(batch, dev)
        b["counts"] = counts.to(dev)
        step = make_contrast_train_step(cfg, m, steps_per_epoch=10)
        losses = {k: float(v) for k, v in step(st, b).items()
                  if k.startswith("nce_loss") or k == "loss"}
        res[run] = (losses, {k: v.cpu() for k, v in m.state_dict().items()},
                    st.banks.cpu())
    (l_ref, sd_ref, b_ref), (l_got, sd_got, b_got) = res["cpu"], res["cuda"]
    pn_tol = dict(rtol=1e-3, atol=5e-4)
    for k, ref in l_ref.items():
        tol = pn_tol if arch == "HRNetPN" and "2" in k else dict(
            rtol=1e-4, atol=0.0)
        if not abs(l_got[k] - ref) <= tol["atol"] + tol["rtol"] * abs(ref):
            raise AssertionError(f"tiny step {k}: card {l_got[k]} vs cpu {ref}")
    for i in range(b_ref.shape[0]):
        torch.testing.assert_close(
            b_got[i], b_ref[i],
            **(pn_tol if arch == "HRNetPN" and i == 1 else
               dict(rtol=1e-4, atol=1e-5)),
            msg=lambda m, i=i: f"tiny step bank {i + 1}: {m}")
    dist = {"cuda": 0.0, "cpu": 0.0}
    for k, ref in sd_ref.items():
        if not ref.is_floating_point():
            continue
        if arch == "HRNetPN" and k.startswith("encoder2."):
            if k.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(
                    sd_got[k], ref, rtol=1e-3,
                    atol=1e-3 * float(ref.abs().max()),
                    msg=lambda m, k=k: f"tiny step {k}: {m}")
            else:
                truth = res["cpu-f64"][1][k].double()
                for run in dist:
                    dist[run] += float(((res[run][1][k].double() - truth)
                                        ** 2).sum())
            continue
        torch.testing.assert_close(sd_got[k], ref, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, k=k: f"tiny step {k}: {m}")
    note = ""
    if arch == "HRNetPN":
        card_d, cpu_d = dist["cuda"] ** 0.5, dist["cpu"] ** 0.5
        if not card_d <= 3 * cpu_d:
            raise AssertionError(f"tiny step encoder2: card {card_d} vs cpu "
                                 f"{cpu_d} from the float64 step")
        note = (f"; encoder2 params {card_d:.4g} (card) and {cpu_d:.4g} "
                "(cpu) from the float64 step")
    print(f"tiny f32 {arch} step, card vs cpu: loss {l_got['loss']:.6f} vs "
          f"{l_ref['loss']:.6f}, params and banks within tolerance{note} "
          f"[{card}]")


def k1_wrappers() -> dict:
    """K1's and K1b's wrappers, in the order of their JSON entries; each
    launches once per fused site and step."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    return {"mm_bn_stats": mb.mm_bn_stats_cuda,
            "bn_apply fwd": mb.bn_apply_fwd_cuda,
            "bn_apply bwd sums": mb.bn_apply_bwd_stats_cuda,
            "bn_apply bwd dy": mb.bn_apply_bwd_dy_cuda,
            "mm_bn bwd dyt": mb.mm_bn_bwd_dyt_cuda}


def generic_sites(encoder) -> int:
    """Fused ConvBN sites of an HRNet whose (K, C) takes K1's generic
    path."""
    from hcmoco_tpu_torch.models.hrnet import _is_fusable
    from hcmoco_tpu_torch.ops.matmul_bn import FAST_SHAPES

    return sum(1 for m in encoder.modules()
               if isinstance(m, torch.nn.Conv2d) and _is_fusable(m)
               and (m.in_channels, m.out_channels) not in FAST_SHAPES)


def drive_slice(card: str) -> dict:
    """Stage-1 W18 320^2 bs32 train steps through the user entry points,
    HCMOCO_CONVBN_FUSE=1; returns K1's (all and generic-path) and K1b's
    launches during the steps, in the order of their JSON entries."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.ops import matmul_bn as mb
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites, set_convbn_fuse
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = make_cfg()
    os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), BATCH, size=cfg.crop_size, num_joints=16,
        n_data=N_DATA), dev)
    sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
    generic = generic_sites(model.encoder1) + generic_sites(model.encoder2)

    # the fused and the unfused step from one copied state
    twin = copy.deepcopy(state)
    twin_losses = {}
    for fuse in ("1", "0"):
        st = copy.deepcopy(twin)
        set_convbn_fuse(st.model, fuse == "1")
        tstep = make_contrast_train_step(cfg, st.model, steps_per_epoch=100)
        twin_losses[fuse] = {
            k: float(v) for k, v in
            tstep(st, batch, torch.Generator(dev).manual_seed(7)).items()
            if k.startswith("nce_loss") or k == "loss"}
        del st, tstep
    del twin
    for k, ref in twin_losses["0"].items():
        got = twin_losses["1"][k]
        if not abs(got - ref) <= 2e-2 * abs(ref):
            raise AssertionError(f"fused vs unfused {k}: {got} vs {ref}")
    print("fused vs unfused step: " + ", ".join(
        f"{k} {twin_losses['1'][k]:.5f}/{twin_losses['0'][k]:.5f}"
        for k in twin_losses["1"]) + " (rel tol 2e-2)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = k1_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    mb.mm_bn_stats_cuda.generic_launches = 0
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()
                       if k.startswith("nce_loss") or k == "loss"})
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"step {i}: non-finite loss {l}")
    for name, n in launches.items():
        if n != sites * STEPS:
            raise AssertionError(f"{name} launched {n} times in {STEPS} "
                                 f"steps, expected {sites} sites x {STEPS}")
    n_gen = mb.mm_bn_stats_cuda.generic_launches
    if n_gen != generic * STEPS:
        raise AssertionError(f"K1's generic path launched {n_gen} times in "
                             f"{STEPS} steps, expected {generic} sites x "
                             f"{STEPS}")
    launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                "mm_bn_stats generic": n_gen, **launches}
    if not bool(torch.isfinite(state.banks).all()):
        raise AssertionError("non-finite bank rows")
    print("losses per step: " + ", ".join(f"{l['loss']:.5f}" for l in losses))
    print("step times (s): " + ", ".join(f"{t:.4f}" for t in times)
          + f"; first step includes warm-up [{card}]")
    steady = statistics.median(times[1:])
    print(f"W18 320^2 bs{BATCH} fused stage-1 step: median {steady * 1e3:.2f}"
          f" ms = {BATCH / steady:.2f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1/K1b launches "
          f"{launches}, each {sites} sites x {STEPS} steps ({generic} sites "
          f"on K1's generic path) [{card}]")
    return launches


def check_build_refusal(card: str) -> None:
    """build_model refuses, on the card, a cloud larger than K56a's
    destination limit, and names the limit."""
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.ops.point_gather import MAX_DEST

    cfg = make_cfg(arch="HRNetPN", batch_size=PN_BATCH,
                   pn_num_points=MAX_DEST + 1)
    try:
        build_model(cfg, device="cuda")
    except ValueError as e:
        if "K56a" not in str(e) or str(MAX_DEST) not in str(e):
            raise AssertionError(f"build_model's refusal does not name "
                                 f"K56a's limit: {e}") from e
        print(f"build_model refuses pn_num_points={MAX_DEST + 1} on the "
              f"card: {e} [{card}]")
        return
    raise AssertionError(f"build_model took pn_num_points={MAX_DEST + 1} "
                         "on the card")


def point_wrappers() -> dict:
    """K2-K6's wrappers and the K56a/K56b ones under K5's and K6's
    backwards, by JSON entry in check_points' order, with the launches each
    makes in one HRNetPN train step."""
    from hcmoco_tpu_torch.ops import ball_query, fps, point_gather, three_nn

    return {"fps": (fps.fps_cuda, 3),
            "ball_query": (ball_query.ball_query_cuda, 8),
            "three_nn": (three_nn.three_nn_cuda, 4),
            "group_rows fwd": (point_gather.group_rows_cuda, 8),
            "group_rows bwd": (point_gather.group_rows_bwd_cuda, 8),
            "interpolate_rows fwd": (point_gather.interpolate_rows_cuda, 4),
            "interpolate_rows bwd": (point_gather.interpolate_rows_bwd_cuda,
                                     4),
            "dest_csr": (point_gather.dest_csr_cuda, 12),
            "segment_rows_sum": (point_gather.segment_rows_sum_cuda, 12)}


# (class, substrings of the lower-cased kernel name), first match wins
PN_CLASSES = (
    ("K2-K6 point kernels", ("fps_kernel", "ball_query_kernel",
                             "three_nn_kernel", "group_fwd", "interp_fwd",
                             "csr_", "segsum_")),
    ("cuDNN batch norm", ("batchnorm", "batch_norm", "welford")),
    ("bilinear upsample", ("upsample",)),
    ("cuDNN convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                           "dgrad", "sm90_", "nhwc")),
    ("cuBLAS gemm", ("gemm", "cutlass", "matmul")),
    ("sort, scan, search", ("sort", "scan", "search", "radix", "cub::")),
    ("index, gather, scatter", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("copies, casts, fills", ("copy", "memcpy", "memset", "fill")),
    ("elementwise arithmetic", ("mul", "add", "sub", "rsqrt", "div", "clamp",
                                "where", "threshold", "relu", "max", "min")),
)


def profile_steps(card: str, step, state, batch, gen, median_s: float,
                  n: int = 2) -> None:
    """Device kernel time of `n` more steps under torch.profiler, by kernel
    class and the top kernels, and its share of the median step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
    # kernels only: a user annotation's device row spans counted kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / 1e3 / n
    print(f"profile: device kernel time {total:.3f} ms/step, busy share "
          f"{total / (median_s * 1e3):.3f} of the median step [{card}]")
    classes, members = {}, {}
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        k = e.key.lower()
        cls = next((c for c, keys in PN_CLASSES
                    if any(t in k for t in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + e.self_device_time_total / 1e3
        members.setdefault(cls, []).append(e)
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  [class] {us / n:9.3f} ms/step  {cls}")
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:20]
    for e in top + [e for e in members.get("K2-K6 point kernels", [])
                    + members.get("other", [])[:5] if e not in top]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"{e.count // n:6d} calls/step  {e.key[:90]}")


def drive_pn(card: str) -> dict:
    """Stage-1 HRNetPN W18 320^2 bs64 train steps, 4096 points, through the
    user entry points (ConvBN fuse at its default, off); returns each point
    kernel's launches during the steps."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = make_cfg(arch="HRNetPN", batch_size=PN_BATCH)
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)  # drive_slice set it
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), PN_BATCH, size=cfg.crop_size,
        num_joints=16, n_data=N_DATA), dev)
    if not (0 < int(batch["use_depth"].sum()) < PN_BATCH):
        raise AssertionError("the batch must hold valid and zero clouds")
    wrappers = point_wrappers()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in wrappers.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()
                       if k.startswith("nce_loss") or k == "loss"})
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"HRNetPN step {i}: non-finite loss {l}")
    for name, (_, per_step) in wrappers.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{STEPS} steps, expected {per_step} x "
                                 f"{STEPS}")
    if not bool(torch.isfinite(state.banks).all()):
        raise AssertionError("non-finite bank rows")
    print("HRNetPN losses per step: "
          + ", ".join(f"{l['loss']:.5f}" for l in losses))
    print("HRNetPN step times (s): " + ", ".join(f"{t:.4f}" for t in times)
          + f"; first step includes warm-up [{card}]")
    steady = statistics.median(times[1:])
    print(f"HRNetPN W18 320^2 bs{PN_BATCH} 4096-point stage-1 step: median "
          f"{steady * 1e3:.2f} ms = {PN_BATCH / steady:.2f} samples/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} in {STEPS} steps [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
          "matmuls and cuDNN")

    from hcmoco_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")

    k1 = check_k1(card) + check_k1b(card)
    small_reference_check(card)
    for entry, launches in zip(k1, drive_slice(card).values()):
        entry["launches"] = launches
    points = check_points(card)
    small_reference_check(card, "HRNetPN")
    check_build_refusal(card)
    for entry, launches in zip(points, drive_pn(card).values()):
        entry["launches"] = launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: e[k] for k in keys} for e in k1 + points]
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "hcmoco_tpu"))
    if jax_mods:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{jax_mods[:10]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
