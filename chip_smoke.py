"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the main paths'
shapes, and drives the train steps the port has through its entry points:

  * HCMoCo (HRNet-W18 x2 + SemGCN, 320^2 crops, bank NCE with K=16384,
    bs32) with HCMOCO_CONVBN_FUSE=1, the path of kernels K1 (its fast path
    at the layer1 sites, its generic path at the 62 fuse-layer sites) and
    K1b;
  * HRNetPN (HRNet-W18 + PointNet++ MSG on 4096 depth points + SemGCN,
    320^2, K=16384, bs64), the path of kernels K2-K6, then two more of its
    steps under torch.profiler (device ms per kernel class);
  * stage 2 of both, and then the pre-training CLI (cli/main_contrast.py)
    in process from a tree of Kinect-size frames written from a seed:
    stage-1 HRNet bs32 fused for an epoch, its resume, stage 2 grafted
    with --pretrain, and HRNetPN bs64 from a pack through the native
    resample; each run's iteration times, host input rate, device busy
    share and peak memory.  The CLI runs' launches add to the kernels';
  * the versatility segmentor (the stage-2 HRNet-W18 model + an FCN head,
    RECIPES['versatility/sup_rgbd'], bs32, fused, K1 and K1b): a tiny
    step card vs CPU for supervise_type 0 and 3, five synthetic steps with
    a profile, cli/main_segmentor.py grafted from the CLI's stage-2
    checkpoint for an epoch of Kinect-size NTU and Parsing-4K frames with
    its validation, cli/transfer_ckpt.py's exports loaded into a bare
    HRNet-W18, and the row-gather NCE: its three formulations against each
    other at n_data 8192 and 262144, a stage-1 step at n_data 262144 with
    one profiled step, and --microbatch 2 steps (f32 plain, bf16 fused)
    equal bit for bit to their halves by hand.  Its two runs' launches
    add to K1's and K1b's;
  * the downstream stacks from stage 2's depth encoder as
    cli/transfer_ckpt.py exported it, fused: K1 and K1b against their
    plain versions at the trainers' row counts (566440 rows at the
    parsing model's layer1), then downstream/seg/train.py (HRNet-W18
    human parsing, 473^2, bs40, --pretrained) for an epoch of Kinect-size
    Parsing-4K frames with its validation and a --test_only pass with
    flip TTA, and downstream/a2j/train.py (A2J 3D pose, 288^2, bs12,
    --pretrained_pth) on an ITOP fixture with PCK@10cm before and after
    each epoch; each run's iteration times, device busy share, peak
    memory and K1/K1b launches, which add to the kernels';
  * data parallelism (parallel/mesh.py): the pre-training CLI under
    torchrun's environment for a world of one (NCCL, a rank-0 checkpoint
    and its resume; no NCCL kernel in its profile), and two ranks on the
    one card over gloo (`chip_smoke.py --dp-rank`, NCCL refusing two
    ranks on one device) against one process: HRNet-W18 stage 1 at
    320^2 bs32 fused (K1 and K1b on each rank's rows, K1's sums
    all-reduced), stage 2 and HRNetPN (K2-K6) at bs16 in f32; the ranks
    equal bit for bit after every step, the collectives a step and their
    host time.  Both ranks' launches add to the kernels'.

    python3 chip_smoke.py

Needs CUDA; raises without it.  Every phase raises on failure, so the exit
code is non-zero unless all of them passed.  The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and the line before it a JSON object with each kernel's launches on its
main path, its error against the plain version, its time, the plain
version's, the least time the card could take for the same work (`bound_ms`,
from this run's shapes and data and the H100 SXM's published peaks) and,
where one PyTorch call computes the same function, that call's time.
TF32 is off for matmuls and cuDNN convs: f32 means f32 here, but for the
downstream trainers' runs, which take torch's default, as their CLIs do
(cuDNN's f32 convs in TF32).  Nothing of
JAX or of the JAX package (hcmoco_tpu) is imported; the script checks that
before it prints its last line.
"""

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# K1b's (R, C, site[, N]): the layer1 shapes of a W18 bs32 step and a
# ragged R
K1B_SHAPES = ((204800, 256, "layer1 conv3/downsample"),
              (204800, 64, "layer1 conv1"),
              (12800 + 37, 18, "ragged R, C=18"))
# one of two ranks' rows of the W18 bs32 step, normalised by the global
# batch's N: layer1, and the 40x40 branch of a stage-2 fuse (36 -> 36)
K1B_DP_SHAPES = ((102400, 256, "layer1 conv3/downsample, rank rows",
                  204800),
                 (102400, 64, "layer1 conv1, rank rows", 204800),
                 (25600, 36, "40x40 branch, rank rows", 51200))


def check_k1b(card: str, shapes=K1B_SHAPES, clamp: bool = True) -> list:
    """K1b (bn_apply_stats forward and backward, K1's dyt prologue) against
    the plain versions on the same inputs, at `shapes` (by default the
    layer1 shapes and a ragged R with C=18; the JSON entries time the
    first).  A shape with a fourth entry N takes the data-parallel split:
    s1 and s2 sum N rows (the global batch's), y is the first R of them
    (a rank's), and forward and backward normalise by N, the kernel and
    the plain version alike.  Channel 0 of y is constant, so the var >= 0
    clamp binds there (with `clamp`, required; without, only where the
    plain version's var is 0: s2 rcp(R) - (s1 rcp(R))^2, PyTorch's CUDA
    division by a scalar as the kernel computes it, may round to one
    positive ulp, as at R = 62208, and then var is held to the plain
    version's like the others).  Tolerances: out, dy, dyt within 1 bf16 ulp; mean, var within 1
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
    for r, c, site, *split in shapes:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)

        n = split[0] if split else None
        yg = (rnd(n or r, c) * 1.3 + 0.2).bfloat16()
        yg[:, 0] = 0.5
        ygf = yg.float()
        s1, s2 = ygf.sum(0), (ygf * ygf).sum(0)
        y, yf = yg[:r], ygf[:r]
        scale = torch.rand((c,), generator=g, device=dev) + 0.5
        bias = rnd(c)
        rm0, rv0 = rnd(c), rnd(c).abs() + 0.5

        def running():
            return (rm0.clone(), rv0.clone(),
                    torch.zeros((), dtype=torch.int64, device=dev), 0.01)

        run_k, run_p = running(), running()
        out, mean, var, rstd = mb.bn_apply_fwd_cuda(y, s1, s2, scale, bias,
                                                    1e-5, run_k, n)
        pout, pmean, pvar, prstd = mb.bn_apply_fwd_plain(y, s1, s2, scale,
                                                         bias, 1e-5, run_p, n)
        binds = float(pvar[0]) == 0.0
        if (clamp or binds) and not (binds and float(var[0]) == 0.0):
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
        args = (dout, y, s1, pmean, pvar, prstd, scale, dm, dv, n)
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
        rs, sc, rf = prstd.double(), scale.double(), float(n or r)
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
        if binds and float(got[3][0]) != 0.0:
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
            (lambda: mb.bn_apply_fwd_cuda(*fwd_args, run_k, n),
             lambda: mb.bn_apply_fwd_plain(*fwd_args, run_p, n)),
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
        print(f"K1b R={r} C={c}" + (f" N={n}" if n else "")
              + f" ({site}): fwd {times[0][0]:.4f} ms (plain "
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


def check_pts2depth(card: str, batch_size: int = 8,
                    main_batch: int = PN_BATCH) -> None:
    """K4, K6 and K6's backward (K56a + K56b) at pts2depth's call (every
    pixel of the 320^2 crop against the 4096 sampled points, f32 features
    of width 128; hcmoco_tpu/models/pointnet2_model.py:414), the stage-2
    HRNetPN path.  At bs8 with zero clouds: K4 equal to its plain version
    (and its scan), K6's forward equal to its plain version, K56a's index
    equal, K6's backward bit for bit equal to the plain version on the CPU
    and over two launches.  At the main path's bs64, whose f32 maps pass
    2^31 bytes: K4, K6 fwd and K56a equal again, K6 bwd's rows of the
    last valid and the last zero cloud equal to the CPU's, and the times
    of K4, K6 fwd, K6 bwd, K56a and K56b beside the plain
    versions' and their bounds; K6 bwd and K56b also on the valid and the
    zero-cloud samples apart (a zero cloud sends all of its 307200 sources
    to rows 0, 1 and 2: three buckets of 102400, K56b's long path)."""
    from hcmoco_tpu_torch.ops import point_gather as pg
    from hcmoco_tpu_torch.ops import three_nn as tn
    from hcmoco_tpu_torch.ops.point_ops import interpolation_weights

    c = 128
    g = torch.Generator(device="cuda").manual_seed(9)
    cloud, all_pts, valid = depth_clouds("cuda", batch_size, 320, 4096)
    b, n, m = batch_size, all_pts.shape[1], cloud.shape[1]
    dist, idx = check_three_nn("pts2depth", all_pts, cloud, ~valid)
    print_k4_scan("pts2depth", k4_scan(all_pts, cloud, dist, idx, valid),
                  card)
    w = interpolation_weights(dist)
    feat = torch.randn((b, m, c), generator=g, device="cuda")
    gout = torch.randn((b, n, c), generator=g, device="cuda")
    out = pg.interpolate_rows_cuda(feat, idx, w)
    if not torch.equal(out, pg.interpolate_rows_plain(feat, idx, w)):
        raise AssertionError("K6 interpolate fwd at pts2depth: not exact")
    zero_rows = out[~valid]
    if not torch.allclose(zero_rows, feat[~valid][:, :3].mean(1, keepdim=True)
                          .expand_as(zero_rows), rtol=1e-5, atol=1e-6):
        raise AssertionError("K6 at pts2depth: a zero cloud's pixels are "
                             "not the mean of its points 0-2")
    del out, zero_rows
    check_csr("K6 pts2depth", idx.view(b, n * 3), m)
    scatter_exact("K6 interpolate bwd pts2depth",
                  lambda: pg.interpolate_rows_bwd_cuda(gout, idx, w, m),
                  pg.interpolate_rows_bwd_plain(gout.cpu(), idx.cpu(),
                                                w.cpu(), m))
    print(f"K4, K6 fwd and K6 bwd at pts2depth ({b},{n}<-{m}, f32, C {c}):"
          f" equal to the plain versions, K6 bwd to the CPU's bit for bit "
          f"and over two launches; {int((~valid).sum())} zero clouds "
          f"[{card}]")
    del feat, gout, dist, idx, w

    # the main path's batch: times
    b = main_batch
    cloud, all_pts, valid = depth_clouds("cuda", b, 320, 4096)
    dist, idx = check_three_nn("pts2depth bs64", all_pts, cloud, ~valid)
    w = interpolation_weights(dist)
    feat = torch.randn((b, m, c), generator=g, device="cuda")
    gout = torch.randn((b, n, c), generator=g, device="cuda")
    # past 2^31 bytes: K6 fwd equal to the plain version on the card, K56a's
    # index equal, K6 bwd's rows of the last valid and the last zero cloud
    # (offsets above 2^31 bytes in gout and the grad) equal to the CPU's
    if not torch.equal(pg.interpolate_rows_cuda(feat, idx, w),
                       pg.interpolate_rows_plain(feat, idx, w)):
        raise AssertionError("K6 interpolate fwd at pts2depth bs64: not "
                             "exact")
    check_csr("K6 pts2depth bs64", idx.view(b, n * 3), m)
    grad = pg.interpolate_rows_bwd_cuda(gout, idx, w, m)
    for sel in (valid, ~valid):
        k = int(torch.nonzero(sel)[-1])
        want = pg.interpolate_rows_bwd_plain(gout[k:k + 1].cpu(),
                                             idx[k:k + 1].cpu(),
                                             w[k:k + 1].cpu(), m)
        if not torch.equal(grad[k:k + 1].cpu(), want):
            raise AssertionError(f"K6 interpolate bwd at pts2depth bs64, "
                                 f"sample {k}: differs from the CPU's")
        print(f"K6 fwd and bwd at pts2depth bs64: sample {k} "
              f"({'valid' if bool(valid[k]) else 'zero'} cloud, gout from "
              f"byte {k * n * c * 4}) equal to the plain versions [{card}]")
    del grad
    small = b * n * 24  # idx and weights, or dist and idx
    rows, big = b * n * 3, b * n * c * 4
    k4 = (cuda_ms(lambda: tn.three_nn_cuda(all_pts, cloud), iters=5),
          cuda_ms(lambda: tn.three_nn_plain(all_pts, cloud), iters=1,
                  warmup=1),
          bound(b * (n + m) * 12 + small, 0, F32_OPS_S))
    fwd = (cuda_ms(lambda: pg.interpolate_rows_cuda(feat, idx, w), iters=5),
           cuda_ms(lambda: pg.interpolate_rows_plain(feat, idx, w), iters=2,
                   warmup=1),
           bound(b * m * c * 4 + small + big, 5 * b * n * c, F32_OPS_S))
    bwd = (cuda_ms(lambda: pg.interpolate_rows_bwd_cuda(gout, idx, w, m),
                   iters=5),
           cuda_ms(lambda: pg.interpolate_rows_bwd_plain(gout, idx, w, m),
                   iters=2, warmup=1),
           bound(big + small + b * m * c * 4, 6 * b * n * c, F32_OPS_S))
    idx2 = idx.view(b, n * 3)
    start, src = pg.dest_csr_cuda(idx2, m)
    # K56b's buckets: more than 192 sources take its long path, one warp a
    # 32-channel slice summing them in order
    size = (start[:, 1:] - start[:, :-1]).long()
    for label, sel in (("valid", valid), ("zero-cloud", ~valid)):
        sz = size[sel]
        long = sz > 192
        print(f"  K56b buckets at pts2depth, {label} samples: "
              f"{float(long.sum(1).float().mean()):.1f} long buckets a "
              f"sample, largest {int(sz.max())} sources, "
              f"{float((sz * long).sum() / sz.sum()):.4f} of the sources "
              f"on the long path [{card}]")
    csr = (cuda_ms(lambda: pg.dest_csr_cuda(idx2, m), iters=5),
           cuda_ms(lambda: pg.dest_csr_plain(idx2, m), iters=2, warmup=1),
           bound(rows * 8 + b * (m + 1) * 4, 0, F32_OPS_S))
    seg = (cuda_ms(lambda: pg.segment_rows_sum_cuda(gout, start, src, m, w),
                   iters=5), None,
           bound(big + rows * 8 + b * (m + 1) * 4 + b * m * c * 4,
                 2 * rows * c, F32_OPS_S))
    for name, (ms, plain, bnd) in (("K4 three-NN", k4), ("K6 fwd", fwd),
                                   ("K6 bwd", bwd), ("  K56a", csr),
                                   ("  K56b", seg)):
        plain_s = "not timed" if plain is None else f"{plain:.4f} ms"
        print(f"{name} at pts2depth ({b},{n}<-{m}, f32, C {c}): kernel "
              f"{ms:.4f} ms, plain {plain_s}, bound {bnd['bound_ms']:.4f} "
              f"ms ({bnd['bound_by']}) [{card}]")
    for label, sel in (("valid", valid), ("zero-cloud", ~valid)):
        gs, ii, ww = (x[sel].contiguous() for x in (gout, idx, w))
        t = cuda_ms(lambda: pg.interpolate_rows_bwd_cuda(gs, ii, ww, m),
                    iters=5)
        st, sr = pg.dest_csr_cuda(ii.view(-1, n * 3), m)
        t_seg = cuda_ms(lambda: pg.segment_rows_sum_cuda(gs, st, sr, m, ww),
                        iters=5)
        k = int(sel.sum())
        print(f"  K6 bwd at pts2depth on the {k} {label} samples alone: "
              f"{t:.4f} ms ({t / k:.5f} ms a sample), K56b {t_seg:.4f} ms "
              f"({t_seg / k:.5f} ms a sample) [{card}]")


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
              "depth_mask", "grid_xy", "depth_mean", "pts_u", "joints2d",
              "joints_vis", "pix_idx", "label", "true_label", "neg_idx")
STAGE2_RECIPES = {"HRNet": "second_stage/ntumpiirgbd2s_hrnet_w18",
                  "HRNetPN": "second_stage/ntumpiirgbd2s_hrnetpn_w18"}


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS
            if k in batch}


def timed_steps(step, state, batch, gen, n: int, label: str,
                card: str, times: list = None) -> tuple:
    """n train steps, each timed on the host clock up to a synchronize;
    returns (median of steps 2..n in s, the metrics of each step as
    floats), and appends each step's seconds to `times` if given.  Raises
    on a non-finite metric or bank row."""
    times = [] if times is None else times
    metrics = []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    for i, mm in enumerate(metrics):
        if not all(np.isfinite(v) for v in mm.values()):
            raise AssertionError(f"{label} step {i}: non-finite metric {mm}")
    if not bool(torch.isfinite(state.banks).all()):
        raise AssertionError(f"{label}: non-finite bank rows")
    print(f"{label} step times (s): " + ", ".join(f"{t:.4f}" for t in times)
          + f"; first step includes warm-up [{card}]")
    return statistics.median(times[1:]), metrics


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
    steady, metrics = timed_steps(step, state, batch, gen, STEPS,
                                  "stage-1 HRNet", card)
    launches = {name: fn.launches for name, fn in wrappers.items()}
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
    print("losses per step: " + ", ".join(f"{m['loss']:.5f}"
                                          for m in metrics))
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
    ("upsample (bilinear, nearest)", ("upsample",)),
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


def device_rows(prof) -> list:
    """(name, device us) of every kernel, copy and fill that a finished
    torch.profiler run saw on the card, user annotations left out; read
    from the raw trace events, which takes a fraction of a second where
    key_averages() takes seconds a profiled step."""
    from torch.autograd import DeviceType

    rows = [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and e.duration_ns() > 0]
    if not rows:
        raise AssertionError("the profiler saw no device time")
    return rows


def profile_steps(card: str, step, state, batch, gen, median_s: float,
                  n: int = 2) -> tuple:
    """Device kernel time of `n` more steps under torch.profiler, by kernel
    class and the top kernels, and its share of the median step; returns
    (device ms a step, busy share)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
    by_name = {}  # name -> [device us, calls]
    for name, us in device_rows(prof):
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    names = sorted(by_name, key=lambda k: -by_name[k][0])
    total = sum(us for us, _ in by_name.values()) / 1e3 / n
    print(f"profile: device kernel time {total:.3f} ms/step, busy share "
          f"{total / (median_s * 1e3):.3f} of the median step [{card}]")
    classes, members = {}, {}
    for name in names:
        k = name.lower()
        cls = next((c for c, keys in PN_CLASSES
                    if any(t in k for t in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + by_name[name][0] / 1e3
        members.setdefault(cls, []).append(name)
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  [class] {ms / n:9.3f} ms/step  {cls}")
    top = names[:20]
    for name in top + [k for k in members.get("K2-K6 point kernels", [])
                       + members.get("other", [])[:5] if k not in top]:
        us, calls = by_name[name]
        print(f"  {us / 1e3 / n:9.3f} ms/step {calls // n:6d} calls/step  "
              f"{name[:90]}")
    return total, total / (median_s * 1e3)


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
    steady, metrics = timed_steps(step, state, batch, gen, STEPS,
                                  "stage-1 HRNetPN", card)
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    for name, (_, per_step) in wrappers.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{STEPS} steps, expected {per_step} x "
                                 f"{STEPS}")
    print("HRNetPN losses per step: "
          + ", ".join(f"{m['loss']:.5f}" for m in metrics))
    print(f"HRNetPN W18 320^2 bs{PN_BATCH} 4096-point stage-1 step: median "
          f"{steady * 1e3:.2f} ms = {PN_BATCH / steady:.2f} samples/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} in {STEPS} steps [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    return launches


def pinned_pixels(depth_mask: np.ndarray, n: int,
                  rng: np.random.Generator) -> np.ndarray:
    """(B, n) soft-Pri3D pixel draws of a stride-4 map: uniform over the
    valid pixels of the half-pixel-centre /4 mask, or over all pixels of
    an image with none."""
    small = depth_mask[:, 2::4, 2::4].reshape(depth_mask.shape[0], -1)
    out = np.zeros((depth_mask.shape[0], n), np.int64)
    for b, row in enumerate(small):
        cand = np.nonzero(row)[0]
        out[b] = rng.choice(cand if cand.size else np.arange(row.size), n)
    return out


def small_stage2_check(card: str, arch: str) -> None:
    """One tiny f32 stage-2 step (width 4, 32^2, 16 soft-Pri3D pixels an
    image pinned; HRNetPN: 64 points, zero clouds in the batch) on the
    card against the same step on the CPU (held against the JAX package by
    tests/test_torch_stage2_step.py).  HRNet: losses, banks and params
    within rel 1e-4 (losses) and rtol 1e-4, atol 1e-5, accuracies within
    0.05.  HRNetPN: the 64-point encoder is f32-ill-conditioned and its
    per-pixel features feed the dense losses, so the CPU step runs its
    point branch (encoder2, encoder2_linear) in float64: the losses and
    banks the depth map does not feed within rel 1e-4, those it feeds
    within rtol 1e-2, atol 1e-3 (tests/test_torch_stage2_step.py F32_TOL),
    parameters outside the point branch within rtol 1e-3, atol 5e-4, the
    point branch's finite and moved."""
    from hcmoco_tpu_torch.contrast.memory import sample_negative_counts
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cfg = make_cfg(method="CMCJointsPri3DRGBD2S", arch=arch, width=4,
                   crop_size=32, batch_size=6, nce_k=15,
                   compute_dtype="float32", pn_num_points=64,
                   linear_feat_map=True, pri3d_num_samples_per_image=16)
    rng = np.random.default_rng(4)
    batch = synthetic_contrast_batch(rng, 6, size=32, n_data=64)
    if arch == "HRNet":  # see small_reference_check
        batch["rgbd"] = (rng.standard_normal((6, 32, 32, 6)) * 0.5).astype(
            np.float32)
    else:
        batch["pts_u"] = rng.random((6, 64), dtype=np.float32)
        if not 0 < int(batch["use_depth"].sum()) < 6:
            raise AssertionError("the batch must hold valid and zero clouds")
    batch["pix_idx"] = pinned_pixels(batch["depth_mask"], 16, rng)
    counts = sample_negative_counts(torch.Generator().manual_seed(2), 6, 64,
                                    15)
    torch.manual_seed(0)
    model = set_convbn_fuse(build_model(cfg, device="cpu"), False)
    banks = None
    res = []
    for run in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(run)
        if not res and arch == "HRNetPN":  # the CPU reference
            for mod in (m.encoder2, m.encoder2_linear):
                mod.double()
                for sub in mod.modules():
                    if hasattr(sub, "compute_dtype"):
                        sub.compute_dtype = torch.float64
        st = create_train_state(cfg, m, torch.Generator(run).manual_seed(3),
                                n_data=64, steps_per_epoch=10)
        if banks is None:
            banks = st.banks.clone()
        st.banks = banks.to(run, copy=True)
        b = to_device(batch, run)
        b["counts"] = counts.to(run)
        step = make_contrast_train_step(cfg, m, steps_per_epoch=10)
        metrics = {k: float(v) for k, v in step(st, b).items()
                   if k != "learning_rate"}
        res.append((metrics, {k: v.cpu() for k, v in m.state_dict().items()},
                    st.banks.cpu()))
    (ref, sd_ref, b_ref), (got, sd_got, b_got) = res
    rgb_only = ("nce_loss_12", "nce_loss_13", "nce_loss_31",
                "loss_rgb2joint", "acc_rgb2joint")
    f32_tol = dict(rtol=1e-2, atol=1e-3)
    for k, want in ref.items():
        if k.startswith("acc") or k.startswith("nce_acc"):
            tol = dict(rtol=0.0, atol=0.05)
        elif arch == "HRNetPN" and k not in rgb_only:
            tol = f32_tol
        else:
            tol = dict(rtol=1e-4, atol=0.0)
        if not np.isfinite(got[k]) or not (
                abs(got[k] - want) <= tol["atol"] + tol["rtol"] * abs(want)):
            raise AssertionError(f"tiny stage-2 step {k}: card {got[k]} vs "
                                 f"cpu {want}")
    for i in range(b_ref.shape[0]):
        torch.testing.assert_close(
            b_got[i], b_ref[i],
            **(f32_tol if arch == "HRNetPN" and i == 1 else
               dict(rtol=1e-4, atol=1e-5)),
            msg=lambda msg, i=i: f"tiny stage-2 step bank {i + 1}: {msg}")
    start = model.state_dict()
    for k, want in sd_ref.items():
        if not want.is_floating_point():
            continue
        if arch == "HRNetPN" and k.startswith("encoder2"):
            # the point branch: encoder2 and encoder2_linear
            if not bool(torch.isfinite(sd_got[k]).all()):
                raise AssertionError(f"tiny stage-2 step {k}: non-finite")
            if "running" not in k and torch.equal(sd_got[k], start[k]):
                raise AssertionError(f"tiny stage-2 step {k}: did not move")
            continue
        tol = (dict(rtol=1e-3, atol=5e-4) if arch == "HRNetPN" else
               dict(rtol=1e-4, atol=1e-5))
        torch.testing.assert_close(sd_got[k], want.to(sd_got[k].dtype),
                                   **tol,
                                   msg=lambda msg, k=k: f"tiny stage-2 step "
                                   f"{k}: {msg}")
    print(f"tiny f32 {arch} stage-2 step, card vs cpu"
          f"{' (point branch in float64)' if arch == 'HRNetPN' else ''}: "
          + ", ".join(f"{k} {got[k]:.6f}/{ref[k]:.6f}" for k in
                      ("loss", "loss_rgb2depth", "loss_d2joint", "loss_scl"))
          + f", params and banks within tolerance [{card}]")


def drive_stage2(card: str, arch: str) -> dict:
    """Stage-2 train steps (mem='bank+jointspri3d') of the reference's
    second-stage recipe for `arch` through the user entry points: HRNet-W18
    at bs32 with HCMOCO_CONVBN_FUSE=1 (K1, K1b), or HRNetPN at bs64 with
    4096 points (K2-K6, K56a/K56b, and pts2depth's K4, K6 and K6 bwd).
    320^2, K=16384, 400 soft-Pri3D pixels an image drawn by the step, T =
    0.07.  Prints every stage-2 metric a step, the median step, samples/s,
    peak memory and a profile; returns each kernel wrapper's launches in
    the steps, in the order of its JSON entries, after checking them
    against the expected count a step."""
    from hcmoco_tpu_torch.core.config import RECIPES
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.ops import matmul_bn as mb
    from hcmoco_tpu_torch.train.contrast_step import (STAGE2_METRICS,
                                                      make_contrast_train_step)
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    bsz = BATCH if arch == "HRNet" else PN_BATCH
    cfg = dataclasses.replace(RECIPES[STAGE2_RECIPES[arch]], batch_size=bsz)
    if arch == "HRNet":
        os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    else:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), bsz, size=cfg.crop_size, num_joints=16,
        n_data=N_DATA), dev)
    if not 0 < int(batch["use_depth"].sum()) < bsz:
        raise AssertionError("the batch must hold samples with and without "
                             "depth")
    if arch == "HRNet":
        sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
        generic = generic_sites(model.encoder1) + generic_sites(
            model.encoder2)
        wrappers = {name: (fn, sites) for name, fn in k1_wrappers().items()}
        mb.mm_bn_stats_cuda.generic_launches = 0
    else:
        # stage 1's launches a step, and pts2depth's K4, K6 fwd and K6 bwd
        # (one K56a and one K56b) once more
        extra = {"three_nn": 1, "interpolate_rows fwd": 1,
                 "interpolate_rows bwd": 1, "dest_csr": 1,
                 "segment_rows_sum": 1}
        wrappers = {name: (fn, n + extra.get(name, 0))
                    for name, (fn, n) in point_wrappers().items()}
    label = f"stage-2 {arch}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in wrappers.values():
        fn.launches = 0
    steady, metrics = timed_steps(step, state, batch, gen, STEPS, label,
                                  card)
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, (_, per_step) in wrappers.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{label}: {name} launched {launches[name]}"
                                 f" times in {STEPS} steps, expected "
                                 f"{per_step} x {STEPS}")
    if arch == "HRNet":
        n_gen = mb.mm_bn_stats_cuda.generic_launches
        if n_gen != generic * STEPS:
            raise AssertionError(f"{label}: K1's generic path launched "
                                 f"{n_gen} times, expected {generic} x "
                                 f"{STEPS}")
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic": n_gen, **launches}
    for i, m in enumerate(metrics):
        print(f"{label} step {i}: " + ", ".join(
            f"{k} {m[k]:.5f}" for k in ("loss",) + STAGE2_METRICS))
    print(f"{label} W{cfg.width} {cfg.crop_size}^2 bs{bsz} K={cfg.nce_k} "
          f"{cfg.pri3d_num_samples_per_image} pixels/image step: median "
          f"{steady * 1e3:.2f} ms = {bsz / steady:.2f} samples/s; peak memory"
          f" {peak:.2f} GiB; launches {launches} in {STEPS} steps [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    del model, state, step, batch
    torch.cuda.empty_cache()
    return launches


CLI_FRAMES = 512   # NTU frames of the CLI phase's tree
CLI_MPII = 64      # MPII images of it
KINECT_HW = (424, 512)


def cli_input_rate(argv: list, batches: int = 10) -> float:
    """Samples/s that the CLI's DataSource alone delivers over `batches`
    batches after its first, with the card idle."""
    from hcmoco_tpu_torch.cli.main_contrast import (build_argparser,
                                                    config_from_args)
    from hcmoco_tpu_torch.data.pipeline import build_contrast_source

    cfg = config_from_args(build_argparser().parse_args(argv))
    source, _, _ = build_contrast_source(cfg)
    t0 = time.perf_counter()
    it = iter(source)
    try:
        next(it)
        t1 = time.perf_counter()
        for _ in range(batches):
            next(it)
        t2 = time.perf_counter()
        print(f"DataSource alone, bs{cfg.batch_size}: first batch "
              f"{t1 - t0:.2f} s, then {batches} in {t2 - t1:.2f} s")
        return batches * cfg.batch_size / (t2 - t1)
    finally:
        it.close()


def cli_run(card: str, label: str, argv: list, bsz: int, n: int,
            wrappers: dict, on_ready=None, input_rate: float = None,
            main=None):
    """main(argv) (cli/main_contrast.py's unless `main` is another CLI's
    with its signature and result), which runs `n` steps, on the card with
    every count of `wrappers` ({name: (fn, launches a step, or None:
    checked by the caller)}) and K1's generic-path count set to 0 just
    before it; torch.profiler records the run's last two steps.
    Prints the iteration's median and quartiles over the steps before the
    profiler's (the first step, a warm-up, left out), samples/s, the host
    input rate, the device busy share and the peak memory; returns
    (result, launches by name), after checking
    the launches against the expected count a step and that the epoch's
    loss is finite and its checkpoint written."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if main is None:
        from hcmoco_tpu_torch.cli.main_contrast import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in wrappers.values():
        fn.launches = 0
    mm_bn_stats_cuda = k1_wrappers()["mm_bn_stats"]
    mm_bn_stats_cuda.generic_launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=n - 3, warmup=1, active=2,
                                   repeat=1)) as prof:
        r = main(argv, on_ready=on_ready, on_step=lambda _: prof.step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    if "mm_bn_stats" in launches:
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic": mm_bn_stats_cuda.generic_launches,
                    **launches}
    steps = len(r.step_s)
    if steps != n:
        raise AssertionError(f"{label}: ran {steps} steps, expected {n}")
    for name, (_, per_step) in wrappers.items():
        if per_step is not None and launches[name] != per_step * steps:
            raise AssertionError(f"{label}: {name} launched {launches[name]}"
                                 f" times in {steps} steps, expected "
                                 f"{per_step} x {steps}")
    with open(os.path.join(r.ckpt_dir, "metrics.tsv")) as f:
        head, *epochs = [line.split("\t") for line in f.read().splitlines()]
    loss = float(epochs[-1][head.index("loss")])
    ckpt = os.path.join(r.ckpt_dir, f"epoch_{r.last_epoch}.pt")
    if not (np.isfinite(loss) and os.path.exists(ckpt)):
        raise AssertionError(f"{label}: epoch {r.last_epoch} loss {loss}, "
                             f"checkpoint {ckpt} exists: "
                             f"{os.path.exists(ckpt)}")
    if not bool(torch.isfinite(r.state.banks).all()):
        raise AssertionError(f"{label}: non-finite bank rows")

    rows = device_rows(prof)
    kernel_ms = sum(us for name, us in rows
                    if not name.startswith(("Memcpy", "Memset"))) / 1e3 / 2
    h2d_ms = sum(us for name, us in rows
                 if name.startswith("Memcpy") and "HtoD" in name) / 1e3 / 2
    it_s = [a + b + c for a, b, c in zip(r.wait_s, r.upload_s, r.step_s)]
    free = slice(1, n - 3)  # after the warm-up, before the profiler's steps
    q1, med, q3 = statistics.quantiles(it_s[free], n=4)
    step_med = statistics.median(r.step_s[free])
    print(f"{label}: {steps} steps, epochs {r.start_epoch}-{r.last_epoch}, "
          f"loss {loss:.5f} (epoch mean), checkpoint {ckpt}")
    print(f"{label}: iteration median {med * 1e3:.2f} ms (quartiles "
          f"{q1 * 1e3:.2f}, {q3 * 1e3:.2f}; steps 2-{n - 3}) = "
          f"{bsz / med:.2f} samples/s; medians of its parts: data wait "
          f"{statistics.median(r.wait_s[free]) * 1e3:.2f} ms, pin + upload "
          f"enqueue {statistics.median(r.upload_s[free]) * 1e3:.2f} ms, step "
          f"{step_med * 1e3:.2f} ms; host input rate {input_rate:.2f} "
          f"samples/s (DataSource alone, 10 batches) against the step's "
          f"{bsz / step_med:.2f}; device kernel time {kernel_ms:.3f} "
          f"ms/step, busy share {kernel_ms / (med * 1e3):.3f}; H2D copies "
          f"{h2d_ms:.3f} ms/step; peak memory {peak:.2f} GiB [{card}]")
    print(f"{label}: launches {launches} in {steps} steps; wall time: main "
          f"{t1 - t0:.1f} s, profile read {time.perf_counter() - t1:.1f} s "
          f"[{card}]")
    return r, launches


NCCL_CLI_STEPS = 4


def nccl_cli(card: str, argv: list, save: str) -> list:
    """cli/main_contrast.py under torchrun's environment for a world of
    one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT set here;
    no torchrun binary): it joins an NCCL process group, trains
    NCCL_CLI_STEPS steps and saves as rank 0, then a second run resumes
    from that checkpoint for NCCL_CLI_STEPS more.  In a world of one the
    port issues no collective, so the profiler (over the resumed run's
    steps) must show no NCCL kernel.  Returns both runs' K1/K1b
    launches."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.cli.main_contrast import main
    from hcmoco_tpu_torch.models.hrnet import fused_sites

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    seen = {}

    def on_ready(state):
        seen["backend"] = dist.get_backend()
        seen["world"] = dist.get_world_size()
        seen["step"] = state.step

    wrappers = k1_wrappers()
    runs = []
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        for i, extra in enumerate((
                ["--epochs", "1", "--max_steps", str(NCCL_CLI_STEPS)],
                ["--epochs", "2", "--resume", "auto", "--max_steps",
                 str(2 * NCCL_CLI_STEPS)])):
            for fn in wrappers.values():
                fn.launches = 0
            wrappers["mm_bn_stats"].generic_launches = 0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                r = main(argv + ["--model_path", save] + extra,
                         on_ready=on_ready)
                torch.cuda.synchronize()
            if seen != {"backend": "nccl", "world": 1,
                        "step": i * NCCL_CLI_STEPS}:
                raise AssertionError(f"NCCL CLI run {i}: {seen}")
            if dist.is_initialized():
                raise AssertionError("the CLI left its process group")
            steps = len(r.step_s)
            model = r.state.model
            sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
            gen = generic_sites(model.encoder1) + generic_sites(
                model.encoder2)
            launches = {name: fn.launches for name, fn in wrappers.items()}
            launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                        "mm_bn_stats generic":
                            wrappers["mm_bn_stats"].generic_launches,
                        **launches}
            want = {name: (gen if name.endswith("generic") else sites)
                    * steps for name in launches}
            if steps != NCCL_CLI_STEPS or launches != want:
                raise AssertionError(f"NCCL CLI run {i}: {steps} steps, "
                                     f"launches {launches}, expected {want}")
            nccl = [(n, us) for n, us in device_rows(prof)
                    if "nccl" in n.lower()]
            if nccl:
                raise AssertionError(f"NCCL CLI run {i}: NCCL kernels in a "
                                     f"world of one: {nccl[:5]}")
            runs.append(launches)
            print(f"NCCL CLI run {i}: world 1 over nccl, epochs "
                  f"{r.start_epoch}-{r.last_epoch}, {steps} steps from step "
                  f"{i * NCCL_CLI_STEPS}, checkpoint "
                  f"epoch_{r.last_epoch}.pt written by rank 0; 0 NCCL "
                  f"kernels in its profile (no collective in a world of "
                  f"one) [{card}]")
            del r
    finally:
        for k in env:
            os.environ.pop(k, None)
    print(f"NCCL CLI runs (start, resume) wall time "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return runs


def drive_cli(card: str, stage2_copy: str) -> tuple:
    """The pre-training CLI (cli/main_contrast.py) in process on the card,
    from frames on disk: an NTU tree of CLI_FRAMES Kinect-size frames and
    an MPII tree of CLI_MPII images, written from a seed into a temporary
    directory under build/ and deleted at the end.  Stage 1 HRNet-W18 bs32
    fused for an epoch, its resume for a second (the restored step, banks
    and a weight equal to what was saved), stage 2 grafted from it with
    --pretrain, and HRNetPN bs64 from a pack of the NTU tree through the
    native resample.  Returns the K1/K1b launches of the three HRNet runs
    and the point kernels' of the HRNetPN run; copies the stage-2 run's
    checkpoint to `stage2_copy` (the versatility phase grafts from it)."""
    from hcmoco_tpu_torch.data.fixtures import (make_mpii_fixture,
                                                make_ntu_fixture)
    from hcmoco_tpu_torch.data.packed import pack_ntu
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.native import library_route, resample_lib

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_cli_", dir=build)
    try:
        t0 = time.perf_counter()
        ntu, ntu_list = make_ntu_fixture(os.path.join(tmp, "ntu"),
                                         n_frames=CLI_FRAMES, seed=0,
                                         h=KINECT_HW[0], w=KINECT_HW[1])
        mpii = make_mpii_fixture(os.path.join(tmp, "mpii"),
                                 n_images=CLI_MPII, seed=1, h=KINECT_HW[0],
                                 w=KINECT_HW[1])
        t1 = time.perf_counter()
        if resample_lib() is None:
            raise AssertionError("the native resample library did not build")
        t2 = time.perf_counter()
        pack = os.path.join(tmp, "pack")
        meta = pack_ntu(ntu, ntu_list, pack)
        print(f"CLI tree: {CLI_FRAMES} NTU frames and {CLI_MPII} MPII images "
              f"at {KINECT_HW[0]}x{KINECT_HW[1]} written in {t1 - t0:.2f} s; "
              f"native resample built and loaded in {t2 - t1:.2f} s; packed "
              f"{meta['n']} frames in {time.perf_counter() - t2:.2f} s")
        files = ["--data_folder", ntu, "--train_file_list", ntu_list,
                 "--mpii_root", mpii, "--model_path",
                 os.path.join(tmp, "save"), "--seed", "0", "--print_freq",
                 "6"]
        steps1 = (CLI_FRAMES + CLI_MPII) // BATCH

        os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
        k1 = {name: (fn, None) for name, fn in k1_wrappers().items()}

        def check_k1(launches: dict, r, n: int, label: str) -> None:
            """K1 and K1b once a fused site and step, K1's generic path
            once a generic site and step."""
            model = r.state.model
            sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
            gen = (generic_sites(model.encoder1)
                   + generic_sites(model.encoder2))
            want = {name: (gen if name.endswith("generic") else sites) * n
                    for name in launches}
            if launches != want:
                raise AssertionError(f"{label}: launches {launches}, "
                                     f"expected {want}")

        restored = {}
        s1 = ["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18",
              "--batch_size", str(BATCH)] + files
        rate = cli_input_rate(s1)
        r1, l1 = cli_run(card, "CLI stage-1 HRNet", s1 + [
            "--epochs", "1", "--max_steps", str(steps1)], BATCH, steps1, k1,
            input_rate=rate)
        check_k1(l1, r1, steps1, "CLI stage-1 HRNet")
        stage1_dir = r1.ckpt_dir
        saved = (r1.state.step, r1.state.banks.detach().cpu().clone(),
                 r1.state.model.encoder1.conv1.weight.detach().cpu().clone())

        def check_restored(state):
            got = (state.step, state.banks.detach().cpu(),
                   state.model.encoder1.conv1.weight.detach().cpu())
            if not (got[0] == saved[0] and torch.equal(got[1], saved[1])
                    and torch.equal(got[2], saved[2])):
                raise AssertionError("resume: the restored step, banks or "
                                     "encoder1.conv1.weight differ from "
                                     "what was saved")
            restored["step"] = got[0]

        r2, l2 = cli_run(card, "CLI stage-1 HRNet resumed", s1 + [
            "--epochs", "2", "--resume", "auto", "--max_steps",
            str(2 * steps1)], BATCH, steps1, k1, on_ready=check_restored,
            input_rate=rate)
        if r2.start_epoch != 2 or restored.get("step") != steps1:
            raise AssertionError(f"resume started at epoch {r2.start_epoch}"
                                 f", step {restored.get('step')}")
        print(f"CLI resume: epoch 2 restored step {steps1}, the banks and "
              f"encoder1.conv1.weight bit for bit [{card}]")
        check_k1(l2, r2, steps1, "CLI stage-1 HRNet resumed")
        trained = r2.state.model.encoder1.conv1.weight.detach().cpu().clone()
        del r1, r2
        torch.cuda.empty_cache()
        l_nccl = nccl_cli(card, s1, os.path.join(tmp, "save_nccl"))

        def check_grafted(state):
            if not torch.equal(
                    state.model.encoder1.conv1.weight.detach().cpu(),
                    trained):
                raise AssertionError("--pretrain did not graft "
                                     "encoder1.conv1.weight")

        s2_steps = 8
        s2 = ["--recipe", "second_stage/ntumpiirgbd2s_hrnet_w18",
              "--batch_size", str(BATCH)] + files
        r3, l3 = cli_run(card, "CLI stage-2 HRNet --pretrain", s2 + [
            "--pretrain", stage1_dir, "--epochs", "1", "--max_steps",
            str(s2_steps)],
            BATCH, s2_steps, k1, on_ready=check_grafted, input_rate=rate)
        check_k1(l3, r3, s2_steps, "CLI stage-2 HRNet")
        shutil.copy(os.path.join(r3.ckpt_dir, f"epoch_{r3.last_epoch}.pt"),
                    stage2_copy)
        del r3

        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
        pn = ["--recipe", "first_stage/ntumpiirgbd2s_hrnetpn_w18",
              "--batch_size", str(PN_BATCH), "--packed_dir", pack] + files
        pn_steps = 8
        r4, l4 = cli_run(card, "CLI stage-1 HRNetPN packed", pn + [
            "--epochs", "1", "--max_steps", str(pn_steps)], PN_BATCH,
            pn_steps, point_wrappers(), input_rate=cli_input_rate(pn))
        route = library_route("resample")
        if not route.startswith("native"):
            raise AssertionError(f"the packed path took the {route}")
        print(f"CLI HRNetPN packed path: resample route {route} [{card}]")
        del r4
        torch.cuda.empty_cache()
        return [l1, l2, l3] + l_nccl, [l4]
    finally:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the versatility segmentor, its export, and the row-gather NCE ----------

VERSATILITY_RECIPE = "versatility/sup_rgbd"
SEG_NTU_FRAMES = 192   # NTU frames of the versatility CLI's tree
SEG_FRAMES = 64        # Parsing-4K frames of it (and its validation set)
GATHER_N_DATA = 262144  # above counts_max_n_data: the 'gather' NCE


def seg_batch(rng: np.random.Generator, bsz: int, size: int, n_data: int,
              n_class: int = 25) -> dict:
    """A synthetic batch with segmentation labels: label uniform over the
    classes, true_label on about half the frames (one labelled and one
    unlabelled frame at least)."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch

    b = synthetic_contrast_batch(rng, bsz, size=size, n_data=n_data)
    b["label"] = rng.integers(0, n_class, (bsz, size, size)).astype(np.int32)
    b["true_label"] = (rng.random(bsz) < 0.5).astype(np.int32)
    b["true_label"][:2] = (1, 0)
    return b


def small_segment_check(card: str) -> None:
    """(a) One tiny f32 versatility step (width 4, 32^2, K=15, 16 pixels
    an image, 25 classes; negatives and pixels pinned) on the card against
    the same step on the CPU (held against the JAX package by
    tests/test_torch_segment_step.py), for supervise_type 0 and 3: losses
    within rel 1e-4, accuracies within 0.05, banks and the params of model
    and classifier within rtol 1e-4, atol 1e-5.  Plain ConvBN path (see
    small_reference_check)."""
    from hcmoco_tpu_torch.core.config import RECIPES
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.heads import FCNHead
    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse
    from hcmoco_tpu_torch.train.segment_step import make_segment_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    for sup in (0, 3):
        cfg = dataclasses.replace(
            RECIPES[VERSATILITY_RECIPE], supervise_type=sup, width=4,
            crop_size=32, batch_size=6, nce_k=15, compute_dtype="float32",
            pri3d_num_samples_per_image=16)
        rng = np.random.default_rng(5)
        batch = seg_batch(rng, 6, 32, 64)
        batch["rgbd"] = (rng.standard_normal((6, 32, 32, 6)) * 0.5).astype(
            np.float32)  # see small_reference_check
        batch["pix_idx"] = pinned_pixels(batch["depth_mask"], 16, rng)
        neg = rng.integers(0, 64, (6, 16))
        neg[:, 0] = batch["index"]
        batch["neg_idx"] = neg
        torch.manual_seed(0)
        model = set_convbn_fuse(build_model(cfg, device="cpu"), False)
        head = FCNHead(128, cfg.n_class)
        banks = None
        res = []
        for run in ("cpu", "cuda"):
            m, h = copy.deepcopy(model).to(run), copy.deepcopy(head).to(run)
            st = create_train_state(cfg, m,
                                    torch.Generator(run).manual_seed(3),
                                    n_data=64, steps_per_epoch=10,
                                    classifier=h)
            if banks is None:
                banks = st.banks.clone()
            st.banks = banks.to(run, copy=True)
            step = make_segment_train_step(cfg, m, h, steps_per_epoch=10)
            metrics = {k: float(v) for k, v in
                       step(st, to_device(batch, run)).items()
                       if k != "learning_rate"}
            sd = {f"model.{k}": v.cpu() for k, v in m.state_dict().items()}
            sd.update({f"classifier.{k}": v.cpu()
                       for k, v in h.state_dict().items()})
            res.append((metrics, sd, st.banks.cpu()))
        (ref, sd_ref, b_ref), (got, sd_got, b_got) = res
        if ("loss_seg" in got) != (sup != 3):
            raise AssertionError(f"supervise_type {sup}: metrics {sorted(got)}")
        for k, want in ref.items():
            tol = (dict(rtol=0.0, atol=0.05) if "acc" in k
                   else dict(rtol=1e-4, atol=0.0))
            if not np.isfinite(got[k]) or not (
                    abs(got[k] - want) <= tol["atol"]
                    + tol["rtol"] * abs(want)):
                raise AssertionError(f"tiny segment step (supervise_type "
                                     f"{sup}) {k}: card {got[k]} vs cpu "
                                     f"{want}")
        torch.testing.assert_close(b_got, b_ref, rtol=1e-4, atol=1e-5)
        for k, want in sd_ref.items():
            if want.is_floating_point():
                torch.testing.assert_close(
                    sd_got[k], want, rtol=1e-4, atol=1e-5,
                    msg=lambda msg, k=k: f"tiny segment step {k}: {msg}")
        print(f"tiny f32 segment step (supervise_type {sup}), card vs cpu: "
              + ", ".join(f"{k} {got[k]:.6f}/{ref[k]:.6f}" for k in
                          ("loss", "loss_seg", "loss_scl") if k in got)
              + f", params of model and classifier and banks within "
              f"tolerance [{card}]")


def drive_versatility(card: str) -> dict:
    """(b) The versatility step of RECIPES['versatility/sup_rgbd']
    (HRNet-W18 x2 + SemGCN + the FCN head, 320^2, K=16384, 'dense' NCE,
    supervise_type 0) at bs32 with HCMOCO_CONVBN_FUSE=1, n_data 8192,
    through the user entry points: STEPS timed steps (median, quartiles),
    peak memory, K1/K1b launches (checked: one a fused site and step),
    then a profile of two steps by kernel class.  Returns the launches in
    the order of their JSON entries."""
    from hcmoco_tpu_torch.core.config import RECIPES
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.heads import FCNHead
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.ops import matmul_bn as mb
    from hcmoco_tpu_torch.train.segment_step import (SEGMENT_METRICS,
                                                     make_segment_train_step)
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = dataclasses.replace(RECIPES[VERSATILITY_RECIPE], batch_size=BATCH)
    os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    head = FCNHead(128, cfg.n_class).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=N_DATA,
                               steps_per_epoch=100, classifier=head)
    step = make_segment_train_step(cfg, model, head, steps_per_epoch=100)
    batch = to_device(seg_batch(np.random.default_rng(0), BATCH,
                                cfg.crop_size, N_DATA, cfg.n_class), dev)
    sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
    generic = generic_sites(model.encoder1) + generic_sites(model.encoder2)
    wrappers = k1_wrappers()
    label = "versatility HRNet"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    mb.mm_bn_stats_cuda.generic_launches = 0
    times = []
    steady, metrics = timed_steps(step, state, batch, gen, STEPS, label,
                                  card, times)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_gen = mb.mm_bn_stats_cuda.generic_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, n in launches.items():
        if n != sites * STEPS:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {sites} x {STEPS}")
    if n_gen != generic * STEPS:
        raise AssertionError(f"{label}: K1's generic path launched {n_gen} "
                             f"times, expected {generic} x {STEPS}")
    launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                "mm_bn_stats generic": n_gen, **launches}
    for i, m in enumerate(metrics):
        print(f"{label} step {i}: " + ", ".join(
            f"{k} {m[k]:.5f}" for k in ("loss", "loss_seg")
            + SEGMENT_METRICS))
    q1, _, q3 = statistics.quantiles(times[1:], n=4)
    print(f"{label} W{cfg.width} {cfg.crop_size}^2 bs{BATCH} K={cfg.nce_k} "
          f"supervise_type "
          f"{cfg.supervise_type} step: median {steady * 1e3:.2f} ms "
          f"(quartiles {q1 * 1e3:.2f}, {q3 * 1e3:.2f}; steps 2-{STEPS}) = "
          f"{BATCH / steady:.2f} samples/s; peak memory {peak:.2f} GiB; "
          f"launches {launches} in {STEPS} steps ({sites} fused sites, "
          f"{generic} on K1's generic path) [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    del model, head, state, step, batch
    torch.cuda.empty_cache()
    return launches


def drive_segmentor_cli(card: str, stage2_ckpt: str, tmp: str) -> tuple:
    """(c) cli/main_segmentor.py in process on the card from a tree of
    SEG_NTU_FRAMES NTU and SEG_FRAMES Parsing-4K frames at the Kinect
    size, written from a seed under `tmp`: RECIPES['versatility/sup_rgbd']
    at bs32 fused, --pretrain from the stage-2 checkpoint, one epoch of
    (SEG_NTU_FRAMES + SEG_FRAMES) / 32 steps and one validation pass on
    the Parsing-4K frames, whose three heads' mIoU must be finite.
    Returns (its RunResult, its K1/K1b launches, checked one a fused site
    and step)."""
    from hcmoco_tpu_torch.cli.main_segmentor import main as seg_main
    from hcmoco_tpu_torch.data.fixtures import (make_ntu_fixture,
                                                make_seg_fixture)
    from hcmoco_tpu_torch.models.hrnet import fused_sites

    t0 = time.perf_counter()
    ntu, ntu_list = make_ntu_fixture(os.path.join(tmp, "ntu"),
                                     n_frames=SEG_NTU_FRAMES, seed=5,
                                     h=KINECT_HW[0], w=KINECT_HW[1])
    seg, seg_list = make_seg_fixture(os.path.join(tmp, "seg"), ntu,
                                     n_frames=SEG_FRAMES, seed=6,
                                     h=KINECT_HW[0], w=KINECT_HW[1])
    print(f"versatility CLI tree: {SEG_NTU_FRAMES} NTU and {SEG_FRAMES} "
          f"Parsing-4K frames at {KINECT_HW[0]}x{KINECT_HW[1]} written in "
          f"{time.perf_counter() - t0:.2f} s")
    steps = (SEG_NTU_FRAMES + SEG_FRAMES) // BATCH
    argv = ["--recipe", VERSATILITY_RECIPE, "--batch_size", str(BATCH),
            "--data_folder", ntu, "--train_file_list", ntu_list,
            "--seg_root", seg, "--seg_file_list", seg_list,
            "--seg_val_file_list", seg_list, "--model_path",
            os.path.join(tmp, "save"), "--seed", "0", "--print_freq", "4"]
    want = torch.load(stage2_ckpt, map_location="cpu",
                      weights_only=True)["model"]["encoder1.conv1.weight"]

    def check_grafted(state):
        if not torch.equal(state.model.encoder1.conv1.weight.detach().cpu(),
                           want):
            raise AssertionError("--pretrain did not graft "
                                 "encoder1.conv1.weight")

    os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    label = "versatility CLI --pretrain"
    r, launches = cli_run(
        card, label, argv + ["--pretrain", stage2_ckpt, "--epochs", "1"],
        BATCH, steps, {name: (fn, None) for name, fn in k1_wrappers().items()},
        on_ready=check_grafted, input_rate=cli_input_rate(argv),
        main=seg_main)
    model = r.state.model
    sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
    generic = generic_sites(model.encoder1) + generic_sites(model.encoder2)
    expect = {name: (generic if name.endswith("generic") else sites) * steps
              for name in launches}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    if len(r.val) != 1 or not all(
            np.isfinite(v) for res in r.val[0].values() for v in res.values()):
        raise AssertionError(f"{label}: validation {r.val}")
    print(f"{label}: validation on {SEG_FRAMES} Parsing-4K frames: "
          + ", ".join(f"{name} mIoU {res['miou']:.4f}"
                      for name, res in r.val[0].items())
          + f"; best rgbd mIoU {r.best_miou:.4f} [{card}]")
    return r, launches


def check_export(card: str, stage2_ckpt: str, seg_ckpt: str,
                 tmp: str) -> None:
    """(d) cli/transfer_ckpt.py on the stage-2 checkpoint (encoder1 and
    encoder2) and on the segmentor's (encoder1): each .pth loads with
    strict=True into a bare HRNet-W18 on the card, whose eval forward of a
    bs2 320^2 input equals the source encoder's (the model rebuilt from
    the checkpoint, in the recipe's compute dtype, bf16) bit for bit:
    same weights, dtype, card and kernels."""
    from hcmoco_tpu_torch.cli import transfer_ckpt
    from hcmoco_tpu_torch.core.config import HRNET_W18, RECIPES
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import HRNet

    dev = torch.device("cuda")
    x = torch.randn((2, 3, 320, 320), generator=torch.Generator(
        dev).manual_seed(9), device=dev).contiguous(
        memory_format=torch.channels_last)
    cfg = RECIPES["second_stage/ntumpiirgbd2s_hrnet_w18"]
    for ckpt, enc in ((stage2_ckpt, "encoder1"), (stage2_ckpt, "encoder2"),
                      (seg_ckpt, "encoder1")):
        out = os.path.join(tmp, f"{enc}.pth")
        sd = transfer_ckpt.main(["--ckpt", ckpt, "--encoder", enc, "--out",
                                 out])
        bare = HRNet(HRNET_W18, 3, getattr(torch, cfg.compute_dtype)).to(
            dev, memory_format=torch.channels_last).eval()
        bare.load_state_dict(torch.load(out, map_location=dev,
                                        weights_only=True), strict=True)
        source = build_model(cfg).to(memory_format=torch.channels_last)
        source.load_state_dict(torch.load(ckpt, map_location=dev,
                                          weights_only=True)["model"],
                               strict=True)
        source = getattr(source, enc).eval()
        with torch.no_grad():
            got, want = bare(x), source(x)
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"export {enc} of {ckpt}: map {i} differs by "
                    f"{float((g.float() - w.float()).abs().max())}")
        print(f"transfer_ckpt {enc} of {os.path.basename(ckpt)}: "
              f"{len(sd)} tensors, strict load into a bare HRNet-W18, eval "
              f"forward equal bit for bit on all {len(got)} maps [{card}]")
        del bare, source, got, want


def record_k1_rows(rows: list):
    """Wraps K1's dispatcher so that each launch on the card appends its
    row count to `rows`; returns the function that undoes it."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    plain = mb.mm_bn_stats

    def recorded(x2d, w):
        if x2d.is_cuda:
            rows.append(x2d.shape[0])
        return plain(x2d, w)

    mb.mm_bn_stats = recorded

    def undo():
        mb.mm_bn_stats = plain

    return undo


def nce_forms(card: str, n_data: int) -> None:
    """The index form of the NCE at bs32, K=16384 over `n_data` bank rows:
    'hybrid' and 'gather' against 'dense' on one pinned draw (logits
    within rtol 1e-5 plus 1e-6 of their largest magnitude, the features'
    gradients within 1e-5 of theirs), the counts form's CE against the
    index form's, whether 'dense' (whose backward scatter-adds with f32
    atomics) repeats its gradient bit for bit, and the device time of
    each form's forward + backward."""
    from hcmoco_tpu_torch.contrast import memory as mem
    from hcmoco_tpu_torch.contrast.losses import per_sample_nce

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(11)

    def unit(*shape):
        v = torch.randn(shape, generator=g, device=dev)
        return v / v.norm(dim=-1, keepdim=True)

    k = 16384
    feats, banks = unit(3, BATCH, 128), unit(3, n_data, 128)
    y = torch.randperm(n_data, generator=g, device=dev)[:BATCH]
    idx = mem.sample_negative_indices(g, y, n_data, k)
    cot = torch.randn((6, BATCH, k + 1), generator=g, device=dev)
    counts = torch.zeros((BATCH, n_data), device=dev).scatter_add_(
        1, idx[:, 1:], torch.ones((BATCH, k), device=dev))

    def run(mode):
        f = feats.clone().requires_grad_(True)
        if mode == "counts":
            per = mem.cmc3_losses_counts(f, banks, y, k, 0.07, counts=counts)
            loss = sum(ce.sum() for ce, _ in per)
            logits = None
        else:
            logits, _ = mem.cmc3_forward(banks, f, y, f, y, k, 0.07,
                                         neg_idx=idx, mode=mode)
            logits = torch.stack(logits)
            loss = (logits * cot).sum()
        loss.backward()
        return (None if logits is None else logits.detach()), f.grad

    ref_l, ref_g = run("dense")
    again = run("dense")[1]
    dense_exact = torch.equal(again, ref_g)
    for mode in ("hybrid", "gather"):
        lg, gr = run(mode)
        torch.testing.assert_close(
            lg, ref_l, rtol=1e-5, atol=1e-6 * float(ref_l.abs().max()),
            msg=lambda m, mode=mode: f"NCE {mode} logits vs dense: {m}")
        torch.testing.assert_close(
            gr, ref_g, rtol=0.0, atol=1e-5 * float(ref_g.abs().max()),
            msg=lambda m, mode=mode: f"NCE {mode} grads vs dense: {m}")
    # the counts form is the same CE on the same draw
    f = feats.clone().requires_grad_(True)
    lg, _ = mem.cmc3_forward(banks, f, y, f, y, k, 0.07, neg_idx=idx,
                             mode="gather")
    per_i = [per_sample_nce(x)[0] for x in lg]
    per_c = [ce for ce, _ in mem.cmc3_losses_counts(feats, banks, y, k, 0.07,
                                                    counts=counts)]
    for a, b in zip(per_c, per_i):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-5)
    ms = {mode: cuda_ms(lambda mode=mode: run(mode), iters=10)
          for mode in ("counts", "dense", "hybrid", "gather")}
    print(f"six-way NCE at bs{BATCH}, K={k}, n_data {n_data}: hybrid and "
          f"gather agree with dense; 'dense' gradient run to run "
          f"{'bit for bit' if dense_exact else 'NOT bit for bit'} "
          f"(max diff {float((again - ref_g).abs().max()):.3g}); "
          f"forward + backward device ms: "
          + ", ".join(f"{m} {t:.4f}" for m, t in ms.items()) + f" [{card}]")


def check_microbatch(card: str, dtype: str, fuse: bool,
                     full_rows: list = None) -> None:
    """A --microbatch 2 step at bs32 against its two bs16 halves run by
    hand (loss/2 backward, banks committed after each half, one SGD
    step), from one state, under cuDNN's and torch's deterministic
    algorithms.  The step is first run twice: the two must agree bit for
    bit, which is the reading that sets the bound, and then the halves
    by hand must equal the step bit for bit, parameters, BN running
    statistics (a training forward never reads them, so only this
    catches statistics that do not chain), banks and metrics alike.
    With `fuse` (HCMOCO_CONVBN_FUSE=1, the path main_contrast
    --microbatch takes in bf16) K1 and K1b must launch once a fused site
    and microbatch, K1 at half of each of `full_rows` (a bs32 step's
    rows, one a site)."""
    from hcmoco_tpu_torch.contrast import memory as mem
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.train.contrast_step import (
        fill_missing_grads, make_contrast_loss_fn, make_contrast_train_step)
    from hcmoco_tpu_torch.train.schedules import learning_rate_fn
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    label = f"--microbatch 2 {dtype} fuse {int(fuse)}"
    if fuse:
        os.environ["HCMOCO_CONVBN_FUSE"] = "1"
    else:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    cfg = make_cfg(microbatch=2, compute_dtype=dtype)
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    base = create_train_state(cfg, model, torch.Generator(dev).manual_seed(1),
                              n_data=N_DATA, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(2), BATCH, size=cfg.crop_size, num_joints=16,
        n_data=N_DATA), dev)
    batch["counts"] = mem.sample_negative_counts(
        torch.Generator(dev).manual_seed(3), BATCH, N_DATA, cfg.nce_k,
        device=dev)
    wrappers = k1_wrappers()
    rows = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = []
    for run in ("step", "step again", "by hand"):
        st = copy.deepcopy(base)
        if run == "step":
            for fn in wrappers.values():
                fn.launches = 0
            wrappers["mm_bn_stats"].generic_launches = 0
            undo = record_k1_rows(rows)
            m = make_contrast_train_step(cfg, st.model, 100)(st, batch)
            torch.cuda.synchronize()
            undo()
            launches = {name: fn.launches for name, fn in wrappers.items()}
            n_gen = wrappers["mm_bn_stats"].generic_launches
        elif run == "step again":
            m = make_contrast_train_step(cfg, st.model, 100)(st, batch)
        else:
            loss_fn = make_contrast_loss_fn(cfg, st.model)
            for group in st.optimizer.param_groups:
                group["lr"] = learning_rate_fn(cfg, 100)(0)
            st.optimizer.zero_grad(set_to_none=True)
            parts = []
            for half in range(2):
                part = {key: v[half * BATCH // 2:(half + 1) * BATCH // 2]
                        for key, v in batch.items()}
                loss, mm, commit = loss_fn(st, part)
                (loss / 2).backward()
                commit()
                parts.append(mm)
            fill_missing_grads(st.optimizer)
            st.optimizer.step()
            m = {key: torch.stack([p[key] for p in parts]).mean()
                 for key in parts[0]}
        runs.append((st, {key: float(v) for key, v in m.items()
                          if key != "learning_rate"}))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = deterministic
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    (a, ma), *others = runs
    if not np.isfinite(ma["loss"]):
        raise AssertionError(f"{label}: loss {ma['loss']}")
    for (b, mb_), what in zip(others, ("step again", "by hand")):
        if mb_ != ma:
            raise AssertionError(f"{label} vs {what}: metrics {ma} vs {mb_}")
        state_b = dict(b.model.state_dict())
        for name, t in a.model.state_dict().items():
            u = state_b[name]
            if not torch.equal(t, u):
                raise AssertionError(
                    f"{label} vs {what}: {name} differs by "
                    f"{float((t.double() - u.double()).abs().max())}")
        if not torch.equal(a.banks, b.banks):
            raise AssertionError(f"{label} vs {what}: banks differ")
    n_params = len(list(a.model.parameters()))
    n_stats = sum(name.endswith(("running_mean", "running_var"))
                  for name in a.model.state_dict())
    note = ""
    if fuse:
        sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
        generic = generic_sites(model.encoder1) + generic_sites(model.encoder2)
        for name, n in launches.items():
            if n != 2 * sites:
                raise AssertionError(f"{label}: {name} launched {n} times, "
                                     f"expected 2 x {sites}")
        if n_gen != 2 * generic:
            raise AssertionError(f"{label}: K1's generic path launched "
                                 f"{n_gen} times, expected 2 x {generic}")
        want = sorted(r // 2 for r in full_rows for _ in range(2))
        if len(full_rows) != sites or any(r % 2 for r in full_rows) or (
                sorted(rows) != want):
            raise AssertionError(f"{label}: K1 rows {sorted(set(rows))}, "
                                 f"bs{BATCH} rows {sorted(set(full_rows))}")
        note = (f"; K1 and K1b {2 * sites} launches each ({2 * generic} on "
                f"K1's generic path), K1 at rows {sorted(set(rows))}, half "
                f"of bs{BATCH}'s")
    print(f"{label} step at bs{BATCH} (cuDNN and torch deterministic): "
          f"equal bit for bit to itself run again and to its two "
          f"bs{BATCH // 2} halves by hand, {n_params} parameter and "
          f"{n_stats} BN statistic tensors, banks and metrics; loss "
          f"{ma['loss']:.6f}{note} [{card}]")
    del model, base, runs, a, others
    torch.cuda.empty_cache()


def check_row_gather_nce(card: str) -> None:
    """(e) The index form of the NCE on the card (nce_forms) at n_data
    8192 and at 262144; an HRNet-W18 stage-1 step at n_data 262144 (the
    'gather' mode, its banks ~400 MB) with a finite loss, its host median
    and one profiled step's device time, K1's rows recorded; then the
    --microbatch 2 checks (check_microbatch) in f32 on the plain ConvBN
    path and in bf16 on the fused one."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import (make_contrast_train_step,
                                                      nce_mode)
    from hcmoco_tpu_torch.train.state import create_train_state

    nce_forms(card, N_DATA)
    nce_forms(card, GATHER_N_DATA)

    # an HRNet-W18 stage-1 step past counts_max_n_data: 'gather'
    dev = torch.device("cuda")
    os.environ["HCMOCO_CONVBN_FUSE"] = "1"
    cfg = make_cfg()
    if nce_mode(cfg, GATHER_N_DATA, False) != "gather":
        raise AssertionError("n_data above counts_max_n_data is not 'gather'")
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    g = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, g, n_data=GATHER_N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(1), BATCH, size=cfg.crop_size, num_joints=16,
        n_data=GATHER_N_DATA), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full_rows = []
    undo = record_k1_rows(full_rows)
    step(state, batch, g)  # warm-up, and one step's K1 rows
    torch.cuda.synchronize()
    undo()
    steady, metrics = timed_steps(step, state, batch, g, STEPS,
                                  "stage-1 HRNet 'gather'", card)
    print(f"stage-1 HRNet W18 bs{BATCH} at n_data {GATHER_N_DATA} ('gather' "
          f"NCE, banks {state.banks.numel() * 4 / 2**20:.0f} MiB): median "
          f"{steady * 1e3:.2f} ms of steps 2-{STEPS}, loss "
          f"{metrics[-1]['loss']:.5f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    profile_steps(card, step, state, batch, g, steady, n=1)
    del model, state, step, batch
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.cuda.empty_cache()

    check_microbatch(card, "float32", False)
    check_microbatch(card, "bfloat16", True, full_rows)


def versatility_phase(card: str, stage2_ckpt: str, tmp: str) -> list:
    """(a)-(e); returns the K1/K1b launches of its two main paths (the
    synthetic step and the CLI), each counted from 0."""
    small_segment_check(card)
    runs = [drive_versatility(card)]
    r, launches = drive_segmentor_cli(card, stage2_ckpt, tmp)
    runs.append(launches)
    seg_ckpt = os.path.join(r.ckpt_dir, f"epoch_{r.last_epoch}.pt")
    del r
    torch.cuda.empty_cache()
    check_export(card, stage2_ckpt, seg_ckpt, tmp)
    check_row_gather_nce(card)
    return runs


# ---- the downstream stacks: parsing and A2J from stage 2's depth encoder ----

SEG_CROP, SEG_BATCH = 473, 40   # the parsing recipe's crop, per-GPU batch
SEG_TRAIN, SEG_VAL = 320, 40    # Parsing-4K frames of the parsing tree
A2J_CROP, A2J_BATCH = 288, 12   # A2J's crop and batch (a2j/train.py)
ITOP_TRAIN, ITOP_TEST = 64, 16  # ITOP frames of the A2J fixture
# K1 at the downstream trainers' row counts: (R, K, C, site); R = batch x
# H x W of the site's input (473^2: branches 119/60/30/15; 288^2: 72/36/
# 18/9), every (K, C) of each trainer's fused sites
K1_DOWNSTREAM = (
    (566440, 64, 256, "parsing layer1 conv3/downsample 119x119"),
    (566440, 256, 64, "parsing layer1 conv1 119x119"),
    (566440, 64, 64, "parsing layer1 block-1 conv1 119x119"),
    (144000, 36, 18, "parsing fuse 36->18 60x60"),
    (36000, 72, 18, "parsing fuse 72->18 30x30"),
    (36000, 72, 36, "parsing fuse 72->36 30x30"),
    (9000, 144, 18, "parsing fuse 144->18 15x15"),
    (9000, 144, 36, "parsing fuse 144->36 15x15"),
    (9000, 144, 72, "parsing fuse 144->72 15x15"),
    (62208, 64, 256, "A2J layer1 conv3/downsample 72x72"),
    (62208, 256, 64, "A2J layer1 conv1 72x72"),
    (62208, 64, 64, "A2J layer1 block-1 conv1 72x72"),
    (15552, 36, 18, "A2J fuse 36->18 36x36"),
    (3888, 72, 18, "A2J fuse 72->18 18x18"),
    (3888, 72, 36, "A2J fuse 72->36 18x18"),
    (972, 144, 18, "A2J fuse 144->18 9x9"),
    (972, 144, 36, "A2J fuse 144->36 9x9"),
    (972, 144, 72, "A2J fuse 144->72 9x9"))
K1B_DOWNSTREAM = ((566440, 256, "parsing layer1 conv3/downsample"),
                  (566440, 64, "parsing layer1 conv1"),
                  (144000, 18, "parsing fuse 36->18"),
                  (62208, 256, "A2J layer1 conv3/downsample"),
                  (972, 72, "A2J fuse 144->72"))


def k1_exact_check(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                   yp: torch.Tensor, site: str) -> tuple:
    """K1's y against the exact product of its bf16 inputs (in f64): within
    1 bf16 ulp plus the f32 accumulation bound K 2^-24 sum_k |x w|, the
    bound any f32-accumulated, bf16-rounded product meets.  Where y parts
    from the plain version `yp` by more than 1 bf16 ulp (cuBLAS at
    144000x36->18 picks an algorithm that strays on cancelling sums), y
    must be the closer of the two to the exact product.  Returns (max
    |y - exact| in those units, elements parted from yp)."""
    ex = x.double() @ w.double().t()
    tol = (bf16_ulp(torch.maximum(y.double().abs(), ex.abs()))
           + x.shape[1] * 2.0 ** -24 * (x.double().abs()
                                         @ w.double().abs().t()))
    err = (y.double() - ex).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"K1 y at {site}: {int((err > tol).sum())} "
                             "elements off the exact product by more than "
                             "1 bf16 ulp + the f32 accumulation bound")
    yf, ypf = y.float(), yp.float()
    parted = (yf - ypf).abs() > bf16_ulp(torch.maximum(yf.abs(), ypf.abs()))
    if bool((parted & (err > (yp.double() - ex).abs())).any()):
        raise AssertionError(f"K1 y at {site}: where it parts from the "
                             "plain version by more than 1 bf16 ulp, the "
                             "plain version is closer to the exact product")
    return float((err / tol).max()), int(parted.sum())


def check_downstream_kernels(card: str) -> None:
    """K1 and K1b against their plain versions at the downstream row
    counts (none a multiple of the fast path's 32- or 64-row blocks but
    62208): y as k1_exact_check holds it (within 1 bf16 ulp of the plain
    version, as check_k1 holds it, unless the plain version strays
    farther from the exact product), s1/s2 within 1e-5 of each channel's
    summed magnitudes of f64 sums of the kernel's own y, the same bits
    over two launches; K1b as check_k1b holds it.  Times the
    566440x64->256 call."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    g = torch.Generator(device="cuda").manual_seed(11)
    for r, k, c, site in K1_DOWNSTREAM:
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = (torch.randn((c, k), generator=g, device="cuda")
             / k ** 0.5).bfloat16()
        y, s1, s2 = mb.mm_bn_stats_cuda(x, w)
        y2, a1, a2 = mb.mm_bn_stats_cuda(x, w)
        yp = mb.mm_bn_stats_plain(x, w)[0]
        if not (torch.equal(y, y2) and torch.equal(s1, a1)
                and torch.equal(s2, a2)):
            raise AssertionError(f"K1 differs between launches at {site}")
        rel, parted = k1_exact_check(x, w, y, yp, site)
        err = (y.float() - yp.float()).abs()
        yd = y.double()
        for name, got, want, scale in (
                ("s1", s1, yd.sum(0), yd.abs().sum(0)),
                ("s2", s2, (yd * yd).sum(0), (yd * yd).sum(0))):
            if bool(((got.double() - want).abs() > 1e-5 * scale).any()):
                raise AssertionError(
                    f"K1 {name} off at {site} (R={r}): max err "
                    f"{float((got.double() - want).abs().max())}")
        path = "fast" if (k, c) in mb.FAST_SHAPES else "generic"
        note = ""
        if (r, k, c) == K1_DOWNSTREAM[0][:3]:
            ms = cuda_ms(lambda: mb.mm_bn_stats_cuda(x, w))
            plain_ms = cuda_ms(lambda: mb.mm_bn_stats_plain(x, w))
            bnd = bound(2 * (r * k + c * k + r * c) + 8 * c, 2 * r * k * c,
                        BF16_OPS_S)
            note = (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        print(f"K1 {path} R={r} K={k} C={c} ({site}): y max|y - plain| "
              f"{float(err.max()):.6g}, {parted} elements more than 1 bf16 "
              f"ulp from plain (the plain version the farther from the "
              f"exact product there), max |y - exact| {rel:.3f} of 1 bf16 "
              f"ulp + the f32 accumulation bound; s1/s2 within 1e-5, 2 "
              f"launches identical{note} [{card}]")
        del x, y, y2, yp, yd, err
    check_k1b(card, K1B_DOWNSTREAM, clamp=False)
    torch.cuda.empty_cache()


def capture_stdout(fn):
    """fn()'s result and what it printed, which is printed here too."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    sys.stdout.write(buf.getvalue())
    return result, buf.getvalue()


def downstream_run(card: str, label: str, main, argv: list, bsz: int,
                   n: int, sites: int, generic: int) -> tuple:
    """A downstream trainer's main(argv) on the card, `n` train steps, with
    every K1/K1b count set to 0 just before it; torch.profiler records
    its last two steps.  Checks that K1 and the four K1b kernels launched
    `sites` times a step and K1's generic path `generic` times, and that
    every step's loss is finite.  Prints the iteration's median and
    quartiles over the steps before the profiler's (the first, a warm-up,
    left out) with its parts, the device time a step and the busy share,
    and the peak memory of the training steps and of the whole run.
    Returns (the run, its printed text, its launches by name)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = k1_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["mm_bn_stats"].generic_launches = 0
    train_peak = []
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=n - 3, warmup=1, active=2,
                                   repeat=1)) as prof:
        def on_step(i):
            prof.step()
            if i == n:
                train_peak.append(torch.cuda.max_memory_allocated())
        r, out = capture_stdout(lambda: main(argv, on_step=on_step))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                "mm_bn_stats generic":
                    wrappers["mm_bn_stats"].generic_launches, **launches}
    if len(r.step_s) != n:
        raise AssertionError(f"{label}: ran {len(r.step_s)} steps, "
                             f"expected {n}")
    want = {name: (generic if name.endswith("generic") else sites) * n
            for name in launches}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    losses = [m["loss"] for m in r.metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss in {losses}")

    rows = device_rows(prof)
    kernel_ms = sum(us for name, us in rows
                    if not name.startswith(("Memcpy", "Memset"))) / 1e3 / 2
    it_s = [a + b + c for a, b, c in zip(r.wait_s, r.upload_s, r.step_s)]
    free = slice(1, n - 3)  # after the warm-up, before the profiler's steps
    q1, med, q3 = statistics.quantiles(it_s[free], n=4)
    print(f"{label}: {n} steps, losses " + ", ".join(f"{v:.5f}"
                                                   for v in losses))
    classes, by_name = {}, {}
    for name, us in rows:
        k = name.lower()
        cls = next((c for c, keys in PN_CLASSES
                    if any(t in k for t in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / 2
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / 2
    print(f"{label}: device ms/step by class: " + ", ".join(
        f"{c} {ms:.3f}" for c, ms in sorted(classes.items(),
                                            key=lambda kv: -kv[1]))
        + f" [{card}]")
    for name in sorted(by_name, key=lambda k: -by_name[k])[:6]:
        print(f"  {by_name[name]:9.3f} ms/step  {name[:100]}")
    print(f"{label}: iteration median {med * 1e3:.2f} ms (quartiles "
          f"{q1 * 1e3:.2f}, {q3 * 1e3:.2f}; steps 2-{n - 3}) = "
          f"{bsz / med:.2f} samples/s; medians of its parts: data wait "
          f"{statistics.median(r.wait_s[free]) * 1e3:.2f} ms, pin + upload "
          f"enqueue {statistics.median(r.upload_s[free]) * 1e3:.2f} ms, step "
          f"{statistics.median(r.step_s[free]) * 1e3:.2f} ms; device kernel "
          f"time {kernel_ms:.3f} ms/step, busy share "
          f"{kernel_ms / (med * 1e3):.3f}; peak memory "
          f"{train_peak[0] / 2**30:.2f} GiB over the train steps, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over the "
          f"run [{card}]")
    print(f"{label}: K1/K1b launches {launches} in {n} steps = {sites} a "
          f"step ({generic} on K1's generic path) for the one HRNet-W18 "
          f"(the pre-training step's two: 80, 62); wall {wall:.1f} s "
          f"[{card}]")
    return r, out, launches


def downstream_phase(card: str, encoder2: str, tmp: str) -> list:
    """The downstream journey on the card from stage 2's exported depth
    encoder (`encoder2`, transfer_ckpt's .pth), HCMOCO_CONVBN_FUSE=1:
    (a) K1 and K1b against their plain versions at the trainers' row
    counts; (b) depth parsing (downstream/seg/train.py): HRNet-W18, crop
    473, bs40, --pretrained, on a Parsing-4K tree of Kinect-size frames
    written from a seed, one epoch of SEG_TRAIN / 40 steps and its
    validation, then --test_only with flip TTA at two scales on 2 val
    frames from the best weights; (c) A2J (downstream/a2j/train.py):
    HRNet-W18, crop 288, bs12, --pretrained_pth, on an ITOP fixture, 8
    steps over two epochs with PCK@10cm before and after each.  Returns
    the K1/K1b launches of (b) and (c)."""
    import re

    from hcmoco_tpu_torch.data.fixtures import make_seg_fixture
    from hcmoco_tpu_torch.downstream.a2j.data import make_itop_fixture
    from hcmoco_tpu_torch.downstream.a2j.train import main as a2j_main
    from hcmoco_tpu_torch.downstream.seg.train import main as seg_main
    from hcmoco_tpu_torch.core.config import HRNET_W18
    from hcmoco_tpu_torch.models.hrnet import HRNet, fused_sites

    check_downstream_kernels(card)
    bare = HRNet(HRNET_W18, 3, torch.float32)  # one HRNet-W18 per trainer
    sites, generic = fused_sites(bare), generic_sites(bare)
    del bare
    sd = torch.load(encoder2, map_location="cpu", weights_only=True)
    n_convs = sum(1 for k, v in sd.items()
                  if k.endswith(".weight") and v.dim() == 4)
    t0 = time.perf_counter()
    seg_root, seg_list = make_seg_fixture(
        os.path.join(tmp, "parsing"), os.path.join(tmp, "parsing_ntu"),
        n_frames=SEG_TRAIN + SEG_VAL, seed=7, h=KINECT_HW[0], w=KINECT_HW[1])
    lines = open(seg_list).read().split()
    lists = {}
    for name, part in (("train", lines[:SEG_TRAIN]),
                       ("val", lines[SEG_TRAIN:]),
                       ("test", lines[SEG_TRAIN:SEG_TRAIN + 2])):
        lists[name] = os.path.join(seg_root, f"{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(part) + "\n")
    itop = make_itop_fixture(os.path.join(tmp, "itop"), n_train=ITOP_TRAIN,
                             n_test=ITOP_TEST, seed=0)
    print(f"downstream trees: {SEG_TRAIN} + {SEG_VAL} Parsing-4K frames at "
          f"{KINECT_HW[0]}x{KINECT_HW[1]}, ITOP {ITOP_TRAIN} + {ITOP_TEST} "
          f"frames at 240x320, written in {time.perf_counter() - t0:.2f} s")

    os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    # the trainers run as their CLIs run: with torch's default, cuDNN's f32
    # convs in TF32 (A2J's f32 output convs with TF32 off took an FFT-based
    # complex GEMM, 223 of 297 device ms a step)
    torch.backends.cudnn.allow_tf32 = True
    try:
        steps = SEG_TRAIN // SEG_BATCH
        best = os.path.join(tmp, "parsing_best.pt")
        seg = ["--root", seg_root, "--modality", "depth", "--crop",
               str(SEG_CROP), "--width", "18", "--batch_size",
               str(SEG_BATCH), "--restore", best, "--seed", "0"]
        label = "parsing W18 473^2 bs40"
        r, out, seg_launches = downstream_run(
            card, label, seg_main, seg + [
                "--train_list", lists["train"], "--val_list", lists["val"],
                "--pretrained", encoder2, "--epochs", "1", "--max_steps",
                str(steps), "--print_freq", "4"],
            SEG_BATCH, steps, sites, generic)
        if f"=> loaded {n_convs} conv tensors from {encoder2}" not in out:
            raise AssertionError(f"{label}: the export's {n_convs} convs "
                                 "were not all loaded")
        miou = re.findall(r"epoch 1: mIoU (\d\.\d+)", out)
        if len(miou) != 1 or len(r.scores) != 1:
            raise AssertionError(f"{label}: no validation mIoU")
        del r
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        r, out = capture_stdout(lambda: seg_main(seg + [
            "--train_list", lists["train"], "--val_list", lists["test"],
            "--test_only", "--eval_flip", "--test_scales", "0.75,1.0"]))
        test_miou = re.findall(r"testval mIoU: (\d\.\d+)", out)
        if len(test_miou) != 1 or "=> restored weights" not in out:
            raise AssertionError(f"{label}: --test_only gave no mIoU")
        print(f"{label}: loaded {n_convs} conv tensors of stage 2's "
              f"encoder2; validation mIoU {miou[0]} on {SEG_VAL} frames; "
              f"--test_only (flip TTA, scales 0.75 and 1.0) from the best "
              f"weights on 2 frames: mIoU {test_miou[0]} in "
              f"{time.perf_counter() - t1:.1f} s [{card}]")
        del r
        torch.cuda.empty_cache()

        label = "A2J W18 288^2 bs12"
        a2j_steps = 8
        tr, te, btr, bte = itop
        r, out, a2j_launches = downstream_run(
            card, label, a2j_main, [
                "--train_dir", tr, "--test_dir", te, "--bndbox_train", btr,
                "--bndbox_test", bte, "--pretrained_pth", encoder2,
                "--width", "18", "--crop", str(A2J_CROP), "--batch_size",
                str(A2J_BATCH), "--epochs", "2", "--max_steps",
                str(a2j_steps), "--print_freq", "4", "--eval_first",
                "--seed", "0"],
            A2J_BATCH, a2j_steps, sites, generic)
        if f"=> loaded {n_convs} conv tensors from {encoder2}" not in out:
            raise AssertionError(f"{label}: the export's {n_convs} convs "
                                 "were not all loaded")
        pck = dict(re.findall(r"epoch (\d): PCK@10cm (\d\.\d+)", out))
        if not {"0", "1"} <= set(pck):
            raise AssertionError(f"{label}: PCK@10cm for epochs {pck}")
        print(f"{label}: loaded {n_convs} conv tensors of stage 2's "
              f"encoder2; PCK@10cm by epoch {pck} on {ITOP_TEST} frames "
              f"[{card}]")
        del r
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
        torch.backends.cudnn.allow_tf32 = False
    return [seg_launches, a2j_launches]


# ---- data parallelism: two ranks on one card over gloo ----------------------

# (label, arch, stage, global batch, steps, HCMOCO_CONVBN_FUSE, dtype)
DP_CASES = (("stage-1 HRNet", "HRNet", 1, 32, 3, True, "bfloat16"),
            ("stage-2 HRNet f32", "HRNet", 2, 16, 2, False, "float32"),
            ("stage-1 HRNetPN f32", "HRNetPN", 1, 16, 2, False, "float32"))
DP_LR = 0.03
# 2 ranks against one process on the same card: the loss and every loss
# metric of the first step within DP_METRIC[dtype] relative (of later
# steps within DP_LATER_METRIC: an SGD step at lr 0.03 carries the first
# step's rounding into the next forward, 5e-3 of loss_rgb2joint in f32).
# f32 (TF32 off): the state (dp_distance: the parameters' update and the
# BN running statistics relative in L2, the banks max abs) after the
# first step within twice the distance between two one-process runs that
# differ only in rounding, measured in the same run (at least
# DP_STATE_MIN): BN with nn.BatchNorm's two-pass variance against the
# ranks' E[x^2] - E[x]^2.  bf16: the update is rounding noise at
# initialisation (a one-process fused run and a plain one part by 0.97 of
# it), so what the first step sets deterministically is held instead
# (DP_SITE_TOL, relative in L2, worst site): at every fused site K1's
# all-reduced s1 and s2 and the normaliser N (exactly the one process's
# rows), the change K1b makes to the running mean and variance; and the
# BN statistics and banks after the first step.  The limits are about 3x
# a sound run's readings on an H100 (s1 3.5e-3, s2 6.0e-3, mean 3.5e-3,
# var 3.3e-2, stats 7.1e-5, banks 3.7e-3): normalising by a rank's rows,
# or missing the all-reduce, parts mean and var by 1 and s1 by 0.5.
DP_METRIC = {"float32": 1e-3, "bfloat16": 2e-2}
DP_LATER_METRIC = 2e-2
DP_STATE_MIN = {"update": 1e-3, "stats": 1e-6, "banks": 1e-5}
DP_SITE_TOL = {"s1": 1e-2, "s2": 2e-2, "mean": 1e-2, "var": 1e-1,
               "stats": 2e-4, "banks": 1.2e-2}
DP_TIMEOUT_S = 240
DP_WORLD = 2


@contextlib.contextmanager
def ranks_formula():
    """In this process, training BN layers normalise as the data-parallel
    ranks do (f32 sums of x and x^2, var = E[x^2] - E[x]^2, the
    all-reduce an identity) in a world of one."""
    from hcmoco_tpu_torch.parallel import batchnorm

    before = batchnorm.global_stats_active
    batchnorm.global_stats_active = lambda: True
    try:
        yield
    finally:
        batchnorm.global_stats_active = before


@contextlib.contextmanager
def record_fused_sites(sites: list):
    """Append, for every fused ConvBN site that runs inside, K1's channel
    sums as K1b takes them (all-reduced over the ranks), the rows N they
    cover, and the change K1b makes to the site's running mean and
    variance."""
    from hcmoco_tpu_torch.models import hrnet

    apply = hrnet.bn_apply_stats

    def recording(y, s1, s2, scale, bias, eps, running=None, n=None):
        rm, rv = running[0].clone(), running[1].clone()
        out = apply(y, s1, s2, scale, bias, eps, running, n)
        sites.append({"s1": s1.detach().cpu(), "s2": s2.detach().cpu(),
                      "n": n or y.shape[0],
                      "mean": (running[0] - rm).cpu(),
                      "var": (running[1] - rv).cpu()})
        return out

    hrnet.bn_apply_stats = recording
    try:
        yield
    finally:
        hrnet.bn_apply_stats = apply


def dp_cfg(arch: str, stage: int, bsz: int, dtype: str):
    """A DP case's config; scl_groups 0 (one SCL group a rank) is given
    as DP_WORLD groups, so that one process takes the ranks' groups."""
    from hcmoco_tpu_torch.core.config import RECIPES

    if stage == 1:
        cfg = make_cfg(arch=arch, batch_size=bsz, learning_rate=DP_LR,
                       compute_dtype=dtype)
    else:
        cfg = dataclasses.replace(RECIPES[STAGE2_RECIPES[arch]],
                                  batch_size=bsz, learning_rate=DP_LR,
                                  compute_dtype=dtype)
    return dataclasses.replace(cfg, scl_groups=cfg.scl_groups or DP_WORLD)


def dp_state_parts(state) -> dict:
    """The replicated state as three f32 vectors: parameters, BN running
    statistics, banks."""
    model = state.model
    return {"params": torch.cat([p.detach().float().reshape(-1)
                                 for p in model.parameters()]),
            "stats": torch.cat([b.detach().float().reshape(-1)
                                for b in model.buffers()
                                if b.is_floating_point()]),
            "banks": state.banks.detach().reshape(-1).clone()}


def dp_run(case: tuple, rank: int, size: int) -> dict:
    """One case's steps on this rank's rows of each global batch (all the
    rows in a world of one), through build_model, create_train_state and
    make_contrast_train_step; the draws from a generator seeded alike on
    every rank.  In a world of two, after every step the ranks'
    parameters, BN statistics and banks are gathered and must be equal
    bit for bit.  Returns the metrics, the state before and after the
    first step, the fused sites of the first step (record_fused_sites),
    the kernels' launches, the collectives a step and the step times."""
    import torch.distributed as dist

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.parallel import mesh
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    label, arch, stage, bsz, steps, fuse, dtype = case
    dev = torch.device("cuda")
    cfg = dp_cfg(arch, stage, bsz, dtype)
    if fuse:
        os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    else:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    state = create_train_state(cfg, model,
                               torch.Generator(dev).manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batches = []
    for i in range(steps):
        b = synthetic_contrast_batch(np.random.default_rng(40 + i), bsz,
                                     size=cfg.crop_size, num_joints=16,
                                     n_data=N_DATA)
        batches.append(to_device(mesh.shard_rows(b, rank, size), dev))
    before = {k: v.cpu() for k, v in dp_state_parts(state).items()}
    wrappers = (k1_wrappers() if fuse else
                {name: fn for name, (fn, _) in point_wrappers().items()}
                if arch == "HRNetPN" else {})
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    mm_bn_stats_cuda = k1_wrappers()["mm_bn_stats"]
    mm_bn_stats_cuda.generic_launches = 0
    mesh.STATS.update(calls=0, seconds=0.0)
    metrics, times, sites = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with (record_fused_sites(sites) if fuse and i == 0
              else contextlib.nullcontext()):
            m = step(state, b, torch.Generator(dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = {k: v.cpu() for k, v in dp_state_parts(state).items()}
        if size > 1:
            parts = dp_state_parts(state)
            flat = torch.cat(list(parts.values()))
            got = [torch.empty_like(flat) for _ in range(size)]
            dist.all_gather(got, flat)
            if not all(torch.equal(g, got[0]) for g in got):
                raise AssertionError(f"{label} step {i}: the ranks' "
                                     "parameters, BN statistics or banks "
                                     "differ")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if fuse:
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic": mm_bn_stats_cuda.generic_launches,
                    **launches}
    out = dict(metrics=metrics, before=before, first=first, sites=sites,
               launches=launches, step_s=times,
               calls=mesh.STATS["calls"] / steps,
               coll_s=mesh.STATS["seconds"] / steps)
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def dp_distance(b: dict, a: dict) -> dict:
    """How far run b's state after the first step lies from run a's
    (dp_run results): the parameters' update from the initial state and
    the BN statistics, relative in L2; the banks, max abs."""
    upd_a = a["first"]["params"] - a["before"]["params"]
    upd_b = b["first"]["params"] - b["before"]["params"]
    return {"update": float((upd_b - upd_a).norm() / upd_a.norm()),
            "stats": float((b["first"]["stats"] - a["first"]["stats"]).norm()
                           / a["first"]["stats"].norm()),
            "banks": float((b["first"]["banks"]
                            - a["first"]["banks"]).abs().max())}


def dp_sites(label: str, b: dict, a: dict) -> dict:
    """How far run b's fused sites lie from run a's in the first step
    (dp_run's `sites`, relative in L2, the worst site): K1's s1 and s2 as
    K1b took them, and K1b's change to the running mean and variance.
    Raises unless both ran the same sites, each normalised by the same N."""
    if not a["sites"] or len(b["sites"]) != len(a["sites"]):
        raise AssertionError(f"DP {label}: {len(b['sites'])} fused sites "
                             f"on 2 ranks, {len(a['sites'])} on one process")
    worst = dict.fromkeys(("s1", "s2", "mean", "var"), 0.0)
    for i, (sb, sa) in enumerate(zip(b["sites"], a["sites"])):
        if sb["n"] != sa["n"]:
            raise AssertionError(f"DP {label}: fused site {i} normalised by "
                                 f"N={sb['n']} on 2 ranks, {sa['n']} rows "
                                 "on one process")
        for k in worst:
            worst[k] = max(worst[k], float((sb[k] - sa[k]).norm()
                                           / sa[k].norm()))
    return worst


def dp_worker(out_path: str) -> int:
    """A rank of check_data_parallel: joins the gloo group that the
    parent's environment describes, on cuda:0 with the other rank, runs
    every DP case and writes its results to out_path."""
    from hcmoco_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, size = mesh.init_distributed(backend="gloo", timeout_s=DP_TIMEOUT_S)
    try:
        res = {case[0]: dp_run(case, rank, size) for case in DP_CASES}
        if rank:  # rank 0's states stand for both (checked equal)
            for r in res.values():
                for k in ("before", "first", "sites"):
                    r.pop(k)
        torch.save(res, out_path)
    finally:
        mesh.destroy()
    return 0


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def check_data_parallel(card: str) -> tuple:
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device) against one process on the same card: for each DP_CASES case,
    HRNet-W18 stage 1 at 320^2 in bf16 with K1/K1b at every fused site,
    stage 2 in f32, and HRNetPN (K2-K6, K56a/K56b) at 4096 points in f32,
    each rank holding half of the global batch.  First K1b against its
    plain version at a rank's rows normalised by the global batch's
    (K1B_DP_SHAPES).  The parent runs the one-process steps with the
    ranks' BN formula (ranks_formula), and the f32 cases once more with a
    change of rounding alone, nn.BatchNorm's two-pass variance (the
    floor), then two `chip_smoke.py --dp-rank` processes the same steps on
    their rows; a rank that fails, or does not finish in DP_TIMEOUT_S,
    fails the phase.  Holds the loss and metrics to the one-process run
    (DP_METRIC), the state after the first step to it (f32: the parameter
    update, BN statistics and banks within twice the floor; bf16: the
    fused sites' sums, N and running-stat changes, the BN statistics and
    banks, DP_SITE_TOL), the ranks to each other bit for bit after every
    step (in the ranks), and the kernels' launches a rank to the one
    process's; prints the collectives a step and the step times (two
    ranks on one card over gloo: not a multi-card figure).  Returns the
    K1/K1b and the point kernels' launches of both ranks, by JSON
    entry."""
    check_k1b(card, K1B_DP_SHAPES)
    # f32 means f32 on both sides (the ranks set the same in dp_worker)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ranks_formula():  # BN as the ranks normalise
        one = {case[0]: dp_run(case, 0, 1) for case in DP_CASES}
    # the f32 cases once more with nn.BatchNorm's own (two-pass) variance
    floor = {case[0]: dp_distance(dp_run(case, 0, 1), one[case[0]])
             for case in DP_CASES if case[6] == "float32"}
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_dp_", dir=build)
    procs = []
    try:
        port = str(free_port())
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        t1 = time.perf_counter()
        for r in range(DP_WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_WORLD),
                       LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(DP_WORLD),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 outs[r]], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        deadline = time.monotonic() + DP_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"DP rank {r} did not finish in "
                                     f"{DP_TIMEOUT_S} s")
            logs.append(log)
            if p.returncode != 0:
                raise AssertionError(f"DP rank {r} failed "
                                     f"({p.returncode}):\n{log[-4000:]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        t2 = time.perf_counter()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    k1_total, pn_total = {}, {}
    for case in DP_CASES:
        label, _, _, bsz, steps, fuse, dtype = case
        a, b = one[label], ranks[0][label]
        worst = 0.0
        for s, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
            if mb != ranks[1][label]["metrics"][s]:
                raise AssertionError(f"DP {label} step {s}: the ranks' "
                                     "metrics differ")
            for k, va in ma.items():
                vb = mb[k]
                if not np.isfinite(vb):
                    raise AssertionError(f"DP {label} step {s}: {k} {vb}")
                if "acc" in k:  # a count of hits: one flip is 1/bs
                    continue
                rel = abs(vb - va) / max(abs(va), 1e-3)
                worst = max(worst, rel)
                if rel > (DP_METRIC[dtype] if s == 0 else DP_LATER_METRIC):
                    raise AssertionError(f"DP {label} step {s}: {k} {vb} on "
                                         f"2 ranks, {va} on one process")
        dist = dp_distance(b, a)
        if dtype == "float32":
            tol = {k: max(2 * v, DP_STATE_MIN[k])
                   for k, v in floor[label].items()}
            ref = ("one process with nn.BatchNorm's two-pass variance: "
                   + ", ".join(f"{k} {v:.3g}"
                               for k, v in floor[label].items()))
        else:
            del dist["update"]
            dist.update(dp_sites(label, b, a))
            tol = DP_SITE_TOL
            ref = (f"{len(a['sites'])} fused sites, N equal to one "
                   "process's rows at each")
        if any(v > tol[k] for k, v in dist.items()):
            raise AssertionError(
                f"DP {label}: after the first step, 2 ranks against one "
                f"process: {dist}, tolerances {tol}")
        total = (k1_total if fuse else pn_total)
        for r in ranks:
            for name, n in r[label]["launches"].items():
                total[name] = total.get(name, 0) + n
        per_rank = [r[label]["launches"] for r in ranks]
        if per_rank[0] != per_rank[1] or per_rank[0] != a["launches"]:
            raise AssertionError(f"DP {label}: launches a rank {per_rank}, "
                                 f"one process {a['launches']}")
        print(f"DP {label} global bs{bsz}, {steps} steps, 2 ranks x "
              f"{bsz // 2} rows against one process: losses "
              + ", ".join(f"{mb['loss']:.5f}/{ma['loss']:.5f}"
                          for ma, mb in zip(a["metrics"], b["metrics"]))
              + f"; {dtype}: worst loss rel diff {worst:.3g}; after the "
              "first step "
              + ", ".join(f"{k} {v:.3g}" for k, v in dist.items())
              + f" ({ref}); tolerances {tol}; ranks equal bit for bit after every "
              f"step; launches a rank {per_rank[0]} [{card}]")
        print(f"DP {label}: step median {statistics.median(b['step_s']) * 1e3:.1f}"
              f" ms on each of 2 ranks ({bsz // 2} rows) against "
              f"{statistics.median(a['step_s']) * 1e3:.1f} ms for one "
              f"process ({bsz} rows); {b['calls']:.0f} collectives a step, "
              f"{b['coll_s'] * 1e3:.1f} ms a step in their calls (host "
              f"clock) -- two ranks on one card over gloo: not a multi-card "
              f"figure [{card}]")
    print(f"DP phase: one-process references {t1 - t0:.1f} s, two ranks "
          f"(start, build, {len(DP_CASES)} cases) {t2 - t1:.1f} s [{card}]")
    return k1_total, pn_total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_worker(sys.argv[2])
    t_start = time.perf_counter()
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
    small_stage2_check(card, "HRNet")
    # each main path is driven with the counts set to 0 just before it;
    # an entry's launches are the sum over the paths that run it
    k1_runs = [drive_slice(card), drive_stage2(card, "HRNet")]
    points = check_points(card)
    check_pts2depth(card)
    small_reference_check(card, "HRNetPN")
    small_stage2_check(card, "HRNetPN")
    check_build_refusal(card)
    pn_runs = [drive_pn(card), drive_stage2(card, "HRNetPN")]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_versatility_", dir=build)
    try:
        stage2_ckpt = os.path.join(tmp, "stage2.pt")
        t_cli = time.perf_counter()
        cli_k1, cli_pn = drive_cli(card, stage2_ckpt)
        print(f"CLI phase wall time: {time.perf_counter() - t_cli:.1f} s "
              f"[{card}]")
        t_vers = time.perf_counter()
        vers_k1 = versatility_phase(card, stage2_ckpt, tmp)
        print(f"versatility phase wall time: "
              f"{time.perf_counter() - t_vers:.1f} s [{card}]")
        t_down = time.perf_counter()
        # check_export wrote stage 2's depth encoder there
        down_k1 = downstream_phase(card, os.path.join(tmp, "encoder2.pth"),
                                   tmp)
        print(f"downstream phase wall time: "
              f"{time.perf_counter() - t_down:.1f} s [{card}]")
        t_dp = time.perf_counter()
        dp_k1, dp_pn = check_data_parallel(card)
        print(f"data-parallel phase wall time: "
              f"{time.perf_counter() - t_dp:.1f} s [{card}]")
    finally:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
        shutil.rmtree(tmp, ignore_errors=True)
    k1_runs += cli_k1 + vers_k1 + down_k1 + [dp_k1]
    pn_runs += cli_pn + [dp_pn]
    for entries, runs in ((k1, k1_runs), (points, pn_runs)):
        for entry, name in zip(entries, runs[0]):
            entry["launches"] = sum(r[name] for r in runs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: e[k] for k in keys} for e in k1 + points]
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "hcmoco_tpu"))
    if jax_mods:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{jax_mods[:10]}")
    print(f"smoke wall time: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
