"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the main paths'
shapes, and drives the train steps the port has through its entry points:

  * HCMoCo (HRNet-W18 x2 + SemGCN, 320^2 crops, bank NCE with K=16384,
    bs32) with HCMOCO_CONVBN_FUSE=1, the path of kernels K1 (its fast path
    at the layer1 sites, its generic path at the 62 fuse-layer sites), K1b
    and the BN-site kernels at the 530 other ConvBN sites (check_bn_sites
    holds them to their plain versions at the benchmark cell's shapes);
  * HRNetPN (HRNet-W18 + PointNet++ MSG on 4096 depth points + SemGCN,
    320^2, K=16384, bs64), the path of kernels K2-K6, then two more of its
    steps under torch.profiler (device ms per kernel class); K56a past
    8192 destinations, and both stages at 16384 points bs32;
  * recomputation in the backward (remat_phase, train/remat.py):
    HRNet-W18 stage 1 at bs32 fused without it, with remat_policy
    'conv_out' and with 'dots', and stage 2 with 'conv_out', each run
    equal bit for bit to the run without (deterministic algorithms), with
    its peak memory, host and device ms, K1/K1b launches and convolutions
    a step; stage 1 at the recipes' global batch of 224 on one card with
    'conv_out' and without; HRNetPN at 4096 points bs64 with pn_remat off
    and on (K5's forward once more at each scale of SA levels 0-1), and
    at 16384 points bs64 with it.  Its launches add to the kernels';
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
    and its resume; no NCCL kernel in its profile) and with --multihost
    under a SLURM job step's variables alone, and two ranks on the
    one card over gloo (`chip_smoke.py --dp-rank`, NCCL refusing two
    ranks on one device) against one process: HRNet-W18 stage 1 at
    320^2 bs32 fused (K1 and K1b on each rank's rows, K1's sums
    all-reduced), the same with remat (no more collectives a step),
    stage 2 and HRNetPN (K2-K6) at bs16 in f32; the ranks equal bit for
    bit after every step, the collectives a step and their host time.
    Both ranks' launches add to the kernels';
  * the baseline methods (ResNet encoders; no kernel of the port lies on
    their path, and the phase checks that it launches none): one float64
    step each of InsDis, PIRL, CMC (dual and the shared trunk), MoCo and
    CMCv2 on the card against the CPU; MoCov2 (K 65536), CMC on
    ImageNet-size banks (1281167 rows, the 'gather' NCE) and PIRL with
    its 9x64^2 patches at ResNet-50 224^2 bf16, each step's device ms,
    busy share, launches and peak memory; main_contrast MoCov2 on an
    ImageFolder tree of JPEGs, its --resume (the queue and pointer
    restored) and main_linear --pretrain; and MoCo and CMC-jigsaw on two
    `--dp-baseline-rank` ranks against one process;
  * the last modules (last_modules_phase): ResNeSt's avd pool's gradient
    in channels_last (ROADMAP F14), a small ResNeSt card vs CPU in
    float64 and in the dtypes users run (f32 through cuDNN, bf16),
    MoCov2 at ResNeSt-50, A2J's ResNet50, the grouped SemGCN and the
    model summaries.

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
from typing import Callable, Optional

import numpy as np
import torch

STEPS = 5
BATCH = 32
PN_BATCH = 64
N_DATA = 8192
# HRNetPN at 16384 points, past K56a's former 8192 destinations: npoints
# (16384, 4096, 1024, 256), at the largest power-of-two batch whose peak
# memory stays under ~60 GiB
PN_WIDE_POINTS = 16384
PN_WIDE_BATCH = 32
# K56a past 8192 destinations: (n_dest, sources a group, sources a sample);
# a group of 32 is K5's (a center's slots at SA0), of 3 K6's (a pixel's
# three rows at pts2depth, 320^2 = 102400 pixels)
CSR_WIDE = ((8193, 32, 8193 * 32), (16384, 32, 16384 * 32),
            (65537, 3, 307200), (102400, 3, 307200))
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


# The BN-site kernels' (R, C, site, NHWC shape) at the benchmark cell's
# batch of 224 at 320^2: the largest call (the stem's conv1) and branch 0,
# then a ragged R whose stream ends inside a chunk and inside a vector
BN_SITE_SHAPES = ((224 * 160 * 160, 64, "stem conv1 160x160",
                   (224, 160, 160, 64)),
                  (224 * 80 * 80, 18, "branch 0 80x80", (224, 80, 80, 18)),
                  (12800 + 37, 18, "ragged R, C=18", (1, 1, 12837, 18)))


def check_bn_sites(card: str) -> list:
    """The BN-site kernels (conv_out_bn's: forward sums, apply, backward
    sums, dx) against their plain versions on the same inputs, with and
    without the ReLU, at BN_SITE_SHAPES: out and dx equal bit for bit
    (the plain versions fed the kernels' sums), mean/var/rstd within 1 f32
    ulp, the running statistics within 2, the sums within 1e-5 of the f64
    sums of their terms' magnitudes and the same bits over two launches.
    Times each at the first two shapes beside the plain version and, as
    the library yardstick, the chain they replace (f32 cast, cuDNN's
    F.batch_norm, cast back, ReLU; the backward's threshold, cast,
    native_batch_norm_backward, cast back).  Returns the JSON entries at
    the first shape."""
    import torch.nn.functional as F

    from hcmoco_tpu_torch.ops import matmul_bn as mb

    g = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    errs = [0.0] * 4
    main = None
    for r, c, site, shape4 in BN_SITE_SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)

        y = (rnd(r, c) * 1.3 + 0.2).bfloat16()
        y[:, 0] = 0.5
        yd = y.double()
        scale = torch.rand((c,), generator=g, device=dev) + 0.5
        bias = rnd(c)
        dout = rnd(r, c).bfloat16()
        dm, dv = rnd(c) * 1e-3, rnd(c) * 1e-3
        s = mb.bn_sums_cuda(y)
        if not torch.equal(s, mb.bn_sums_cuda(y)):
            raise AssertionError(f"BN-site sums differ between launches at "
                                 f"{site}")
        errs[0] = max(errs[0], within(
            f"BN-site s1 at {site}", s[0], yd.sum(0),
            1e-5 * yd.abs().sum(0)))
        within(f"BN-site s2 at {site}", s[1], (yd * yd).sum(0),
               1e-5 * (yd * yd).sum(0))
        for relu in (False, True):
            at = f"{site}{', ReLU' if relu else ''}"
            rm0, rv0 = rnd(c), rnd(c).abs() + 0.5
            run_k = (rm0.clone(), rv0.clone(),
                     torch.zeros((), dtype=torch.int64, device=dev), 0.01)
            run_p = (rm0.clone(), rv0.clone(),
                     torch.zeros((), dtype=torch.int64, device=dev), 0.01)
            out, st = mb.bn_relu_fwd_cuda(y, s, scale, bias, 1e-5, relu,
                                          run_k)
            pout, pst = mb.bn_relu_fwd_plain(y, s, scale, bias, 1e-5, relu,
                                             run_p)
            if not torch.equal(out, pout):
                within(f"BN-site out at {at}", out, pout,
                       torch.zeros_like(pout, dtype=torch.float64))
            within(f"BN-site mean/var/rstd at {at}", st, pst,
                   f32_ulp(torch.maximum(st.abs(), pst.abs())))
            for name, a, b in (("running_mean", run_k[0], run_p[0]),
                               ("running_var", run_k[1], run_p[1])):
                within(f"BN-site {name} at {at}", a, b,
                       2 * f32_ulp(torch.maximum(a.abs(), b.abs())))
            if not int(run_k[2]) == int(run_p[2]) == 1:
                raise AssertionError(f"BN-site num_batches_tracked at {at}")
            sums = mb.bn_relu_bwd_sums_cuda(dout, y, pst, scale, bias, relu)
            if not torch.equal(sums, mb.bn_relu_bwd_sums_cuda(
                    dout, y, pst, scale, bias, relu)):
                raise AssertionError(f"BN-site backward sums differ between "
                                     f"launches at {at}")
            d = y.float() - pst[0]
            gm = dout.float()
            if relu:
                gm = torch.where(d * (pst[2] * scale) + bias > 0, gm, 0.0)
            terms = gm * (d * pst[2])
            for i, name, ref, mag in (
                    (0, "dbias", gm.double().sum(0), gm.double().abs().sum(0)),
                    (1, "dscale", terms.double().sum(0),
                     terms.double().abs().sum(0))):
                errs[2] = max(errs[2], within(f"BN-site {name} at {at}",
                                              sums[i], ref, 1e-5 * mag))
            dx = mb.bn_relu_bwd_dx_cuda(dout, y, pst, scale, bias, sums, relu,
                                        None, dm, dv)
            pdx = mb.bn_relu_bwd_dx_plain(dout, y, pst, scale, bias, sums,
                                          relu, None, dm, dv)
            if not torch.equal(dx, pdx):
                within(f"BN-site dx at {at}", dx, pdx,
                       torch.zeros_like(pdx, dtype=torch.float64))
            if not relu or shape4[0] == 1:
                continue
            calls = (
                (lambda: mb.bn_sums_cuda(y), lambda: mb.bn_sums_plain(y)),
                (lambda: mb.bn_relu_fwd_cuda(y, s, scale, bias, 1e-5, True,
                                             run_k),
                 lambda: mb.bn_relu_fwd_plain(y, s, scale, bias, 1e-5, True,
                                              run_p)),
                (lambda: mb.bn_relu_bwd_sums_cuda(dout, y, pst, scale, bias,
                                                  True),
                 lambda: mb.bn_relu_bwd_sums_plain(dout, y, pst, scale, bias,
                                                   True)),
                (lambda: mb.bn_relu_bwd_dx_cuda(dout, y, pst, scale, bias,
                                                sums, True),
                 lambda: mb.bn_relu_bwd_dx_plain(dout, y, pst, scale, bias,
                                                 sums, True)))
            times = [(cuda_ms(k), cuda_ms(p)) for k, p in calls]
            # the chain the kernels replace, on the same channels_last
            # tensors: cast, cuDNN BN in f32, cast back, ReLU; and back
            y4 = y.view(shape4).permute(0, 3, 1, 2)
            d4 = dout.view(shape4).permute(0, 3, 1, 2)
            rm, rv = run_k[0].clone(), run_k[1].clone()
            lib_f = cuda_ms(lambda: F.relu(F.batch_norm(
                y4.float(), rm, rv, scale, bias, True, 0.01, 1e-5).to(
                    torch.bfloat16)))
            y4f = y4.float()
            out4, smean, sinv = torch.ops.aten.native_batch_norm(
                y4f, scale, bias, rm, rv, True, 0.01, 1e-5)
            out4 = F.relu(out4.to(torch.bfloat16))
            lib_b = cuda_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                torch.ops.aten.threshold_backward(d4, out4, 0).float(), y4f,
                scale, rm, rv, smean, sinv, True, 1e-5,
                [True, True, True])[0].to(torch.bfloat16))
            rc = r * c
            # bf16 (R, C) tensors read and written once
            bnds = (bound(2 * rc + 8 * c, 2 * rc, F32_OPS_S),
                    bound(4 * rc + 36 * c, 4 * rc, F32_OPS_S),
                    bound(4 * rc + 36 * c, 8 * rc, F32_OPS_S),
                    bound(6 * rc + 36 * c, 8 * rc, F32_OPS_S))
            names = ("fwd sums", "apply", "bwd sums", "dx")
            print(f"BN-site R={r} C={c} ({site}, ReLU): " + ", ".join(
                f"{n} {t[0]:.4f} ms (bound {b['bound_ms']:.4f}, "
                f"{100 * b['bound_ms'] / t[0]:.1f}%; plain {t[1]:.4f})"
                for n, t, b in zip(names, times, bnds))
                + f"; the chain replaced: forward {lib_f:.4f} ms, backward "
                f"{lib_b:.4f} ms; kernels forward "
                f"{times[0][0] + times[1][0]:.4f}, backward "
                f"{times[2][0] + times[3][0]:.4f} [{card}]")
            if main is None:
                main = list(zip(times, bnds, (None, lib_f, None, lib_b)))
        print(f"BN-site R={r} C={c} ({site}): out and dx equal the plain "
              f"versions bit for bit, sums within 1e-5 and the same over two "
              f"launches, with and without ReLU [{card}]")
    names = ("bn_sums (BN-site forward sums)",
             "bn_relu_fwd (BN-site apply + ReLU + running stats)",
             "bn_relu_bwd_sums (BN-site dbias, dscale)",
             "bn_relu_bwd_dx (BN-site dx)")
    rep = "none: hcmoco_tpu/models/hrnet.py:38 _bn_train_apply (XLA-fused)"
    return [kernel_entry(n, "matmul_bn.cu", rep, err, t[0], t[1], bnd, lib)
            for n, err, (t, bnd, lib) in zip(names, errs, main)]


def bn_site_wrappers() -> dict:
    """conv_out_bn's kernel wrappers, in the order of check_bn_sites'
    entries; each launches once per BN site (models/hrnet.py::bn_sites)
    and training step."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    return {"bn_sums": mb.bn_sums_cuda, "bn_relu_fwd": mb.bn_relu_fwd_cuda,
            "bn_relu_bwd_sums": mb.bn_relu_bwd_sums_cuda,
            "bn_relu_bwd_dx": mb.bn_relu_bwd_dx_cuda}


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


def check_csr_wide(card: str) -> None:
    """K56a past 8192 destinations (CSR_WIDE), on two samples: one of
    random indices, one of a zero cloud's (K5: every center's slots
    0..31; K6: every pixel's rows 0, 1 and 2).  start and src equal to the
    plain version on the card, then K5's or K6's backward (K56a + K56b)
    bit for bit equal to the plain version on the CPU and over two
    launches; K56a's time."""
    from hcmoco_tpu_torch.ops import point_gather as pg

    g = torch.Generator(device="cuda").manual_seed(12)
    for n_dest, per, r in CSR_WIDE:
        idx = torch.randint(0, n_dest, (2, r), generator=g, device="cuda",
                            dtype=torch.int32)
        idx[1] = torch.arange(r, device="cuda", dtype=torch.int32) % per
        check_csr(f"n_dest {n_dest}", idx, n_dest)
        if per == 32:
            gidx = idx.view(2, r // per, per)
            gout = torch.randn((2, r // per, per, 32), generator=g,
                               device="cuda").bfloat16()
            scatter_exact(f"K5 bwd at n_dest {n_dest}",
                          lambda: pg.group_rows_bwd_cuda(gout, gidx, n_dest),
                          pg.group_rows_bwd_plain(gout.cpu(), gidx.cpu(),
                                                  n_dest))
            what = "K5 bwd (bf16, C 32)"
        else:
            ii = idx.view(2, r // 3, 3)
            w = torch.rand((2, r // 3, 3), generator=g, device="cuda") + 1e-3
            w = w / w.sum(-1, keepdim=True)
            gout = torch.randn((2, r // 3, 128), generator=g, device="cuda")
            scatter_exact(f"K6 bwd at n_dest {n_dest}",
                          lambda: pg.interpolate_rows_bwd_cuda(gout, ii, w,
                                                               n_dest),
                          pg.interpolate_rows_bwd_plain(gout.cpu(), ii.cpu(),
                                                        w.cpu(), n_dest))
            what = "K6 bwd (f32, C 128)"
        ms = cuda_ms(lambda: pg.dest_csr_cuda(idx, n_dest), iters=5)
        print(f"K56a at n_dest {n_dest} (2 x {r} sources, "
              f"{-(-n_dest // 8192)} windows of destinations; a random and "
              f"a zero-cloud sample): start and src equal to the plain "
              f"version, {what} after it equal to the CPU's bit for bit and "
              f"over two launches; {ms:.4f} ms [{card}]")
        del idx, gout


def check_wide_points(card: str, batch_size: int = PN_WIDE_BATCH,
                      n_points: int = PN_WIDE_POINTS) -> None:
    """K56a at the 16384-point path's two calls past 8192 destinations, on
    a synthetic batch with zero clouds: SA0's K5 backward (scale 1, the
    ball query of the cloud around itself, 32 slots) and pts2depth's K6
    backward (every pixel of the 320^2 crop against the cloud).  K3 and K4
    equal to their plain versions there, K56a's index equal, the
    backwards' rows of the last valid and the last zero cloud equal to the
    CPU's; K56a's and the backwards' times against the plain versions and
    K56a's bound (idx read once, src and start written once)."""
    from hcmoco_tpu_torch.models.pointnet2_model import NSAMPLE, RADIUS
    from hcmoco_tpu_torch.ops import ball_query as bq
    from hcmoco_tpu_torch.ops import point_gather as pg
    from hcmoco_tpu_torch.ops.point_ops import interpolation_weights

    b, n = batch_size, n_points
    g = torch.Generator(device="cuda").manual_seed(13)
    cloud, all_pts, valid = depth_clouds("cuda", b, 320, n)
    r_, s_ = RADIUS[0][1], NSAMPLE[0][1]
    gidx = bq.ball_query_cuda(cloud, cloud, r_, s_)
    if not torch.equal(gidx, bq.ball_query_plain(cloud, cloud, r_, s_)):
        raise AssertionError(f"K3 at sa0.1 with {n} points: indices off")
    dist, idx = check_three_nn(f"pts2depth {n} points", all_pts, cloud,
                               ~valid)
    w = interpolation_weights(dist)
    del dist
    calls = (("SA0's K5 bwd", gidx.view(b, -1), 32, torch.bfloat16),
             ("pts2depth's K6 bwd", idx.view(b, -1), 128, torch.float32))
    for label, idx2, c, dt in calls:
        rows = idx2.shape[1]
        check_csr(f"{label} at {n} points", idx2, n)
        if c == 32:
            gout = torch.randn((b, n, s_, c), generator=g,
                               device="cuda").to(dt)

            def bwd():
                return pg.group_rows_bwd_cuda(gout, gidx, n)

            def bwd_cpu(k):
                return pg.group_rows_bwd_plain(gout[k:k + 1].cpu(),
                                               gidx[k:k + 1].cpu(), n)

            def plain():
                return pg.group_rows_bwd_plain(gout, gidx, n)
        else:
            gout = torch.randn((b, all_pts.shape[1], c), generator=g,
                               device="cuda").to(dt)

            def bwd():
                return pg.interpolate_rows_bwd_cuda(gout, idx, w, n)

            def bwd_cpu(k):
                return pg.interpolate_rows_bwd_plain(
                    gout[k:k + 1].cpu(), idx[k:k + 1].cpu(),
                    w[k:k + 1].cpu(), n)

            def plain():
                return pg.interpolate_rows_bwd_plain(gout, idx, w, n)
        grad = bwd()
        if not torch.equal(grad, bwd()):
            raise AssertionError(f"{label} at {n} points: two launches "
                                 "differ")
        for sel in (valid, ~valid):
            k = int(torch.nonzero(sel)[-1])
            if not torch.equal(grad[k:k + 1].cpu(), bwd_cpu(k)):
                raise AssertionError(f"{label} at {n} points, sample {k}: "
                                     "differs from the CPU's")
        del grad
        csr = cuda_ms(lambda: pg.dest_csr_cuda(idx2, n), iters=5)
        csr_plain = cuda_ms(lambda: pg.dest_csr_plain(idx2, n), iters=2,
                            warmup=1)
        bnd = bound(b * rows * 8 + b * (n + 1) * 4, 0, F32_OPS_S)
        t_bwd = cuda_ms(bwd, iters=5)
        t_plain = cuda_ms(plain, iters=2, warmup=1)
        print(f"K56a at {label}, {n} points bs{b} ({b} x {rows} sources -> "
              f"{n} rows, {-(-rows // 8192)} tiles x {-(-n // 8192)} "
              f"windows a sample): {csr:.4f} ms, plain {csr_plain:.4f} ms, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"{bnd['bound_ms'] / csr:.3f} of it; the backward (K56a + "
              f"K56b, {str(dt)[6:]}, C {c}) {t_bwd:.4f} ms, plain "
              f"{t_plain:.4f} ms; index and the last valid and zero "
              f"cloud's rows equal [{card}]")
        del gout


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
                cuda_ms(lambda: fp.fps_plain(xyz, m), iters=3, warmup=1),
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


def small_reference_check(card: str, arch: str = "HRNet",
                          n_points: int = 64, size: int = 32,
                          batch_size: int = 6) -> None:
    """One f32 train step of the tiny (width-4, `size`^2, 32 by default,
    bs6; HRNetPN: `n_points`, 64 by default, where 9000 takes K56a past
    8192 destinations at SA0) model on the card vs the same step on the
    CPU (the CPU path is held
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

    bs = batch_size
    cfg = make_cfg(arch=arch, width=4, crop_size=size, batch_size=bs,
                   nce_k=15, compute_dtype="float32", pn_num_points=n_points)
    rng = np.random.default_rng(1)
    batch = synthetic_contrast_batch(rng, bs, size=size, n_data=64)
    if arch == "HRNet":
        # depth of every sample non-zero: the synthetic all-zero depth
        # samples leave the tiny depth encoder too ill-conditioned to
        # compare
        batch["rgbd"] = (rng.standard_normal((bs, size, size, 6))
                         * 0.5).astype(np.float32)
    else:
        batch["pts_u"] = rng.random((bs, n_points), dtype=np.float32)
        if not 0 < int(batch["use_depth"].sum()) < bs:
            raise AssertionError("the batch must hold valid and zero clouds")
    counts = sample_negative_counts(torch.Generator().manual_seed(2), bs, 64,
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
    what = f"{arch} {size}^2 bs{bs}" + (f" {n_points} points"
                                  if arch == "HRNetPN" else "")
    print(f"tiny f32 {what} step, card vs cpu: loss {l_got['loss']:.6f} vs "
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


def drive_slice(card: str) -> tuple:
    """Stage-1 W18 320^2 bs32 train steps through the user entry points,
    HCMOCO_CONVBN_FUSE=1, under torch.profiler (CUDA activity); returns
    K1's (all and generic-path) and K1b's launches during the steps, in
    the order of their JSON entries, and the BN-site kernels'
    (bn_site_wrappers): the profiler's kernel records, since the
    encoders replay CUDA graphs from the second step."""
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.ops import matmul_bn as mb
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import (bn_sites, fused_sites,
                                               set_convbn_fuse)
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
    other = bn_sites(model.encoder1) + bn_sites(model.encoder2)

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
    site_wrappers = bn_site_wrappers()
    for fn in (*wrappers.values(), *site_wrappers.values()):
        fn.launches = 0
    mb.mm_bn_stats_cuda.generic_launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steady, metrics = timed_steps(step, state, batch, gen, STEPS,
                                      "stage-1 HRNet", card)
    rows = device_rows(prof)
    host = {name: fn.launches for name, fn in wrappers.items()}
    host.update({name: fn.launches for name, fn in site_wrappers.items()},
                generic=mb.mm_bn_stats_cuda.generic_launches)
    replays = graph_replays(model)
    if replays != {"encoder1": (STEPS - 1,) * 2,
                   "encoder2": (STEPS - 1,) * 2}:
        raise AssertionError(f"stage-1 HRNet: CUDA graph replays {replays}"
                             f", expected {STEPS - 1} of each encoder's "
                             f"forward and backward")
    launches = traced_launches(rows, wrappers)
    for name, n in launches.items():
        if n != sites * STEPS:
            raise AssertionError(f"{name} launched {n} times in {STEPS} "
                                 f"steps, expected {sites} sites x {STEPS}")
    site_launches = traced_launches(rows, site_wrappers)
    for name, n in site_launches.items():
        if n != other * STEPS:
            raise AssertionError(f"{name} launched {n} times in {STEPS} "
                                 f"steps, expected {other} BN sites x "
                                 f"{STEPS}")
    n_gen = traced_launches(rows, ["mm_bn_stats generic"])[
        "mm_bn_stats generic"]
    if n_gen != generic * STEPS:
        raise AssertionError(f"K1's generic path launched {n_gen} times in "
                             f"{STEPS} steps, expected {generic} sites x "
                             f"{STEPS}")
    launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                "mm_bn_stats generic": n_gen, **launches}
    print("losses per step: " + ", ".join(f"{m['loss']:.5f}"
                                          for m in metrics))
    print(f"W18 320^2 bs{BATCH} fused stage-1 step (CUDA activity traced):"
          f" median {steady * 1e3:.2f} ms = {BATCH / steady:.2f} samples/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"K1/K1b launches {launches}, each {sites} sites x {STEPS} steps "
          f"({generic} sites on K1's generic path); BN-site launches "
          f"{site_launches}, each {other} sites x {STEPS} steps (the "
          f"profiler's kernel records); CUDA graph replays (forward, "
          f"backward) {replays}; the wrappers' host launches {host} "
          f"[{card}]")
    return launches, site_launches


def check_build_wide(card: str) -> None:
    """build_model takes pn_num_points = PN_WIDE_POINTS on the card (K56a
    ranks any number of destinations): the model's four SA levels sample
    (16384, 4096, 1024, 256) points."""
    from hcmoco_tpu_torch.models.build import build_model

    cfg = make_cfg(arch="HRNetPN", batch_size=PN_WIDE_BATCH,
                   pn_num_points=PN_WIDE_POINTS)
    model = build_model(cfg, device="cuda")
    npoints = [sa.npoint for sa in model.encoder2.SA_modules]
    want = [PN_WIDE_POINTS // 4 ** k for k in range(4)]
    if npoints != want or next(model.parameters()).device.type != "cuda":
        raise AssertionError(f"build_model at pn_num_points="
                             f"{PN_WIDE_POINTS} on the card: npoints "
                             f"{npoints}, expected {want}")
    print(f"build_model takes pn_num_points={PN_WIDE_POINTS} on the card: "
          f"SA npoints {npoints} [{card}]")
    del model


def point_wrappers() -> dict:
    """K2-K6's wrappers and the K56a/K56b ones under K5's and K6's
    backwards, by JSON entry in check_points' order, with the launches each
    makes in one HRNetPN train step."""
    from hcmoco_tpu_torch.ops import ball_query, fps, point_gather, three_nn

    return {"fps": (fps.fps_cuda, 3),
            "ball_query": (ball_query.ball_query_cuda, 8),
            "three_nn": (three_nn.three_nn_cuda, 4),
            # each SA scale's coordinates (8) and levels 1-3's projected
            # features (6); only the features take a backward
            "group_rows fwd": (point_gather.group_rows_cuda, 14),
            "group_rows bwd": (point_gather.group_rows_bwd_cuda, 6),
            "interpolate_rows fwd": (point_gather.interpolate_rows_cuda, 4),
            "interpolate_rows bwd": (point_gather.interpolate_rows_bwd_cuda,
                                     4),
            "dest_csr": (point_gather.dest_csr_cuda, 10),
            "segment_rows_sum": (point_gather.segment_rows_sum_cuda, 10)}


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
    for label, prefix in (("K56a (csr_*)", "csr_"),
                          ("K56b (segsum_*)", "segsum_")):
        ms = sum(us for name, (us, _) in by_name.items()
                 if prefix in name) / 1e3
        if ms:
            print(f"  [kernel] {ms / n:9.3f} ms/step  {label}")
    top = names[:20]
    for name in top + [k for k in members.get("K2-K6 point kernels", [])
                       + members.get("other", [])[:5] if k not in top]:
        us, calls = by_name[name]
        print(f"  {us / 1e3 / n:9.3f} ms/step {calls // n:6d} calls/step  "
              f"{name[:90]}")
    return total, total / (median_s * 1e3)


def drive_pn(card: str, n_points: int = 4096,
             batch_size: int = PN_BATCH) -> dict:
    """Stage-1 HRNetPN W18 320^2 train steps, bs64 with 4096 points by
    default, through the user entry points (ConvBN fuse at its default,
    off); returns each point kernel's launches during the steps."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = make_cfg(arch="HRNetPN", batch_size=batch_size,
                   pn_num_points=n_points)
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)  # drive_slice set it
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), batch_size, size=cfg.crop_size,
        num_joints=16, n_data=N_DATA), dev)
    if not (0 < int(batch["use_depth"].sum()) < batch_size):
        raise AssertionError("the batch must hold valid and zero clouds")
    wrappers = point_wrappers()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in wrappers.values():
        fn.launches = 0
    steady, metrics = timed_steps(step, state, batch, gen, STEPS,
                                  f"stage-1 HRNetPN {n_points} points", card)
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    for name, (_, per_step) in wrappers.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{STEPS} steps, expected {per_step} x "
                                 f"{STEPS}")
    print("HRNetPN losses per step: "
          + ", ".join(f"{m['loss']:.5f}" for m in metrics))
    print(f"HRNetPN W18 320^2 bs{batch_size} {n_points}-point stage-1 step: "
          f"median {steady * 1e3:.2f} ms = {batch_size / steady:.2f} "
          f"samples/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} in {STEPS} steps [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    del model, state, step, batch
    torch.cuda.empty_cache()
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


def drive_stage2(card: str, arch: str, n_points: int = 4096,
                 batch_size: Optional[int] = None) -> dict:
    """Stage-2 train steps (mem='bank+jointspri3d') of the reference's
    second-stage recipe for `arch` through the user entry points: HRNet-W18
    at bs32 with HCMOCO_CONVBN_FUSE=1 (K1, K1b), or HRNetPN at bs64 with
    4096 points by default (`batch_size`, `n_points`; K2-K6, K56a/K56b,
    and pts2depth's K4, K6 and K6 bwd).
    320^2, K=16384, 400 soft-Pri3D pixels an image drawn by the step, T =
    0.07.  Prints every stage-2 metric a step, the median step, samples/s,
    peak memory and a profile; returns each kernel wrapper's launches in
    the steps, in the order of its JSON entries, after checking them
    against the expected count a step.  The steps run under
    torch.profiler (CUDA activity): the encoders replay CUDA graphs, so
    K1's and K1b's launches are its kernel records; the point kernels'
    are their wrappers' counts (the point branch runs eagerly)."""
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.core.config import RECIPES
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.ops import matmul_bn as mb
    from hcmoco_tpu_torch.train.contrast_step import (STAGE2_METRICS,
                                                      make_contrast_train_step)
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    bsz = batch_size or (BATCH if arch == "HRNet" else PN_BATCH)
    cfg = dataclasses.replace(RECIPES[STAGE2_RECIPES[arch]], batch_size=bsz)
    if arch == "HRNetPN":
        cfg = dataclasses.replace(cfg, pn_num_points=n_points)
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
    label = f"stage-2 {arch}" + (f" {n_points} points"
                                 if arch == "HRNetPN" else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in wrappers.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steady, metrics = timed_steps(step, state, batch, gen, STEPS, label,
                                      card)
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    host = dict(launches)
    replays = graph_replays(model)
    if arch == "HRNet":
        rows = device_rows(prof)
        launches = traced_launches(rows, launches)
        host["generic"] = mb.mm_bn_stats_cuda.generic_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, (_, per_step) in wrappers.items():
        if launches[name] != per_step * STEPS:
            raise AssertionError(f"{label}: {name} launched {launches[name]}"
                                 f" times in {STEPS} steps, expected "
                                 f"{per_step} x {STEPS}")
    if arch == "HRNet":
        n_gen = traced_launches(rows, ["mm_bn_stats generic"])[
            "mm_bn_stats generic"]
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
          f"{cfg.pri3d_num_samples_per_image} pixels/image step (CUDA "
          f"activity traced): median {steady * 1e3:.2f} ms = "
          f"{bsz / steady:.2f} samples/s; peak memory {peak:.2f} GiB; "
          f"launches {launches} in {STEPS} steps; CUDA graph replays "
          f"(forward, backward) {replays}; the wrappers' host launches "
          f"{host} [{card}]")
    profile_steps(card, step, state, batch, gen, steady)
    del model, state, step, batch
    torch.cuda.empty_cache()
    return launches


# ---- recomputation in the backward (TrainConfig.remat, pn_remat) ---------

# train/remat.py: the HRNet step's model forward under remat_policy
# 'conv_out' (every conv output saved, K1's y and sums too) or 'dots' (the
# 2-D matmuls alone), and HRNetPN's SA levels 0-1 under pn_remat.  Steps
# of each run from one state and batch, under cuDNN's and torch's
# deterministic algorithms, held to the run without recomputation
REMAT_STEPS = 2
# the first-stage recipes' global batch, on one card
REMAT_BIG_BATCH = 224
REMAT_BIG_STEPS = 3
# where two runs without recomputation part, a recomputed run may part
# from them by this much of each tensor's largest magnitude
REMAT_RTOL = 1e-6


def remat_parts(state) -> dict:
    """What a step writes: parameters, their gradients, BN running
    statistics and num_batches_tracked, banks (clones, on the card)."""
    model = state.model
    out = {f"param {k}": p.detach().clone()
           for k, p in model.named_parameters()}
    out.update({f"grad {k}": p.grad.detach().clone()
                for k, p in model.named_parameters() if p.grad is not None})
    out.update({f"buffer {k}": b.detach().clone()
                for k, b in model.named_buffers()})
    out["banks"] = state.banks.detach().clone()
    return out


def remat_gap(a: dict, b: dict) -> tuple:
    """(largest difference relative to the tensor's largest magnitude,
    its name) between two remat_parts + metrics results; (0, '') when
    they are equal bit for bit."""
    if a["parts"].keys() != b["parts"].keys():
        raise AssertionError("the runs wrote different tensors")
    worst, where = 0.0, ""
    for k, t in a["parts"].items():
        u = b["parts"][k]
        if torch.equal(t, u):
            continue
        d = float((t.double() - u.double()).abs().max()
                  / max(float(t.double().abs().max()), 1e-30))
        if d >= worst:
            worst, where = max(d, 1e-300), k
    for s, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        for k, v in ma.items():
            if mb[k] != v:
                d = abs(mb[k] - v) / max(abs(v), 1e-30)
                if d >= worst:
                    worst, where = max(d, 1e-300), f"step {s} {k}"
    return worst, where


def conv_rows(prof) -> dict:
    """Forward and backward convolutions in a profiled run, from its CPU
    op rows."""
    from torch.autograd import DeviceType

    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU]
    return {"fwd": names.count("aten::convolution"),
            "bwd": names.count("aten::convolution_backward")}


def fresh_state(cfg):
    """build_model and create_train_state of cfg on the card from fixed
    seeds: every call gives the same weights and banks."""
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    return create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                              n_data=N_DATA, steps_per_epoch=100)


def remat_run(card: str, label: str, cfg, batch, wrappers: dict,
              steps: int = REMAT_STEPS) -> dict:
    """`steps` steps of cfg's train step from fresh_state(cfg) on `batch`
    under deterministic algorithms (the generators seeded alike in every
    run), then two timed steps and one profiled step with them off.
    Returns the metrics and remat_parts after the deterministic steps,
    the wrappers' launches over all the steps, their count, the peak
    memory and the median host ms of the timed steps, the device ms and
    convolutions of the profiled step, and the ops that torch warned
    have no deterministic implementation."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step

    dev = torch.device("cuda")
    st = fresh_state(cfg)
    step = make_contrast_train_step(cfg, st.model, steps_per_epoch=100)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    k1 = k1_wrappers()["mm_bn_stats"]
    k1.generic_launches = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    metrics = []
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for i in range(steps):
                m = step(st, batch, torch.Generator(dev).manual_seed(10 + i))
                metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
    for s, mm in enumerate(metrics):
        if not all(np.isfinite(v) for v in mm.values()):
            raise AssertionError(f"{label} step {s}: non-finite {mm}")
    nondet = sorted({str(w.message).split(" ")[0] for w in seen
                     if "deterministic implementation" in str(w.message)})
    parts = remat_parts(st)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        step(st, batch, torch.Generator(dev).manual_seed(20 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(st, batch, torch.Generator(dev).manual_seed(30))
        torch.cuda.synchronize()
    device_ms = sum(us for _, us in device_rows(prof)) / 1e3
    n = steps + 3
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if "mm_bn_stats" in launches:
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic": k1.generic_launches, **launches}
    out = dict(metrics=metrics, parts=parts, launches=launches, steps=n,
               peak=peak, host_ms=statistics.median(times) * 1e3,
               device_ms=device_ms, convs=conv_rows(prof), nondet=nondet)
    del st, step
    torch.cuda.empty_cache()
    return out


def remat_case(card: str, label: str, cfg, variants: dict, batch,
               wrappers: dict, expect: dict, rerun_convs: int = 0,
               off_twice: bool = False) -> list:
    """One batch, each of `variants` (name -> TrainConfig fields; 'off' is
    no recomputation, run twice with `off_twice`) through remat_run;
    every recomputed run is held to 'off': equal bit for bit unless two
    'off' runs part, then within REMAT_RTOL, naming the ops torch found
    no deterministic implementation of.  expect: name -> {wrapper: launches a
    step}; under 'conv_out' the forward convolutions a step are those
    without recomputation + `rerun_convs` (convs outside the ConvBN sites,
    which the policy, as JAX's, does not keep), the backward's the same.
    Prints each run's peak memory, host and device ms a step, launches a
    step and convolutions a step; returns each run's launches (every step
    of it)."""
    runs = {}
    for name in (["off"] + ["off again"] * off_twice
                 + [v for v in variants if v != "off"]):
        kw = variants.get(name, variants["off"])
        runs[name] = remat_run(card, f"{label} {name}",
                               dataclasses.replace(cfg, **kw), batch,
                               wrappers)
    floor, floor_at = (remat_gap(runs["off"], runs["off again"])
                       if off_twice else (0.0, ""))
    for name, r in runs.items():
        per_step = {k: v / r["steps"] for k, v in r["launches"].items()}
        want = expect.get(name.replace(" again", ""), {})
        for k, v in want.items():
            if per_step[k] != v:
                raise AssertionError(f"{label} {name}: {k} launched "
                                     f"{per_step[k]} times a step, expected "
                                     f"{v}")
        if name.startswith("off"):
            verdict = ""
        else:
            gap, at = remat_gap(runs["off"], r)
            if floor == 0.0 and gap != 0.0:
                raise AssertionError(
                    f"{label} {name}: parts from the run without "
                    f"recomputation by {gap:.3g} at {at}, where two runs "
                    "without it are equal bit for bit")
            if gap > REMAT_RTOL:
                raise AssertionError(
                    f"{label} {name}: {gap:.3g} at {at} from the run "
                    f"without recomputation, above {REMAT_RTOL}")
            verdict = ("; loss, gradients, parameters, running statistics "
                       "and banks equal bit for bit to 'off'" if gap == 0.0
                       else f"; largest difference from 'off' {gap:.3g} "
                       f"relative at {at} (two 'off' runs: {floor:.3g} at "
                       f"{floor_at}; ops without a deterministic "
                       f"implementation: {r['nondet']}), within "
                       f"{REMAT_RTOL}")
        print(f"remat {label} {name}: peak {r['peak']:.2f} GiB, host "
              f"{r['host_ms']:.1f} ms and device {r['device_ms']:.1f} ms a "
              f"step, convolutions a step {r['convs']['fwd']} forward "
              f"{r['convs']['bwd']} backward (profiler rows), launches a "
              f"step {per_step}; losses "
              + ", ".join(f"{m['loss']:.6f}" for m in r["metrics"])
              + verdict + f" [{card}]")
    if floor:
        print(f"remat {label}: two runs without recomputation part by "
              f"{floor:.3g} at {floor_at}; ops without a deterministic "
              f"implementation: {runs['off']['nondet']} [{card}]")
    if not runs["off"]["convs"]["fwd"]:
        raise AssertionError(f"{label}: the profiler saw no convolution")
    off = runs["off"]["convs"]
    for name, r in runs.items():
        kw = variants.get(name, {})
        if kw.get("remat") and kw.get("remat_policy",
                                      "conv_out") == "conv_out" and \
                r["convs"] != dict(off, fwd=off["fwd"] + rerun_convs):
            raise AssertionError(f"{label} {name}: convolutions {r['convs']}"
                                 f", without recomputation {off}, "
                                 f"{rerun_convs} more expected")
    launches = [r["launches"] for r in runs.values()]
    del runs
    torch.cuda.empty_cache()
    return launches


def remat_big(card: str, cfg, batch, wrappers: dict, label: str) -> dict:
    """REMAT_BIG_STEPS timed steps of a fresh state: median host ms of
    the steps after the first, peak memory, the profile of one more step
    (profile_steps); returns the wrappers' launches."""
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step

    dev = torch.device("cuda")
    state = fresh_state(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    step = make_contrast_train_step(cfg, state.model, steps_per_epoch=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    k1 = k1_wrappers()["mm_bn_stats"]
    k1.generic_launches = 0
    steady, metrics = timed_steps(step, state, batch, gen, REMAT_BIG_STEPS,
                                  label, card)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if "mm_bn_stats" in launches:
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic": k1.generic_launches, **launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    device_ms, _ = profile_steps(card, step, state, batch, gen, steady, n=1)
    print(f"remat {label}: {REMAT_BIG_STEPS} steps, median host "
          f"{steady * 1e3:.1f} ms a step = {cfg.batch_size / steady:.2f} "
          f"samples/s, device {device_ms:.1f} ms a step, peak "
          f"{peak:.2f} GiB; losses "
          + ", ".join(f"{m['loss']:.5f}" for m in metrics)
          + f"; launches {launches} [{card}]")
    del state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, peak=peak)


@contextlib.contextmanager
def eager_encoders():
    """Contrast steps made inside run their encoders eagerly:
    train/graphs.py's install patched out."""
    from hcmoco_tpu_torch.train import graphs

    install = graphs.install
    graphs.install = lambda model: None
    try:
        yield
    finally:
        graphs.install = install


@eager_encoders()
def remat_phase(card: str) -> tuple:
    """TrainConfig.remat (HRNet, both policies) and pn_remat (HRNetPN) on
    the card: W18 320^2 stage 1 at bs32 fused without recomputation,
    'conv_out' and 'dots', and stage 2 with 'conv_out', each held to the
    run without (remat_case); stage 1 at the recipes' global batch of 224
    with 'conv_out', and without if bs32's peak times 7 fits; HRNetPN at
    4096 points bs64 with pn_remat off and on, held alike, and at 16384
    points bs64 with it.  Every run, 'off' too, runs its encoders eagerly
    (eager_encoders): the phase holds recomputation to the same step
    without, launch for launch and convolution for convolution, and an
    encoder that replays CUDA graphs issues neither on the host.  Returns
    the K1/K1b and the point kernels' launches of every run."""
    from hcmoco_tpu_torch.core.config import RECIPES
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites

    dev = torch.device("cuda")
    k1w = k1_wrappers()
    pnw = {name: fn for name, (fn, _) in point_wrappers().items()}
    k1_runs, pn_runs = [], []
    os.environ["HCMOCO_CONVBN_FUSE"] = "1"  # read when the model is built
    try:
        probe = build_model(make_cfg(), device=dev)
        sites = fused_sites(probe.encoder1) + fused_sites(probe.encoder2)
        del probe
        # K1b's forward runs again in each recompute; 'dots' also reruns K1
        once = {name: sites for name in k1w}
        expect = {"off": once,
                  "conv_out": dict(once, **{"bn_apply fwd": 2 * sites}),
                  "dots": dict(once, **{"mm_bn_stats": 2 * sites,
                                        "bn_apply fwd": 2 * sites})}
        variants = {"off": {}, "conv_out": dict(remat=True),
                    "dots": dict(remat=True, remat_policy="dots")}
        batch = to_device(synthetic_contrast_batch(
            np.random.default_rng(0), BATCH, size=320, num_joints=16,
            n_data=N_DATA), dev)
        k1_runs += remat_case(card, f"stage-1 HRNet-W18 320^2 bs{BATCH} "
                              "fused", make_cfg(), variants, batch, k1w,
                              expect, off_twice=True)
        cfg2 = dataclasses.replace(
            RECIPES[STAGE2_RECIPES["HRNet"]], batch_size=BATCH)
        # stage 2's two linear_merge heads (1x1 convs with a bias, not
        # ConvBN sites) run again under 'conv_out'
        k1_runs += remat_case(
            card, f"stage-2 HRNet-W18 320^2 bs{BATCH} fused", cfg2,
            {"off": {}, "conv_out": dict(remat=True)}, batch, k1w, expect,
            rerun_convs=2)
        del batch
        torch.cuda.empty_cache()
        big = to_device(synthetic_contrast_batch(
            np.random.default_rng(1), REMAT_BIG_BATCH, size=320,
            num_joints=16, n_data=N_DATA), dev)
        cfg_big = make_cfg(batch_size=REMAT_BIG_BATCH)
        run = remat_big(card, dataclasses.replace(cfg_big, remat=True), big,
                        k1w, f"stage-1 HRNet-W18 bs{REMAT_BIG_BATCH} fused "
                        "conv_out")
        k1_runs.append(run["launches"])
        free, total = torch.cuda.mem_get_info()
        print(f"remat: card memory {total / 2**30:.2f} GiB [{card}]")
        k1_runs.append(remat_big(
            card, cfg_big, big, k1w,
            f"stage-1 HRNet-W18 bs{REMAT_BIG_BATCH} fused without "
            "recomputation")["launches"])
        del big
    finally:
        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.cuda.empty_cache()
    per_step = {name: n for name, (_, n) in point_wrappers().items()}
    pn_expect = {"off": per_step,
                 "pn_remat": dict(per_step, **{
                     "group_rows fwd": per_step["group_rows fwd"] + 6})}
    cfg_pn = make_cfg(arch="HRNetPN", batch_size=PN_BATCH)
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), PN_BATCH, size=320, num_joints=16,
        n_data=N_DATA), dev)
    pn_runs += remat_case(card, f"stage-1 HRNetPN 4096 points bs{PN_BATCH}",
                          cfg_pn, {"off": {}, "pn_remat": dict(pn_remat=True)},
                          batch, pnw, pn_expect)
    del batch
    torch.cuda.empty_cache()
    batch = to_device(synthetic_contrast_batch(
        np.random.default_rng(0), PN_BATCH, size=320, num_joints=16,
        n_data=N_DATA), dev)
    pn_runs.append(remat_big(
        card, make_cfg(arch="HRNetPN", batch_size=PN_BATCH,
                       pn_num_points=PN_WIDE_POINTS, pn_remat=True),
        batch, pnw, f"stage-1 HRNetPN {PN_WIDE_POINTS} points bs{PN_BATCH} "
        "pn_remat")["launches"])
    del batch
    torch.cuda.empty_cache()
    return k1_runs, pn_runs


CLI_FRAMES = 512   # NTU frames of the CLI phase's tree
RESUME_STEPS = 6   # steps of the resumed stage-1 CLI run
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


def wrapper_counts(wrappers: dict) -> dict:
    """{name: launches so far} of cli_run's `wrappers`, K1's generic-path
    count after K1's own."""
    launches = {name: fn.launches for name, (fn, _) in wrappers.items()}
    if "mm_bn_stats" in launches:
        launches = {"mm_bn_stats": launches.pop("mm_bn_stats"),
                    "mm_bn_stats generic":
                        k1_wrappers()["mm_bn_stats"].generic_launches,
                    **launches}
    return launches


# the device kernels of each K1/K1b wrapper launch, by name in a trace: K1
# launches its fast path's kernel (and its slot reduction) or its generic
# path's one kernel; K1b's backward sums a reduction (and its tail)
K1_TRACE_KERNELS = {
    "mm_bn_stats": ("mm_bn_fast_kernel", "mm_bn_generic_kernel"),
    "mm_bn_stats generic": ("mm_bn_generic_kernel",),
    "bn_apply fwd": ("k1b_bn_fwd_kernel",),
    "bn_apply bwd sums": ("k1b_bwd_reduce_kernel",),
    "bn_apply bwd dy": ("k1b_bwd_dy_kernel",),
    "mm_bn bwd dyt": ("k1b_dyt_kernel",)}
# ... and of each BN-site wrapper launch: its sums kernel (and the slot
# reduction) or its elementwise kernel
TRACE_KERNELS = dict(K1_TRACE_KERNELS, **{
    "bn_sums": ("FwdTerms",),
    "bn_relu_fwd": ("batch_norm_relu_fwd_kernel",),
    "bn_relu_bwd_sums": ("BwdTerms",),
    "bn_relu_bwd_dx": ("batch_norm_relu_bwd_dx_kernel",)})


def traced_launches(rows: list, names) -> dict:
    """{name: the kernel records among `rows` ((name, us), device_rows)
    of TRACE_KERNELS[name]}: the launches that ran on the card, those
    replayed from a CUDA graph included, which the wrappers (host
    launches: a capture once, a replay never) do not count."""
    return {k: sum(1 for name, _ in rows
                   if any(t in name for t in TRACE_KERNELS[k]))
            for k in names}


def graph_replays(model) -> dict:
    """{encoder: (forward, backward) CUDA graph replays so far} of the
    model's graphed encoders (train/graphs.py)."""
    from hcmoco_tpu_torch.train import graphs

    return {name: graphs.of(m).replays() for name, m in model.named_children()
            if graphs.of(m) is not None}


def read_cli_trace(trace_dir: str) -> dict:
    """The one trace that the CLI's --profile_dir wrote: its file's MB,
    the `global_step N` spans, the names of the program's other host
    spans, every device kernel's (name, us), copies and fills left out,
    the host activity's events, and the seconds json.load took."""
    import glob

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile_dir wrote {files}, expected one "
                             "trace file")
    t0 = time.perf_counter()
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    read_s = time.perf_counter() - t0
    return {"mb": os.path.getsize(files[0]) / 1e6, "read_s": read_s,
            "events": len(events),
            "spans": sorted((e["name"] for e in events
                             if e.get("cat") == "user_annotation"
                             and e.get("name", "").startswith("global_step ")),
                            key=lambda n: int(n.split()[1])),
            "program": {e["name"] for e in events
                        if e.get("cat") == "user_annotation"},
            "cpu_ops": sum(1 for e in events if e.get("cat") == "cpu_op"),
            "kernels": [(e["name"], float(e.get("dur", 0.0))) for e in events
                        if e.get("cat") == "kernel"]}


def check_trace(card: str, label: str, trace_dir: str, marks: dict,
                r, free_it_ms: float) -> tuple:
    """The CLI's --profile_dir trace against the run: its spans are global
    steps 10-15 and its K1/K1b kernel events (K1_TRACE_KERNELS) are
    there; unless the run's encoders replay CUDA graphs, they equal the
    wrappers' launches over those steps (`marks`: the counts after step 9
    and after step 15, and the host clock there).  Prints the trace's
    size, the seconds that stopping the profiler and writing the trace
    took (the host time between the two marks less the six steps'), and
    reading it, and the trace's device ms a step beside the CLI's own
    step time; returns that device ms a step and the K1/K1b kernel
    events."""
    from hcmoco_tpu_torch.cli.main_contrast import PROFILE_STEPS

    first, last = PROFILE_STEPS
    tr = read_cli_trace(trace_dir)
    want_spans = [f"global_step {i}" for i in range(first, last + 1)]
    if tr["spans"] != want_spans:
        raise AssertionError(f"{label}: trace spans {tr['spans']}, "
                             f"expected {want_spans}")
    phases = {"data_wait", "upload", "forward", "nce", "backward",
              "bank_update", "optimizer", "grad_sync", "metrics"}
    if not phases <= tr["program"] or tr["cpu_ops"]:
        raise AssertionError(f"{label}: the trace's program spans "
                             f"{sorted(tr['program'])} lack "
                             f"{sorted(phases - tr['program'])}, or it holds "
                             f"{tr['cpu_ops']} CPU ops")
    n = last - first + 1
    counted = {k: marks["after"][k] - marks["before"][k]
               for k in K1_TRACE_KERNELS}
    traced = traced_launches(tr["kernels"], K1_TRACE_KERNELS)
    if not all(traced.values()) or (
            not graph_replays(r.state.model) and traced != counted):
        raise AssertionError(f"{label}: K1/K1b kernels in the trace "
                             f"{traced}, the wrappers counted {counted} over "
                             f"steps {first}-{last}")
    steps = slice(first, last + 1)
    traced_host = sum(a + b + c for a, b, c in zip(
        r.wait_s[steps], r.upload_s[steps], r.step_s[steps]))
    write_s = marks["after_t"] - marks["before_t"] - traced_host
    kernel_ms = sum(us for _, us in tr["kernels"]) / 1e3 / n
    step_ms = statistics.median(r.step_s[steps]) * 1e3
    print(f"{label} --profile_dir: trace of global steps {first}-{last} "
          f"({tr['events']} events, {len(tr['kernels'])} kernels, "
          f"{tr['mb']:.1f} MB); K1/K1b kernel events {traced}, the "
          f"wrappers' host launches over those steps {counted}; stopping "
          f"the profiler and writing the trace {write_s:.1f} s, json.load "
          f"{tr['read_s']:.1f} s [{card}]")
    print(f"{label} --profile_dir: device kernel time {kernel_ms:.3f} ms a "
          f"step from the trace, beside the CLI's step time {step_ms:.2f} ms "
          f"(median of the traced steps, CUDA activity and spans on) and its "
          f"iteration median {free_it_ms:.2f} ms untraced: busy share "
          f"{kernel_ms / free_it_ms:.3f} [{card}]")
    return kernel_ms, traced


def cli_run(card: str, label: str, argv: list, bsz: int, n: int,
            wrappers: dict, on_ready=None, input_rate: float = None,
            main=None, trace_dir: Optional[str] = None):
    """main(argv) (cli/main_contrast.py's unless `main` is another CLI's
    with its signature and result), which runs `n` steps, on the card with
    every count of `wrappers` ({name: (fn, launches a step, or None:
    checked by the caller)}) and K1's generic-path count set to 0 just
    before it; torch.profiler records the run's last two steps, or with
    `trace_dir` the CLI's own --profile_dir traces global steps 10-15
    there (check_trace).
    Prints the iteration's median and quartiles over the steps before the
    profiler's (the first step, a warm-up, left out; with `trace_dir` the
    steps outside 10-15), samples/s, the host input rate, the device busy
    share and the peak memory; returns (result, launches by name, the
    steps they cover), after checking the launches against the expected
    count a step and that the epoch's loss is finite and its checkpoint
    written.  Where the run's encoders replay CUDA graphs (train/graphs.py),
    the K1/K1b launches are the profiler's kernel records of the traced
    steps, which they cover; every other launch is the wrappers' over all
    the steps."""
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
    prof = None
    if trace_dir is not None:
        from hcmoco_tpu_torch.cli.main_contrast import PROFILE_STEPS

        marks = {}

        def on_step(i):
            # after step 9 and after step 15
            for key, at in (("before", PROFILE_STEPS[0]),
                            ("after", PROFILE_STEPS[1] + 1)):
                if i == at:
                    marks[key] = wrapper_counts(wrappers)
                    marks[f"{key}_t"] = time.perf_counter()

        r = main(argv + ["--profile_dir", trace_dir], on_ready=on_ready,
                 on_step=on_step)
    else:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=n - 3, warmup=1, active=2,
                                       repeat=1)) as prof:
            r = main(argv, on_ready=on_ready, on_step=lambda _: prof.step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = wrapper_counts(wrappers)
    host = dict(launches)
    steps = len(r.step_s)
    if steps != n:
        raise AssertionError(f"{label}: ran {steps} steps, expected {n}")
    replays = graph_replays(r.state.model)
    for name, (_, per_step) in wrappers.items():
        if replays and name in K1_TRACE_KERNELS:
            continue  # the traced steps' records, below
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

    it_s = [a + b + c for a, b, c in zip(r.wait_s, r.upload_s, r.step_s)]
    if prof is None:
        # after the warm-up, outside the traced steps
        free = [i for i in range(1, n)
                if not PROFILE_STEPS[0] <= i <= PROFILE_STEPS[1]]
        where = f"steps 2-{PROFILE_STEPS[0]} and {PROFILE_STEPS[1] + 2}-{n}"
    else:
        # after the warm-up, before the profiler's steps
        free = list(range(1, n - 3))
        where = f"steps 2-{n - 3}"
    q1, med, q3 = statistics.quantiles([it_s[i] for i in free], n=4)
    step_med = statistics.median(r.step_s[i] for i in free)
    covered = steps
    if prof is None:
        kernel_ms, traced = check_trace(card, label, trace_dir, marks, r,
                                        med * 1e3)
        h2d = ""  # the trace's copies are not read
        if replays:
            launches.update(traced)
            covered = PROFILE_STEPS[1] - PROFILE_STEPS[0] + 1
    else:
        rows = device_rows(prof)
        if replays:
            launches.update(traced_launches(
                rows, [k for k in launches if k in K1_TRACE_KERNELS]))
            covered = 2
        kernel_ms = sum(us for name, us in rows
                        if not name.startswith(("Memcpy", "Memset"))) / 1e3 / 2
        h2d = "; H2D copies {:.3f} ms/step".format(sum(
            us for name, us in rows
            if name.startswith("Memcpy") and "HtoD" in name) / 1e3 / 2)
    print(f"{label}: {steps} steps, epochs {r.start_epoch}-{r.last_epoch}, "
          f"loss {loss:.5f} (epoch mean), checkpoint {ckpt}")
    print(f"{label}: iteration median {med * 1e3:.2f} ms (quartiles "
          f"{q1 * 1e3:.2f}, {q3 * 1e3:.2f}; {where}) = "
          f"{bsz / med:.2f} samples/s; medians of its parts: data wait "
          f"{statistics.median(r.wait_s[i] for i in free) * 1e3:.2f} ms, "
          f"pin + upload enqueue "
          f"{statistics.median(r.upload_s[i] for i in free) * 1e3:.2f} ms, "
          f"step {step_med * 1e3:.2f} ms; host input rate {input_rate:.2f} "
          f"samples/s (DataSource alone, 10 batches) against the step's "
          f"{bsz / step_med:.2f}; device kernel time {kernel_ms:.3f} "
          f"ms/step, busy share {kernel_ms / (med * 1e3):.3f}{h2d}; peak "
          f"memory {peak:.2f} GiB [{card}]")
    graphed = (f"; encoders' CUDA graph replays (forward, backward) "
               f"{replays}: K1/K1b launches are the kernel records of the "
               f"{covered} traced steps, the wrappers' host launches over "
               f"all {steps} {host}" if replays else "")
    print(f"{label}: launches {launches} in {covered} steps{graphed}; wall "
          f"time: main {t1 - t0:.1f} s, profile read "
          f"{time.perf_counter() - t1:.1f} s [{card}]")
    return r, launches, covered


NCCL_CLI_STEPS = 4


def nccl_cli(card: str, argv: list, save: str) -> list:
    """cli/main_contrast.py under torchrun's environment for a world of
    one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT set here;
    no torchrun binary): it joins an NCCL process group, trains
    NCCL_CLI_STEPS steps and saves as rank 0, then a second run resumes
    from that checkpoint for NCCL_CLI_STEPS more.  In a world of one the
    port issues no collective, so the profiler (over the resumed run's
    steps) must show no NCCL kernel.  Returns both runs' K1/K1b
    launches, the profiler's kernel records (the encoders replay CUDA
    graphs in a world of one)."""
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
            host = {name: fn.launches for name, fn in wrappers.items()}
            host = {"mm_bn_stats": host.pop("mm_bn_stats"),
                    "mm_bn_stats generic":
                        wrappers["mm_bn_stats"].generic_launches, **host}
            rows = device_rows(prof)
            launches = traced_launches(rows, host)
            want = {name: (gen if name.endswith("generic") else sites)
                    * steps for name in launches}
            if steps != NCCL_CLI_STEPS or launches != want:
                raise AssertionError(f"NCCL CLI run {i}: {steps} steps, "
                                     f"launches {launches} (the profiler's "
                                     f"kernel records), expected {want}")
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
                  f"one); K1/K1b kernel records {launches}, host launches "
                  f"{host}, CUDA graph replays {graph_replays(model)} "
                  f"[{card}]")
            del r
    finally:
        for k in env:
            os.environ.pop(k, None)
    print(f"NCCL CLI runs (start, resume) wall time "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return runs


SLURM_CLI_STEPS = 2


def slurm_cli(card: str, argv: list, save: str) -> dict:
    """cli/main_contrast.py --multihost under a SLURM job step's variables
    alone, for one task (SLURM_JOB_ID, SLURM_STEP_NODELIST, SLURM_NTASKS,
    SLURM_PROCID, SLURM_LOCALID set here; no srun, and none of torchrun's
    variables, nor MASTER_PORT): it joins an NCCL process group of one at
    the node list's first host and port SLURM_JOB_ID % 4096 + 61440, as
    jax.distributed.initialize() does, and trains SLURM_CLI_STEPS steps.
    Checks the rank, world, backend and address it joined; returns its
    K1/K1b launches, the profiler's kernel records."""
    import socket

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.cli.main_contrast import main
    from hcmoco_tpu_torch.models.hrnet import fused_sites
    from hcmoco_tpu_torch.parallel import mesh

    job = 7340000
    while True:  # a job id whose port is free here
        port = job % 4096 + 61440
        with socket.socket() as sock:
            try:
                sock.bind(("localhost", port))
                break
            except OSError:
                job += 1
    env = {"SLURM_JOB_ID": str(job), "SLURM_STEP_NODELIST": "localhost",
           "SLURM_NTASKS": "1", "SLURM_PROCID": "0", "SLURM_LOCALID": "0",
           "SLURM_STEP_TASKS_PER_NODE": "1", "SLURM_NODEID": "0"}
    hidden = {k: os.environ.pop(k) for k in mesh.TORCHRUN_ENV
              + ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR")
              if k in os.environ}
    seen = {}

    def on_ready(state):
        seen.update(backend=dist.get_backend(), rank=dist.get_rank(),
                    world=dist.get_world_size(), joined=dict(mesh.JOINED))

    wrappers = k1_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["mm_bn_stats"].generic_launches = 0
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r = main(argv + ["--model_path", save, "--multihost", "--epochs",
                             "1", "--max_steps", str(SLURM_CLI_STEPS)],
                     on_ready=on_ready)
            torch.cuda.synchronize()
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(hidden)
    joined = seen.pop("joined", None)
    want = {"launcher": "slurm", "rank": 0, "world": 1, "local_rank": 0,
            "address": f"localhost:{port}"}
    if seen != {"backend": "nccl", "rank": 0, "world": 1} or joined != want:
        raise AssertionError(f"SLURM CLI run: joined {joined}, process "
                             f"group {seen}; expected {want} over nccl")
    if dist.is_initialized():
        raise AssertionError("the CLI left its process group behind")
    model = r.state.model
    sites = fused_sites(model.encoder1) + fused_sites(model.encoder2)
    gen = generic_sites(model.encoder1) + generic_sites(model.encoder2)
    host = {name: fn.launches for name, fn in wrappers.items()}
    host = {"mm_bn_stats": host.pop("mm_bn_stats"),
            "mm_bn_stats generic":
                wrappers["mm_bn_stats"].generic_launches, **host}
    launches = traced_launches(device_rows(prof), host)
    steps = len(r.step_s)
    want = {name: (gen if name.endswith("generic") else sites) * steps
            for name in launches}
    if steps != SLURM_CLI_STEPS or launches != want:
        raise AssertionError(f"SLURM CLI run: {steps} steps, launches "
                             f"{launches} (the profiler's kernel records), "
                             f"expected {want}")
    print(f"SLURM CLI run (--multihost, SLURM_JOB_ID {job}, no torchrun "
          f"variables): joined rank {joined['rank']} of {joined['world']} "
          f"over {seen['backend']} at {joined['address']}, {steps} steps "
          f"in {time.perf_counter() - t0:.1f} s; K1/K1b kernel records "
          f"{launches}, host launches {host}, CUDA graph replays "
          f"{graph_replays(model)} [{card}]")
    del r
    return launches


def drive_cli(card: str, stage2_copy: str) -> tuple:
    """The pre-training CLI (cli/main_contrast.py) in process on the card,
    from frames on disk: an NTU tree of CLI_FRAMES Kinect-size frames and
    an MPII tree of CLI_MPII images, written from a seed into a temporary
    directory under build/ and deleted at the end.  Stage 1 HRNet-W18 bs32
    fused for an epoch, its resume for RESUME_STEPS steps of a second (the
    restored step, banks and a weight equal to what was saved), stage 2
    grafted from it with --pretrain, and HRNetPN bs64 from a pack of the
    NTU tree through the native resample; the CLI under torchrun's and
    under SLURM's variables (nccl_cli, slurm_cli).  Returns the K1/K1b
    launches of the HRNet runs and the point kernels' of the HRNetPN
    run; copies the stage-2 run's
    checkpoint to `stage2_copy` (the versatility phase grafts from it).
    The stage-1 run passes --profile_dir: its trace of global steps 10-15
    must hold K1 and K1b once a fused site and step (cli_run,
    check_trace).  The HRNet runs replay their encoders' CUDA graphs:
    their K1/K1b launches are the profiler's kernel records of the traced
    steps."""
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
        t_trace = time.perf_counter()
        r1, l1, n1 = cli_run(card, "CLI stage-1 HRNet", s1 + [
            "--epochs", "1", "--max_steps", str(steps1)], BATCH, steps1, k1,
            input_rate=rate, trace_dir=os.path.join(tmp, "trace"))
        print(f"CLI stage-1 HRNet with --profile_dir: wall "
              f"{time.perf_counter() - t_trace:.1f} s, the trace's write "
              f"and read included [{card}]")
        check_k1(l1, r1, n1, "CLI stage-1 HRNet")
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

        r2, l2, n2 = cli_run(card, "CLI stage-1 HRNet resumed", s1 + [
            "--epochs", "2", "--resume", "auto", "--max_steps",
            str(steps1 + RESUME_STEPS)], BATCH, RESUME_STEPS, k1,
            on_ready=check_restored, input_rate=rate)
        if r2.start_epoch != 2 or restored.get("step") != steps1:
            raise AssertionError(f"resume started at epoch {r2.start_epoch}"
                                 f", step {restored.get('step')}")
        print(f"CLI resume: epoch 2 restored step {steps1}, the banks and "
              f"encoder1.conv1.weight bit for bit [{card}]")
        check_k1(l2, r2, n2, "CLI stage-1 HRNet resumed")
        trained = r2.state.model.encoder1.conv1.weight.detach().cpu().clone()
        del r1, r2
        torch.cuda.empty_cache()
        l_nccl = nccl_cli(card, s1, os.path.join(tmp, "save_nccl"))
        l_slurm = slurm_cli(card, s1, os.path.join(tmp, "save_slurm"))

        def check_grafted(state):
            if not torch.equal(
                    state.model.encoder1.conv1.weight.detach().cpu(),
                    trained):
                raise AssertionError("--pretrain did not graft "
                                     "encoder1.conv1.weight")

        s2_steps = 8
        s2 = ["--recipe", "second_stage/ntumpiirgbd2s_hrnet_w18",
              "--batch_size", str(BATCH)] + files
        r3, l3, n3 = cli_run(card, "CLI stage-2 HRNet --pretrain", s2 + [
            "--pretrain", stage1_dir, "--epochs", "1", "--max_steps",
            str(s2_steps)],
            BATCH, s2_steps, k1, on_ready=check_grafted, input_rate=rate)
        check_k1(l3, r3, n3, "CLI stage-2 HRNet")
        shutil.copy(os.path.join(r3.ckpt_dir, f"epoch_{r3.last_epoch}.pt"),
                    stage2_copy)
        del r3

        os.environ.pop("HCMOCO_CONVBN_FUSE", None)
        pn = ["--recipe", "first_stage/ntumpiirgbd2s_hrnetpn_w18",
              "--batch_size", str(PN_BATCH), "--packed_dir", pack] + files
        pn_steps = 8
        r4, l4, _ = cli_run(card, "CLI stage-1 HRNetPN packed", pn + [
            "--epochs", "1", "--max_steps", str(pn_steps)], PN_BATCH,
            pn_steps, point_wrappers(), input_rate=cli_input_rate(pn))
        route = library_route("resample")
        if not route.startswith("native"):
            raise AssertionError(f"the packed path took the {route}")
        print(f"CLI HRNetPN packed path: resample route {route} [{card}]")
        del r4
        torch.cuda.empty_cache()
        return [l1, l2, l3] + l_nccl + [l_slurm], [l4]
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
    r, launches, _ = cli_run(
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
          f"step ({generic} on K1's generic path)"
          + (" for the one HRNet-W18 (the pre-training step's two: 80, 62)"
             if sites else "") + f"; wall {wall:.1f} s [{card}]")
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
    the K1/K1b launches of (b) and (c), and the ITOP fixture's (train dir,
    test dir, train boxes, test boxes)."""
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
    return [seg_launches, a2j_launches], itop


# ---- data parallelism: two ranks on one card over gloo ----------------------

# (label, arch, stage, global batch, steps, HCMOCO_CONVBN_FUSE, dtype)
# (label, arch, stage, global batch, steps, fuse, dtype[, TrainConfig
# fields]); 'remat' recomputes in the backward, its BN sums' all-reduces
# kept from the forward (train/remat.py)
DP_CASES = (("stage-1 HRNet", "HRNet", 1, 32, 3, True, "bfloat16"),
            ("stage-1 HRNet remat", "HRNet", 1, 32, 2, True, "bfloat16",
             dict(remat=True)),
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
        if running is None:  # a recompute (TrainConfig.remat)
            return apply(y, s1, s2, scale, bias, eps, running, n)
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
    the kernels' launches, the collectives a step, the device ms a step
    of the `grad_sync` span and of the collectives' spans, and the step
    times."""
    import torch.distributed as dist

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.parallel import mesh
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state
    from hcmoco_tpu_torch.utils import spans

    label, arch, stage, bsz, steps, fuse, dtype, *fields = case
    dev = torch.device("cuda")
    cfg = dataclasses.replace(dp_cfg(arch, stage, bsz, dtype),
                              **(fields[0] if fields else {}))
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
    mesh.STATS.update(calls=0)
    spans.clear()
    metrics, times, sites = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with (record_fused_sites(sites) if fuse and i == 0
              else contextlib.nullcontext()), spans.recording():
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
               **{f"{k}_ms": span_ms(names) / steps for k, names in
                  (("grad_sync", ("grad_sync",)),
                   ("coll", mesh.COLLECTIVES))})
    spans.clear()
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def span_ms(names) -> float:
    """Device ms in the recorded spans named `names` (utils/spans.py:
    each span's close marker less its open marker)."""
    from hcmoco_tpu_torch.utils import spans

    return sum(s.device_ns for s in spans.recorded()
               if s.name in names and s.device_ns is not None) / 1e6


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


def spawn_ranks(flag: str) -> list:
    """DP_WORLD processes `chip_smoke.py <flag> OUT` on cuda:0, joined
    over gloo (RANK, WORLD_SIZE and MASTER_PORT in their environment);
    returns each rank's torch.save'd result, rank order.  A rank that
    fails, or does not finish in DP_TIMEOUT_S, raises; every process is
    stopped on the way out."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_dp_", dir=build)
    procs = []
    try:
        port = str(free_port())
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        for r in range(DP_WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_WORLD),
                       LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(DP_WORLD),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, outs[r]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"DP rank {r} did not finish in "
                                     f"{DP_TIMEOUT_S} s")
            if p.returncode != 0:
                raise AssertionError(f"DP rank {r} failed "
                                     f"({p.returncode}):\n{log[-4000:]}")
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def check_data_parallel(card: str) -> tuple:
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device) against one process on the same card: for each DP_CASES case,
    HRNet-W18 stage 1 at 320^2 in bf16 with K1/K1b at every fused site,
    stage 2 in f32, and HRNetPN (K2-K6, K56a/K56b) at 4096 points in f32,
    each rank holding half of the global batch.  First K1b against its
    plain version at a rank's rows normalised by the global batch's
    (K1B_DP_SHAPES).  The parent runs the one-process steps with the
    ranks' BN formula (ranks_formula) and its encoders eager
    (eager_encoders), and the f32 cases once more with a
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
    # the one process runs its encoders eagerly, as the ranks do (a world
    # of two replays no CUDA graph), so that their launches compare
    with ranks_formula(), eager_encoders():  # BN as the ranks normalise
        one = {case[0]: dp_run(case, 0, 1) for case in DP_CASES}
    # the f32 cases once more with nn.BatchNorm's own (two-pass) variance
    with eager_encoders():
        floor = {case[0]: dp_distance(dp_run(case, 0, 1), one[case[0]])
                 for case in DP_CASES if case[6] == "float32"}
    os.environ.pop("HCMOCO_CONVBN_FUSE", None)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = spawn_ranks("--dp-rank")
    t2 = time.perf_counter()
    k1_total, pn_total = {}, {}
    for case in DP_CASES:
        label, _, _, bsz, steps, fuse, dtype, *_ = case
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
              f"their spans {b['coll_ms']:.2f} device ms a step, grad_sync's "
              f"{b['grad_sync_ms']:.2f} -- two ranks on one card over gloo: "
              f"not a multi-card figure [{card}]")
    plain, remat = (ranks[0][k]["calls"] for k in ("stage-1 HRNet",
                                                   "stage-1 HRNet remat"))
    if remat != plain:
        raise AssertionError(f"DP: {remat} collectives a remat step, "
                             f"{plain} without recomputation")
    print(f"DP stage-1 HRNet remat: {remat:.0f} collectives a step, as "
          "without recomputation: the recompute takes the forward's BN "
          f"sums back instead of all-reducing them again [{card}]")
    print(f"DP phase: one-process references {t1 - t0:.1f} s, two ranks "
          f"(start, build, {len(DP_CASES)} cases) {t2 - t1:.1f} s [{card}]")
    return k1_total, pn_total


# ---- the baseline methods (ROADMAP item 11a) -------------------------------

# InsDis/PIRL/CMC on banks and MoCo/MoCov2/CMCv2/InfoMin on the queue with
# the EMA key encoder (models/resnet.py, models/build.py's baseline models,
# train/contrast_step.py's baseline branches).  No kernel of the port lies
# on this path: the ResNets are cuDNN convs and the port's BN modules.
IMAGENET_N_DATA = 1281167  # ImageNet-1k's train images: the banks' rows
MOCO_K = 65536             # MoCo's published queue length
BASELINE_SMALL_N_DATA = 256
# card vs CPU, one step in float64 (model and heads): in f32 a train-mode
# ResNet at 64^2 amplifies two sound implementations' rounding through BN
# over a few values a channel (1.4e-2 of the pooled feature between the
# port and the JAX package at 32^2 bs4, tests/torch_baseline_common.py);
# in float64 two orders of summation part by ~1e-12
BASELINE_SMALL_TOL = dict(rtol=1e-6, atol=1e-9)
BASELINE_SMALL = (
    ("InsDis", dict(method="InsDis")),
    ("PIRL", dict(method="PIRL")),
    ("CMC", dict(method="CMC")),
    ("CMC shared trunk", dict(method="CMC", arch="resnet50cmc",
                              batch_size=4)),
    ("MoCo", dict(method="MoCo")),
    ("CMCv2", dict(method="CMCv2")),
)
# card vs CPU in the dtypes the full-width cells run (baseline_dtype_check),
# at a size where BN is well conditioned: ResNet-18 at 224^2 bs8, whose
# layer4 BN sees 8 * 4 * 4 = 128 values a channel after the double max-pool
BASELINE_DTYPE = (("MoCov2", dict(method="MoCov2")),
                  ("CMC", dict(method="CMC")))
BASELINE_DTYPE_SIZE = dict(arch="resnet18", crop_size=224, batch_size=8,
                           nce_k=256)
# The tolerances, from readings of sound runs and of broken controls on an
# H100 (PERF.md, PR 14: MoCov2 and CMC, the largest sound reading against
# the smallest control's).
# f32: each group of the card's state, and its loss, no further from the
# float64 step than 3x the CPU f32 step is, + 2^-20 (8 f32 roundings) of
# the group's norm (sound: 0.38 of that; BN eps 1e-3: 204-289 of it)
BASELINE_F32_RATIO = 3.0
BASELINE_F32_FLOOR = 2.0 ** -20
# bf16 card step vs the f32 CPU step, largest abs difference of the
# features (unit vectors) and of the loss (sound: 0.0205 and 0.027; the
# stems' channels reversed: features 0.099-0.119)
BASELINE_BF16_TOL = dict(feat=0.05, loss=0.06)
# the f32 glue of the bf16 card step vs its CPU replay, largest abs
# difference (sound: 1.04e-7; heads in bf16: 1.34e-3-1.43e-3)
BASELINE_GLUE_TOL = 1e-5
# (label, TrainConfig fields, n_data) at full width: ResNet-50, 224^2, bf16
BASELINE_FULL = (
    ("MoCov2 ResNet-50", dict(method="MoCov2", batch_size=256,
                              nce_k=MOCO_K), IMAGENET_N_DATA),
    ("CMC dual ResNet-50", dict(method="CMC", batch_size=256,
                                nce_k=16384), IMAGENET_N_DATA),
    ("PIRL ResNet-50", dict(method="PIRL", batch_size=128, nce_k=16384),
     IMAGENET_N_DATA),
)
BASELINE_DP = (("MoCo", dict(method="MoCo")),
               ("CMC-jigsaw", dict(method="Customize", modal="CMC",
                                   mem="bank", jigsaw=True)))


def baseline_cfg(**kw):
    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config

    base = dict(arch="resnet18", crop_size=64, batch_size=8, epochs=100,
                nce_k=64, compute_dtype="float32")
    base.update(kw)
    return resolve_config(TrainConfig(**base))


def baseline_batch(cfg, rng: np.random.Generator, n_data: int,
                   pins: bool = True) -> dict:
    """A baseline batch from seeded numpy: rgbd (two crops on channels for
    moco), distinct indices, PIRL's (B, 9, 64, 64, 3) patch stack, and
    with `pins` the step's draws (negatives, patch orders)."""
    bsz, crop = cfg.batch_size, cfg.crop_size
    moco = cfg.mem == "moco"
    b = {"rgbd": rng.standard_normal((bsz, crop, crop, 6 if moco else 3),
                                     dtype=np.float32),
         "index": rng.choice(n_data, bsz, replace=False).astype(np.int64)}
    if cfg.jigsaw:
        b["rgbd_jig"] = rng.standard_normal((bsz, 9, 64, 64, 3),
                                            dtype=np.float32)
    if pins:
        if not moco:
            idx = rng.integers(0, n_data, (bsz, cfg.nce_k + 1))
            idx[:, 0] = b["index"]
            b["neg_idx"] = idx
        if cfg.jigsaw:
            b["jig_perm"] = np.argsort(rng.random((bsz, 9)), axis=1)
    return b


def with_compute_dtype(model: torch.nn.Module,
                       dtype: torch.dtype) -> torch.nn.Module:
    """The encoders' convs in `dtype` (what build_model's compute_dtype
    sets); parameters and heads stay as they are."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


def model_f64(model: torch.nn.Module) -> torch.nn.Module:
    """The whole model in float64: parameters, BN statistics, compute."""
    return with_compute_dtype(model.double(), torch.float64)


def baseline_state_parts(state) -> dict:
    """The state a baseline step changes: parameters and BN statistics,
    and the banks, or the queue, its pointer and the key encoder."""
    parts = {f"model {k}": v for k, v in state.model.state_dict().items()
             if v.is_floating_point()}
    if state.moco is not None:
        parts["queues"] = state.moco.queues
        parts["ptr"] = torch.tensor(state.moco.ptr)
        parts.update({f"key {k}": v for k, v in
                      state.key_model.named_parameters()})
    else:
        parts["banks"] = state.banks
    return {k: v.detach().cpu().clone() for k, v in parts.items()}


def run_baseline_step(cfg, model: torch.nn.Module, dev: str, batch: dict,
                      n_data: int, mem: Optional[torch.Tensor] = None,
                      control: Optional[Callable] = None,
                      capture: bool = False) -> dict:
    """One step of a copy of `model` on `dev` through create_train_state
    and make_contrast_train_step, its banks or queue set to `mem` (None:
    as drawn), the batch's images in the model's parameter dtype;
    `control(model)` alters the copy first.  Returns, on the CPU: the
    metrics, the banks or queue before the step (`before`), the state
    after (baseline_state_parts) and, with `capture`, the output dicts of
    the query and the key pass and each encoder's layer4 map (`maps`)."""
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    m = copy.deepcopy(model).to(dev)
    if control is not None:
        control(m)
    st = create_train_state(cfg, m, torch.Generator(dev).manual_seed(3),
                            n_data=n_data, steps_per_epoch=10)
    bank = st.moco.queues if st.moco is not None else st.banks
    if mem is not None:
        with torch.no_grad():
            bank.copy_(mem)
    before = bank.detach().cpu().clone()
    dtype = next(m.parameters()).dtype
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    for k in ("rgbd", "rgbd_jig"):
        if k in b:
            b[k] = b[k].to(dtype)
    seen = {"query": None, "key": None, "maps": {}}
    hooks = []
    if capture:
        def keep(where):
            def hook(mod, args, out):
                seen[where] = {k: v.detach().cpu().clone()
                               for k, v in out.items()}
            return hook

        def keep_map(name):
            def hook(mod, args, out):
                seen["maps"][name] = out.detach().cpu().clone()
            return hook

        hooks.append(m.register_forward_hook(keep("query")))
        if st.key_model is not None:
            hooks.append(st.key_model.register_forward_hook(keep("key")))
        hooks += [mod.register_forward_hook(keep_map(name))
                  for name, mod in m.named_modules()
                  if name.endswith("layer4")]
    metrics = make_contrast_train_step(cfg, m, steps_per_epoch=10)(st, b)
    for h in hooks:
        h.remove()
    return dict(seen, metrics={k: float(v) for k, v in metrics.items()},
                before=before, state=baseline_state_parts(st))


def small_baseline_check(card: str, label: str, kw: dict) -> None:
    """One step of a baseline on the card and on the CPU (the CPU path is
    held against the JAX package by tests/test_torch_baseline_step.py and
    test_torch_moco.py) from the same weights, banks or queue and pinned
    draws, the model in float64: metrics, parameters, BN statistics,
    banks or queue and pointer, and the EMA within BASELINE_SMALL_TOL."""
    from hcmoco_tpu_torch.models.build import build_model

    cfg = baseline_cfg(**kw)
    n = BASELINE_SMALL_N_DATA
    batch = baseline_batch(cfg, np.random.default_rng(5), n)
    torch.manual_seed(0)
    model = model_f64(build_model(cfg, device="cpu"))
    ref = run_baseline_step(cfg, model, "cpu", batch, n)
    got = run_baseline_step(cfg, model, "cuda", batch, n, mem=ref["before"])
    (m_ref, s_ref), (m_got, s_got) = ((r["metrics"], r["state"])
                                      for r in (ref, got))
    for k, ref in m_ref.items():
        tol = BASELINE_SMALL_TOL
        if not abs(m_got[k] - ref) <= tol["atol"] + tol["rtol"] * abs(ref):
            raise AssertionError(f"{label} f64 step {k}: card {m_got[k]} vs "
                                 f"cpu {ref}")
    worst = 0.0
    for k, ref in s_ref.items():
        torch.testing.assert_close(s_got[k], ref, **BASELINE_SMALL_TOL,
                                   msg=lambda msg, k=k: f"{label} {k}: {msg}")
        if ref.is_floating_point():
            worst = max(worst, float((s_got[k] - ref).abs().max()))
    print(f"baseline {label} ({cfg.arch} {cfg.crop_size}^2 bs{cfg.batch_size}"
          f", {cfg.mem}) float64 step, card vs cpu: loss {m_got['loss']:.10f}"
          f" vs {m_ref['loss']:.10f}; state max abs diff {worst:.3g} "
          f"(tolerance {BASELINE_SMALL_TOL}) [{card}]")


def bn_eps_control(model: torch.nn.Module) -> None:
    """A broken control: every BN at eps 1e-3 (Keras's default) instead of
    the reference's 1e-5."""
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.eps = 1e-3


def stem_bgr_control(model: torch.nn.Module) -> None:
    """A broken control: each encoder's input channels in reverse order
    (BGR for RGB, ba for CMC's ab), by its stem's weights."""
    with torch.no_grad():
        for name, m in model.named_children():
            if name.startswith("encoder"):
                # a ResNeSt's deep stem is a Sequential, its first conv at 0
                stem = (m.conv1[0] if isinstance(m.conv1, torch.nn.Sequential)
                        else m.conv1)
                stem.weight.copy_(stem.weight.flip(1))


def head_bf16_control(model: torch.nn.Module) -> None:
    """A broken control: the projection heads in bf16, the dtype error the
    f32 glue after a bf16 encoder must not make."""
    for name, m in model.named_children():
        if name.startswith("head"):
            m.to(torch.bfloat16)


def f32_margins(run: dict, cpu: dict, ref: dict) -> dict:
    """{group: d(run) / (BASELINE_F32_RATIO d(cpu) + BASELINE_F32_FLOOR
    |ref|)}, d the L2 distance from the float64 step `ref` over the
    group's tensors (params, bn: the running statistics, memory: the
    banks or queue, key: the key encoder) or of the loss: a group passes
    at <= 1, the card no further from float64 than the CPU's f32 allows."""
    def dist(r, keys):
        return sum(float(((r["state"][k].double() - ref["state"][k].double())
                          ** 2).sum()) for k in keys) ** 0.5

    groups = {}
    for k, v in ref["state"].items():
        if v.is_floating_point():
            g = ("memory" if k in ("queues", "banks") else
                 "key" if k.startswith("key ") else
                 "bn" if "running_" in k else "params")
            groups.setdefault(g, []).append(k)
    out = {}
    for g, keys in groups.items():
        norm = sum(float((ref["state"][k].double() ** 2).sum())
                   for k in keys) ** 0.5
        out[g] = dist(run, keys) / (BASELINE_F32_RATIO * dist(cpu, keys)
                                    + BASELINE_F32_FLOOR * norm)
    loss = ref["metrics"]["loss"]
    out["loss"] = abs(run["metrics"]["loss"] - loss) / (
        BASELINE_F32_RATIO * abs(cpu["metrics"]["loss"] - loss)
        + BASELINE_F32_FLOOR * abs(loss))
    return out


def bf16_gaps(run: dict, cpu: dict) -> dict:
    """The bf16 card step against the f32 CPU step: the largest abs
    difference of the features (every feat* of the query and key passes,
    unit vectors) and the loss's abs difference."""
    feat = 0.0
    for where in ("query", "key"):
        for k, v in (cpu[where] or {}).items():
            if k.startswith("feat"):
                feat = max(feat, float((run[where][k].float() - v).abs()
                                       .max()))
    return {"feat": feat,
            "loss": abs(run["metrics"]["loss"] - cpu["metrics"]["loss"])}


def glue_gaps(cfg, model: torch.nn.Module, batch: dict, run: dict) -> dict:
    """The f32 glue after the encoders of the card step `run`, replayed on
    the CPU from its captured encoder outputs: _pool of each layer4 map,
    the heads at `model`'s weights (the key encoder's equal them before the
    step) on the pooled features, the loss from the features and the
    banks or queue before the step, and the banks or queue after.  ->
    {part: largest abs difference from the card's}.  MoCo (modal RGB) on
    the queue and CMC on banks."""
    from hcmoco_tpu_torch.contrast.losses import (compute_loss_accuracy,
                                                  nce_loss_and_acc)
    from hcmoco_tpu_torch.contrast.memory import (memory_logits, moco_logits,
                                                  update_memory)
    from hcmoco_tpu_torch.models.resnet import _pool

    def gap(a, b):
        return float((a.float() - b.float()).abs().max())

    q, k = run["query"], run["key"]
    suffixes = sorted(n[len("pooled"):] for n in q if n.startswith("pooled"))
    maps = [run["maps"][n] for n in sorted(run["maps"])]
    out = {"pool": max(gap(_pool(fm), q[f"pooled{s}"])
                       for fm, s in zip(maps, suffixes))}
    head = 0.0
    with torch.no_grad():
        for s in suffixes:
            h = getattr(model, f"head{s}")
            for o in ((q, k) if k is not None else (q,)):
                head = max(head, gap(h(o[f"pooled{s}"]), o[f"feat{s}"]))
        mem, t = run["before"], cfg.nce_t
        after = mem.clone()
        if cfg.mem == "moco":
            loss = nce_loss_and_acc(moco_logits(q["feat"], k["feat"],
                                                mem[0], t))[0]
            after[0, :k["feat"].shape[0]] = k["feat"].float()
        else:
            idx = torch.from_numpy(batch["neg_idx"]).long()
            y = torch.from_numpy(batch["index"]).long()
            dense = ((cfg.dense_scores or cfg.bank_logits != "gather")
                     and mem.shape[1] <= cfg.counts_max_n_data)
            losses = compute_loss_accuracy(
                [memory_logits(q["feat1"], mem[1], idx, t, dense),
                 memory_logits(q["feat2"], mem[0], idx, t, dense)])[0]
            loss = sum(losses)
            for i in range(2):
                update_memory(after[i], q[f"feat{i + 1}"], y, cfg.nce_m)
    out.update(head=head,
               loss=abs(float(loss) - run["metrics"]["loss"]),
               memory=gap(after, run["state"]["queues" if k is not None
                                              else "banks"]))
    return out


def baseline_dtype_readings(label: str, kw: dict,
                            size: dict = BASELINE_DTYPE_SIZE) -> dict:
    """One step of `label` at `size` (BASELINE_DTYPE_SIZE) on the CPU in
    float64 and f32 and on the card in f32 and bf16 (convs; heads, logits
    and memory f32), each card step also with its broken control, from
    the same weights, memory and pinned draws.  -> the readings the checks
    hold: f32_margins of the card's f32 step and of its BN-eps control;
    bf16_gaps of the bf16 step and of its BGR control; glue_gaps of the
    bf16 step and of its bf16-heads control."""
    from hcmoco_tpu_torch.models.build import build_model

    cfg = baseline_cfg(**kw, **size)
    n = BASELINE_SMALL_N_DATA
    batch = baseline_batch(cfg, np.random.default_rng(7), n)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    bf16 = with_compute_dtype(copy.deepcopy(model), torch.bfloat16)
    ref = run_baseline_step(cfg, model_f64(copy.deepcopy(model)), "cpu",
                            batch, n)
    mem = ref["before"]

    def step(m, dev, control=None):
        return run_baseline_step(cfg, m, dev, batch, n, mem=mem,
                                 control=control, capture=True)

    cpu = step(model, "cpu")
    runs = {"f32": step(model, "cuda"),
            "f32 eps control": step(model, "cuda", bn_eps_control),
            "bf16": step(bf16, "cuda"),
            "bf16 bgr control": step(bf16, "cuda", stem_bgr_control),
            "bf16 heads control": step(bf16, "cuda", head_bf16_control)}
    f32 = ["f32", "f32 eps control"]
    for name, r in runs.items():
        if "ptr" in cpu["state"] and not torch.equal(r["state"]["ptr"],
                                                     cpu["state"]["ptr"]):
            raise AssertionError(f"{label} {name}: queue pointer "
                                 f"{r['state']['ptr']} vs the CPU's")
    return {"cfg": cfg,
            "f32": {name: f32_margins(runs[name], cpu, ref) for name in f32},
            "bf16": {name: bf16_gaps(runs[name], cpu)
                     for name in ("bf16", "bf16 bgr control")},
            "glue": {name: glue_gaps(cfg, model, batch, runs[name])
                     for name in ("bf16", "bf16 heads control")},
            "loss": {"cpu f64": ref["metrics"]["loss"],
                     "cpu f32": cpu["metrics"]["loss"],
                     **{name: r["metrics"]["loss"]
                        for name, r in runs.items()}}}


def baseline_dtype_check(card: str, label: str, kw: dict,
                         size: dict = BASELINE_DTYPE_SIZE) -> None:
    """The baseline step in the dtypes users run, card vs CPU, at a size
    where BN is well conditioned (baseline_dtype_readings): the card's
    f32 step within f32_margins <= 1 of the float64 step in every group
    and the loss; its bf16 step within BASELINE_BF16_TOL of the f32 CPU
    step (features and loss); the bf16 step's glue within
    BASELINE_GLUE_TOL of its CPU replay.  Each check must fail its broken
    control, or it has no teeth.  `size`: the arch, crop, batch and
    nce_k."""
    r = baseline_dtype_readings(label, kw, size)
    cfg = r["cfg"]
    head = (f"baseline {label} ({cfg.arch} {cfg.crop_size}^2 "
            f"bs{cfg.batch_size}, {cfg.mem})")
    f32 = {name: max(v.values()) for name, v in r["f32"].items()}
    bf16 = {name: max(v[k] / BASELINE_BF16_TOL[k] for k in v)
            for name, v in r["bf16"].items()}
    glue = {name: max(v.values()) / BASELINE_GLUE_TOL
            for name, v in r["glue"].items()}
    print(f"{head} f32 card step vs the float64 CPU step, over "
          f"{BASELINE_F32_RATIO} x the f32 CPU step's distance + "
          f"{BASELINE_F32_FLOOR:.3g} of the norm: {r['f32']} [{card}]")
    print(f"{head} bf16 card step vs the f32 CPU step (max abs; tolerance "
          f"{BASELINE_BF16_TOL}): {r['bf16']} [{card}]")
    print(f"{head} f32 glue of the bf16 card step vs its CPU replay (max "
          f"abs; tolerance {BASELINE_GLUE_TOL}): {r['glue']}; losses "
          f"{r['loss']} [{card}]")
    for check, worst, sound, control in (
            ("f32", f32, "f32", "f32 eps control"),
            ("bf16", bf16, "bf16", "bf16 bgr control"),
            ("glue", glue, "bf16", "bf16 heads control")):
        if not worst[sound] <= 1.0:
            raise AssertionError(f"{head} {check} check failed: "
                                 f"{worst[sound]:.3g} of its tolerance")
        if not worst[control] > 1.0:
            raise AssertionError(f"{head} {check} check passed its broken "
                                 f"control ({control}: {worst[control]:.3g}"
                                 " of its tolerance)")


def drive_baseline(card: str, label: str, kw: dict, n_data: int,
                   warmup: int = 2, steps: int = 5,
                   arch: str = "resnet50") -> None:
    """`warmup` + `steps` full-width steps (`arch`, 224^2, bf16) through
    build_model, create_train_state and make_contrast_train_step on one
    batch built from seeded numpy; the draws from the step's generator.
    Prints device ms a step (CUDA events), the host median, the busy share
    and launches a step (torch.profiler over one more step), and the peak
    memory.  Raises on a non-finite metric, bank or queue row, or a queue
    pointer that did not advance by the batch each step."""
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = baseline_cfg(arch=arch, crop_size=224, compute_dtype="bfloat16",
                       **kw)
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    spe = n_data // cfg.batch_size
    state = create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                               n_data=n_data, steps_per_epoch=spe)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=spe)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in baseline_batch(
        cfg, np.random.default_rng(9), n_data, pins=False).items()}
    gen = torch.Generator(dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host, dev_ms, metrics = [], [], []
    for i in range(warmup + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        m = step(state, batch, gen)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= warmup:
            host.append(time.perf_counter() - t0)
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        metrics.append({k: float(v) for k, v in m.items()})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    kernels = [us for name, us in rows
               if not name.startswith(("Memcpy", "Memset"))]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, mm in enumerate(metrics):
        if not all(np.isfinite(v) for v in mm.values()):
            raise AssertionError(f"{label} step {i}: non-finite {mm}")
    n_steps = warmup + steps + 1
    if state.moco is not None:
        if not bool(torch.isfinite(state.moco.queues).all()):
            raise AssertionError(f"{label}: non-finite queue rows")
        want = n_steps * cfg.batch_size % cfg.nce_k
        if state.moco.ptr != want:
            raise AssertionError(f"{label}: queue pointer {state.moco.ptr} "
                                 f"after {n_steps} steps, expected {want}")
        mem = (f"queue {tuple(state.moco.queues.shape)} "
               f"{state.moco.queues.numel() * 4 / 1e6:.1f} MB, pointer "
               f"{state.moco.ptr} = {n_steps} x {cfg.batch_size} mod "
               f"{cfg.nce_k}")
    else:
        if not bool(torch.isfinite(state.banks).all()):
            raise AssertionError(f"{label}: non-finite bank rows")
        mem = (f"banks {tuple(state.banks.shape)} "
               f"{state.banks.numel() * 4 / 1e9:.2f} GB, NCE form "
               + ("gather" if n_data > cfg.counts_max_n_data else "dense"))
    med_ms = statistics.median(host) * 1e3
    kernel_ms = sum(kernels) / 1e3
    print(f"baseline {label} 224^2 bs{cfg.batch_size} bf16 ({cfg.mem}, "
          f"{cfg.modal}, jigsaw {cfg.jigsaw}, nce_k {cfg.nce_k}): device "
          f"{statistics.median(dev_ms):.2f} ms a step (CUDA events, median "
          f"of {steps}: " + ", ".join(f"{t:.2f}" for t in dev_ms)
          + f"), host median {med_ms:.2f} ms = "
          f"{cfg.batch_size / med_ms * 1e3:.1f} samples/s, busy share "
          f"{kernel_ms / med_ms:.3f} (profiled step's kernels "
          f"{kernel_ms:.2f} ms), {len(kernels)} launches a step, peak "
          f"memory {peak:.2f} GiB; {mem}; losses "
          + ", ".join(f"{mm['loss']:.4f}" for mm in metrics) + f" [{card}]")
    del model, state, step, batch
    torch.cuda.empty_cache()


def baseline_cli(card: str, tmp: str) -> None:
    """The baselines' user journey on a fixture ImageFolder tree of
    Kinect-free JPEGs (8 classes x 32 train and 16 val images, 192-320
    px): the folder DataSource's rate alone; main_contrast MoCov2
    ResNet-50 224^2 bs64 (K 65536) for an epoch of 4 steps and its rank-0
    checkpoint; --resume for 2 more steps (the restored queue and pointer
    equal the saved ones); then main_linear --pretrain of that run for 4
    steps with its validation's top-1/top-5."""
    from hcmoco_tpu_torch.cli import main_contrast, main_linear
    from hcmoco_tpu_torch.data.fixtures import make_image_folder_fixture

    root = make_image_folder_fixture(os.path.join(tmp, "imgs"), n_classes=8,
                                     n_per_class=32, seed=0,
                                     size=(192, 320))
    save = os.path.join(tmp, "save")
    argv = ["--method", "MoCov2", "--arch", "resnet50", "--crop_size", "224",
            "--batch_size", "64", "--nce_k", str(MOCO_K), "--dataset",
            "folder", "--data_folder", os.path.join(root, "train"),
            "--epochs", "1", "--print_freq", "1", "--model_path", save]
    rate = cli_input_rate(argv)
    print(f"baseline CLI: folder DataSource alone {rate:.1f} samples/s "
          f"(MoCov2's two crops of policy B + index, bs64, 8 threads) "
          f"[{card}]")
    from torch.profiler import ProfilerActivity, profile, schedule

    t0 = time.perf_counter()
    # torch.profiler over the epoch's last two steps
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=2,
                                   repeat=1)) as prof:
        r1 = main_contrast.main(argv, on_step=lambda _: prof.step())
    t1 = time.perf_counter()
    kernel_ms = sum(us for name, us in device_rows(prof)
                    if not name.startswith(("Memcpy", "Memset"))) / 1e3 / 2
    saved = torch.load(os.path.join(r1.ckpt_dir, "epoch_1.pt"),
                       map_location="cpu", weights_only=True)
    seen = {}
    r2 = main_contrast.main(
        argv[:argv.index("--epochs")] + ["--epochs", "2", "--resume", "auto",
                                         "--max_steps", "6"]
        + argv[argv.index("--epochs") + 2:],
        on_ready=lambda st: seen.update(
            queues=st.moco.queues.cpu().clone(), ptr=st.moco.ptr,
            step=st.step))
    t2 = time.perf_counter()
    if not (r1.state.step == 4 and seen["step"] == 4 == saved["step"]
            and seen["ptr"] == saved["ptr"] == 4 * 64
            and torch.equal(seen["queues"], saved["queues"])):
        raise AssertionError(
            f"baseline CLI resume: restored step {seen['step']} ptr "
            f"{seen['ptr']} against saved {saved['step']}, {saved['ptr']}; "
            "queues equal: "
            + str(torch.equal(seen["queues"], saved["queues"])))
    if not (r2.state.step == 6 and r2.state.moco.ptr == 6 * 64
            and len(r2.step_s) == 2):
        raise AssertionError(f"baseline CLI resume ran to step "
                             f"{r2.state.step}, pointer {r2.state.moco.ptr}")
    for label, r, t in (("MoCov2 CLI", r1, t1 - t0),
                        ("MoCov2 CLI --resume", r2, t2 - t1)):
        it_s = [a + b + c for a, b, c in zip(r.wait_s, r.upload_s, r.step_s)]
        print(f"baseline {label}: {len(r.step_s)} steps, iteration median "
              f"{statistics.median(it_s[1:] or it_s) * 1e3:.1f} ms (data "
              f"wait {statistics.median(r.wait_s) * 1e3:.1f} ms, step "
              f"{statistics.median(r.step_s) * 1e3:.1f} ms), wall {t:.1f} s "
              f"[{card}]")
    it_s = [a + b + c for a, b, c in zip(r1.wait_s, r1.upload_s, r1.step_s)]
    print(f"baseline MoCov2 CLI: device kernel time {kernel_ms:.2f} ms a "
          f"step over steps 3-4, busy share "
          f"{kernel_ms / (statistics.median(it_s[2:]) * 1e3):.3f} of their "
          f"iteration median; the DataSource alone delivers a batch of 64 "
          f"in {64 / rate * 1e3:.1f} ms [{card}]")
    print(f"baseline CLI resume: restored step 4, queue pointer 256 and the "
          f"queue equal to epoch_1.pt's; ran to step 6, pointer 384 [{card}]")
    t3 = time.perf_counter()
    # the pre-training's method: the probe loads its model whole
    run, out = capture_stdout(lambda: main_linear.main([
        "--method", "MoCov2", "--arch", "resnet50", "--data_folder", root,
        "--crop_size", "224", "--batch_size", "64", "--n_class", "8",
        "--epochs", "1", "--max_steps", "4", "--print_freq", "1",
        "--pretrain", r2.ckpt_dir]))
    top1, top5 = run.val[-1]
    if not ("=> loaded encoder" in out and len(run.metrics) == 4
            and 0 <= top1 <= top5 <= 1
            and all(np.isfinite(m["loss"]) for m in run.metrics)):
        raise AssertionError(f"main_linear: {run.metrics}, val {run.val}")
    print(f"baseline main_linear --pretrain: 4 steps, loss "
          f"{run.metrics[-1]['loss']:.4f}, val top-1 {top1:.4f} top-5 "
          f"{top5:.4f} (128 images, 8 classes), wall "
          f"{time.perf_counter() - t3:.1f} s [{card}]")


def dp_baseline_run(label: str, kw: dict, rank: int, size: int) -> dict:
    """Two steps of a baseline (resnet18 64^2, global batch 8, the model
    in float64) on this rank's rows, the draws from a generator seeded
    alike on every rank; in a world of two the ranks' state is gathered
    after every step and must be equal bit for bit.  Returns each step's
    metrics and state (baseline_state_parts)."""
    import torch.distributed as dist

    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.parallel import mesh
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = baseline_cfg(**kw)
    n = BASELINE_SMALL_N_DATA
    torch.manual_seed(0)
    model = model_f64(build_model(cfg, device=dev))
    state = create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                               n_data=n, steps_per_epoch=10)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=10)
    out = {"metrics": [], "state": []}
    rng = np.random.default_rng(11)
    for i in range(2):
        b = baseline_batch(cfg, rng, n, pins=False)
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             mesh.shard_rows(b, rank, size).items()}
        b["rgbd"] = b["rgbd"].double()
        if "rgbd_jig" in b:
            b["rgbd_jig"] = b["rgbd_jig"].double()
        m = step(state, b, torch.Generator(dev).manual_seed(200 + i))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        parts = baseline_state_parts(state)
        out["state"].append(parts)
        if size > 1:
            flat = torch.cat([v.double().reshape(-1) for v in
                              parts.values()]).to(dev)
            got = [torch.empty_like(flat) for _ in range(size)]
            dist.all_gather(got, flat)
            if not all(torch.equal(g, got[0]) for g in got):
                raise AssertionError(f"DP {label} step {i}: the ranks' "
                                     "state differs")
    return out


def dp_baseline_worker(out_path: str) -> int:
    """A rank of check_baseline_dp: joins the gloo group, runs every
    BASELINE_DP case and writes its results to out_path."""
    from hcmoco_tpu_torch.parallel import mesh

    mesh.init_distributed(backend="gloo", timeout_s=DP_TIMEOUT_S)
    try:
        rank, size = mesh.world()
        torch.save({label: dp_baseline_run(label, kw, rank, size)
                    for label, kw in BASELINE_DP}, out_path)
    finally:
        mesh.destroy()
    return 0


def check_baseline_dp(card: str) -> None:
    """MoCo and CMC with jigsaw (BASELINE_DP) on two `chip_smoke.py
    --dp-baseline-rank` processes on cuda:0 over gloo against one process
    with the ranks' BN formula: the ranks equal bit for bit after every
    step (in the ranks); metrics and state within BASELINE_SMALL_TOL of
    one process's (float64: the ranks differ by the order of their BN
    sums)."""
    t0 = time.perf_counter()
    with ranks_formula():
        one = {label: dp_baseline_run(label, kw, 0, 1)
               for label, kw in BASELINE_DP}
    t1 = time.perf_counter()
    ranks = spawn_ranks("--dp-baseline-rank")
    t2 = time.perf_counter()
    for label, _ in BASELINE_DP:
        a, b = one[label], ranks[0][label]
        worst = 0.0
        for i in range(2):
            if b["metrics"][i] != ranks[1][label]["metrics"][i]:
                raise AssertionError(f"DP {label} step {i}: the ranks' "
                                     "metrics differ")
            for k, va in a["metrics"][i].items():
                vb = b["metrics"][i][k]
                tol = BASELINE_SMALL_TOL
                if not abs(vb - va) <= tol["atol"] + tol["rtol"] * abs(va):
                    raise AssertionError(f"DP {label} step {i}: {k} {vb} on "
                                         f"2 ranks, {va} on one process")
            for k, va in a["state"][i].items():
                torch.testing.assert_close(
                    b["state"][i][k], va, **BASELINE_SMALL_TOL,
                    msg=lambda msg, k=k: f"DP {label} {k}: {msg}")
                if va.is_floating_point():
                    worst = max(worst, float((b["state"][i][k] - va).abs()
                                             .max()))
        print(f"baseline DP {label}: 2 ranks x 4 rows on cuda:0 over gloo "
              "against one process, 2 steps, float64: losses "
              + ", ".join(f"{mb['loss']:.8f}/{ma['loss']:.8f}" for ma, mb in
                          zip(a["metrics"], b["metrics"]))
              + f"; state max abs diff {worst:.3g} (tolerance "
              f"{BASELINE_SMALL_TOL}); ranks equal bit for bit after every "
              f"step [{card}]")
    print(f"baseline DP: one process {t1 - t0:.1f} s, two ranks "
          f"{t2 - t1:.1f} s [{card}]")


def baseline_phase(card: str, tmp: str) -> None:
    """The baselines on the card: the float64 card-vs-CPU steps
    (BASELINE_SMALL), the full-width steps (BASELINE_FULL), the CLI
    journey (baseline_cli) and data parallelism (check_baseline_dp).
    None of the port's kernels lies on this path: their counts must stay
    0 throughout."""
    wrappers = {**k1_wrappers(),
                **{name: fn for name, (fn, _) in point_wrappers().items()}}
    for fn in wrappers.values():
        fn.launches = 0
    # f64 means f64 and f32 f32 (TF32 off, as the rest of the smoke)
    for label, kw in BASELINE_SMALL:
        small_baseline_check(card, label, kw)
    for label, kw in BASELINE_DTYPE:
        baseline_dtype_check(card, label, kw)
    for label, kw, n_data in BASELINE_FULL:
        drive_baseline(card, label, kw, n_data)
    baseline_cli(card, tmp)
    check_baseline_dp(card)
    launched = {name: fn.launches for name, fn in wrappers.items()
                if fn.launches}
    if launched:
        raise AssertionError(f"the baseline phase launched the port's "
                             f"kernels: {launched}")


# ---- the last modules: ResNeSt, A2J's ResNet50, the non-local SemGCN and
# the model summary ----------------------------------------------------------

# the small ResNeSt of the card-vs-CPU checks: one block a stage,
# ResNeSt-50's stem (tests/torch_dp_worker.py's SMALL_RESNEST)
SMALL_RESNEST = dict(layers=(1, 1, 1, 1), stem_width=32)
RESNEST_SMALL = (
    ("ResNeSt MoCo", dict(method="MoCo", arch="resnest50", crop_size=32,
                          batch_size=4)),
    ("ResNeSt CMC dual", dict(method="CMC", arch="resnest50", crop_size=32,
                              batch_size=4)))
# the dtype check's size: the small ResNeSt at 224^2 bs8, whose layer4 BN
# sees 8 * 7 * 7 = 392 values a channel (its SplAt attention BN: 8).  Its
# f32 step runs the path users' f32 steps take, cuDNN's convs included; it
# read 31.9-39.1 of the check's margin on an H100 while the avd pool ran
# PyTorch's channels_last average pool, whose gradient is wrong on the
# card (ROADMAP F14; check_avd_pool)
RESNEST_DTYPE_SIZE = dict(arch="resnest50", crop_size=224, batch_size=8,
                          nce_k=256)
# SemGCN's Human3.6M joint pairs (16 joints, groups of 2)
SEMGCN_GROUPS = ((2, 3), (5, 6), (1, 4), (0, 7), (8, 9), (14, 15), (11, 12),
                 (10, 13))
# the grouped SemGCN card vs CPU in f32: the largest abs difference over
# the largest magnitude of the output, the input gradient and the BN
# statistics (an H100: sound 1.19e-6-3.09e-6; the joints left in group
# order 0.23-0.92; PERF.md)
NONLOCAL_TOL = 1e-5
A2J_RES_CROP = 64


# ResNeSt's avd pools at the dtype check's size, (B, C, H, W, stride):
# layer1's (is_first, stride 1) and layer2's
AVD_POOL_CALLS = ((8, 64, 56, 56, 1), (8, 128, 56, 56, 2))


def check_avd_pool(card: str) -> None:
    """ResNeSt's avd pool (models/resnest.py::_avd_pool: 3x3, padding 1)
    on the card on a channels_last tensor, in f32 and bf16: its input
    gradient against float64 on the CPU of the same values, within 1e-6
    (f32) or 2^-7 (bf16) of the gradient's largest magnitude.  Beside it
    PyTorch's F.avg_pool2d on the same channels_last tensor, the pool
    before F14 was decided, read and printed (its gradient is wrong on the
    card)."""
    import torch.nn.functional as F

    from hcmoco_tpu_torch.models.resnest import _avd_pool

    g = torch.Generator().manual_seed(21)
    for b, c, h, w, stride in AVD_POOL_CALLS:
        x0 = torch.relu(torch.randn((b, c, h, w), generator=g))
        gy0 = torch.randn((b, c, (h - 1) // stride + 1,
                           (w - 1) // stride + 1), generator=g)
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)):
            xr = x0.to(dt).double().requires_grad_()
            F.avg_pool2d(xr, 3, stride, 1).backward(gy0.to(dt).double())
            errs = {}
            for name, fn in (("_avd_pool", lambda t: _avd_pool(t, stride)),
                             ("F.avg_pool2d channels_last",
                              lambda t: F.avg_pool2d(t, 3, stride, 1))):
                x = x0.to(dt).cuda().contiguous(
                    memory_format=torch.channels_last).requires_grad_()
                fn(x).backward(gy0.to(dt).cuda())
                errs[name] = float((x.grad.cpu().double() - xr.grad).abs()
                                   .max() / xr.grad.abs().max())
            if not errs["_avd_pool"] <= tol:
                raise AssertionError(f"avd pool {(b, c, h, w)} stride "
                                     f"{stride} {dt}: gradient {errs}")
            print(f"avd pool ({b},{c},{h},{w}) stride {stride} {str(dt)[6:]}"
                  f" on the card, channels_last: input gradient vs float64 "
                  f"(of its largest magnitude; tolerance {tol:.3g}): "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" [{card}]")


@contextlib.contextmanager
def small_resnest():
    """Inside, build_model builds arch 'resnest50' as SMALL_RESNEST."""
    from hcmoco_tpu_torch.models import build
    from hcmoco_tpu_torch.models.resnest import ResNeSt

    make = build.make_resnet

    def small(name, in_channel=3, dtype=torch.bfloat16):
        if name != "resnest50":
            return make(name, in_channel, dtype)
        return ResNeSt(in_channel=in_channel, dtype=dtype, **SMALL_RESNEST)

    build.make_resnet = small
    try:
        yield
    finally:
        build.make_resnet = make


def resnest_full(card: str) -> None:
    """MoCov2 at ResNeSt-50, 224^2, K 65536, bf16 (drive_baseline), at
    bs256, or at the largest of 128 and 64 that fits if it does not."""
    for bsz in (256, 128, 64):
        try:
            drive_baseline(card, "MoCov2 ResNeSt-50",
                           dict(method="MoCov2", batch_size=bsz,
                                nce_k=MOCO_K), IMAGENET_N_DATA,
                           arch="resnest50")
            return
        except torch.cuda.OutOfMemoryError:
            print(f"baseline MoCov2 ResNeSt-50: bs{bsz} does not fit in "
                  f"the card's memory [{card}]")
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    raise AssertionError("MoCov2 ResNeSt-50 fits at none of bs256-64")


def a2j_resnet_step(model: torch.nn.Module, dev: str, depth: np.ndarray,
                    labels: np.ndarray) -> dict:
    """One downstream/a2j/train.py train step (Adam, the StepLR, cls + 3 x
    reg) of a copy of `model` on `dev` over the stride-16 grid; returns on
    the CPU the metrics, the gradients and the state after."""
    from hcmoco_tpu_torch.downstream.a2j import train as a2j

    m = copy.deepcopy(model).to(dev)
    args = a2j.build_argparser().parse_args([])
    opt = torch.optim.Adam(m.parameters(), lr=args.learning_rate,
                           weight_decay=args.weight_decay)
    grid = a2j.a2j_anchors("resnet50", depth.shape[1], dev).double()
    step = a2j.make_train_step(m, opt, a2j.step_lr_fn(
        args.learning_rate, 10, args.lr_gamma), grid, args)
    metrics = step({"depth": torch.from_numpy(depth).to(dev),
                    "label": torch.from_numpy(labels).to(dev)}, 0)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu().clone()
                      for n, p in m.named_parameters()},
            "state": {k: v.detach().cpu().clone()
                      for k, v in m.state_dict().items()}}


def small_a2j_resnet_check(card: str) -> None:
    """One float64 train step of A2JResNet at 64^2 bs2 on the card against
    the CPU (the CPU step is held against the JAX package by
    tests/test_torch_a2j_resnet.py): the losses, every gradient, the BN
    statistics and the parameters after Adam within BASELINE_SMALL_TOL
    (a gradient's atol scaled by its tensor's largest), but the heads'
    conv biases ahead of a training BN, whose gradient is zero in exact
    arithmetic (rounding noise on either side, which Adam's first step
    turns into +-lr): their gradients must be under atol x the model's
    largest gradient on both sides."""
    from hcmoco_tpu_torch.downstream.a2j.model import A2JResNet

    torch.manual_seed(0)
    model = model_f64(A2JResNet(dtype=torch.float32))
    rng = np.random.default_rng(13)
    c = A2J_RES_CROP
    depth = rng.standard_normal((2, c, c, 1))
    labels = np.concatenate([rng.uniform(0, c, (2, 15, 2)),
                             rng.standard_normal((2, 15, 1)) * 5], -1)
    ref = a2j_resnet_step(model, "cpu", depth, labels)
    got = a2j_resnet_step(model, "cuda", depth, labels)
    tol = BASELINE_SMALL_TOL
    for k, v in ref["metrics"].items():
        if not abs(got["metrics"][k] - v) <= tol["atol"] + tol["rtol"] * abs(v):
            raise AssertionError(f"A2J ResNet50 f64 step {k}: card "
                                 f"{got['metrics'][k]} vs cpu {v}")
    ahead_of_bn = {f"{h}.conv{i}.bias" for h in (
        "classificationModel", "regressionModel", "DepthRegressionModel")
        for i in range(1, 5)}
    top = max(float(v.abs().max()) for v in ref["grads"].values())
    for k in ahead_of_bn:
        noise = max(float(r["grads"][k].abs().max()) for r in (ref, got))
        if not noise <= tol["atol"] * top:
            raise AssertionError(f"A2J ResNet50 grads {k}: {noise} on a bias "
                                 "whose gradient is zero ahead of a BN")
    worst = 0.0
    for what in ("grads", "state"):
        for k, v in ref[what].items():
            if k in ahead_of_bn:
                continue
            # a gradient's atol scales with its tensor's largest
            atol = tol["atol"] * (float(v.abs().max()) if what == "grads"
                                  else 1.0)
            torch.testing.assert_close(
                got[what][k], v, rtol=tol["rtol"], atol=atol,
                msg=lambda msg, k=k, w=what: f"A2J ResNet50 {w} {k}: {msg}")
            if v.is_floating_point():
                worst = max(worst, float((got[what][k] - v).abs().max()))
    print(f"A2J ResNet50 ({c}^2 bs2) float64 train step, card vs cpu: loss "
          f"{got['metrics']['loss']:.10f} vs {ref['metrics']['loss']:.10f}; "
          f"gradients and state max abs diff {worst:.3g} (tolerance {tol}; "
          f"the 12 head conv biases ahead of BN: gradients under "
          f"{tol['atol'] * top:.3g}) [{card}]")


def nonlocal_gaps(model: torch.nn.Module, dev: str, x: np.ndarray,
                  g: np.ndarray) -> dict:
    """A train-mode forward and backward of sum(out * g) of a copy of the
    grouped SemGCN on `dev`: the output, the input's gradient and the BN
    running statistics, on the CPU."""
    m = copy.deepcopy(model).to(dev).train()
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    out = m(xt)
    (out * torch.from_numpy(g).to(dev)).sum().backward()
    return {"out": out.detach().cpu(), "dx": xt.grad.cpu(),
            "stats": torch.cat([v.detach().cpu().reshape(-1) for k, v in
                                m.state_dict().items() if "running_" in k])}


def nonlocal_sgcn_check(card: str) -> None:
    """SemGCN(128, 4, 'mpii', nodes_group=SEMGCN_GROUPS) at bs256 in f32,
    every non-local block's W_bn scale and bias drawn away from zero (at
    init the blocks are the identity): its output, input gradient and BN
    statistics on the card against the CPU's, each's largest abs
    difference over its largest magnitude within NONLOCAL_TOL; a broken
    control, the joints left in group order after each block, must fail
    it."""
    from hcmoco_tpu_torch.models.sgcn import (GraphNonLocal,
                                              GroupedNonLocal, SemGCN)

    torch.manual_seed(0)
    model = SemGCN(128, 4, "mpii", nodes_group=SEMGCN_GROUPS)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GraphNonLocal):
                m.W[1].weight.uniform_(0.5, 1.5)
                m.W[1].bias.uniform_(-0.5, 0.5)
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, (256, 16, 2)).astype(np.float32)
    g = rng.standard_normal((256, 16, 128)).astype(np.float32)
    broken = copy.deepcopy(model)
    for m in broken.modules():
        if isinstance(m, GroupedNonLocal):
            m.restored = torch.arange(16)
    ref = nonlocal_gaps(model, "cpu", x, g)
    gaps = {}
    for name, m in (("sound", model), ("control", broken)):
        got = nonlocal_gaps(m, "cuda", x, g)
        gaps[name] = {k: float((got[k] - v).abs().max() / v.abs().max())
                      for k, v in ref.items()}
    print(f"non-local SemGCN (128, 4 layers, 8 groups of 2) bs256 f32 train "
          f"forward + backward, card vs cpu, max abs diff over max |value| "
          f"(tolerance {NONLOCAL_TOL}): {gaps['sound']}; control (joints "
          f"left in group order): {gaps['control']} [{card}]")
    if not max(gaps["sound"].values()) <= NONLOCAL_TOL:
        raise AssertionError(f"non-local SemGCN card vs cpu: {gaps['sound']}")
    if not max(gaps["control"].values()) > NONLOCAL_TOL:
        raise AssertionError("the non-local SemGCN check passed its broken "
                             f"control: {gaps['control']}")


def summary_models(dev: str) -> list:
    """(label, model, example inputs) of every full-width model the smoke
    builds, one sample each, on `dev` in f32 (the count is of shapes)."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.downstream.a2j.model import A2JHRNet, A2JResNet
    from hcmoco_tpu_torch.downstream.seg.model import SegHRNet
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.resnet import make_resnet

    f32 = torch.float32
    b = synthetic_contrast_batch(np.random.default_rng(0), 1, size=320,
                                 n_data=N_DATA)
    t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    rgbd = t["rgbd"].permute(0, 3, 1, 2)
    pn = make_cfg(arch="HRNetPN", compute_dtype="float32")
    torch.manual_seed(0)
    return [
        ("HCMoCo HRNet-W18 320^2",
         build_model(make_cfg(compute_dtype="float32"), device=dev),
         (rgbd, t["skeleton"])),
        ("HCMoCo HRNetPN-W18 320^2 (4096 points)",
         build_model(pn, device=dev),
         (rgbd, t["skeleton"], t["depth_mask"], t["grid_xy"], pn.pn_ori_h,
          pn.pn_ori_w, t["depth_mean"], torch.Generator(dev).manual_seed(0))),
        ("ResNet-50 224^2", make_resnet("resnet50", dtype=f32).to(dev),
         (torch.zeros(1, 3, 224, 224, device=dev),)),
        ("ResNeSt-50 224^2", make_resnet("resnest50", dtype=f32).to(dev),
         (torch.zeros(1, 3, 224, 224, device=dev),)),
        ("parsing HRNet-W18 473^2", SegHRNet(25, 18, f32).to(dev),
         (torch.zeros(1, 3, 473, 473, device=dev),)),
        ("A2J HRNet-W18 288^2", A2JHRNet(15, 9, 18, dtype=f32).to(dev),
         (torch.zeros(1, 1, 288, 288, device=dev),)),
        ("A2J ResNet50 288^2", A2JResNet(15, 16, dtype=f32).to(dev),
         (torch.zeros(1, 1, 288, 288, device=dev),))]


def summary_check(card: str) -> dict:
    """utils/summary.py's count_params and forward_flops of every
    full-width model the smoke builds (summary_models), on the card and on
    the CPU: equal, since FlopCounterMode counts shapes.  Returns {label:
    (params, forward GFLOPs an image)}."""
    from hcmoco_tpu_torch.utils.summary import count_params, forward_flops

    cpu = {label: (count_params(m), forward_flops(m, *a))
           for label, m, a in summary_models("cpu")}
    out = {}
    for label, m, a in summary_models("cuda"):
        got = (count_params(m), forward_flops(m, *a))
        if got != cpu[label]:
            raise AssertionError(f"summary {label}: card {got}, cpu "
                                 f"{cpu[label]}")
        out[label] = (got[0], got[1] / 1e9)
        print(f"summary {label}: {got[0]:,} parameters, {got[1] / 1e9:.3f} "
              f"GFLOP a forward (FlopCounterMode, 2 x multiply-adds), equal "
              f"on the card and the CPU [{card}]")
    return out


def last_modules_phase(card: str, itop: tuple) -> None:
    """The modules of ROADMAP items 11b and 14 on the card: ResNeSt (its
    avd pool's gradient in channels_last, check_avd_pool; float64 MoCo and
    CMC-dual steps of the small ResNeSt card vs CPU, the f32/bf16 dtype
    check with the baselines' broken controls, MoCov2 at
    ResNeSt-50 224^2 bs256 K 65536 bf16), A2J's ResNet50 (a float64 train
    step card vs CPU, then downstream/a2j/train.py --arch resnet50 at 288^2
    bs12 on the ITOP fixture `itop` for 8 steps and PCK@10cm), the grouped
    non-local SemGCN card vs CPU, none of which launches a kernel of the
    port; then the model summary of every full-width model."""
    from hcmoco_tpu_torch.downstream.a2j.train import main as a2j_main

    wrappers = {**k1_wrappers(),
                **{name: fn for name, (fn, _) in point_wrappers().items()}}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    check_avd_pool(card)
    with small_resnest():
        for label, kw in RESNEST_SMALL:
            small_baseline_check(card, label, kw)
        for label, kw in (("ResNeSt MoCov2", dict(method="MoCov2")),
                          ("ResNeSt CMC", dict(method="CMC"))):
            baseline_dtype_check(card, label, kw, RESNEST_DTYPE_SIZE)
    t1 = time.perf_counter()
    resnest_full(card)
    t2 = time.perf_counter()
    small_a2j_resnet_check(card)
    tr, te, btr, bte = itop
    # the trainer runs as its CLI does: cuDNN's f32 convs in TF32 (F9)
    torch.backends.cudnn.allow_tf32 = True
    try:
        r, out, _ = downstream_run(
            card, "A2J ResNet50 288^2 bs12", a2j_main, [
                "--arch", "resnet50", "--train_dir", tr, "--test_dir", te,
                "--bndbox_train", btr, "--bndbox_test", bte, "--crop",
                str(A2J_CROP), "--batch_size", str(A2J_BATCH), "--epochs",
                "2", "--max_steps", "8", "--print_freq", "4",
                "--eval_first", "--seed", "0"], A2J_BATCH, 8, 0, 0)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    import re
    pck = dict(re.findall(r"epoch (\d): PCK@10cm (\d\.\d+)", out))
    if not {"0", "1"} <= set(pck):
        raise AssertionError(f"A2J ResNet50: PCK@10cm for epochs {pck}")
    print(f"A2J ResNet50 288^2 bs12 (from scratch, 16 anchors a stride-16 "
          f"cell): PCK@10cm by epoch {pck} on {ITOP_TEST} frames [{card}]")
    del r
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    nonlocal_sgcn_check(card)
    launched = {name: fn.launches for name, fn in wrappers.items()
                if fn.launches}
    if launched:
        raise AssertionError(f"the last-modules phase launched the port's "
                             f"kernels: {launched}")
    t4 = time.perf_counter()
    summary_check(card)  # HRNetPN's forward runs the point kernels
    print(f"last-modules phase parts: ResNeSt checks {t1 - t0:.1f} s, "
          f"ResNeSt-50 MoCov2 {t2 - t1:.1f} s, A2J ResNet50 {t3 - t2:.1f} "
          f"s, non-local SemGCN {t4 - t3:.1f} s, summaries "
          f"{time.perf_counter() - t4:.1f} s [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--dp-baseline-rank"]:
        return dp_baseline_worker(sys.argv[2])
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
    sites = check_bn_sites(card)
    small_reference_check(card)
    small_stage2_check(card, "HRNet")
    # each main path is driven with the counts set to 0 just before it;
    # an entry's launches are the sum over the paths that run it (the
    # BN-site kernels': over the stage-1 slice), each the kernels that ran
    # on the card: the wrappers' launches where the encoders run eagerly,
    # the profiler's kernel records where they replay CUDA graphs
    slice_k1, site_launches = drive_slice(card)
    for entry, name in zip(sites, site_launches):
        entry["launches"] = site_launches[name]
    k1_runs = [slice_k1, drive_stage2(card, "HRNet")]
    points = check_points(card)
    check_pts2depth(card)
    check_csr_wide(card)
    check_wide_points(card)
    small_reference_check(card, "HRNetPN")
    small_reference_check(card, "HRNetPN", n_points=9000, size=96,
                          batch_size=4)
    small_stage2_check(card, "HRNetPN")
    check_build_wide(card)
    pn_runs = [drive_pn(card), drive_stage2(card, "HRNetPN"),
               drive_pn(card, PN_WIDE_POINTS, PN_WIDE_BATCH),
               drive_stage2(card, "HRNetPN", PN_WIDE_POINTS, PN_WIDE_BATCH)]
    t_remat = time.perf_counter()
    remat_k1, remat_pn = remat_phase(card)
    k1_runs += remat_k1
    pn_runs += remat_pn
    print(f"remat phase wall time: {time.perf_counter() - t_remat:.1f} s "
          f"[{card}]")
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
        down_k1, itop = downstream_phase(
            card, os.path.join(tmp, "encoder2.pth"), tmp)
        print(f"downstream phase wall time: "
              f"{time.perf_counter() - t_down:.1f} s [{card}]")
        t_dp = time.perf_counter()
        dp_k1, dp_pn = check_data_parallel(card)
        print(f"data-parallel phase wall time: "
              f"{time.perf_counter() - t_dp:.1f} s [{card}]")
        t_base = time.perf_counter()
        baseline_phase(card, tmp)
        print(f"baseline phase wall time: "
              f"{time.perf_counter() - t_base:.1f} s [{card}]")
        t_last = time.perf_counter()
        last_modules_phase(card, itop)
        print(f"last-modules phase wall time: "
              f"{time.perf_counter() - t_last:.1f} s [{card}]")
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
    kernels = [{k: e[k] for k in keys} for e in k1 + sites + points]
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
