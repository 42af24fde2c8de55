"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the main path's
shapes, and drives the stage-1 HCMoCo train step (HRNet-W18 x2 + SemGCN,
320^2 crops, bank NCE with K=16384) with HCMOCO_CONVBN_FUSE=1.

    python3 chip_smoke.py

Needs CUDA; raises without it.  Every phase raises on failure, so the exit
code is non-zero unless all of them passed.  The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and the line before it a JSON object with each kernel's launches on the
main path, its error against the plain version and both times.
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
N_DATA = 8192


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def check_k1(card: str) -> dict:
    """K1 against its plain version at the W18 main-path shapes (bs32,
    320^2): y within 1 bf16 ulp, s1/s2 within 1e-5 of f64 sums of the
    kernel's own y (relative to each channel's sum of magnitudes), dx/dw through the autograd.Function within rel 1e-2 of
    plain autograd (bf16 operands: the two round dy_total at different
    points)."""
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [  # (R, K, C, site)
        (204800, 64, 256, "layer1 cb3/downsample 80x80"),
        (204800, 256, 64, "layer1 cb1 80x80"),
        (51200, 36, 18, "fuse0_1 at 40x40"),
        (12800 + 37, 144, 72, "ragged R, fuse2_3-like"),
    ]
    max_err = 0.0
    main = None
    for r, k, c, site in shapes:
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = (torch.randn((c, k), generator=g, device="cuda")
             / k ** 0.5).bfloat16()
        y, s1, s2 = mb.mm_bn_stats_cuda(x, w)
        yp, s1p, s2p = mb.mm_bn_stats_plain(x, w)
        torch.cuda.synchronize()
        yf, ypf = y.float(), yp.float()
        err = (yf - ypf).abs()
        bad = err > bf16_ulp(torch.maximum(yf.abs(), ypf.abs()))
        if bool(bad.any()):
            raise AssertionError(f"K1 y off by more than 1 bf16 ulp at {site}"
                                 f": {int(bad.sum())} elements")
        max_err = max(max_err, float(err.max()))
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
        ms = cuda_ms(lambda: mb.mm_bn_stats_cuda(x, w))
        plain_ms = cuda_ms(lambda: mb.mm_bn_stats_plain(x, w))
        print(f"K1 R={r} K={k} C={c} ({site}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, y max|err| {float(err.max()):.6g}, "
              f"s1/s2/dx/dw ok [{card}]")
        if main is None:
            main = (ms, plain_ms)
    return {"name": "mm_bn_stats (fused 1x1 conv + BN stats)",
            "route": "cuda",
            "source": "hcmoco_tpu_torch/csrc/matmul_bn.cu",
            "replaces": "hcmoco_tpu/ops/pallas/matmul_bn.py:34",
            "max_abs_err": max_err, "ms": main[0], "plain_ms": main[1]}


def make_cfg(**kw):
    from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config

    base = dict(method="CMCRGBD2S", arch="HRNet", width=18,
                batch_size=BATCH, epochs=100, learning_rate=0.03,
                cosine=True, nce_k=16384, modality_missing=True,
                crop_size=320, compute_dtype="bfloat16")
    base.update(kw)
    return resolve_config(TrainConfig(**base))


def to_device(batch: dict, device) -> dict:
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb")
    return {k: torch.from_numpy(batch[k]).to(device) for k in keys}


def small_reference_check(card: str) -> None:
    """One f32 train step of the tiny (width-4, 32^2) model on the card vs
    the same step on the CPU (the CPU path is held against the JAX package
    by tests/test_torch_*.py): losses, updated params and banks within rel
    1e-4.  Plain ConvBN path: K1 is bf16-only, and the tiny model in bf16
    moves its features by 2% between any two bf16 implementations, so K1
    is held against its plain version by check_k1 and, at W18, by the
    fused-vs-unfused step in drive_slice."""
    from hcmoco_tpu_torch.contrast.memory import sample_negative_counts
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cfg = make_cfg(width=4, crop_size=32, batch_size=6, nce_k=15,
                   compute_dtype="float32")
    rng = np.random.default_rng(1)
    batch = synthetic_contrast_batch(rng, 6, size=32, n_data=64)
    # depth of every sample non-zero: the synthetic all-zero depth samples
    # leave the tiny depth encoder too ill-conditioned to compare
    batch["rgbd"] = (rng.standard_normal((6, 32, 32, 6)) * 0.5).astype(
        np.float32)
    counts = sample_negative_counts(torch.Generator().manual_seed(2), 6, 64,
                                    15)
    torch.manual_seed(0)
    model = set_convbn_fuse(build_model(cfg), False)
    banks = None
    res = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
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
        res[dev] = (losses, {k: v.cpu() for k, v in m.state_dict().items()},
                    st.banks.cpu())
    (l_ref, sd_ref, b_ref), (l_got, sd_got, b_got) = res["cpu"], res["cuda"]
    for k, ref in l_ref.items():
        if not abs(l_got[k] - ref) <= 1e-4 * abs(ref):
            raise AssertionError(f"tiny step {k}: card {l_got[k]} vs cpu {ref}")
    for k, ref in list(sd_ref.items()) + [("banks", b_ref)]:
        got = sd_got[k] if k != "banks" else b_got
        if ref.is_floating_point():
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, k=k: f"tiny step {k}: {m}")
    print(f"tiny f32 step, card vs cpu: loss {l_got['loss']:.6f} vs "
          f"{l_ref['loss']:.6f}, params and banks within rtol 1e-4 [{card}]")


def drive_slice(card: str) -> int:
    """Stage-1 W18 320^2 bs32 train steps through the user entry points,
    HCMOCO_CONVBN_FUSE=1; returns K1's launches during the steps."""
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import fused_sites, set_convbn_fuse
    from hcmoco_tpu_torch.ops.matmul_bn import mm_bn_stats_cuda
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
    mm_bn_stats_cuda.launches = 0
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()
                       if k.startswith("nce_loss") or k == "loss"})
    launches = mm_bn_stats_cuda.launches
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"step {i}: non-finite loss {l}")
    if launches != sites * STEPS:
        raise AssertionError(f"K1 launched {launches} times in {STEPS} steps,"
                             f" expected {sites} sites x {STEPS}")
    if not bool(torch.isfinite(state.banks).all()):
        raise AssertionError("non-finite bank rows")
    print("losses per step: " + ", ".join(f"{l['loss']:.5f}" for l in losses))
    print("step times (s): " + ", ".join(f"{t:.4f}" for t in times)
          + f"; first step includes warm-up [{card}]")
    steady = statistics.median(times[1:])
    print(f"W18 320^2 bs{BATCH} fused stage-1 step: median {steady * 1e3:.2f}"
          f" ms = {BATCH / steady:.2f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
          f"{launches} = {sites} sites x {STEPS} steps [{card}]")
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

    k1 = check_k1(card)
    small_reference_check(card)
    k1["launches"] = drive_slice(card)
    k1 = {k: k1[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                             "hcmoco_tpu"))
    if jax_mods:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{jax_mods[:10]}")
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
