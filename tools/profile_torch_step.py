"""Time and profile the PyTorch port's stage-1 step on one CUDA card, with the
fused 1x1 ConvBN path (K1 + K1b) on and off.

Usage: python3 tools/profile_torch_step.py [--batch 32] [--steps 6]
                                           [--warmup 2] [--profile-steps 2]

Builds the W18 320^2 stage-1 model of chip_smoke.py once and switches its
ConvBN path with set_convbn_fuse between blocks of steps, in the order
on, off, off, on, on, off, so that both paths see the same drift of the
host.  Prints, with the card's name and power limit:
  - per path, the median step time and quartiles over all its steps
    (host clock around torch.cuda.synchronize(), no profiler);
  - per path, a torch.profiler breakdown over --profile-steps steps: device
    kernel ms per step by kernel class, the top kernels, kernel launches per
    step, and the device busy share (kernel time over the median unprofiled
    step time);
  - per path, the kernels one layer1 ConvBN site (64 -> 256 channels at
    80x80, forward and backward) launches, counted from the profiler's
    kernel rows.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# (class, substrings of the lower-cased kernel name), first match wins
_CLASSES = (
    ("K1b BN apply, its backward, K1's dyt prologue", ("k1b_",)),
    ("K1 mm_bn (fused 1x1 conv + BN stats)", ("mm_bn",)),
    ("cuDNN batch norm", ("batchnorm", "batch_norm", "welford")),
    # before convolution: the channels_last kernels are named *_nhwc_*
    ("bilinear upsample", ("upsample", "interp")),
    ("cuDNN convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                           "dgrad", "sm90_", "nhwc")),
    ("cuBLAS gemm", ("gemm", "cutlass", "matmul")),
    ("reductions", ("reduce",)),
    ("copies, casts, fills", ("copy", "memcpy", "memset", "fill")),
    ("elementwise arithmetic", ("mul", "add", "sub", "rsqrt", "div", "clamp",
                                "where", "threshold", "relu")),
)


def kernel_class(name: str) -> str:
    k = name.lower()
    for cls, keys in _CLASSES:
        if any(s in k for s in keys):
            return cls
    return "other elementwise"


def kernel_rows(prof):
    """The profile's kernel rows: a user annotation such as
    Optimizer.step#SGD.step also has a device row, spanning kernels counted
    on their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def site_launches(card: str, batch: int, n: int = 3) -> None:
    """Kernels launched by one layer1 ConvBN site (the downsample, 64 -> 256
    channels at 80x80), forward and backward, fused and unfused; and the
    site's wall time per call over 20 calls, at `batch` and at batch 1
    (where the card waits on the host, so it reads the host's time)."""
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.models.hrnet import ConvBN, set_convbn_fuse

    dev = torch.device("cuda")
    cl = torch.channels_last
    cb = ConvBN(64, 256, 1, 1, False, torch.bfloat16).to(dev, memory_format=cl)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((batch, 64, 80, 80), generator=g, device=dev).to(
        torch.bfloat16, memory_format=cl).requires_grad_()
    gy = torch.randn((batch, 256, 80, 80), generator=g, device=dev).to(
        torch.bfloat16, memory_format=cl)

    def run():
        cb.zero_grad(set_to_none=True)
        x.grad = None
        torch.autograd.backward(cb(x), gy)

    for on in (True, False):
        set_convbn_fuse(cb.train(), on)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        launches = sum(e.count for e in rows) / n
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
        walls = []
        for xb, gb in ((x, gy), (x[:1].detach().requires_grad_(), gy[:1])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                cb.zero_grad(set_to_none=True)
                torch.autograd.backward(cb(xb), gb)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 20 * 1e3)
        print(f"\n== one layer1 ConvBN site (bs{batch}, 64->256 at 80x80), "
              f"fuse={int(on)}: {launches:g} kernel launches, {ms:.3f} device "
              f"ms, forward and backward; wall {walls[0]:.3f} ms a call, "
              f"{walls[1]:.3f} ms at bs1 [{card}]")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total):
            print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms "
                  f"{e.count / n:5g} launches  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6,
                    help="timed steps per block (6 blocks)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed steps at the start of each block")
    ap.add_argument("--profile-steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step.py needs a CUDA device")

    import chip_smoke as smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card)
    dev = torch.device("cuda")
    cfg = smoke.make_cfg(batch_size=args.batch)
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=smoke.N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = smoke.to_device(synthetic_contrast_batch(
        np.random.default_rng(0), args.batch, size=cfg.crop_size,
        n_data=smoke.N_DATA), dev)

    times = {True: [], False: []}
    for on in (True, False, False, True, True, False):
        set_convbn_fuse(model, on)
        for _ in range(args.warmup):
            step(state, batch, gen)
        torch.cuda.synchronize()
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step(state, batch, gen)
            torch.cuda.synchronize()
            times[on].append(time.perf_counter() - t0)
    medians = {}
    for on, ts in times.items():
        med = statistics.median(ts)
        medians[on] = med
        q1, q3 = np.percentile(ts, [25, 75])
        print(f"fuse={int(on)}: median {med * 1e3:.2f} ms, quartiles "
              f"{q1 * 1e3:.2f}-{q3 * 1e3:.2f} ms over {len(ts)} steps, "
              f"{args.batch / med:.2f} samples/s [{card}]")
        print("  steps (ms): " + " ".join(f"{t * 1e3:.1f}" for t in ts))

    n = args.profile_steps
    for on in (True, False):
        set_convbn_fuse(model, on)
        step(state, batch, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(state, batch, gen)
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        total = sum(e.self_device_time_total for e in rows) / 1e3 / n
        launches = sum(e.count for e in rows) / n
        print(f"\n== fuse={int(on)}: device kernel time {total:.2f} ms/step, "
              f"busy share {total / (medians[on] * 1e3):.3f} of the median "
              f"unprofiled step, {launches:g} kernel launches/step [{card}]")
        classes = {}
        for e in rows:
            cls = kernel_class(e.key)
            classes[cls] = classes.get(cls, 0.0) + (
                e.self_device_time_total / 1e3 / n)
        for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
            print(f"  [class] {ms:9.3f} ms/step  {cls}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
                  f"{e.count // n:6d} calls/step  {e.key[:100]}")
        host = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        print("  host: top rows by self CPU time (profiled, so inflated)")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
            print(f"  {e.self_cpu_time_total / 1e3 / n:9.3f} ms/step "
                  f"{e.count // n:6d} calls/step  {e.key[:100]}")
    del state, step, model
    site_launches(card, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
