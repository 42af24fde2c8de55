"""Time K5's and K6's backwards at their largest calls of the HRNetPN bs64
step, and that step end to end, on one CUDA card.

Usage: python3 tools/bench_point_bwd.py [steps]

Runs the tree it sits in, so a copy of it in an older checkout (beside
that checkout's chip_smoke.py, whose helpers it uses) times that
checkout's kernels by the same method: chip_smoke.cuda_ms, back-to-back
calls between CUDA events behind a device spin, so the times are the
card's and not the host's.  Prints, with the card's name and power limit:
  - group_rows_bwd_cuda at sa0 scale 1, (64, 4096, 32, 32) bf16 ->
    (64, 4096, 32), gidx from the ball query of a synthetic batch with
    zero clouds, and on its valid and zero-cloud samples alone;
  - interpolate_rows_bwd_cuda at fp1, (64, 4096, 512) bf16 ->
    (64, 1024, 512), likewise;
  - the HRNetPN W18 320^2 bs64 train step: the host-clock median and
    quartiles of `steps` steps (default 12) after two warm-up steps, and
    the device ms per step of all kernels and of the point kernels
    (torch.profiler over two more steps).
"""

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch


def kernel_times(smoke, card: str) -> None:
    from hcmoco_tpu_torch.models.pointnet2_model import NSAMPLE, RADIUS
    from hcmoco_tpu_torch.ops import ball_query as bq
    from hcmoco_tpu_torch.ops import point_gather as pg
    from hcmoco_tpu_torch.ops import three_nn as tn
    from hcmoco_tpu_torch.ops.point_ops import interpolation_weights

    levels, valid = smoke.point_levels("cuda", 64, 320, 4096)
    g = torch.Generator(device="cuda").manual_seed(0)
    gidx = bq.ball_query_cuda(levels[0], levels[1], RADIUS[0][1],
                              NSAMPLE[0][1])
    b, m, s = gidx.shape
    n, c = levels[0].shape[1], 32
    gout = torch.randn((b, m, s, c), generator=g, device="cuda").bfloat16()
    dist, idx = tn.three_nn_cuda(levels[1], levels[2])
    w = interpolation_weights(dist)
    k = levels[2].shape[1]
    go6 = torch.randn((b, idx.shape[1], 512), generator=g,
                      device="cuda").bfloat16()
    for label, sel in (("all", slice(None)), ("valid", valid),
                       ("zero-cloud", ~valid)):
        n_s = b if label == "all" else int(sel.sum())
        g5, i5 = gout[sel].contiguous(), gidx[sel].contiguous()
        g6, i6, w6 = (x[sel].contiguous() for x in (go6, idx, w))
        t5 = smoke.cuda_ms(lambda: pg.group_rows_bwd_cuda(g5, i5, n))
        t6 = smoke.cuda_ms(lambda: pg.interpolate_rows_bwd_cuda(g6, i6, w6,
                                                                k))
        print(f"{label} {n_s} samples: K5 bwd sa0.1 ({n_s},{m},{s},{c}) -> "
              f"({n_s},{n},{c}) {t5:.4f} ms; K6 bwd fp1 "
              f"({n_s},{idx.shape[1]},512) -> ({n_s},{k},512) {t6:.4f} ms "
              f"[{card}]")


def step_times(smoke, card: str, steps: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda")
    cfg = smoke.make_cfg(arch="HRNetPN", batch_size=64)
    torch.manual_seed(0)
    model = build_model(cfg).to(memory_format=torch.channels_last)
    gen = torch.Generator(dev).manual_seed(0)
    state = create_train_state(cfg, model, gen, n_data=smoke.N_DATA,
                               steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = smoke.to_device(synthetic_contrast_batch(
        np.random.default_rng(0), 64, size=cfg.crop_size, num_joints=16,
        n_data=smoke.N_DATA), dev)
    times = []
    for i in range(steps + 2):
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, batch, gen)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    keys = smoke.PN_CLASSES[0][1]
    total = sum(e.self_device_time_total for e in rows) / 2e3
    point = sum(e.self_device_time_total for e in rows
                if any(t in e.key.lower() for t in keys)) / 2e3
    print(f"HRNetPN W18 320^2 bs64 step over {steps} steps: median "
          f"{statistics.median(times):.2f} ms, quartiles {q1:.2f}-{q3:.2f} "
          f"(interpolated median {med:.2f}); device {total:.3f} ms/step, "
          f"point kernels {point:.3f} ms/step [{card}]")
    print("step times (ms): " + ", ".join(f"{t:.2f}" for t in times))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_point_bwd.py needs a CUDA device")
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"{card}; tree {os.path.basename(ROOT)}")
    kernel_times(smoke, card)
    step_times(smoke, card, int(sys.argv[1]) if len(sys.argv) > 1 else 12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
