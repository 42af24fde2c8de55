"""Time kernel K1 (and the K1b kernels, where the tree has them) and one fused
1x1 ConvBN site, forward and backward, on one CUDA card.

Usage: python3 tools/bench_matmul_bn.py

Runs the tree it sits in, so a copy of it (with this tree's chip_smoke.py)
in an older checkout times that checkout's kernels by the same method:
chip_smoke.cuda_ms, back-to-back calls between CUDA events behind a device
spin, so the times are the card's and not the host's.  Prints, with the
card's name and power limit, at the layer1 shapes of the W18 bs32 320^2
step (R = 204800 rows):
  - K1 (mm_bn_stats_cuda) device ms;
  - each K1b kernel's device ms, if ops.matmul_bn has it;
  - the fused site (conv1x1_bn_stats + bn_apply_stats, then backward of
    both) device ms, and its host ms a call at R = 6400 (bs1), where the
    card waits on the host;
then K1 at every (R, K, C) of the step's fused sites, found by one
training forward of both HRNets at bs1 (R scaled to bs32): each shape's
sites a step, K1 ms against its bound and torch.matmul's ms (y only), and
K1's ms a step over the layer1 shapes' fast path and the others' generic
path apart, each shape's plain-version ms, and the launch floor (an empty
kernel's back-to-back time).
"""

import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

SHAPES = ((204800, 64, 256), (204800, 256, 64), (204800, 64, 64))


def fused_site_shapes(smoke) -> collections.Counter:
    """(R, K, C) -> sites a step of the W18 bs32 320^2 fused stage-1 step,
    from one training forward of both HRNets at bs1, R scaled to bs32."""
    from hcmoco_tpu_torch.models import hrnet
    from hcmoco_tpu_torch.models.build import build_model

    seen = collections.Counter()
    real = hrnet.conv1x1_bn_stats

    def spy(x2d, w):
        seen[(x2d.shape[0] * smoke.BATCH, x2d.shape[1], w.shape[0])] += 1
        return real(x2d, w)

    model = hrnet.set_convbn_fuse(build_model(smoke.make_cfg(),
                                              device="cuda"), True)
    hrnet.conv1x1_bn_stats = spy
    try:
        with torch.no_grad():
            for enc in (model.encoder1, model.encoder2):
                enc(torch.randn((1, 3, 320, 320), device="cuda"))
    finally:
        hrnet.conv1x1_bn_stats = real
    return seen


def k1_by_path(smoke, mb, card: str) -> None:
    """K1 at every fused site's shape, fast and generic paths apart."""
    fast = {(k, c) for _, k, c in SHAPES}  # matmul_bn.cu's fast path
    g = torch.Generator("cuda").manual_seed(1)
    per_step = {"fast": 0.0, "generic": 0.0}
    shapes = fused_site_shapes(smoke)
    for (r, k, c), sites in sorted(shapes.items(), key=lambda kv: -kv[0][0]):
        x = torch.randn((r, k), generator=g, device="cuda").bfloat16()
        w = (torch.randn((c, k), generator=g, device="cuda") / k ** 0.5
             ).bfloat16()
        ms = smoke.cuda_ms(lambda: mb.mm_bn_stats_cuda(x, w))
        plain = smoke.cuda_ms(lambda: mb.mm_bn_stats_plain(x, w))
        lib = smoke.cuda_ms(lambda: torch.matmul(x, w.t()))
        bnd = smoke.bound(2 * (r * k + c * k + r * c) + 8 * c, 2 * r * k * c,
                          smoke.BF16_OPS_S)
        path = "fast" if (k, c) in fast else "generic"
        per_step[path] += sites * ms
        print(f"K1 {path} R={r} K={k} C={c}, {sites} sites a step: "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), torch.matmul "
              f"(y only) {lib:.4f} ms [{card}]")
    floor = smoke.cuda_ms(lambda: torch.cuda._sleep(0))
    print(f"K1 a fused step: fast path {per_step['fast']:.4f} ms, generic "
          f"path {per_step['generic']:.4f} ms, {sum(shapes.values())} "
          f"sites; launch floor (an empty back-to-back kernel) {floor:.4f} "
          f"ms [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_matmul_bn.py needs a CUDA device")
    import chip_smoke as smoke
    from hcmoco_tpu_torch.ops import matmul_bn as mb

    card = smoke.card_line()
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    for r, k, c in SHAPES:
        x = torch.randn((r, k), generator=g, device=dev).bfloat16()
        w = (torch.randn((c, k), generator=g, device=dev) / k ** 0.5
             ).bfloat16()
        scale = torch.rand((c,), generator=g, device=dev) + 0.5
        bias = torch.randn((c,), generator=g, device=dev)
        dout = torch.randn((r, c), generator=g, device=dev).bfloat16()
        line = (f"R={r} K={k} C={c}: K1 "
                f"{smoke.cuda_ms(lambda: mb.mm_bn_stats_cuda(x, w)):.4f} ms")
        if hasattr(mb, "bn_apply_fwd_cuda"):
            y, s1, s2 = mb.mm_bn_stats_cuda(x, w)
            _, mean, var, rstd = mb.bn_apply_fwd_cuda(y, s1, s2, scale,
                                                      bias, 1e-5)
            zero = torch.zeros((c,), device=dev)
            for name, fn in (
                    ("K1b fwd", lambda: mb.bn_apply_fwd_cuda(
                        y, s1, s2, scale, bias, 1e-5)),
                    ("bwd sums", lambda: mb.bn_apply_bwd_stats_cuda(
                        dout, y, s1, mean, var, rstd, scale, zero, zero)),
                    ("dy", lambda: mb.bn_apply_bwd_dy_cuda(dout, rstd,
                                                           scale)),
                    ("dyt", lambda: mb.mm_bn_bwd_dyt_cuda(dout, y, zero,
                                                          zero))):
                line += f", {name} {smoke.cuda_ms(fn):.4f}"
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()

        def site(xs=xs, ws=ws, dout=dout):
            xs.grad = ws.grad = None
            y2, a1, a2 = mb.conv1x1_bn_stats(xs, ws)
            out, _, _ = mb.bn_apply_stats(y2, a1, a2, scale, bias, 1e-5)
            torch.autograd.backward(out, dout)

        line += f"; fused site fwd+bwd {smoke.cuda_ms(site, iters=10):.4f} ms"
        small = (xs[:6400].detach().requires_grad_(),
                 ws.detach().requires_grad_(), dout[:6400])
        for _ in range(3):
            site(*small)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            site(*small)
        torch.cuda.synchronize()
        line += (f", host {(time.perf_counter() - t0) / 50 * 1e3:.4f} ms a "
                 f"call at R=6400 [{card}]")
        print(line)
    k1_by_path(smoke, mb, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
