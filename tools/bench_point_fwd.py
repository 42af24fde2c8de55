"""Time K2 (FPS), K3 (ball query) and K4 (three-NN) at every call of the
HRNetPN bs64 step, and K4 at pts2depth's bs64 call, on one CUDA card.

Usage: python3 tools/bench_point_fwd.py [--check]

Runs the tree it sits in, so a copy of it in an older checkout (beside
this tree's chip_smoke.py, whose helpers depth_clouds, point_levels,
cuda_ms and card_line it uses) times that checkout's kernels by the same
method: back-to-back calls between CUDA events behind a device spin, so
the times are the card's and not the host's.  Inputs: the four SA levels
of a synthetic bs64 batch with zero clouds (chip_smoke.point_levels), and
for pts2depth the same batch's 102400 pixels (depth2pts's all_pts) against
its 4096 sampled points.  Prints, with the card's name and power limit:
  - default: each call's kernel ms (K2 also in us a round) and each
    kernel's sum over the calls of one step; K4 at pts2depth's call; then
    K2 at SA1's call for clouds of 8192 and 16384 points ((64, N, 3) ->
    N/4), each held to the plain version first;
  - --check, instead: K3's scan at sa0.0 and sa0.1 (chip_smoke.k3_scan:
    the spread of the S-th hit's index, the share of centers that scan
    all N, the share of 32-point tiles the ball can reach, the tests of a
    blind scan and of the tile skip), K4's scan at every FP call and at
    pts2depth's (chip_smoke.k4_scan: the share of (warp, tile) pairs its
    walk visits, on valid and zero clouds apart), and K2-K4 against their
    plain versions at every call (torch.equal); no kernel is timed.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

FPS_CALLS = (1, 2, 3)  # the SA levels whose centers FPS picks


def calls(levels):
    """(K2 calls as (xyz, m)), (K3 calls as (label, xyz, centers, r, s)),
    (K4 calls as (label, unknown, known))."""
    from hcmoco_tpu_torch.models.pointnet2_model import NSAMPLE, RADIUS

    k2 = [(levels[k], levels[k + 1].shape[1]) for k in FPS_CALLS]
    k3 = [(f"sa{k}.{i}", levels[k], levels[k + 1], r, s)
          for k in range(4) for i, (r, s) in enumerate(zip(RADIUS[k],
                                                           NSAMPLE[k]))]
    k4 = [(f"fp{i}", levels[i], levels[i + 1]) for i in range(4)]
    return k2, k3, k4


def check(smoke, card: str, levels, valid, pts2depth) -> None:
    from hcmoco_tpu_torch.ops import ball_query as bq
    from hcmoco_tpu_torch.ops import fps as fp

    k2, k3, k4 = calls(levels)
    for label, unknown, known in k4 + [("pts2depth", *pts2depth)]:
        dist, idx = smoke.check_three_nn(label, unknown, known, ~valid)
        smoke.print_k4_scan(label, smoke.k4_scan(unknown, known, dist, idx,
                                                 valid), card)
        print(f"K4 {label} N={unknown.shape[1]} M={known.shape[1]}: equal "
              f"[{card}]")
    for label, xyz, centers, r, s in k3:
        if label.startswith("sa0"):
            smoke.print_k3_scan(label, smoke.k3_scan(xyz, centers, r, s),
                                card)
        ok = torch.equal(bq.ball_query_cuda(xyz, centers, r, s),
                         bq.ball_query_plain(xyz, centers, r, s))
        print(f"K3 {label} N={xyz.shape[1]} M={centers.shape[1]} S={s} "
              f"r={r}: {'equal' if ok else 'DIFFERENT'} [{card}]")
        if not ok:
            raise AssertionError(f"K3 {label} differs from the plain version")
    for xyz, m in k2:
        ok = torch.equal(fp.fps_cuda(xyz, m), fp.fps_plain(xyz, m))
        print(f"K2 {tuple(xyz.shape)}->{m}: {'equal' if ok else 'DIFFERENT'} "
              f"[{card}]")
        if not ok:
            raise AssertionError(f"K2 {tuple(xyz.shape)} differs")


def times(smoke, card: str, levels, pts2depth) -> None:
    from hcmoco_tpu_torch.ops import ball_query as bq
    from hcmoco_tpu_torch.ops import fps as fp
    from hcmoco_tpu_torch.ops import three_nn as tn

    k2, k3, k4 = calls(levels)
    total = 0.0
    for xyz, m in k2:
        ms = smoke.cuda_ms(lambda: fp.fps_cuda(xyz, m))
        total += ms
        print(f"K2 {tuple(xyz.shape)}->{m}: {ms:.4f} ms, "
              f"{ms * 1e3 / (m - 1):.4f} us a round [{card}]")
    print(f"K2 per step ({len(k2)} calls): {total:.4f} ms [{card}]")
    total = 0.0
    for label, xyz, centers, r, s in k3:
        ms = smoke.cuda_ms(lambda: bq.ball_query_cuda(xyz, centers, r, s))
        total += ms
        print(f"K3 {label} N={xyz.shape[1]} M={centers.shape[1]} S={s} "
              f"r={r}: {ms:.4f} ms [{card}]")
    print(f"K3 per step ({len(k3)} calls): {total:.4f} ms [{card}]")
    total = 0.0
    for label, unknown, known in k4:
        ms = smoke.cuda_ms(lambda: tn.three_nn_cuda(unknown, known))
        total += ms
        print(f"K4 {label} N={unknown.shape[1]} M={known.shape[1]}: "
              f"{ms:.4f} ms [{card}]")
    print(f"K4 per step ({len(k4)} calls): {total:.4f} ms [{card}]")
    unknown, known = pts2depth
    ms = smoke.cuda_ms(lambda: tn.three_nn_cuda(unknown, known), iters=5)
    print(f"K4 pts2depth ({unknown.shape[0]},{unknown.shape[1]}<-"
          f"{known.shape[1]}): {ms:.4f} ms [{card}]")


def large_clouds(smoke, card: str) -> None:
    """K2 at SA1's call of a bs64 step with 8192 and 16384 cloud points:
    SA0 keeps the cloud, so SA1 samples N/4 centers from all N points."""
    from hcmoco_tpu_torch.ops import fps as fp

    for n in (8192, 16384):
        xyz = smoke.point_levels("cuda", 64, 320, n)[0][1]
        m = n // 4
        if not torch.equal(fp.fps_cuda(xyz, m), fp.fps_plain(xyz, m)):
            raise AssertionError(f"K2 {tuple(xyz.shape)}->{m} differs")
        ms = smoke.cuda_ms(lambda: fp.fps_cuda(xyz, m), iters=3, warmup=1)
        print(f"K2 {tuple(xyz.shape)}->{m}: {ms:.4f} ms, "
              f"{ms * 1e3 / (m - 1):.4f} us a round, equal [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_point_fwd.py needs a CUDA device")
    import chip_smoke as smoke

    card = smoke.card_line()
    print(f"{card}; tree {os.path.basename(ROOT)}")
    levels, valid = smoke.point_levels("cuda", 64, 320, 4096)
    cloud, all_pts, _ = smoke.depth_clouds("cuda", 64, 320, 4096)
    if "--check" in sys.argv:
        check(smoke, card, levels, valid, (all_pts, cloud))
        return 0
    times(smoke, card, levels, (all_pts, cloud))
    large_clouds(smoke, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
