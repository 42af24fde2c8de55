"""Offline NTU preprocessing CLI (counterpart of
hcmoco_tpu/cli/preprocess_ntu.py).

Reference: `pycontrast/data/NTURGBD/generate_skeleton_data.py` (skeleton
parse -> per-frame pkls) and `preprocess_nturgbd.py` (per-(setup,camera)
RANSAC homography + RGB video warp into the 512x424 depth frame).

  python -m hcmoco_tpu_torch.cli.preprocess_ntu skeletons \
      --skeleton_dir ... --out_dir ... [--file_list flist.txt]
  python -m hcmoco_tpu_torch.cli.preprocess_ntu warp --rgb_dir ... \
      --skeleton_dir ... --out_dir ...
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import pickle
import re

import numpy as np

_TAG = re.compile(r".*S(\d{3})C(\d{3})P(\d{3})R(\d{3})A(\d{3}).*")


def cmd_skeletons(args):
    from ..data.preprocess import write_parsed_skeletons

    if args.file_list:
        with open(args.file_list) as f:
            tags = sorted({l.split("/")[-2] for l in f if l.strip()})
    else:
        tags = sorted(f[:-9] for f in os.listdir(args.skeleton_dir)
                      if f.endswith(".skeleton"))
    print(f"parsing {len(tags)} skeleton files...")

    def one(tag):
        n = write_parsed_skeletons(
            os.path.join(args.skeleton_dir, tag + ".skeleton"),
            os.path.join(args.out_dir, tag))
        return tag, n

    with cf.ThreadPoolExecutor(args.workers) as pool:
        for tag, n in pool.map(one, tags):
            print(f"{tag}: {n} frames")


def cmd_warp(args):
    import cv2
    from ..data.preprocess import fit_video_set_homography, warp_perspective

    tags = sorted(f.split("_")[0] for f in os.listdir(args.rgb_dir))
    groups = {}
    for t in tags:
        m = _TAG.match(t)
        key = (int(m.group(1)), int(m.group(2)))
        groups.setdefault(key, []).append(t)

    print(f"fitting homographies for {len(groups)} (setup, camera) sets")
    hs = {}
    for key, group in sorted(groups.items()):
        paths = [os.path.join(args.skeleton_dir, t + ".skeleton")
                 for t in group
                 if os.path.exists(
                     os.path.join(args.skeleton_dir, t + ".skeleton"))]
        hs[key] = fit_video_set_homography(paths, seed=args.seed,
                                           sample_prob=0.5)
        print(f"set {key}: H fitted from {len(paths)} sequences")
    with open(os.path.join(args.out_dir, "homography_dict.pkl"),
              "wb") as f:
        pickle.dump(hs, f)

    for t in tags:
        m = _TAG.match(t)
        h = hs[(int(m.group(1)), int(m.group(2)))]
        out_dir = os.path.join(args.out_dir,
                               "nturgb+d_rgb_warped_correction", t)
        os.makedirs(out_dir, exist_ok=True)
        cap = cv2.VideoCapture(os.path.join(args.rgb_dir, t + "_rgb.avi"))
        counter = 1
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            warped = warp_perspective(frame, h, (512, 424))
            cv2.imwrite(os.path.join(out_dir, f"WRGB-{counter:08d}.jpg"),
                        warped)
            counter += 1
        print(f"{t}: {counter - 1} frames warped")


def main(argv=None):
    p = argparse.ArgumentParser("NTU offline preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("skeletons")
    ps.add_argument("--skeleton_dir", required=True)
    ps.add_argument("--out_dir", required=True)
    ps.add_argument("--file_list", default="")
    ps.add_argument("--workers", type=int, default=8)
    pw = sub.add_parser("warp")
    pw.add_argument("--rgb_dir", required=True)
    pw.add_argument("--skeleton_dir", required=True)
    pw.add_argument("--out_dir", required=True)
    pw.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(getattr(args, "out_dir", "."), exist_ok=True)
    {"skeletons": cmd_skeletons, "warp": cmd_warp}[args.cmd](args)


if __name__ == "__main__":
    main()
