"""Checkpoint export CLI: a pre-training or segmentor checkpoint -> the
flat reference-named HRNet state dict of one encoder, for the downstream
stacks (counterpart of hcmoco_tpu/cli/transfer_ckpt.py).

Reference: `pycontrast/transfer_ckpt.py` (encoder1, RGB) and
`transfer_ckpt_depth.py` (encoder2, depth): strip the `encoderN.` prefix
into a plain HRNet dict.  This one reads the port's `epoch_<n>.pt` (of
cli/main_contrast.py or cli/main_segmentor.py; both keep the model's
state dict under `model`) or a run directory (its latest epoch), and
writes a `.pth` of CPU tensors that a bare HRNet loads with strict=True.

  python -m hcmoco_tpu_torch.cli.transfer_ckpt \\
      --ckpt save/<run>/epoch_100.pt --encoder encoder1 --out hrnet_rgb.pth
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("hcmoco_tpu_torch checkpoint export")
    p.add_argument("--ckpt", required=True,
                   help="epoch_<n>.pt, or a run directory (latest epoch)")
    p.add_argument("--encoder", default="encoder1",
                   choices=["encoder1", "encoder2"])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from ..export.transfer import export_encoder
    from ..train.checkpoint import resolve_checkpoint

    path = resolve_checkpoint(args.ckpt)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = export_encoder(ckpt["model"], args.encoder, args.out)
    print(f"wrote {len(sd)} tensors ({args.encoder}) of {path} to "
          f"{args.out}")
    return sd


if __name__ == "__main__":
    main()
