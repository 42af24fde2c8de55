"""Pack an NTU file list into decode-free memmapped arrays
(data/packed.py); point main_contrast at the result with --packed_dir.
Counterpart of hcmoco_tpu/cli/pack_ntu.py.

  python -m hcmoco_tpu_torch.cli.pack_ntu --data_folder ... \
      --train_file_list ... --out_dir packed/
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("hcmoco_tpu_torch NTU packer")
    p.add_argument("--data_folder", required=True)
    p.add_argument("--train_file_list", required=True)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    from ..data.packed import pack_ntu

    meta = pack_ntu(args.data_folder, args.train_file_list, args.out_dir,
                    verbose=True)
    print(f"packed {meta['n']} frames ({meta['h']}x{meta['w']}) "
          f"into {args.out_dir}")


if __name__ == "__main__":
    main()
