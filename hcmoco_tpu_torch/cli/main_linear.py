"""The linear-probe CLI (counterpart of hcmoco_tpu/cli/main_linear.py):
not ported yet.  It trains a LinearClassifier on the pooled features of a
frozen single-input model (SingleModalModel) over ImageFolder data
(data/image_folder.py), both of ROADMAP.md Queue 1 item 11, the baseline
methods; it moves with them.  main() raises rather than run a part."""

from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "cli/main_linear.py is not ported yet: it needs SingleModalModel "
        "and the ImageFolder datasets of ROADMAP.md Queue 1 item 11")


if __name__ == "__main__":
    main()
