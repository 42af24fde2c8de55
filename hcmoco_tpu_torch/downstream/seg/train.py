"""Downstream human-parsing training/eval CLI (counterpart of
hcmoco_tpu/downstream/seg/train.py).

Reference: `HRNet-Semantic-Segmentation/tools/train.py` + `tools/test.py` +
`lib/core/function.py` — SGD momentum 0.9 + poly LR (power 0.9), class-
weighted CE (or OHEM), per-epoch confusion-matrix validation, best-mIoU
checkpointing; test = sliding-window multi-scale + flip TTA.

The JAX CLI's flags plus `--device` (default `cuda`; `cpu` is the one way
onto the CPU, and without a card the CLI raises).  torch SGD with the L2
term in the gradient is optax's add_decayed_weights -> trace ->
scale_by_learning_rate; the lr is set from the poly schedule before each
step, at the optimizer's step count, as optax evaluates it.  `--restore`
is a torch file ({'model': state dict}) written at each best validation
mIoU and read by `--test_only`.  Convs run in bf16 (f32 with
`--synthetic`, as the JAX CLI does); HCMOCO_CONVBN_FUSE=1 sends the
backbone's 1x1 ConvBN sites through K1/K1b in training.

Usage (depth parsing, NTURGBD-Parsing-4K recipe; --pretrained is
cli/transfer_ckpt.py's export of a stage-2 run's depth encoder):
  python -m hcmoco_tpu_torch.downstream.seg.train --root ... \\
      --train_list ... --val_list ... --modality depth --epochs 150 \\
      --batch_size 40 --learning_rate 7e-3 --pretrained encoder2.pth
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser("hcmoco_tpu_torch downstream parsing")
    p.add_argument("--root", type=str, default="")
    p.add_argument("--train_list", type=str, default="")
    p.add_argument("--val_list", type=str, default="")
    p.add_argument("--modality", type=str, default="depth",
                   choices=["depth", "rgb"])
    p.add_argument("--dataset", type=str, default="nturgbd",
                   choices=["nturgbd", "human36m", "cityscapes", "lip",
                            "pascal_ctx"],
                   help="legacy cityscapes/lip/pascal_ctx loaders "
                        "(downstream/seg/legacy.py) batch-train like the "
                        "others; their val splits keep reference-original "
                        "label sizes, so evaluate them with --test_only")
    p.add_argument("--num_classes", type=int, default=25)
    p.add_argument("--crop", type=int, default=473)
    p.add_argument("--width", type=int, default=18)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--learning_rate", type=float, default=7e-3)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--ohem", action="store_true")
    p.add_argument("--ohem_thres", type=float, default=0.9)
    p.add_argument("--ohem_keep", type=int, default=131072)
    p.add_argument("--pretrained", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--eval_flip", action="store_true")
    p.add_argument("--test_only", action="store_true",
                   help="testval mode: sliding-window inference on the "
                        "val list (tools/test.py)")
    p.add_argument("--test_scales", type=str, default="1.0",
                   help="comma-separated multi-scale TTA factors")
    p.add_argument("--restore", type=str, default="",
                   help="torch weights file: written at each best mIoU, "
                        "read by --test_only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; 'cpu' is the one way "
                        "onto the CPU")
    return p


class SyntheticParsing:
    """--synthetic N: seeded normal images and uniform labels."""

    def __init__(self, n: int, crop: int, num_classes: int):
        self.n, self.crop, self.num_classes = n, crop, num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        c = self.crop
        return {
            "image": rng.standard_normal((c, c, 3)).astype(np.float32),
            "label": rng.integers(0, self.num_classes,
                                  (c, c)).astype(np.int32),
            "size": np.array([c, c], np.int32),
            "index": np.int32(i),
        }


def build_datasets(args):
    """(train set, val set, class weights as a numpy array or None)."""
    from .datasets import CLASS_WEIGHTS_25, Human36MParsing, ParsingDataset

    crop = args.crop
    weights = np.asarray(CLASS_WEIGHTS_25[: args.num_classes], np.float32)
    if args.synthetic:
        ds = SyntheticParsing(args.synthetic, crop, args.num_classes)
        return ds, ds, weights
    if args.dataset in ("cityscapes", "lip", "pascal_ctx"):
        from .legacy import (CityscapesParsing, LIPParsing,
                             PascalContextParsing)

        cls = {"cityscapes": CityscapesParsing, "lip": LIPParsing,
               "pascal_ctx": PascalContextParsing}[args.dataset]
        # ignore_label=255 matches this trainer's criterion convention
        # (the reference uses -1 for these sets; pure label-encoding delta)
        kw = dict(crop_size=(crop, crop), base_size=crop,
                  num_classes=args.num_classes, seed=args.seed,
                  ignore_label=255)
        train_ds = cls(args.root, args.train_list, is_train=True, **kw)
        val_ds = cls(args.root, args.val_list, is_train=False, **kw)
        # cityscapes ships hardcoded class weights (cityscapes.py:42-45);
        # lip/pascal_ctx train unweighted
        return train_ds, val_ds, train_ds.class_weights
    cls = Human36MParsing if args.dataset == "human36m" else ParsingDataset
    kw = dict(modality=args.modality, crop_size=(crop, crop), base_size=crop,
              num_classes=args.num_classes, seed=args.seed)
    return (cls(args.root, args.train_list, is_train=True, **kw),
            cls(args.root, args.val_list, is_train=False, **kw), weights)


def poly_lr_fn(base_lr: float, max_iters: int) -> Callable[[int], float]:
    """The JAX CLI's lr_fn: base_lr * (1 - min(step, max_iters - 1) /
    max_iters) ** 0.9, in f32."""
    from .criterion import poly_lr

    return lambda step: poly_lr(base_lr, min(step, max_iters - 1),
                                max_iters)


def make_train_step(model, optimizer, lr_fn, loss_fn) -> Callable:
    """step(batch, step) -> metrics: the lr set from lr_fn(step), the
    model's forward on batch['image'] (B, H, W, 3) as NCHW, loss_fn(logits,
    labels), one optimizer step."""

    def step(batch, gstep: int):
        lr = lr_fn(gstep)
        for group in optimizer.param_groups:
            group["lr"] = lr
        model.train()
        logits = model(batch["image"].permute(0, 3, 1, 2))
        loss = loss_fn(logits, batch["label"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "learning_rate": lr}

    return step


def validate(model, source, n_batches: int, device, n_class: int):
    """mIoU over n_batches of `source` (function.py:89-136): eval-mode
    logits upsampled to the label size, argmax, the confusion matrix
    summed in float64 on the host.  Returns (mIoU, per-class IoU)."""
    import torch.nn.functional as F

    from ...data.pipeline import to_device
    from .criterion import confusion_matrix, miou_from_confusion

    model.eval()
    conf = np.zeros((n_class, n_class), np.float64)
    it = iter(source)
    try:
        with torch.no_grad():
            for _ in range(n_batches):
                b = to_device(next(it), device)
                label = b["label"]
                logits = F.interpolate(
                    model(b["image"].permute(0, 3, 1, 2)).float(),
                    size=label.shape[1:], mode="bilinear",
                    align_corners=False)
                conf += confusion_matrix(logits.argmax(1), label, n_class) \
                    .cpu().numpy().astype(np.float64)
    finally:
        it.close()
    miou, iou = miou_from_confusion(torch.from_numpy(conf))
    return float(miou), iou


def test_val(args, model, val_ds, device) -> float:
    """testval: per-image sliding-window multi-scale (+flip) inference
    (tools/test.py:51-138, base_dataset.multi_scale_inference); prints and
    returns the mIoU."""
    import cv2

    from .criterion import confusion_matrix, miou_from_confusion
    from .datasets import mapped_pairs
    from .inference import sliding_window_inference

    scales = tuple(float(s) for s in args.test_scales.split(","))
    pairs = mapped_pairs() if args.modality == "depth" else None
    model.eval()
    conf = np.zeros((args.num_classes, args.num_classes), np.float64)
    for i in range(len(val_ds)):
        s = val_ds[i]
        probs = sliding_window_inference(
            model, s["image"], args.num_classes,
            crop_size=(args.crop, args.crop), scales=scales,
            flip=args.eval_flip, flip_pairs=pairs, device=device)
        pred = cv2.resize(probs, (s["label"].shape[1], s["label"].shape[0]),
                          interpolation=cv2.INTER_LINEAR).argmax(-1)
        conf += confusion_matrix(torch.from_numpy(pred)[None],
                                 torch.from_numpy(s["label"])[None],
                                 args.num_classes).numpy().astype(np.float64)
    miou, iou = miou_from_confusion(torch.from_numpy(conf))
    print(f"testval mIoU: {float(miou):.4f}")
    for ci, v in enumerate(iou.tolist()):
        print(f"  class {ci}: IoU {v:.4f}")
    return float(miou)


def main(argv=None, on_step: Optional[Callable[[int], None]] = None):
    """Run the CLI on argv; on_step(n) after each step, n the global step
    count.  Returns a downstream.run.DownstreamRun (scores: each epoch's
    validation mIoU, or the testval mIoU)."""
    args = build_argparser().parse_args(argv)
    from ...data.pipeline import DataSource
    from ...utils.meters import MetricLogger
    from ..run import DownstreamRun, resolve_device
    from .criterion import cross_entropy_seg, ohem_cross_entropy
    from .model import SegHRNet, load_pretrained

    device = resolve_device(args.device, "downstream.seg.train")
    train_ds, val_ds, weights = build_datasets(args)
    class_weights = (None if weights is None else
                     torch.as_tensor(weights, dtype=torch.float32,
                                     device=device))

    steps = max(len(train_ds) // args.batch_size, 1)
    max_iters = steps * args.epochs
    src = DataSource(train_ds, args.batch_size, np.ones(len(train_ds)),
                     seed=args.seed, num_workers=8)
    it = iter(src)
    try:
        # the JAX CLI draws one batch to initialise its model; drawing it
        # here too keeps the two CLIs' data streams aligned
        next(it)
        torch.manual_seed(args.seed)
        model = SegHRNet(num_classes=args.num_classes, width=args.width,
                         dtype=torch.float32 if args.synthetic
                         else torch.bfloat16).to(
            device, memory_format=torch.channels_last)
        if args.pretrained:
            n = load_pretrained(args.pretrained, model)
            print(f"=> loaded {n} conv tensors from {args.pretrained}")
        run = DownstreamRun(model)

        if args.test_only:
            if args.restore:
                model.load_state_dict(torch.load(
                    args.restore, map_location=device,
                    weights_only=True)["model"])
                print(f"=> restored weights from {args.restore}")
            run.scores.append(test_val(args, model, val_ds, device))
            return run

        optimizer = torch.optim.SGD(model.parameters(),
                                    lr=args.learning_rate,
                                    momentum=args.momentum,
                                    weight_decay=args.weight_decay)
        if args.ohem:
            def loss_fn(logits, label):
                return ohem_cross_entropy(logits, label, class_weights,
                                          thres=args.ohem_thres,
                                          min_kept=args.ohem_keep)
        else:
            def loss_fn(logits, label):
                return cross_entropy_seg(logits, label, class_weights)
        step = make_train_step(model, optimizer,
                               poly_lr_fn(args.learning_rate, max_iters),
                               loss_fn)

        logger = MetricLogger(None, print_freq=args.print_freq)
        best_miou = -1.0
        gstep = 0
        for epoch in range(1, args.epochs + 1):
            logger.reset()
            t0 = time.time()
            for i in range(steps):
                values = run.timed_step(it, device,
                                        lambda b: step(b, gstep))
                gstep += 1
                logger.log_step(epoch, i, steps, values, n=args.batch_size)
                if on_step is not None:
                    on_step(gstep)
                if args.max_steps and gstep >= args.max_steps:
                    break

            vsrc = DataSource(val_ds, args.batch_size, np.ones(len(val_ds)),
                              seed=args.seed + 1, num_workers=8)
            miou, _ = validate(model, vsrc,
                               max(len(val_ds) // args.batch_size, 1),
                               device, args.num_classes)
            run.scores.append(miou)
            flag = ""
            if miou > best_miou:
                best_miou = miou
                flag = " (best)"
                if args.restore:
                    torch.save({"model": model.state_dict()}, args.restore)
            print(f"epoch {epoch}: mIoU {miou:.4f}{flag}, best "
                  f"{best_miou:.4f}, time {time.time() - t0:.2f}")
            if args.max_steps and gstep >= args.max_steps:
                break
        return run
    finally:
        it.close()  # stops the DataSource's thread pool


if __name__ == "__main__":
    main()
