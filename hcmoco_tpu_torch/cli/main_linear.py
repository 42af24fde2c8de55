"""Linear-probe CLI: a frozen encoder and a linear classifier (counterpart
of hcmoco_tpu/cli/main_linear.py).

Reference: `pycontrast/main_linear.py` + `learning/linear_trainer.py`: the
encoder of a single-input model (modal 'RGB', SingleModalModel) in eval
mode gives the pooled features (no projection head), a LinearClassifier
on them is trained with cross-entropy and SGD (the pre-training's SGD and
learning-rate schedule), and each epoch ends with top-1/top-5 on the
validation set.  main_contrast's flags, plus --val_folder and --n_class;
the data is an ImageFolder tree (--data_folder with train/ and val/) or
--synthetic N samples.  --pretrain loads the model of a pre-training
checkpoint of the port (a file, or a run directory's latest epoch).

One process drives one device: the card unless --device cpu asks for the
CPU.  Under torchrun (or --multihost) each rank decodes its rows of the
global batch, the loss is the global batch's mean (the gradients summed
over the ranks), and the metrics and validation hit counts are summed
over the ranks, each rank validating its share of the images:
  torchrun --nproc_per_node=4 -m hcmoco_tpu_torch.cli.main_linear \\
      --arch resnet50 --pretrain save/<run> --data_folder DIR ...
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .main_contrast import (build_argparser as contrast_argparser,
                            config_from_args, join_ranks, metric_floats,
                            rank_rows)


def build_argparser():
    p = contrast_argparser()
    p.add_argument("--val_folder", type=str, default="")
    return p


class SyntheticLabelled:
    """N synthetic samples (the JAX CLI's): rgbd N(0, 1) from a generator
    seeded by the index, label index % n_class."""

    def __init__(self, n: int, size: int, n_class: int):
        self.n, self.size, self.n_class = n, size, n_class

    def __len__(self):
        return self.n

    def skip_draws(self, index) -> None:
        pass

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(i)
        return {"rgbd": rng.standard_normal(
                    (self.size, self.size, 3)).astype(np.float32),
                "label": np.int32(i % self.n_class),
                "index": np.int32(i)}


@dataclass
class LinearRun:
    """What main() did: the frozen model, the trained classifier, each
    step's metrics, and each epoch's validation (top1, top5)."""

    model: torch.nn.Module
    classifier: torch.nn.Module
    metrics: List[Dict[str, float]] = field(default_factory=list)
    val: List[tuple] = field(default_factory=list)


def topk_hits(logits: torch.Tensor, label: torch.Tensor, n_class: int):
    """(top-1 hits, top-k hits) per row, k = min(5, n_class), ties broken
    towards the lower class as the JAX CLI's argsort does."""
    k = min(5, n_class)
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    hit = topk == label[:, None]
    return hit[:, 0].float(), hit.any(dim=-1).float()


def main(argv=None, on_ready: Optional[Callable] = None) -> LinearRun:
    """Run the probe on argv.  on_ready(model, classifier) is called once
    both are built (and the encoder loaded), before the first step."""
    args = build_argparser().parse_args(argv)
    if args.profile_dir:
        raise ValueError(
            "--profile_dir traces the training steps of main_contrast and "
            "main_segmentor; the linear probe writes no trace (the JAX "
            "package's probe takes the flag and ignores it)")
    cfg = config_from_args(args, accept=("n_class",))
    if cfg.modal != "RGB":
        raise ValueError(
            f"the linear probe takes a single-encoder model (modal 'RGB', "
            f"its 'pooled' feature), as the JAX CLI does; got modal "
            f"{cfg.modal!r}")
    rank, size, device = join_ranks(args, cfg)
    try:
        return _run(args, cfg, rank, size, device, on_ready)
    finally:
        if size > 1 or "WORLD_SIZE" in os.environ:
            from ..parallel.mesh import destroy
            destroy()


def _run(args, cfg, rank: int, size: int, device, on_ready) -> LinearRun:
    from ..data.pipeline import DataSource, collate, to_device
    from ..models.build import build_model
    from ..models.heads import LinearClassifier
    from ..parallel.mesh import all_reduce_grads, global_sum, world_size
    from ..train.checkpoint import resolve_checkpoint
    from ..train.state import make_optimizer
    from ..utils.meters import MetricLogger

    if args.synthetic:
        train_ds = val_ds = SyntheticLabelled(args.synthetic, cfg.crop_size,
                                              cfg.n_class)
    else:
        from ..data.image_folder import ImageFolderDataset

        train_ds = ImageFolderDataset(
            f"{cfg.data_folder}/train", cfg.crop_size, train=True,
            seed=cfg.seed)
        val_ds = ImageFolderDataset(
            args.val_folder or f"{cfg.data_folder}/val", cfg.crop_size,
            train=False, seed=cfg.seed)
    steps = max(len(train_ds) // cfg.batch_size, 1)
    src = DataSource(train_ds, cfg.batch_size, np.ones(len(train_ds)),
                     seed=cfg.seed, num_workers=args.num_workers,
                     rows=rank_rows(cfg, rank, size))
    it = iter(src)
    try:
        next(it)  # the JAX CLI draws one batch to initialise
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, device=device).to(
            memory_format=torch.channels_last)
        if cfg.pretrain:
            path = resolve_checkpoint(cfg.pretrain)
            ckpt = torch.load(path, map_location=device, weights_only=True)
            model.load_state_dict(ckpt["model"], strict=True)
            if rank == 0:
                print(f"=> loaded encoder from {path}")
        model.eval().requires_grad_(False)
        classifier = LinearClassifier(model.encoder.out_channels,
                                      cfg.n_class).to(device)
        opt, lr_fn = make_optimizer(cfg, classifier.parameters(), steps)
        if on_ready is not None:
            on_ready(model, classifier)
        run = LinearRun(model, classifier)
        logger = MetricLogger(None, print_freq=cfg.print_freq)
        gstep = 0
        for epoch in range(1, cfg.epochs + 1):
            logger.reset()
            t0 = time.time()
            for i in range(steps):
                batch = to_device(next(it), device)
                lr = lr_fn(gstep)
                for group in opt.param_groups:
                    group["lr"] = lr
                with torch.no_grad():
                    feat = model(batch["rgbd"].permute(0, 3, 1, 2),
                                 project=False)["pooled"]
                logits = classifier(feat)
                label = batch["label"].long()
                n = label.shape[0] * world_size()
                ce = F.cross_entropy(logits, label, reduction="sum") / n
                opt.zero_grad(set_to_none=True)
                ce.backward()
                all_reduce_grads(list(classifier.parameters()))
                opt.step()
                h1, h5 = topk_hits(logits.detach(), label, cfg.n_class)
                metrics = global_sum(torch.stack([ce.detach(), h1.sum() / n,
                                                  h5.sum() / n]))
                values = metric_floats(dict(zip(("loss", "top1", "top5"),
                                                metrics.unbind(0))))
                values["learning_rate"] = lr
                run.metrics.append(values)
                gstep += 1
                logger.log_step(epoch, i, steps, values, n=cfg.batch_size)
                if args.max_steps and gstep >= args.max_steps:
                    break
            top1, top5 = validate(model, classifier, val_ds, cfg, device,
                                  rank, size, collate, to_device, global_sum)
            run.val.append((top1, top5))
            if rank == 0:
                print(f" * epoch {epoch} Acc@1 {top1:.3f} Acc@5 {top5:.3f} "
                      f"({time.time() - t0:.2f}s)")
            if args.max_steps and gstep >= args.max_steps:
                break
    finally:
        it.close()  # stops the DataSource's thread pool
    return run


@torch.no_grad()
def validate(model, classifier, val_ds, cfg, device, rank: int, size: int,
             collate, to_device, global_sum) -> tuple:
    """LinearTrainer.validate (linear_trainer.py:193-242): top-1/top-5
    over the validation set in batch_size chunks; rank r takes the images
    r, r + W, ..., and the hit counts are summed over the ranks."""
    hits = torch.zeros(3, dtype=torch.float64, device=device)
    mine = list(range(rank, len(val_ds), size))
    for start in range(0, len(mine), cfg.batch_size):
        b = to_device(collate([val_ds[i] for i in
                               mine[start:start + cfg.batch_size]]), device)
        feat = model(b["rgbd"].permute(0, 3, 1, 2), project=False)["pooled"]
        h1, h5 = topk_hits(classifier(feat), b["label"].long(), cfg.n_class)
        hits += torch.stack([h1.sum(), h5.sum(),
                             torch.tensor(float(h1.shape[0]),
                                          device=device)]).double()
    n1, n5, n = global_sum(hits).tolist()
    return n1 / max(n, 1), n5 / max(n, 1)


if __name__ == "__main__":
    main()
