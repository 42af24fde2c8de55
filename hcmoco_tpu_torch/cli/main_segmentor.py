"""Versatility CLI: joint contrastive + cross-modal supervised segmentation
with per-modality validation (counterpart of
hcmoco_tpu/cli/main_segmentor.py).

Reference: `pycontrast/main_segmentor.py`: the tri-modal stage-2 model and
an FCN classifier over the 128-d linear_merge maps, trained with the
supervision `--supervise_type` picks; every epoch the rgb, d and rgbd heads
are validated and the best mIoU of the `--test_type` head is kept
(:96-128).  The pre-training CLI's flags (cli/main_contrast.py) plus the
versatility ones; one process drives one device, the card unless
`--device cpu` asks for the CPU.  Under torchrun (or `--multihost`) it
trains data-parallel as cli/main_contrast.py does: `--batch_size` is the
global batch, each rank decodes and validates its rows, and the
validation counts are summed over the ranks.

Usage:
  python -m hcmoco_tpu_torch.cli.main_segmentor \\
      --recipe versatility/sup_rgbd --data_folder ... --train_file_list ... \\
      --seg_root ... --seg_file_list ... --seg_val_file_list ... \\
      --pretrain save/<stage-2 run>
  python -m hcmoco_tpu_torch.cli.main_segmentor --synthetic 512 ...  # no data

Without a --recipe or --dataset the run is NTUSeg, RGBD2S,
mem='bank+jointspri3d', linear_feat_map (the JAX CLI's defaults).
`--synthetic N` adds seeded labels (label uniform over the classes,
true_label on half the frames) and skips validation, as the JAX CLI does.
Checkpoints go to <model_path>/<model_name>_seg/epoch_<n>.pt with the
classifier beside the model; cli/transfer_ckpt.py exports their encoders.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .main_contrast import (SEGMENTOR_FIELDS, RunResult, build_argparser,
                            config_from_args, decode_threads,
                            graft_and_resume, join_ranks, print_options,
                            rank_rows, shard_stream, train_epochs)


@dataclass
class SegRunResult(RunResult):
    """main()'s RunResult plus each epoch's validation ({head: {aacc,
    miou, macc}}, empty without a validation set) and the best mIoU of
    the --test_type head (-1 before any validation)."""

    val: List[Dict[str, Dict[str, float]]] = field(default_factory=list)
    best_miou: float = -1.0


def synthetic_labels(batches: Iterator[Dict[str, np.ndarray]], n_class: int,
                     seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Add `label` (uniform over the classes) and `true_label` (half the
    frames) to synthetic batches, from numpy's generator at seed + 7 (the
    JAX CLI's add_labels)."""
    rng = np.random.default_rng(seed + 7)
    for b in batches:
        bsz, s = b["rgbd"].shape[0], b["rgbd"].shape[1]
        b["label"] = rng.integers(0, n_class, (bsz, s, s)).astype(np.int32)
        b["true_label"] = (rng.random(bsz) < 0.5).astype(np.int32)
        yield b


def validate(eval_fn: Callable, source, n_batches: int, device,
             n_class: int) -> Dict[str, Dict[str, float]]:
    """n_batches of `source` through eval_fn; the counts summed in float64
    on the host (and over the ranks, each of which validates its rows),
    then {head: {aacc, miou, macc}}."""
    from ..data.pipeline import to_device
    from ..parallel.mesh import global_sum, world_size
    from ..train.segment_step import SEG_HEADS, calc_seg_metrics

    totals = np.zeros((len(SEG_HEADS), 4, n_class), np.float64)
    it = iter(source)
    try:
        for _ in range(n_batches):
            counts = eval_fn(to_device(next(it), device))
            totals += torch.stack([torch.stack(c) for c in counts]).cpu() \
                .numpy().astype(np.float64)
    finally:
        it.close()
    totals = torch.from_numpy(totals)
    if world_size() > 1:
        totals = global_sum(totals.to(device)).cpu()
    results = {}
    for name, t in zip(SEG_HEADS, totals):
        aacc, miou, macc, _, _ = calc_seg_metrics(*t)
        results[name] = dict(aacc=float(aacc), miou=float(miou),
                             macc=float(macc))
    return results


def main(argv=None, on_ready: Optional[Callable] = None,
         on_step: Optional[Callable[[int], None]] = None) -> SegRunResult:
    """Run the CLI on argv.  on_ready(state) is called once the state is
    built, grafted and restored, before the first step; on_step(n) after
    each step, n the global step count."""
    args = build_argparser().parse_args(argv)
    if args.IN_Pretrain or args.depth_Pretrain:
        raise ValueError("main_segmentor starts from a stage-2 checkpoint "
                         "(--pretrain), not --IN_Pretrain/--depth_Pretrain")
    cfg = config_from_args(args, accept=SEGMENTOR_FIELDS)
    if not cfg.dataset:
        cfg = dataclasses.replace(cfg, dataset="NTUSeg", modal="RGBD2S",
                                  mem="bank+jointspri3d",
                                  linear_feat_map=True)
    if cfg.microbatch > 1:
        raise ValueError("the segment step has no microbatch form (nor has "
                         "the JAX package's)")
    rank, size, device = join_ranks(args, cfg)
    try:
        return _run(args, cfg, rank, size, device, on_ready, on_step)
    finally:
        from ..parallel.mesh import leave
        leave()


def _run(args, cfg, rank: int, size: int, device, on_ready,
         on_step) -> SegRunResult:
    from ..models.build import build_model
    from ..models.heads import FCNHead
    from ..train.segment_step import (TEST_HEAD, make_segment_train_step,
                                      make_validate_fn)
    from ..train.state import create_train_state

    if rank == 0:
        print_options(cfg)
    rows = rank_rows(cfg, rank, size)
    val_source = None
    if args.synthetic:
        from ..data.synthetic import SyntheticContrastSource

        n_data = args.synthetic
        source = SyntheticContrastSource(
            cfg.batch_size, size=cfg.crop_size, num_joints=cfg.num_joints,
            n_data=n_data, seed=cfg.seed)
        steps_per_epoch = max(n_data // cfg.batch_size, 1)
        it = shard_stream(synthetic_labels(iter(source), cfg.n_class,
                                           cfg.seed), rows)
    else:
        from ..data.combined import NTUSegJoint
        from ..data.pipeline import DataSource, build_contrast_source

        threads = decode_threads(args, size)
        source, n_data, steps_per_epoch = build_contrast_source(
            cfg, num_workers=threads, rows=rows)
        it = iter(source)
        val_ds = NTUSegJoint(
            cfg.data_folder, cfg.train_file_list, cfg.seg_root,
            cfg.seg_val_file_list, size=cfg.crop_size,
            random_resized_crop=True, only_seg=True, seed=cfg.seed + 1)
        val_source = DataSource(val_ds, cfg.batch_size, np.ones(len(val_ds)),
                                seed=cfg.seed + 2, num_workers=threads,
                                rows=rows)
        n_val_batches = max(len(val_ds) // cfg.batch_size, 1)

    torch.manual_seed(cfg.seed)  # the model's and classifier's weights
    model = build_model(cfg, device=device).to(
        memory_format=torch.channels_last)
    classifier = FCNHead(channels=128, num_classes=cfg.n_class, num_convs=1,
                         kernel_size=1).to(device)
    try:
        # the JAX CLI draws one batch to initialise its state; drawing it
        # here too keeps the two CLIs' data streams aligned
        next(it)
        state = create_train_state(
            cfg, model, torch.Generator(device).manual_seed(cfg.seed),
            n_data, steps_per_epoch, classifier=classifier)
        # a stage-2 checkpoint grafts into the encoders, heads and banks
        # (main_segmentor.py:50-65); the classifier keeps its init
        state, ckpt, start_epoch = graft_and_resume(
            cfg, state, f"{cfg.model_path}/{cfg.model_name}_seg")
        if on_ready is not None:
            on_ready(state)
        result = SegRunResult(state, n_data, steps_per_epoch, start_epoch,
                              start_epoch - 1, ckpt.directory)
        eval_fn = make_validate_fn(cfg, model, classifier)
        test_head = TEST_HEAD[cfg.test_type]

        def after_epoch(epoch: int) -> None:
            if val_source is None:
                return
            results = validate(eval_fn, val_source, n_val_batches, device,
                               cfg.n_class)
            say = print if rank == 0 else (lambda *a: None)
            for name, r in results.items():
                say(f"val[{name}] mIoU {r['miou']:.4f} "
                    f"mAcc {r['macc']:.4f} aAcc {r['aacc']:.4f}")
            result.val.append(results)
            if results[test_head]["miou"] > result.best_miou:
                result.best_miou = results[test_head]["miou"]
                say(f"new best {test_head} mIoU: {result.best_miou:.4f}")

        train_epochs(args, cfg, state, it, device, ckpt, result,
                     make_segment_train_step(cfg, model, classifier,
                                             steps_per_epoch),
                     on_step, after_epoch)
    finally:
        it.close()  # stops the DataSource's thread pool
    return result


if __name__ == "__main__":
    main()
