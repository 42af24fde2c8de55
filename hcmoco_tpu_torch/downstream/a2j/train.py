"""A2J ITOP training CLI (counterpart of hcmoco_tpu/downstream/a2j/train.py).

Reference: `A2J/main.py:286-391` — Adam(3.5e-4, wd=1e-4), StepLR(10, 0.2),
batch 12, losses = Cls_loss + Reg_loss*RegLossFactor(3), in-loop PCK@10cm
eval.  `--pretrained_pth` loads an HRNet state dict (cli/transfer_ckpt.py's
export) into the Backbone through the filtered load.

The JAX CLI's flags plus `--device` (default `cuda`; `cpu` is the one way
onto the CPU, and without a card the CLI raises).  torch Adam with
`weight_decay` couples the L2 term into the gradient, which is optax's
add_decayed_weights -> scale_by_adam (eps outside the square root); the
StepLR is a staircase at lr_step x steps-per-epoch optimizer steps, set
before each step.  `--arch resnet50` trains the legacy A2J_model
(model.A2JResNet, 16 anchors per stride-16 cell) at the same settings;
with `--pretrained_pth` it raises: the JAX trainer's HRNet loader maps no
name of that ResNet and loads nothing (ROADMAP.md Queue 3, F13b).
Convs run in bf16 (f32 with `--synthetic`); HCMOCO_CONVBN_FUSE=1 sends
the backbone's 1x1 ConvBN sites through K1/K1b in training.  Under
torchrun it trains data-parallel as the pre-training CLI does
(parallel/mesh.py): `--batch_size` is the global batch, each rank decodes
its rows, BN is the global batch's, each rank's loss is its share of the
global mean and the gradients are summed over the ranks; every rank
evaluates the whole test set with the same weights, rank 0 prints.

Usage:
  python -m hcmoco_tpu_torch.downstream.a2j.train --train_dir ... \\
      --test_dir ... --bndbox_train ... --bndbox_test ... \\
      --pretrained_pth encoder2.pth
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser("hcmoco_tpu_torch A2J ITOP trainer")
    p.add_argument("--train_dir", type=str, default="")
    p.add_argument("--test_dir", type=str, default="")
    p.add_argument("--bndbox_train", type=str, default="")
    p.add_argument("--bndbox_test", type=str, default="")
    p.add_argument("--pretrained_pth", type=str, default="")
    p.add_argument("--width", type=int, default=18)
    p.add_argument("--arch", type=str, default="hrnet",
                   choices=("hrnet", "resnet50"),
                   help="hrnet = HCMoCo's A2J_HRNet_model (stride-4 "
                        "anchors, main.py:289-295); resnet50 = the legacy "
                        "A2J_model (stride-16 anchors, main.py:296-300)")
    p.add_argument("--epochs", type=int, default=35)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--learning_rate", type=float, default=3.5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--lr_step", type=int, default=10)
    p.add_argument("--lr_gamma", type=float, default=0.2)
    p.add_argument("--reg_loss_factor", type=float, default=3.0)
    p.add_argument("--spatial_factor", type=float, default=0.5)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--crop", type=int, default=288)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_first", action="store_true",
                   help="evaluate PCK@10cm before training (epoch 0) to "
                        "establish the untrained baseline")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; 'cpu' is the one way "
                        "onto the CPU")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over torchrun's (multi-node) "
                        "rendezvous")
    return p


class SyntheticITOP:
    """--synthetic N: seeded depth crops and labels."""

    def __init__(self, n: int, crop: int):
        self.n, self.crop = n, crop

    def __len__(self):
        return self.n

    def skip_draws(self, i) -> None:
        """Nothing to consume: each sample draws from its own generator."""

    def __getitem__(self, i):
        from .data import DEPTH_FACTOR, KEYPOINTS

        rng = np.random.default_rng(i)
        c = self.crop
        return {
            "depth": rng.standard_normal((c, c, 1)).astype(np.float32),
            "label": np.concatenate([
                rng.uniform(0, c, (KEYPOINTS, 2)),
                rng.standard_normal((KEYPOINTS, 1)) * DEPTH_FACTOR,
            ], -1).astype(np.float32),
            "keypoints_world": rng.standard_normal(
                (KEYPOINTS, 3)).astype(np.float32),
            "mean": np.float32(2.0),
            "index": np.int32(i),
        }


def step_lr_fn(lr: float, transition_steps: int,
               gamma: float) -> Callable[[int], float]:
    """optax.exponential_decay(lr, transition_steps, gamma,
    staircase=True): lr * gamma ** floor(step / transition_steps), in
    f32."""
    def fn(step: int) -> float:
        k = np.float32(step // transition_steps)
        return float(np.float32(lr) * np.float32(gamma) ** k)

    return fn


def a2j_anchors(arch: str, crop: int, device) -> torch.Tensor:
    """The anchor grid of `arch`, W-major, f32 on `device`: for hrnet
    (A2J_HRNet_model) 9 anchors ([1, 2, 3]^2 offsets, A2J/main.py:84) per
    stride-4 cell; for resnet50 (A2J_model) the 16 default anchors
    ([2, 6, 10, 14]^2, anchor.py:7-25) per stride-16 cell."""
    from .anchors import generate_anchors, shift_anchors

    if arch == "resnet50":
        grid = shift_anchors((crop // 16, crop // 16), 16,
                             generate_anchors(None, None))
    else:
        p_hw = np.array([1, 2, 3])
        grid = shift_anchors((crop // 4, crop // 4), 4,
                             generate_anchors(p_hw, p_hw))
    return torch.as_tensor(grid, dtype=torch.float32, device=device)


def build_a2j(args, device) -> torch.nn.Module:
    """The model of --arch on `device` (channels_last), in f32 with
    --synthetic and in bf16 otherwise, as the JAX trainer builds it."""
    from .data import KEYPOINTS
    from .model import A2JHRNet, A2JResNet

    dtype = torch.float32 if args.synthetic else torch.bfloat16
    if args.arch == "resnet50":
        model = A2JResNet(num_classes=KEYPOINTS, num_anchors=16, dtype=dtype)
    else:
        model = A2JHRNet(num_classes=KEYPOINTS, num_anchors=9,
                         width=args.width, dtype=dtype)
    return model.to(device, memory_format=torch.channels_last)


def make_train_step(model, optimizer, lr_fn, anchors, args) -> Callable:
    """step(batch, step) -> metrics: the lr set from lr_fn(step), the
    model's forward on batch['depth'] (B, H, W, 1) as NCHW, the A2J losses
    (cls + reg x reg_loss_factor; means over the rank's rows, so a rank's
    share of the global mean is its mean over the world size), the
    gradients summed over the ranks (run.sync_step), one optimizer
    step."""
    from ...parallel.mesh import world_size
    from ..run import sync_step
    from .anchors import a2j_loss

    def step(batch, gstep: int):
        lr = lr_fn(gstep)
        for group in optimizer.param_groups:
            group["lr"] = lr
        model.train()
        heads = model(batch["depth"].permute(0, 3, 1, 2))
        cls_l, reg_l = a2j_loss(heads, batch["label"], anchors,
                                spatial_factor=args.spatial_factor)
        size = world_size()
        if size > 1:
            cls_l, reg_l = cls_l / size, reg_l / size
        loss = cls_l + reg_l * args.reg_loss_factor
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = sync_step(model.parameters(), {
            "loss": loss.detach(), "cls_loss": cls_l.detach(),
            "reg_loss": reg_l.detach()})
        optimizer.step()
        metrics["learning_rate"] = lr
        return metrics

    return step


def read_bndbox(path: str) -> np.ndarray:
    """A bounding-box table: the reference's .mat (`FRbndbox_test`) or a
    pickle."""
    if path.endswith(".mat"):
        import scipy.io as scio

        return np.asarray(scio.loadmat(path)["FRbndbox_test"])
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


def evaluate(model, anchors, args, device):
    """In-loop PCK@10cm over the test set (A2J/main.py:365-386): eval-mode
    soft-argmax keypoints, mapped back to world coordinates.  Returns
    (PCK, per-joint PCK)."""
    from ...data.pipeline import collate
    from .anchors import post_process
    from .data import ITOPDataset, evaluation_10cm

    bnd = read_bndbox(args.bndbox_test)
    test_ds = ITOPDataset(args.test_dir, bnd, augment=False)
    model.eval()
    preds, worlds, means = [], [], []
    with torch.no_grad():
        for start in range(0, len(test_ds), args.batch_size):
            b = collate([test_ds[i] for i in range(
                start, min(start + args.batch_size, len(test_ds)))])
            depth = torch.from_numpy(b["depth"]).to(device)
            preds.append(post_process(model(depth.permute(0, 3, 1, 2)),
                                      anchors).cpu().numpy())
            worlds.append(b["keypoints_world"])
            means.append(b["mean"])
    pred = np.concatenate(preds)
    # the depth is de-normalised inside evaluation_10cm, with the means
    return evaluation_10cm(pred, np.concatenate(worlds), bnd[: len(pred)],
                           np.concatenate(means), per_joint=True)


def main(argv=None, on_step: Optional[Callable[[int], None]] = None):
    """Run the CLI on argv; on_step(n) after each step, n the global step
    count.  Returns a downstream.run.DownstreamRun (scores: PCK@10cm of
    each evaluation, the untrained one first under --eval_first)."""
    args = build_argparser().parse_args(argv)
    if args.arch == "resnet50" and args.pretrained_pth:
        raise ValueError(
            "--pretrained_pth with --arch resnet50: the JAX trainer loads it "
            "through its HRNet name tables, which map no name of the A2J "
            "ResNet50, so it loads 0 conv tensors and trains from scratch "
            "(ROADMAP.md Queue 3, F13b); drop --pretrained_pth to train "
            "from scratch, or use --arch hrnet")
    from ..run import join_ranks

    rank, size, device = join_ranks(args, "downstream.a2j.train")
    try:
        return _run(args, rank, size, device, on_step)
    finally:
        if size > 1 or "WORLD_SIZE" in os.environ:
            from ...parallel.mesh import destroy
            destroy()


def _run(args, rank: int, size: int, device, on_step):
    from ...data.pipeline import DataSource
    from ...export.transfer import load_hrnet_state, read_state_dict
    from ...parallel.mesh import broadcast_, local_world_size
    from ...utils.meters import MetricLogger
    from ..run import DownstreamRun, train_rows
    from .data import ITOPDataset

    say = print if rank == 0 else (lambda *a: None)
    crop = args.crop
    if args.synthetic:
        train_ds = SyntheticITOP(args.synthetic, crop)
    else:
        train_ds = ITOPDataset(args.train_dir, read_bndbox(args.bndbox_train),
                               augment=True, seed=args.seed)

    steps = max(len(train_ds) // args.batch_size, 1)
    src = DataSource(train_ds, args.batch_size, np.ones(len(train_ds)),
                     seed=args.seed,
                     num_workers=8 if size == 1 else max(
                         8 // local_world_size(), 1),
                     rows=train_rows(args.batch_size, rank, size))
    it = iter(src)
    try:
        # the JAX CLI draws one batch to initialise its model; drawing it
        # here too keeps the two CLIs' data streams aligned
        next(it)
        anchors = a2j_anchors(args.arch, crop, device)
        torch.manual_seed(args.seed)
        model = build_a2j(args, device)
        if args.pretrained_pth:
            n = load_hrnet_state(read_state_dict(args.pretrained_pth),
                                 model.Backbone)
            say(f"=> loaded {n} conv tensors from {args.pretrained_pth}")
        broadcast_([*model.parameters(), *model.buffers()])
        run = DownstreamRun(model)

        # StepLR(step=10 epochs, gamma=0.2) (A2J/main.py:302)
        lr_fn = step_lr_fn(args.learning_rate, args.lr_step * steps,
                           args.lr_gamma)
        # torch Adam(weight_decay=wd) couples L2 into the gradient (not
        # AdamW), as the reference trains
        optimizer = torch.optim.Adam(model.parameters(),
                                     lr=args.learning_rate,
                                     weight_decay=args.weight_decay)
        step = make_train_step(model, optimizer, lr_fn, anchors, args)
        evaluating = bool(args.test_dir and args.bndbox_test)

        logger = MetricLogger(None, print_freq=args.print_freq)
        best_acc = -1.0
        gstep = 0
        if args.eval_first and evaluating:
            acc, _ = evaluate(model, anchors, args, device)
            run.scores.append(float(acc))
            say(f"epoch 0: PCK@10cm {acc:.4f} (untrained baseline)")
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
            if evaluating:
                acc, _ = evaluate(model, anchors, args, device)
                run.scores.append(float(acc))
                flag = ""
                if acc > best_acc:
                    best_acc = acc
                    flag = " (best)"
                say(f"epoch {epoch}: PCK@10cm {acc:.4f}{flag}")
            say(f"epoch {epoch}, total time {time.time() - t0:.2f}")
            if args.max_steps and gstep >= args.max_steps:
                break
        return run
    finally:
        it.close()  # stops the DataSource's thread pool


if __name__ == "__main__":
    main()
