"""Contrastive pre-training CLI (counterpart of
hcmoco_tpu/cli/main_contrast.py).

Reference: `pycontrast/main_contrast.py` + the option surface of
`pycontrast/options/{base,train}_options.py`, with the JAX CLI's flags and
`config_from_args`, plus `--device` and `--packed_dir`.  One process drives
one device: the card unless `--device cpu` asks for the CPU.

Data parallelism: under torchrun (WORLD_SIZE in the environment), or with
`--multihost` over torchrun's multi-node rendezvous (the counterpart of
jax.distributed.initialize()), each process joins the process group (NCCL
on the card, gloo on the CPU), drives cuda:LOCAL_RANK and trains on its
rows of the global batch; `--batch_size` stays the global batch:
  torchrun --nproc_per_node=4 -m hcmoco_tpu_torch.cli.main_contrast \
      --recipe first_stage/ntumpiirgbd2s_hrnet_w18 ... --batch_size 224
A plain `python -m` run is one process on one card.

Usage:
  python -m hcmoco_tpu_torch.cli.main_contrast --method CMCRGBD2S \\
      --arch HRNet --dataset NTUMPII --data_folder ... --train_file_list ...
  python -m hcmoco_tpu_torch.cli.main_contrast \\
      --recipe first_stage/ntumpiirgbd2s_hrnet_w18 --data_folder ... \\
      --train_file_list ... --mpii_root ...
  python -m hcmoco_tpu_torch.cli.main_contrast --synthetic 512 ...  # no data

The baselines run through the same CLI: a method preset (--method InsDis,
CMC, MoCo, PIRL, MoCov2, CMCv2 or InfoMin) with --arch resnet50 (any
RESNET_SPECS name, or <resnet>cmc for CMC's shared trunk) on an ImageFolder
tree (--dataset folder --data_folder DIR/train); --IN_Pretrain fills the
ResNet encoder (the RGB methods' `encoder`, CMC's `encoder1`).

Each step's random draws (negatives; HRNetPN's depth2pts points; stage 2's
soft-Pri3D pixels; the baselines' jigsaw orders) come from a generator on
the device seeded from (seed + 1, global step) alone, so a resumed run
draws what an uninterrupted one would.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..core.config import TrainConfig
    from ..train.state import TrainState

# the versatility segmentor's fields: cli/main_segmentor.py takes them;
# the pre-training CLI, which trains no segmentation head, refuses them
SEGMENTOR_FIELDS = ("n_class", "supervise_type", "test_type",
                     "cmc_loss_weights", "other_loss_weights")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hcmoco_tpu_torch contrastive pretraining")
    p.add_argument("--recipe", type=str, default="",
                   help="named recipe from core.config.RECIPES; other flags "
                        "override it")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples (no dataset files)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; 'cpu' is the one way "
                        "onto the CPU")
    # mirrored reference flags (options/base_options.py)
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--modal", type=str, default=None)
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--head", type=str, default=None)
    p.add_argument("--feat_dim", type=int, default=None)
    p.add_argument("--mem", type=str, default=None)
    p.add_argument("--nce_k", "-k", type=int, default=None)
    p.add_argument("--nce_m", "-m", type=float, default=None)
    p.add_argument("--nce_t", "-t", type=float, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--pri3d_num_samples_per_image", type=int, default=None)
    p.add_argument("--scl_groups", type=int, default=None,
                   help="cross-subject SCL group count; 0 (default) = one "
                        "group per process, 1 = the whole batch")
    p.add_argument("--modality_missing", type=int, default=None)
    p.add_argument("--linear_feat_map", type=int, default=None)
    p.add_argument("--pool_method", type=str, default=None)
    p.add_argument("--skeleton_meta_name", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--lr_decay_epochs", type=str, default=None)
    p.add_argument("--lr_decay_rate", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--cosine", action="store_true", default=None)
    p.add_argument("--warm", action="store_true", default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--data_folder", type=str, default=None)
    p.add_argument("--train_file_list", type=str, default=None)
    p.add_argument("--mpii_root", type=str, default=None)
    p.add_argument("--coco_root", type=str, default=None)
    p.add_argument("--seg_root", type=str, default=None)
    p.add_argument("--seg_file_list", type=str, default=None)
    p.add_argument("--packed_dir", type=str, default=None)
    p.add_argument("--aug", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--random_flip", type=int, default=None)
    p.add_argument("--not_use_weighted_sampler", action="store_true",
                   default=None)
    # versatility / segmentation (main_segmentor.py surface)
    p.add_argument("--n_class", type=int, default=None)
    p.add_argument("--supervise_type", type=int, default=None)
    p.add_argument("--test_type", type=int, default=None)
    p.add_argument("--mask_seg_depth", action="store_true", default=None)
    p.add_argument("--mask_seg_rgb", action="store_true", default=None)
    p.add_argument("--cmc_loss_weights", type=float, default=None)
    p.add_argument("--other_loss_weights", type=float, default=None)
    p.add_argument("--seg_val_file_list", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--IN_Pretrain", type=str, default="")
    p.add_argument("--depth_Pretrain", type=str, default="")
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--microbatch", type=int, default=None,
                   help="split each batch into N sequential microbatches, "
                        "one optimizer step (N must divide the batch)")
    p.add_argument("--num_workers", "-j", type=int, default=8)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--deterministic_data", action="store_true",
                   help="accepted for the JAX CLI's command lines, where "
                        "it has no effect either")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of global steps 10-15 "
                        "to this directory (TensorBoard's trace format)")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over torchrun's (multi-node) "
                        "rendezvous: join the process group its environment "
                        "describes")
    return p


def config_from_args(args, accept: Tuple[str, ...] = ()) -> "TrainConfig":
    """The TrainConfig of parsed args: the recipe, then every flag given.
    accept: the SEGMENTOR_FIELDS this caller takes (cli/main_segmentor.py
    all of them, cli/main_linear.py n_class); the others raise when
    given."""
    from ..core.config import RECIPES, TrainConfig, resolve_config

    if args.recipe and args.recipe not in RECIPES:
        import sys
        sys.exit(f"error: unknown --recipe '{args.recipe}'. Available:\n  "
                 + "\n  ".join(sorted(RECIPES)))
    for name in SEGMENTOR_FIELDS:
        if name not in accept and getattr(args, name, None) is not None:
            raise NotImplementedError(
                f"--{name} sets a field of the versatility segmentor "
                "(ROADMAP.md Queue 1 item 12), which trains through "
                "cli/main_segmentor.py, not this CLI")
    cfg = RECIPES[args.recipe] if args.recipe else TrainConfig()
    overrides = {}
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            if f.name == "lr_decay_epochs" and isinstance(v, str):
                v = tuple(int(x) for x in v.split(","))
            elif f.type in ("bool",) or isinstance(f.default, bool):
                v = bool(v)
            overrides[f.name] = v
    cfg = dataclasses.replace(cfg, **overrides)
    return resolve_config(cfg)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, a function of (seed, step)
    alone: the counterpart of jax.random.fold_in(PRNGKey(seed), step)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(hi) << 32 | int(lo))


def metric_floats(metrics: Dict) -> Dict[str, float]:
    """The step's 0-d tensor metrics read back in one transfer."""
    names = [k for k, v in metrics.items() if torch.is_tensor(v)]
    values = torch.stack([metrics[k].float() for k in names]).tolist() \
        if names else []
    out = {k: float(v) for k, v in metrics.items() if not torch.is_tensor(v)}
    out.update(zip(names, values))
    return out


@dataclass
class RunResult:
    """What main() did: the final state, the data size, the epochs run,
    the checkpoint directory, and each step's host seconds: waiting on
    the data source (`wait_s`), pinning and enqueueing the upload
    (`upload_s`), and the train step up to its metrics read back
    (`step_s`)."""

    state: "TrainState"
    n_data: int
    steps_per_epoch: int
    start_epoch: int
    last_epoch: int
    ckpt_dir: str
    wait_s: List[float] = field(default_factory=list)
    upload_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_PORT")

# --profile_dir traces these global steps, first and last, as the JAX CLI's
# jax.profiler trace does
PROFILE_STEPS = (10, 15)


class StepTrace:
    """--profile_dir: torch.profiler over global steps PROFILE_STEPS, its
    CPU activity and, on the card, its CUDA activity; each traced step is
    a `global_step N` span.  It starts before step 10 (a run that starts
    past it, resumed, traces nothing, as the JAX CLI) and stops after
    step 15 once the step's metrics are read back, or when the run ends
    first (close(); the JAX CLI leaves that trace unwritten).
    tensorboard_trace_handler writes one `<host>_<pid>.<time>.pt.trace.json`
    a process, so each rank of a data-parallel run writes its own, as each
    JAX process does."""

    def __init__(self, profile_dir: str, device, say: Callable):
        self.dir, self.device, self.say = profile_dir, device, say
        self.prof = None

    def span(self, step: int):
        """The context of global step `step`: the profiler started at the
        first traced step, and the step's span while it runs."""
        if self.dir and step == PROFILE_STEPS[0] and self.prof is None:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self.dir))
            self.prof.start()
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"global_step {step}")

    def after(self, step: int) -> None:
        if step >= PROFILE_STEPS[1]:
            self.close()

    def close(self) -> None:
        """Stop the profiler, if it runs, and write its trace."""
        if self.prof is None:
            return
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof = None
        self.say(f"profiler trace written to {self.dir}")


def join_ranks(args, cfg: "TrainConfig") -> tuple:
    """(rank, world size, device) of this process.  Under torchrun
    (WORLD_SIZE in the environment) or --multihost it joins the process
    group, NCCL on the card (cuda:LOCAL_RANK) and gloo on the CPU;
    otherwise (0, 1, --device).  Exits with the JAX CLI's error when the
    global batch does not split over the ranks (times --microbatch)."""
    from ..parallel.mesh import init_distributed

    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if args.multihost and missing:
        raise NotImplementedError(
            "--multihost joins the process group that torchrun's rendezvous "
            f"describes, and {', '.join(missing)} is not set: launch with "
            "torchrun (--nnodes/--rdzv_endpoint across hosts).  Finding a "
            "cluster without it, as jax.distributed.initialize() does on "
            "SLURM, is not ported (ROADMAP.md Queue 1 item 10 ports "
            "torchrun's rendezvous)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    rank, size = 0, 1
    if args.multihost or "WORLD_SIZE" in os.environ:
        rank, size = init_distributed(device=args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    n = size * max(cfg.microbatch, 1)
    if cfg.batch_size % n:
        sys.exit(f"error: --batch_size {cfg.batch_size} must be divisible "
                 f"by the {size}-device 'data' mesh axis"
                 + (f" times --microbatch {cfg.microbatch}"
                    if cfg.microbatch > 1 else ""))
    return rank, size, device


def shard_stream(batches, rows):
    """This rank's rows of every batch of a host stream (the synthetic
    sources, which generate the global batch); the stream itself when
    rows is None."""
    if rows is None:
        yield from batches
        return
    for b in batches:
        yield {k: np.ascontiguousarray(v[rows]) for k, v in b.items()}


def print_options(cfg: "TrainConfig") -> None:
    from ..core.config import to_dict

    print("----------------- Options ---------------")
    for k, v in sorted(to_dict(cfg).items()):
        print(f"{k:>35}: {v}")
    print("----------------- End -------------------")


def graft_and_resume(cfg: "TrainConfig", state: "TrainState",
                     ckpt_dir: str) -> tuple:
    """--pretrain (a previous stage's checkpoint, partially grafted;
    main_contrast.py:52-67), the moco key encoder set to the model's
    weights as loaded so far, then --resume from ckpt_dir (which restores
    the key encoder too).  Returns (state, its CheckpointManager, the
    first epoch to run)."""
    from ..train.checkpoint import CheckpointManager, graft_pretrain
    from ..train.state import copy_to_key_model

    if cfg.pretrain:
        state = graft_pretrain(cfg.pretrain, state)
    copy_to_key_model(state)
    ckpt = CheckpointManager(ckpt_dir, save_freq=cfg.save_freq)
    start_epoch = 1
    if cfg.resume:
        state, last = ckpt.restore(state)
        start_epoch = last + 1
        if last and ckpt.is_writer:
            print(f"=> resumed from epoch {last}")
    return state, ckpt, start_epoch


def train_epochs(args, cfg: "TrainConfig", state: "TrainState", it, device,
                 ckpt, result: RunResult, step_fn: Callable,
                 on_step: Optional[Callable[[int], None]] = None,
                 after_epoch: Optional[Callable[[int], None]] = None
                 ) -> None:
    """The epochs from result.start_epoch to cfg.epochs (or --max_steps):
    each step's batch from `it`, uploaded, stepped with the generator of
    (seed + 1, global step), its host times recorded in `result` and its
    metrics logged; each epoch's TSV line and checkpoint, then
    after_epoch(epoch).  With --profile_dir, global steps 10-15 are
    traced (StepTrace)."""
    from ..data.pipeline import to_device
    from ..utils.meters import MetricLogger

    logger = MetricLogger(ckpt.directory, print_freq=cfg.print_freq)
    trace = StepTrace(args.profile_dir, device,
                      (lambda *a: None) if logger.quiet else print)
    steps_per_epoch = result.steps_per_epoch
    global_step = state.step
    try:
        for epoch in range(result.start_epoch, cfg.epochs + 1):
            t0 = time.time()
            logger.reset()
            for i in range(steps_per_epoch):
                t_wait = time.perf_counter()
                host = next(it)
                t_upload = time.perf_counter()
                batch = to_device(host, device)
                t_step = time.perf_counter()
                with trace.span(global_step):
                    metrics = step_fn(state, batch, step_generator(
                        cfg.seed + 1, global_step, device))
                    values = metric_floats(metrics)
                t_end = time.perf_counter()
                trace.after(global_step)
                global_step += 1
                result.wait_s.append(t_upload - t_wait)
                result.upload_s.append(t_step - t_upload)
                result.step_s.append(t_end - t_step)
                logger.log_step(epoch, i, steps_per_epoch, values,
                                n=cfg.batch_size)
                if on_step is not None:
                    on_step(global_step)
                if args.max_steps and global_step >= args.max_steps:
                    break
            logger.write_epoch(epoch)
            ckpt.save(epoch, state)
            result.last_epoch = epoch
            if after_epoch is not None:
                after_epoch(epoch)
            if not logger.quiet:
                print(f"epoch {epoch}, total time {time.time() - t0:.2f}")
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        trace.close()
        logger.close()


def main(argv=None, on_ready: Optional[Callable] = None,
         on_step: Optional[Callable[[int], None]] = None) -> RunResult:
    """Run the CLI on argv.  on_ready(state) is called once the state is
    built, grafted and restored, before the first step; on_step(n) after
    each step, n the global step count (instrumentation, e.g. a
    profiler's step)."""
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.batch_size % max(cfg.microbatch, 1):
        raise ValueError(f"--microbatch {cfg.microbatch} does not divide "
                         f"--batch_size {cfg.batch_size}")
    rank, size, device = join_ranks(args, cfg)
    try:
        return _run(args, cfg, rank, size, device, on_ready, on_step)
    finally:
        if size > 1 or "WORLD_SIZE" in os.environ:
            from ..parallel.mesh import destroy
            destroy()


def rank_rows(cfg: "TrainConfig", rank: int, size: int):
    """This rank's rows of the global batch, None in a world of one."""
    from ..parallel.mesh import shard_positions

    if size == 1:
        return None
    return shard_positions(cfg.batch_size, rank, size,
                           max(cfg.microbatch, 1))


def decode_threads(args, size: int) -> int:
    """--num_workers, divided by the ranks on this host under data
    parallelism (at least 1)."""
    from ..parallel.mesh import local_world_size

    if size == 1:
        return args.num_workers
    return max(args.num_workers // local_world_size(), 1)


def _run(args, cfg: "TrainConfig", rank: int, size: int, device,
         on_ready, on_step) -> RunResult:
    from ..models.build import build_model
    from ..train.contrast_step import make_contrast_train_step
    from ..train.state import create_train_state

    if rank == 0:
        print_options(cfg)
    rows = rank_rows(cfg, rank, size)

    if args.synthetic:
        from ..data.synthetic import SyntheticContrastSource

        if cfg.mem == "moco":
            # the JAX CLI feeds this source's 3 channels to a step that
            # splits them into two crops (ROADMAP.md Queue 3, F11)
            raise ValueError(
                "--synthetic with mem='moco': the synthetic source yields "
                "one 3-channel image, and the moco step needs the query and "
                "the key crop stacked on channels; train moco from folder "
                "data (--dataset folder --data_folder ...)")
        n_data = args.synthetic
        source = SyntheticContrastSource(
            cfg.batch_size, size=cfg.crop_size,
            num_joints=cfg.num_joints, n_data=n_data, seed=cfg.seed,
            modal=cfg.modal)
        steps_per_epoch = max(n_data // cfg.batch_size, 1)
        it = shard_stream(iter(source), rows)
    else:
        from ..data.pipeline import build_contrast_source

        source, n_data, steps_per_epoch = build_contrast_source(
            cfg, num_workers=decode_threads(args, size), rows=rows)
        it = iter(source)

    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = build_model(cfg, device=device).to(
        memory_format=torch.channels_last)
    try:
        # the JAX CLI draws one batch to initialise its state; drawing it
        # here too keeps the two CLIs' data streams aligned
        next(it)
        state = create_train_state(
            cfg, model, torch.Generator(device).manual_seed(cfg.seed),
            n_data, steps_per_epoch)
        if args.IN_Pretrain or args.depth_Pretrain:
            from ..export.transfer import load_imagenet_pretrained

            # the RGB baselines and the CMC shared trunk have one encoder
            first = "encoder" if hasattr(model, "encoder") else "encoder1"
            for enc, path in ((first, args.IN_Pretrain),
                              ("encoder2", args.depth_Pretrain)):
                if path:
                    n = load_imagenet_pretrained(path, model,
                                                 encoder_names=(enc,))
                    if rank == 0:
                        print(f"=> loaded {n} conv tensors into {enc} "
                              f"from {path}")
        state, ckpt, start_epoch = graft_and_resume(
            cfg, state, f"{cfg.model_path}/{cfg.model_name}")
        if on_ready is not None:
            on_ready(state)
        result = RunResult(state, n_data, steps_per_epoch, start_epoch,
                           start_epoch - 1, ckpt.directory)
        train_epochs(args, cfg, state, it, device, ckpt, result,
                     make_contrast_train_step(cfg, model, steps_per_epoch),
                     on_step)
    finally:
        it.close()  # stops the DataSource's thread pool
    return result


if __name__ == "__main__":
    main()
