"""Checkpoint save/resume and the stage-1 -> stage-2 graft (counterpart of
hcmoco_tpu/train/checkpoint.py, which writes orbax checkpoints).

Reference semantics (`contrast_trainer.py:93-140`): every epoch write the
model, the contrast memory banks, the optimizer and the epoch; resume
restores everything including the banks.  Here a checkpoint is one
`torch.save` file, `<directory>/epoch_<n>.pt`, holding the model's
state_dict (the reference torch names, BN running statistics included),
the optimizer's state_dict (SGD's momentum buffers), the banks, `step` and
`epoch`; a versatility segmentor's also its classifier's state_dict
(`classifier`, the reference FCN names); a moco run's, in place of the
banks, the key encoder's parameters (`key_model`, the EMA ones, under the
model's names), the queue (`queues`) and its pointer (`ptr`).  The
reference BN names and buffers are the same with HCMOCO_CONVBN_FUSE on or
off, so a checkpoint of one path restores into the other.

Under data parallelism the ranks' states are replicas: rank 0 writes, every
rank waits for the write (a barrier), and every rank restores from the same
file, so the banks and parameters come back identical on every rank.  A
checkpoint does not depend on the world size it was written at.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from ..parallel.mesh import barrier, world
from .state import TrainState

_CKPT = re.compile(r"epoch_(\d+)\.pt")


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


class CheckpointManager:
    """One file per epoch under `directory`, the newest `max_to_keep`
    kept (orbax's CheckpointManager options in the JAX package)."""

    def __init__(self, directory: str, save_freq: int = 20,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_freq = save_freq
        self.max_to_keep = max_to_keep
        # rank 0 writes (and reports) under data parallelism
        self.is_writer = world()[0] == 0
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> list:
        """The saved epochs, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _CKPT.fullmatch, os.listdir(self.directory)) if m)

    def save(self, epoch: int, state: TrainState):
        """Write epoch `epoch` (replacing one of that number), then drop
        all but the newest max_to_keep.  The file is written under a
        temporary name and renamed, so a reader never sees a partial one.
        Rank 0 writes; every rank returns once it has."""
        if not self.is_writer:
            barrier()
            return
        path = self.path(epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        ckpt = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "banks": state.banks, "step": int(state.step),
                "epoch": int(epoch)}
        if state.classifier is not None:
            ckpt["classifier"] = state.classifier.state_dict()
        if state.moco is not None:
            ckpt["key_model"] = {n: p.detach() for n, p in
                                 state.key_model.named_parameters()}
            ckpt["queues"] = state.moco.queues
            ckpt["ptr"] = int(state.moco.ptr)
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self.path(old))
        barrier()

    def restore(self, state: TrainState,
                epoch: Optional[int] = None) -> Tuple[TrainState, int]:
        """Load the latest (or the given) epoch into `state`, in place, on
        the model's device; returns (state, epoch), epoch 0 when there is
        no checkpoint."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            return state, 0
        ckpt = torch.load(self.path(epoch), map_location=_device(state),
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        if state.classifier is not None:
            state.classifier.load_state_dict(ckpt["classifier"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        with torch.no_grad():
            if state.moco is not None:
                for name, p in state.key_model.named_parameters():
                    p.copy_(ckpt["key_model"][name])
                state.moco.queues.copy_(ckpt["queues"])
                state.moco.ptr = int(ckpt["ptr"])
            else:
                state.banks.copy_(ckpt["banks"])
        state.step = int(ckpt["step"])
        return state, int(ckpt["epoch"])

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None


def resolve_checkpoint(pretrain_path: str) -> str:
    """A checkpoint file, or a run directory (its latest epoch)."""
    path = os.path.abspath(pretrain_path)
    if os.path.isdir(path):
        latest = CheckpointManager(path).latest_epoch()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        return CheckpointManager(path).path(latest)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def graft_pretrain(pretrain_path: str, state: TrainState) -> TrainState:
    """Cold-start from a previous stage's checkpoint: copy every model
    tensor whose name and shape match, keep the newly initialised ones
    (stage 2 adds encoder{1,2}_linear), and the banks when their shape
    matches.  The optimizer and the step stay the new state's (a fresh
    SGD at step 0), as the JAX graft keeps the new optimizer trace.

    Reference: main_contrast.py:52-67 (`--pretrain` with partial
    matching); the segmentor's graft (main_segmentor.py:50-65) fills its
    encoders, heads and banks alike and leaves its classifier at its
    initialisation.  pretrain_path is a checkpoint file or a run
    directory.
    Prints the JAX package's counts: parameters, and BN running means and
    variances as its batch statistics (rank 0 prints)."""
    path = resolve_checkpoint(pretrain_path)
    ckpt = torch.load(path, map_location=_device(state), weights_only=True)
    src = ckpt["model"]
    params = dict(state.model.named_parameters())
    n_param = n_stat = 0
    with torch.no_grad():
        for name, dst in state.model.state_dict().items():
            got = src.get(name)
            if got is None or got.shape != dst.shape:
                continue
            dst.copy_(got)
            if name in params:
                n_param += 1
            elif name.endswith(("running_mean", "running_var")):
                n_stat += 1
        say = print if world()[0] == 0 else (lambda *a: None)
        say(f"=> grafted {n_param} param tensors from {path}")
        say(f"=> grafted {n_stat} batch-stat tensors from {path}")
        banks = ckpt.get("banks")
        if (banks is not None and state.banks is not None
                and banks.shape == state.banks.shape):
            state.banks.copy_(banks)
            say("=> grafted memory banks")
    return state
