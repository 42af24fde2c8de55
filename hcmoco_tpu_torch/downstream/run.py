"""What the two downstream trainers (seg/train.py, a2j/train.py) share:
the device check, joining the ranks, the timed fetch-upload-step of one
iteration, and the record of a run."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List

import torch


def resolve_device(name: str, cli: str) -> torch.device:
    """`--device` as a torch.device; raises for a CUDA device when none is
    available (the CPU is only ever taken on request)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cli}: no CUDA device is available; pass "
                           "--device cpu to train on the CPU")
    return device


def join_ranks(args, cli: str) -> tuple:
    """(rank, world size, device) of a trainer's process: resolve_device,
    then, under torchrun or with --multihost in a SLURM job step, the
    process group and cuda:<local rank>, as the pre-training CLI joins
    (cli/main_contrast.py::join_ranks); the global --batch_size must
    split over the ranks."""
    from ..cli.main_contrast import join_ranks as join

    resolve_device(args.device, cli)
    return join(args, SimpleNamespace(batch_size=args.batch_size,
                                      microbatch=1))


def train_rows(batch_size: int, rank: int, size: int):
    """This rank's rows of each global batch, None in a world of one."""
    from ..parallel.mesh import shard_positions

    return None if size == 1 else shard_positions(batch_size, rank, size)


def sync_step(params, metrics: Dict) -> Dict:
    """Under data parallelism: the gradients summed over the ranks (each
    rank's loss is its share of the global one) and the tensor metrics
    made global; nothing in a world of one."""
    from ..parallel.mesh import all_reduce_grads, world_size
    from ..train.contrast_step import global_metrics

    if world_size() == 1:
        return metrics
    all_reduce_grads([p for p in params if p.grad is not None])
    return global_metrics(metrics)


@dataclass
class DownstreamRun:
    """What a trainer's main() did: the model, each step's metrics, each
    evaluation's score (mIoU or PCK@10cm, an untrained epoch-0 one first
    where the trainer ran one), and each step's host seconds: waiting on
    the data source (`wait_s`), pinning and enqueueing the upload
    (`upload_s`), and the train step up to its metrics read back
    (`step_s`)."""

    model: torch.nn.Module
    metrics: List[Dict[str, float]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    wait_s: List[float] = field(default_factory=list)
    upload_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)

    def timed_step(self, it: Iterator, device, step_fn: Callable
                   ) -> Dict[str, float]:
        """One iteration: the next host batch of `it`, uploaded to `device`,
        through step_fn(batch) -> {name: 0-d tensor}; the metrics read back
        as floats, recorded with the three host times and returned."""
        from ..cli.main_contrast import metric_floats
        from ..data.pipeline import to_device

        t_wait = time.perf_counter()
        host = next(it)
        t_upload = time.perf_counter()
        batch = to_device(host, device)
        t_step = time.perf_counter()
        values = metric_floats(step_fn(batch))
        t_end = time.perf_counter()
        self.wait_s.append(t_upload - t_wait)
        self.upload_s.append(t_step - t_upload)
        self.step_s.append(t_end - t_step)
        self.metrics.append(values)
        return values
