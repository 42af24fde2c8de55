"""Data parallelism over torch.distributed ranks (counterpart of
hcmoco_tpu/parallel/mesh.py).

The JAX package runs one global-batch program over a ('data', 'model')
mesh: the batch is sharded over 'data', parameters and memory banks are
replicated, BN statistics are those of the global batch, and the gradient
is that of the global-mean loss.  The port runs one process a rank (one
card each, launched by torchrun or by a SLURM job step's `srun`,
`cluster_env`) and holds each rank to the same global
step: rank r holds rows of the global batch (`shard_rows`), and the few
places that see the batch as a whole go through the collectives here:

  * `all_reduce_sum` (differentiable): the BN channel sums, so every BN
    normalises with global statistics; its backward sums the sums'
    cotangents over the ranks, which is the gradient of the global loss;
  * `global_sum` (no gradient): the loss denominators and gates;
  * `gather_rows`: the features and indices of the replicated bank
    update, in global row order;
  * `gather_rows_grad`: rows a loss needs from the other ranks with their
    gradient (an SCL group that spans ranks);
  * `all_reduce_grads`: one flattened all-reduce of the gradients.

With no process group, or a world of one, every function here is an
identity and launches nothing, so a one-process run is what it was.
`STATS` counts the collectives issued (in a world above one).  While
spans record (utils/spans.py), each collective is a span named after
its function: NCCL runs them asynchronously, so their time is the
span's device interval, not the host's time in the call.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..train import remat
from ..utils import spans

# the process group's timeout: a rank that waits longer on a collective
# raises instead of hanging
DEFAULT_TIMEOUT_S = 600

# collectives issued in a world above one
STATS = {"calls": 0}
# the spans of the collectives, one a function
COLLECTIVES = ("all_reduce_sum", "global_sum", "gather_rows",
               "gather_rows_grad", "all_reduce_grads")


def _counted(name: str):
    """The span of the collective `name`, counted."""
    STATS["calls"] += 1
    return spans.span(name)


# torchrun's rendezvous variables, and a SLURM job step's that
# jax.distributed.initialize() reads (jax/_src/clusters/slurm_cluster.py)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_PORT")
SLURM_ENV = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
             "SLURM_PROCID", "SLURM_LOCALID")

# where init_distributed joined (launcher, rank, world, local_rank,
# address); empty once the group is left
JOINED: Dict = {}


def slurm_first_host(node_list: str) -> str:
    """The first host of a SLURM node list, as JAX's SlurmCluster reads
    it: 'node001', 'node001,host2', 'node[001-0015],host2' and
    'node[001,007-015],host2' all give 'node001'."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ",["),
               len(node_list))
    if cut == len(node_list) or node_list[cut] == ",":
        return node_list[:cut]
    rest = node_list[cut + 1:]
    end = next((i for i, ch in enumerate(rest) if ch in ",-]"), len(rest))
    return node_list[:cut] + rest[:end]


def cluster_env() -> Optional[Dict]:
    """Where this process joins, from the environment: torchrun's where
    RANK, WORLD_SIZE and MASTER_PORT are set; else a
    SLURM job step's where all of SLURM_ENV are: rank SLURM_PROCID of
    SLURM_NTASKS, local rank SLURM_LOCALID, the first host of
    SLURM_STEP_NODELIST at MASTER_PORT, or at SLURM_JOB_ID % 4096 + 61440
    as jax.distributed.initialize() takes it.  -> {launcher, rank, world,
    local_rank, addr, port}, or None with neither."""
    env = os.environ
    if all(k in env for k in TORCHRUN_ENV):
        return dict(launcher="torchrun", rank=int(env["RANK"]),
                    world=int(env["WORLD_SIZE"]),
                    local_rank=int(env.get("LOCAL_RANK", "0")),
                    addr=env.get("MASTER_ADDR", "localhost"),
                    port=int(env["MASTER_PORT"]))
    if all(k in env for k in SLURM_ENV):
        port = env.get("MASTER_PORT") or (int(env["SLURM_JOB_ID"]) % 4096
                                          + 61440)
        return dict(launcher="slurm", rank=int(env["SLURM_PROCID"]),
                    world=int(env["SLURM_NTASKS"]),
                    local_rank=int(env["SLURM_LOCALID"]),
                    addr=slurm_first_host(env["SLURM_STEP_NODELIST"]),
                    port=int(port))
    return None


def init_distributed(backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group that torchrun's or a SLURM job step's
    environment describes (`cluster_env`): the counterpart of
    jax.distributed.initialize().

    backend: 'nccl' or 'gloo'; None takes NCCL on the card and gloo on the
    CPU (`device` 'cpu').  On the card the current device becomes
    cuda:<local rank>, or cuda:0 where the launcher shows each task one
    card.  Records where it joined in JOINED.  Returns (rank, world
    size)."""
    where = cluster_env()
    if where is None:
        raise RuntimeError(
            "no process group to join: neither torchrun's environment ("
            f"{', '.join(TORCHRUN_ENV)}) nor a SLURM job step's "
            f"({', '.join(SLURM_ENV)}) is set; launch with torchrun "
            "(--nnodes/--rdzv_endpoint across hosts) or with srun")
    rank, size, local = where["rank"], where["world"], where["local_rank"]
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        torch.cuda.set_device(local if torch.cuda.device_count() > 1
                              else 0)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{where['addr']}:{where['port']}",
            rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
    JOINED.clear()
    JOINED.update(launcher=where["launcher"], rank=rank, world=size,
                  local_rank=local,
                  address=f"{where['addr']}:{where['port']}")
    return rank, size


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return world()[1]


def slurm_tasks_on_node(tasks_per_node: str, node: int) -> int:
    """Node `node`'s entry of SLURM_STEP_TASKS_PER_NODE: '4(x2)' is 4 on
    each of two nodes, '2,1' 2 on the first and 1 on the second."""
    counts = []
    for part in tasks_per_node.split(","):
        n, _, rep = part.partition("(x")
        counts += [int(n)] * (int(rep.rstrip(")")) if rep else 1)
    return counts[min(node, len(counts) - 1)]


def local_world_size() -> int:
    """The ranks on this host: torchrun's LOCAL_WORLD_SIZE, else this
    node's entry (SLURM_NODEID) of a SLURM step's
    SLURM_STEP_TASKS_PER_NODE; 1 without either."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if "SLURM_STEP_TASKS_PER_NODE" in os.environ:
        return slurm_tasks_on_node(os.environ["SLURM_STEP_TASKS_PER_NODE"],
                                   int(os.environ.get("SLURM_NODEID", "0")))
    return 1


def shard_positions(batch_size: int, rank: int, size: int,
                    microbatch: int = 1) -> np.ndarray:
    """The rows of a global batch of `batch_size` that rank `rank` of
    `size` holds, ascending.  With `microbatch` n the step splits the
    rank's rows into n chunks, and chunk i must be the rank's share of the
    global microbatch i, rows [i B/n, (i+1) B/n) (the JAX package's
    train_step_microbatch): so the rank holds rows
    [i B/n + r B/(n W), i B/n + (r+1) B/(n W)) for each i."""
    n = max(microbatch, 1)
    if batch_size % (n * size):
        raise ValueError(f"the global batch of {batch_size} does not split "
                         f"into {n} microbatch(es) over {size} rank(s)")
    per_mb = batch_size // n
    per_rank = per_mb // size
    return np.concatenate([
        np.arange(i * per_mb + rank * per_rank,
                  i * per_mb + (rank + 1) * per_rank) for i in range(n)])


def shard_rows(batch: Dict, rank: int, size: int,
               microbatch: int = 1) -> Dict:
    """This rank's rows (`shard_positions`) of every array or tensor of a
    global batch dict; the batch itself at size 1."""
    if size == 1:
        return batch
    bsz = next(iter(batch.values())).shape[0]
    pos = shard_positions(bsz, rank, size, microbatch)
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v[torch.as_tensor(pos, device=v.device)]
        else:
            out[k] = np.ascontiguousarray(np.asarray(v)[pos])
    return out


def my_rows(global_rows: int) -> slice:
    """The slice of a draw made for `global_rows` rows (the global batch,
    or a global microbatch) that this rank's rows take: ranks hold equal
    consecutive shares."""
    rank, size = world()
    per = global_rows // size
    return slice(rank * per, (rank + 1) * per)


def _all_reduced(t: torch.Tensor) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    with _counted("all_reduce_sum"):
        dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """torch.distributed.nn.functional.all_reduce's autograd (deprecated
    in this torch for the traced functional collectives), counted: the
    backward all-reduces the cotangent.  In a recomputed region the
    forward hands back its first run's sum (train/remat.py::recorded)."""

    @staticmethod
    def forward(ctx, t):
        return remat.recorded(lambda: _all_reduced(t))

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with _counted("all_reduce_sum"):
            dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of t, differentiable: its backward
    all-reduces the cotangent, so each rank's input gets the sum over the
    ranks of what their losses send back (the gradient of the sum of the
    ranks' losses); t itself at size 1."""
    if world_size() == 1:
        return t
    return _AllReduceSum.apply(t)


@torch.no_grad()
def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of t, with no gradient (denominators and
    gates); t itself at size 1."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    with _counted("global_sum"):
        dist.all_reduce(out)
    return out


@torch.no_grad()
def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' t concatenated along dim 0 in rank order (the global
    batch's row order), with no gradient; t itself at size 1."""
    if world_size() == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size())]
    with _counted("gather_rows"):
        dist.all_gather(parts, t)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward sums the cotangent over the
    ranks (one all-reduce, which every backend has) and keeps this rank's
    rows."""

    @staticmethod
    def forward(ctx, t):
        rank, size = world()
        ctx.rank, ctx.rows = rank, t.shape[0]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        with _counted("gather_rows_grad"):
            dist.all_gather(parts, t)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with _counted("gather_rows_grad"):
            dist.all_reduce(g)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def gather_rows_grad(t: torch.Tensor) -> torch.Tensor:
    """gather_rows with the gradient flowing back to each rank's rows;
    t itself at size 1."""
    if world_size() == 1:
        return t
    return _GatherRows.apply(t)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite every tensor with rank src's, in place (no-op at size 1)."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum every parameter's .grad over the ranks with one flattened
    all-reduce (no-op at size 1).  Each rank's loss is its share of the
    global loss (losses with global denominators), so the sum is the
    gradient of the global loss; every rank gets the same bits, so the
    ranks' SGD steps stay identical."""
    if world_size() == 1:
        return
    grads: List[torch.Tensor] = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    with _counted("all_reduce_grads"):
        dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    JOINED.clear()


def leave() -> None:
    """Leave the process group if init_distributed joined one: the entry
    points' teardown, whichever launcher started them."""
    if JOINED:
        destroy()
