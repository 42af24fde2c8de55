"""Spawning the gloo ranks of the port's data-parallel tests.

Each rank is a fresh `python tests/torch_dp_worker.py` (torch and the
port only), joined over localhost; the process group has a 100 s timeout
and the test waits at most `timeout` seconds for its ranks, killing them
on expiry, so a stuck collective fails the test instead of hanging it.
The ranks get torchrun's environment, or with launcher 'slurm' a SLURM
job step's and none of torchrun's (the port then derives from
SLURM_JOB_ID, as jax.distributed.initialize() does).
"""

import os
import random
import socket
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

from hcmoco_tpu_torch.parallel import batchnorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")


@contextmanager
def ranks_formula():
    """In this process, training BN layers normalise as the ranks do (f32
    sums of x and x^2, var = E[x^2] - E[x]^2, the all-reduce an identity)
    in a world of one: the one-process run a data-parallel one is held
    to."""
    before = batchnorm.global_stats_active
    batchnorm.global_stats_active = lambda: True
    try:
        yield
    finally:
        batchnorm.global_stats_active = before


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# SLURM's coordinator port: 61440 + SLURM_JOB_ID % 4096
SLURM_PORT0 = 61440
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def free_slurm_port() -> int:
    """A free localhost port that a SLURM job id maps to."""
    for port in random.sample(range(SLURM_PORT0, 65536), 65536 - SLURM_PORT0):
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port in SLURM's range")


class _Ranks:
    """The worker processes of one run_ranks call."""

    def __init__(self, spec, tmp_dir, world, timeout, clis, launcher):
        pick = free_slurm_port if launcher == "slurm" else free_port
        spec_path = os.path.join(tmp_dir, "spec.pt")
        if clis is None:
            torch.save(spec, spec_path)
        else:  # one port a run: each CLI joins and leaves its own group
            ports = set()
            while len(ports) < len(clis):
                ports.add(pick())
            torch.save([(which, list(argv), port) for (which, argv), port
                        in zip(clis, sorted(ports))], spec_path)
        port = pick()
        self.tmp_dir, self.procs, self.outs = tmp_dir, [], []
        for r in range(world):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       PYTHONPATH=ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            if launcher == "slurm":
                for k in TORCHRUN_VARS:
                    env.pop(k, None)
                env.update(SLURM_JOB_ID=str(port - SLURM_PORT0),
                           SLURM_STEP_NODELIST="localhost",
                           SLURM_NTASKS=str(world), SLURM_PROCID=str(r),
                           SLURM_LOCALID=str(r), SLURM_NODEID="0",
                           SLURM_STEP_TASKS_PER_NODE=str(world))
            else:
                env.update(RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
            out = os.path.join(tmp_dir, f"rank{r}.pt")
            self.outs.append(out)
            cmd = ([sys.executable, WORKER]
                   + ([] if clis is None else ["--clis"])
                   + [spec_path, out])
            # a file, not a pipe: a rank blocked on a full pipe would stall
            # the other one in a collective
            with open(os.path.join(tmp_dir, f"rank{r}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=ROOT))
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout

    def results(self):
        for r, p in enumerate(self.procs):
            try:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"a rank did not finish in {self.timeout} s")
            if p.returncode != 0:
                with open(os.path.join(self.tmp_dir, f"rank{r}.log")) as log:
                    raise AssertionError(f"rank {r} failed:\n{log.read()}")
        return [torch.load(o, weights_only=False) for o in self.outs]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@contextmanager
def ranks_running(spec, tmp_dir, world: int = 2, timeout: float = 120.0,
                  clis=None, launcher: str = "torchrun"):
    """Start `world` ranks of the worker on `spec` (a list of cases, see
    torch_dp_worker.run_case) and yield a function that waits for them
    and returns their results, rank order; the caller may work meanwhile.
    clis: a list of (which, argv): run those CLIs in turn instead (spec
    unused, see torch_dp_worker.run_clis); a rank's result is then the
    list of their snapshots.  launcher: 'torchrun' or 'slurm', whose
    environment the ranks get.  Ranks still running on exit are
    killed."""
    ranks = _Ranks(spec, tmp_dir, world, timeout, clis, launcher)
    try:
        yield ranks.results
    finally:
        ranks.kill()


def run_ranks(spec, tmp_dir, world: int = 2, timeout: float = 120.0,
              clis=None, launcher: str = "torchrun"):
    """ranks_running's results, waited for at once."""
    with ranks_running(spec, tmp_dir, world, timeout, clis,
                       launcher) as results:
        return results()
