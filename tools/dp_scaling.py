"""Data-parallel stage-1 steps across cards: the port's collectives over
NCCL and its scaling against one card.

Usage: python3 tools/dp_scaling.py [--ranks 4] [--batch 32] [--steps 6]
                                   [--device cuda|cpu]

Runs the HRNet-W18 320^2 stage-1 step (HCMOCO_CONVBN_FUSE=1, bf16, the
smoke's configuration, `batch` rows a rank) first on one card alone, then
on `ranks` cards at once, each rank a process of this script joined over
NCCL (gloo with --device cpu, where it runs a width-4 32^2 f32 model for
a rehearsal).  Each run times its steps on the host clock around
torch.cuda.synchronize() and profiles its last two steps with
torch.profiler.  Prints, with every card's name and power limit:
  - the median step and samples/s of the one-card run and of rank 0 of
    the multi-card run, and the scaling efficiency (multi-card samples/s
    over `ranks` times one card's);
  - the collectives a step (parallel/mesh.py's STATS), the NCCL kernels
    a step and their device ms (profiler rows whose name holds 'nccl');
  - that the ranks' parameters and banks are equal bit for bit after the
    last step.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

PROFILED = 2


def run(args, rank: int, size: int) -> dict:
    """`args.steps` steps on this rank's rows; the results of rank 0."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.parallel import mesh
    from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cpu = args.device == "cpu"
    dev = torch.device("cpu" if cpu else "cuda")
    kw = dict(batch_size=args.batch * size)
    if cpu:
        kw.update(width=4, crop_size=32, compute_dtype="float32")
    else:
        os.environ["HCMOCO_CONVBN_FUSE"] = "1"
    cfg = cs.make_cfg(**kw)
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    state = create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                               n_data=cs.N_DATA, steps_per_epoch=100)
    step = make_contrast_train_step(cfg, model, steps_per_epoch=100)
    batch = synthetic_contrast_batch(np.random.default_rng(0),
                                     cfg.batch_size, size=cfg.crop_size,
                                     num_joints=16, n_data=cs.N_DATA)
    batch = cs.to_device(mesh.shard_rows(batch, rank, size), dev)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    times = []
    for i in range(args.steps - PROFILED):
        t0 = time.perf_counter()
        step(state, batch, torch.Generator(dev).manual_seed(i))
        sync()
        times.append(time.perf_counter() - t0)
    mesh.STATS.update(calls=0)
    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        for i in range(PROFILED):
            step(state, batch, torch.Generator(dev).manual_seed(100 + i))
        sync()
    nccl = [] if cpu else [(n, us) for n, us in cs.device_rows(prof)
                           if "nccl" in n.lower()]
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in model.parameters()] + [state.banks.reshape(-1)])
    equal = True
    if size > 1:
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat)
        equal = all(torch.equal(p, parts[0]) for p in parts)
    med = statistics.median(times[1:])
    return dict(rank_rows=args.batch, ranks=size, median_ms=med * 1e3,
                samples_s=args.batch * size / med,
                collectives=mesh.STATS["calls"] / PROFILED,
                nccl_kernels=len(nccl) / PROFILED,
                nccl_device_ms=sum(us for _, us in nccl) / PROFILED / 1e3,
                ranks_equal=equal)


def rank_main(args) -> None:
    from hcmoco_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, size = mesh.init_distributed(device=args.device, timeout_s=300)
    try:
        out = run(args, rank, size)
        if rank == 0:
            with open(args.out, "w") as f:
                json.dump(out, f)
    finally:
        mesh.destroy()


def launch(args, ranks: int) -> dict:
    """`ranks` processes of this script, one a card, joined over
    localhost; rank 0's results."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    out = tempfile.mktemp(suffix=".json")
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(0 if args.device == "cpu" else r),
                   LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of",
             str(ranks), "--out", out, "--batch", str(args.batch),
             "--steps", str(args.steps), "--device", args.device], env=env))
    try:
        for p in procs:
            if p.wait(timeout=600) != 0:
                raise SystemExit(f"a rank failed ({p.returncode})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    return res


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank-of", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args()
    if args.rank_of:
        rank_main(args)
        return
    if args.device != "cpu":
        import chip_smoke as cs

        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"needs {args.ranks} cards, found "
                             f"{torch.cuda.device_count()}")
        print(cs.card_line())
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    one, many = launch(args, 1), launch(args, args.ranks)
    for r in (one, many):
        print(json.dumps(r))
    if not many["ranks_equal"]:
        raise SystemExit("the ranks' parameters or banks differ")
    eff = many["samples_s"] / (args.ranks * one["samples_s"])
    print(f"{args.ranks} ranks x {args.batch} rows on {args.device}: "
          f"{many['samples_s']:.2f} samples/s, one rank "
          f"{one['samples_s']:.2f}: scaling efficiency {eff:.3f}; "
          f"{many['collectives']:.0f} collectives a step, "
          f"{many['nccl_kernels']:.0f} NCCL kernels a step, "
          f"{many['nccl_device_ms']:.2f} device ms")


if __name__ == "__main__":
    main()
