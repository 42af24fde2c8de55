"""One run of a cell: set-up, the measured window, and the check against
the plain reference.

Set-up builds the program's model, train state and step once, loads the
benchmark's weights and banks into them, puts the pool of batches on the
card, and drives that same state through three steps of the window's own
call on three distinct batches: they warm every shape up and are the
steps the reference follows.  From them the program's readings are
taken: each step's loss, every parameter's first gradient as SGD got it
(its momentum buffer after step 1 less the weight decay of the initial
weights), and every parameter's, BN statistic's and bank's change over
the three steps.  The window then runs a fixed number of further steps,
enough to last `seconds`, cycling through the pool; nothing the program
builds is built inside it.  Once it has closed and the peak memory has
been read, the program's state is freed and the reference runs over
the batches of the three steps.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import cells, checks, devtrace, traffic, weights
from .reference import models, step as ref_step

FIRST_STEPS = 3


@dataclass
class Args:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclass
class Window:
    steps: int
    samples: int
    seconds: float
    setup_s: float
    peak_bytes: int
    failed: int
    trace: Optional[devtrace.Trace] = None
    # seconds in which an operation ran on the card
    busy_s: Optional[float] = None
    readings: Dict = field(default_factory=dict)


def say(t_start: float, msg: str) -> None:
    """A progress line on standard error, seconds since the start."""
    print(f"[h100_bench +{time.perf_counter() - t_start:.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(run: dict):
    """The program's TrainConfig: the recipe with the cell's fields."""
    import dataclasses

    from hcmoco_tpu_torch.core.config import RECIPES, TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    base = RECIPES[run["recipe"]]
    return dataclasses.replace(base, **{k: v for k, v in run.items()
                                        if k in fields})


def program_readings(model, state, p0: Dict[str, torch.Tensor],
                     banks0: torch.Tensor,
                     first_grads: Dict[str, float]) -> Dict:
    """The program's readings after its first steps, against its initial
    weights `p0` and banks `banks0` (the loss is added by the caller)."""
    def norm(t: torch.Tensor) -> float:
        return float(t.double().norm())

    params = dict(model.named_parameters())
    moved = {k: norm(b.detach() - p0[k])
             for k, b in ref_step.bn_statistics(model).items()}
    for i in range(banks0.shape[0]):
        moved[f"bank{i}"] = norm(state.banks[i] - banks0[i])
    return {"grad": first_grads,
            "change": {k: norm(p.detach() - p0[k])
                       for k, p in params.items()},
            "state": moved}


def first_gradients(model, optimizer, p0, wd: float) -> Dict[str, float]:
    """Each parameter's gradient as SGD got it in step 1: its momentum
    buffer less the weight decay of its initial value (0 if SGD kept no
    buffer)."""
    out = {}
    for k, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        out[k] = 0.0 if buf is None else float(
            (buf - wd * p0[k]).double().norm())
    return out


def make_pool(run: dict, seed: int, device) -> List[Dict]:
    """The cell's pool of batches, with the fields its architecture
    reads."""
    return traffic.make_pool(run, seed, device,
                             models.arch(run["arch"]).FIELDS)


@dataclass
class Program:
    """The program's model, train state and timed call after its first
    steps, the pool it cycles through, and its readings."""
    model: torch.nn.Module
    state: object
    step: object
    pool: List[Dict]
    readings: Dict
    last_step_s: float


def start_program(run: dict, seed: int, device,
                  log=lambda msg: None) -> Program:
    """Build the program for `run` from the seed's weights, banks and
    batches, and drive it through its first steps."""
    from hcmoco_tpu_torch.models.build import build_model
    from hcmoco_tpu_torch.train import contrast_step
    from hcmoco_tpu_torch.train.state import create_train_state

    cfg = train_config(run)
    spe = ref_step.steps_per_epoch(run)
    pool = make_pool(run, seed, device)
    log(f"pool of {len(pool)} batches on {device}")
    model = build_model(cfg, device=device).to(
        memory_format=torch.channels_last)
    init = weights.make_state(run, seed, device)
    model.load_state_dict(init, strict=True)
    state = create_train_state(cfg, model,
                               torch.Generator(device).manual_seed(0),
                               n_data=run["n_data"], steps_per_epoch=spe)
    banks0 = weights.make_banks(run, seed, device)
    state.banks.copy_(banks0)
    # made again from the seed for the readings: a bank of the real
    # dataset's rows is too large to keep a copy beside the first steps
    del banks0
    step = contrast_step.make_contrast_train_step(cfg, model,
                                                  steps_per_epoch=spe)
    losses, grads, last = [], {}, 0.0
    for i in range(FIRST_STEPS):
        t = time.perf_counter()
        m = step(state, pool[i % len(pool)], None)
        losses.append(float(m["loss"]))
        _sync(device)
        last = time.perf_counter() - t
        log(f"step {i + 1}: {last:.3f} s, loss {losses[-1]!r}")
        if i == 0:
            grads = first_gradients(model, state.optimizer, init,
                                    cfg.weight_decay)
    readings = program_readings(model, state, init,
                                weights.make_banks(run, seed, device), grads)
    readings["loss"] = losses
    return Program(model, state, step, pool, readings, last)


def run_cell(root, args: Args, t_start: float) -> dict:
    """Run the cell: set-up, the window, and the program's state freed.
    Returns the cell, the window and the device."""
    cell = cells.load_cell(root, args.workload)
    run = cell.run
    os.environ.update(cell.env)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    prog = start_program(run, args.seed, device,
                         lambda m: say(t_start, m))
    n = max(2, math.ceil(args.seconds / max(prog.last_step_s, 1e-3)))
    window = _window(prog, n, run, device, args, t_start)
    window.readings = prog.readings
    say(t_start, f"window: {n} steps in {window.seconds:.3f} s, "
        f"set-up {window.setup_s:.3f} s, peak {window.peak_bytes} bytes")
    if window.trace is not None:
        window.busy_s = window.trace.busy_s()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell, "window": window, "device": device}


def _window(prog: Program, n: int, run: dict, device, args: Args,
            t_start: float) -> Window:
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses: List[torch.Tensor] = []
    with devtrace.Tracer(args.trace and device.type == "cuda") as tracer:
        t0 = time.perf_counter()
        for i in range(n):
            tracer.span("step call")
            m = prog.step(prog.state,
                          prog.pool[(FIRST_STEPS + i) % len(prog.pool)], None)
            tracer.span("loop between step calls")
            losses.append(m["loss"])
        tracer.span("synchronize after the last step call")
        _sync(device)
        t1 = time.perf_counter()
        tracer.span(None)
    finite = torch.isfinite(torch.stack(losses).float())
    rows = run["batch_size"]
    return Window(
        steps=n, samples=n * rows, seconds=t1 - t0,
        setup_s=t0 - t_start,
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0),
        failed=int((~finite).sum()) * rows,
        trace=tracer.trace(t1 - t0))


def reference_readings(run: dict, seed: int, device,
                       lowp: Optional[torch.dtype] = None,
                       rows: Optional[int] = None) -> Dict:
    """The plain reference's readings over the first steps'
    batches (the first `rows` of each, where given), float32 with TF32
    off, or its inputs and weights in `lowp` (the control)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        num = models.Numerics(lowp=lowp, checkpoint=True)
        model = models.build(run, num, device=device)
        model.load_state_dict(weights.make_state(run, seed, device))
        banks = weights.make_banks(run, seed, device)
        pool = make_pool(run, seed, device)
        batches = [{k: v[:rows] for k, v in pool[i % len(pool)].items()}
                   for i in range(FIRST_STEPS)]
        return ref_step.reference_steps(model, banks, batches, run)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def check(out: dict, seed: int) -> List[checks.Check]:
    """The check of a run against the reference."""
    cell, window = out["cell"], out["window"]
    ref = reference_readings(cell.run, seed, out["device"])
    return checks.compare(window.readings, ref, cell.limits,
                          checks.leaf_groups(cell.run))
