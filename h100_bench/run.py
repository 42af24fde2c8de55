"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`), its configuration, traffic and
limits are found by name (cells.py).  With --trace 0 the last line of
standard output holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from a window traced on the device (CUDA activity
only).  Each run also checks the program's first training steps against
the plain reference (checks.py) and prints every number compared beside
its limit, last on standard error and under `checks` in the line.

A cell runs in this one process on one card.  The run exits with another
code than 0, and prints no line, without a CUDA card, and when the JAX
package or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "hcmoco_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    return args


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "h100_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0].split(",")[-1].strip() \
        if out.returncode == 0 and out.stdout.strip() else "unread"


def end_to_end(cell, window) -> dict:
    values = {"samples_per_s": window.samples / window.seconds,
              "peak_mem_gib": window.peak_bytes / 2 ** 30,
              "setup_s": window.setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, window, device) -> dict:
    from h100_bench import cells, flops
    from h100_bench.context import Context

    run = cell.run
    counted = {}

    def forward_flops():
        if "n" not in counted:
            counted["n"] = flops.forward_flops(run, device)
        return counted["n"]

    ctx = Context(trace=window.trace, steps=window.steps,
                  samples=window.samples, window_s=window.seconds,
                  rows=run["batch_size"], run=run,
                  forward_flops=forward_flops)
    out = {}
    for m in cell.per_layer:
        value = cells.reader(ROOT, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from h100_bench import cells, session

    cell = cells.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA card; found none", file=sys.stderr)
        return 2
    cache_dirs()
    out = session.run_cell(ROOT, session.Args(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace)), T_START)
    window, device = out["window"], out["device"]
    metrics = (per_layer(cell, window, device) if args.trace
               else end_to_end(cell, window))
    session.say(T_START, "metrics read")
    checks = session.check(out, args.seed)
    session.say(T_START, "reference steps done")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": window.peak_bytes,
           "power_limit": power_limit()}
    line = {"correct": window.failed == 0 and all(c.ok for c in checks),
            "attempted": window.samples, "failed": window.failed,
            "metrics": metrics, "device": dev}
    if args.trace and window.trace is not None:
        dev.update(busy_s=window.busy_s, window_s=window.trace.window_s)
        line["breakdown"] = {"device_ops": window.trace.top_ops(),
                             "idle_gaps": window.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"({c.where})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
