"""The readings that the correctness limits are set from, besides the
program's own (which every run prints): the plain reference put in the
program's place in float8 (the control), and with half of each batch
left out (a fault), each against the float32 reference, at the cell's own
sizes on the card.  The benchmark's runs do not run this.

    python3 h100_bench/control.py --workload <name> --seeds 1 2 3

prints one JSON line a seed and variant: the gaps of checks.py and the
leaf or step where each is worst.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from h100_bench import cells, checks, session  # noqa: E402

VARIANTS = {"float8_control": dict(lowp=torch.float8_e4m3fn),
            "half_batch_fault": dict(half=True)}


def readings(workload: str, seed: int, device: str = "cuda"):
    """(variant, gaps) of each variant against the float32 reference."""
    cell = cells.load_cell(ROOT, workload)
    run = cell.run
    groups = checks.leaf_groups(run)
    ref = session.reference_readings(run, seed, device)
    for name, kw in VARIANTS.items():
        rows = run["batch_size"] // 2 if kw.get("half") else None
        got = session.reference_readings(run, seed, device,
                                         lowp=kw.get("lowp"), rows=rows)
        yield name, checks.gaps(got, ref, groups)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        for name, gaps in readings(args.workload, seed):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": name, "seconds":
                              time.perf_counter() - t0,
                              "gaps": {k: [v, w] for k, (v, w) in
                                       gaps.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
