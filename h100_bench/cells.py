"""A cell found by name: its entry in BENCHMARK.json, its configuration
file, its traffic file (h100_bench/traffic/<traffic>.json), its
correctness limits (h100_bench/limits/<workload>.json), the reference of
its architecture (h100_bench/reference/archs/<arch>.py) and the metrics
it reports.  A new configuration, traffic mix, architecture, metric or
cell is new files and new entries: nothing here names one.

A configuration file holds the recipe as run: `train` has the program's
TrainConfig fields that the cell sets (its `arch` names the reference
file; every size the reference reads, such as a point cloud's
`pn_num_points` and `pn_ori_h`/`pn_ori_w`, is stated here), besides
`source`, `reduced`, `assumed` and `env` (the environment the program
reads when it builds the model).  A traffic file holds how the batch is
fed: its `batch_size` and `pn_num_points` (the points a cloud), which
override the configuration's, `pool` (distinct batches made before the
window and cycled through it) and `depth_ratio` (the share of samples
with depth).  An architecture's file holds its plain reference model,
its layer groups for the check, and the batch fields it reads beyond
traffic.py's own (traffic.py says which fields it makes).  The harness
runs a cell in one process on one card.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from .reference import models

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TRAFFIC_KEYS = {"batch_size", "pool", "depth_ratio", "pn_num_points"}


class CellError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be found or
    read, named in the message."""


def _read(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def run(self) -> dict:
        """The TrainConfig fields and feeding of this cell, in one dict."""
        out = dict(self.config["train"])
        out.update(self.traffic)
        return out

    @property
    def env(self) -> Dict[str, str]:
        """What the program reads from the environment when it builds."""
        return dict(self.config.get("env", {}))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, with its files."""
    root = Path(root)
    bench = _read(root / "BENCHMARK.json", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"workload {workload!r}: not in BENCHMARK.json "
                        f"(has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise CellError(f"configuration {w['config']!r} of {workload}: not "
                        "in BENCHMARK.json")
    for name in (w["name"], w["config"], w["traffic"]):
        if not NAME.match(name):
            raise CellError(f"name {name!r}: not a benchmark name")
    if w["chips"] != 1:
        raise CellError(f"{workload}: {w['chips']} chips; the harness runs "
                        "a cell on one card")
    config = _read(root / configs[w["config"]]["file"],
                   f"configuration {w['config']!r}")
    arch = config["train"]["arch"]
    try:
        models.arch(arch)
    except ValueError as e:
        raise CellError(f"arch {arch!r} of configuration {w['config']!r}: "
                        f"{e}") from None
    traffic = _read(root / "h100_bench" / "traffic" / f"{w['traffic']}.json",
                    f"traffic {w['traffic']!r}")
    extra = set(traffic) - TRAFFIC_KEYS
    if extra:
        raise CellError(f"traffic {w['traffic']!r}: unknown keys "
                        f"{sorted(extra)}")
    limits = _read(root / "h100_bench" / "limits" / f"{workload}.json",
                   f"limits of {workload!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reports(m, workload)]
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def reader(root: Path, metric: str):
    """The `read(ctx)` of h100_bench/metrics/<metric>.py."""
    import importlib.util

    path = Path(root) / "h100_bench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise CellError(f"metric {metric!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
