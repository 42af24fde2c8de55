"""The numbers that decide `correct`: the program's first training steps
against the plain reference's, from the same weights, banks and batches.

  loss_gap      the largest relative gap of a step's loss;
  grad_gap      the largest, over the layer groups, of the median gap
                between the norms of a parameter's first gradient, each
                over the larger of the reference's norm of that parameter
                and of the median one;
  grad_shift    the largest, over the groups, of the median of the same
                gaps taken with their sign: a precision that shrinks
                gradients moves it, rounding that goes either way does not;
  change_gap    grad_gap of each parameter's change over the steps;
  change_total  the gap between the norms of all the parameters' change
                taken together, over the reference's;
  bank_gap      the worst memory bank's gap between the norms of its
                change, over the reference's.

The layer groups (`leaf_groups`) are the architecture's: for HRNet each
encoder's fused 1x1 ConvBN sites and its other leaves, SemGCN, and the
heads; a point-cloud encoder's set-abstraction and feature-propagation
levels apart; so that a fault in one layer's few leaves is not outvoted
by the others.  The gaps of
norms, not the norms of the differences.  Medians within a group, not
its worst parameter: at the benchmark's random weights a few dozen BN
parameters deep in HRNet take gradients that any rounding moves by half
or more (the program in float32 with cuDNN's TF32 and the reference with
bfloat16 inputs read 0.5-1.2 there), so the worst parameter reads alike
for every precision (PERF.md gives the readings).  Parameters whose
reference gradient is under a thousandth of the median parameter's move
by rounding and weight decay alone; the gradient and change numbers
leave them out.  A cell's limits are in h100_bench/limits/<workload>.json,
each {"limit": x}.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# a reference gradient under this share of the median leaf's leaves the
# parameter out of grad_gap and change_gap
NEGLIGIBLE = 1e-3
NAMES = ("loss_gap", "grad_gap", "grad_shift", "change_gap", "change_total",
         "bank_gap")


@dataclass
class Check:
    name: str
    value: float
    limit: Optional[float]
    where: str = ""

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.limit is None or self.value <= self.limit


def _gap(p: float, r: float, floor: float) -> float:
    return (p - r) / max(r, floor, 1e-30) if math.isfinite(p) else math.inf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys) -> Dict[str, float]:
    """Each leaf's signed gap of norms, over the larger of its reference
    norm and the median leaf's (inf for a leaf the program lacks)."""
    med = statistics.median(ref[k] for k in keys)
    return {k: _gap(prog.get(k, math.inf), ref[k], med) for k in keys}


def leaf_groups(run: dict) -> Dict[str, str]:
    """Each parameter's layer group, as the cell's architecture names
    them (`groups` of h100_bench/reference/archs/<arch>.py)."""
    from .reference import models

    return models.arch(run["arch"]).groups(
        models.build(run, models.Numerics(), device="meta"))


def _by_group(g: Dict[str, float], groups: Dict[str, str]
              ) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for k, v in g.items():
        out.setdefault(groups[k], []).append(v)
    return out


def _each(med: Dict[str, float]) -> str:
    return "; by group " + ", ".join(f"{n} {v:+.3g}"
                                     for n, v in sorted(med.items()))


def _group_median_abs(g: Dict[str, float], groups: Dict[str, str]
                      ) -> Tuple[float, str]:
    """The largest of the groups' median |gap|, with its group, the
    group's worst leaf and every group's median."""
    med = {n: statistics.median(abs(v) for v in vs)
           for n, vs in _by_group(g, groups).items()}
    top = max(med, key=med.get)
    worst = max((k for k in g if groups[k] == top), key=lambda k: abs(g[k]))
    return med[top], f"{top}; worst {worst} {g[worst]:+.3g}" + _each(med)


def _group_shift(g: Dict[str, float], groups: Dict[str, str]
                 ) -> Tuple[float, str]:
    """The largest of the groups' |median signed gap|, with its group and
    every group's median."""
    med = {n: statistics.median(vs) for n, vs in _by_group(g, groups).items()}
    top = max(med, key=lambda n: abs(med[n]))
    return abs(med[top]), f"{top} {med[top]:+.3g}" + _each(med)


def _total(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    tp = math.sqrt(sum(prog.get(k, math.inf) ** 2 for k in keys))
    tr = math.sqrt(sum(ref[k] ** 2 for k in keys))
    return abs(tp - tr) / tr if math.isfinite(tp) else math.inf


def gaps(prog: Dict, ref: Dict, groups: Dict[str, str]
         ) -> Dict[str, Tuple[float, str]]:
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= NEGLIGIBLE * med]
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
             for p, r in zip(prog["loss"], ref["loss"])]
    s = max(range(len(steps)), key=lambda i: steps[i])
    grad = leaf_gaps(prog["grad"], ref["grad"], moved)
    banks = [k for k in ref["state"] if k.startswith("bank")]
    bank = {k: abs(_gap(prog["state"].get(k, math.inf), ref["state"][k],
                        0.0)) for k in banks}
    worst_bank = max(bank, key=bank.get)
    return {"loss_gap": (steps[s], f"step {s + 1}"),
            "grad_gap": _group_median_abs(grad, groups),
            "grad_shift": _group_shift(grad, groups),
            "change_gap": _group_median_abs(
                leaf_gaps(prog["change"], ref["change"], moved), groups),
            "change_total": (_total(prog["change"], ref["change"], moved),
                             ""),
            "bank_gap": (bank[worst_bank], worst_bank)}


def compare(prog: Dict, ref: Dict, limits: Dict,
            groups: Dict[str, str]) -> List[Check]:
    g = gaps(prog, ref, groups)
    return [Check(n, g[n][0], limits[n]["limit"], g[n][1]) for n in NAMES]
