"""The port's point kernels in a traced window, and the least time of
one training step's point work at a cell's shapes.

The kernels are those of the port's csrc/fps.cu, ball_query.cu,
three_nn.cu and point_gather.cu: FPS (K2), ball query (K3), three-NN
(K4), the row gather and its interpolation's forwards (K5, K6), and the
backwards' destination index (K56a, `csr_*`) and ordered segment sum
(K56b, `segsum_*`), matched by their names, mangled or not.

The step's work is HRNetPN's PointNet++ MSG (reference/archs/HRNetPN.py)
on `pn_num_points` points a cloud, `rows` clouds a step, counted with
roofline.py's formulas:
  - each SA level but the first (whose centers are every point, in
    order) samples its centers by FPS;
  - each SA scale queries its ball and gathers its neighbours'
    coordinates (4-wide f32 rows, forward only) and, where the level has
    input features, the features' projected rows (layer 0's width, in
    the compute dtype), forward and backward;
  - each FP level finds three neighbours and interpolates the known
    features onto its unknown points, forward and backward.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from . import roofline
from .reference.archs import HRNetPN as pn

KERNEL = re.compile(r"(?<![A-Za-z_])(fps_kernel|ball_query_kernel|"
                    r"three_nn_kernel|group_fwd_kernel|interp_fwd_kernel|"
                    r"csr_[A-Za-z0-9]+_kernel|segsum_[A-Za-z0-9]+_kernel)")


def is_point_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None


def levels(n_points: int) -> List[Tuple[int, int]]:
    """(points in, centers out) of each SA level."""
    out, n = [], n_points
    for k in range(4):
        m = max(n_points // 4 ** k, 1)
        out.append((n, m))
        n = m
    return out


def step_s(run: dict, rows: int) -> float:
    """The least time of one step's point work: `rows` clouds of the
    cell's `pn_num_points`, the MLPs in its compute dtype."""
    b = rows
    elt = 2 if run["compute_dtype"] == "bfloat16" else 4
    sa = levels(run["pn_num_points"])
    total = 0.0
    for k, (n, m) in enumerate(sa):
        if m != n:
            total += roofline.k2_s(b, n, m)
        for s, widths in zip(pn.NSAMPLE[k], pn.MLPS[k]):
            total += roofline.k3_s(b, n, m, s)
            total += roofline.k5_s(b, n, m, s, 4, 4)[0]
            if k > 0:
                total += sum(roofline.k5_s(b, n, m, s, widths[0], elt))
    widths = [sum(w[-1] for w in pn.MLPS[3])] + [pn.FP_MLPS[i + 1][-1]
                                                 for i in (2, 1, 0)]
    for i, c in zip((3, 2, 1, 0), widths):
        unknown, known = sa[i][0], sa[i][1]
        total += roofline.k4_s(b, unknown, known)
        total += sum(roofline.k6_s(b, unknown, known, c, elt))
    return total
