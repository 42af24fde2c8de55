"""SharedMLP's grouped layer 0 in bf16 against the same module in float64
(ROADMAP.md Queue 3, F16), on a cloud placed 1-2 m from the origin with
25-125 mm neighbourhoods, as HCMoCo's depth clouds are.

The tolerance is bf16 rounding (unit roundoff 2^-8), element by
element: with the weights and features bf16 values, the f32 offsets
(exact: Sterbenz) rounded once (2^-8 of each |offset|), the features'
projected rows rounded once (2^-8 of each |f . w|) and the sum rounded
once (2^-8 of |h|, at most the sum of the terms' magnitudes), so
|h_bf16 - h_f64| <= (2^-7 + 2^-20) * (|rel| @ |W_xyz|^T + |f| @
|W_f|^T), the 2^-20 for the f32 accumulation of a few terms.

Projecting the absolute coordinates first and subtracting the center's
projection (the port's order before F16, and the JAX package's) rounds
terms 8-80 times larger than the offsets, and its worst element reads
3174 times the tolerance at radius 0.025 and 1067 at 0.125 without
features, 5.2 and 3.8 with them, where the module reads 0.86-0.93 (the
test computes that order beside the module's and asserts it fails).
That is the error that put the bf16 HRNetPN step's SA gradients as far
from float32 as an FP8 control (PERF.md).
"""

import pytest
import torch
import torch.nn.functional as F

from hcmoco_tpu_torch.models import pointnet2_model as pn
from hcmoco_tpu_torch.ops.point_ops import ball_query, group_points

TOL = 2.0 ** -7 + 2.0 ** -20


def _bf16_values(t):
    return t.to(torch.bfloat16).double()


def _cloud(g, b=2, n=2048):
    """(b, n, 3) f32: each sample a 0.2 m cube whose corner lies 1-2 m
    from the origin on every axis, signs drawn."""
    base = (1 + torch.rand((b, 1, 3), generator=g, dtype=torch.float64))
    sign = torch.where(torch.rand((b, 1, 3), generator=g) < 0.5, -1.0, 1.0)
    pts = base * sign + torch.rand((b, n, 3), generator=g,
                                   dtype=torch.float64) * 0.2
    return pts.float()


def _layer0_input(mlp, *args, **kw):
    """What layer 0's BN is handed: h's rows in f32 (f64 for f64)."""
    seen = []
    hook = mlp.layer0.bn.bn.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].detach()))
    try:
        mlp(*args, **kw)
    finally:
        hook.remove()
    return seen[0].double()


@pytest.mark.parametrize("radius,nsample", [(0.025, 16), (0.125, 32)])
@pytest.mark.parametrize("c", [0, 8], ids=["sa0", "features"])
def test_grouped_layer0_in_bf16_is_within_rounding_of_float64(radius,
                                                              nsample, c):
    g = torch.Generator().manual_seed(7)
    xyz = _cloud(g)
    centers = xyz[:, ::4].contiguous()
    gidx = ball_query(xyz, centers, radius, nsample)
    f0 = 32
    w = _bf16_values(torch.randn((f0, 3 + c, 1, 1), generator=g,
                                 dtype=torch.float64))
    feats = _bf16_values(torch.randn((xyz.shape[0], xyz.shape[1], c),
                                     generator=g, dtype=torch.float64))
    mods = {}
    for dtype in (torch.bfloat16, torch.float64):
        m = pn.SharedMLP((3 + c, f0), dtype)
        m.layer0.conv.weight.data = w.clone()
        if dtype == torch.float64:
            m.double()
        mods[dtype] = m
    table = torch.cat([xyz.double(), feats], -1)
    got = _layer0_input(mods[torch.bfloat16], table.float(), gidx=gidx,
                        center=centers)
    want = _layer0_input(mods[torch.float64], table, gidx=gidx,
                         center=centers.double())

    got, want = (t.reshape(gidx.shape + (f0,)) for t in (got, want))
    w2 = w[:, :, 0, 0]
    rel = group_points(xyz.double(), gidx) - centers.double()[:, :, None]
    assert rel.abs().amax() <= radius and rel.abs().amax() > radius / 2
    scale = rel.abs() @ w2[:, :3].abs().t()
    if c:
        scale = scale + group_points(feats.abs() @ w2[:, 3:].abs().t(), gidx)
    ratio = float(((got - want).abs() / (TOL * scale + 1e-300)).amax())
    assert ratio <= 1.0, ratio

    # the order it replaced: the table projected in bf16 with its absolute
    # coordinates, grouped, less the center's projection
    wb = w2.to(torch.bfloat16)
    cpad = F.pad(centers, (0, c)).to(torch.bfloat16)
    old = (group_points(F.linear(table.to(torch.bfloat16), wb), gidx)
           - F.linear(cpad, wb)[:, :, None]).double()
    old_ratio = float(((old - want).abs() / (TOL * scale + 1e-300)).amax())
    print(f"radius {radius} c {c}: worst error over the tolerance "
          f"{ratio:.3f}; projected first {old_ratio:.3f}")
    assert old_ratio > 2.0, old_ratio
