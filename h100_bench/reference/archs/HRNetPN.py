"""Arch 'HRNetPN': HCMoCo with depth as a point cloud, the published
CMC3HRNetSGCNPN2SingleHead (HCMoCo's build_backbone.py:305-514): HRNet on
RGB, PointNet++ MSG (pointnet2_msg.py:22-95, with the set-abstraction
and feature-propagation modules of pointnet2_modules.py) on a cloud
back-projected from the depth map (`depth2pts`), SemGCN on the 2D
joints; each pooled, projected and L2-normalised.

Plain float32 torch, as models.py: the searches (FPS, ball query,
three-NN) are loops and masks over every pair of points, with squared
distances taken elementwise, ((dx*dx + dy*dy) + dz*dz), in float32 from
the float32 coordinates whatever the MLPs' dtype.  No search is a
matmul, so the FLOP count (flops.py) holds the MLPs, the convolutions
and the heads alone.  The shared MLPs are 1x1 convolutions over the
channels of each grouped row (F.linear on channels-last rows) with the
harness's training BN (models.BN, over every row) and ReLU; under
`Numerics.lowp` their inputs, weights and gradients are held as the
HRNet's convolutions are.  State-dict keys and shapes are the program's
HCMoCoPNModel's (`conv.weight`, `bn.bn.*` a layer), so weights.py makes
one dict for both.

Departures from the published code, each the program's too:
  - depth2pts draws its points by inverse CDF over the valid pixels from
    the batch's uniforms `pts_u`, sorted, with replacement (published:
    torch.multinomial); a sample with no valid pixel gives a cloud of
    zeros.  The cloud's third coordinate is the mean-subtracted depth.
  - SA level 0, whose npoint equals the cloud's size, takes every point
    as a center in input order; published FPS visits every point too,
    but in its own order, and picks point 0 again in place of points
    that coincide with one already picked.
  - The FPS centers of each level are sorted by index (published: FPS
    visit order), so ball query's first hits and the next level's FPS
    follow the sorted order.
  - With fewer than three known points the missing neighbours of
    three-NN weigh nothing (the smallest clouds of the tests).
The max over a group's samples is torch.max, whose gradient goes to one
sample as F.max_pool2d's does; the program's amax splits it among ties.
In float32 only coinciding points tie, and their split reaches the MLP
weights as the same sum.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import models

# pointnet2_msg.py:10-17: each SA level's radii, samples and per-scale
# MLP widths (after the 3 + C input channels), each FP level's MLP
RADIUS = ((0.025, 0.125), (0.125, 0.25), (0.25, 0.5), (0.5, 1.0))
NSAMPLE = ((16, 32), (16, 32), (16, 32), (16, 32))
MLPS = (((16, 32), (32, 64)), ((64, 128), (64, 128)),
        ((128, 256), (128, 256)), ((256, 512), (256, 512)))
FP_MLPS = ((128, 128), (256, 256), (512, 512), (512, 512))
PN_MOMENTUM = 0.1
PN_DIM = 128
# centers or unknown points a block of the pairwise searches
CHUNK = 256

# the batch fields the model reads beyond traffic.py's own
FIELDS = ("depth_mask", "grid_xy", "depth_mean", "pts_u")


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, P, 3), (B, Q, 3) -> (B, P, Q) float32 squared distances."""
    a, b = a.float()[:, :, None], b.float()[:, None]
    d = [a[..., i] - b[..., i] for i in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def fps(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Furthest point sampling, (B, N, 3) -> (B, m): point 0 first, then
    each round the first point furthest from the picked set."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    idx = torch.zeros((b, m), dtype=torch.long, device=xyz.device)
    mind = torch.full((b, n), 1e10, device=xyz.device)
    for j in range(1, m):
        last = xyz[rows, idx[:, j - 1]][:, None]
        mind = torch.minimum(mind, sq_dists(last, xyz)[:, 0])
        idx[:, j] = mind.argmax(dim=1)
    return idx


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               s: int) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, s): for each center the first s
    points (by index) with squared distance under radius^2 (rounded to
    float32 once); slots that no hit reaches take the first hit, and a
    center with none takes point 0."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=xyz.device)
    out = []
    for c0 in range(0, centers.shape[1], CHUNK):
        hit = sq_dists(centers[:, c0:c0 + CHUNK], xyz) < r2  # (B, C, N)
        # each hit's place among its center's hits
        rank = hit.cumsum(-1, dtype=torch.int32) - 1
        bi, ci, ni = (hit & (rank < s)).nonzero(as_tuple=True)
        slots = torch.full(hit.shape[:2] + (s,), -1, dtype=torch.long,
                           device=xyz.device)
        slots[bi, ci, rank[bi, ci, ni].long()] = ni
        first = slots[..., :1].clamp(min=0)
        out.append(torch.where(slots >= 0, slots, first))
    return torch.cat(out, 1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3), (B, M, 3) -> the min(3, M) smallest squared distances
    of each unknown point to the known ones, ascending, the earlier index
    first among equals, and their indices."""
    k = min(3, known.shape[1])
    d, i = [], []
    for c0 in range(0, unknown.shape[1], CHUNK):
        dc, ic = torch.sort(sq_dists(unknown[:, c0:c0 + CHUNK], known),
                            dim=-1, stable=True)
        d.append(dc[..., :k])
        i.append(ic[..., :k])
    return torch.cat(d, 1), torch.cat(i, 1)


def rows_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) gathered at idx (B, ...) -> (B, ..., C)."""
    b = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


class Layer(nn.Module):
    """One shared-MLP layer: 1x1 conv with no bias, BN over every row,
    ReLU (pytorch_utils' conv + bn.bn)."""

    def __init__(self, cin: int, cout: int, num: models.Numerics):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = nn.Sequential(OrderedDict(
            bn=models.BN(cout, PN_MOMENTUM, num)))
        self.num = [num]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        num = self.num[0]
        w = self.conv.weight
        w = w.view(w.shape[0], w.shape[1])
        y = models.lowp_out(F.linear(models.lowp(x.to(w.dtype), num),
                                     models.lowp(w, num)), num)
        return F.relu(self.bn.bn(y.reshape(-1, y.shape[-1])).view(y.shape))


def mlp(channels: Sequence[int], num: models.Numerics) -> nn.Sequential:
    return nn.Sequential(OrderedDict(
        (f"layer{j}", Layer(a, b, num))
        for j, (a, b) in enumerate(zip(channels[:-1], channels[1:]))))


class SAModuleMSG(nn.Module):
    """Set abstraction, multi-scale grouping: FPS centers, then per scale
    a ball query, the neighbours' coordinates less the center's before
    their features, the shared MLP and the max over the samples."""

    def __init__(self, npoint: int, radii, nsamples, mlps, cin: int,
                 num: models.Numerics):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.mlps = nn.ModuleList(mlp((cin + 3,) + tuple(m), num)
                                  for m in mlps)
        self.num = [num]

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        n = xyz.shape[1]
        if self.npoint == n:
            centers = xyz
        else:
            idx = torch.sort(fps(xyz, self.npoint), dim=-1).values
            centers = rows_of(xyz, idx)
        outs = []
        for net, r, s in zip(self.mlps, self.radii, self.nsamples):
            gidx = ball_query(xyz, centers, r, s)
            outs.append(models.run(self.num[0], self._scale, net, xyz,
                                   centers, gidx, feats))
        return centers, torch.cat(outs, -1)

    @staticmethod
    def _scale(net, xyz, centers, gidx, feats):
        dtype = net[0].conv.weight.dtype
        grouped = rows_of(xyz, gidx).to(dtype) - centers[:, :, None].to(dtype)
        if feats is not None:
            grouped = torch.cat([grouped, rows_of(feats, gidx).to(dtype)],
                                -1)
        return net(grouped).max(dim=2).values


class FPModule(nn.Module):
    """Feature propagation: each unknown point takes its three nearest
    known points' features weighted by 1/(d^2 + 1e-8), normalised, then
    its own features after them, and the shared MLP."""

    def __init__(self, channels: Sequence[int], num: models.Numerics):
        super().__init__()
        self.mlp = mlp(channels, num)

    def forward(self, unknown, known, unknown_feats, known_feats):
        d2, idx = three_nn(unknown, known)
        recip = 1.0 / (d2 + 1e-8)
        w = recip / recip.sum(-1, keepdim=True)
        dtype = self.mlp[0].conv.weight.dtype
        x = (rows_of(known_feats.to(dtype), idx)
             * w[..., None].to(dtype)).sum(2)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats.to(dtype)], -1)
        return self.mlp(x)


class Pointnet2MSG(nn.Module):
    """(B, N, 3) -> (B, N, 128) per-point features: four SA levels of
    N, N/4, N/16 and N/64 centers, then four FP levels back to the
    points."""

    def __init__(self, n_points: int, num: models.Numerics):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        skip, cin = [0], 0
        for k in range(4):
            self.SA_modules.append(SAModuleMSG(
                max(n_points // 4 ** k, 1), RADIUS[k], NSAMPLE[k], MLPS[k],
                cin, num))
            cin = sum(m[-1] for m in MLPS[k])
            skip.append(cin)
        self.FP_modules = nn.ModuleList(
            FPModule(((FP_MLPS[k + 1][-1] if k < 3 else cin) + skip[k],)
                     + FP_MLPS[k], num) for k in range(4))

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        l_xyz, l_feats = [xyz], [None]
        for sa in self.SA_modules:
            nx, nf = sa(l_xyz[-1], l_feats[-1])
            l_xyz.append(nx)
            l_feats.append(nf)
        for i in range(3, -1, -1):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1],
                                            l_feats[i], l_feats[i + 1])
        return l_feats[0]


def depth2pts(depth: torch.Tensor, mask: torch.Tensor, grid: torch.Tensor,
              ori_h: float, ori_w: float, mean: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """(B, H, W) mean-subtracted depth, its valid pixels, the pixel grid
    (B, H, W, 2), the original frame's size, each sample's depth mean and
    (B, n) uniforms -> (B, n, 3) float32 points: the pixels back-projected
    (x = (row - H0/2) z 0.0035, y = (W0/2 - col) z 0.0035 at the absolute
    depth z), drawn uniformly over the valid ones with replacement, in
    pixel order; zeros for a sample with no valid pixel."""
    b, h, w = depth.shape
    z = depth + mean[:, None, None]
    x = (grid[..., 0].float() - ori_h / 2.0) * z * 0.0035
    y = (ori_w / 2.0 - grid[..., 1].float()) * z * 0.0035
    pts = torch.stack([x, y, depth], -1).reshape(b, h * w, 3)
    cdf = torch.cumsum(mask.float().reshape(b, h * w), -1)
    total = cdf[:, -1]
    v = torch.sort(u.float() * total.clamp(min=1.0)[:, None], -1).values
    # the pixel where the count of valid pixels first passes v
    pick = torch.searchsorted(cdf, v, right=True).clamp(max=h * w - 1)
    return torch.where((total > 0)[:, None, None], rows_of(pts, pick), 0.0)


class HCMoCoPN(nn.Module):
    def __init__(self, width: int, n_points: int, ori: Tuple[float, float],
                 num: models.Numerics, feat_dim: int = 128,
                 gcn_dim: int = 128):
        super().__init__()
        self.encoder1 = models.HRNet(width, 3, num)
        self.encoder2 = Pointnet2MSG(n_points, num)
        self.encoder3 = models.SemGCN(gcn_dim, 4, "mpii", num)
        total = sum(models.hrnet_stages(width)[3].channels)
        self.head1 = models.head(total, feat_dim)
        self.head2 = models.head(PN_DIM, feat_dim)
        self.head3 = models.head(gcn_dim, feat_dim)
        self.ori = ori
        self.num = num

    def forward(self, batch: dict) -> torch.Tensor:
        x = batch["rgbd"].permute(0, 3, 1, 2)
        pts = depth2pts(x[:, 3], batch["depth_mask"], batch["grid_xy"],
                        *self.ori, batch["depth_mean"], batch["pts_u"])
        fm2 = self.encoder2(pts)
        fj = self.encoder3(batch["skeleton"])
        return torch.stack([
            models.project(self.head1,
                           models.pool(self.encoder1(x[:, :3]))),
            models.project(self.head2, fm2.float().mean(dim=1)),
            models.project(self.head3, fj.mean(dim=1))])


def build(run: dict, num: models.Numerics) -> nn.Module:
    return HCMoCoPN(run["width"], run["pn_num_points"],
                    (run["pn_ori_h"], run["pn_ori_w"]), num)


def groups(model: nn.Module) -> dict:
    """The RGB HRNet's fused 1x1 ConvBN sites and its other leaves,
    PointNet++'s set-abstraction levels (`encoder2.sa`) and its
    feature-propagation levels (`encoder2.fp`), SemGCN, and the heads."""
    out = models.hrnet_groups(model, ("encoder1",))
    for k in out:
        if k.startswith("encoder2."):
            out[k] = ("encoder2.sa" if k.startswith("encoder2.SA_modules.")
                      else "encoder2.fp")
    return out
