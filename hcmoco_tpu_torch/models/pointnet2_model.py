"""PointNet++ MSG encoder and the depth-as-point-cloud HCMoCo model
(counterpart of hcmoco_tpu/models/pointnet2_model.py).

Behavioural spec:
  * `Pointnet2MSG` (pycontrast/networks/pointnet2_msg.py:10-95): four
    set-abstraction levels with multi-scale grouping (npoints 4096/1024/
    256/64, two radii each, shared MLPs, max pool) and four feature
    propagation levels; per-point 128-d features out.
  * `SAModuleMSG` / `FPModule` (pointnet2/pointnet2_modules.py:58-156):
    grouped xyz are centred on their center and put before the features
    (use_xyz=True).
  * `HCMoCoPNModel` (build_backbone.py:305-514, arch 'HRNetPN'): HRNet on
    RGB, PointNet++ on a cloud back-projected from depth (`depth2pts`),
    SemGCN on 2D joints; in stage 2 the point features carried back onto
    the pixels (`pts2depth`).

Layout: points (B, N, 3), features channels-last (B, N, C).  Each shared
MLP layer is a 1x1 conv kept as the reference's Conv2d weight
(Fout, Fin, 1, 1) and applied as a matmul over the channel axis in the
compute dtype, with BN in f32 over all B*M*S (or B*N) rows; torch BN
semantics (unbiased running variance, ROADMAP.md Queue 3 F1).  FPS, ball
query and three-NN work on f32 coordinates; the grouping and the
interpolation are kernels K5 and K6 with their own backwards
(ops/point_gather.py).

The TPU package's locality windows (SA_WINDOWS, FP_WINDOWS) and its
HCMOCO_PN_*/HCMOCO_SS_*/HCMOCO_BQ_WINDOW/HCMOCO_FP_* switches are TPU
devices and are not ported: every op here is the exact one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import HRNET_CONFIGS
from ..ops.point_ops import (ball_query, furthest_point_sample, gather_points,
                             group_points, interpolation_weights,
                             three_interpolate, three_nn)
from .heads import ProjectionHead, linear_1x1
from .hrnet import HRNet, merge_all_res, nearest_resize, pool_maps
from .sgcn import SemGCN

# architecture constants (pointnet2_msg.py:10-17)
NPOINTS = (4096, 1024, 256, 64)
RADIUS = ((0.025, 0.125), (0.125, 0.25), (0.25, 0.5), (0.5, 1.0))
NSAMPLE = ((16, 32), (16, 32), (16, 32), (16, 32))
MLPS = (((16, 32), (32, 64)), ((64, 128), (64, 128)),
        ((128, 256), (128, 256)), ((256, 512), (256, 512)))
FP_MLPS = ((128, 128), (256, 256), (512, 512), (512, 512))

# flax momentum 0.9 (pointnet2_model.py SharedMLP) == torch momentum 0.1
BN_MOMENTUM = 0.1


class ConvBNReLU(nn.Module):
    """One shared-MLP layer: 1x1 conv (no bias) + BN + ReLU, with the
    reference pytorch_utils names conv / bn.bn."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = nn.Sequential(OrderedDict(
            bn=nn.BatchNorm1d(cout, momentum=BN_MOMENTUM)))

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        """The (Fout, Fin) weight in `dtype`."""
        w = self.conv.weight
        return w.reshape(w.shape[0], w.shape[1]).to(dtype)

    def bn_relu(self, h: torch.Tensor) -> torch.Tensor:
        """BN over every leading row of h (..., F) in f32 (f64 for f64),
        ReLU, h's dtype."""
        x = h.reshape(-1, h.shape[-1])
        y = self.bn.bn(x.to(torch.promote_types(x.dtype, torch.float32)))
        return F.relu(y.to(h.dtype)).reshape(h.shape)


class SharedMLP(nn.Sequential):
    """Dense + BN + ReLU layers over the channel (last) axis, as
    layer0, layer1, ...; `channels` = (Fin, F0, F1, ...).

    Project-then-group (gidx given): x is the per-point TABLE
    (B, N, Cc) = concat(xyz, feats) and the first layer's matmul commutes
    with the neighbour gather,

        W (concat(xyz[k] - center_m, feats[k]))
          = (table W^T)[k] - (concat(center_m, 0) W^T),

    so layer 0 runs on the N table rows and K5 gathers F0-wide projected
    rows (the JAX package's SharedMLP, which pins the identity in its
    tests).  BN then sees the same values as after grouping."""

    def __init__(self, channels: Sequence[int], dtype: torch.dtype):
        super().__init__(OrderedDict(
            (f"layer{j}", ConvBNReLU(cin, cout))
            for j, (cin, cout) in enumerate(zip(channels[:-1],
                                                channels[1:]))))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, gidx: Optional[torch.Tensor] = None,
                center: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        for j, layer in enumerate(self):
            w = layer.matrix(dtype)
            if j == 0 and gidx is not None:
                h = group_points(F.linear(x.to(dtype), w), gidx)
                if center is not None:
                    # the centring term concat(center, 0) W^T, per center
                    cpad = F.pad(center.float(), (0, x.shape[-1] - 3))
                    h = h - F.linear(cpad.to(dtype), w)[:, :, None, :]
            else:
                h = F.linear(x.to(dtype), w)
            x = layer.bn_relu(h)
        return x


class SAModuleMSG(nn.Module):
    """Set abstraction with multi-scale grouping: FPS centers (sorted
    ascending), then per scale a ball query, the project-then-group
    shared MLP and a max over the samples."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int, dtype: torch.dtype):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(SharedMLP((in_channels + 3,) + tuple(m),
                                            dtype) for m in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # npoint == N (SA0) takes the identity: the consumers are
        # permutation-equivariant.  Sorting the centers keeps every
        # intermediate in the JAX package's order.
        idx = furthest_point_sample(xyz, self.npoint, allow_identity=True)
        idx = torch.sort(idx, dim=-1).values
        new_xyz = gather_points(xyz, idx)  # (B, M, 3)
        if features is None:
            table = xyz.float()
        else:
            table = torch.cat([xyz.to(features.dtype), features], dim=-1)
        outs = []
        for mlp, r, s in zip(self.mlps, self.radii, self.nsamples):
            gidx = ball_query(xyz, new_xyz, r, s)
            h = mlp(table, gidx=gidx, center=new_xyz)
            outs.append(h.amax(dim=2))  # max over the samples
        return new_xyz, torch.cat(outs, dim=-1)


class FPModule(nn.Module):
    """Feature propagation: three-NN inverse-distance interpolation of the
    known features onto the unknown points, concat with the unknown
    points' own features, shared MLP."""

    def __init__(self, channels: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.mlp = SharedMLP(channels, dtype)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        dist2, idx = three_nn(unknown, known)
        weight = interpolation_weights(dist2)
        interp = three_interpolate(known_feats.contiguous(), idx, weight)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class Pointnet2MSG(nn.Module):
    """(B, N, 3[+C]) -> (B, N, 128) per-point features; the reference's
    SA_modules / FP_modules."""

    def __init__(self, input_channels: int = 0,
                 npoints: Tuple[int, ...] = NPOINTS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        skip = [input_channels]
        cin = input_channels
        for k, npoint in enumerate(npoints):
            self.SA_modules.append(SAModuleMSG(
                npoint, RADIUS[k], NSAMPLE[k], MLPS[k], cin, dtype))
            cin = sum(m[-1] for m in MLPS[k])
            skip.append(cin)
        self.FP_modules = nn.ModuleList()
        for k, mlp in enumerate(FP_MLPS):
            pre = FP_MLPS[k + 1][-1] if k + 1 < len(FP_MLPS) else cin
            self.FP_modules.append(FPModule((pre + skip[k],) + tuple(mlp),
                                            dtype))

    def forward(self, pointcloud: torch.Tensor) -> torch.Tensor:
        xyz = pointcloud[..., :3].contiguous()
        feats = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [feats]
        for k, sa in enumerate(self.SA_modules):
            nx, nf = sa(l_xyz[k], l_feats[k])
            l_xyz.append(nx)
            l_feats.append(nf)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1],
                                            l_feats[i], l_feats[i + 1])
        return l_feats[0]


def depth2pts(depth: torch.Tensor, depth_mask: torch.Tensor,
              grid_xy: torch.Tensor, ori_h: float, ori_w: float,
              mean: torch.Tensor, n_points: int = 4096,
              generator: Optional[torch.Generator] = None,
              u: Optional[torch.Tensor] = None):
    """Back-project the depth map and sample its cloud
    (build_backbone.py:379-446).

    depth (B, H, W) mean-subtracted; depth_mask (B, H, W); grid_xy
    (B, H, W, 2) original pixel coords tracked through the crop; mean (B,)
    per-sample depth mean.  The n_points samples are drawn uniformly over
    the valid pixels with replacement, by inverse CDF from uniforms in
    [0, 1): `u` (B, n_points) when given (pins the draw), else drawn from
    `generator`.  The uniforms are sorted, so the samples come out in
    raster order, as in the JAX package.  Returns (sampled (B, n, 3),
    all_pts (B, H*W, 3), sample_ind (B, n) int32, valid (B,) bool); a
    sample with no valid pixel gives all-zero points and valid False."""
    b, h, w = depth.shape
    z_abs = depth + mean[:, None, None]
    gx = grid_xy[..., 0].float()
    gy = grid_xy[..., 1].float()
    world_x = (gx - ori_h / 2.0) * z_abs * 0.0035
    world_y = (ori_w / 2.0 - gy) * z_abs * 0.0035
    pts = torch.stack([world_x, world_y, depth], dim=-1).reshape(b, h * w, 3)

    mask = depth_mask.float().reshape(b, h * w)
    valid = mask.sum(-1) > 0
    cdf = torch.cumsum(mask, dim=-1)  # steps of 1 at valid pixels
    total = cdf[:, -1]
    if u is None:
        u = torch.rand((b, n_points), generator=generator,
                       device=depth.device)
    u = torch.sort(u.float() * torch.clamp(total, min=1.0)[:, None],
                   dim=-1).values
    sample_ind = torch.searchsorted(cdf, u, right=True)
    sample_ind = torch.clamp(sample_ind, 0, h * w - 1)
    sampled = torch.gather(pts, 1, sample_ind[..., None].expand(-1, -1, 3))
    keep = valid[:, None, None]
    sampled = torch.where(keep, sampled, 0.0)
    pts = torch.where(keep, pts, 0.0)
    return sampled, pts, sample_ind.to(torch.int32), valid


def pts2depth(sampled: torch.Tensor, all_pts: torch.Tensor,
              feats: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-point features back onto the (h, w) pixel grid by three-NN
    inverse-distance interpolation (build_backbone.py:448-455): every
    pixel's point (all_pts (B, h*w, 3)) takes its three nearest sampled
    points (B, n, 3), K4, and their features (B, n, C) weighted, K6.
    Returns (B, h, w, C) in feats' dtype."""
    dist2, idx = three_nn(all_pts, sampled)
    weight = interpolation_weights(dist2)
    interp = three_interpolate(feats.contiguous(), idx, weight)
    return interp.reshape(interp.shape[0], h, w, interp.shape[-1])


class HCMoCoPNModel(nn.Module):
    """HRNet(RGB) + PointNet++(depth cloud) + SemGCN (arch 'HRNetPN'):
    rgbd (B, >=4, H, W) with RGB in channels 0-2 and the mean-subtracted
    depth in channel 3, skeleton (B, J, 2), and the depth2pts inputs ->
    dict of pooled1..3 and feat1..3.

    return_fm (stage 2) adds fm1 (HRNet's four NCHW maps), fm2 (the
    (B, n_points, 128) point features) and fm3 (SemGCN's joint features).
    With linear_feat_map also merge1 (`merge_all_res`) and linear_merge1
    (its 1x1 head, (B, 128, H/4, W/4) f32) as HCMoCoModel's, merge2 = fm2,
    and linear_merge2: encoder2_linear (Conv1d + BN + ReLU on the points,
    build_backbone.py:368) in the compute dtype, cast to f32, carried onto
    every pixel by `pts2depth` and resized to linear_merge1's size by
    nearest-exact (ROADMAP.md Queue 3, F2), as (B, 128, H/4, W/4)."""

    def __init__(self, width: int = 18, feat_dim: int = 128,
                 head: str = "linear", linear_feat_map: bool = False,
                 pool_method: str = "mean", skeleton_meta: str = "mpii",
                 sgcn_dim: int = 128, pn_dim: int = 128, n_points: int = 4096,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hr_cfg = HRNET_CONFIGS[width]
        self.pool_method = pool_method
        self.n_points = n_points
        self.linear_feat_map = linear_feat_map
        self.dtype = dtype
        npoints = tuple(max(n_points // (4 ** k), 1) for k in range(4))
        self.encoder1 = HRNet(hr_cfg, 3, dtype)
        # the MLPs run in the compute dtype; FPS, ball query and three-NN
        # stay f32 (ops/point_ops.py)
        self.encoder2 = Pointnet2MSG(npoints=npoints, dtype=dtype)
        self.encoder3 = SemGCN(sgcn_dim, 4, skeleton_meta)
        self.head1 = ProjectionHead(hr_cfg.total_channels, feat_dim, head)
        self.head2 = ProjectionHead(pn_dim, feat_dim, head)
        self.head3 = ProjectionHead(sgcn_dim, feat_dim, head)
        if linear_feat_map:
            self.encoder1_linear = nn.Conv2d(hr_cfg.total_channels, sgcn_dim,
                                             1)
            self.encoder2_linear = SharedMLP((pn_dim, sgcn_dim), dtype)

    def forward(self, rgbd: torch.Tensor, skeleton: torch.Tensor,
                depth_mask: torch.Tensor, grid_xy: torch.Tensor,
                ori_h: float, ori_w: float, mean: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None,
                return_fm: bool = False) -> Dict[str, torch.Tensor]:
        fm1 = self.encoder1(rgbd[:, :3])
        sampled, all_pts, _, _ = depth2pts(rgbd[:, 3], depth_mask, grid_xy,
                                           ori_h, ori_w, mean, self.n_points,
                                           generator, u)
        fm2 = self.encoder2(sampled)  # (B, n_points, 128)
        fj = self.encoder3(skeleton)
        out = {
            "pooled1": pool_maps(fm1, self.pool_method),
            "pooled2": fm2.float().mean(dim=1),
            "pooled3": fj.float().mean(dim=1),
        }
        out["feat1"] = self.head1(out["pooled1"])
        out["feat2"] = self.head2(out["pooled2"])
        out["feat3"] = self.head3(out["pooled3"])
        if return_fm:
            out.update(fm1=fm1, fm2=fm2, fm3=fj)
            if self.linear_feat_map:
                out["merge1"] = merge_all_res(fm1)
                lm1 = linear_1x1(self.encoder1_linear, out["merge1"],
                                 self.dtype)
                lm2 = self.encoder2_linear(fm2).float()
                h, w = rgbd.shape[2], rgbd.shape[3]
                lm2 = pts2depth(sampled, all_pts, lm2, h, w)
                # (B, h, w, C) -> NCHW view, resized to lm1's size
                lm2 = nearest_resize(lm2.permute(0, 3, 1, 2), *lm1.shape[2:])
                out.update(merge2=fm2, linear_merge1=lm1, linear_merge2=lm2)
        return out
