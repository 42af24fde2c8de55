"""Semantic GCN (SemGCN) skeleton encoder in PyTorch.

Counterpart of hcmoco_tpu/models/sgcn.py, with the reference module names
(pycontrast/networks/SGCN: gconv_input.0.{gconv,bn},
gconv_layers.{i}.gconv{1,2}.{gconv,bn}, gconv_output).  Input (B, J, 2)
normalised 2D joints, output (B, J, hid_dim); all math in f32.

The bias is the reference's own, initialised uniform(-stdv, stdv).  (The
JAX module stores bias + stdv and subtracts stdv in its forward;
export/convert.py maps between the two.)

`SemGCN(nodes_group=...)` interleaves grouped non-local blocks
(GroupedNonLocal, the reference's `_GraphNonLocal`) after the input block
and after each residual block, as sem_gcn.py:68-87 builds them:
gconv_input.1 and gconv_layers.{1, 3, ...} (the residual blocks then sit
at gconv_layers.{0, 2, ...}), each holding its GraphNonLocal as
`non_local` (g, theta, phi, concat_project, W, the reference's
graph_non_local.py names).  With nodes_group=None (every shipped recipe)
the module tree and state-dict keys are the plain SemGCN's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.batchnorm import GlobalBatchNorm1d

# parent lists (skeleton_meta.py:3-23)
SKELETON_PARENTS = {
    "mpii": [1, 2, 6, 6, 3, 4, -1, 6, 7, 8, 11, 12, 8, 8, 13, 14],
    "coco_reduce": [1, 2, 9, 10, 3, 4, -1, 8, 9, 6, 6, 10, 11],
}

# flax momentum 0.9 (sgcn.py GraphConvBlock) == torch momentum 0.1
BN_MOMENTUM = 0.1


def skeleton_adjacency(name: str) -> np.ndarray:
    """Dense normalised adjacency from a parent list (graph_utils.py:42-45):
    symmetrise the child->parent edges, add self-loops, row-normalise."""
    parents = SKELETON_PARENTS[name]
    j = len(parents)
    a = np.zeros((j, j), dtype=np.float32)
    for child, parent in enumerate(parents):
        if parent >= 0:
            a[child, parent] = 1.0
    a = np.maximum(a, a.T) + np.eye(j, dtype=np.float32)
    return (a / a.sum(axis=1, keepdims=True)).astype(np.float32)


class SemGraphConv(nn.Module):
    """Semantic graph conv (sem_graph_conv.py:9-51).

    out = (A_sm * I) @ (x W0) + (A_sm * (1-I)) @ (x W1) + b, where A_sm is
    a row softmax over learned edge logits placed at the adjacency's
    nonzeros (row-major order).
    """

    def __init__(self, in_features: int, out_features: int, adj: np.ndarray,
                 bias: bool = True):
        super().__init__()
        mask = torch.as_tensor(adj > 0)
        self.register_buffer("mask", mask, persistent=False)
        self.register_buffer("eye", torch.eye(adj.shape[0]),
                             persistent=False)
        self.W = nn.Parameter(torch.empty(2, in_features, out_features))
        nn.init.xavier_uniform_(self.W, gain=1.414)
        self.e = nn.Parameter(torch.ones(1, int(mask.sum())))
        if bias:
            stdv = 1.0 / math.sqrt(out_features)
            self.bias = nn.Parameter(
                torch.empty(out_features).uniform_(-stdv, stdv))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        h0 = x @ self.W[0]
        h1 = x @ self.W[1]
        logits = torch.full(self.mask.shape, -9e15, device=x.device)
        logits = logits.masked_scatter(self.mask, self.e.view(-1))
        a = F.softmax(logits, dim=1)
        out = (a * self.eye) @ h0 + (a * (1.0 - self.eye)) @ h1
        if self.bias is not None:
            out = out + self.bias
        return out


class GraphConvBlock(nn.Module):
    """SemGraphConv + BatchNorm1d + ReLU (_GraphConv, sem_gcn.py:8-28)."""

    def __init__(self, in_features: int, out_features: int, adj: np.ndarray):
        super().__init__()
        self.gconv = SemGraphConv(in_features, out_features, adj)
        self.bn = GlobalBatchNorm1d(out_features, momentum=BN_MOMENTUM)

    def forward(self, x):
        x = self.gconv(x)
        x = self.bn(x.transpose(1, 2)).transpose(1, 2)
        return F.relu(x)


class ResGraphConv(nn.Module):
    """Two GraphConvBlocks with a residual (sem_gcn.py:31-43)."""

    def __init__(self, hid_dim: int, adj: np.ndarray):
        super().__init__()
        self.gconv1 = GraphConvBlock(hid_dim, hid_dim, adj)
        self.gconv2 = GraphConvBlock(hid_dim, hid_dim, adj)

    def forward(self, x):
        return x + self.gconv2(self.gconv1(x))


def _conv1d(cin: int, cout: int) -> nn.Conv1d:
    """A 1x1 Conv1d, kaiming-normal weight and zero bias (the JAX block's
    Dense init)."""
    conv = nn.Conv1d(cin, cout, 1)
    nn.init.kaiming_normal_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class GraphNonLocal(nn.Module):
    """1-D non-local block with the concatenation pairwise function
    (graph_non_local.py:7-113, `_NonLocalBlock` with dimension 1), on
    channels-last (B, J, C) joints as the JAX package's GraphNonLocal.

    g, theta and phi are the reference's 1x1 Conv1ds (C -> ic, ic = C // 2
    by default); with sub_sample > 1, g and phi are followed by a
    MaxPool1d(sub_sample) over the joints (stride = kernel, truncating),
    `g.0` / `phi.0` in the reference's Sequentials.  concat_project (a
    bias-free (2ic -> 1) conv + ReLU) factorises as f[b, i, k] =
    relu(theta[b, i] . w_t + phi[b, k] . w_p), so the (B, 2ic, J, J')
    concatenation is never built; f / J' weights g.  W is a 1x1 conv
    (ic -> C) + BN whose scale starts at zero (bn_layer), or one zero-init
    conv, so the block is the identity at init.  All math in f32 (float64
    for a float64 input)."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 sub_sample: int = 1, bn_layer: bool = True):
        super().__init__()
        ic = inter_channels or in_channels // 2
        assert ic > 0
        self.inter_channels, self.sub_sample = ic, sub_sample
        self.g = _conv1d(in_channels, ic)
        self.theta = _conv1d(in_channels, ic)
        self.phi = _conv1d(in_channels, ic)
        if sub_sample > 1:
            self.g = nn.Sequential(self.g, nn.MaxPool1d(sub_sample))
            self.phi = nn.Sequential(self.phi, nn.MaxPool1d(sub_sample))
        cp = nn.Conv2d(2 * ic, 1, 1, bias=False)
        nn.init.kaiming_normal_(cp.weight)
        self.concat_project = nn.Sequential(cp, nn.ReLU())
        if bn_layer:
            bn = GlobalBatchNorm1d(in_channels, momentum=BN_MOMENTUM)
            nn.init.zeros_(bn.weight)
            self.W = nn.Sequential(_conv1d(ic, in_channels), bn)
        else:
            self.W = nn.Conv1d(ic, in_channels, 1)
            nn.init.zeros_(self.W.weight)
            nn.init.zeros_(self.W.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        xc = x.transpose(1, 2)                      # (B, C, J)
        g = self.g(xc)                              # (B, ic, J')
        theta = self.theta(xc)                      # (B, ic, J)
        phi = self.phi(xc)                          # (B, ic, J')
        ic = self.inter_channels
        w = self.concat_project[0].weight.view(2 * ic)
        ft = torch.einsum("bcj,c->bj", theta, w[:ic])
        fp = torch.einsum("bck,c->bk", phi, w[ic:])
        f = F.relu(ft[:, :, None] + fp[:, None, :]) / fp.shape[-1]
        y = torch.bmm(f, g.transpose(1, 2))         # (B, J, ic)
        return x + self.W(y.transpose(1, 2)).transpose(1, 2)


def group_orders(nodes_group: Sequence[Sequence[int]]
                 ) -> Tuple[List[int], List[int]]:
    """The grouped joint order of a nodes_group and the order that
    restores it (sem_gcn.py:74-81)."""
    grouped = [i for g in nodes_group for i in g]
    restored = [grouped.index(i) for i in range(len(grouped))]
    return grouped, restored


class GroupedNonLocal(nn.Module):
    """The joints permuted into group order, a GraphNonLocal sub-sampled by
    the group size, the order restored (`_GraphNonLocal`,
    sem_gcn.py:46-58)."""

    def __init__(self, hid_dim: int, nodes_group: Sequence[Sequence[int]]):
        super().__init__()
        grouped, restored = group_orders(nodes_group)
        self.register_buffer("grouped", torch.tensor(grouped),
                             persistent=False)
        self.register_buffer("restored", torch.tensor(restored),
                             persistent=False)
        self.non_local = GraphNonLocal(hid_dim,
                                       sub_sample=len(nodes_group[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.non_local(x[:, self.grouped])[:, self.restored]


class SemGCN(nn.Module):
    """Input block + num_layers residual blocks + output graph conv
    (sem_gcn.py:60-95, coords_dim = (2, hid_dim) per create_SGCN.py:13);
    with nodes_group, a GroupedNonLocal after the input block and after
    each residual block (module docstring).  No config field sets
    nodes_group, as in the JAX package: every shipped recipe passes
    None."""

    def __init__(self, hid_dim: int = 128, num_layers: int = 4,
                 skeleton: str = "mpii",
                 nodes_group: Optional[Sequence[Sequence[int]]] = None):
        super().__init__()
        adj = skeleton_adjacency(skeleton)
        grouped = nodes_group is not None
        assert not grouped or len(nodes_group[0]) > 1  # sem_gcn.py:71-72
        inputs = [GraphConvBlock(2, hid_dim, adj)]
        if grouped:
            inputs.append(GroupedNonLocal(hid_dim, nodes_group))
        layers = []
        for _ in range(num_layers):
            layers.append(ResGraphConv(hid_dim, adj))
            if grouped:
                layers.append(GroupedNonLocal(hid_dim, nodes_group))
        self.gconv_input = nn.Sequential(*inputs)
        self.gconv_layers = nn.Sequential(*layers)
        self.gconv_output = SemGraphConv(hid_dim, hid_dim, adj)

    def forward(self, joints2d: torch.Tensor) -> torch.Tensor:
        x = self.gconv_input(joints2d.float())
        return self.gconv_output(self.gconv_layers(x))
