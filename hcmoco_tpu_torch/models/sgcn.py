"""Semantic GCN (SemGCN) skeleton encoder in PyTorch.

Counterpart of hcmoco_tpu/models/sgcn.py, with the reference module names
(pycontrast/networks/SGCN: gconv_input.0.{gconv,bn},
gconv_layers.{i}.gconv{1,2}.{gconv,bn}, gconv_output).  Input (B, J, 2)
normalised 2D joints, output (B, J, hid_dim); all math in f32.

The bias is the reference's own, initialised uniform(-stdv, stdv).  (The
JAX module stores bias + stdv and subtracts stdv in its forward;
export/convert.py maps between the two.)
"""

from __future__ import annotations

import math

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


class SemGCN(nn.Module):
    """Input block + num_layers residual blocks + output graph conv
    (sem_gcn.py:60-95, coords_dim = (2, hid_dim) per create_SGCN.py:13).
    The reference's optional non-local blocks (nodes_group) are not
    ported: every shipped recipe passes nodes_group=None."""

    def __init__(self, hid_dim: int = 128, num_layers: int = 4,
                 skeleton: str = "mpii"):
        super().__init__()
        adj = skeleton_adjacency(skeleton)
        self.gconv_input = nn.Sequential(GraphConvBlock(2, hid_dim, adj))
        self.gconv_layers = nn.Sequential(
            *(ResGraphConv(hid_dim, adj) for _ in range(num_layers)))
        self.gconv_output = SemGraphConv(hid_dim, hid_dim, adj)

    def forward(self, joints2d: torch.Tensor) -> torch.Tensor:
        x = self.gconv_input(joints2d.float())
        return self.gconv_output(self.gconv_layers(x))
