"""Plain PyTorch reference of the benchmarked HCMoCo models: the parts
they share, and each architecture found by name (`build`, `arch`).

Written against the published architecture (HCMoCo's
`build_backbone.py`, HRNetV2's `official_hrnet.py`, SemGCN), float32
throughout, with no kernel, no fused path and no import of the program
under test.  Module and parameter names follow the published
torch modules, which the program keeps too, so one state dict made by the
benchmark loads into both.  An architecture (TrainConfig's `arch`) is a
file of its own, h100_bench/reference/archs/<arch>.py, that puts these
parts together: a new one is a new file, and nothing here names it.

`Numerics` carries what the benchmark varies: `lowp`, a low precision
for every convolution (each tensor scaled to its range): float8 reads the inputs and weights as e4m3 and the gradient that
comes back into the output as e5m2, the usual hybrid of FP8 training, and
is the lower-precision control of the correctness check; `update_stats`,
which a recomputed region turns off so that BN running statistics move
once; and `checkpoint`, which recomputes each block in the backward so
that a batch of 224 at 320x320 fits one card in float32.
"""

from __future__ import annotations

import importlib
import re
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class Numerics:
    def __init__(self, lowp: Optional[torch.dtype] = None,
                 checkpoint: bool = True):
        self.lowp = lowp
        self.update_stats = True
        self.checkpoint = checkpoint


# the dtype of the gradient that comes back into a low-precision product
GRAD_DTYPE = {torch.float8_e4m3fn: torch.float8_e5m2}


def _held(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as `dtype` holds it, scaled to its range (no gradient)."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradIn(torch.autograd.Function):
    """The identity, whose backward holds the gradient in a low dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _held(g, ctx.dtype), None


def lowp(x: torch.Tensor, num: Numerics) -> torch.Tensor:
    """An input of a product as `num.lowp` holds it (straight through in
    the backward), or x itself."""
    if num.lowp is None:
        return x
    return x + (_held(x.detach(), num.lowp) - x.detach())


def lowp_out(y: torch.Tensor, num: Numerics) -> torch.Tensor:
    """A product's output, whose gradient comes back in the low dtype."""
    if num.lowp is None:
        return y
    return _GradIn.apply(y, GRAD_DTYPE.get(num.lowp, num.lowp))


def run(num: Numerics, fn, *args):
    """fn(*args), recomputed in the backward when checkpointing."""
    if num.checkpoint and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class BN(nn.Module):
    """Training batch norm over every dim but 1: biased batch variance to
    normalise, the unbiased one into the running variance (torch's
    semantics), parameters and buffers under nn.BatchNorm's names."""

    def __init__(self, c: int, momentum: float, num: Numerics,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.momentum, self.eps = momentum, eps
        self.num = [num]  # a list: not a submodule

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
        if self.num[0].update_stats:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * n / (n - 1), alpha=m)
                self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)


def conv(c: nn.Conv2d, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    x = x.to(c.weight.dtype)
    return lowp_out(F.conv2d(lowp(x, num), lowp(c.weight, num), c.bias,
                             c.stride, c.padding, c.dilation, c.groups), num)


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


# ---- HRNetV2 -----------------------------------------------------------


@dataclass(frozen=True)
class Stage:
    modules: int
    branches: int
    block: str
    blocks: tuple
    channels: tuple


def hrnet_stages(width: int) -> tuple:
    """Stages 1-4 of HRNetV2-W<width> (the seg YAMLs); width 4 is a
    one-module, one-block test size of the same structure."""
    if width == 4:
        return (Stage(1, 1, "BOTTLENECK", (1,), (8,)),
                Stage(1, 2, "BASIC", (1, 1), (4, 8)),
                Stage(1, 3, "BASIC", (1, 1, 1), (4, 8, 16)),
                Stage(1, 4, "BASIC", (1, 1, 1, 1), (4, 8, 16, 32)))
    c = (width, 2 * width, 4 * width, 8 * width)
    return (Stage(1, 1, "BOTTLENECK", (4,), (64,)),
            Stage(1, 2, "BASIC", (4, 4), c[:2]),
            Stage(4, 3, "BASIC", (4, 4, 4), c[:3]),
            Stage(3, 4, "BASIC", (4, 4, 4, 4), c))


HR_MOMENTUM = 0.01


def _c(cin: int, cout: int, k: int, s: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, s, k // 2, bias=False)


class ConvBN(nn.Sequential):
    def __init__(self, cin, cout, k, s, relu, num):
        super().__init__(_c(cin, cout, k, s), BN(cout, HR_MOMENTUM, num))
        self.relu, self.num = relu, [num]

    def forward(self, x):
        y = self[1](conv(self[0], x, self.num[0]))
        return F.relu(y) if self.relu else y


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, down, num):
        super().__init__()
        self.conv1, self.bn1 = _c(cin, planes, 3, 1), BN(planes,
                                                        HR_MOMENTUM, num)
        self.conv2, self.bn2 = _c(planes, planes, 3, 1), BN(planes,
                                                           HR_MOMENTUM, num)
        self.downsample = ConvBN(cin, planes, 1, 1, False, num) if down \
            else None
        self.num = [num]

    def forward(self, x):
        return run(self.num[0], self._f, x)

    def _f(self, x):
        n = self.num[0]
        y = F.relu(self.bn1(conv(self.conv1, x, n)))
        y = self.bn2(conv(self.conv2, y, n))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, down, num):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = _c(cin, planes, 1, 1), BN(planes,
                                                        HR_MOMENTUM, num)
        self.conv2, self.bn2 = _c(planes, planes, 3, 1), BN(planes,
                                                           HR_MOMENTUM, num)
        self.conv3, self.bn3 = _c(planes, out, 1, 1), BN(out, HR_MOMENTUM,
                                                         num)
        self.downsample = ConvBN(cin, out, 1, 1, False, num) if down \
            else None
        self.num = [num]

    def forward(self, x):
        return run(self.num[0], self._f, x)

    def _f(self, x):
        n = self.num[0]
        y = F.relu(self.bn1(conv(self.conv1, x, n)))
        y = F.relu(self.bn2(conv(self.conv2, y, n)))
        y = self.bn3(conv(self.conv3, y, n))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


_BLOCKS = {"BASIC": Basic, "BOTTLENECK": Bottleneck}


def _blocks(name, cin, planes, n, num):
    blk = _BLOCKS[name]
    out = planes * blk.expansion
    return nn.Sequential(*(blk(cin if b == 0 else out, planes,
                               b == 0 and cin != out, num)
                           for b in range(n)))


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class HRModule(nn.Module):
    def __init__(self, st: Stage, cins: Sequence[int], num: Numerics):
        super().__init__()
        exp = _BLOCKS[st.block].expansion
        out = [c * exp for c in st.channels]
        self.branches = nn.ModuleList(
            _blocks(st.block, cins[i], st.channels[i], st.blocks[i], num)
            for i in range(st.branches))
        self.fuse_layers = None
        if st.branches > 1:
            rows = []
            for i in range(st.branches):
                row = []
                for j in range(st.branches):
                    if j > i:
                        row.append(ConvBN(out[j], out[i], 1, 1, False, num))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.Sequential(*(
                            ConvBN(out[j], out[i] if k == i - j - 1
                                   else out[j], 3, 2, k != i - j - 1, num)
                            for k in range(i - j))))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)
        self.num = [num]

    def forward(self, xs):
        ys = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        return [run(self.num[0], self._fuse, i, *ys)
                for i in range(len(self.fuse_layers))]

    def _fuse(self, i, *ys):
        h, w = ys[i].shape[2:]
        acc = ys[i]
        for j, layer in enumerate(self.fuse_layers[i]):
            if j > i:
                acc = acc + resize(layer(ys[j]), h, w)
            elif j < i:
                acc = acc + layer(ys[j])
        return F.relu(acc)


class HRNet(nn.Module):
    def __init__(self, width: int, cin: int, num: Numerics):
        super().__init__()
        st = hrnet_stages(width)
        self.conv1, self.bn1 = _c(cin, 64, 3, 2), BN(64, HR_MOMENTUM, num)
        self.conv2, self.bn2 = _c(64, 64, 3, 2), BN(64, HR_MOMENTUM, num)
        self.layer1 = _blocks(st[0].block, 64, st[0].channels[0],
                              st[0].blocks[0], num)
        pre = [st[0].channels[0] * _BLOCKS[st[0].block].expansion]
        for si, spec in zip((2, 3, 4), st[1:]):
            cur = [c * _BLOCKS[spec.block].expansion for c in spec.channels]
            trans = []
            for i in range(spec.branches):
                if i < len(pre):
                    trans.append(ConvBN(pre[i], cur[i], 3, 1, True, num)
                                 if pre[i] != cur[i] else None)
                else:
                    trans.append(nn.Sequential(*(
                        ConvBN(pre[-1], cur[i] if j == i - len(pre)
                               else pre[-1], 3, 2, True, num)
                        for j in range(i + 1 - len(pre)))))
            setattr(self, f"transition{si - 1}", nn.ModuleList(trans))
            setattr(self, f"stage{si}", nn.Sequential(*(
                HRModule(spec, cur, num) for _ in range(spec.modules))))
            pre = cur
        self.num = [num]

    def forward(self, x):
        xs = [self.layer1(run(self.num[0], self._stem, x))]
        for si in (2, 3, 4):
            new = []
            for i, t in enumerate(getattr(self, f"transition{si - 1}")):
                src = xs[i] if i < len(xs) else xs[-1]
                new.append(src if t is None else t(src))
            xs = getattr(self, f"stage{si}")(new)
        return xs

    def _stem(self, x):
        n = self.num[0]
        x = F.relu(self.bn1(conv(self.conv1, x, n)))
        return F.relu(self.bn2(conv(self.conv2, x, n)))


def pool(maps: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([m.mean(dim=(2, 3)) for m in maps], dim=-1)


# ---- SemGCN ------------------------------------------------------------

SKELETON_PARENTS = {
    "mpii": [1, 2, 6, 6, 3, 4, -1, 6, 7, 8, 11, 12, 8, 8, 13, 14],
}
GCN_MOMENTUM = 0.1


def adjacency(name: str) -> np.ndarray:
    """Child-parent edges made symmetric, self-loops, rows normalised."""
    parents = SKELETON_PARENTS[name]
    a = np.eye(len(parents), dtype=np.float32)
    for child, parent in enumerate(parents):
        if parent >= 0:
            a[child, parent] = a[parent, child] = 1.0
    return a / a.sum(axis=1, keepdims=True)


class SemGraphConv(nn.Module):
    """out = (A*I) @ x W0 + (A*(1-I)) @ x W1 + b, A the row softmax of
    learned edge weights on the adjacency's nonzeros."""

    def __init__(self, cin: int, cout: int, adj: np.ndarray):
        super().__init__()
        self.register_buffer("mask", torch.as_tensor(adj > 0),
                             persistent=False)
        self.W = nn.Parameter(torch.zeros(2, cin, cout))
        self.e = nn.Parameter(torch.ones(1, int((adj > 0).sum())))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x = x.to(self.W.dtype)
        j = self.mask.shape[0]
        logits = torch.full((j, j), -9e15, device=x.device, dtype=x.dtype)
        logits = logits.masked_scatter(self.mask, self.e.view(-1))
        a = F.softmax(logits, dim=1)
        eye = torch.eye(j, device=x.device, dtype=x.dtype)
        return (a * eye) @ (x @ self.W[0]) \
            + (a * (1 - eye)) @ (x @ self.W[1]) + self.bias


class GraphBlock(nn.Module):
    def __init__(self, cin, cout, adj, num):
        super().__init__()
        self.gconv = SemGraphConv(cin, cout, adj)
        self.bn = BN(cout, GCN_MOMENTUM, num)

    def forward(self, x):
        return F.relu(self.bn(self.gconv(x).transpose(1, 2)).transpose(1, 2))


class ResGraph(nn.Module):
    def __init__(self, dim, adj, num):
        super().__init__()
        self.gconv1 = GraphBlock(dim, dim, adj, num)
        self.gconv2 = GraphBlock(dim, dim, adj, num)

    def forward(self, x):
        return x + self.gconv2(self.gconv1(x))


class SemGCN(nn.Module):
    def __init__(self, dim: int, layers: int, skeleton: str, num: Numerics):
        super().__init__()
        adj = adjacency(skeleton)
        self.gconv_input = nn.Sequential(GraphBlock(2, dim, adj, num))
        self.gconv_layers = nn.Sequential(*(ResGraph(dim, adj, num)
                                            for _ in range(layers)))
        self.gconv_output = SemGraphConv(dim, dim, adj)

    def forward(self, j):
        return self.gconv_output(self.gconv_layers(self.gconv_input(j)))


def head(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cin, cout))


def project(h: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A head's L2-normalised projection, in the head's dtype."""
    return l2n(h(x.to(h[0].weight.dtype)))


# ---- HCMoCo, depth as an image (arch HRNet) -------------------------------


class HCMoCo(nn.Module):
    """HRNet on RGB, HRNet on depth copied to 3 channels, SemGCN on the 2D
    joints; each pooled, projected and L2-normalised."""

    def __init__(self, width: int, num: Numerics, feat_dim: int = 128,
                 gcn_dim: int = 128):
        super().__init__()
        self.encoder1 = HRNet(width, 3, num)
        self.encoder2 = HRNet(width, 3, num)
        self.encoder3 = SemGCN(gcn_dim, 4, "mpii", num)
        total = sum(hrnet_stages(width)[3].channels)
        self.head1, self.head2 = head(total, feat_dim), head(total, feat_dim)
        self.head3 = head(gcn_dim, feat_dim)
        self.num = num

    def forward(self, batch: dict) -> torch.Tensor:
        x = batch["rgbd"].permute(0, 3, 1, 2)
        fj = self.encoder3(batch["skeleton"])
        return torch.stack([
            project(self.head1, pool(self.encoder1(x[:, :3]))),
            project(self.head2, pool(self.encoder2(x[:, 3:6]))),
            project(self.head3, fj.mean(dim=1))])


def hrnet_groups(model: nn.Module, encoders: Sequence[str]) -> dict:
    """Each parameter's layer group, with the HRNets `encoders` split in
    two: `<encoder>.convbn`, the weight of every 1x1 stride-1 convolution
    and its BN's scale and shift (the program's fused K1/K1b sites), and
    `<encoder>.other`.  Every other parameter goes by its top-level
    module: `encoder3` (SemGCN), `heads`, or its own name."""
    keys = {k for k, _ in model.named_parameters()}
    fused = set()
    for enc in encoders:
        for name, m in model.get_submodule(enc).named_modules():
            if isinstance(m, nn.Conv2d) and m.kernel_size == (1, 1) \
                    and m.stride == (1, 1):
                name = f"{enc}.{name}"
                parent, leaf = name.rsplit(".", 1)
                bn = parent + "." + ("1" if leaf == "0"
                                     else leaf.replace("conv", "bn"))
                site = {f"{name}.weight", f"{bn}.weight", f"{bn}.bias"}
                if not site <= keys:
                    raise ValueError(
                        f"no BN beside the 1x1 convolution {name}")
                fused |= site
    out = {}
    for k in keys:
        top = k.split(".")[0]
        if top in encoders:
            out[k] = f"{top}.{'convbn' if k in fused else 'other'}"
        else:
            out[k] = "heads" if top.startswith("head") else top
    return out


# ---- the architectures ----------------------------------------------------

ARCHS = Path(__file__).resolve().parent / "archs"
ARCH_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def arch(name: str):
    """The reference of architecture `name` (TrainConfig.arch): the
    module h100_bench/reference/archs/<name>.py.  It holds `build(run,
    num)`, the model (which takes a batch and returns the three
    modalities' features, (3, B, feat_dim)); `groups(model)`, each
    parameter's layer group for the check; and `FIELDS`, the batch
    fields beyond traffic.py's own that the model reads (traffic.py
    draws them)."""
    path = ARCHS / f"{name}.py"
    if not ARCH_NAME.match(name) or not path.is_file():
        raise ValueError(f"arch {name!r}: no reference file {path}")
    return importlib.import_module(f"{__package__}.archs.{name}")


def build(run: dict, num: Numerics, device="cpu") -> nn.Module:
    """The plain reference of the cell `run` (its `arch` and sizes),
    its parameters on `device`."""
    ref = arch(run["arch"])
    with torch.device(device):
        return ref.build(run, num)
