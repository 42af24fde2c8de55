"""CUDA graphs of the HRNet encoders in the contrastive train step.

An HRNet-W18 encoder launches some 3,000 kernels a training forward and
as many again backward, each issued by Python and by autograd's engine;
on the card the host then paces the step.  Here each encoder's forward
and backward replay from CUDA graphs instead, through one autograd node
(`_Replay`), while everything around them (the point branch, SemGCN, the
heads, the NCE, the banks, SGD) runs eagerly as before.

    install(model)   # make_contrast_train_step does this

graphs the HRNet encoders among the model's children (`encoder1` and
`encoder2` of HCMoCoModel, `encoder1` of HCMoCoPNModel); the step
installs them only where it runs one forward per backward (microbatch
1).  `models/hrnet.py::HRNet.forward` asks `replay` first: the graphed
region starts at the encoder's input cast to its compute dtype,
channels_last (that cast is the copy into the graph's static input) and
ends at the four maps.

Which calls replay (`engages`, from what the call can observe; there is
no switch): a CUDA input that needs no gradient, grad enabled, the
encoder in training, a world of one (under data parallelism the BN sums
are all-reduced inside the encoder) and no recompute policy or region
(train/remat.py).  Every other call runs the encoder eagerly, as does
the CPU.  Graphs are kept by the input's shape, strides and dtype (and
the encoder's compute dtype, fuse setting and parameter storage): the
first call of a key runs eagerly, which warms cuDNN and the kernels'
lazy state outside any capture; the second captures the forward and
replays it, and its backward captures the backward and replays it;
later calls replay both.  No call runs the encoder twice, so BN running
statistics move once a call, as eagerly.  A forward whose backward has
not run while its autograd node lives runs eagerly, so no replay
overwrites what that backward reads.

The same step, bit for bit: a replay runs the kernels that the eager
call runs, in the same order.  The backward writes each parameter's
gradient into a buffer of the graph and hands it to the parameter as
`.grad` (added to another gradient already there), in the layout
AccumulateGrad would give it, so SGD reads what the eager step gives it
and nothing is copied a step.  The buffer is overwritten by the next
replay of its pool: a step zeroes its gradients before its backward.

The graphed encoders are found through a weak registry, not an
attribute of the model, so a copy of a model (copy.deepcopy) runs
eagerly until a step graphs it.

Memory: the capture's autograd graph, and with it every tensor the
captured forward saves for the backward, lives as long as the graphs, so
`torch.cuda.max_memory_allocated` counts the activations as it does in
the eager step; the static gradient buffers count too.  Temporaries
inside a replay are reserved in a memory pool but not allocated.  The
encoders of one model share pools (`_Pools`): a step replays the graphs
of a pool in the order it captured them (the forwards in turn, then the
backwards in autograd's order), so a later capture may reuse what an
earlier one freed.  A pool holds one input key of each encoder, and an
encoder's next key opens another pool, so graphs that a step may replay
out of their capture order never share one.

K1's generic path takes a counter of each graph's own
(ops/matmul_bn.py::graph_counter).  The kernel wrappers count launches
on the host: a capture counts once, a replay not at all.  Each forward
replay is the span `encoder_graph` (utils/spans.py); backward replays
run on autograd's thread and have none (`EncoderGraphs.replays` counts
both).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..ops import matmul_bn
from ..parallel.mesh import world_size
from ..utils.spans import span
from . import remat

# encoder -> its EncoderGraphs (install)
_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# device index -> the stream of every capture on it: autograd runs a
# node's backward on the stream its forward ran on, so a backward is
# captured on the stream its forward was captured on
_streams: Dict[int, torch.cuda.Stream] = {}


def engages(*, cuda: bool, grad: bool, training: bool, input_grad: bool,
            world: int, recompute: bool) -> bool:
    """Whether an encoder call replays its graphs: a CUDA input that
    needs no gradient, grad enabled, training mode, a world of one, no
    recompute."""
    return (cuda and grad and training and not input_grad and world == 1
            and not recompute)


def install(model: torch.nn.Module) -> None:
    """Graph every HRNet encoder among `model`'s children, for a step of
    one forward per backward; the encoders share the model's pools."""
    from ..models.hrnet import HRNet

    pools = _Pools()
    for m in model.children():
        if isinstance(m, HRNet):
            _graphs[m] = EncoderGraphs(pools)


def of(encoder: torch.nn.Module) -> Optional["EncoderGraphs"]:
    """The encoder's graphs, if install() graphed it."""
    return _graphs.get(encoder)


def replay(encoder: torch.nn.Module, x: torch.Tensor
           ) -> Optional[List[torch.Tensor]]:
    """The encoder's maps of input `x` from its graphs, or None where the
    call runs eagerly (`engages`, the first call of a key)."""
    graphs = _graphs.get(encoder)
    if graphs is None or not engages(
            cuda=x.is_cuda, grad=torch.is_grad_enabled(),
            training=encoder.training, input_grad=x.requires_grad,
            world=world_size(), recompute=remat.active()):
        return None
    return graphs(encoder, x)


def _stream(device: torch.device) -> torch.cuda.Stream:
    if device.index not in _streams:
        _streams[device.index] = torch.cuda.Stream(device)
    return _streams[device.index]


class _Pools:
    """The memory pools of one model's graphs, each with one input key
    of each encoder at most (`take`)."""

    def __init__(self):
        # [pool handle, None until its first capture; the ids of the
        # encoders with a key in it]
        self.pools: List[list] = []

    def take(self, encoder: torch.nn.Module) -> list:
        """The first pool without a key of `encoder`, now holding one."""
        for p in self.pools:
            if id(encoder) not in p[1]:
                p[1].add(id(encoder))
                return p
        self.pools.append([None, {id(encoder)}])
        return self.pools[-1]


class _Graph:
    """One CUDA graph with a K1 counter of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.counter = matmul_bn.new_counter(device)
        self.replays = 0

    def capture(self, fn: Callable, pool=None):
        """fn()'s kernels captured, not run (on the device's capture
        stream, into `pool` or a pool of the graph's own); fn's result."""
        # a capture cannot release cached blocks: free them first
        torch.cuda.empty_cache()
        main, stream = torch.cuda.current_stream(self.device), \
            _stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream), \
                matmul_bn.graph_counter(self.counter):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                self.graph.capture_end()
        main.wait_stream(stream)
        return out

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def _as_grad(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """g as AccumulateGrad would keep it as p.grad: itself where its
    strides are p's in every dim longer than 1, else a copy in p's
    layout (the gradient layout contract)."""
    if all(n == 1 or a == b for n, a, b in zip(g.shape, g.stride(),
                                               p.stride())):
        return g
    return torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                               device=p.device).copy_(g)


class _Entry:
    """The graphs of one input key in `pool` (a _Pools entry): the static
    input, the forward graph with its outputs and the capture's autograd
    graph, and, once the first backward has come, the backward graph
    with its static output gradients and parameter gradients."""

    def __init__(self, encoder: torch.nn.Module, x: torch.Tensor,
                 pool: list):
        # filled before the capture: the captured forward saves it at the
        # version the backward's capture checks
        self.x = torch.empty_like(x, dtype=encoder.compute_dtype,
                                  memory_format=torch.channels_last)
        self.x.copy_(x)
        self.params = [p for p in encoder.parameters() if p.requires_grad]
        self.fwd = _Graph(x.device)
        self.outs = tuple(self.fwd.capture(lambda: encoder.maps(self.x),
                                           pool=pool[0]))
        if pool[0] is None:
            pool[0] = self.fwd.graph.pool()
        self.pool = pool[0]
        self.bwd: Optional[_Graph] = None
        self.gouts: List[torch.Tensor] = []
        self.grads: List[Optional[torch.Tensor]] = []
        # the autograd node of the last forward replay, until its backward
        self.node = None

    def pending(self) -> bool:
        """Whether a forward replay's backward has yet to run while its
        autograd node lives."""
        return self.node is not None and self.node() is not None

    def backward(self, grads) -> None:
        if self.bwd is None:
            self.gouts = [torch.empty_like(g) for g in grads]
            self.bwd = _Graph(self.x.device)
            self.grads = self.bwd.capture(self._param_grads, pool=self.pool)
        for s, g in zip(self.gouts, grads):
            s.copy_(g)
        self.bwd.replay()
        self.node = None
        # a gradient still held from the last replay was zeroed in place
        # or set to None since (the step zeroes before each backward): the
        # replay has overwritten it
        for p, g in zip(self.params, self.grads):
            if g is None or p.grad is g:
                continue
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)

    def _param_grads(self) -> List[Optional[torch.Tensor]]:
        grads = torch.autograd.grad(self.outs, self.params, self.gouts,
                                    retain_graph=True, allow_unused=True)
        return [None if g is None else _as_grad(g, p)
                for g, p in zip(grads, self.params)]


class _Replay(torch.autograd.Function):
    """The replayed forward of an entry; its backward replays the
    entry's backward.  `anchor` requires grad, so the outputs do."""

    @staticmethod
    def forward(ctx, entry: _Entry, anchor: torch.Tensor):
        ctx.entry = entry
        entry.fwd.replay()
        entry.node = weakref.ref(ctx)
        return tuple(o.detach() for o in entry.outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        ctx.entry.backward(grads)
        return None, None


class EncoderGraphs:
    """One encoder's graphs, by input key, in its model's pools."""

    def __init__(self, pools: _Pools):
        self.pools = pools
        # key -> its _Entry, or None after the key's first (eager) call
        self.entries: Dict[tuple, Optional[_Entry]] = {}
        self.anchor = torch.empty(0, requires_grad=True)

    def replays(self) -> Tuple[int, int]:
        """Forward and backward replays so far, over every key."""
        done = [e for e in self.entries.values() if e is not None]
        return (sum(e.fwd.replays for e in done),
                sum(e.bwd.replays for e in done if e.bwd is not None))

    def __call__(self, encoder: torch.nn.Module, x: torch.Tensor
                 ) -> Optional[List[torch.Tensor]]:
        key = (tuple(x.shape), x.stride(), x.dtype, x.device,
               encoder.compute_dtype, encoder.convbn_fuse,
               next(encoder.parameters()).data_ptr())
        if key not in self.entries:
            self.entries[key] = None
            return None
        entry = self.entries[key]
        if entry is None:
            entry = self.entries[key] = _Entry(encoder, x,
                                               self.pools.take(encoder))
        elif entry.pending():
            return None
        else:
            entry.x.copy_(x)
        with span("encoder_graph"):
            return list(_Replay.apply(entry, self.anchor))
