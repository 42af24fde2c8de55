"""Recomputation in the backward: activation memory traded for a second
forward of the cheap ops (counterpart of the `jax.checkpoint` of
hcmoco_tpu/train/contrast_step.py:176-192, with the `checkpoint_name`
anchors of hcmoco_tpu/models/hrnet.py:255,276, and of the `nn.remat` of
hcmoco_tpu/models/pointnet2_model.py:210-226).

`TrainConfig.remat` runs the HRNet model's training forward (stages 1
and 2, arch 'HRNet') under `recompute(cfg.remat_policy)`.  The model then
runs as checkpointed regions (`region`): the stem, each residual block,
each standalone ConvBN, each fused output of an HRModule, SemGCN and the
heads.  A region's first run drops its graph and keeps its inputs and
what its policy keeps; when the backward reaches the region, it runs
again and its own backward runs (`_Region`, a reentrant checkpoint).
Unlike torch.utils.checkpoint's reentrant mode, the first run runs with
gradients on, so that every op takes the path it takes in the step
without recomputation (with torch's, whose first run is under no_grad,
the card's gradients parted from those of the step without, at
SemGCN's noise-level bias gradients); the mode without reentry runs a
Python hook for every tensor saved in a region, which tripled the host
time of the W18 step on the card.  (One region over the whole model, as JAX's
`jax.checkpoint` is, would bring every activation back at once at the
start of the backward: no lower peak.)  The policies, the JAX step's
two:

  * 'conv_out' keeps every ConvBN site's pre-BN conv output
    (models/hrnet.py::conv_bn), and on the fused path K1's y with its
    channel sums s1, s2 (ops/matmul_bn.py): BN, ReLU, resizes and adds
    run again, no ConvBN conv and no K1 does.  Both sites are autograd
    Functions that hand the recompute their first run's outputs (`kept`)
    and whose backward is the plain path's.  JAX keeps K1's y alone and
    reruns the pallas_call for the sums; the port keeps them.
  * 'dots' keeps nothing inside a region: every conv and K1 run again.
    JAX's dots_with_no_batch_dims_saveable also keeps the outputs of
    plain 2-D matmuls; in this model those are the heads' and SemGCN's
    feature products, a few hundred KB at bs32, which the port recomputes
    too.

`TrainConfig.pn_remat` runs each scale of SA levels 0 and 1 of
PointNet++ (the shared MLP with its K5 gather, then the max over the
samples) as a region that keeps nothing inside (`run_region` with no
policy); FPS, the ball query and depth2pts's draws stay outside.

A recompute must not change what the step computes once:
  * BN running statistics and num_batches_tracked are updated by a
    region's first run only: the BN paths read `replaying()`
    (parallel/batchnorm.py, models/hrnet.py::conv_bn for K1b);
  * a collective in a region's forward (the BN sums' all-reduce) is
    issued by the first run only: `recorded` keeps its result and hands
    it back to the recompute, so the backward issues no forward
    collective and the ranks' collectives are those of a step without
    recomputation (the sums' backward all-reduce runs once, in the
    region's backward);
  * no region draws a random number (the regions run with
    preserve_rng_state=False): the step's draws all lie outside them.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch

POLICIES = ("conv_out", "dots")

_local = threading.local()


class _Tape:
    """One region's state: its policy, whether it is being recomputed
    (every run after the first), and the values its first run kept."""

    def __init__(self, policy: Optional[str]):
        self.policy = policy
        self.replay = False
        self.values: List = []


def _tape() -> Optional[_Tape]:
    return getattr(_local, "tape", None)


def check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {POLICIES}")
    return policy


@contextmanager
def recompute(policy: str):
    """Within this block, on this thread, `region` checkpoints under
    `policy` (one of POLICIES)."""
    before = getattr(_local, "policy", None)
    _local.policy = policy
    try:
        yield
    finally:
        _local.policy = before


def replaying() -> bool:
    """Whether this thread is recomputing a region for the backward."""
    tape = _tape()
    return tape is not None and tape.replay


def active() -> bool:
    """Whether this thread runs under a `recompute` policy or inside a
    region."""
    return getattr(_local, "policy", None) is not None or _tape() is not None


def keeps_conv_out() -> bool:
    """Whether this thread runs a region under 'conv_out'."""
    tape = _tape()
    return tape is not None and tape.policy == "conv_out"


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


def recorded(fn: Callable):
    """fn() outside a region and in a region's first run, which keeps the
    result (a tensor or a tuple of them); a recompute takes the kept
    results back in their order instead of calling fn."""
    tape = _tape()
    if tape is None:
        return fn()
    if tape.replay:
        if not tape.values:
            raise RuntimeError("a recompute asked for more kept values "
                               "than its region's first run kept")
        return tape.values.pop(0)
    out = fn()
    tape.values.append(_detached(out))
    return out


def kept(fn: Callable):
    """`recorded` in a region under 'conv_out' (a conv output, K1's),
    else fn()."""
    return recorded(fn) if keeps_conv_out() else fn()


class _Region(torch.autograd.Function):
    """A region: its forward runs fn with gradients on, as the step
    without recomputation would (so every op takes the path it takes
    there), and drops that graph; its backward runs fn again with
    gradients and backpropagates through that run.  Keeps the tensor
    arguments."""

    @staticmethod
    def forward(ctx, body, spec, *args):
        ctx.body, ctx.spec = body, spec
        ctx.save_for_backward(*(a for a, t in zip(args, spec) if t))
        ctx.others = [None if t else a for a, t in zip(args, spec)]
        with torch.enable_grad():
            out = body(*_inputs(args, spec))
        return tuple(o.detach() for o in out)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        args = [next(saved) if t else a for a, t in zip(ctx.others,
                                                           ctx.spec)]
        inputs = _inputs(args, ctx.spec)
        with torch.enable_grad():
            out = ctx.body(*inputs)
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None) + tuple(
            a.grad if t and a.requires_grad else None
            for a, t in zip(inputs, ctx.spec))


def _inputs(args, spec):
    """The region's arguments with each tensor detached, requiring grad
    where it did."""
    return [a.detach().requires_grad_(a.requires_grad) if t else a
            for a, t in zip(args, spec)]


def run_region(fn: Callable, *args, policy: Optional[str] = None):
    """fn(*args) as a region (_Region) that keeps its tensor arguments and
    what `policy` keeps; with none, nothing inside.  fn returns a tensor,
    a tuple or a dict of them, none of them an argument.  Runs fn
    directly inside another region (nested regions are one) or with
    gradients off."""
    if _tape() is not None or not torch.is_grad_enabled():
        return fn(*args)
    tape = _Tape(policy)
    shape = {}

    def body(_, *a):
        _local.tape = tape
        try:
            out = fn(*a)
        finally:
            _local.tape = None
            tape.replay = True
        if isinstance(out, dict):
            shape["keys"] = list(out)
            return tuple(out.values())
        shape["single"] = isinstance(out, torch.Tensor)
        return (out,) if shape["single"] else tuple(out)

    # the anchor, an argument that requires grad, makes the outputs
    # require it, and so the parameters inside get their gradients, where
    # no input does (the stem's image, SA level 0's coordinates)
    args = (torch.empty(0, requires_grad=True),) + args
    spec = tuple(isinstance(a, torch.Tensor) for a in args)
    out = _Region.apply(body, spec, *args)
    if "keys" in shape:
        return dict(zip(shape["keys"], out))
    return out[0] if shape["single"] else out


def region(fn: Callable, *args):
    """fn(*args): a checkpointed region under the policy of an enclosing
    `recompute` on this thread, else a plain call."""
    policy = getattr(_local, "policy", None)
    if policy is None:
        return fn(*args)
    return run_region(fn, *args, policy=policy)
