"""Find which of ResNeSt's convolutions makes its f32 train step through
cuDNN read outside the dtype check's margin on one CUDA card, and which
cuDNN algorithm that convolution takes (ROADMAP.md Queue 3, F14).

Usage: python3 tools/resnest_f32_sites.py [sites,layouts,ops,replay]

At the dtype check's size (chip_smoke.RESNEST_DTYPE_SIZE: the small
ResNeSt of chip_smoke.small_resnest, 224^2 bs8, nce_k 256), with TF32 off,
prints with the card's name and power limit (the parts named in the
argument, all by default):
  1. `sites`: for MoCov2 and CMC, the f32 card step's
     chip_smoke.f32_margins (the check passes at <= 1 in every group) with
     every conv through cuDNN, every conv native (PyTorch's own CUDA
     convolutions, whose output is NCHW), and for each site class: native
     at that class alone, and cuDNN at that class alone; then cuDNN with
     `deterministic` at each class alone;
  `layouts`: the same readings with the layout held apart from the
     convolution: every conv's output made NCHW (cuDNN) or kept
     channels_last (native), cuDNN's batch norm off, and each class native
     in channels_last alone; and the parameter tensors farthest from the
     float64 step, each beside the CPU f32 step's distance;
  `ops`: the readings with one kind of op (average pool, max pool, batch
     norm) run in NCHW inside an otherwise channels_last step, and each
     such op alone at the small ResNeSt's shapes, forward and input
     gradient in f32 on the card in NCHW and in channels_last against
     float64 on the CPU;
  2. `replay`: each distinct conv call of one f32 MoCov2 step, replayed
     alone: the
     forward, the input gradient and the weight gradient through cuDNN,
     natively and through cuDNN with `deterministic`, each as its largest
     abs difference from float64 on the CPU over the float64 result's
     largest magnitude, and the kernels cuDNN launches for it
     (torch.profiler);
  3. (with `sites`) the float64 step on the card through cuDNN against
     the float64 CPU step, in f32_margins' units.

The site classes are the stem's three 3x3 convs, SplAtConv2d's grouped
radix conv ('splat conv') and its 1x1 fc1/fc2 on the pooled (B, C, 1, 1)
vector ('splat fc'), a bottleneck's 1x1 conv1/conv3 ('block 1x1') and the
avg-down shortcut's 1x1 conv ('shortcut').  A class is routed by swapping
the convolution calls of models/resnest.py (through hrnet.conv_bn and its
own F.conv2d) for an autograd function that runs the forward and the
backward under the class's cuDNN setting.
"""

import contextlib
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch
import torch.nn.functional as F

SITES = ("stem", "splat conv", "splat fc", "block 1x1", "shortcut")
MODES = {"cudnn": dict(enabled=True, deterministic=False),
         "native": dict(enabled=False, deterministic=False),
         "deterministic": dict(enabled=True, deterministic=True)}
# a mode and the memory format its output is put in (None: as it comes)
LAYOUTS = {"cudnn nchw": ("cudnn", torch.contiguous_format),
           "native nhwc": ("native", torch.channels_last)}
ROUTE = {}          # site class -> mode; cuDNN where absent
STATE = {"site": None, "record": None}


@contextlib.contextmanager
def cudnn_mode(enabled: bool, deterministic: bool):
    c = torch.backends.cudnn
    was = (c.enabled, c.deterministic)
    c.enabled, c.deterministic = enabled, deterministic
    try:
        yield
    finally:
        c.enabled, c.deterministic = was


def _pair(v):
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


class RoutedConv(torch.autograd.Function):
    """F.conv2d whose forward and backward both run under one cuDNN
    setting."""

    @staticmethod
    def forward(ctx, x, w, b, conf, mode):
        ctx.conf, ctx.mode, ctx.has_b = conf, mode, b is not None
        ctx.save_for_backward(x, w)
        with cudnn_mode(**MODES[mode]):
            return F.conv2d(x, w, b, *conf)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        need = ctx.needs_input_grad
        with cudnn_mode(**MODES[ctx.mode]):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]] if ctx.has_b else None,
                _pair(stride), _pair(padding), _pair(dilation), False,
                [0, 0], groups, [need[0], need[1], ctx.has_b and need[2]])
        return gx, gw, gb, None, None


def conv(site, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    conf = (stride, padding, dilation, groups)
    if STATE["record"] is not None and x.is_cuda:
        STATE["record"].append((site, x.detach().clone(), w.detach().clone(),
                                None if b is None else b.detach().clone(),
                                conf))
    mode, layout = LAYOUTS.get(ROUTE.get(site, "cudnn"),
                               (ROUTE.get(site, "cudnn"), None))
    if not x.is_cuda or (mode == "cudnn" and torch.backends.cudnn.enabled):
        y = F.conv2d(x, w, b, *conf)
    else:
        y = RoutedConv.apply(x, w, b, conf, mode)
    return y if layout is None else y.contiguous(memory_format=layout)


class _F:
    """torch.nn.functional with conv2d routed by the current site."""

    def __init__(self, site=None):
        self.site = site

    def conv2d(self, *args, **kw):
        return conv(self.site or STATE["site"], *args, **kw)

    def __getattr__(self, name):
        return getattr(F, name)


@contextlib.contextmanager
def routed():
    """Inside, ResNeSt's convs go through `conv`, tagged by site class."""
    from hcmoco_tpu_torch.models import hrnet, resnest

    orig = resnest.conv_bn

    def conv_bn(c, *args, **kw):
        STATE["site"] = getattr(c, "_site", None)
        try:
            return orig(c, *args, **kw)
        finally:
            STATE["site"] = None

    saved = (resnest.conv_bn, resnest.F, hrnet.F)
    resnest.conv_bn, resnest.F, hrnet.F = conv_bn, _F("splat fc"), _F()
    try:
        yield
    finally:
        resnest.conv_bn, resnest.F, hrnet.F = saved


def tag_sites(model: torch.nn.Module) -> None:
    from hcmoco_tpu_torch.models.resnest import (ResNeSt, ResNeStBottleneck,
                                                 SplAtConv2d)

    for m in model.modules():
        if isinstance(m, ResNeSt):
            for i in (0, 3, 6):
                m.conv1[i]._site = "stem"
        elif isinstance(m, ResNeStBottleneck):
            m.conv1._site = m.conv3._site = "block 1x1"
            if m.downsample is not None:
                m.downsample[1]._site = "shortcut"
        elif isinstance(m, SplAtConv2d):
            m.conv._site = "splat conv"
            m.fc1._site = m.fc2._site = "splat fc"


def setup(smoke, kw):
    """The f32 model, batch, memory and the CPU's float64 and f32 steps
    of one method at the dtype check's size."""
    from hcmoco_tpu_torch.models.build import build_model

    cfg = smoke.baseline_cfg(**kw, **smoke.RESNEST_DTYPE_SIZE)
    n = smoke.BASELINE_SMALL_N_DATA
    batch = smoke.baseline_batch(cfg, np.random.default_rng(7), n)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    tag_sites(model)
    ref = smoke.run_baseline_step(cfg, smoke.model_f64(copy.deepcopy(model)),
                                  "cpu", batch, n)
    mem = ref["before"]
    cpu = smoke.run_baseline_step(cfg, model, "cpu", batch, n, mem=mem)
    return dict(cfg=cfg, model=model, batch=batch, n=n, mem=mem, ref=ref,
                cpu=cpu)


def reading(smoke, label, name, st, card, route, cudnn=True,
            breakdown=False):
    """One f32 card step under `route` (and cuDNN on or off outside the
    routed convs), its f32_margins printed."""
    ROUTE.clear()
    ROUTE.update(route)
    with cudnn_mode(cudnn, False):
        run = smoke.run_baseline_step(st["cfg"], st["model"], "cuda",
                                      st["batch"], st["n"], mem=st["mem"])
    ROUTE.clear()
    r = smoke.f32_margins(run, st["cpu"], st["ref"])
    print(f"F14 {label} f32 step, {name}: worst {max(r.values()):.4g} "
          f"of the margin; {({k: round(v, 4) for k, v in r.items()})} "
          f"[{card}]")
    if breakdown:
        ref = st["ref"]["state"]
        rows = []
        for k, v in ref.items():
            if v.is_floating_point() and k.startswith("model ") \
                    and "running_" not in k:
                d = [float(((x["state"][k].double() - v.double()) ** 2)
                           .sum()) ** 0.5 for x in (run, st["cpu"])]
                rows.append((d[0], d[1], k, tuple(v.shape)))
        total = sum(d ** 2 for d, _, _, _ in rows)
        for d, dc, k, shape in sorted(rows, reverse=True)[:8]:
            print(f"  {k} {shape}: {d:.4g} from float64 ({d ** 2 / total:.3f}"
                  f" of the squared distance), the CPU f32 step's {dc:.4g}")


def sites(smoke, label, st, card):
    """Part 1 and 3 for one method."""
    variants = [("all cudnn", {}),
                ("all native", {s: "native" for s in SITES})]
    for s in SITES:
        variants.append((f"native at {s} alone", {s: "native"}))
        variants.append((f"cudnn at {s} alone",
                         {t: "native" for t in SITES if t != s}))
    for s in SITES:
        variants.append((f"deterministic cudnn at {s} alone",
                         {s: "deterministic"}))
    for name, route in variants:
        reading(smoke, label, name, st, card, route)
    run = smoke.run_baseline_step(
        st["cfg"], smoke.model_f64(copy.deepcopy(st["model"])), "cuda",
        st["batch"], st["n"], mem=st["mem"])
    r = smoke.f32_margins(run, st["cpu"], st["ref"])
    print(f"F14 {label} float64 card step through cuDNN vs the float64 CPU "
          f"step: worst {max(r.values()):.4g} of the f32 margin; "
          f"{({k: float(f'{v:.4g}') for k, v in r.items()})} [{card}]")


def layouts(smoke, label, st, card):
    """The layout apart from the convolution algorithm."""
    reading(smoke, label, "all cudnn (channels_last)", st, card, {},
            breakdown=True)
    reading(smoke, label, "all native (NCHW outputs)", st, card,
            {s: "native" for s in SITES}, breakdown=True)
    reading(smoke, label, "cudnn convs, outputs made NCHW", st, card,
            {s: "cudnn nchw" for s in SITES})
    reading(smoke, label, "native convs, outputs kept channels_last", st,
            card, {s: "native nhwc" for s in SITES}, breakdown=True)
    reading(smoke, label, "cudnn convs, cuDNN batch norm off", st, card,
            {s: "cudnn" for s in SITES}, cudnn=False)
    for s in SITES:
        reading(smoke, label, f"native at {s} alone, channels_last kept",
                st, card, {s: "native nhwc"})


def kernels_of(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation()]
    return sorted(set(names))


@contextlib.contextmanager
def op_in_nchw(name: str):
    """Inside, torch.nn.functional.<name> runs on an NCHW copy of a
    channels_last input and returns channels_last."""
    orig = getattr(F, name)

    def nchw(x, *args, **kw):
        cl = x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last) and not x.is_contiguous()
        if not cl:
            return orig(x, *args, **kw)
        y = orig(x.contiguous(), *args, **kw)
        return y.contiguous(memory_format=torch.channels_last)

    setattr(F, name, nchw)
    try:
        yield
    finally:
        setattr(F, name, orig)


# (op, input shape, args): the small ResNeSt's calls at 224^2 bs8
OP_CALLS = (
    ("max_pool2d", (8, 64, 112, 112), (3, 2, 1)),
    ("avg_pool2d", (8, 64, 56, 56), (3, 1, 1)),
    ("avg_pool2d", (8, 128, 56, 56), (3, 2, 1)),
    ("avg_pool2d", (8, 256, 28, 28), (3, 2, 1)),
    ("avg_pool2d", (8, 256, 56, 56), (2, 2)),
    ("avg_pool2d", (8, 512, 28, 28), (2, 2)),
    ("batch_norm", (8, 32, 112, 112), ()),
    ("batch_norm", (8, 64, 56, 56), ()),
    ("batch_norm", (8, 512, 7, 7), ()),
)


def ops(smoke, label, st, card):
    """The layout of the non-conv ops, in the step and alone."""
    for name in ("avg_pool2d", "max_pool2d", "batch_norm"):
        with op_in_nchw(name):
            reading(smoke, label, f"all cudnn, {name} in NCHW", st, card, {})
    if label != "ResNeSt MoCov2":
        return
    g = torch.Generator().manual_seed(5)

    def call(name, x, args):
        if name == "batch_norm":
            c = x.shape[1]
            w = torch.ones(c, dtype=x.dtype, device=x.device)
            return F.batch_norm(x, None, None, w, torch.zeros_like(w),
                                training=True)
        return getattr(F, name)(x, *args)

    for name, shape, args in OP_CALLS:
        x0 = torch.randn(shape, generator=g)
        if name.endswith("pool2d"):
            x0 = F.relu(x0)  # after the ReLU of a ConvBN site
        x64 = x0.double().clone().requires_grad_()
        y64 = call(name, x64, args)
        gy = torch.randn(y64.shape, generator=g)
        y64.backward(gy.double())
        errs = {}
        for fmt in ("nchw", "channels_last"):
            mf = (torch.contiguous_format if fmt == "nchw"
                  else torch.channels_last)
            for cud in (True, False):
                with cudnn_mode(cud, False):
                    x = x0.cuda().contiguous(memory_format=mf)
                    x.requires_grad_()
                    y = call(name, x, args)
                    y.backward(gy.cuda())
                errs[f"{fmt}{'' if cud else ' no-cudnn'}"] = tuple(
                    float((a.detach().cpu().double() - r).abs().max()
                          / r.abs().max())
                    for a, r in ((y, y64.detach()), (x.grad, x64.grad)))
        print(f"F14 op {name} x{shape} args {args}: rel err (y, dx) "
              + "; ".join(f"{k} {v[0]:.3g}, {v[1]:.3g}"
                          for k, v in errs.items()) + f" [{card}]")
    # the faulty pool by dtype and by count_include_pad, channels_last
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        for stride in (1, 2):
            for incl in (True, False):
                x0 = F.relu(torch.randn((8, 64, 56, 56), generator=g)).to(dt)
                x64 = x0.double().clone().requires_grad_()
                y64 = F.avg_pool2d(x64, 3, stride, 1, count_include_pad=incl)
                gy = torch.randn(y64.shape, generator=g).to(dt)
                y64.backward(gy.double())
                x = x0.cuda().contiguous(
                    memory_format=torch.channels_last).requires_grad_()
                F.avg_pool2d(x, 3, stride, 1,
                             count_include_pad=incl).backward(gy.cuda())
                err = float((x.grad.cpu().double() - x64.grad).abs().max()
                            / x64.grad.abs().max())
                print(f"F14 op avg_pool2d (8, 64, 56, 56) 3x3 stride {stride}"
                      f" pad 1 count_include_pad={incl} {str(dt)[6:]} "
                      f"channels_last: dx rel err {err:.3g} [{card}]")


def replay(smoke, st, card):
    """Part 2: every distinct conv call of one f32 step, alone."""
    cfg, model, batch, n, mem = (st[k] for k in ("cfg", "model", "batch",
                                                  "n", "mem"))
    STATE["record"] = []
    ROUTE.clear()
    smoke.run_baseline_step(cfg, model, "cuda", batch, n, mem=mem)
    calls, seen = [], set()
    for site, x, w, b, conf in STATE["record"]:
        key = (site, tuple(x.shape), tuple(w.shape), b is not None, conf)
        if key not in seen:
            seen.add(key)
            calls.append((site, x, w, b, conf))
    STATE["record"] = None
    g = torch.Generator().manual_seed(11)
    for site, x, w, b, conf in calls:
        x64 = x.cpu().double().requires_grad_()
        w64 = w.cpu().double().requires_grad_()
        b64 = None if b is None else b.cpu().double().requires_grad_()
        y64 = F.conv2d(x64, w64, b64, *conf)
        gy = torch.randn(y64.shape, generator=g)
        y64.backward(gy.double())
        want = (y64.detach(), x64.grad, w64.grad)

        def run(mode):
            xx = x.clone().requires_grad_()
            ww = w.clone().requires_grad_()
            bb = None if b is None else b.clone().requires_grad_()
            y = RoutedConv.apply(xx, ww, bb, conf, mode)
            y.backward(gy.to(x.device))
            return y.detach(), xx.grad, ww.grad

        errs = {}
        for mode in MODES:
            got = run(mode)
            errs[mode] = tuple(
                float((a.cpu().double() - r).abs().max() / r.abs().max())
                for a, r in zip(got, want))
        fwd = kernels_of(lambda: RoutedConv.apply(x, w, b, conf, "cudnn"))
        xx = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        y = RoutedConv.apply(xx, ww, b, conf, "cudnn")
        gyd = gy.to(x.device)
        bwd = kernels_of(lambda: y.backward(gyd))
        print(f"F14 conv {site} x{tuple(x.shape)} w{tuple(w.shape)} "
              f"stride/pad/dil/groups {conf}: rel err (y, dx, dw) "
              + "; ".join(f"{m} " + ", ".join(f"{e:.3g}" for e in v)
                          for m, v in errs.items())
              + f" [{card}]")
        print(f"  cuDNN fwd kernels: {[k[:100] for k in fwd]}")
        print(f"  cuDNN bwd kernels: {[k[:100] for k in bwd]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("resnest_f32_sites.py needs a CUDA device")
    import chip_smoke as smoke

    parts = (sys.argv[1] if len(sys.argv) > 1
             else "sites,layouts,ops,replay").split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()}; TF32 off")
    with smoke.small_resnest(), routed():
        for label, kw in (("ResNeSt MoCov2", dict(method="MoCov2")),
                          ("ResNeSt CMC", dict(method="CMC"))):
            st = setup(smoke, kw)
            if "sites" in parts:
                sites(smoke, label, st, card)
            if "layouts" in parts:
                layouts(smoke, label, st, card)
            if "ops" in parts:
                ops(smoke, label, st, card)
            if "replay" in parts and label == "ResNeSt MoCov2":
                replay(smoke, st, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
