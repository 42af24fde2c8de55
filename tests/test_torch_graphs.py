"""CUDA graphs of the HRNet encoders in the contrast train step
(hcmoco_tpu_torch/train/graphs.py).

On the CPU: the rule by which an encoder call replays (`engages`) and
what `replay` observes for it; that the contrast step of one microbatch
graphs exactly the model's HRNet encoders, in one set of pools; which
pool a key takes; and that a graphed encoder on the CPU runs as it did,
bit for bit.  On the card (`cuda` marker, JAX-free):

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

a graphed step equal to the eager step bit for bit over four steps (W18
at 64x64, bs8: stage 1 fused and plain, HRNetPN on 64 points with and
without pn_remat, stage 2; HRNetPN at the point cell's 320x320, bs64,
4096 points; cuDNN's deterministic algorithms on, so that two eager
runs agree), the same number of forward and backward replays,
the encoders' graphs in one pool, a second input shape captured as a
second graph in a second pool, bit for bit, and the peak memory of a
graphed step within 1% of the eager step's at the point cell's shapes
(HRNetPN W18 320x320 bs64, 4096 points).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hcmoco_tpu_torch.core.config import (HRNET_CONFIGS, RECIPES,
                                          TrainConfig, resolve_config)
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.train import contrast_step, graphs, remat

ELIGIBLE = dict(cuda=True, grad=True, training=True, input_grad=False,
                world=1, recompute=False)


@pytest.mark.parametrize("case,change,want", [
    ("eligible", {}, True),
    ("cpu tensor", dict(cuda=False), False),
    ("no grad", dict(grad=False), False),
    ("eval mode", dict(training=False), False),
    ("input needs grad", dict(input_grad=True), False),
    ("data parallel", dict(world=2), False),
    ("recompute", dict(recompute=True), False),
])
def test_engages_only_where_every_condition_holds(case, change, want):
    assert graphs.engages(**dict(ELIGIBLE, **change)) is want


class _Pair(torch.nn.Module):
    """Two tiny HRNets as a model's children, and a non-HRNet child."""

    def __init__(self):
        super().__init__()
        self.encoder1 = HRNet(HRNET_CONFIGS[4], 3, torch.float32)
        self.encoder2 = HRNet(HRNET_CONFIGS[4], 3, torch.float32)
        self.head = torch.nn.Linear(4, 4)


@pytest.mark.parametrize("context", ["plain", "eval", "no_grad", "world2",
                                     "recompute", "region", "input_grad"])
def test_replay_observes_the_call(monkeypatch, context):
    """What `replay` hands the rule: the input's device and grad, grad
    mode, the encoder's mode, the world size and remat's state."""
    seen = []
    monkeypatch.setattr(graphs, "engages",
                        lambda **kw: seen.append(kw) or False)
    model = _Pair()
    graphs.install(model)
    enc = model.encoder1
    x = torch.zeros((2, 3, 32, 32))
    want = dict(ELIGIBLE, cuda=False)
    if context == "eval":
        enc.eval()
        want["training"] = False
    if context == "world2":
        monkeypatch.setattr(graphs, "world_size", lambda: 2)
        want["world"] = 2
    if context == "input_grad":
        x.requires_grad_(True)
        want["input_grad"] = True
    if context == "no_grad":
        with torch.no_grad():
            assert graphs.replay(enc, x) is None
        want["grad"] = False
    elif context == "recompute":
        with remat.recompute("conv_out"):
            assert graphs.replay(enc, x) is None
        want["recompute"] = True
    elif context == "region":
        remat.run_region(lambda t: graphs.replay(enc, t) or t, x)
        want["recompute"] = True
    else:
        assert graphs.replay(enc, x) is None
    assert seen == [want]


def _tiny_cfg(arch, stage2=False, **kw):
    stage = "second_stage" if stage2 else "first_stage"
    base = RECIPES[f"{stage}/ntumpiirgbd2s_{arch.lower()}_w18"]
    return dataclasses.replace(base, width=4, crop_size=32, batch_size=4,
                               nce_k=15, compute_dtype="float32",
                               pn_num_points=64, **kw)


@pytest.mark.parametrize("arch,microbatch,graphed", [
    ("HRNet", 1, ("encoder1", "encoder2")),
    ("HRNetPN", 1, ("encoder1",)),
    ("HRNet", 0, ("encoder1", "encoder2")),
    ("HRNet", 2, ()),
    ("HRNetPN", 2, ()),
])
def test_contrast_step_graphs_its_hrnet_encoders(arch, microbatch, graphed):
    """One forward per backward graphs the model's HRNet encoders, in
    one set of pools; microbatches graph nothing."""
    cfg = _tiny_cfg(arch, microbatch=microbatch)
    model = build_model(cfg, device="cpu")
    contrast_step.make_contrast_train_step(cfg, model, steps_per_epoch=10)
    found = {name for name, m in model.named_children()
             if graphs.of(m) is not None}
    assert found == set(graphed)
    assert all(isinstance(getattr(model, n), HRNet) for n in found)
    assert len({id(graphs.of(getattr(model, n)).pools) for n in found}) \
        == min(len(found), 1)


def test_pools_hold_one_key_of_each_encoder():
    """A pool takes one key of each encoder; an encoder's next key opens
    the next pool, and a key of the other encoder fills the first pool
    that lacks it."""
    pools = graphs._Pools()
    a, b = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)
    p1 = pools.take(a)
    assert pools.take(b) is p1
    p2 = pools.take(a)
    assert p2 is not p1 and pools.take(b) is p2
    assert pools.take(b) is not p2
    assert [p[1] for p in pools.pools] == [{id(a), id(b)}, {id(a), id(b)},
                                           {id(b)}]
    assert all(p[0] is None for p in pools.pools)


def test_moco_step_graphs_nothing():
    cfg = resolve_config(TrainConfig(method="MoCo", arch="resnet18",
                                     crop_size=32, batch_size=4, nce_k=16,
                                     compute_dtype="float32"))
    model = build_model(cfg, device="cpu")
    contrast_step.make_contrast_train_step(cfg, model, steps_per_epoch=10)
    assert not any(graphs.of(m) is not None for m in model.modules())


def test_graphed_encoder_on_the_cpu_is_an_exact_pass_through():
    """Two forward/backward passes of a graphed pair of tiny HRNets on
    the CPU equal those of the same pair ungraphed, bit for bit (maps,
    gradients, BN statistics), and no graph is made."""
    torch.manual_seed(0)
    models = [_Pair(), _Pair()]
    models[1].load_state_dict(models[0].state_dict())
    graphs.install(models[1])
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn((2, 3, 32, 32), generator=g) for _ in range(2)]
    out = []
    for m in models:
        maps = []
        for x in xs:
            m.zero_grad(set_to_none=True)
            ys = m.encoder1(x) + m.encoder2(x)
            sum((y * (i + 1)).sum() for i, y in enumerate(ys)).backward()
            maps.append([y.detach() for y in ys])
        out.append((maps, {k: p.grad for k, p in m.named_parameters()
                           if p.grad is not None}, m.state_dict()))
    (maps0, grads0, sd0), (maps1, grads1, sd1) = out
    for a, b in zip(maps0, maps1):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert grads0.keys() == grads1.keys() and len(grads0) > 0
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert graphs.of(models[1].encoder1).entries == {}
    assert graphs.of(models[1].encoder1).replays() == (0, 0)


# --------------------------------------------------------------------------
# on the card

N_DATA = 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms and torch's (warn only: the
    bilinear resize's backward has none), so that two eager runs agree."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = before


def _card_cfg(arch, stage2=False, **kw):
    stage = "second_stage" if stage2 else "first_stage"
    base = RECIPES[f"{stage}/ntumpiirgbd2s_{arch.lower()}_w18"]
    kw = dict(dict(crop_size=64, batch_size=8, nce_k=63,
                   compute_dtype="bfloat16", pn_num_points=64,
                   pri3d_num_samples_per_image=16), **kw)
    return dataclasses.replace(base, **kw)


def _batch(cfg, seed, dev, batch_size=None):
    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch

    bs = batch_size or cfg.batch_size
    b = synthetic_contrast_batch(np.random.default_rng(seed), bs,
                                 size=cfg.crop_size, n_data=N_DATA)
    keys = ("rgbd", "index", "skeleton", "use_depth", "use_rgb",
            "depth_mask", "grid_xy", "depth_mean", "joints2d", "joints_vis")
    return {k: torch.from_numpy(b[k]).to(dev) for k in keys if k in b}


def _program(cfg, dev, graphed, monkeypatch, fuse=True):
    """Model, train state and step of cfg from fixed seeds; the step's
    encoders graphed or not."""
    from hcmoco_tpu_torch.train.state import create_train_state

    monkeypatch.setenv("HCMOCO_CONVBN_FUSE", "1" if fuse else "0")
    torch.manual_seed(0)
    model = build_model(cfg, device=dev).to(memory_format=torch.channels_last)
    state = create_train_state(cfg, model, torch.Generator(dev).manual_seed(0),
                               n_data=N_DATA, steps_per_epoch=100)
    with monkeypatch.context() as mp:
        if not graphed:
            mp.setattr(graphs, "install", lambda *a: None)
        step = contrast_step.make_contrast_train_step(cfg, model, 100)
    return model, state, step


def _run(cfg, dev, graphed, monkeypatch, steps=4, fuse=True, sizes=None):
    """`steps` steps on distinct batches (of `sizes`, one a step, where
    given): each step's metrics and every parameter's gradient as SGD
    got it, then the state after them (parameters, BN statistics and
    num_batches_tracked, momentum buffers, banks) and the encoders'
    replays."""
    model, state, step = _program(cfg, dev, graphed, monkeypatch, fuse)
    per_step = []
    for i, bs in enumerate(sizes or [None] * steps):
        m = step(state, _batch(cfg, 100 + i, dev, bs),
                 torch.Generator(dev).manual_seed(10 + i))
        per_step.append((
            {k: v.clone() for k, v in m.items() if torch.is_tensor(v)},
            {k: p.grad.clone() for k, p in model.named_parameters()}))
    final = {"state": {k: v.clone() for k, v in model.state_dict().items()},
             "momentum": {k: state.optimizer.state[p]["momentum_buffer"]
                          .clone() for k, p in model.named_parameters()},
             "banks": state.banks.clone()}
    replays = {n: graphs.of(m).replays() for n, m in model.named_children()
               if graphs.of(m) is not None}
    pools = [[e.pool for e in graphs.of(m).entries.values() if e is not None]
             for m in model.children() if graphs.of(m) is not None]
    return per_step, final, replays, pools


def _differ(a: dict, b: dict) -> list:
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


CASES = {
    "stage1 fused": (dict(arch="HRNet"), True),
    "stage1 plain": (dict(arch="HRNet"), False),
    "pn": (dict(arch="HRNetPN"), True),
    "pn remat": (dict(arch="HRNetPN", pn_remat=True), True),
    "stage2 fused": (dict(arch="HRNet", stage2=True), True),
    # the point cell's shapes
    "pn 320 bs64": (dict(arch="HRNetPN", crop_size=320, batch_size=64,
                         nce_k=16384, pn_num_points=4096), True),
}


def _assert_equal_runs(eager, got):
    for i, ((m0, g0), (m1, g1)) in enumerate(zip(eager[0], got[0])):
        assert _differ(m0, m1) == [], f"step {i + 1} metrics"
        assert _differ(g0, g1) == [], f"step {i + 1} gradients"
    for part in ("state", "momentum"):
        assert _differ(eager[1][part], got[1][part]) == [], part
    assert torch.equal(eager[1]["banks"], got[1]["banks"])
    assert eager[2] == {}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_step_equals_eager_bit_for_bit(monkeypatch, deterministic,
                                               case):
    """Run on the card only: four steps with the encoders graphed (the
    first eager, the second capturing, then replaying) equal the four
    eager steps bit for bit: metrics, gradients as SGD got them, the
    parameters, BN statistics, num_batches_tracked, momentum buffers and
    banks; each encoder's backward replays match its forward replays,
    and the encoders' graphs share one pool."""
    dev = _card()
    kw, fuse = CASES[case]
    cfg = _card_cfg(**kw)
    eager = _run(cfg, dev, False, monkeypatch, fuse=fuse)
    got = _run(cfg, dev, True, monkeypatch, fuse=fuse)
    _assert_equal_runs(eager, got)
    n_enc = 1 if kw["arch"] == "HRNetPN" else 2
    assert got[2] == {f"encoder{i + 1}": (3, 3) for i in range(n_enc)}
    pools = [p for enc in got[3] for p in enc]
    assert len(pools) == n_enc and len(set(pools)) == 1


@pytest.mark.cuda
def test_second_input_shape_captures_a_second_graph(monkeypatch,
                                                    deterministic):
    """Run on the card only: batches of 8, 8, 6, 6, 8, 6 capture one
    graph an encoder at each batch size, in a second pool, and the fifth
    and sixth steps replay the first and the second; backward replays
    match forward replays, and the six steps equal the eager steps bit
    for bit."""
    dev = _card()
    cfg = _card_cfg(arch="HRNet")
    sizes = (8, 8, 6, 6, 8, 6)
    eager = _run(cfg, dev, False, monkeypatch, sizes=sizes)
    got = _run(cfg, dev, True, monkeypatch, sizes=sizes)
    _assert_equal_runs(eager, got)
    assert got[2] == {"encoder1": (4, 4), "encoder2": (4, 4)}
    # per encoder: bs8's entry, then bs6's; each key's pool holds both
    # encoders' graphs of it
    (a8, a6), (b8, b6) = got[3]
    assert a8 == b8 and a6 == b6 and a8 != a6


@pytest.mark.cuda
def test_graphed_step_peak_memory_within_one_percent(monkeypatch):
    """Run on the card only: at the point cell's shapes (HRNetPN W18
    320x320 bs64, 4096 points, fused) the peak allocated memory of a
    step that replays is within 1% of an eager step's: the graphs keep
    the captured activations allocated, so the count does not fall."""
    dev = _card()
    cfg = _card_cfg(arch="HRNetPN", crop_size=320, batch_size=64,
                    nce_k=16384, pn_num_points=4096)
    peaks = {}
    for graphed in (False, True):
        model, state, step = _program(cfg, dev, graphed, monkeypatch)
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            step(state, _batch(cfg, 300 + i, dev),
                 torch.Generator(dev).manual_seed(i))
        torch.cuda.synchronize()
        peaks[graphed] = (torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_reserved())
        if graphed:
            assert graphs.of(model.encoder1).replays() == (2, 2)
        del model, state, step
        torch.cuda.empty_cache()
    print(f"peak allocated / reserved bytes: eager {peaks[False]}, "
          f"graphed {peaks[True]}")
    assert abs(peaks[True][0] / peaks[False][0] - 1) <= 0.01
