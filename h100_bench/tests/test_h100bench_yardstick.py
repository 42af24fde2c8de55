"""CPU tests of the benchmark's yardstick: cells found by name, the
contract of BENCHMARK.json, the roofline formulas, the frozen input
generator, an architecture found by name, and what the harness process
imports."""

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from h100bench_common import PN, REPO

from h100_bench import cells, checks, roofline, session, traffic, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(workload):
    cell = cells.load_cell(REPO, workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cells.reader(REPO, m["name"]))
    assert set(cell.limits) == set(checks.NAMES)


@pytest.mark.parametrize("what,edit,message", [
    ("workload", lambda b: b, "workload 'nope'"),
    ("traffic", lambda b: b["workloads"][0].update(traffic="gone"),
     "traffic 'gone'"),
    ("configuration", lambda b: b["configs"][0].update(file="h100_bench/"
                                                       "configs/gone.json"),
     "configuration 'hrnet_w18_s1'"),
    ("arch", lambda b: b["configs"][0].update(file="h100_bench/"
                                              "configs/gone_arch.json"),
     "arch 'Gone' of configuration 'hrnet_w18_s1'"),
])
def test_a_missing_file_fails_by_name(tmp_path, what, edit, message):
    bench = json.loads(json.dumps(BENCH))
    edit(bench)
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench")
    conf = json.loads((REPO / BENCH["configs"][0]["file"]).read_text())
    conf["train"]["arch"] = "Gone"
    (tmp_path / "h100_bench/configs/gone_arch.json").write_text(
        json.dumps(conf))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    name = "nope" if what == "workload" else BENCH["workloads"][0]["name"]
    with pytest.raises(cells.CellError, match=re.escape(message)):
        cells.load_cell(tmp_path, name)
    with pytest.raises(cells.CellError, match="metric 'gone'"):
        cells.reader(tmp_path, "gone")


def test_a_new_traffic_mix_is_new_files_only(tmp_path):
    """A cell on a traffic mix added as a data file, with a BENCHMARK.json
    entry and its limits file: no file of the harness changes."""
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench")
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "h100_bench").rglob("*") if p.is_file()}
    (tmp_path / "h100_bench/traffic/b112.json").write_text(json.dumps(
        {"batch_size": 112, "pool": 2, "depth_ratio": 0.25}))
    shutil.copy(tmp_path / "h100_bench/limits/hrnet_w18_s1.b224.json",
                tmp_path / "h100_bench/limits/hrnet_w18_s1.b112.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="hrnet_w18_s1.b112",
                                   config="hrnet_w18_s1", traffic="b112",
                                   chips=1, why="a throwaway mix"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell(tmp_path, "hrnet_w18_s1.b112")
    assert cell.run["batch_size"] == 112 and cell.run["pool"] == 2
    assert cell.run["width"] == 18
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "h100_bench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/")
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert set(m.get("workloads", ())) <= cell_names
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("kernel,ms,seconds", [
    ("K1 at 204800x64->256", 0.0391,
     lambda: roofline.k1_s(204800, 64, 256)),
    ("K1b forward at R 204800, C 256", 0.0626,
     lambda: roofline.k1b_s(204800, 256)[0]),
    ("K5 forward at (64,4096,32) -> (4096,32,32) bf16", 0.1753,
     lambda: roofline.k5_s(64, 4096, 4096, 32, 32, 2)[0]),
    ("K6 forward at pts2depth, (64,4096,128) -> 102400 f32", 1.0886,
     lambda: roofline.k6_s(64, 102400, 4096, 128, 4)[0]),
])
def test_roofline_bounds_match_the_kernel_table(kernel, ms, seconds):
    assert round(seconds() * 1e3, 4) == ms, kernel


def test_convbn_sites_are_the_fused_ones():
    sites = roofline.convbn_sites(18, 320)
    assert len(sites) == 40  # K1 launches a W18 HRNet
    fast = [s for s in sites if (s[1], s[2]) in ((64, 256), (256, 64),
                                                 (64, 64))]
    assert len(fast) == 9 and all(s[0] == 6400 for s in fast)
    assert sum(1 for s in sites if s == (1600, 36, 18)) == 8
    # the least time grows with the rows
    assert math.isclose(roofline.convbn_step_s(18, 320, 64, 2),
                        2 * roofline.convbn_step_s(18, 320, 32, 2),
                        rel_tol=0.05)


@pytest.mark.parametrize("train,hrnets,want", [
    ({}, ("encoder1", "encoder2"), {"encoder3": 48, "heads": 6}),
    (PN, ("encoder1",),
     {"encoder2.sa": 48, "encoder2.fp": 24, "encoder3": 48, "heads": 6})],
    ids=["HRNet", "HRNetPN"])
def test_the_checks_groups_hold_the_fused_sites(train, hrnets, want):
    """The check's layer groups, as each architecture's file names them:
    each HRNet's fused group holds the conv and BN leaves of the 40 sites
    that K1 runs; HRNetPN's PointNet++ is two groups, its four SA levels'
    shared MLPs (2 scales x 2 layers x 3 leaves a level) and its four FP
    levels' (2 layers x 3 leaves a level)."""
    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run, **train)
    sizes = {}
    for g in checks.leaf_groups(run).values():
        sizes[g] = sizes.get(g, 0) + 1
    sites = len(roofline.convbn_sites(18, 320))
    for enc in hrnets:
        assert sizes.pop(f"{enc}.convbn") == 3 * sites
        assert sizes.pop(f"{enc}.other") == 795
    assert sizes == want


def test_convbn_roofline_counts_the_cells_hrnets():
    """convbn_roofline's least time counts the fused sites of two HRNets
    for HRNet and of the one RGB HRNet for HRNetPN, whose PointNet++ runs
    no K1 (its MLPs are not 1x1 ConvBN sites of an HRNet)."""
    from h100_bench.context import Context
    from h100_bench.devtrace import Trace

    read = cells.reader(REPO, "convbn_roofline")
    base = cells.load_cell(REPO, "hrnet_w18_s1.b224").run
    trace = Trace(ops=[("mm_bn_kernel", 0, 10 ** 9)], window_s=1.0)
    for train, encoders in (({}, 2), (PN, 1)):
        run = dict(base, **train)
        ctx = Context(trace=trace, steps=3, samples=3 * 64, window_s=1.0,
                      rows=64, run=run, forward_flops=lambda: 0)
        least = roofline.convbn_step_s(18, 320, 64, 1) * 3
        assert read(ctx) == pytest.approx(100 * least * encoders)
        fused = sum(g.endswith(".convbn")
                    for g in checks.leaf_groups(run).values())
        assert fused == 3 * len(roofline.convbn_sites(18, 320)) * encoders


def test_generator_gives_the_programs_fields():
    """The device generator's fields have the layout, dtypes and ranges of
    the program's synthetic generator."""
    import torch

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch

    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run,
               batch_size=6, crop_size=48, n_data=100, nce_k=15)
    want = synthetic_contrast_batch(np.random.default_rng(5), 6, 48,
                                    n_data=100)
    got = traffic.make_pool(dict(run, pool=1), 5, "cpu")[0]
    for k, v in got.items():
        if k in want:
            assert tuple(v.shape) == want[k].shape, k
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    assert got["index"].min() >= 0 and got["index"].max() < 100
    assert float(got["skeleton"].abs().max()) <= 1.0
    depth = got["rgbd"][..., 3:]
    assert torch.equal(depth[..., 0], depth[..., 2])
    assert tuple(got["neg_idx"].shape) == (6, 16)
    assert torch.equal(got["neg_idx"][:, 0], got["index"].long())
    assert 0 <= int(got["neg_idx"].min()) and int(got["neg_idx"].max()) < 100


def test_cloud_fields_for_the_point_cloud_architecture():
    """HRNetPN's file lists the cloud fields, and the pool carries them
    beside the same fields an HRNet pool has, drawn alike: the depth's
    mask, the program's synthetic pixel grid, a depth mean over 2-4 m,
    and (B, pn_num_points) uniforms; every seed draws the same counts."""
    import torch

    from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch

    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run,
               batch_size=6, crop_size=48, n_data=100, nce_k=15, pool=2)
    pn = dict(run, **dict(PN, pn_num_points=96))
    want = synthetic_contrast_batch(np.random.default_rng(5), 6, 48,
                                    n_data=100)
    plain = traffic.make_pool(run, 5, "cpu")
    for seed in (5, 2 ** 31 + 17):
        pool = session.make_pool(pn, seed, "cpu")
        for i, b in enumerate(pool):
            if seed == 5:
                assert set(b) - set(plain[i]) == {"depth_mask", "grid_xy",
                                                  "depth_mean", "pts_u"}
                assert all(torch.equal(v, b[k])
                           for k, v in plain[i].items())
            for k in ("depth_mask", "grid_xy", "depth_mean"):
                assert tuple(b[k].shape) == want[k].shape, k
                assert str(b[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert torch.equal(b["grid_xy"][0],
                               torch.from_numpy(want["grid_xy"][0]))
            depth = b["rgbd"][..., 3]
            assert torch.equal(b["depth_mask"] == 0, depth == 0)
            assert torch.equal(b["depth_mask"].flatten(1).amax(1).int(),
                               b["use_depth"])
            assert 2 <= float(b["depth_mean"].min()) \
                and float(b["depth_mean"].max()) < 4
            assert tuple(b["pts_u"].shape) == (6, 96)
            assert 0 <= float(b["pts_u"].min()) \
                and float(b["pts_u"].max()) < 1
        assert not torch.equal(pool[0]["pts_u"], pool[1]["pts_u"])


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def test_hrnet_cell_draws_what_it_drew_before_architectures_had_files():
    """hrnet_w18_s1.b224's inputs as the harness made them before the
    architectures moved into files of their own (digests recorded there,
    on the CPU): its pool at a small batch and crop (no new field), its
    initial W18 state, its banks at 64 rows, and its layer groups.  Its
    FLOP count is the configuration's recorded one
    (test_recorded_flops_are_the_references)."""
    seed = 2 ** 31 + 5
    run = cells.load_cell(REPO, "hrnet_w18_s1.b224").run
    small = dict(run, batch_size=8, crop_size=32, n_data=64, nce_k=15)
    pool = traffic.make_pool(small, seed, "cpu")
    assert sorted(pool[0]) == ["index", "neg_idx", "rgbd", "skeleton",
                               "use_depth", "use_rgb"]
    assert _digest([b[k] for b in pool for k in sorted(b)]) \
        == "51603837f06bd6c6"
    assert _digest(weights.make_state(run, seed, "cpu").values()) \
        == "dc0850bea2f2d11c"
    assert _digest([weights.make_banks(small, seed, "cpu")]) \
        == "fa87ebbc6760ee39"
    groups = json.dumps(sorted(checks.leaf_groups(run).items()))
    assert hashlib.sha256(groups.encode()).hexdigest()[:16] \
        == "421a864ac4eaec4e"


STAND_IN = '''"""A stand-in architecture: HCMoCo with its heads and SemGCN
and one HRNet on RGB, written for a test."""
from torch import nn

from .. import models

FIELDS = ("depth_mean",)


class Model(nn.Module):
    def __init__(self, run, num):
        super().__init__()
        self.encoder1 = models.HRNet(run["width"], 3, num)
        self.encoder3 = models.SemGCN(128, 4, "mpii", num)
        total = sum(models.hrnet_stages(run["width"])[3].channels)
        self.head1, self.head3 = models.head(total, 128), models.head(128, 128)
        self.num = num

    def forward(self, batch):
        f1 = models.project(self.head1, models.pool(self.encoder1(
            batch["rgbd"].permute(0, 3, 1, 2)[:, :3])))
        f3 = models.project(self.head3, self.encoder3(
            batch["skeleton"]).mean(dim=1))
        return __import__("torch").stack([f1, f1 * batch["depth_mean"][:, None] / 3, f3])


def build(run, num):
    return Model(run, num)


def groups(model):
    return models.hrnet_groups(model, ("encoder1",))
'''

STAND_IN_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import h100_bench
assert h100_bench.__file__.startswith({root!r}), h100_bench.__file__
from h100_bench import cells, checks, flops, session, weights
from h100_bench.reference import models, step
run = cells.load_cell({root!r}, "standin_w4.t8").run
model = models.build(run, models.Numerics(checkpoint=False))
model.load_state_dict(weights.make_state(run, 3, "cpu"))
pool = session.make_pool(run, 3, "cpu")
out = step.reference_steps(model, weights.make_banks(run, 3, "cpu"), pool,
                           run)
print(json.dumps(dict(groups=sorted(set(checks.leaf_groups(run).values())),
                      fields=sorted(pool[0]), loss=out["loss"],
                      flops=flops.forward_flops(run))))
"""


def test_a_new_architecture_is_new_files_only(tmp_path):
    """A cell of an architecture added as reference/archs/<arch>.py, with
    its configuration, traffic and limits files and BENCHMARK.json's
    entries: the harness (imported from that root) builds it, makes its
    weights, banks and pool with the fields it lists, groups its leaves,
    counts its FLOPs and runs the reference's steps, and no file of the
    harness changes."""
    root = tmp_path / "bench"
    shutil.copytree(REPO / "h100_bench", root / "h100_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "h100_bench").rglob("*") if p.is_file()}
    (root / "h100_bench/reference/archs/StandIn.py").write_text(STAND_IN)
    conf = json.loads((REPO / BENCH["configs"][0]["file"]).read_text())
    conf["train"].update(arch="StandIn", width=4, crop_size=32, nce_k=15,
                         n_data=64)
    (root / "h100_bench/configs/standin_w4.json").write_text(
        json.dumps(conf))
    (root / "h100_bench/traffic/t8.json").write_text(json.dumps(
        {"batch_size": 8, "pool": 3, "depth_ratio": 0.5}))
    shutil.copy(root / "h100_bench/limits/hrnet_w18_s1.b224.json",
                root / "h100_bench/limits/standin_w4.t8.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(BENCH["configs"][0], name="standin_w4",
                                 file="h100_bench/configs/standin_w4.json"))
    bench["workloads"].append(dict(name="standin_w4.t8", config="standin_w4",
                                   traffic="t8", chips=1, why="a stand-in"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", STAND_IN_SCRIPT.format(root=str(root))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["groups"] == ["encoder1.convbn", "encoder1.other", "encoder3",
                             "heads"]
    assert got["fields"] == ["depth_mean", "index", "neg_idx", "rgbd",
                             "skeleton", "use_depth", "use_rgb"]
    assert len(got["loss"]) == 3 and all(map(math.isfinite, got["loss"]))
    assert got["flops"] > 0
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "h100_bench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_pool_gives_every_seed_the_same_work():
    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run,
               batch_size=8, crop_size=32, n_data=64, nce_k=15)
    for seed in (0, 2 ** 31 + 11):
        pool = traffic.make_pool(run, seed, "cpu")
        assert len(pool) == run["pool"]
        for b in pool:
            assert int(b["use_depth"].sum()) == 4
            assert tuple(b["neg_idx"].shape) == (8, 16)
        again = traffic.make_pool(run, seed, "cpu")
        assert all(bool((a[k] == b[k]).all()) for a, b in zip(pool, again)
                   for k in a)
    a, b = traffic.make_pool(run, 1, "cpu"), traffic.make_pool(run, 2, "cpu")
    assert not bool((a[0]["rgbd"] == b[0]["rgbd"]).all())


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import h100_bench.run, h100_bench.session, h100_bench.flops
import h100_bench.reference.models, h100_bench.reference.step
import hcmoco_tpu_torch.models.build, hcmoco_tpu_torch.train.contrast_step
import hcmoco_tpu_torch.train.state, hcmoco_tpu_torch.parallel.mesh
from h100_bench import cells
import json
bench = json.load(open({bench!r}))
for m in bench["per_layer"]:
    cells.reader({root!r}, m["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_harness_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(REPO),
                                             bench=str(REPO / "BENCHMARK"
                                                       ".json"))],
        capture_output=True, text=True, timeout=120, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "hcmoco_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    """The reference, every architecture's file under reference/archs/
    included, loads neither JAX nor the JAX package nor the program, and
    no file of it names either package."""
    archs = sorted(p.stem for p in (REPO / "h100_bench/reference/archs")
                   .glob("*.py") if p.stem != "__init__")
    assert {"HRNet", "HRNetPN"} <= set(archs)
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
              "import h100_bench.reference.models, "
              "h100_bench.reference.step; "
              "from h100_bench.reference.models import arch; "
              f"[arch(a) for a in {archs!r}]; "
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "hcmoco_tpu",
                      "hcmoco_tpu_torch"}
    for path in (REPO / "h100_bench" / "reference").rglob("*.py"):
        assert "hcmoco_tpu" not in path.read_text(), path.name


def _mlp_flops(rows: int, channels) -> int:
    return sum(2 * rows * a * b for a, b in zip(channels[:-1], channels[1:]))


def test_point_cloud_flops_count_the_mlps_alone():
    """HRNetPN's forward FLOPs count convolutions and products alone: its
    PointNet++ reads as its shared MLPs in closed form (each SA scale on
    centers x samples rows, each FP level on its unknown points), with
    nothing for FPS, ball query or three-NN, and the whole model counts
    no op but products and convolutions."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference import models
    from h100_bench.reference.archs import HRNetPN as pn

    n = 256
    run = dict(cells.load_cell(REPO, "hrnet_w18_s1.b224").run, **PN)
    run.update(width=4, crop_size=32, batch_size=1, pool=1, depth_ratio=1.0,
               n_data=64, pn_num_points=n)
    model = models.build(run, models.Numerics(checkpoint=False))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(session.make_pool(run, 0, "cpu")[0])
    counts = counter.get_flop_counts()
    ops = {str(op) for op in counts["Global"]}
    assert ops <= {"aten.mm", "aten.addmm", "aten.bmm", "aten.convolution"}
    want, cin, skip = 0, 0, [0]
    for k in range(4):
        for s, m in zip(pn.NSAMPLE[k], pn.MLPS[k]):
            want += _mlp_flops(max(n // 4 ** k, 1) * s, (cin + 3,) + m)
        cin = sum(m[-1] for m in pn.MLPS[k])
        skip.append(cin)
    # FP level k's unknown points are level k's input: the cloud for
    # k = 0, SA level k - 1's centers after
    for k in range(4):
        pre = pn.FP_MLPS[k + 1][-1] if k < 3 else cin
        want += _mlp_flops(n if k == 0 else max(n // 4 ** (k - 1), 1),
                           (pre + skip[k],) + pn.FP_MLPS[k])
    enc2 = [v for k, v in counts.items() if k.endswith(".encoder2")]
    assert len(enc2) == 1 and sum(enc2[0].values()) == want


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_recorded_flops_are_the_references(workload):
    """The configuration's forward FLOPs a sample, counted again over the
    plain reference at batch 1 (~20 s for HRNet-W18 at 320^2)."""
    from h100_bench import flops

    cell = cells.load_cell(REPO, workload)
    assert flops.forward_flops(cell.run) == \
        cell.config["forward_flops_per_sample"]
