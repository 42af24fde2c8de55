"""CPU tests of the benchmark's yardstick: cells found by name, the
contract of BENCHMARK.json, the roofline formulas, the frozen input
generator, and what the harness process imports."""

import json
import math
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from h100bench_common import REPO

from h100_bench import cells, checks, roofline, traffic

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
])
def test_a_missing_file_fails_by_name(tmp_path, what, edit, message):
    bench = json.loads(json.dumps(BENCH))
    edit(bench)
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench")
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


def test_the_checks_groups_hold_the_fused_sites():
    """The check's layer groups: each encoder's fused group holds the
    conv and BN leaves of the 40 sites that K1 runs."""
    groups = checks.leaf_groups(cells.load_cell(REPO,
                                                "hrnet_w18_s1.b224").run)
    sizes = {}
    for g in groups.values():
        sizes[g] = sizes.get(g, 0) + 1
    sites = len(roofline.convbn_sites(18, 320))
    assert sizes["encoder1.convbn"] == sizes["encoder2.convbn"] == 3 * sites
    assert set(sizes) == {"encoder1.convbn", "encoder1.other",
                          "encoder2.convbn", "encoder2.other", "encoder3",
                          "heads"}


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
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
              "import h100_bench.reference.models, "
              "h100_bench.reference.step; "
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "hcmoco_tpu",
                      "hcmoco_tpu_torch"}
    for path in (REPO / "h100_bench" / "reference").glob("*.py"):
        assert "hcmoco_tpu" not in path.read_text(), path.name


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_recorded_flops_are_the_references(workload):
    """The configuration's forward FLOPs a sample, counted again over the
    plain reference at batch 1 (~20 s for HRNet-W18 at 320^2)."""
    from h100_bench import flops

    cell = cells.load_cell(REPO, workload)
    assert flops.forward_flops(cell.run) == \
        cell.config["forward_flops_per_sample"]
