"""What the harness's CPU tests share: a copy of the benchmark in a
temporary root with tiny cells of the configuration (width-4 HRNet,
32x32 crops, 8 samples, a 64-row bank above a lowered counts_max_n_data,
so that the NCE takes the cell's 'gather' path, float32, the fused path
off), held to the limits of the real cell: `tiny.t8` as configured, and
`tinypn.p64` on the point-cloud architecture (HRNetPN, the stage-1
recipe's) with clouds of 64 points, the traffic's `pn_num_points`
overriding the recipe's 4096.  At 64 points the SA levels hold 64, 16, 4
and 1 centers, so the last FP level interpolates from fewer than three
known points."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = dict(width=4, crop_size=32, nce_k=15, n_data=64, batch_size=8,
            counts_max_n_data=32, compute_dtype="float32")
# HRNetPN's stage-1 recipe, with the sizes the reference reads
PN = dict(recipe="first_stage/ntumpiirgbd2s_hrnetpn_w18", arch="HRNetPN",
          pn_num_points=4096, pn_ori_h=424.0, pn_ori_w=512.0)
FEED = {"batch_size": 8, "pool": 3, "depth_ratio": 0.5}
# tiny workload -> (configuration, real cell whose limits it takes, its
# configuration's train fields, its traffic)
CELLS = {"tiny.t8": ("hrnet_w18_s1", "hrnet_w18_s1.b224", {}, FEED),
         "tinypn.p64": ("hrnet_w18_s1", "hrnet_w18_s1.b224", PN,
                        dict(FEED, pn_num_points=64))}


def tiny_root(tmp: Path) -> Path:
    """tmp holding BENCHMARK.json and h100_bench/ with the tiny cells."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "h100_bench", tmp / "h100_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    for name, (config, real, train, feed) in CELLS.items():
        conf_name, traffic = name.split(".")
        cfg = json.loads((REPO / configs[config]["file"]).read_text())
        cfg["train"].update(train, **TINY)
        cfg["env"] = {"HCMOCO_CONVBN_FUSE": "0"}
        path = f"h100_bench/configs/{conf_name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        (tmp / f"h100_bench/traffic/{traffic}.json").write_text(
            json.dumps(feed))
        shutil.copy(tmp / f"h100_bench/limits/{real}.json",
                    tmp / f"h100_bench/limits/{name}.json")
        bench["configs"].append(dict(configs[config], name=conf_name,
                                     file=path, reduced=cfg["reduced"]))
        bench["workloads"].append(dict(name=name, config=conf_name,
                                       traffic=traffic, chips=1,
                                       why="test"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def port_model_f64(model):
    """The port's model with its two encoders in float64 (SemGCN and the
    heads stay float32, as the program keeps them)."""
    import torch

    for enc in (model.encoder1, model.encoder2):
        enc.double()
        for m in enc.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    return model
