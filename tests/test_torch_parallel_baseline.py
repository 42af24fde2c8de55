"""The baselines under the port's data parallelism: two gloo ranks
(tests/torch_dp_worker.py, fresh processes importing torch and the port
only) against the port's one-process run of the same global batches and
draws (torch_dp_worker.one_process, BN with the ranks' formula), in one
spawn: MoCo (the queue, the EMA key encoder; no ShuffleBN permutation,
which under global BN changes only the order of a sum, ROADMAP.md Queue
3, F12) and CMC with jigsaw on banks (the negatives and
the patch orders drawn for the global batch, the bank update from every
rank's rows), and MoCo on the small ResNeSt (torch_dp_worker's
SMALL_RESNEST: global BN at SplAtConv2d's (B, 1, 1, C) attention sites,
8 rows a channel over the ranks).  Global batch 8, two steps each, the
draws from a generator seeded alike on every rank, the encoders in
float64 (torch_baseline_common says why).

The ranks: every metric, parameter, BN statistic, bank or queue, pointer
and key-encoder parameter equal bit for bit after every step.  Against
one process: rtol 1e-5, atol 3e-6 (tests/test_torch_parallel.py's
tolerance against the port's own one-process run); the pointer exactly.
"""

import contextlib

import numpy as np
import torch

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.models.build import build_model

from torch_dp_common import ranks_running
from torch_dp_worker import one_process, small_resnest

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=3e-6)
BSZ, CROP, PATCH, N_DATA = 8, 32, 16, 32


def make_case(name: str, kw: dict, seed: int,
              resnest: bool = False) -> dict:
    cfg = resolve_config(TrainConfig(**kw))
    torch.manual_seed(seed)
    with small_resnest() if resnest else contextlib.nullcontext():
        model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    moco = cfg.mem == "moco"
    batches = []
    for _ in range(2):
        c = 6 if moco else 3
        b = {"rgbd": torch.from_numpy(rng.standard_normal(
                 (BSZ, CROP, CROP, c))),
             # index 9 on both ranks: the later row's feature wins
             "index": torch.tensor([9, 1, 2, 3, 4, 9, 6, 7])}
        if cfg.jigsaw:
            b["rgbd_jig"] = torch.from_numpy(rng.standard_normal(
                (BSZ, 9, PATCH, PATCH, 3)))
        batches.append(b)
    mem = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal(
        (1 if cfg.modal == "RGB" else 2, cfg.nce_k if moco else N_DATA,
         128)).astype(np.float32)), dim=-1)
    case = {"name": name, "kind": "contrast", "cfg": kw, "f64": True,
            "small_resnest": resnest,
            "n_data": N_DATA, "model": model.state_dict(),
            "batches": batches, "gen_seed": 100 + seed}
    case["queues" if moco else "banks"] = mem
    return case


CASES = [
    make_case("moco", dict(method="MoCo", arch="resnet18", nce_k=16,
                           batch_size=BSZ, epochs=2,
                           compute_dtype="float32"), 0),
    make_case("cmc_jigsaw", dict(method="Customize", modal="CMC", mem="bank",
                                 jigsaw=True, arch="resnet18", nce_k=7,
                                 batch_size=BSZ, epochs=2,
                                 compute_dtype="float32"), 1),
    make_case("moco_resnest", dict(method="MoCo", arch="resnest50", nce_k=16,
                                   batch_size=BSZ, epochs=2,
                                   compute_dtype="float32"), 2,
              resnest=True),
]


def _flat(step: dict, i: int) -> dict:
    out = {f"metric {k}": torch.tensor(v) for k, v in
           step["metrics"][i].items()}
    out.update({f"model {k}": v for k, v in step["model"][i].items()})
    if "queues" in step:
        out["queues"] = step["queues"][i]
        out["ptr"] = torch.tensor(step["ptr"][i])
        out.update({f"key {k}": v for k, v in step["key_model"][i].items()})
    else:
        out["banks"] = step["banks"][i]
    return out


def test_two_ranks_match_one_process(tmp_path):
    with ranks_running(CASES, str(tmp_path), timeout=150) as results:
        one = {c["name"]: one_process(c, 2) for c in CASES}
        ranks = results()
    for case in CASES:
        name = case["name"]
        for i in range(len(case["batches"])):
            r0, r1 = (_flat(r[name], i) for r in ranks)
            ref = _flat(one[name], i)
            assert r0.keys() == r1.keys() == ref.keys()
            for k in ref:
                assert torch.equal(r0[k], r1[k]), (name, i, k)
                if k == "ptr":
                    assert int(r0[k]) == int(ref[k]) == (i + 1) * BSZ % 16
                elif not k.endswith("num_batches_tracked"):
                    np.testing.assert_allclose(
                        r0[k].double().numpy(), ref[k].double().numpy(),
                        **TOL, err_msg=f"{name} step {i} {k}")
