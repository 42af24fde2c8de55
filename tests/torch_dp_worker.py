"""One rank of the port's data-parallel tests, and the one-process run
they are held to.

    RANK=r WORLD_SIZE=w MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dp_worker.py SPEC OUT

joins a gloo process group of w ranks on the CPU, runs every case of SPEC
(a torch.save'd list, see run_case) on this rank's rows of each global
batch and torch.saves {case name: result} to OUT.  It imports torch and
the port only.  The tests call run_case in their own process, with no
process group, for the one-process run.

    ... python tests/torch_dp_worker.py --clis SPEC OUT

runs, in turn, each (which, argv, port) of SPEC instead:
cli/main_contrast.py's main (`contrast`; main_segmentor's with
`segmentor`, a downstream trainer's with `seg` or `a2j`) on argv, which
joins a group at that MASTER_PORT (under a SLURM job step's variables:
at the SLURM_JOB_ID that maps to that port) and leaves it, and saves the
list of this rank's states as each main() restored it (before the first
step) and as it ended, and where it joined.
"""

import os
import sys
from contextlib import contextmanager

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config  # noqa: E402
from hcmoco_tpu_torch.models.build import build_model  # noqa: E402
from hcmoco_tpu_torch.models.heads import FCNHead, MaskedBatchNorm  # noqa: E402
from hcmoco_tpu_torch.models.hrnet import set_convbn_fuse  # noqa: E402
from hcmoco_tpu_torch.parallel import mesh  # noqa: E402
from hcmoco_tpu_torch.parallel.batchnorm import (  # noqa: E402
    GlobalBatchNorm1d, GlobalBatchNorm2d)
from hcmoco_tpu_torch.train.contrast_step import (  # noqa: E402
    make_contrast_train_step)
from hcmoco_tpu_torch.train.segment_step import (  # noqa: E402
    make_segment_train_step)
from hcmoco_tpu_torch.train.state import create_train_state  # noqa: E402
from torch_dp_common import SLURM_PORT0, ranks_formula  # noqa: E402


def _load_params(module, sd):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(sd[name])


def run_bn_case(case: dict) -> dict:
    """One BN layer in training on this rank's rows of x (and of the
    per-sample mask for 'masked'), then the backward of sum(out * g).
    case: module 'bn1d' | 'bn2d' | 'masked'; x, g (global); mask; weight,
    bias.  Returns this rank's out and dx, its shares of dweight and
    dbias, and the running statistics."""
    rank, size = mesh.world()
    c = case["x"].shape[1]
    bn = {"bn1d": GlobalBatchNorm1d, "bn2d": GlobalBatchNorm2d,
          "masked": MaskedBatchNorm}[case["module"]](c)
    with torch.no_grad():
        bn.weight.copy_(case["weight"])
        bn.bias.copy_(case["bias"])
    rows = {"x": case["x"], "g": case["g"]}
    if case.get("mask") is not None:
        rows["mask"] = case["mask"]
    local = mesh.shard_rows(rows, rank, size)
    x = local["x"].clone().requires_grad_(True)
    out = bn(x, local["mask"]) if "mask" in local else bn(x)
    (out * local["g"]).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def port_f64(model: torch.nn.Module, heads: bool = False
             ) -> torch.nn.Module:
    """The model's ResNet / CMCResNet / ResNeSt encoders in float64
    (parameters, BN statistics and compute), and with `heads` the whole
    model; else its heads stay f32, as the JAX package's ProjectionHead
    computes in f32 (tests/torch_baseline_common.py says why)."""
    from hcmoco_tpu_torch.models.resnest import ResNeSt
    from hcmoco_tpu_torch.models.resnet import CMCResNet, ResNet

    for enc in model.modules():
        if heads or isinstance(enc, (ResNet, CMCResNet, ResNeSt)):
            enc.double()
            for m in enc.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = torch.float64
    return model


# the CPU tests' small ResNeSt: one block a stage, ResNeSt-50's stem
SMALL_RESNEST = dict(layers=(1, 1, 1, 1), stem_width=32)


@contextmanager
def small_resnest():
    """Inside, the port's build_model builds arch 'resnest50' as the small
    ResNeSt (SMALL_RESNEST) at its width and input channels."""
    from hcmoco_tpu_torch.models import build
    from hcmoco_tpu_torch.models.resnest import ResNeSt

    make = build.make_resnet

    def patched(name, in_channel=3, dtype=torch.bfloat16):
        if name != "resnest50":
            return make(name, in_channel, dtype)
        return ResNeSt(in_channel=in_channel, dtype=dtype, **SMALL_RESNEST)

    build.make_resnet = patched
    try:
        yield
    finally:
        build.make_resnet = make


def run_case(case: dict) -> dict:
    """Steps of one case on this rank's rows.

    case: name; kind 'contrast' | 'segment'; cfg (TrainConfig kwargs);
    fuse (HCMOCO_CONVBN_FUSE's path); f64 (the baselines' model in
    float64, port_f64 with its heads); small_resnest (arch 'resnest50'
    built as SMALL_RESNEST); n_data; model / classifier (state dicts) and banks,
    or for mem='moco' queues, to start from (the moco key encoder starts
    as the model); batches (global batch dicts of tensors); sync (per
    step: None, or {'model', 'classifier', 'banks'} whose parameters and
    banks the step starts from); gen_seed (None: the batches pin every
    draw; else step i draws from a generator seeded gen_seed + i).
    Returns per step: metrics (floats), model and classifier state dicts,
    banks, the collectives issued (none in one process); for moco the queues, the pointer and the key encoder's
    parameters instead of the banks.  A case of kind 'bn' is
    run_bn_case's."""
    if case["kind"] == "bn":
        return run_bn_case(case)
    if case.get("small_resnest"):
        with small_resnest():
            return run_case(dict(case, small_resnest=False))
    rank, size = mesh.world()
    cfg = resolve_config(TrainConfig(**case["cfg"]))
    model = set_convbn_fuse(build_model(cfg, device="cpu"),
                            case.get("fuse", False))
    model.load_state_dict(case["model"], strict=True)
    if case.get("f64"):
        port_f64(model, heads=True)
    classifier = None
    if case["kind"] == "segment":
        classifier = FCNHead(128, cfg.n_class)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=case["n_data"], steps_per_epoch=1,
                               classifier=classifier)
    if classifier is not None:
        classifier.load_state_dict(case["classifier"], strict=True)
    with torch.no_grad():
        if state.moco is not None:
            state.moco.queues.copy_(case["queues"])
        else:
            state.banks.copy_(case["banks"])
    if classifier is None:
        step = make_contrast_train_step(cfg, model, steps_per_epoch=1)
    else:
        step = make_segment_train_step(cfg, model, classifier,
                                       steps_per_epoch=1)
    out = {"metrics": [], "model": [], "classifier": [], "banks": [],
           "collectives": []}
    for i, batch in enumerate(case["batches"]):
        sync = (case.get("sync") or [None] * len(case["batches"]))[i]
        if sync is not None:
            _load_params(model, sync["model"])
            if classifier is not None:
                _load_params(classifier, sync["classifier"])
            with torch.no_grad():
                state.banks.copy_(sync["banks"])
        local = mesh.shard_rows(batch, rank, size, max(cfg.microbatch, 1))
        gen = None
        if case.get("gen_seed") is not None:
            gen = torch.Generator().manual_seed(case["gen_seed"] + i)
        calls = mesh.STATS["calls"]
        m = step(state, local, gen)
        out["collectives"].append(mesh.STATS["calls"] - calls)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["model"].append({k: v.clone() for k, v in
                             model.state_dict().items()})
        if classifier is not None:
            out["classifier"].append({k: v.clone() for k, v in
                                      classifier.state_dict().items()})
        if state.moco is not None:
            out.setdefault("queues", []).append(state.moco.queues.clone())
            out.setdefault("ptr", []).append(state.moco.ptr)
            out.setdefault("key_model", []).append(
                {k: v.detach().clone() for k, v in
                 state.key_model.named_parameters()})
        else:
            out["banks"].append(state.banks.clone())
    return out


def one_process(case: dict, world: int) -> dict:
    """run_case in this process (no process group) on the case as the
    world of `world` ranks runs it: scl_groups 0, one SCL group a rank,
    is `world` groups there, and BN takes the ranks' variance formula
    (torch_dp_common.ranks_formula).  The ranks differ from this
    run by the order of their f32 sums alone."""
    if case["kind"] != "bn" and not case["cfg"].get("scl_groups"):
        case = dict(case, cfg=dict(case["cfg"], scl_groups=world))
    with ranks_formula():
        return run_case(case)


def _snapshot(state) -> dict:
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "banks": state.banks.clone(), "step": state.step}


def run_cli(which: str, argv: list) -> dict:
    """One rank of a CLI run (see the module docstring); `which` also
    takes the downstream trainers, 'seg' and 'a2j', whose end is their
    model's state dict and each step's metrics."""
    if which in ("seg", "a2j"):
        return run_downstream(which, argv)
    if which == "segmentor":
        from hcmoco_tpu_torch.cli.main_segmentor import main as cli_main
    else:
        from hcmoco_tpu_torch.cli.main_contrast import main as cli_main
    seen = {}
    result = cli_main(argv, on_ready=lambda st: seen.update(
        ready=_snapshot(st), joined=dict(mesh.JOINED)))
    seen["end"] = _snapshot(result.state)
    seen["steps"] = len(result.step_s)
    return seen


def run_clis(spec_path: str, out_path: str) -> None:
    """This rank's run_cli of every (which, argv, port) in the spec, each
    CLI in the process group at that port."""
    torch.set_num_threads(1)
    out = []
    for which, argv, port in torch.load(spec_path, weights_only=False):
        if "RANK" in os.environ:
            os.environ["MASTER_PORT"] = str(port)
        else:  # a SLURM job step: the port follows from the job id
            os.environ["SLURM_JOB_ID"] = str(port - SLURM_PORT0)
        out.append(run_cli(which, argv))
    torch.save(out, out_path)


def run_downstream(which: str, argv: list) -> dict:
    """A downstream trainer's main on argv: its model's final state dict
    and each step's metrics."""
    if which == "seg":
        from hcmoco_tpu_torch.downstream.seg.train import main as cli_main
    else:
        from hcmoco_tpu_torch.downstream.a2j.train import main as cli_main
    run = cli_main(argv)
    return {"model": {k: v.clone() for k, v in
                      run.model.state_dict().items()},
            "metrics": run.metrics, "scores": run.scores}


def main(spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    mesh.init_distributed(backend="gloo", device="cpu", timeout_s=100)
    try:
        spec = torch.load(spec_path, weights_only=False)
        results = {case["name"]: run_case(case) for case in spec}
        torch.save(results, out_path)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    if sys.argv[1] == "--clis":
        run_clis(*sys.argv[2:4])
    else:
        main(*sys.argv[1:3])
