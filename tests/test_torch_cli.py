"""The port's pre-training CLI (cli/main_contrast.py), its pack CLI and its
MetricLogger, on the CPU at tiny size (width-4 HRNet, 32^2 crops, f32).

- config_from_args equals the JAX CLI's for every stage recipe with
  overrides, field for field.
- main([... '--device', 'cpu']) runs the user's journeys on --synthetic
  data and on the fixture trees (files and a pack): two epochs of stage 1,
  --resume for a third (the restored step and banks are the saved ones),
  then stage 2 with --pretrain (the printed graft counts are the stage-1
  model's parameters and BN statistics).  Checked: the TSV's header and
  lines, the checkpoint files, the counts.
- The refusals: no card without --device cpu, n_data above
  counts_max_n_data before the model is built, and the flags whose ROADMAP
  item is not ported.
- --alpha reaches the moco key encoder's EMA (a MoCo step on folder data),
  and the weights --IN_Pretrain or --pretrain load reach its start.
- MetricLogger's stdout lines and TSV equal the JAX package's.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from hcmoco_tpu.cli import main_contrast as jax_cli
from hcmoco_tpu.cli import pack_ntu as jax_pack_cli
from hcmoco_tpu.utils.meters import MetricLogger as JaxMetricLogger

from hcmoco_tpu_torch.cli import main_contrast as cli
from hcmoco_tpu_torch.cli import pack_ntu as pack_cli
from hcmoco_tpu_torch.core import config
from hcmoco_tpu_torch.data.fixtures import (make_image_folder_fixture,
                                            make_mpii_fixture,
                                            make_ntu_fixture)
from hcmoco_tpu_torch.parallel import mesh
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager
from hcmoco_tpu_torch.train.contrast_step import STAGE2_METRICS
from hcmoco_tpu_torch.utils.meters import MetricLogger

torch.set_num_threads(1)

PORT_FIELDS = [f.name for f in config.dataclasses.fields(config.TrainConfig)]
STAGE_RECIPES = sorted(config.RECIPES)
OVERRIDES = [
    [],
    ["--batch_size", "8", "--width", "4", "--cosine", "--crop_size", "32"],
    ["--lr_decay_epochs", "3,5", "--random_flip", "0", "--seed", "3",
     "--not_use_weighted_sampler", "--mask_seg_depth", "--warm"],
    ["--method", "CMCRGBD2S", "--nce_k", "15", "--modality_missing", "0",
     "--compute_dtype", "float32", "--model_path", "/x", "--resume", "auto",
     "--pretrain", "/y", "--save_freq", "2", "--print_freq", "1"],
]
TINY = ["--width", "4", "--crop_size", "32", "--batch_size", "4",
        "--nce_k", "15", "--compute_dtype", "float32", "--print_freq", "2",
        "--device", "cpu"]
STAGE1_METRICS = ["learning_rate", "loss"] + sorted(
    f"nce_{m}_{d}" for m in ("acc", "loss")
    for d in ("12", "21", "23", "32", "13", "31"))


@pytest.mark.parametrize("overrides", range(len(OVERRIDES)))
@pytest.mark.parametrize("recipe", STAGE_RECIPES + [""])
def test_config_from_args_matches_jax(recipe, overrides):
    argv = (["--recipe", recipe] if recipe else []) + OVERRIDES[overrides]
    got = cli.config_from_args(cli.build_argparser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_argparser().parse_args(argv))
    for name in PORT_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.model_name == want.model_name


@pytest.mark.parametrize("argv,exc,match", [
    # --multihost with neither torchrun's nor a SLURM step's environment
    pytest.param(["--multihost"], RuntimeError, "torchrun.*SLURM.*srun",
                 id="argv0-item 10"),
    pytest.param(["--supervise_type", "1"], NotImplementedError, "item 12",
                 id="argv1-item 12"),
    pytest.param(["--n_class", "3"], NotImplementedError, "item 12",
                 id="argv2-item 12"),
])
def test_unported_flags_raise(argv, exc, match, monkeypatch):
    for k in mesh.TORCHRUN_ENV + mesh.SLURM_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(exc, match=match):
        cli.main(["--synthetic", "8", "--device", "cpu"] + argv)


def _trace_spans(trace_dir: str) -> list:
    """The `global_step N` spans of the one trace file under trace_dir,
    which holds the CPU's activity and the program's spans."""
    import glob
    import json

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    program = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"data_wait", "upload", "forward", "nce", "backward",
            "bank_update", "optimizer", "grad_sync", "metrics"} <= program
    return sorted(e["name"] for e in events
                  if e.get("name", "").startswith("global_step "))


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    """--profile_dir traces global steps 10-15 as the JAX CLI's
    jax.profiler trace does (torch.profiler, CPU activity on the CPU):
    a 16-step run writes one trace whose step spans are those six, with
    the program's spans inside them, and says where; a 12-step run,
    which ends inside the window, writes what it traced (steps 10 and
    11) when it ends."""
    base = ["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18", "--synthetic",
            "64", "--epochs", "1"] + TINY
    for steps, want in ((16, range(10, 16)), (12, range(10, 12))):
        trace = str(tmp_path / f"trace{steps}")
        r = cli.main(base + ["--max_steps", str(steps), "--model_path",
                             str(tmp_path / f"save{steps}"), "--profile_dir",
                             trace])
        assert r.state.step == steps
        assert f"profiler trace written to {trace}" in capsys.readouterr().out
        assert _trace_spans(trace) == sorted(f"global_step {i}"
                                             for i in want)


def test_alpha_reaches_the_moco_ema(tmp_path):
    """--alpha 0.9 is cfg.alpha, as the JAX CLI parses it, and the moco
    key encoder's EMA: after a MoCo step on folder data every key
    parameter is 0.9 of its value before + 0.1 of the model's after.
    With --synthetic the moco CLI raises, naming the 3-channel source
    (ROADMAP.md Queue 3, F11)."""
    argv = ["--method", "MoCo", "--alpha", "0.9"]
    got = cli.config_from_args(cli.build_argparser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_argparser().parse_args(
        argv))
    assert got.alpha == want.alpha == 0.9 and got.mem == "moco"
    root = make_image_folder_fixture(str(tmp_path / "imgs"), 2, 4)
    seen = {}
    run = cli.main(argv + [
        "--arch", "resnet18", "--dataset", "folder", "--data_folder",
        os.path.join(root, "train"), "--crop_size", "32", "--batch_size",
        "4", "--nce_k", "16", "--compute_dtype", "float32", "--max_steps",
        "1", "--num_workers", "1", "--model_path", str(tmp_path / "save"),
        "--device", "cpu"], on_ready=lambda st: seen.update(
            {n: p.detach().clone()
             for n, p in st.key_model.named_parameters()}))
    state = run.state
    assert state.step == 1 and state.moco.ptr == 4
    model = dict(state.model.named_parameters())
    for n, p in state.key_model.named_parameters():
        # within an f32 rounding of the two products' sum
        torch.testing.assert_close(p, 0.9 * seen[n] + 0.1 * model[n],
                                   rtol=2.5e-7, atol=1e-8)
    with pytest.raises(ValueError, match="3-channel"):
        cli.main(argv + ["--synthetic", "8", "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--IN_Pretrain", "--pretrain"])
def test_loaded_weights_reach_the_moco_key_encoder(tmp_path, flag):
    """--IN_Pretrain (a ResNet-18 state dict under the reference names) and
    --pretrain (a port checkpoint) load the model, and the moco key
    encoder starts from the same weights (the reference's
    momentum_update(model, model_ema, 0)), not from the random init: at
    on_ready, before the first step, every key parameter equals the
    model's, and the loaded ones equal the file's."""
    from hcmoco_tpu_torch.models.build import build_model

    argv = ["--method", "MoCo", "--arch", "resnet18", "--crop_size", "32",
            "--batch_size", "4", "--nce_k", "16", "--compute_dtype",
            "float32"]
    torch.manual_seed(7)
    src = build_model(cli.config_from_args(cli.build_argparser().parse_args(
        argv)), device="cpu")
    path = str(tmp_path / "weights.pt")
    if flag == "--IN_Pretrain":
        torch.save(src.encoder.state_dict(), path)
        want = {f"encoder.{k}": v for k, v in
                src.encoder.state_dict().items()}
    else:
        want = src.state_dict()
        torch.save({"model": want}, path)
    root = make_image_folder_fixture(str(tmp_path / "imgs"), 2, 4)
    seen = {}

    def ready(st):
        model = dict(st.model.named_parameters())
        seen.update({n: (p.detach().clone(), model[n].detach().clone())
                     for n, p in st.key_model.named_parameters()})

    cli.main(argv + [
        flag, path, "--dataset", "folder", "--data_folder",
        os.path.join(root, "train"), "--max_steps", "1", "--num_workers",
        "1", "--model_path", str(tmp_path / "save"), "--device", "cpu"],
        on_ready=ready)
    loaded = [n for n in seen if n in want]
    assert len(loaded) > 10
    for n, (key, model) in seen.items():
        assert torch.equal(key, model), n
    for n in loaded:
        assert torch.equal(seen[n][1], want[n]), n


def test_without_a_card_main_raises(monkeypatch):
    """The CLI runs on the card unless asked for the CPU; it does not carry
    on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic", "8"] + TINY[:-2])


def test_n_data_above_counts_max_is_refused_at_start(tmp_path, monkeypatch):
    """No longer refused: a dataset above counts_max_n_data, which the CLI
    refused at start until the row-gather NCE was ported, trains through
    the 'gather' formulation (its memory does not grow with n_data)."""
    from hcmoco_tpu_torch.train import contrast_step

    modes = []
    nce_mode = contrast_step.nce_mode
    monkeypatch.setattr(contrast_step, "nce_mode",
                        lambda *a: modes.append(nce_mode(*a)) or modes[-1])
    n_data = config.TrainConfig().counts_max_n_data + 1
    r = cli.main(["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18",
                  "--synthetic", str(n_data),
                  "--max_steps", "1", "--model_path", str(tmp_path)] + TINY)
    assert r.n_data == n_data and r.state.banks.shape[1] == n_data
    assert r.state.step == 1 and modes == ["gather"]
    head, rows = _tsv(r.ckpt_dir)
    assert all(np.isfinite(float(v)) for v in rows[0])


def test_microbatch_runs_and_must_divide_the_batch(tmp_path):
    r = cli.main(["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18",
                  "--synthetic", "8", "--microbatch", "2", "--epochs", "1", "--model_path",
                  str(tmp_path)] + TINY)
    assert r.state.step == 2
    with pytest.raises(ValueError, match="does not divide"):
        cli.main(["--synthetic", "8", "--microbatch", "3"] + TINY)


def test_step_generator_depends_on_seed_and_step_alone():
    def draw(seed, step):
        return torch.rand(5, generator=cli.step_generator(seed, step, "cpu"))

    assert torch.equal(draw(1, 7), draw(1, 7))
    assert not torch.equal(draw(1, 7), draw(1, 8))
    assert not torch.equal(draw(1, 7), draw(2, 7))


def _tsv(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.tsv")) as f:
        head, *rows = [line.split("\t") for line in f.read().splitlines()]
    return head, rows


def _journey(tmp_path, data_args, steps_per_epoch):
    """Stage 1 for two epochs, resumed for a third, then stage 2 grafted
    from it; returns stage 1's RunResult."""
    save = str(tmp_path / "save")
    s1 = ["--recipe", "first_stage/ntumpiirgbd2s_hrnet_w18", "--model_path",
          save] + TINY + data_args
    r1 = cli.main(s1 + ["--epochs", "2"])
    assert (r1.start_epoch, r1.last_epoch) == (1, 2)
    assert r1.state.step == 2 * steps_per_epoch
    assert len(r1.step_s) == len(r1.wait_s) == 2 * steps_per_epoch
    mgr = CheckpointManager(r1.ckpt_dir)
    assert mgr.epochs() == [1, 2]
    saved = (r1.state.step, r1.state.banks.clone())
    seen = {}

    def on_ready(state):
        seen["step"] = state.step
        seen["banks"] = state.banks.clone()

    r2 = cli.main(s1 + ["--epochs", "3", "--resume", "auto"],
                  on_ready=on_ready)
    assert (r2.start_epoch, r2.last_epoch) == (3, 3)
    assert seen["step"] == saved[0] and torch.equal(seen["banks"], saved[1])
    assert r2.state.step == 3 * steps_per_epoch
    assert mgr.epochs() == [1, 2, 3]
    head, rows = _tsv(r1.ckpt_dir)
    assert head == ["epoch"] + STAGE1_METRICS
    assert [r[0] for r in rows] == ["1", "2", "3"]
    assert all(np.isfinite(float(v)) for r in rows for v in r)

    n_param = len(list(r1.state.model.parameters()))
    n_stat = sum(k.endswith(("running_mean", "running_var"))
                 for k in r1.state.model.state_dict())
    out = io.StringIO()
    steps = []
    with redirect_stdout(out):
        r3 = cli.main(["--recipe", "second_stage/ntumpiirgbd2s_hrnet_w18",
                       "--model_path", save, "--pretrain", r1.ckpt_dir,
                       "--epochs", "1", "--max_steps", "2"] + TINY
                      + data_args, on_step=steps.append)
    text = out.getvalue()
    assert steps == [1, 2] and r3.state.step == 2
    assert f"=> grafted {n_param} param tensors from " in text
    assert f"=> grafted {n_stat} batch-stat tensors from " in text
    assert "=> grafted memory banks" in text
    head, rows = _tsv(r3.ckpt_dir)
    assert set(STAGE2_METRICS) < set(head) and len(rows) == 1
    assert os.path.exists(os.path.join(r3.ckpt_dir, "epoch_1.pt"))
    return r1


def test_journey_on_synthetic_data(tmp_path):
    _journey(tmp_path, ["--synthetic", "16"], steps_per_epoch=4)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_trees"))
    ntu, lst = make_ntu_fixture(os.path.join(root, "ntu"), n_frames=9)
    mpii = make_mpii_fixture(os.path.join(root, "mpii"), n_images=3)
    return ["--data_folder", ntu, "--train_file_list", lst, "--mpii_root",
            mpii, "--num_workers", "2"]


def test_journey_on_fixture_trees(tmp_path, trees):
    """NTU + MPII files: 12 samples, 3 steps an epoch at batch 4."""
    r1 = _journey(tmp_path, trees, steps_per_epoch=3)
    assert r1.n_data == 12 and r1.steps_per_epoch == 3


def test_journey_on_a_pack(tmp_path, trees):
    """The NTU frames packed by cli/pack_ntu.py, which writes what the JAX
    pack CLI writes."""
    folder, lst = trees[1], trees[3]
    for mod, name in ((pack_cli, "pack"), (jax_pack_cli, "jax_pack")):
        mod.main(["--data_folder", folder, "--train_file_list", lst,
                  "--out_dir", str(tmp_path / name)])
    for f in ("rgb.npy", "depth.npy", "joints3d.npy", "joints_d.npy"):
        assert (open(tmp_path / "pack" / f, "rb").read()
                == open(tmp_path / "jax_pack" / f, "rb").read()), f
    r1 = _journey(tmp_path, trees + ["--packed_dir", str(tmp_path / "pack")],
                  steps_per_epoch=3)
    assert r1.n_data == 12


def test_metric_logger_matches_jax(tmp_path):
    """The same stdout lines and the same TSV as the JAX package's."""
    rng = np.random.default_rng(0)
    outs = []
    for cls, name in ((MetricLogger, "port"), (JaxMetricLogger, "jax")):
        log = cls(str(tmp_path / name), print_freq=2, tensorboard=False)
        buf = io.StringIO()
        with redirect_stdout(buf):
            for epoch in (1, 2):
                log.reset()
                for it in range(5):
                    log.log_step(epoch, it, 5, {
                        "loss": float(rng.standard_normal()),
                        "nce_acc_12": float(rng.random())}, n=4)
                log.write_epoch(epoch)
        log.close()
        outs.append((buf.getvalue(), open(
            tmp_path / name / "metrics.tsv").read()))
        rng = np.random.default_rng(0)
    assert outs[0] == outs[1]
    assert outs[0][0].count("Train: [") == 4
