"""The port's versatility CLI (cli/main_segmentor.py) and its export
journey on the CPU at tiny size (width-4 HRNet, 32^2 crops, f32): on
--synthetic data and from NTU + Parsing-4K fixture trees with per-epoch
validation, --resume, --pretrain from a stage-2 checkpoint of
cli/main_contrast.py, and cli/transfer_ckpt.py on its checkpoint; and the
versatility flags that the pre-training CLI refuses.  (The linear-probe
CLI's tests are tests/test_torch_linear.py.)"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from hcmoco_tpu.cli import main_contrast as jax_cli

from hcmoco_tpu_torch.cli import main_contrast, main_segmentor
from hcmoco_tpu_torch.cli import transfer_ckpt
from hcmoco_tpu_torch.core import config
from hcmoco_tpu_torch.core.config import HRNET_CONFIGS
from hcmoco_tpu_torch.data.fixtures import make_ntu_fixture, make_seg_fixture
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager
from hcmoco_tpu_torch.train.segment_step import SEGMENT_METRICS

torch.set_num_threads(1)

TINY = ["--width", "4", "--crop_size", "32", "--batch_size", "4",
        "--nce_k", "15", "--compute_dtype", "float32", "--print_freq", "1",
        "--device", "cpu"]
NCE = [f"nce_{m}_{d}" for m in ("acc", "loss")
       for d in ("12", "21", "23", "32", "13", "31")]
PORT_FIELDS = [f.name for f in config.dataclasses.fields(config.TrainConfig)]


def _run(argv, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        r = main_segmentor.main(argv, **kw)
    return r, out.getvalue()


def _tsv(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.tsv")) as f:
        head, *rows = [line.split("\t") for line in f.read().splitlines()]
    return head, rows


def test_synthetic_run_and_export(tmp_path):
    """The acceptance run: every step line carries loss_seg, the stage-2
    losses and the six NCE losses; transfer_ckpt turns its checkpoint
    into a .pth whose keys are a bare width-4 HRNet's, loading strictly."""
    r, text = _run(["--synthetic", "32", "--batch_size", "8", "--epochs",
                    "1", "--model_path", str(tmp_path)] + TINY[:4]
                   + TINY[6:])
    steps = [l for l in text.splitlines() if l.startswith("Train: [1]")]
    assert len(steps) == 4 == r.steps_per_epoch
    for line in steps:
        for k in ("loss_seg",) + SEGMENT_METRICS + tuple(NCE):
            assert f" {k} " in line, (k, line)
    assert r.state.step == 4 and r.ckpt_dir.endswith("_seg")
    head, rows = _tsv(r.ckpt_dir)
    assert "loss_seg" in head and all(np.isfinite(float(v)) for v in rows[0])
    assert r.val == [] and r.best_miou == -1.0  # no validation set
    for enc in ("encoder1", "encoder2"):
        out = str(tmp_path / f"{enc}.pth")
        transfer_ckpt.main(["--ckpt", r.ckpt_dir, "--encoder", enc, "--out",
                            out])
        bare = HRNet(HRNET_CONFIGS[4], 3, torch.float32)
        sd = torch.load(out, weights_only=True)
        assert set(sd) == set(bare.state_dict())
        bare.load_state_dict(sd, strict=True)
        assert torch.equal(sd["conv1.weight"], getattr(
            r.state.model, enc).conv1.weight.detach())


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seg_trees"))
    ntu, ntu_list = make_ntu_fixture(os.path.join(root, "ntu"), n_frames=6)
    seg, seg_list = make_seg_fixture(os.path.join(root, "seg"), ntu,
                                     n_frames=4)
    return ["--data_folder", ntu, "--train_file_list", ntu_list,
            "--seg_root", seg, "--seg_file_list", seg_list,
            "--seg_val_file_list", seg_list, "--num_workers", "2"]


@pytest.mark.parametrize("recipe", ["versatility/sup_rgbd",
                                    "versatility/sup_none"])
def test_run_from_fixture_trees_validates(tmp_path, seg_tree, recipe):
    """NTU + Parsing-4K frames (10 samples, 2 steps an epoch at batch 4),
    two epochs, each validated on the seg frames: three finite mIoU lines
    and the best of the --test_type head (rgbd)."""
    r, text = _run(["--recipe", recipe, "--epochs", "2", "--model_path",
                    str(tmp_path)] + TINY + seg_tree)
    assert r.n_data == 10 and r.steps_per_epoch == 2 and r.state.step == 4
    assert len(r.val) == 2
    for name in ("rgb", "d", "rgbd"):
        lines = [l for l in text.splitlines()
                 if l.startswith(f"val[{name}] mIoU ")]
        assert len(lines) == 2, name
        for res in r.val:
            assert set(res[name]) == {"aacc", "miou", "macc"}
            assert all(0.0 <= v <= 1.0 for v in res[name].values())
    assert r.best_miou == max(res["rgbd"]["miou"] for res in r.val)
    assert "new best rgbd mIoU" in text
    head, _ = _tsv(r.ckpt_dir)
    assert ("loss_seg" in head) == (recipe == "versatility/sup_rgbd")
    assert CheckpointManager(r.ckpt_dir).epochs() == [1, 2]


def test_resume_restores_classifier_and_banks(tmp_path):
    base = ["--synthetic", "8", "--model_path", str(tmp_path)] + TINY
    r1, _ = _run(base + ["--epochs", "1"])
    saved = (r1.state.step, r1.state.banks.clone(),
             {k: v.clone() for k, v in
              r1.state.classifier.state_dict().items()})
    seen = {}

    def on_ready(state):
        seen.update(step=state.step, banks=state.banks.clone(),
                    head={k: v.clone() for k, v in
                          state.classifier.state_dict().items()})

    r2, text = _run(base + ["--epochs", "2", "--resume", "auto"],
                    on_ready=on_ready)
    assert "=> resumed from epoch 1" in text
    assert (r2.start_epoch, r2.last_epoch) == (2, 2)
    assert seen["step"] == saved[0] == 2 and r2.state.step == 4
    assert torch.equal(seen["banks"], saved[1])
    for k, v in saved[2].items():
        assert torch.equal(seen["head"][k], v), k


def test_pretrain_from_a_stage2_checkpoint(tmp_path):
    """A stage-2 run of cli/main_contrast.py grafts every model tensor and
    the banks into the segmentor; its classifier keeps its initial
    weights (those of a run without --pretrain)."""
    stage2 = main_contrast.main(
        ["--recipe", "second_stage/ntumpiirgbd2s_hrnet_w18", "--synthetic",
         "8", "--epochs", "1", "--model_path", str(tmp_path / "s2")] + TINY)
    n_param = len(list(stage2.state.model.parameters()))
    heads = []

    def keep_head(state):
        heads.append({k: v.clone() for k, v in
                      state.classifier.state_dict().items()})
        if len(heads) == 2:
            assert torch.equal(state.model.encoder1.conv1.weight,
                               stage2.state.model.encoder1.conv1.weight)
            assert torch.equal(state.banks, stage2.state.banks)

    base = ["--synthetic", "8", "--epochs", "1", "--max_steps", "1",
            "--recipe", "versatility/sup_rgbd"] + TINY
    _run(base + ["--model_path", str(tmp_path / "a")], on_ready=keep_head)
    _, text = _run(base + ["--model_path", str(tmp_path / "b"),
                           "--pretrain", stage2.ckpt_dir],
                   on_ready=keep_head)
    assert f"=> grafted {n_param} param tensors from " in text
    assert "=> grafted memory banks" in text
    for k, v in heads[0].items():
        assert torch.equal(heads[1][k], v), k


@pytest.mark.parametrize("recipe", sorted(
    k for k in config.RECIPES if k.startswith("versatility/")))
def test_segmentor_config_matches_jax(recipe):
    """The segmentor's flags reach its config as the JAX CLI's do."""
    argv = ["--recipe", recipe, "--n_class", "7", "--supervise_type", "2",
            "--test_type", "1", "--cmc_loss_weights", "0.5",
            "--other_loss_weights", "2.0"]
    got = main_contrast.config_from_args(
        main_contrast.build_argparser().parse_args(argv),
        accept=main_contrast.SEGMENTOR_FIELDS)
    want = jax_cli.config_from_args(jax_cli.build_argparser().parse_args(
        argv))
    for name in PORT_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("flag,value", [
    ("--n_class", "3"), ("--supervise_type", "1"), ("--test_type", "2"),
    ("--cmc_loss_weights", "0.5"), ("--other_loss_weights", "2.0")])
def test_pretraining_cli_refuses_segmentor_flags(flag, value):
    with pytest.raises(NotImplementedError, match="main_segmentor"):
        main_contrast.main(["--synthetic", "8", flag, value] + TINY)


def test_segmentor_refusals(monkeypatch):
    with pytest.raises(ValueError, match="microbatch"):
        main_segmentor.main(["--synthetic", "8", "--microbatch", "2"]
                            + TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_segmentor.main(["--synthetic", "8"] + TINY[:-2])
