"""The port's linear probe (cli/main_linear.py) on the CPU: its first step
on --synthetic data against the JAX CLI's (the same initial encoder and
classifier: the test records what the JAX CLI's inits return and carries
it into the port): the classifier
after SGD at rtol 1e-4, atol 1e-5 and the validation's top-1/top-5 as the
JAX CLI prints them; then the user's journey on an ImageFolder tree:
pre-train InsDis with main_contrast, probe with --pretrain (the encoder
loaded and left frozen)."""

import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from hcmoco_tpu.cli import main_linear as jax_linear
from hcmoco_tpu.models.build import SingleModalModel as JaxSingleModal
from hcmoco_tpu.models.heads import LinearClassifier as JaxLinear

from hcmoco_tpu_torch.cli import main_contrast, main_linear
from hcmoco_tpu_torch.data.fixtures import make_image_folder_fixture
from hcmoco_tpu_torch.export.convert import (baseline_flax_to_torch,
                                             linear_flax_to_torch)
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ARGS = ["--modal", "RGB", "--arch", "resnet18", "--crop_size", "32",
        "--batch_size", "8", "--n_class", "4", "--compute_dtype", "float32",
        "--epochs", "1", "--max_steps", "1", "--print_freq", "1",
        "--seed", "3"]


def acc_line(out: str) -> str:
    return re.search(r"\* epoch 1 (Acc@1 \S+ Acc@5 \S+)", out).group(1)


def test_main_linear_first_step_matches_jax(monkeypatch):
    argv = ["--synthetic", "16"] + ARGS
    # the JAX CLI's initial encoder and classifier, as its inits return
    # them
    inits = {}
    for cls, name in ((JaxSingleModal, "model"), (JaxLinear, "classifier")):
        def init(self, *a, _orig=cls.init, _name=name, **kw):
            inits[_name] = _orig(self, *a, **kw)
            return inits[_name]
        monkeypatch.setattr(cls, "init", init)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jax_cls = jax_linear.main(argv)
    jax_acc = acc_line(buf.getvalue())
    mv, cv = inits["model"], inits["classifier"]

    def load(model, classifier):
        model.load_state_dict(baseline_flax_to_torch(mv["params"],
                                                     mv["batch_stats"]),
                              strict=True)
        classifier.load_state_dict(linear_flax_to_torch(cv["params"]),
                                   strict=True)

    buf = io.StringIO()
    with redirect_stdout(buf):
        run = main_linear.main(argv + ["--device", "cpu", "--num_workers",
                                       "1"], on_ready=load)
    assert acc_line(buf.getvalue()) == jax_acc
    want = linear_flax_to_torch(jax_cls)
    for k, v in run.classifier.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert len(run.metrics) == 1 and set(run.metrics[0]) == {
        "loss", "top1", "top5", "learning_rate"}


def test_pretrain_then_probe_on_folder_data(tmp_path):
    root = make_image_folder_fixture(str(tmp_path / "imgs"), 3, 4)
    save = str(tmp_path / "save")
    pre = main_contrast.main([
        "--method", "InsDis", "--arch", "resnet18", "--dataset", "folder",
        "--data_folder", os.path.join(root, "train"), "--crop_size", "32",
        "--batch_size", "4", "--nce_k", "8", "--compute_dtype", "float32",
        "--epochs", "1", "--num_workers", "1", "--model_path", save,
        "--device", "cpu"])
    assert pre.state.step == 3  # 12 images, bs4
    ckpt = CheckpointManager(pre.ckpt_dir).path(1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        run = main_linear.main([
            "--arch", "resnet18", "--modal", "RGB", "--data_folder", root,
            "--crop_size", "32", "--batch_size", "4", "--n_class", "3",
            "--compute_dtype", "float32", "--epochs", "2", "--num_workers",
            "1", "--pretrain", pre.ckpt_dir, "--device", "cpu"])
    assert f"=> loaded encoder from {ckpt}" in buf.getvalue()
    assert len(run.metrics) == 6 and len(run.val) == 2
    for top1, top5 in run.val:  # 6 val images, 3 classes: top-5 is all
        assert 0 <= top1 <= 1 and top5 == 1.0
    saved = torch.load(ckpt, weights_only=True)["model"]
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, saved[k]), k  # frozen, BN included


def test_main_linear_refusals(monkeypatch):
    with pytest.raises(ValueError, match="single-encoder"):
        main_linear.main(["--synthetic", "8", "--method", "CMC",
                          "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_linear.main(["--synthetic", "8"] + ARGS)
