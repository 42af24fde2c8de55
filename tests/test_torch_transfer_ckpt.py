"""cli/transfer_ckpt.py and export/transfer.py::export_encoder of the port:
the exported HRNet state dict of a pre-training and of a segmentor
checkpoint has the reference keys and shapes
(tests/golden/hrnet_w18_torch_keys.txt), equals the JAX package's
export_encoder of the same weights tensor for tensor, and loads into a
bare HRNet with strict=True."""

import os
import types

import jax
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.export.transfer import export_encoder as jax_export_encoder
from hcmoco_tpu.models.build import build_model as jax_build_model

from hcmoco_tpu_torch.cli import transfer_ckpt
from hcmoco_tpu_torch.core.config import (HRNET_CONFIGS, TrainConfig,
                                          resolve_config)
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.export.transfer import export_encoder
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.heads import FCNHead
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager
from hcmoco_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
W18_KEYS = os.path.join(HERE, "golden", "hrnet_w18_torch_keys.txt")


def _checkpoint(tmp_path, width, stage2, segmentor=False, arch="HRNet"):
    """A saved epoch_1.pt of a model of that kind; returns its path and
    the state."""
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGBD2S", arch=arch, width=width,
        mem="bank+jointspri3d" if stage2 else "bank",
        linear_feat_map=stage2, compute_dtype="float32",
        pn_num_points=64))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    head = FCNHead(128, 25) if segmentor else None
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=16, steps_per_epoch=1, classifier=head)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, state)
    return mgr.path(1), state


@pytest.mark.parametrize("kind", ["pretrain", "segmentor"])
@pytest.mark.parametrize("encoder", ["encoder1", "encoder2"])
def test_export_has_the_reference_w18_keys(tmp_path, kind, encoder):
    path, state = _checkpoint(tmp_path, 18, stage2=kind == "segmentor",
                              segmentor=kind == "segmentor")
    if kind == "segmentor":
        assert "classifier" in torch.load(path, weights_only=True)
    out = str(tmp_path / f"{encoder}.pth")
    transfer_ckpt.main(["--ckpt", path, "--encoder", encoder, "--out", out])
    sd = torch.load(out, weights_only=True)
    want = pc.read_keys_file(W18_KEYS)
    assert sorted(sd) == sorted(k for k, _ in want)
    source = state.model.state_dict()
    for k, shape in want:
        assert tuple(sd[k].shape) == shape, k
        assert sd[k].device.type == "cpu"
        assert torch.equal(sd[k], source[f"{encoder}.{k}"]), k
    bare = HRNet(HRNET_CONFIGS[18], 3, torch.float32)
    bare.load_state_dict(sd, strict=True)


def test_export_matches_jax_export_encoder(tmp_path):
    """The same weights through the JAX package's export_encoder (flax
    trees -> reference names) and through the port's (the port's state
    dict -> prefix stripped): equal tensor for tensor."""
    kw = dict(method="Customize", modal="RGBD2S", arch="HRNet", width=4,
              compute_dtype="float32")
    jcfg = jax_resolve_config(JaxTrainConfig(**kw))
    b = pc.synth_batches(steps=1, bsz=2, crop=32, n_data=16, k=3)[0]
    v = jax_build_model(jcfg).init(jax.random.PRNGKey(0), b["rgbd"],
                                   b["skeleton"], train=False)
    v = jax.tree_util.tree_map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(
            a.shape), dict(v))  # BN statistics off their init
    model_sd = flax_to_port_state_dict(v["params"], v["batch_stats"])
    jstate = types.SimpleNamespace(params=v["params"],
                                   batch_stats=v["batch_stats"])
    for enc in ("encoder1", "encoder2"):
        want = jax_export_encoder(jstate, enc, str(tmp_path / "jax.pth"))
        got = export_encoder(model_sd, enc, str(tmp_path / "port.pth"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        bare = HRNet(HRNET_CONFIGS[4], 3, torch.float32)
        bare.load_state_dict(torch.load(tmp_path / "port.pth",
                                        weights_only=True), strict=True)


def test_transfer_ckpt_reads_a_run_directory(tmp_path, capsys):
    path, _ = _checkpoint(tmp_path, 4, stage2=False)
    out = str(tmp_path / "e1.pth")
    sd = transfer_ckpt.main(["--ckpt", os.path.dirname(path), "--out", out])
    assert f"wrote {len(sd)} tensors (encoder1) of {path}" in \
        capsys.readouterr().out
    assert set(sd) == set(HRNet(HRNET_CONFIGS[4], 3).state_dict())


def test_export_refuses_a_point_encoder(tmp_path):
    """HRNetPN's encoder2 is a PointNet++, not an HRNet."""
    path, _ = _checkpoint(tmp_path, 4, stage2=False, arch="HRNetPN")
    transfer_ckpt.main(["--ckpt", path, "--encoder", "encoder1", "--out",
                        str(tmp_path / "e1.pth")])
    with pytest.raises(ValueError, match="not an HRNet"):
        transfer_ckpt.main(["--ckpt", path, "--encoder", "encoder2",
                            "--out", str(tmp_path / "e2.pth")])
