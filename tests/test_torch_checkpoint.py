"""The port's checkpoints (train/checkpoint.py), its stage-1 -> stage-2
graft and its ImageNet-pretrain loader, at tiny size on the CPU (width-4
HRNet, 32^2 crops, f32).

- A save/restore round trip is bit-identical (model, SGD momentum, banks,
  step, epoch), the newest 3 epochs are kept, and a checkpoint restores
  across HCMOCO_CONVBN_FUSE 0 <-> 1 (the fused path keeps the reference BN
  names and buffers).
- A step after a restore equals the step on the in-memory state, bit for
  bit (the same batch, the same generator).
- graft_pretrain and load_imagenet_pretrained copy exactly the tensors that
  the JAX package's copy, compared through
  export/convert.py::flax_to_port_state_dict, exactly (both are copies).
"""

import os

import jax
import numpy as np
import pytest
import torch

from hcmoco_tpu.core.config import TrainConfig as JaxTrainConfig
from hcmoco_tpu.core.config import resolve_config as jax_resolve_config
from hcmoco_tpu.data.synthetic import synthetic_contrast_batch
from hcmoco_tpu.export.transfer import (
    load_imagenet_pretrained as jax_load_imagenet_pretrained)
from hcmoco_tpu.models.build import build_model as jax_build_model
from hcmoco_tpu.train.checkpoint import CheckpointManager as JaxManager
from hcmoco_tpu.train.checkpoint import graft_pretrain as jax_graft_pretrain
from hcmoco_tpu.train.state import create_train_state as jax_create_state

from hcmoco_tpu_torch.core.config import HRNET_TINY, TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import flax_to_port_state_dict
from hcmoco_tpu_torch.export.transfer import load_imagenet_pretrained
from hcmoco_tpu_torch.models.build import build_model
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager, graft_pretrain
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

N_DATA, BSZ, CROP = 24, 4, 32
TINY = dict(method="CMCRGBD2S", width=4, nce_k=15, batch_size=BSZ,
            crop_size=CROP, epochs=3, modality_missing=True,
            compute_dtype="float32")
STAGE2 = dict(TINY, method="CMCJointsPri3DRGBD2S", linear_feat_map=True,
              pri3d_num_samples_per_image=16)


def _batch(seed=0):
    return synthetic_contrast_batch(np.random.default_rng(seed), BSZ,
                                    size=CROP, num_joints=16, n_data=N_DATA)


def _state(kw=TINY, seed=0):
    cfg = resolve_config(TrainConfig(**kw))
    torch.manual_seed(seed)
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(seed),
                               N_DATA, steps_per_epoch=2)
    return cfg, state


def _step(cfg, state, seed):
    step = make_contrast_train_step(cfg, state.model, steps_per_epoch=2)
    b = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
    return step(state, b, torch.Generator().manual_seed(100 + seed))


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"]), i
    assert torch.equal(a.banks, b.banks) and a.step == b.step


def test_round_trip_is_bit_identical(tmp_path):
    cfg, state = _state()
    _step(cfg, state, 1)
    _step(cfg, state, 2)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, state)
    _, fresh = _state(seed=5)
    restored, epoch = mgr.restore(fresh)
    assert restored is fresh and epoch == 1 and fresh.step == 2
    assert len(fresh.optimizer.state_dict()["state"]) > 0
    _assert_states_equal(fresh, state)
    assert mgr.latest_epoch() == 1


def test_empty_directory_restores_epoch_zero(tmp_path):
    _, state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_epoch() is None
    got, epoch = mgr.restore(state)
    assert got is state and epoch == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k])


def test_keeps_newest_three(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "run"), save_freq=2)
    for epoch in range(1, 6):
        state.step = 10 * epoch
        mgr.save(epoch, state)
    assert mgr.epochs() == [3, 4, 5] and mgr.latest_epoch() == 5
    assert sorted(os.listdir(mgr.directory)) == [
        "epoch_3.pt", "epoch_4.pt", "epoch_5.pt"]
    _, fresh = _state()
    assert mgr.restore(fresh, epoch=4)[1] == 4 and fresh.step == 40
    assert mgr.restore(fresh)[1] == 5 and fresh.step == 50


@pytest.mark.parametrize("saved,restored", [("1", "0"), ("0", "1")])
def test_restore_across_convbn_fuse(tmp_path, monkeypatch, saved, restored):
    """A checkpoint of the fused ConvBN path restores into the plain one
    and the other way round, and the next step agrees (rtol 1e-5: the two
    paths compute BN's statistics in different orders)."""
    monkeypatch.setenv("HCMOCO_CONVBN_FUSE", saved)
    cfg, state = _state()
    _step(cfg, state, 1)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, state)
    monkeypatch.setenv("HCMOCO_CONVBN_FUSE", restored)
    _, other = _state(seed=3)
    mgr.restore(other)
    _assert_states_equal(other, state)
    ma, mb_ = _step(cfg, state, 2), _step(cfg, other, 2)
    for k in ("loss", "nce_loss_12", "nce_loss_32"):
        np.testing.assert_allclose(float(mb_[k]), float(ma[k]), rtol=1e-5)


def test_step_after_restore_equals_in_memory_step(tmp_path):
    cfg, state = _state()
    _step(cfg, state, 1)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, state)
    _, other = _state(seed=9)
    mgr.restore(other)
    ma, mb_ = _step(cfg, state, 2), _step(cfg, other, 2)
    assert ma.keys() == mb_.keys()
    for k in ma:
        assert float(ma[k]) == float(mb_[k]), k
    _assert_states_equal(other, state)


# --- against the JAX package -------------------------------------------


def _jax_state(kw):
    jcfg = jax_resolve_config(JaxTrainConfig(**kw))
    return jax_create_state(jcfg, jax_build_model(jcfg),
                            jax.random.PRNGKey(0), _batch(), n_data=N_DATA,
                            steps_per_epoch=2)


def _port_from_jax(kw, jstate):
    _, state = _state(kw)
    state.model.load_state_dict(flax_to_port_state_dict(
        jstate.params, jstate.batch_stats), strict=True)
    with torch.no_grad():
        state.banks.copy_(torch.from_numpy(np.array(jstate.memory.banks)))
    return state


def test_graft_pretrain_matches_jax(tmp_path, capsys):
    """Stage 1 into stage 2: the port copies exactly what the JAX graft
    copies (and prints the same counts); encoder{1,2}_linear keep their
    init, and the optimizer stays fresh at step 0."""
    j1 = _jax_state(TINY)
    j2 = _jax_state(STAGE2)
    # stage 1 trained a little: its weights, BN statistics and banks moved
    j1 = j1.replace(
        params=jax.tree_util.tree_map(lambda x: x + 0.5, j1.params),
        batch_stats=jax.tree_util.tree_map(lambda x: x * 1.5 + 0.25,
                                           j1.batch_stats),
        memory=j1.memory.replace(banks=j1.memory.banks[:, ::-1]))
    jdir = str(tmp_path / "jax_run")
    JaxManager(jdir).save(1, jax.device_get(j1))
    capsys.readouterr()
    jgraft = jax_graft_pretrain(jdir, j2)
    jax_out = capsys.readouterr().out

    s1 = _port_from_jax(TINY, j1)
    CheckpointManager(str(tmp_path / "port_run")).save(1, s1)
    s2 = _port_from_jax(STAGE2, j2)
    init = {k: v.clone() for k, v in s2.model.state_dict().items()}
    got = graft_pretrain(str(tmp_path / "port_run"), s2)
    port_out = capsys.readouterr().out
    assert got is s2 and s2.step == 0
    assert not s2.optimizer.state_dict()["state"]

    want = flax_to_port_state_dict(jgraft.params, jgraft.batch_stats)
    sd = s2.model.state_dict()
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k].to(sd[k].dtype)), k
    for k in sd:
        if k.startswith(("encoder1_linear", "encoder2_linear")):
            assert torch.equal(sd[k], init[k]), k
    assert torch.equal(s2.banks, torch.from_numpy(
        np.array(jgraft.memory.banks)))

    def counts(out):
        return [(line.split()[2], line.split()[3]) for line in
                out.splitlines() if line.startswith("=> grafted ")
                and "tensors" in line]

    assert counts(port_out) == counts(jax_out)
    assert [c[1] for c in counts(port_out)] == ["param", "batch-stat"]
    assert ("=> grafted memory banks" in port_out) == (
        "=> grafted memory banks" in jax_out) is True


def test_graft_pretrain_from_file_and_missing(tmp_path):
    _, s1 = _state()
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(2, s1)
    _, s2 = _state(STAGE2, seed=4)
    graft_pretrain(mgr.path(2), s2)
    assert torch.equal(s2.model.encoder1.conv1.weight,
                       s1.model.encoder1.conv1.weight)
    with pytest.raises(FileNotFoundError):
        graft_pretrain(str(tmp_path / "nothing"), s2)


def _imagenet_state_dict(seed=0):
    """A seeded torch HRNet state dict: every HRNet-tiny tensor, a
    classifier the encoders lack, and a stem of another width."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) if v.is_floating_point() else v.clone()
        for k, v in HRNet(HRNET_TINY).state_dict().items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
    sd["conv1.weight"] = torch.ones(64, 5, 3, 3)  # another input width
    sd["classifier.weight"] = torch.ones(10, 32)
    return sd


def test_load_imagenet_pretrained_matches_jax(tmp_path):
    path = str(tmp_path / "in.pth")
    torch.save(_imagenet_state_dict(), path)
    jstate = _jax_state(TINY)
    params, bs, jn = jax_load_imagenet_pretrained(
        path, jstate.params, jstate.batch_stats)
    state = _port_from_jax(TINY, jstate)
    n = load_imagenet_pretrained(path, state.model)
    assert n == jn and n > 0
    want = flax_to_port_state_dict(params, bs)
    sd = state.model.state_dict()
    for k in sd:
        assert torch.equal(sd[k], want[k].to(sd[k].dtype)), k
    # the stem of another width stayed at its init, the rest was loaded
    src = _imagenet_state_dict()
    assert not torch.equal(sd["encoder1.conv1.weight"][:, :3],
                           src["conv1.weight"][:, :3])
    assert torch.equal(sd["encoder2.layer1.0.conv1.weight"],
                       src["layer1.0.conv1.weight"])


@pytest.mark.parametrize("encoders", [("encoder1",), ("encoder2",)])
def test_load_imagenet_pretrained_one_encoder(tmp_path, encoders):
    """--IN_Pretrain loads encoder1 alone, --depth_Pretrain encoder2."""
    path = str(tmp_path / "in.pth")
    torch.save(_imagenet_state_dict(1), path)
    _, state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    n = load_imagenet_pretrained(path, state.model, encoder_names=encoders)
    assert n > 0
    for k, v in state.model.state_dict().items():
        moved = not torch.equal(v, before[k])
        if moved:
            assert k.split(".")[0] in encoders, k


def test_load_imagenet_pretrained_skips_pointnet(tmp_path):
    """HRNetPN's encoder2 is PointNet++: it takes nothing."""
    path = str(tmp_path / "in.pth")
    torch.save(_imagenet_state_dict(2), path)
    _, state = _state(dict(TINY, arch="HRNetPN", pn_num_points=64))
    assert load_imagenet_pretrained(path, state.model,
                                    encoder_names=("encoder2",)) == 0
    n1 = load_imagenet_pretrained(path, state.model,
                                  encoder_names=("encoder1",))
    _, hr = _state()
    assert n1 == load_imagenet_pretrained(path, hr.model,
                                          encoder_names=("encoder1",))
