"""hcmoco_tpu_torch's own config and synthetic data held against
hcmoco_tpu's: the port reads neither from the JAX package, so these pin
the copies to it."""

import dataclasses

import numpy as np
import pytest
import torch

from hcmoco_tpu.core import config as jax_config
from hcmoco_tpu.data.synthetic import (
    synthetic_contrast_batch as jax_synthetic_contrast_batch)

from hcmoco_tpu_torch.core import config
from hcmoco_tpu_torch.data.synthetic import synthetic_contrast_batch

torch.set_num_threads(1)

PORT_FIELDS = [f.name for f in dataclasses.fields(config.TrainConfig)]


def test_hrnet_configs_match_jax():
    assert config.HRNET_CONFIGS.keys() == jax_config.HRNET_CONFIGS.keys()
    for w, spec in config.HRNET_CONFIGS.items():
        want = jax_config.HRNET_CONFIGS[w]
        assert dataclasses.asdict(spec) == dataclasses.asdict(want), w
        assert spec.total_channels == want.total_channels


def test_method_presets_match_jax():
    assert ({k: dataclasses.asdict(v) for k, v in
             config.METHOD_PRESETS.items()}
            == {k: dataclasses.asdict(v) for k, v in
                jax_config.METHOD_PRESETS.items()})


def test_train_config_defaults_match_jax():
    port, jax_cfg = config.TrainConfig(), jax_config.TrainConfig()
    for name in PORT_FIELDS:
        assert getattr(port, name) == getattr(jax_cfg, name), name


def test_pointnet_fields_match_jax():
    """The HRNetPN fields the port reads, at the JAX package's defaults."""
    port, jax_cfg = config.TrainConfig(), jax_config.TrainConfig()
    want = dict(pn_ori_h=424.0, pn_ori_w=512.0, pn_num_points=4096,
                pn_remat=False)
    for name, value in want.items():
        assert getattr(port, name) == getattr(jax_cfg, name) == value, name


@pytest.mark.parametrize("kw", [
    dict(method="CMCRGBD2S", batch_size=32, epochs=100, cosine=True,
         nce_k=16384, modality_missing=True, crop_size=320),
    dict(method="CMCRGBD2S", batch_size=512, epochs=100, cosine=True),
    dict(method="CMCJointsPri3DRGBD2S", batch_size=224, epochs=600,
         warm=True, linear_feat_map=True),
    dict(method="CMC"),
    dict(method="MoCov2", width=32, skeleton_meta_name="coco_reduce"),
    dict(method="Customize", modal="RGBD2S", width=4, nce_k=15,
         compute_dtype="float32"),
])
def test_resolve_config_matches_jax(kw):
    port = config.resolve_config(config.TrainConfig(**kw))
    want = jax_config.resolve_config(jax_config.TrainConfig(**kw))
    for name in PORT_FIELDS:
        assert getattr(port, name) == getattr(want, name), name
    assert port.hrnet == config.HRNET_CONFIGS[want.width]
    assert port.num_joints == want.num_joints


@pytest.mark.parametrize("bsz,size,joints", [(3, 32, 16), (5, 48, 13)])
def test_synthetic_batch_matches_jax(bsz, size, joints):
    got = synthetic_contrast_batch(np.random.default_rng(7), bsz, size=size,
                                   num_joints=joints, n_data=100)
    want = jax_synthetic_contrast_batch(np.random.default_rng(7), bsz,
                                        size=size, num_joints=joints,
                                        n_data=100)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
