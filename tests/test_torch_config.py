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


STAGE_RECIPES = sorted(k for k in jax_config.RECIPES
                       if k.startswith(("first_stage/", "second_stage/",
                                        "versatility/")))


def test_recipes_are_the_jax_stage_recipes():
    assert sorted(config.RECIPES) == STAGE_RECIPES


@pytest.mark.parametrize("name", STAGE_RECIPES)
def test_recipe_matches_jax(name):
    port, want = config.RECIPES[name], jax_config.RECIPES[name]
    for field in PORT_FIELDS:
        assert getattr(port, field) == getattr(want, field), (name, field)


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


@pytest.mark.parametrize("name", STAGE_RECIPES)
def test_recipe_run_fields_match_jax(name):
    """The pipeline's and the CLI's fields of each stage recipe (dataset,
    flip, paths, seed), its model_name (the checkpoint directory) and its
    to_dict, against the JAX package's."""
    port, want = config.RECIPES[name], jax_config.RECIPES[name]
    assert port.dataset == want.dataset in ("NTUMPII", "NTUCOCO", "NTUSeg")
    assert port.random_flip is want.random_flip is True
    assert port.model_name == want.model_name
    got, full = config.to_dict(port), jax_config.to_dict(want)
    assert set(got) == set(PORT_FIELDS) < set(full)
    assert got == {k: full[k] for k in got}


def test_data_and_run_fields_are_ported():
    names = set(PORT_FIELDS)
    assert {"dataset", "data_folder", "train_file_list", "val_file_list",
            "mpii_root", "coco_root", "seg_root", "seg_file_list",
            "seg_val_file_list", "packed_dir", "random_flip",
            "not_use_weighted_sampler", "mask_seg_depth", "mask_seg_rgb",
            "model_path", "resume", "pretrain", "save_freq", "print_freq",
            "seed"} <= names


def test_versatility_and_nce_fields_match_jax():
    """The segmentor's fields and the NCE formulation switches, at the JAX
    package's defaults, and each versatility recipe's supervision."""
    port, jax_cfg = config.TrainConfig(), jax_config.TrainConfig()
    want = dict(n_class=25, supervise_type=0, test_type=0,
                cmc_loss_weights=1.0, other_loss_weights=1.0,
                bank_logits="counts", dense_scores=False,
                counts_max_n_data=131072)
    for name, value in want.items():
        assert getattr(port, name) == getattr(jax_cfg, name) == value, name
    sup = {"versatility/sup_rgbd": (0, 0, False, False),
           "versatility/sup_rgb_test_d": (1, 2, True, False),
           "versatility/sup_d_test_rgb": (2, 1, False, True),
           "versatility/sup_none": (3, 0, False, False)}
    for name, (s, t, md, mr) in sup.items():
        r = config.RECIPES[name]
        assert (r.supervise_type, r.test_type, r.mask_seg_depth,
                r.mask_seg_rgb) == (s, t, md, mr), name
        assert r.mem == "bank+jointspri3d" and r.linear_feat_map
