"""The port's HRNet and stage-1 step against the reference's own numbers:
the eval-mode forward goldens tests/golden/hrnet_forward_golden{,_w32,
_w48}.npz (the reference backbone's four maps with crc32-seeded weights,
the JAX package's tests/test_forward_parity.py criterion: max error
within 2e-3 of the map's mean magnitude), and the 100-step stage-1 loss
curve tests/golden/ref_loss_curve_s1.npz (marked slow, as the JAX
package's replay and the port's stage-2 curve are)."""

import os
import zlib

import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu_torch.core.config import (HRNET_CONFIGS, TrainConfig,
                                          resolve_config)
from hcmoco_tpu_torch.models.build import HCMoCoModel
from hcmoco_tpu_torch.models.hrnet import HRNet
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

from torch_parity_common import counts_from_indices

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def synth_state_dict(keys_path, seed):
    """The crc32-per-key weights of tests/test_forward_parity.py (the
    golden's generator): BN statistics and affine kept plausible."""
    sd = {}
    for k, shape in pc.read_keys_file(keys_path):
        r = np.random.RandomState(
            (zlib.crc32(k.encode()) ^ seed) % (2 ** 31 - 1))
        if k.endswith("running_var"):
            v = r.rand(*shape) * 0.5 + 0.75
        elif k.endswith("running_mean"):
            v = r.randn(*shape) * 0.1
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros(shape, dtype=torch.long)
            continue
        elif len(shape) == 1 and k.endswith("weight"):
            v = r.rand(*shape) + 0.5
        elif len(shape) == 1:
            v = r.randn(*shape) * 0.1
        else:
            v = r.randn(*shape) * 0.05
        sd[k] = torch.from_numpy(v.astype(np.float32))
    return sd


@pytest.mark.parametrize("width", [18, 32, 48])
def test_hrnet_forward_matches_reference_golden(width):
    suffix = "" if width == 18 else f"_w{width}"
    golden = np.load(os.path.join(HERE, "golden",
                                  f"hrnet_forward_golden{suffix}.npz"))
    model = HRNet(HRNET_CONFIGS[width], 3, torch.float32)
    model.load_state_dict(synth_state_dict(
        os.path.join(HERE, "golden", f"hrnet_w{width}_torch_keys.txt"),
        int(golden["seed"])), strict=True)
    model.eval()
    with torch.no_grad():
        outs = model(torch.from_numpy(golden["input"]).contiguous(
            memory_format=torch.channels_last))
    assert len(outs) == 4
    for i, o in enumerate(outs):
        want = golden[f"out{i}"]
        assert tuple(o.shape) == want.shape, i
        rel = np.abs(o.numpy() - want).max() / np.abs(want).mean()
        assert rel < 2e-3, f"branch {i}: max rel err {rel}"


@pytest.mark.slow
def test_stage1_loss_curve_matches_reference():
    """The port's HRNet-W18 stage-1 step against the reference trainer
    (`_train_mem_skeleton3d`) on the golden's pinned weights, banks,
    batches and negatives, by the criteria of tests/test_ref_parity.py::
    test_stage1_loss_curve_matches_reference: each pair of directions'
    mean loss at step 0 within rtol 1e-4, then its mean deviation within
    twice the reference's own perturbation envelope (or 0.02), and the
    final banks within 0.05 (max) and 0.005 (mean).  100 W18 steps at
    64^2: ~100 s on one CPU thread."""
    golden = np.load(os.path.join(HERE, "golden", "ref_loss_curve_s1.npz"))
    steps = int(golden["steps"])
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGBD2S", arch="HRNet", width=18,
        mem="bank", nce_k=pc.NCE_K, nce_m=pc.NCE_M, nce_t=pc.NCE_T,
        batch_size=pc.BSZ, epochs=100, learning_rate=pc.LR,
        momentum=pc.MOMENTUM, weight_decay=pc.WEIGHT_DECAY, cosine=False,
        warm=False, modality_missing=True, compute_dtype="float32",
        crop_size=pc.CROP))
    model = HCMoCoModel(width=18, dtype=torch.float32)
    sd = pc.synth_state_dict(pc.read_keys_file(
        os.path.join(HERE, "golden", "hcmoco_w18_torch_keys.txt")))
    # the key list is the stage-2 model's: stage 1 has no linear heads
    extra = set(sd) - set(model.state_dict())
    assert {k.split(".")[0] for k in extra} == {"encoder1_linear",
                                                "encoder2_linear"}
    sd = {k: v for k, v in sd.items() if k not in extra}
    model.load_state_dict({k: torch.from_numpy(v).to(
        torch.long if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in sd.items()}, strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=pc.N_DATA, steps_per_epoch=steps)
    state.banks.copy_(torch.from_numpy(pc.synth_banks()))
    step = make_contrast_train_step(cfg, model, steps_per_epoch=steps)
    got = {"loss_12": [], "loss_23": [], "loss_13": []}
    for b in pc.synth_batches(steps=steps):
        tb = {k: torch.from_numpy(v) for k, v in b.items() if k != "neg_idx"}
        tb["counts"] = counts_from_indices(torch.from_numpy(b["neg_idx"]),
                                           pc.N_DATA)
        m = step(state, tb)
        for pair in ("12", "23", "13"):
            back = pair[::-1]
            got[f"loss_{pair}"].append(0.5 * (float(m[f"nce_loss_{pair}"])
                                              + float(m[f"nce_loss_{back}"])))
    for key, ours in got.items():
        ours, ref = np.asarray(ours), golden[key]
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-4,
                                   err_msg=f"{key} step 0")
        env = np.abs(golden["pert_" + key] - ref).mean()
        dev = np.abs(ours - ref).mean()
        assert dev <= max(2.0 * env, 0.02), (
            f"{key}: mean dev {dev:.4f} exceeds 2x envelope {env:.4f}")
    diff = np.abs(state.banks.numpy() - golden["bank_final"])
    assert diff.max() < 0.05 and diff.mean() < 0.005
