"""The moco baselines (MoCo, CMCv2, InfoMin) of hcmoco_tpu_torch held
against hcmoco_tpu, and the queue's checkpoint.

One train step each against the JAX package's moco_train_step
(torch_baseline_common.run_family: the same initial weights and queue,
the jigsaw orders the JAX step draws from its key pinned in the port, the
encoders in float64 on both sides; the port runs no ShuffleBN
permutation, which under global BN only reorders a sum, F12) at rtol
1e-4, atol 1e-5: the metrics, the parameters after SGD, the BN running
statistics (the key pass leaves the model's untouched), the queue, the
pointer (exactly) and the key encoder's EMA parameters.  `moco_enqueue`
against JAX's across the ring's end; a checkpoint and --resume through
CheckpointManager continue a moco run bit for bit; and (slow) the
reference MoCo loss curve tests/golden/ref_loss_curve_smoco.npz through the
port's step by tests/test_ref_parity.py's envelope.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_common as pc
from hcmoco_tpu.contrast.memory import MoCoState as JaxMoCoState
from hcmoco_tpu.contrast.memory import moco_enqueue as jax_moco_enqueue

from hcmoco_tpu_torch.contrast.memory import MoCoState, moco_enqueue
from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.models.build import SingleModalModel, build_model
from hcmoco_tpu_torch.train.checkpoint import CheckpointManager
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

from torch_baseline_common import family_batch, run_family

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
BASE = dict(arch="resnet18", nce_k=16, batch_size=4, epochs=2,
            compute_dtype="float32")


@pytest.mark.parametrize("name,kw,metrics", [
    ("MoCo", dict(method="MoCo"), {"nce_acc"}),
    ("CMCv2", dict(method="CMCv2"), {"nce_acc_12", "nce_acc_21"}),
    ("InfoMin", dict(method="InfoMin", alpha=0.9),
     {"nce_acc", "nce_acc_jig", "loss_jig"}),
])
def test_moco_step_matches_jax(name, kw, metrics):
    out = run_family(dict(BASE, **kw))
    assert set(out["metrics"]) == metrics | {"loss", "learning_rate"}
    state, cfg = out["state"], out["cfg"]
    assert cfg.mem == "moco" and state.banks is None
    # the key encoder's buffers took the key pass's statistics; its
    # parameters are under no optimizer
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    assert not any(id(p) in opt_params
                   for p in state.key_model.parameters())


def test_moco_enqueue_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 10, 8)).astype(np.float32)
    keys = [rng.standard_normal((2, 4, 8)).astype(np.float32)
            for _ in range(4)]
    port = MoCoState(queues=torch.from_numpy(q.copy()), ptr=0)
    jst = JaxMoCoState(queues=jnp.asarray(q), ptr=jnp.zeros((), jnp.int32))
    for k in keys:  # 16 keys into a ring of 10: wraps at the second batch
        moco_enqueue(port, torch.from_numpy(k))
        jst = jax_moco_enqueue(jst, jnp.asarray(k))
        assert port.ptr == int(jst.ptr)
        np.testing.assert_array_equal(port.queues.numpy(),
                                      np.asarray(jst.queues))


def test_moco_checkpoint_resume_is_exact(tmp_path):
    """Two steps, a checkpoint, two more; against a state restored from
    the checkpoint taking the same two steps: parameters, the key
    encoder, the queue and its pointer equal bit for bit."""
    cfg = resolve_config(TrainConfig(method="InfoMin", **BASE))
    batches = [{k: torch.from_numpy(v) for k, v in
                family_batch(cfg, seed=s).items()} for s in range(4)]

    def fresh():
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
        state = create_train_state(cfg, model,
                                   torch.Generator().manual_seed(0),
                                   n_data=8, steps_per_epoch=2)
        return state, make_contrast_train_step(cfg, model, 2)

    state, step = fresh()
    for b in batches[:2]:
        step(state, b, torch.Generator().manual_seed(state.step))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    for b in batches[2:]:
        step(state, b, torch.Generator().manual_seed(state.step))

    resumed, step2 = fresh()
    resumed, epoch = ckpt.restore(resumed)
    assert epoch == 1 and resumed.step == 2 and resumed.moco.ptr == 8
    for b in batches[2:]:
        step2(resumed, b, torch.Generator().manual_seed(resumed.step))
    assert resumed.moco.ptr == state.moco.ptr == 0
    assert torch.equal(resumed.moco.queues, state.moco.queues)
    for a, b in ((resumed.model, state.model),
                 (resumed.key_model, state.key_model)):
        for (n, x), y in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(x, y), n


@pytest.mark.slow
def test_moco_loss_curve_matches_reference():
    """The port's moco step (RGBSingleHead ResNet-50, the EMA key encoder
    with train-mode BN, the queue) against the reference trainer's
    `_train_moco` on the golden's pinned weights, queue and batches, by
    tests/test_ref_parity.py::test_moco_loss_curve_matches_reference's
    criteria (the harness pins ShuffleBN to the identity; the port runs
    none)."""
    golden = np.load(os.path.join(HERE, "golden",
                                  "ref_loss_curve_smoco.npz"))
    steps = int(golden["steps"])
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="RGB", arch="resnet50", mem="moco",
        nce_k=pc.MOCO_K, nce_t=pc.NCE_T, alpha=pc.MOCO_ALPHA,
        batch_size=pc.BSZ, epochs=100, learning_rate=pc.LR,
        momentum=pc.MOMENTUM, weight_decay=pc.WEIGHT_DECAY, cosine=False,
        warm=False, compute_dtype="float32", crop_size=pc.MOCO_CROP))
    model = SingleModalModel("resnet50", dtype=torch.float32)
    sd = pc.synth_state_dict(pc.read_keys_file(
        os.path.join(HERE, "golden", "rgb_moco_torch_keys.txt")))
    model.load_state_dict({k: torch.from_numpy(v).to(
        torch.long if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in sd.items()}, strict=True)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=1024, steps_per_epoch=steps)
    state.moco.queues.copy_(torch.from_numpy(pc.synth_moco_queue())[None])
    step = make_contrast_train_step(cfg, model, steps_per_epoch=steps)
    losses = []
    for b in pc.synth_moco_batches(steps=steps):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        losses.append(float(step(state, tb)["loss"]))
    ours, ref = np.asarray(losses, np.float64), golden["loss"]
    np.testing.assert_allclose(ours[0], ref[0], atol=0.05,
                               err_msg="moco loss step 0")
    env = np.abs(golden["pert_loss"] - ref).mean()
    dev = np.abs(ours - ref).mean()
    scale = max(np.abs(ref).mean(), 0.1)
    assert dev <= max(2.0 * env, 0.05 * scale), (
        f"moco loss: mean dev {dev:.4f} vs envelope {env:.4f}")
    q_ref = np.asarray(golden["queue_final"])
    q_ours = state.moco.queues[0].numpy()
    assert q_ours.shape == q_ref.shape
    filled = min(steps * pc.BSZ, pc.MOCO_K)
    cos = np.sum(q_ours[:filled] * q_ref[:filled], axis=-1)
    p_cos = np.sum(golden["pert_queue_final"][:filled] * q_ref[:filled],
                   axis=-1)
    assert cos.min() > 1 - 3 * (1 - p_cos.min()), (cos.min(), p_cos.min())
    assert cos.mean() > 1 - 3 * (1 - p_cos.mean()), (cos.mean(),
                                                     p_cos.mean())
    assert state.moco.ptr == (steps * pc.BSZ) % pc.MOCO_K
