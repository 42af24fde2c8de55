"""One train step of each bank baseline (InsDis, PIRL, CMC, CMC with
jigsaw) of hcmoco_tpu_torch held against hcmoco_tpu's
make_contrast_train_step on the CPU (torch_baseline_common.run_family):
the same initial weights, banks and batch, the JAX step's negatives and
patch orders pinned in the port, the encoders in float64 on both sides
(in f32 a train-mode ResNet at these sizes parts the two frameworks by
more than the tolerance; torch_baseline_common says by how much).
Compared at rtol 1e-4, atol 1e-5: every metric (the raw per-direction
losses and accuracies, the weighted loss), every parameter after SGD, the
BN running statistics (both passes of the jigsaw encoders) and the banks
after their update.  The batch's sample indices collide (5 twice): the
later row wins in both banks."""

import numpy as np
import pytest

from torch_baseline_common import run_family

BASE = dict(arch="resnet18", nce_k=7, batch_size=4, epochs=2,
            compute_dtype="float32")


@pytest.mark.parametrize("name,kw,metrics", [
    ("InsDis", dict(method="InsDis"), ("ins",)),
    ("PIRL", dict(method="PIRL"), ("ins", "jig")),
    ("CMC", dict(method="CMC"), ("12", "21")),
    ("CMC-jigsaw", dict(method="Customize", modal="CMC", mem="bank",
                        jigsaw=True, beta=0.3), ("12", "21", "jig2",
                                                 "jig1")),
])
def test_bank_baseline_step_matches_jax(name, kw, metrics):
    out = run_family(dict(BASE, **kw))
    m, cfg = out["metrics"], out["cfg"]
    assert set(m) == ({f"nce_{k}_{d}" for k in ("loss", "acc")
                       for d in metrics} | {"loss", "learning_rate"})
    losses = [float(m[f"nce_loss_{d}"]) for d in metrics]
    n = len(metrics) // 2 if len(metrics) > 2 or name == "PIRL" else 0
    if n:  # the jig terms: (1 - beta) instance + beta jig
        want = ((1 - cfg.beta) * sum(losses[:n]) + cfg.beta
                * sum(losses[n:]))
    else:
        want = sum(losses)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
