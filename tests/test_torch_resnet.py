"""The port's baseline encoders (models/resnet.py) and models held against
hcmoco_tpu's, in f32 on the CPU, and the CMC shared trunk against the
reference's own forward golden.

Same numpy inputs and the same weights on both sides (the JAX package's
initialised ones carried over by export/convert.py, or the port's carried
into flax trees by torch_baseline_common.port_to_flax): ResNet-18 inside PIRL/InfoMin's
SingleModalModel with its mlp JigsawHead, ResNeXt's grouped (and dilated)
bottleneck alone, and a one-block-a-stage CMCResNet, each in eval and in
train mode (BN running statistics compared as
torch_baseline_common.check_bn_passes does, flax tracking the biased
variance).  Tolerance atol 1e-4, the port's model tests'
(tests/test_torch_models.py).  The CMC ResNet-50 golden
(tests/golden/cmc_resnet50_forward_golden.npz, the reference
resnet_cmc.resnet50 with crc32-seeded weights) at the JAX test's rtol/atol
2e-4 (tests/test_forward_parity.py).  The shared trunk's towers: one port
step on the CPU whose L half gets no gradient from the ab input and the
other way round (tests/test_baseline_methods.py's check, in JAX on the
forward), and its bank update.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcmoco_tpu.models.build import SingleModalModel as JaxSingleModal
from hcmoco_tpu.models.resnet import CMCResNet as JaxCMCResNet
from hcmoco_tpu.models.resnet import ResBottleneck as JaxResBottleneck

from hcmoco_tpu_torch.core.config import TrainConfig, resolve_config
from hcmoco_tpu_torch.export.convert import baseline_flax_to_torch
from hcmoco_tpu_torch.export.transfer import (load_imagenet_pretrained,
                                              resnet_flax_to_torch)
from hcmoco_tpu_torch.models.build import (CMCSharedModel, SingleModalModel,
                                           build_model)
from hcmoco_tpu_torch.models.resnet import (CMCResNet, ResBottleneck,
                                            make_cmc_resnet, make_resnet)
from hcmoco_tpu_torch.train.contrast_step import make_contrast_train_step
from hcmoco_tpu_torch.train.state import create_train_state

from parity_common import read_keys_file
from test_forward_parity import synth_state_dict
from torch_baseline_common import (bn_passes, check_bn_passes, port_f64,
                                   port_to_flax)

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
ATOL = 1e-4
BSZ, CROP = 4, 32


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def jax_init(module, x, **kw):
    """module.init under jit (an eager flax init of a ResNet takes ~20 s
    of per-op compiles on the CPU)."""
    return jax.jit(lambda a: module.init(jax.random.PRNGKey(0), a, **kw))(x)


def jax_train(module, variables, *args, **kw):
    """A train-mode apply: (out, new batch_stats)."""
    out, mut = module.apply(variables, *args, mutable=["batch_stats"], **kw)
    return out, mut["batch_stats"]


def close(got: torch.Tensor, want, atol=ATOL, rtol=0.0, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


def test_single_modal_resnet18_matches_flax():
    """SingleModalModel(resnet18, mlp head, jigsaw): pooled, feat and
    feat_jig (the patches through the same encoder, the JigsawHead
    shuffled by the same ids) in eval mode in f32, and in train mode with
    the encoder in float64 (torch_baseline_common), with the BN running
    statistics of its two passes (the batch, then the patches).  The
    port's initial weights on both sides (port_to_flax)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BSZ, CROP, CROP, 3)).astype(np.float32)
    xj = rng.standard_normal((BSZ * 9, 16, 16, 3)).astype(np.float32)
    ids = (np.stack([rng.permutation(9) for _ in range(BSZ)])
           + 9 * np.arange(BSZ)[:, None]).reshape(-1)
    torch.manual_seed(0)
    model = SingleModalModel("resnet18", head="mlp", jigsaw=True,
                             dtype=torch.float32)
    jm = JaxSingleModal(arch="resnet18", head="mlp", jigsaw=True,
                        dtype=jnp.float32)
    v = port_to_flax(model.state_dict(), jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x, train=False, x_jig=xj,
                        shuffle_ids=ids)), baseline_flax_to_torch)
    v32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), v)
    tx, txj, tids = nchw(x), nchw(xj), torch.from_numpy(ids)
    model.eval()
    got = model(tx, x_jig=txj, shuffle_ids=tids)
    want = jax.jit(lambda a, b, c: jm.apply(
        v32, a, train=False, x_jig=b, shuffle_ids=c))(x, xj, ids)
    for k in ("pooled", "feat", "feat_jig"):
        close(got[k], want[k], what=f"eval {k}")

    port_f64(model).train()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    x64, xj64 = x.astype(np.float64), xj.astype(np.float64)
    with bn_passes(model) as rec:
        got = model(nchw(x64), x_jig=nchw(xj64), shuffle_ids=tids)
    with jax.enable_x64():
        jm64 = JaxSingleModal(arch="resnet18", head="mlp", jigsaw=True,
                              dtype=jnp.float64)
        want, stats = jax.device_get(jax.jit(lambda a, b, c: jax_train(
            jm64, v, a, train=True, x_jig=b, shuffle_ids=c))(x64, xj64,
                                                             ids))
    for k in ("pooled", "feat", "feat_jig"):
        close(got[k], want[k], what=f"train {k}")
    assert check_bn_passes(
        model, before, baseline_flax_to_torch(v["params"],
                                              v["batch_stats"]),
        baseline_flax_to_torch(v["params"], stats), rec) == 29


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 2)])
def test_resnext_grouped_bottleneck_matches_flax(stride, dilation):
    """ResNeXt-50's layer1 block (groups 32, base_width 4: width 128) with
    a downsample, strided and dilated, eval and train mode."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    jb = JaxResBottleneck(64, stride=stride, downsample=True, groups=32,
                          base_width=4, dilation=dilation, dtype=jnp.float32)
    v = jax_init(jb, x, train=False)
    block = ResBottleneck(64, 64, stride, True, groups=32, base_width=4,
                          dilation=dilation, dtype=torch.float32)
    names = {"c1": "conv1", "c2": "conv2", "c3": "conv3"}
    sd = {}
    for k, p in v["params"].items():
        part, kind = k.split("_")
        if part == "ds":
            t = f"downsample.{0 if kind == 'conv' else 1}"
        else:
            t = names[part].replace("conv", kind)
        if kind == "conv":
            sd[f"{t}.weight"] = torch.from_numpy(
                np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)).copy())
        else:
            s = v["batch_stats"][k]
            sd.update({f"{t}.weight": p["scale"], f"{t}.bias": p["bias"],
                       f"{t}.running_mean": s["mean"],
                       f"{t}.running_var": s["var"],
                       f"{t}.num_batches_tracked": np.asarray(0)})
    block.load_state_dict({k: torch.as_tensor(np.array(t))
                           for k, t in sd.items()}, strict=True)
    assert block.conv2.groups == 32 and block.conv2.weight.shape[0] == 128
    block.eval()
    close(block(nchw(x)).permute(0, 2, 3, 1), jb.apply(v, x, train=False),
          what="eval")
    block.train()
    out, _ = jax_train(jb, v, x, train=True)
    close(block(nchw(x)).permute(0, 2, 3, 1), out, what="train")


def test_cmc_resnet_matches_flax():
    """CMCResNet, one block a stage (the stems, the shared BN, every conv
    groups=2): both pooled halves in eval mode in f32 and in train mode in
    float64."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BSZ, CROP, CROP, 3)).astype(np.float32)
    jm = JaxCMCResNet(layers=(1, 1, 1, 1), dtype=jnp.float32)
    torch.manual_seed(0)
    model = CMCResNet(layers=(1, 1, 1, 1), dtype=torch.float32)
    v = port_to_flax(
        model.state_dict(),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                       train=False)),
        lambda p, b: {k: torch.as_tensor(np.asarray(t)) for k, t in
                      resnet_flax_to_torch(p, b).items()})
    model.eval()
    for got, want in zip(model(nchw(x)), jax.jit(lambda a: jm.apply(
            jax.tree_util.tree_map(lambda t: t.astype(np.float32), v), a,
            train=False))(x)):
        close(got, want, what="eval")
    port_f64(model).train()
    x64 = x.astype(np.float64)
    with jax.enable_x64():
        jm64 = JaxCMCResNet(layers=(1, 1, 1, 1), dtype=jnp.float64)
        want, _ = jax.jit(lambda a: jax_train(jm64, v, a, train=True))(x64)
        want = jax.device_get(want)
    for got, w in zip(model(nchw(x64)), want):
        close(got, w, what="train")


def test_cmc_resnet50_forward_matches_reference_golden():
    golden = np.load(os.path.join(HERE, "golden",
                                  "cmc_resnet50_forward_golden.npz"))
    keys = os.path.join(HERE, "golden", "cmc_resnet50_torch_keys.txt")
    sd = synth_state_dict(keys, int(golden["seed"]))
    model = make_cmc_resnet("resnet50", dtype=torch.float32).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    with torch.no_grad():
        y1, y2 = model(torch.from_numpy(golden["x"]))
    close(y1, golden["y1"], atol=2e-4, rtol=2e-4)
    close(y2, golden["y2"], atol=2e-4, rtol=2e-4)


def test_reference_key_lists_load(tmp_path):
    """SingleModalModel(resnet50)'s state dict is the reference
    RGBSingleHead's (rgb_moco_torch_keys.txt, names and shapes) and the CMC
    trunk's is resnet_cmc's (cmc_resnet50_torch_keys.txt);
    load_imagenet_pretrained fills the encoder from either file, the first
    a whole model's dict under `encoder.`."""
    cases = (("rgb_moco_torch_keys.txt",
              SingleModalModel("resnet50", dtype=torch.float32), "encoder."),
             ("cmc_resnet50_torch_keys.txt",
              CMCSharedModel("resnet50", dtype=torch.float32), ""))
    for path, model, prefix in cases:
        keys = os.path.join(HERE, "golden", path)
        got = (model if prefix else model.encoder).state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(s) for k, s in read_keys_file(keys)}, path
        sd = {k: torch.from_numpy(v)
              for k, v in synth_state_dict(keys, 3).items()}
        torch.save(sd, tmp_path / "w.pth")
        n = load_imagenet_pretrained(str(tmp_path / "w.pth"), model,
                                     encoder_names=("encoder",))
        assert n == sum(v.dim() == 4 for v in sd.values()), path
        for k, v in model.encoder.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[prefix + k]), k


def test_shared_trunk_step_towers_never_mix():
    """One port step of CMC on the shared trunk (resnet50cmc, bank, f32):
    the L half's loss terms get no gradient from the ab input and the ab
    half's none from L; the banks take the two halves' features."""
    cfg = resolve_config(TrainConfig(
        method="Customize", modal="CMC", arch="resnet50cmc", mem="bank",
        nce_k=7, batch_size=BSZ, epochs=2, compute_dtype="float32"))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0),
                               n_data=32, steps_per_epoch=2)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (BSZ, CROP, CROP, 3)).astype(np.float32)).requires_grad_(True)
    out = model(x.permute(0, 3, 1, 2))
    g_l = torch.autograd.grad(out["feat1"].sum(), x, retain_graph=True)[0]
    g_ab = torch.autograd.grad(out["feat2"].sum(), x)[0]
    assert g_l[..., 1:].abs().max() == 0 and g_l[..., 0].abs().max() > 0
    assert g_ab[..., 0].abs().max() == 0 and g_ab[..., 1:].abs().max() > 0
    step = make_contrast_train_step(cfg, model, steps_per_epoch=2)
    banks = state.banks.clone()
    y = torch.tensor([3, 9, 3, 30])
    batch = {"rgbd": x.detach(), "index": y,
             "neg_idx": torch.from_numpy(rng.integers(0, 32, (BSZ, 8)))}
    model.train()
    with torch.no_grad():
        feats = model(x.detach().permute(0, 3, 1, 2))
    for mod in model.modules():  # the step's forward sees the same stats
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
    m = step(state, batch, None)
    assert set(m) == {"nce_loss_12", "nce_acc_12", "nce_loss_21",
                      "nce_acc_21", "loss", "learning_rate"}
    for i, f in enumerate((feats["feat1"], feats["feat2"])):
        for r, yi in enumerate(y.tolist()):
            if yi == 3 and r == 0:
                continue  # the later duplicate wins
            w = 0.5 * banks[i, yi] + 0.5 * f[r]
            close(state.banks[i, yi], w / w.norm(), atol=1e-6)
        untouched = torch.ones(32, dtype=torch.bool)
        untouched[y] = False
        assert torch.equal(state.banks[i, untouched], banks[i, untouched])


def test_refusals():
    """The CMC shared trunk refuses jigsaw (ResNeSt, once refused here,
    is tests/test_torch_resnest.py's)."""
    cfg = resolve_config(TrainConfig(method="Customize", modal="CMC",
                                     arch="resnet50cmc", jigsaw=True))
    with pytest.raises(NotImplementedError, match="shared-trunk"):
        build_model(cfg, device="cpu")


def test_build_model_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = resolve_config(TrainConfig(method="MoCo", arch="resnet18"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
