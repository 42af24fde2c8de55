"""JAX package trees -> the port's state dict.

`flax_to_port_state_dict` takes an HCMoCoModel's or HCMoCoPNModel's flax
`params` and `batch_stats` (as numpy arrays) and returns the
reference-named torch state dict that the port's model loads with
strict=True.  The HRNet encoders go through the port's copy of the JAX
package's name tables (export/transfer.py); the SemGCN and head maps are
the inverses of hcmoco_tpu.export.transfer's `_sgcn_torch_to_flax` and
`hcmoco_torch_to_flax` head mapping.

PointNet++ (HCMoCoPNModel's encoder2): tests/golden holds no PointNet++
key list, so the names follow the reference's pointnet2_msg.py
(SA_modules / FP_modules) and its pytorch_utils SharedMLP (layer{j} of a
1x1 conv `conv` and a BN wrapper `bn.bn`):

  sa{k}/mlp{i}/dense{j}/kernel (Fin, Fout)
      -> encoder2.SA_modules.{k}.mlps.{i}.layer{j}.conv.weight (Fout, Fin, 1, 1)
  sa{k}/mlp{i}/bn{j}/{scale, bias} + batch_stats {mean, var}
      -> encoder2.SA_modules.{k}.mlps.{i}.layer{j}.bn.bn.{weight, bias,
         running_mean, running_var, num_batches_tracked}
  fp{k}/mlp/dense{j}, fp{k}/mlp/bn{j}
      -> encoder2.FP_modules.{k}.mlp.layer{j}.conv / .bn.bn (as above)

The stage-2 heads: HCMoCoModel's encoder{1,2}_linear and HCMoCoPNModel's
encoder1_linear are 1x1 convs with bias (kernel (1, 1, Fin, Fout) ->
weight (Fout, Fin, 1, 1)); HCMoCoPNModel's encoder2_linear is a SharedMLP
(dense0/bn0 -> encoder2_linear.layer0.conv / .bn.bn, as above).

The baselines' models (`baseline_flax_to_torch`): each ResNet or
CMCResNet encoder (`encoder`, `encoder1`, `encoder2`) through
export/transfer.py's resnet_flax_to_torch, the projection heads as above,
and PIRL's JigsawHeads (`head_jig`, `head{1,2}_jig`):

  fc1/{kernel, bias} (linear)  -> {head}.fc1.0.{weight, bias}
  fc1a, fc1b (mlp)             -> {head}.fc1.0, {head}.fc1.2
  fc2                          -> {head}.fc2

The moco key encoder's `params_ema` is a params tree of the same model
(with the model's batch_stats: the key encoder's own are never read).
The linear probe's LinearClassifier (`linear_flax_to_torch`): fc -> fc.

The versatility segmentor's FCNHead (`fcn_flax_to_torch`, the inverse of
hcmoco_tpu.export.transfer.fcn_torch_to_flax):

  conv{i}/{kernel, bias}      -> convs.{i}.conv.{weight, bias}
  bn{i}/{scale, bias} + batch_stats {mean, var}
                              -> convs.{i}.norm_name.{weight, bias,
                                 running_mean, running_var,
                                 num_batches_tracked}
  conv_seg/{kernel, bias}     -> conv_seg.{weight, bias}

The downstream models (`seg_flax_to_torch`, `a2j_flax_to_torch`): the
backbone through the HRNet name tables, at the top level for SegHRNet
(the reference's seg_hrnet.py names) and under `Backbone.` for A2JHRNet
(A2JResNet's through resnet_flax_to_torch under `Backbone.model.`); then

  last_conv1 / last_bn / last_conv2 -> last_layer.0 / .1 / .3
  {classificationModel, regressionModel, DepthRegressionModel}/
      conv{i}, bn{i}, output     -> the same names (conv and BN as above)

BN running variance: flax tracks the biased batch variance, torch the
unbiased one.  The port keeps torch semantics, and a flax `var` becomes
`running_var` unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .transfer import hrnet_flax_to_torch, resnet_flax_to_torch


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _bn(out: Dict[str, np.ndarray], prefix: str, p: Dict, s: Dict) -> None:
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]
    out[f"{prefix}.running_mean"] = s["mean"]
    out[f"{prefix}.running_var"] = s["var"]
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0)


def _gconv(out: Dict[str, np.ndarray], prefix: str, p: Dict) -> None:
    w = np.asarray(p["W"])
    out[f"{prefix}.W"] = w
    out[f"{prefix}.e"] = np.asarray(p["e"]).reshape(1, -1)
    if "bias" in p:
        # the flax param is the reference bias + stdv (sgcn.py:94-102)
        out[f"{prefix}.bias"] = np.asarray(p["bias"]) - 1.0 / np.sqrt(
            w.shape[2])


def _conv1d(out: Dict[str, np.ndarray], prefix: str, p: Dict) -> None:
    """A flax Dense -> a 1x1 Conv1d: kernel (in, out) -> weight (out, in,
    1), bias."""
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def nonlocal_flax_to_torch(params: Dict, stats: Dict, prefix: str,
                           sub_sampled: bool) -> Dict[str, np.ndarray]:
    """A flax GraphNonLocal's trees -> the port's GraphNonLocal names under
    `prefix` (numpy): g, theta, phi (g.0 / phi.0 if `sub_sampled`, its
    sub_sample above 1),
    concat_project (2ic, 1) -> concat_project.0.weight (1, 2ic, 1, 1), W
    (and W_bn) -> W.0 and W.1 (W alone without BN)."""
    out: Dict[str, np.ndarray] = {}
    sub = ".0" if sub_sampled else ""
    for name, torch_name in (("g", f"g{sub}"), ("theta", "theta"),
                             ("phi", f"phi{sub}")):
        _conv1d(out, f"{prefix}{torch_name}", params[name])
    out[f"{prefix}concat_project.0.weight"] = np.asarray(
        params["concat_project"]).T[:, :, None, None]
    if "W_bn" in params:
        _conv1d(out, f"{prefix}W.0", params["W"])
        _bn(out, f"{prefix}W.1", params["W_bn"], stats["W_bn"])
    else:
        _conv1d(out, f"{prefix}W", params["W"])
    return out


def sgcn_flax_to_torch(params: Dict, stats: Dict,
                       prefix: str = "") -> Dict[str, np.ndarray]:
    """One SemGCN's flax trees -> reference torch names (numpy), the
    inverse of hcmoco_tpu.export.transfer._sgcn_torch_to_flax; with
    nodes_group, its grouped non-local blocks nl_input and nl{i} go to
    gconv_input.1 and gconv_layers.{2i + 1} (the residual blocks to
    gconv_layers.{2i})."""
    out: Dict[str, np.ndarray] = {}
    _gconv(out, f"{prefix}gconv_input.0.gconv", params["gconv_input"]["gconv"])
    _bn(out, f"{prefix}gconv_input.0.bn", params["gconv_input"]["bn"],
        stats["gconv_input"]["bn"])
    grouped = "nl_input" in params
    step = 2 if grouped else 1

    def non_local(name: str, torch_prefix: str) -> None:
        # a grouped block sub-samples by its group size, always above 1
        out.update(nonlocal_flax_to_torch(
            params[name]["nonlocal"], stats[name]["nonlocal"],
            f"{prefix}{torch_prefix}.non_local.", sub_sampled=True))

    if grouped:
        non_local("nl_input", "gconv_input.1")
    i = 0
    while f"res{i}" in params:
        for g in ("gconv1", "gconv2"):
            base = f"{prefix}gconv_layers.{step * i}.{g}"
            _gconv(out, f"{base}.gconv", params[f"res{i}"][g]["gconv"])
            _bn(out, f"{base}.bn", params[f"res{i}"][g]["bn"],
                stats[f"res{i}"][g]["bn"])
        if grouped:
            non_local(f"nl{i}", f"gconv_layers.{2 * i + 1}")
        i += 1
    _gconv(out, f"{prefix}gconv_output", params["gconv_output"])
    return out


def head_flax_to_torch(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """ProjectionHead flax params -> the port's nn.Sequential names
    (linear: fc -> 0; mlp: fc1 -> 0, fc2 -> 2), kernels transposed."""
    if "fc" in params:
        layers = (("fc", "0"),)
    else:  # mlp: Linear, ReLU, Linear
        layers = (("fc1", "0"), ("fc2", "2"))
    out = {}
    for name, idx in layers:
        key = f"{prefix}.{idx}" if prefix else idx
        out[f"{key}.weight"] = np.asarray(params[name]["kernel"]).T
        out[f"{key}.bias"] = np.asarray(params[name]["bias"])
    return out


def _shared_mlp(out: Dict[str, np.ndarray], prefix: str, p: Dict,
                s: Dict) -> None:
    """A flax SharedMLP (dense{j}, bn{j}) -> layer{j}.conv / layer{j}.bn.bn."""
    j = 0
    while f"dense{j}" in p:
        k = np.asarray(p[f"dense{j}"]["kernel"])  # (Fin, Fout)
        out[f"{prefix}.layer{j}.conv.weight"] = k.T[:, :, None, None]
        _bn(out, f"{prefix}.layer{j}.bn.bn", p[f"bn{j}"], s[f"bn{j}"])
        j += 1


def pointnet2_flax_to_torch(params: Dict, stats: Dict,
                            prefix: str = "") -> Dict[str, np.ndarray]:
    """A Pointnet2MSG's flax trees -> the port's names (module docstring)."""
    out: Dict[str, np.ndarray] = {}
    k = 0
    while f"sa{k}" in params:
        i = 0
        while f"mlp{i}" in params[f"sa{k}"]:
            _shared_mlp(out, f"{prefix}SA_modules.{k}.mlps.{i}",
                        params[f"sa{k}"][f"mlp{i}"],
                        stats[f"sa{k}"][f"mlp{i}"])
            i += 1
        k += 1
    k = 0
    while f"fp{k}" in params:
        _shared_mlp(out, f"{prefix}FP_modules.{k}.mlp",
                    params[f"fp{k}"]["mlp"], stats[f"fp{k}"]["mlp"])
        k += 1
    return out


def _conv(out: Dict[str, np.ndarray], prefix: str, p: Dict) -> None:
    """A flax conv (kernel HWIO, bias) -> weight OIHW, bias."""
    out[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]),
                                           (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def fcn_flax_to_torch(params: Dict, batch_stats: Dict
                      ) -> Dict[str, torch.Tensor]:
    """An FCNHead's flax trees -> the port's FCNHead state dict (module
    docstring).  MaskedBatchNorm already tracks the unbiased variance in
    the JAX package, so `var` is `running_var` as it stands."""
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"conv{i}" in params:
        _conv(sd, f"convs.{i}.conv", params[f"conv{i}"])
        _bn(sd, f"convs.{i}.norm_name", params[f"bn{i}"],
            batch_stats[f"bn{i}"])
        i += 1
    _conv(sd, "conv_seg", params["conv_seg"])
    return _tensors(sd)


def _linear(out: Dict[str, np.ndarray], prefix: str, p: Dict) -> None:
    """A flax Dense -> Linear: kernel (in, out) -> weight (out, in)."""
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def jigsaw_flax_to_torch(params: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """A JigsawHead's flax params -> the port's names (module docstring)."""
    out: Dict[str, np.ndarray] = {}
    if "fc1" in params:
        _linear(out, f"{prefix}.fc1.0", params["fc1"])
    else:
        _linear(out, f"{prefix}.fc1.0", params["fc1a"])
        _linear(out, f"{prefix}.fc1.2", params["fc1b"])
    _linear(out, f"{prefix}.fc2", params["fc2"])
    return out


def baseline_flax_to_torch(params: Dict[str, Any],
                           batch_stats: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """SingleModalModel, CMCDualModel or CMCSharedModel flax trees (or a
    moco run's params_ema with the model's batch_stats) -> the port
    model's state dict (module docstring)."""
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("encoder"):
            for k, v in resnet_flax_to_torch(
                    p, batch_stats.get(name, {})).items():
                sd[f"{name}.{k}"] = v
        elif name.endswith("_jig"):
            sd.update(jigsaw_flax_to_torch(p, name))
        else:
            sd.update(head_flax_to_torch(p, name))
    return _tensors(sd)


def linear_flax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """A LinearClassifier's flax params -> its state dict (fc.weight,
    fc.bias)."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "fc", params["fc"])
    return _tensors(sd)


def flax_to_port_state_dict(params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """HCMoCoModel or HCMoCoPNModel flax trees -> the port model's state
    dict (the PN model's encoder2 holds sa0/fp0 modules)."""
    sd: Dict[str, np.ndarray] = {}
    encoders = ["encoder1"]
    if "sa0" in params["encoder2"]:
        sd.update(pointnet2_flax_to_torch(params["encoder2"],
                                          batch_stats["encoder2"],
                                          "encoder2."))
    else:
        encoders.append("encoder2")
    for enc in encoders:
        for k, v in hrnet_flax_to_torch(params[enc],
                                        batch_stats.get(enc, {})).items():
            sd[f"{enc}.{k}"] = v
    sd.update(sgcn_flax_to_torch(params["encoder3"], batch_stats["encoder3"],
                                "encoder3."))
    for h in ("head1", "head2", "head3"):
        sd.update(head_flax_to_torch(params[h], h))
    for lin in ("encoder1_linear", "encoder2_linear"):
        if lin not in params:
            continue
        if "dense0" in params[lin]:  # HCMoCoPNModel's point head, a SharedMLP
            _shared_mlp(sd, lin, params[lin], batch_stats[lin])
        else:  # a 1x1 conv with bias
            sd[f"{lin}.weight"] = np.transpose(
                np.asarray(params[lin]["kernel"]), (3, 2, 0, 1))
            sd[f"{lin}.bias"] = np.asarray(params[lin]["bias"])
    return _tensors(sd)


def seg_flax_to_torch(params: Dict, batch_stats: Dict
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's SegHRNet trees -> the port's SegHRNet state dict
    (module docstring)."""
    sd = dict(hrnet_flax_to_torch(params["backbone"],
                                  batch_stats.get("backbone", {})))
    _conv(sd, "last_layer.0", params["last_conv1"])
    _bn(sd, "last_layer.1", params["last_bn"], batch_stats["last_bn"])
    _conv(sd, "last_layer.3", params["last_conv2"])
    return _tensors(sd)


A2J_HEADS = ("classificationModel", "regressionModel",
             "DepthRegressionModel")


def anchor_head_flax_to_torch(params: Dict, batch_stats: Dict,
                              prefix: str = "") -> Dict[str, np.ndarray]:
    """One A2J AnchorHead's flax trees -> conv{i}, bn{i} (i = 1..4) and
    output under `prefix` (numpy)."""
    out: Dict[str, np.ndarray] = {}
    for i in range(1, 5):
        _conv(out, f"{prefix}conv{i}", params[f"conv{i}"])
        _bn(out, f"{prefix}bn{i}", params[f"bn{i}"], batch_stats[f"bn{i}"])
    _conv(out, f"{prefix}output", params["output"])
    return out


def a2j_flax_to_torch(params: Dict, batch_stats: Dict
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's A2JHRNet or A2JResNet trees -> the port's state
    dict of the same model (module docstring; A2JResNet's backbone through
    resnet_flax_to_torch, under `Backbone.model.`)."""
    bp, bs = params["Backbone"], batch_stats.get("Backbone", {})
    if "stem_conv" in bp:
        sd = {f"Backbone.model.{k}": v
              for k, v in resnet_flax_to_torch(bp, bs).items()}
    else:
        sd = {f"Backbone.{k}": v
              for k, v in hrnet_flax_to_torch(bp, bs).items()}
    for head in A2J_HEADS:
        if head in params:  # is_3d=False has no depth head
            sd.update(anchor_head_flax_to_torch(
                params[head], batch_stats[head], f"{head}."))
    return _tensors(sd)
