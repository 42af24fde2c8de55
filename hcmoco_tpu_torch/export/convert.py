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

BN running variance: flax tracks the biased batch variance, torch the
unbiased one.  The port keeps torch semantics, and a flax `var` becomes
`running_var` unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .transfer import hrnet_flax_to_torch


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


def sgcn_flax_to_torch(params: Dict, stats: Dict,
                       prefix: str = "") -> Dict[str, np.ndarray]:
    """One SemGCN's flax trees -> reference torch names (numpy), the
    inverse of hcmoco_tpu.export.transfer._sgcn_torch_to_flax."""
    out: Dict[str, np.ndarray] = {}
    _gconv(out, f"{prefix}gconv_input.0.gconv", params["gconv_input"]["gconv"])
    _bn(out, f"{prefix}gconv_input.0.bn", params["gconv_input"]["bn"],
        stats["gconv_input"]["bn"])
    i = 0
    while f"res{i}" in params:
        for g in ("gconv1", "gconv2"):
            base = f"{prefix}gconv_layers.{i}.{g}"
            _gconv(out, f"{base}.gconv", params[f"res{i}"][g]["gconv"])
            _bn(out, f"{base}.bn", params[f"res{i}"][g]["bn"],
                stats[f"res{i}"][g]["bn"])
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
        if lin in params:
            sd[f"{lin}.weight"] = np.transpose(
                np.asarray(params[lin]["kernel"]), (3, 2, 0, 1))
            sd[f"{lin}.bias"] = np.asarray(params[lin]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
