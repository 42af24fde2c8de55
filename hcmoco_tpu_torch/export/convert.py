"""JAX package trees -> the port's state dict.

`flax_to_port_state_dict` takes an HCMoCoModel's flax `params` and
`batch_stats` (as numpy arrays) and returns the reference-named torch state
dict that hcmoco_tpu_torch's HCMoCoModel loads with strict=True.  The
HRNet encoders reuse hcmoco_tpu.export.transfer's numpy name tables; the
SemGCN and head maps are the inverses of its `_sgcn_torch_to_flax` and
`hcmoco_torch_to_flax` head mapping.

BN running variance: flax tracks the biased batch variance, torch the
unbiased one.  The port keeps torch semantics, and a flax `var` becomes
`running_var` unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hcmoco_tpu.export.transfer import hrnet_flax_to_torch


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


def flax_to_port_state_dict(params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """HCMoCoModel flax trees -> the port's HCMoCoModel state dict."""
    sd: Dict[str, np.ndarray] = {}
    for enc in ("encoder1", "encoder2"):
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
