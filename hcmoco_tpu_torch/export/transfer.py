"""Flax HRNet trees -> the reference torch key layout (numpy).

The port's own copy of the name tables of hcmoco_tpu/export/transfer.py
(`_flatten`, `_convbn_torch_names`, `_translate_convbn`,
`hrnet_flax_to_torch`), so that no module of the port imports the JAX
package; tests/test_torch_export.py holds the two to identical output.

Name mapping (flax -> torch):
  stem{1,2}/conv|bn                -> conv{1,2} / bn{1,2}
  layer1_block{b}/cb{1..3}|downsample -> layer1.{b}.conv{k}/bn{k}|downsample.{0,1}
  transition{t}_{i}[_{j}]          -> transition{t}.{i}.[{j}.]{0,1}
  stage{s}_module{m}/branch{i}_block{b}/cb{1,2}
                                   -> stage{s}.{m}.branches.{i}.{b}.conv{k}/bn{k}
  stage{s}_module{m}/fuse{i}_{j}[_{k}] -> stage{s}.{m}.fuse_layers.{i}.{j}.[{k}.]{0,1}
Convs transpose HWIO -> OIHW; BN scale/bias -> weight/bias and batch_stats
mean/var -> running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _convbn_torch_names(flax_path: str) -> Optional[str]:
    """Map a flax module path prefix to the torch prefix of its conv/bn
    pair; None if unknown."""
    m = re.fullmatch(r"stem([12])", flax_path)
    if m:
        return f"__stem{m.group(1)}"  # special: conv1/bn1 flat names
    m = re.fullmatch(r"layer1_block(\d+)", flax_path)
    if m:
        return f"layer1.{m.group(1)}"
    m = re.fullmatch(r"transition(\d)_(\d+)_(\d+)", flax_path)
    if m:
        t, i, j = m.groups()
        return f"transition{t}.{i}.{j}"
    m = re.fullmatch(r"transition(\d)_(\d+)", flax_path)
    if m:
        t, i = m.groups()
        return f"transition{t}.{i}"
    m = re.fullmatch(r"stage(\d)_module(\d+)", flax_path)
    if m:
        s, mm = m.groups()
        return f"stage{s}.{mm}"
    return None


def _translate_convbn(names) -> Optional[tuple]:
    """names: path of module names ending with the ConvBN module.
    Returns (torch_conv_prefix, torch_bn_prefix)."""
    if len(names) == 1:
        m = re.fullmatch(r"stem([12])", names[0])
        if m:
            i = m.group(1)
            return (f"conv{i}", f"bn{i}")
        base = _convbn_torch_names(names[0])
        if base and base.startswith("transition"):
            return (f"{base}.0", f"{base}.1")
        return None
    if names[0].startswith("layer1_block"):
        blk = _convbn_torch_names(names[0])
        leaf = names[1]
        if leaf == "downsample":
            return (f"{blk}.downsample.0", f"{blk}.downsample.1")
        k = leaf[-1]
        return (f"{blk}.conv{k}", f"{blk}.bn{k}")
    if names[0].startswith("stage"):
        mod = _convbn_torch_names(names[0])
        leaf = names[1]
        m = re.fullmatch(r"branch(\d+)_block(\d+)", leaf)
        if m:
            i, b = m.groups()
            sub = names[2]
            if sub == "downsample":
                return (f"{mod}.branches.{i}.{b}.downsample.0",
                        f"{mod}.branches.{i}.{b}.downsample.1")
            k = sub[-1]
            return (f"{mod}.branches.{i}.{b}.conv{k}",
                    f"{mod}.branches.{i}.{b}.bn{k}")
        m = re.fullmatch(r"fuse(\d+)_(\d+)_(\d+)", leaf)
        if m:
            i, j, k = m.groups()
            return (f"{mod}.fuse_layers.{i}.{j}.{k}.0",
                    f"{mod}.fuse_layers.{i}.{j}.{k}.1")
        m = re.fullmatch(r"fuse(\d+)_(\d+)", leaf)
        if m:
            i, j = m.groups()
            return (f"{mod}.fuse_layers.{i}.{j}.0",
                    f"{mod}.fuse_layers.{i}.{j}.1")
    return None


def hrnet_flax_to_torch(params: Dict, batch_stats: Dict) -> Dict[str, Any]:
    """One HRNet encoder's flax params + stats -> reference torch names
    (numpy arrays)."""
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    out: Dict[str, np.ndarray] = {}

    def emit_conv(torch_prefix, arr):
        out[f"{torch_prefix}.weight"] = np.transpose(arr, (3, 2, 0, 1))

    def emit_bn(torch_prefix, path):
        scale = flat_p.get(path + ("scale",))
        bias = flat_p.get(path + ("bias",))
        mean = flat_s.get(path + ("mean",))
        var = flat_s.get(path + ("var",))
        if scale is not None:
            out[f"{torch_prefix}.weight"] = scale
        if bias is not None:
            out[f"{torch_prefix}.bias"] = bias
        if mean is not None:
            out[f"{torch_prefix}.running_mean"] = mean
            out[f"{torch_prefix}.running_var"] = var
            out[f"{torch_prefix}.num_batches_tracked"] = np.asarray(0)

    # one ConvBN module per (..., 'conv', 'kernel') leaf
    convbn_prefixes = sorted(
        {p[:-2] for p in flat_p if p[-2] == "conv" and p[-1] == "kernel"})
    for pref in convbn_prefixes:
        torch_name = _translate_convbn(list(pref))
        if torch_name is None:
            continue
        emit_conv(torch_name[0], flat_p[pref + ("conv", "kernel")])
        emit_bn(torch_name[1], pref + ("bn",))
    return out
