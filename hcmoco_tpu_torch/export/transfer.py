"""Flax HRNet and ResNet trees -> the reference torch key layout (numpy).

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
mean/var -> running_mean/running_var.  `resnet_flax_to_torch` does the same
for the baselines' ResNet and CMCResNet (the inverse of the JAX package's
_resnet_torch_name: stem_conv|stem_v{1,2}|stem_bn -> conv1|conv1_v{1,2}|bn1,
layer{s}_block{b}/c{k}_{conv,bn}|ds_{conv,bn} -> layer{s}.{b}.conv{k}/bn{k}
|downsample.{0,1}), and for a ResNeSt tree, of which the JAX package maps
none, to the port's names (`_resnest_torch_name`).

`load_imagenet_pretrained` is the counterpart of the JAX package's loader of
the same name (over `hrnet_torch_to_flax`): the port already holds the
reference names, so it is a filtered load, `load_hrnet_state`, which the
downstream trainers' `--pretrained` loads share.  `export_encoder` is the
counterpart of its `export_encoder` (transfer_ckpt): the port's model
state dict already holds the reference names under `encoderN.`, so export
strips that prefix.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

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


def _resnet_torch_name(path: Tuple[str, ...]) -> Optional[str]:
    """One flax ResNet / CMCResNet module path -> its torch prefix (the
    inverse of the JAX package's _resnet_torch_name): stem_conv -> conv1,
    stem_v{1,2} -> conv1_v{1,2}, stem_bn -> bn1,
    layer{s}_block{b}/c{k}_{conv,bn} -> layer{s}.{b}.{conv,bn}{k},
    layer{s}_block{b}/ds_{conv,bn} -> layer{s}.{b}.downsample.{0,1}."""
    stem = {"stem_conv": "conv1", "stem_v1": "conv1_v1",
            "stem_v2": "conv1_v2", "stem_bn": "bn1"}
    if len(path) == 1:
        return stem.get(path[0])
    m = re.fullmatch(r"layer(\d)_block(\d+)", path[0])
    m2 = re.fullmatch(r"(c\d|ds)_(conv|bn)", path[1])
    if not (m and m2 and len(path) == 2):
        return None
    s, b = m.groups()
    part, kind = m2.groups()
    if part == "ds":
        return f"layer{s}.{b}.downsample.{0 if kind == 'conv' else 1}"
    return f"layer{s}.{b}.{kind}{part[1]}"


# the ResNeSt deep stem (flax stem{i}/stem_bn{i}) -> the public ResNeSt
# code's conv1 Sequential and bn1
_RESNEST_STEM = {"stem0": "conv1.0", "stem_bn0": "conv1.1",
                 "stem1": "conv1.3", "stem_bn1": "conv1.4",
                 "stem2": "conv1.6", "stem_bn2": "bn1"}


def _resnest_torch_name(path: Tuple[str, ...]) -> Optional[str]:
    """One flax ResNeSt module path -> its torch prefix (models/resnest.py
    of the port): the stem by _RESNEST_STEM, layer{s}_block{b}/{name}[/sub]
    -> layer{s}.{b}.{name}[.sub] (SplAtConv2d's conv, bn0, fc1, bn1, fc2
    under conv2), ds_conv / ds_bn -> downsample.1 / downsample.2."""
    if len(path) == 1:
        return _RESNEST_STEM.get(path[0])
    m = re.fullmatch(r"layer(\d)_block(\d+)", path[0])
    if not m:
        return None
    s, b = m.groups()
    rest = {"ds_conv": "downsample.1", "ds_bn": "downsample.2"}.get(
        path[1], path[1])
    return ".".join((f"layer{s}", b, rest) + tuple(path[2:]))


def resnet_flax_to_torch(params: Dict, batch_stats: Dict) -> Dict[str, Any]:
    """One flax ResNet's, CMCResNet's or ResNeSt's params + stats -> the
    reference torch names (numpy): convs HWIO -> OIHW (and a conv's bias),
    BN scale/bias -> weight/bias, mean/var -> running_mean/running_var."""
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    out: Dict[str, np.ndarray] = {}
    torch_name = (_resnest_torch_name if "stem0" in params
                  else _resnet_torch_name)
    for path, v in flat_p.items():
        name = torch_name(path[:-1])
        if name is None:
            continue
        leaf = path[-1]
        if leaf == "kernel":
            out[f"{name}.weight"] = np.transpose(v, (3, 2, 0, 1))
        elif leaf in ("scale", "bias"):
            out[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = v
            mod = path[:-1]
            if mod + ("mean",) in flat_s and leaf == "scale":
                out[f"{name}.running_mean"] = flat_s[mod + ("mean",)]
                out[f"{name}.running_var"] = flat_s[mod + ("var",)]
                out[f"{name}.num_batches_tracked"] = np.asarray(0)
    return out


_BN_TENSORS = ("weight", "bias", "running_mean", "running_var")


def load_hrnet_state(state_dict: Dict[str, Any], encoder,
                     skip: Tuple[str, ...] = ()) -> int:
    """Copy a torch HRNet state dict into the HRNet `encoder` (a bare
    backbone, or a model whose backbone sits at the top level under the
    reference names, as the parsing model's does; a ResNet the same way,
    by its reference names), in place: per conv its
    weight, per BN its weight, bias, running mean and running var, where
    the dict holds the same name at the same shape; every other tensor is
    skipped, like the reference's filtered load (official_hrnet.py:461-473,
    seg_hrnet.py:456-480).  Modules under a child named in `skip` (a head
    of the model) take nothing.  Returns the number of conv weights
    loaded, the count of the JAX package's hrnet_torch_to_flax.  A conv
    with a bias (ResNeSt's fc1/fc2) takes the dict's bias too."""
    import torch

    total = 0
    with torch.no_grad():
        for name, mod in encoder.named_modules():
            if name.split(".")[0] in skip:
                continue
            if isinstance(mod, torch.nn.Conv2d):
                w = state_dict.get(f"{name}.weight")
                if w is not None and w.shape == mod.weight.shape:
                    mod.weight.copy_(w)
                    total += 1
                b = state_dict.get(f"{name}.bias")
                if (mod.bias is not None and b is not None
                        and b.shape == mod.bias.shape):
                    mod.bias.copy_(b)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                for t in _BN_TENSORS:
                    v = state_dict.get(f"{name}.{t}")
                    if v is not None and v.shape == getattr(mod, t).shape:
                        getattr(mod, t).copy_(v)
    return total


def read_state_dict(path: str) -> Dict[str, Any]:
    """A torch state dict from `path` on the CPU (a pickled module gives
    its state_dict())."""
    import torch

    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def load_imagenet_pretrained(path: str, model, encoder_names=("encoder1",
                                                              "encoder2")
                             ) -> int:
    """--IN_Pretrain / --depth_Pretrain: initialise the encoders
    `encoder_names` of `model` (HRNets, or the baselines' ResNets and CMC
    trunk), in place, from a torch state dict under the reference names
    (e.g. ImageNet pretrain; build_backbone.py:547-560) through
    `load_hrnet_state`, whose filtered load is by module name and so
    serves any of them; the classifier or a stem of another width is
    skipped.  A whole model's dict whose keys carry the encoder's prefix
    (`encoder.`, as tests/golden/rgb_moco_torch_keys.txt) gives that
    encoder its part.  An encoder of another kind (HRNetPN's PointNet++)
    takes nothing.  Returns the number of conv weights loaded.  The JAX
    package's loader maps HRNet names only (into a ResNet or a ResNeSt it
    loads nothing); the port's loads a ResNeSt by the public ResNeSt
    code's names."""
    from ..models.hrnet import HRNet
    from ..models.resnest import ResNeSt
    from ..models.resnet import CMCResNet, ResNet

    sd = read_state_dict(path)
    total = 0
    for enc in encoder_names:
        encoder = getattr(model, enc, None)
        if isinstance(encoder, (HRNet, ResNet, CMCResNet, ResNeSt)):
            prefix = f"{enc}."
            part = {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
            total += load_hrnet_state(part or sd, encoder)
    return total


def export_encoder(state_dict: Dict[str, Any], encoder_name: str,
                   out_path: str) -> Dict[str, Any]:
    """transfer_ckpt: write the flat reference-named HRNet state dict of
    `encoder1` (RGB) or `encoder2` (depth) of a model state dict (a
    pre-training or a segmentor checkpoint's `model`) to out_path (.pth),
    as CPU tensors; returns it.  Raises for an encoder that is not an
    HRNet (HRNetPN's encoder2 is a PointNet++)."""
    import torch

    prefix = f"{encoder_name}."
    sd = {k[len(prefix):]: v.detach().cpu().clone()
          for k, v in state_dict.items() if k.startswith(prefix)}
    if "conv1.weight" not in sd or not any(k.startswith("stage4.")
                                           for k in sd):
        raise ValueError(f"export_encoder: {encoder_name} of this state "
                         "dict is not an HRNet")
    torch.save(sd, out_path)
    return sd
