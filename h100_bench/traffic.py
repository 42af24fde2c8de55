"""The benchmark's inputs: batches of the NTU-RGBD + MPII stage-1 fields,
made on the device from the seed, and the draws that pin each step.

The fields and their distributions are those of the program's synthetic
generator (the field layout of pycontrast's NTUMPII GCN dataset):
ImageNet-normalised RGB as a unit normal, a mean-subtracted depth map of
smooth ~0.3 m relief plus sensor noise on 60% of the pixels, and
root-centred 2D joints.  They are drawn on the card with one
torch.Generator in a few large calls: the program's numpy generator took
15-21 s of every run's set-up at a batch of 224.  A traffic file sets
`depth_ratio`, and every batch has exactly round(batch * depth_ratio)
samples with depth, in an order drawn from the seed, so that every seed
does the same work.

Every batch carries `rgbd`, `index`, `skeleton`, `use_depth`, `use_rgb`
and its pin `neg_idx` (B, K+1): the bank rows of each sample's NCE, its
own row first and then K rows drawn uniformly over the bank, as CMCMem3
draws them.  The caller names the further fields that the cell's
architecture reads (the `FIELDS` of its reference file,
reference/archs/<arch>.py), and the pool carries those too, each made
by its function in `EXTRA`, from a generator stream of their own drawn
after the batch's, so that the other fields are the same with or
without them:

  depth_mask  (B, H, W) f32, the depth's valid pixels: the mask the
              depth was drawn with, no new draw;
  grid_xy     (B, H, W, 2) f32, the pixel grid as the program's synthetic
              generator makes it (row, column), no draw;
  depth_mean  (B,) f32, each sample's depth mean, uniform over 2-4 m;
  pts_u       (B, pn_num_points) f32 uniforms in [0, 1) that pin the
              depth2pts draw of the point cloud.

Program and reference read the same tensors.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

NUM_JOINTS = 16


def _grid_xy(g, run, b, mask, device):
    s = run["crop_size"]
    ar = torch.arange(s, dtype=torch.float32, device=device)
    rows, cols = torch.meshgrid(ar, ar, indexing="ij")
    return torch.stack([rows, cols], -1).expand(b, s, s, 2).contiguous()


# name -> fn(generator, run, batch size, depth mask, device)
EXTRA = {
    "depth_mask": lambda g, run, b, mask, device: mask,
    "grid_xy": _grid_xy,
    "depth_mean": lambda g, run, b, mask, device: torch.rand(
        b, generator=g, device=device) * 2 + 2,
    "pts_u": lambda g, run, b, mask, device: torch.rand(
        (b, run["pn_num_points"]), generator=g, device=device),
}


def make_batch(g: torch.Generator, run: dict, device, extra=(),
               g_extra: torch.Generator = None) -> Dict:
    """One global batch of the cell, tensors on `device`; the fields
    `extra` drawn from `g_extra`."""
    b, s, n_data = run["batch_size"], run["crop_size"], run["n_data"]
    kw = dict(generator=g, device=device)
    rgb = torch.randn((b, s, s, 3), **kw)
    depth_count = int(round(b * run["depth_ratio"]))
    use_depth = (torch.randperm(b, **kw) < depth_count).to(torch.int32)
    mask = (torch.rand((b, s, s), **kw) > 0.4).float() * use_depth[:, None,
                                                                  None]
    ls = max(s // 16, 2)
    relief = F.interpolate(torch.randn((b, 1, ls, ls), **kw), size=(s, s),
                           mode="bilinear", align_corners=True)[:, 0]
    depth = (relief * 0.3 + torch.randn((b, s, s), **kw) * 0.01) * mask
    batch = {
        "rgbd": torch.cat([rgb, depth[..., None].expand(b, s, s, 3)], -1),
        "index": torch.randint(0, n_data, (b,), dtype=torch.int32, **kw),
        "skeleton": torch.rand((b, NUM_JOINTS, 2), **kw) * 2 - 1,
        "use_depth": use_depth,
        "use_rgb": torch.ones(b, dtype=torch.int32, device=device),
    }
    draws = torch.randint(0, n_data, (b, run["nce_k"]), **kw)
    batch["neg_idx"] = torch.cat([batch["index"].long()[:, None], draws], 1)
    for name in extra:
        batch[name] = EXTRA[name](g_extra, run, b, mask, device)
    return batch


def make_pool(run: dict, seed: int, device, fields=()) -> List[Dict]:
    """`run['pool']` distinct global batches of the cell, on `device`,
    with the further `fields` of `EXTRA` that its architecture reads."""
    extra = tuple(fields)
    unknown = set(extra) - set(EXTRA)
    if unknown:
        raise ValueError(f"arch {run['arch']!r} reads fields that traffic.py "
                         f"does not make: {sorted(unknown)}")
    g = torch.Generator(device=device).manual_seed(seed + 2)
    g_extra = torch.Generator(device=device).manual_seed(seed + 3)
    return [make_batch(g, run, device, extra, g_extra)
            for _ in range(run["pool"])]
