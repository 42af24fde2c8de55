"""The benchmark's inputs: batches of the NTU-RGBD + MPII stage-1 fields,
made on the device from the seed, and the draws that pin each step.

The fields and their distributions are those of the program's synthetic
generator (the field layout of pycontrast's NTUMPII GCN dataset):
ImageNet-normalised RGB as a unit normal, a mean-subtracted depth map of
smooth ~0.3 m relief plus sensor noise on 60% of the pixels, root-centred
2D joints, the crop-tracked pixel grid and a depth mean a sample.  They
are drawn on the card with one torch.Generator in a few large calls: the
program's numpy generator took 15-21 s of every run's set-up at a batch
of 224.  A traffic file sets `depth_ratio`, and every batch has exactly
round(batch * depth_ratio) samples with depth, in an order drawn from the
seed, so that every seed does the same work.

Each batch also carries its pin: `neg_idx` (B, K+1), the bank rows of
each sample's NCE, its own row first and then K rows drawn uniformly
over the bank, as CMCMem3 draws them.  Program and reference read the
same tensors.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

NUM_JOINTS = 16


def make_batch(g: torch.Generator, run: dict, device) -> Dict:
    """One global batch of the cell, tensors on `device`."""
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
    return batch


def make_pool(run: dict, seed: int, device) -> List[Dict]:
    """`run['pool']` distinct global batches of the cell, on `device`."""
    g = torch.Generator(device=device).manual_seed(seed + 2)
    return [make_batch(g, run, device) for _ in range(run["pool"])]
