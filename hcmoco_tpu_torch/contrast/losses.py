"""HCMoCo contrastive losses (counterpart of hcmoco_tpu/contrast/losses.py).

Behavioural spec: the loss methods of pycontrast/learning/
contrast_trainer.py:
  * `_compute_loss_accuracy` (:212-253): modality-masked CE over the six
    NCE directions;
  * `_compute_soft_pri3d_loss_accuracy` (:642-723): dense intra-sample
    contrast with pixel-distance soft targets (stage 2);
  * `_compute_joints_pri3d_loss_accuracy` (:744-828): joint-level InfoNCE
    between the image maps and SemGCN's joint features (stage 2);
  * `_compute_cross_subject_joints_pri3d_loss` (:830-892): structure-aware
    cross-sample joint contrast, SCL (stage 2);
  * `_gaussian_joint_pooling` (:725-742).

The reference's data-dependent early returns become masked means with
clamped denominators, as in the JAX package, so the step never syncs with
the host on the masks.

Under data parallelism (parallel/mesh.py) the losses are the JAX
package's global-batch means: each rank keeps its numerators local, and
every denominator and gate (mask counts, `use_depth.sum() > 0`) is summed
over the ranks with no gradient.  A rank's loss is then its share of the
global loss, the shares add up to it over the ranks, and so do their
gradients (the step all-reduces the gradients as a sum).  In a world of
one every function here computes what it did before.

Dense maps are NCHW (B, C, h, w), the port's
layout; the joint index follows the reference: joints2d[..., 0] is the
row, [..., 1] the column, flat index row * h + col after //4 and clamping.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.heads import gaussian_blur_nhwc
from ..models.hrnet import nearest_resize
from ..ops.point_ops import gather_points
from ..parallel.mesh import gather_rows, global_sum, my_rows, world_size
from .memory import _l2norm


def _pixel_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C) f32, pixels in raster order (a view for
    an f32 channels_last map)."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c).float()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean of x over rows where mask, 0 if the mask is empty; the mask's
    count is the global batch's (this rank's share of the mean)."""
    mask = mask.float()
    total = global_sum(mask.sum())
    return torch.sum(x * mask) / torch.clamp(total, min=1.0) \
        * torch.sign(total)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch's rows (this rank's share)."""
    size = world_size()
    if size == 1:
        return x.mean()
    return x.sum() / (x.numel() * size)


def per_sample_nce(logits: torch.Tensor):
    """Per-sample CE-to-class-0 and top-1 indicator of (bsz, K+1) logits
    (the positive in column 0 wins ties, as torch argmax does)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    ce = torch.logsumexp(logits, dim=-1) - logits[:, 0]
    correct = (logits.argmax(dim=-1) == 0).float()
    return ce, correct


def masked_six_way(per_sample: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   use_depth: Optional[torch.Tensor] = None,
                   use_rgb: Optional[torch.Tensor] = None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Modality masking over six per-sample (ce, correct) pairs, order
    (12, 21, 23, 32, 13, 31).

    use_depth only: the four pairs touching depth are restricted to depth
    rows, the rgb<->skeleton pairs are not.  Both masks: all six are
    restricted to rows with both modalities; when there is none, the first
    four are 0 and the last two fall back to the whole batch."""
    losses, accs = [], []
    if use_rgb is not None:
        if use_depth is None:
            raise ValueError("masked_six_way: use_rgb needs use_depth")
        together = (use_depth == 1) & (use_rgb == 1)
        any_together = global_sum(together.sum()) > 0
        for i, (ce, cor) in enumerate(per_sample):
            loss, acc = _masked_mean(ce, together), _masked_mean(cor, together)
            if i >= 4:
                loss = torch.where(any_together, loss, _mean(ce))
                acc = torch.where(any_together, acc, _mean(cor))
            losses.append(loss)
            accs.append(acc)
    elif use_depth is not None:
        depth_ok = use_depth == 1
        for i, (ce, cor) in enumerate(per_sample):
            if i <= 3:
                losses.append(_masked_mean(ce, depth_ok))
                accs.append(_masked_mean(cor, depth_ok))
            else:
                losses.append(_mean(ce))
                accs.append(_mean(cor))
    else:
        for ce, cor in per_sample:
            losses.append(_mean(ce))
            accs.append(_mean(cor))
    return losses, accs


def nce_loss_and_acc(logits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE-to-class-0 and top-1 accuracy of (bsz, K+1) logits over the
    global batch (this rank's share under data parallelism)."""
    ce, correct = per_sample_nce(logits)
    return _mean(ce), _mean(correct)


def compute_loss_accuracy(logits: Sequence[torch.Tensor],
                          use_depth: Optional[torch.Tensor] = None,
                          use_rgb: Optional[torch.Tensor] = None):
    """The masked NCE of logit matrices, one per direction
    (contrast_trainer.py:212-253): masked_six_way of per_sample_nce."""
    return masked_six_way([per_sample_nce(lg) for lg in logits], use_depth,
                          use_rgb)


# ---- stage 2: dense soft-Pri3D ---------------------------------------------


def sample_valid_pixels(mask: torch.Tensor, num_samples: int,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """(B, P) 0/1 mask -> (B, num_samples) int64 pixel indices drawn
    uniformly over each row's valid pixels with replacement
    (torch.multinomial, contrast_trainer.py:683); a row with no valid
    pixel draws uniformly over all of them, as the JAX package does."""
    ok = mask.sum(-1, keepdim=True) > 0
    weights = torch.where(ok, mask.float(), 1.0)
    return torch.multinomial(weights, num_samples, replacement=True,
                             generator=generator)


def soft_pri3d_loss(merge1: torch.Tensor, merge2: torch.Tensor,
                    depth_mask: torch.Tensor, num_samples: int,
                    temperature: float,
                    use_depth: Optional[torch.Tensor] = None,
                    sample_ind: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Dense intra-sample contrast with pixel-distance soft targets
    (contrast_trainer.py:642-723).

    merge1, merge2 (B, C, h, w): the rgb and depth maps (linear_merge1/2);
    depth_mask (B, H, W), resized to (h, w) by `nearest_resize`.  Per
    image, `num_samples` valid-depth pixels (sample_ind (B, S) when given,
    else drawn from `generator`), their channel vectors L2-normalised in
    both modalities, the (S, S) cross-modal similarities over temperature
    cross-entropied against softmax(-pixel distance) along the key axis
    (dim 1).  An image with no valid pixel contributes 0, and the whole
    loss is 0 when use_depth has no 1 (the reference's early return, which
    is its only use of use_depth here).  Under data parallelism the pixels
    are drawn for the global batch (its masks gathered) and each rank keeps
    its rows, so the ranks draw what one process would.  Returns
    ([rgb2depth, depth2rgb] losses, [their accuracies])."""
    b, _, h, w = merge1.shape
    mask_small = nearest_resize(depth_mask.float()[:, None], h, w)
    mask_small = mask_small.reshape(b, h * w)
    img_ok = mask_small.sum(-1) > 0
    batch_ok = (global_sum(use_depth.sum()) > 0).float() \
        if use_depth is not None else 1.0
    if sample_ind is None:
        full = gather_rows(mask_small)  # the global batch's masks
        sample_ind = sample_valid_pixels(
            full, num_samples, generator)[my_rows(full.shape[0])]
    g1 = _l2norm(gather_points(_pixel_rows(merge1), sample_ind))
    g2 = _l2norm(gather_points(_pixel_rows(merge2), sample_ind))
    # logits[b, i, j] = <key_i, query_j> / T (matmul(m2^T, m1), :700)
    rgb2depth = torch.einsum("bic,bjc->bij", g2, g1) / temperature
    depth2rgb = torch.einsum("bic,bjc->bij", g1, g2) / temperature

    ind = sample_ind.long()
    yx = torch.stack([ind // w, ind % w], dim=-1).float()  # (B, S, 2)
    dist = torch.sqrt(((yx[:, :, None, :] - yx[:, None, :, :]) ** 2)
                      .sum(-1))
    soft_target = torch.softmax(-dist, dim=1)  # over the key axis

    target = torch.arange(sample_ind.shape[1], device=merge1.device)
    losses, accs = [], []
    for lg in (rgb2depth, depth2rgb):
        per_img = -(soft_target * F.log_softmax(lg, dim=1)).sum(1).mean(-1)
        losses.append(_masked_mean(per_img, img_ok) * batch_ok)
        hit = (lg.argmax(dim=1) == target).float().mean(-1)
        accs.append(_masked_mean(hit, img_ok) * batch_ok)
    return losses, accs


# ---- stage 2: sparse joint losses ------------------------------------------


def gather_joint_features(feat: torch.Tensor,
                          joints2d: torch.Tensor) -> torch.Tensor:
    """Per-joint feature vectors at joints2d // 4 on a stride-4 NCHW map
    (contrast_trainer.py:755-763); joints2d (B, J, 2) full-resolution
    (row, col).  Both coordinates are clamped to [0, h) and flattened as
    row * h + col, the reference's, which assumes a square map.  Returns
    (B, J, C) f32."""
    h = feat.shape[2]
    j = torch.clamp(torch.div(joints2d, 4, rounding_mode="floor").long(),
                    0, h - 1)
    return gather_points(_pixel_rows(feat), j[..., 0] * h + j[..., 1])


def gaussian_joint_pooling(feat: torch.Tensor,
                           joints2d: torch.Tensor) -> torch.Tensor:
    """The map gaussian-blurred (5x5, sigma 1, reflect padding), then its
    joint features (`_gaussian_joint_pooling`, contrast_trainer.py:725-742);
    feat NCHW."""
    blurred = gaussian_blur_nhwc(feat.permute(0, 2, 3, 1), 5, 1.0)
    return gather_joint_features(blurred.permute(0, 3, 1, 2), joints2d)


def _masked_ce(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(reduction='mean') over (B, J_keys, J_pos) logits
    with target[b, j] = j, averaged over the valid (b, j)."""
    logsoft = F.log_softmax(logits.float(), dim=1)
    ce = -torch.diagonal(logsoft, dim1=1, dim2=2)  # (B, J)
    v = valid.float()
    return torch.sum(ce * v) / torch.clamp(global_sum(v.sum()), min=1.0)


def joints_pri3d_loss(rgb_map: torch.Tensor, d_map: torch.Tensor,
                      joint_feat: torch.Tensor, joints2d: torch.Tensor,
                      joints_vis: torch.Tensor, temperature: float,
                      use_depth: Optional[torch.Tensor] = None):
    """Joint InfoNCE (contrast_trainer.py:744-828): logits[b, i, j] =
    <joint_i, map feature at joint j> / T between SemGCN's joint features
    (B, J, C) and each map (NCHW), CE with class = position over the
    visible joints; the depth side also drops samples without depth.
    Returns ([rgb, depth] losses, [their accuracies])."""
    q = _l2norm(joint_feat.float())
    vis = joints_vis.bool()
    d_vis = vis if use_depth is None else vis & (use_depth == 1)[:, None]
    target = torch.arange(joints2d.shape[1], device=joints2d.device)
    losses, accs = [], []
    for fmap, valid in ((rgb_map, vis), (d_map, d_vis)):
        keys = _l2norm(gather_joint_features(fmap, joints2d))
        lg = torch.einsum("bic,bjc->bij", q, keys) / temperature
        losses.append(_masked_ce(lg, valid))
        v = valid.float()
        hit = (lg.argmax(dim=1) == target).float() * v
        per_img = hit.sum(-1) / torch.clamp(v.sum(-1), min=1.0)
        accs.append(_masked_mean(per_img, v.sum(-1) > 0))
    return losses, accs


def scl_joint_features(rgb_map: torch.Tensor, d_map: torch.Tensor,
                       joints2d: torch.Tensor):
    """The L2-normalised (B, J, C) rgb and depth joint features that the
    cross-subject SCL contrasts."""
    return (_l2norm(gather_joint_features(rgb_map, joints2d)),
            _l2norm(gather_joint_features(d_map, joints2d)))


def scl_loss(rgb_j: torch.Tensor, d_j: torch.Tensor,
             use_depth: torch.Tensor, use_rgb: torch.Tensor,
             temperature: float) -> torch.Tensor:
    """cross_subject_scl_loss from the joint features of its group."""
    b, j, c = rgb_j.shape
    cat = torch.cat([rgb_j.reshape(b * j, c), d_j.reshape(b * j, c)])
    n = 2 * b * j
    logsoft = F.log_softmax(cat @ cat.t() / temperature, dim=1)
    joint_id = torch.arange(j, device=cat.device).repeat(2 * b)
    pos = (joint_id[:, None] == joint_id[None, :]).float()
    pos = pos * (1.0 - torch.eye(n, device=cat.device))
    ok = torch.cat([(use_rgb == 1).repeat_interleave(j),
                    (use_depth == 1).repeat_interleave(j)]).float()
    pos = pos * ok[:, None] * ok[None, :]
    row_loss = -(logsoft * pos).sum(-1) / torch.clamp(pos.sum(-1), min=1.0)
    loss = row_loss.mean()
    return torch.where(use_depth.sum() > 0, loss, torch.zeros_like(loss))


def cross_subject_scl_loss(rgb_map: torch.Tensor, d_map: torch.Tensor,
                           joints2d: torch.Tensor, use_depth: torch.Tensor,
                           use_rgb: torch.Tensor,
                           temperature: float) -> torch.Tensor:
    """Structure-aware cross-sample contrast (contrast_trainer.py:830-892):
    the batch's rgb and depth joint features stacked (2*B*J, C); the
    positives of a row are the same joint id in every other row; rows and
    columns of a missing modality are dropped; loss = the mean over rows
    of -mean over positives of log-softmax.  0 when no sample has depth
    (the reference's early return).  The batch is the group: the train
    step groups it (contrast_step._scl_grouped)."""
    return scl_loss(*scl_joint_features(rgb_map, d_map, joints2d),
                    use_depth, use_rgb, temperature)
