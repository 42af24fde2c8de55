"""Numpy segmentation metrics (the port's copy of
hcmoco_tpu/downstream/seg/metric.py).

Behavioral spec: `HRNet-Semantic-Segmentation/lib/utils/metric.py:1-112`
(wkentaro-style `scores`, the +1-shifted histogram
`batch_pix_accuracy`/`batch_intersection_union` pair, and the
sceneparsing-style `pixel_accuracy`/`intersection_and_union`).  Ships in
the reference but is unused by its shipped train/test loops (which use the
confusion-matrix path — our `criterion.py::confusion_matrix`); ported for
inventory completeness.  Host-side numpy on purpose: these are eval-time
reductions over already-fetched predictions, not device work.

Layout: logits are channels-last (B, H, W, C) host arrays, the JAX
package's layout, so both copies take the same inputs (the reference's
`torch.max(output, 1)` argmaxes its NCHW channel axis; these argmax
axis=-1; move an NCHW tensor's channels last before calling them).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _fast_hist(label_true: np.ndarray, label_pred: np.ndarray,
               n_class: int) -> np.ndarray:
    """Confusion histogram over valid (0 <= label < n_class) pixels
    (metric.py:8-14)."""
    mask = (label_true >= 0) & (label_true < n_class)
    return np.bincount(
        n_class * label_true[mask].astype(int) + label_pred[mask],
        minlength=n_class ** 2,
    ).reshape(n_class, n_class)


def scores(label_trues: Sequence[np.ndarray],
           label_preds: Sequence[np.ndarray], n_class: int) -> Dict:
    """Overall/mean/freq-weighted accuracy + mean/class IoU
    (metric.py:17-38)."""
    hist = np.zeros((n_class, n_class))
    for lt, lp in zip(label_trues, label_preds):
        hist += _fast_hist(lt.flatten(), lp.flatten(), n_class)
    acc = np.diag(hist).sum() / hist.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        acc_cls = np.diag(hist) / hist.sum(axis=1)
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
    acc_cls = np.nanmean(acc_cls)
    valid = hist.sum(axis=1) > 0
    mean_iu = np.nanmean(iu[valid])
    freq = hist.sum(axis=1) / hist.sum()
    fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    cls_iu = dict(zip(range(n_class), iu))
    return {
        "Overall Acc": acc,
        "Mean Acc": acc_cls,
        "FreqW Acc": fwavacc,
        "Mean IoU": mean_iu,
        "Class IoU": cls_iu,
    }


def batch_pix_accuracy(output: np.ndarray,
                       target: np.ndarray) -> Tuple[int, int]:
    """(correct, labeled) pixel counts; labels are +1-shifted so 0 marks
    ignore (metric.py:41-56).  output: (B, H, W, C) logits."""
    predict = np.argmax(np.asarray(output), axis=-1).astype("int64") + 1
    target = np.asarray(target).astype("int64") + 1
    pixel_labeled = np.sum(target > 0)
    pixel_correct = np.sum((predict == target) * (target > 0))
    assert pixel_correct <= pixel_labeled, \
        "Correct area should be smaller than Labeled"
    return pixel_correct, pixel_labeled


def batch_intersection_union(output: np.ndarray, target: np.ndarray,
                             nclass: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (intersection, union) areas via +1-shifted histograms
    (metric.py:59-82).  output: (B, H, W, C) logits."""
    predict = np.argmax(np.asarray(output), axis=-1).astype("int64") + 1
    target = np.asarray(target).astype("int64") + 1
    predict = predict * (target > 0).astype(predict.dtype)
    intersection = predict * (predict == target)
    area_inter, _ = np.histogram(intersection, bins=nclass,
                                 range=(1, nclass))
    area_pred, _ = np.histogram(predict, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(target, bins=nclass, range=(1, nclass))
    area_union = area_pred + area_lab - area_inter
    assert (area_inter <= area_union).all(), \
        "Intersection area should be smaller than Union area"
    return area_inter, area_union


def pixel_accuracy(im_pred: np.ndarray,
                   im_lab: np.ndarray) -> Tuple[int, int]:
    """(correct, labeled) over already-argmaxed predictions, label 0 =
    unlabeled (metric.py:86-96)."""
    im_pred = np.asarray(im_pred)
    im_lab = np.asarray(im_lab)
    pixel_labeled = np.sum(im_lab > 0)
    pixel_correct = np.sum((im_pred == im_lab) * (im_lab > 0))
    return pixel_correct, pixel_labeled


def intersection_and_union(im_pred: np.ndarray, im_lab: np.ndarray,
                           num_class: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (intersection, union) over argmaxed predictions
    (metric.py:99-112); class 0 is unlabeled and excluded."""
    im_pred = np.asarray(im_pred)
    im_lab = np.asarray(im_lab)
    im_pred = im_pred * (im_lab > 0)
    intersection = im_pred * (im_pred == im_lab)
    area_inter, _ = np.histogram(intersection, bins=num_class - 1,
                                 range=(1, num_class - 1))
    area_pred, _ = np.histogram(im_pred, bins=num_class - 1,
                                range=(1, num_class - 1))
    area_lab, _ = np.histogram(im_lab, bins=num_class - 1,
                               range=(1, num_class - 1))
    area_union = area_pred + area_lab - area_inter
    return area_inter, area_union
