"""Multi-scale sliding-window inference with flip TTA (counterpart of
hcmoco_tpu/downstream/seg/inference.py).

Behavioral spec: `lib/datasets/base_dataset.py:147-229` — per scale: resize,
pad to crop size, tile with stride = 2/3 crop, average window predictions
(softmax-exp domain), optional horizontal-flip TTA (with the depth sets'
left-right class-pair swap, nturgbd_d.py:239-259), upsample to original
size, sum over scales.

The host side (resizing, padding, tiling, the running sums) is numpy and
cv2, as in the JAX package; each window goes to `model_fn` as a (1, 3, h,
w) tensor on `device`, whose NCHW logits come back upsampled bilinearly
(half-pixel centres, f32) to the window's size.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _predict(model_fn: Callable, image: torch.Tensor,
             flip_pairs: Optional[np.ndarray], flip: bool) -> torch.Tensor:
    """softmax-prob prediction at input resolution, NCHW (inference,
    nturgbd_d.py:239-259: upsample logits, log_softmax, optional flip TTA
    averaged, exp)."""
    h, w = image.shape[2], image.shape[3]

    def logp(x):
        out = F.interpolate(model_fn(x).float(), size=(h, w),
                            mode="bilinear", align_corners=False)
        return F.log_softmax(out, dim=1)

    pred = logp(image)
    if flip:
        fl = logp(image.flip(3))
        if flip_pairs is not None:
            perm = np.arange(fl.shape[1])
            for a, b in flip_pairs:
                perm[a], perm[b] = b, a
            fl = fl[:, torch.from_numpy(perm).to(fl.device)]
        pred = 0.5 * (pred + fl.flip(3))
    return torch.exp(pred)


def _window_probs(model_fn: Callable, window: np.ndarray, device,
                  flip_pairs: Optional[np.ndarray], flip: bool) -> np.ndarray:
    """(h, w, C) host probabilities of one (h, w, 3) host window."""
    x = torch.from_numpy(np.ascontiguousarray(window)).permute(2, 0, 1)[None]
    with torch.no_grad():
        p = _predict(model_fn, x.to(device), flip_pairs, flip)
    return p[0].permute(1, 2, 0).cpu().numpy()


def sliding_window_inference(
    model_fn: Callable, image: np.ndarray, num_classes: int,
    crop_size: Tuple[int, int] = (473, 473),
    scales: Sequence[float] = (1.0,), flip: bool = False,
    flip_pairs: Optional[np.ndarray] = None,
    pad_value: Optional[np.ndarray] = None, *, device,
) -> np.ndarray:
    """image: (H, W, 3) normalized host array; returns (H, W,
    num_classes) probabilities summed over the scales.  `device`, where
    the windows run, has no default: the caller names it (the card in
    the trainer, the CPU in the tests)."""
    import cv2

    oh, ow = image.shape[:2]
    ch, cw = crop_size
    stride_h, stride_w = int(ch * 2 / 3), int(cw * 2 / 3)
    final = np.zeros((oh, ow, num_classes), np.float32)
    if pad_value is None:
        pad_value = np.zeros(image.shape[-1], np.float32)

    for scale in scales:
        long_size = int(max(oh, ow) * scale + 0.5)
        if oh > ow:
            nh, nw = long_size, int(ow * long_size / oh + 0.5)
        else:
            nw, nh = long_size, int(oh * long_size / ow + 0.5)
        img = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)

        if max(nh, nw) <= min(ch, cw):
            padded = np.full((ch, cw, image.shape[-1]), pad_value,
                             np.float32)
            padded[:nh, :nw] = img
            pred = _window_probs(model_fn, padded, device, flip_pairs,
                                 flip)[:nh, :nw]
        else:
            ph, pw = max(nh, ch), max(nw, cw)
            padded = np.full((ph, pw, image.shape[-1]), pad_value,
                             np.float32)
            padded[:nh, :nw] = img
            rows = int(math.ceil((ph - ch) / stride_h)) + 1
            cols = int(math.ceil((pw - cw) / stride_w)) + 1
            acc = np.zeros((ph, pw, num_classes), np.float32)
            cnt = np.zeros((ph, pw, 1), np.float32)
            for r in range(rows):
                for c in range(cols):
                    h0, w0 = r * stride_h, c * stride_w
                    h1, w1 = min(h0 + ch, ph), min(w0 + cw, pw)
                    h0, w0 = h1 - ch, w1 - cw
                    acc[h0:h1, w0:w1] += _window_probs(
                        model_fn, padded[h0:h1, w0:w1], device, flip_pairs,
                        flip)
                    cnt[h0:h1, w0:w1] += 1
            pred = (acc / cnt)[:nh, :nw]
        pred = cv2.resize(pred, (ow, oh), interpolation=cv2.INTER_LINEAR)
        final += pred
    return final
