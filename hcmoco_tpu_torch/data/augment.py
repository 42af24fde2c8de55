"""Contrastive augmentation: policies A-E and the jigsaw pipeline
(counterpart of hcmoco_tpu/data/augment.py, numpy/PIL as there, so the
port's images equal the JAX package's bit for bit on the same seed).

Behavioral spec: `pycontrast/datasets/util.py:16-336` — the five policy
stacks (A InsDis/MoCo/PIRL, B MoCov2, C CMC, D InfoMin, E CMCv2) with
RandomResizedCrop / flip / ColorJitter / RandomGrayscale / GaussianBlur /
RandAugment / colour-space transfer, the CMC YDbDr normalisation constants
(:240-242), and the jigsaw 3x3 crop pipeline (:25-47, :330-340).
rgb2lab / rgb2ydbdr are skimage's definitions (CIE Lab via sRGB->XYZ
D65, YDbDr by its standard matrix); RandAugment is randaugment.py's at the
reference's `rand-n2-m10-mstd0.5`.

No draw depends on the pixels, only on the source image's size: each
transform called with img=None and that size makes an image's draws and
applies nothing (`skip_draws` of a data-parallel rank, for the rows of
the other ranks).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter

from .randaugment import rand_augment_transform
from .transforms import (IMAGENET_MEAN, IMAGENET_STD,
                         random_resized_crop_params, resized_crop)

YDBDR_MEAN = np.array([0.457, -0.082, -0.052], np.float32)
YDBDR_STD = np.array([0.500, 1.331, 1.333], np.float32)


# ---------------------------------------------------------------------------
# colour conversions
# ---------------------------------------------------------------------------


def rgb2ydbdr(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float YDbDr (skimage.color.rgb2ydbdr definition)."""
    x = img.astype(np.float64) / 255.0
    m = np.array([[0.299, 0.587, 0.114],
                  [-0.450, -0.883, 1.333],
                  [-1.333, 1.116, 0.217]])
    return (x @ m.T).astype(np.float32)


def rgb2lab(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> CIE Lab (D65), matching skimage.color.rgb2lab."""
    x = img.astype(np.float64) / 255.0
    x = np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = x @ m.T
    white = np.array([0.95047, 1.0, 1.08883])
    t = xyz / white
    f = np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([l, a, b], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# elementary PIL ops; img None makes the draws only
# ---------------------------------------------------------------------------


def color_jitter(img: Optional[Image.Image], rng, brightness, contrast,
                 saturation, hue) -> Optional[Image.Image]:
    """torchvision ColorJitter semantics: random order, uniform factors."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f))
    if hue > 0:
        h = rng.uniform(-hue, hue)

        def hue_op(im, h=h):
            hsv = np.array(im.convert("HSV"))
            hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                           + int(h * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")

        ops.append(hue_op)
    order = rng.permutation(len(ops))
    if img is None:
        return None
    for i in order:
        img = ops[i](img)
    return img


def random_grayscale(img: Optional[Image.Image], rng,
                     p=0.2) -> Optional[Image.Image]:
    if rng.random() < p and img is not None:
        return img.convert("L").convert("RGB")
    return img


def gaussian_blur(img: Optional[Image.Image],
                  rng) -> Optional[Image.Image]:
    """GaussianBlur2 (util.py:167-171): PIL filter, sigma U(0.1, 2)."""
    radius = float(rng.uniform(0.1, 2.0))
    return None if img is None else img.filter(
        ImageFilter.GaussianBlur(radius=radius))


def _crop_flip(img: Optional[Image.Image], hw: Tuple[int, int], rng,
               scale: Tuple[float, float], size: int
               ) -> Optional[Image.Image]:
    """RandomResizedCrop of an image of (height, width) hw to size^2, then
    a horizontal flip with p 0.5."""
    i, j, h, w = random_resized_crop_params(rng, hw[0], hw[1], scale,
                                            (3 / 4, 4 / 3))
    if img is not None:
        img = resized_crop(img, i, j, h, w, (size, size))
    if rng.random() < 0.5 and img is not None:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def _colour_space(modal: str):
    """(transfer, mean, std): RGB in [0, 1] with ImageNet's statistics, or
    CMC's YDbDr with its own."""
    if modal == "RGB":
        return ((lambda a: a.astype(np.float32) / 255.0), IMAGENET_MEAN,
                IMAGENET_STD)
    return rgb2ydbdr, YDBDR_MEAN, YDBDR_STD


# ---------------------------------------------------------------------------
# policy builder
# ---------------------------------------------------------------------------


def build_transform(aug: str, modal: str, use_memory_bank: bool = True,
                    size: int = 224, seed: int = 0) -> Callable:
    """f(PIL image) -> normalised float32 HWC array; f(None, (h, w)) makes
    the draws of an image of that size and returns None.

    Policy table: build_transforms (util.py:226-336)."""
    crop = 0.08 if use_memory_bank else 0.2
    rng = np.random.default_rng(seed)
    # the full reference op set at rand-n2-m10-mstd0.5 with the CMC-aware
    # removal of colour ops (util.py:279-321): D/E policies
    ra = rand_augment_transform(
        "rand-n2-m10-mstd0.5",
        translate_const=int(size * 0.45),
        img_mean=tuple(min(255, round(255 * x)) for x in IMAGENET_MEAN),
        use_cmc=(modal == "CMC"))
    transfer, mean, std = _colour_space(modal)

    def policy(img: Optional[Image.Image],
               hw: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
        if img is not None:
            hw = (img.size[1], img.size[0])
        img = _crop_flip(img, hw, rng, (crop, 1.0), size)
        if aug == "A":
            img = color_jitter(img, rng, 0.4, 0.4, 0.4, 0.4)
            img = random_grayscale(img, rng, 0.2)
        elif aug == "B":
            if rng.random() < 0.8:
                img = color_jitter(img, rng, 0.4, 0.4, 0.4, 0.1)
            img = random_grayscale(img, rng, 0.2)
            if rng.random() < 0.5:
                img = gaussian_blur(img, rng)
        elif aug == "C":
            img = color_jitter(img, rng, 0.4, 0.4, 0.4, 0.1)
        elif aug == "D":
            if rng.random() < 0.8:
                img = color_jitter(img, rng, 0.8, 0.8, 0.8, 0.2)
            if rng.random() < 0.5:
                img = gaussian_blur(img, rng)
            img = ra(img, rng)
            img = random_grayscale(img, rng, 0.2)
        elif aug == "E":
            if rng.random() < 0.8:
                img = color_jitter(img, rng, 0.4, 0.4, 0.4, 0.1)
            if rng.random() < 0.5:
                img = gaussian_blur(img, rng)
            img = ra(img, rng)
        else:
            raise NotImplementedError(f"aug policy {aug}")
        if img is None:
            return None
        arr = transfer(np.asarray(img, np.uint8))
        return ((arr - mean) / std).astype(np.float32)

    return policy


def jigsaw_crop(img: Optional[Image.Image], rng, n_grid: int = 3,
                img_size: int = 255,
                crop_size: int = 64) -> Optional[List[Image.Image]]:
    """3x3 jigsaw crops (JigsawCrop, util.py:25-47)."""
    grid = img_size // n_grid
    side = grid - crop_size
    yy, xx = np.meshgrid(np.arange(n_grid), np.arange(n_grid))
    yy = (yy * grid).reshape(-1)
    xx = (xx * grid).reshape(-1)
    offsets = []
    for _ in range(n_grid * n_grid):
        rx = int(rng.integers(0, side + 1))
        ry = int(rng.integers(0, side + 1))
        offsets.append((rx, ry))
    if img is None:
        return None
    arr = np.asarray(img, np.uint8)
    return [Image.fromarray(arr[xx[i] + rx: xx[i] + rx + crop_size,
                                yy[i] + ry: yy[i] + ry + crop_size])
            for i, (rx, ry) in enumerate(offsets)]


def build_jigsaw_transform(modal: str, seed: int = 0) -> Callable:
    """The jigsaw pipeline (util.py:330-340): resized crop to 255, flip, 3x3
    jigsaw crops, each colour-transferred and normalised ->
    (9, 64, 64, 3); f(None, (h, w)) makes the draws only."""
    rng = np.random.default_rng(seed)
    transfer, mean, std = _colour_space(modal)

    def fn(img: Optional[Image.Image],
           hw: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
        if img is not None:
            hw = (img.size[1], img.size[0])
        img = _crop_flip(img, hw, rng, (0.6, 1.0), 255)
        crops = jigsaw_crop(img, rng)
        if crops is None:
            return None
        out = [((transfer(np.asarray(c, np.uint8)) - mean) / std)
               for c in crops]
        return np.stack(out).astype(np.float32)

    return fn
