"""Full RandAugment with the CMC-aware op set (counterpart of
hcmoco_tpu/data/randaugment.py, numpy/PIL as there, so the port's images
equal the JAX package's bit for bit on the same generator).

Behavioral spec: `pycontrast/datasets/RandAugment.py` (the reference vendors
timm's AutoAugment/RandAugment, Apache-2.0) — the complete op table with
level->argument mappings, per-op 0.5 application probability, Gaussian
magnitude jitter (`mstd`), random bilinear/bicubic resampling for geometric
ops, mean-fill, the RGB op list (:311-327), the CMC op list with color ops
removed (:330-340), the experimental w0 choice weights (:345-361), and the
`rand-nN-mM-mstdS[-wW]` config-string parser (:405-448).

Differences from the reference by design: randomness is threaded through an
explicit numpy Generator (the host pipeline keeps every stream seeded and
restorable) instead of the global `random` module.

No draw depends on the pixels, so called with img=None RandAugment makes
the draws of an image and applies nothing: a data-parallel rank's
skip_draws for another rank's row (data/contrast_folder.py).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

MAX_LEVEL = 10.0
FILL = (128, 128, 128)
RANDOM_INTERPOLATION = (Image.BILINEAR, Image.BICUBIC)


# ---------------------------------------------------------------------------
# raw image ops (PIL)
# ---------------------------------------------------------------------------


def shear_x(img, factor, fill=FILL, resample=Image.BILINEAR):
    return img.transform(img.size, Image.AFFINE, (1, factor, 0, 0, 1, 0),
                         fillcolor=fill, resample=resample)


def shear_y(img, factor, fill=FILL, resample=Image.BILINEAR):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, factor, 1, 0),
                         fillcolor=fill, resample=resample)


def translate_x_rel(img, pct, fill=FILL, resample=Image.BILINEAR):
    px = pct * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, px, 0, 1, 0),
                         fillcolor=fill, resample=resample)


def translate_y_rel(img, pct, fill=FILL, resample=Image.BILINEAR):
    px = pct * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, px),
                         fillcolor=fill, resample=resample)


def translate_x_abs(img, pixels, fill=FILL, resample=Image.BILINEAR):
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         fillcolor=fill, resample=resample)


def translate_y_abs(img, pixels, fill=FILL, resample=Image.BILINEAR):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         fillcolor=fill, resample=resample)


def rotate(img, degrees, fill=FILL, resample=Image.BILINEAR):
    return img.rotate(degrees, fillcolor=fill, resample=resample)


def auto_contrast(img, *_, **__):
    return ImageOps.autocontrast(img)


def invert(img, *_, **__):
    return ImageOps.invert(img)


def identity(img, *_, **__):
    return img


def equalize(img, *_, **__):
    return ImageOps.equalize(img)


def solarize(img, thresh, **__):
    return ImageOps.solarize(img, thresh)


def solarize_add(img, add, thresh=128, **__):
    """Add `add` below `thresh`, keep above (RandAugment.py:128-141)."""
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    if img.mode == "RGB":
        lut = lut * 3
    if img.mode in ("L", "RGB"):
        return img.point(lut)
    return img


def posterize(img, bits_to_keep, **__):
    if bits_to_keep >= 8:
        return img
    return ImageOps.posterize(img, bits_to_keep)


def enhance_color(img, factor, **__):
    return ImageEnhance.Color(img).enhance(factor)


def enhance_contrast(img, factor, **__):
    return ImageEnhance.Contrast(img).enhance(factor)


def enhance_brightness(img, factor, **__):
    return ImageEnhance.Brightness(img).enhance(factor)


def enhance_sharpness(img, factor, **__):
    return ImageEnhance.Sharpness(img).enhance(factor)


# ---------------------------------------------------------------------------
# level -> argument mappings (RandAugment.py:165-250); `neg` draws the 50%
# sign flip from the threaded rng
# ---------------------------------------------------------------------------


def _neg(rng, v):
    return -v if rng.random() > 0.5 else v


def _lvl_rotate(level, rng, hp):
    return (_neg(rng, level / MAX_LEVEL * 30.0),)


def _lvl_enhance(level, rng, hp):
    return (level / MAX_LEVEL * 1.8 + 0.1,)


def _lvl_shear(level, rng, hp):
    return (_neg(rng, level / MAX_LEVEL * 0.3),)


def _lvl_translate_abs(level, rng, hp):
    return (_neg(rng, level / MAX_LEVEL * float(hp["translate_const"])),)


def _lvl_translate_rel(level, rng, hp):
    return (_neg(rng, level / MAX_LEVEL * 0.45),)


def _lvl_posterize_original(level, rng, hp):
    return (int(level / MAX_LEVEL * 4) + 4,)


def _lvl_posterize_research(level, rng, hp):
    return (4 - int(level / MAX_LEVEL * 4),)


def _lvl_posterize_tpu(level, rng, hp):
    return (int(level / MAX_LEVEL * 4),)


def _lvl_solarize(level, rng, hp):
    return (int(level / MAX_LEVEL * 256),)


def _lvl_solarize_add(level, rng, hp):
    return (int(level / MAX_LEVEL * 110),)


# name -> (apply_fn, level_fn, geometric)
OPS = {
    "AutoContrast": (auto_contrast, None, False),
    "Equalize": (equalize, None, False),
    "Invert": (invert, None, False),
    "Identity": (identity, None, False),
    "Rotate": (rotate, _lvl_rotate, True),
    "PosterizeOriginal": (posterize, _lvl_posterize_original, False),
    "PosterizeResearch": (posterize, _lvl_posterize_research, False),
    "PosterizeTpu": (posterize, _lvl_posterize_tpu, False),
    "Solarize": (solarize, _lvl_solarize, False),
    "SolarizeAdd": (solarize_add, _lvl_solarize_add, False),
    "Color": (enhance_color, _lvl_enhance, False),
    "Contrast": (enhance_contrast, _lvl_enhance, False),
    "Brightness": (enhance_brightness, _lvl_enhance, False),
    "Sharpness": (enhance_sharpness, _lvl_enhance, False),
    "ShearX": (shear_x, _lvl_shear, True),
    "ShearY": (shear_y, _lvl_shear, True),
    "TranslateX": (translate_x_abs, _lvl_translate_abs, True),
    "TranslateY": (translate_y_abs, _lvl_translate_abs, True),
    "TranslateXRel": (translate_x_rel, _lvl_translate_rel, True),
    "TranslateYRel": (translate_y_rel, _lvl_translate_rel, True),
}

RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeTpu",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

# color ops removed for channel-split CMC inputs (RandAugment.py:330-340)
RAND_TRANSFORMS_CMC = [
    "AutoContrast", "Identity", "Rotate", "Sharpness", "ShearX", "ShearY",
    "TranslateXRel", "TranslateYRel",
]

RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2,
    "TranslateXRel": 0.1, "TranslateYRel": 0.1,
    "Color": 0.025, "Sharpness": 0.025, "AutoContrast": 0.025,
    "Solarize": 0.005, "SolarizeAdd": 0.005, "Contrast": 0.005,
    "Brightness": 0.005, "Equalize": 0.005,
    "PosterizeTpu": 0.0, "Invert": 0.0,
}


class RandAugment:
    """num_layers ops chosen per image (uniform with replacement, or
    weighted without), each applied with prob 0.5 at Gaussian-jittered
    magnitude."""

    def __init__(self, transforms: Sequence[str], num_layers: int = 2,
                 magnitude: float = MAX_LEVEL, magnitude_std: float = 0.0,
                 translate_const: int = 250, img_mean=FILL,
                 interpolation=None, weights: Optional[np.ndarray] = None):
        self.transforms = list(transforms)
        self.num_layers = num_layers
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.hparams = {"translate_const": translate_const}
        self.fill = tuple(img_mean)
        self.interpolation = interpolation  # None = random bilinear/bicubic
        self.weights = weights

    def _apply_one(self, img, name, rng):
        if rng.random() > 0.5:
            return img
        fn, level_fn, geometric = OPS[name]
        magnitude = self.magnitude
        if self.magnitude_std > 0:
            magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = min(MAX_LEVEL, max(0.0, magnitude))
        args = level_fn(magnitude, rng, self.hparams) if level_fn else ()
        if geometric:
            resample = (self.interpolation if self.interpolation is not None
                        else RANDOM_INTERPOLATION[
                            int(rng.integers(0, len(RANDOM_INTERPOLATION)))])
            return (None if img is None else
                    fn(img, *args, fill=self.fill, resample=resample))
        return None if img is None else fn(img, *args)

    def __call__(self, img: Optional[Image.Image],
                 rng: np.random.Generator):
        names = rng.choice(self.transforms, self.num_layers,
                           replace=self.weights is None, p=self.weights)
        for name in names:
            img = self._apply_one(img, str(name), rng)
        return img


def rand_augment_transform(config_str: str, translate_const: int = 250,
                           img_mean=FILL, use_cmc: bool = False,
                           interpolation=None) -> RandAugment:
    """Parse 'rand-nN-mM-mstdS[-wW]' into a RandAugment
    (RandAugment.py:405-448)."""
    magnitude = MAX_LEVEL
    num_layers = 2
    magnitude_std = 0.0
    weight_idx = None
    sections = config_str.split("-")
    assert sections[0] == "rand", config_str
    for c in sections[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            magnitude_std = float(val)
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise ValueError(f"unknown RandAugment section {c!r}")
    transforms = RAND_TRANSFORMS_CMC if use_cmc else RAND_TRANSFORMS
    weights = None
    if weight_idx is not None:
        assert weight_idx == 0, "only weight set 0 exists"
        w = np.asarray([RAND_CHOICE_WEIGHTS_0[k] for k in transforms],
                       np.float64)
        weights = w / w.sum()
    return RandAugment(transforms, num_layers, magnitude, magnitude_std,
                       translate_const, img_mean, interpolation, weights)
