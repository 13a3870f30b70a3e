"""Joint image + mask transforms (the JAX package's data/transforms.py,
albumentations' math), numpy only.

Every transform is ``t(image, mask, rng)`` → ``(image, mask)`` with a
``numpy.random.Generator``; the stochastic ones apply with probability
0.5. Ported: :class:`Compose`, :class:`Normalize`,
:class:`RandomBrightnessContrast`, :class:`Flip` and
:class:`HorizontalFlip` (``cv2.flip`` is a pure index flip), and
:class:`Resize` where the size already matches (``cv2.resize`` to the same
size copies). :class:`Rotate`, :class:`HueSaturationValue` and hence
:func:`train_transform` need ``cv2.warpAffine``/``cvtColor`` and raise
until they are ported (ROADMAP.md); :func:`val_transform` works.

The ImageNet constants are albumentations' ``Normalize`` defaults, as the
reference's pipelines use them (train.py:339-354).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Transform:
    p: float = 0.5

    def __call__(self, image: np.ndarray, mask: Optional[np.ndarray],
                 rng: np.random.Generator):
        if rng.random() < self.p:
            return self.apply(image, mask, rng)
        return image, mask

    def apply(self, image, mask, rng):
        raise NotImplementedError


class Compose:
    """albumentations.Compose: ``aug(image=..., mask=...)`` → dict."""

    def __init__(self, transforms: Sequence[Transform], seed: Optional[int] = None):
        self.transforms = list(transforms)
        self._rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, mask: Optional[np.ndarray] = None, rng=None):
        rng = rng or self._rng
        for t in self.transforms:
            image, mask = t(image, mask, rng)
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} needs cv2, which the port does not use yet; see ROADMAP.md")


class Rotate(Transform):
    """albumentations.Rotate: not ported (cv2.warpAffine)."""

    def __init__(self, limit=(-90, 90), value=0, mask_value=0, p=0.5):
        raise _not_ported("Rotate")


class HueSaturationValue(Transform):
    """albumentations.HueSaturationValue: not ported (cv2.cvtColor)."""

    def __init__(self, hue_shift_limit=20, sat_shift_limit=30, val_shift_limit=20, p=0.5):
        raise _not_ported("HueSaturationValue")


def _flip(a: np.ndarray, d: int) -> np.ndarray:
    """``cv2.flip(a, d)``: 0 flips rows, 1 columns, −1 both."""
    if d == 0:
        return a[::-1].copy()
    if d == 1:
        return a[:, ::-1].copy()
    return a[::-1, ::-1].copy()


class Flip(Transform):
    """albumentations.Flip: when applied, flips horizontally, vertically or
    both with equal probability."""

    def __init__(self, p=0.5):
        self.p = p

    def apply(self, image, mask, rng):
        d = int(rng.integers(-1, 2))  # -1 both, 0 vertical, 1 horizontal
        image = _flip(image, d)
        if mask is not None:
            mask = _flip(mask, d)
            if mask.ndim == 2:
                mask = mask[..., None]
        return image, mask


class HorizontalFlip(Transform):
    def __init__(self, p=0.5):
        self.p = p

    def apply(self, image, mask, rng):
        image = image[:, ::-1].copy()
        if mask is not None:
            mask = mask[:, ::-1].copy()
        return image, mask


class RandomBrightnessContrast(Transform):
    """albumentations.RandomBrightnessContrast with brightness_by_max."""

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2,
                 brightness_by_max=True, p=0.5):
        self.brightness = brightness_limit
        self.contrast = contrast_limit
        self.by_max = brightness_by_max
        self.p = p

    def apply(self, image, mask, rng):
        alpha = 1.0 + rng.uniform(-self.contrast, self.contrast)
        beta = rng.uniform(-self.brightness, self.brightness)
        img = image.astype(np.float32) * alpha
        img += beta * (255.0 if self.by_max else img.mean())
        return np.clip(img, 0, 255).astype(image.dtype), mask


class Resize(Transform):
    """albumentations.Resize(height, width), always applied. Only the
    identity is ported: an input of that size is copied, as cv2.resize
    does; any other size raises (ROADMAP.md)."""

    def __init__(self, height: int, width: int, p=1.0):
        self.height = int(height)
        self.width = int(width)
        self.p = p

    def __call__(self, image, mask, rng):
        return self.apply(image, mask, rng)

    def apply(self, image, mask, rng):
        if image.shape[:2] != (self.height, self.width):
            raise _not_ported(f"Resize from {image.shape[:2]} to "
                              f"{(self.height, self.width)}")
        image = image.copy()
        if image.ndim == 2:
            image = image[..., None]
        if mask is not None:
            mask = mask.copy()
            if mask.ndim == 2:
                mask = mask[..., None]
        return image, mask


class Normalize(Transform):
    """albumentations.Normalize: (img − mean·255) / (std·255), float32."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD, max_pixel_value=255.0, p=1.0):
        self.mean = np.asarray(mean, np.float32) * max_pixel_value
        self.std = np.asarray(std, np.float32) * max_pixel_value
        self.p = p

    def __call__(self, image, mask, rng):
        return self.apply(image, mask, rng)

    def apply(self, image, mask, rng):
        if image.ndim == 2:
            image = image[..., None]
        c = image.shape[2]
        mean = self.mean if c == len(self.mean) else np.full(c, self.mean.mean(), np.float32)
        std = self.std if c == len(self.std) else np.full(c, self.std.mean(), np.float32)
        return (image.astype(np.float32) - mean) / std, mask


def train_transform(config: dict) -> Compose:
    """The reference's train pipeline (train.py:339-349): Rotate, Flip, HSV,
    brightness/contrast, Resize, Normalize. Raises until Rotate and HSV are
    ported."""
    mean, std = list(IMAGENET_MEAN), list(IMAGENET_STD)
    return Compose([
        Rotate([config.get("rotate_min", -10), config.get("rotate_max", 10)],
               value=mean, mask_value=0),
        Flip(),
        HueSaturationValue(10, 10, 10),
        RandomBrightnessContrast(0.10, 0.10, brightness_by_max=True),
        Resize(config["input_h"], config["input_w"]),
        Normalize(mean=mean, std=std),
    ])


def val_transform(config: dict) -> Compose:
    """The reference's val/test pipeline (train.py:351-354)."""
    return Compose([Resize(config["input_h"], config["input_w"]), Normalize()])
