"""Joint image + mask transforms (the JAX package's data/transforms.py,
albumentations' math), numpy only: no cv2.

Every transform is ``t(image, mask, rng)`` → ``(image, mask)`` with a
``numpy.random.Generator``; the stochastic ones apply with probability
0.5. The JAX classes call cv2; here its operations are numpy that follow
OpenCV 5's arithmetic: :func:`warp_affine` (``cv2.warpAffine``, for
:class:`Rotate`), :func:`rgb_to_hsv` / :func:`hsv_to_rgb` (``cvtColor``,
for :class:`HueSaturationValue`), :func:`resize_linear` /
:func:`resize_nearest` (``cv2.resize``, for :class:`Resize`); ``cv2.flip``
is an index flip. :func:`resize_bicubic_pil` is PIL's bicubic resize, for
``srgan_utils.ImageTransforms``. Each draws from the rng as the JAX class does, so
:func:`train_transform` and :func:`val_transform` with one seed take the
branches and parameters of the JAX pipelines.

The ImageNet constants are albumentations' ``Normalize`` defaults, as the
reference's pipelines use them (train.py:339-354).
"""

from __future__ import annotations

import math
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


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2×3 affine map (cv2.invertAffineTransform), in f64."""
    a, b, c = (float(v) for v in m[0])
    d, e, f = (float(v) for v in m[1])
    det = a * e - b * d
    det = 1.0 / det if det != 0 else 0.0
    i11, i12, i21, i22 = e * det, -b * det, -d * det, a * det
    return np.array([[i11, i12, -i11 * c - i12 * f], [i21, i22, -i21 * c - i22 * f]])


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: rotation by ``angle`` degrees
    (counter-clockwise) about ``center`` = (x, y)."""
    a = math.cos(math.radians(angle)) * scale
    b = math.sin(math.radians(angle)) * scale
    cx, cy = center
    return np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]])


def _border_fill(value, channels: int, dtype) -> np.ndarray:
    """A constant border value per channel, saturated to ``dtype`` as cv2
    converts its border scalar (the reference's float ImageNet mean becomes
    0 on uint8)."""
    v = np.broadcast_to(np.asarray(value, np.float64).ravel()[:channels]
                        if np.ndim(value) else np.float64(value), (channels,))
    return _saturate(np.rint(v) if np.issubdtype(dtype, np.integer) else v, dtype)


def warp_affine(img: np.ndarray, m: np.ndarray, size, nearest: bool = False,
                border_value=0) -> np.ndarray:
    """cv2.warpAffine with a constant border, HW or HWC: each destination
    pixel samples the source at the inverse map of its coordinates,
    computed in f32; bilinear in f32 on the four neighbours (those outside
    the image read the border value), the result rounded to nearest, or
    with ``nearest`` the source pixel at the rounded coordinates. Agrees
    with OpenCV 5's float warp within one level (bilinear) and exactly
    (nearest)."""
    w, h = size
    im = _inverse_affine(m).astype(np.float32)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    sh, sw, ch = src.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = im[0, 0] * xs + im[0, 1] * ys + im[0, 2]
    sy = im[1, 0] * xs + im[1, 1] * ys + im[1, 2]
    fill = _border_fill(border_value, ch, src.dtype)
    pad = np.empty((sh + 4, sw + 4, ch), src.dtype if nearest else np.float32)
    pad[...] = fill
    pad[2:-2, 2:-2] = src

    def at(yy, xx):  # coordinates past the 2-pixel frame read the border too
        return pad[np.clip(yy + 2, 0, sh + 3), np.clip(xx + 2, 0, sw + 3)]

    if nearest:
        out = at(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        a, b = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        p00, p01 = at(y0, x0), at(y0, x0 + 1)
        p10, p11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
        top = p00 + a * (p01 - p00)
        v = top + b * (p10 + a * (p11 - p10) - top)
        out = _saturate(np.rint(v), src.dtype)
    return out[..., 0] if squeeze else out


def _saturate(v: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = np.clip(v, info.min, info.max)
    return v.astype(dtype)


class Rotate(Transform):
    """Random rotation with a constant-border fill (albumentations.Rotate):
    the angle uniform in ``limit``, about the image centre
    (``(w/2 − 0.5, h/2 − 0.5)``); the image bilinear with ``value`` as its
    border (the reference passes the ImageNet mean as floats, which on uint8
    images fills black — kept), the mask nearest with ``mask_value``."""

    def __init__(self, limit=(-90, 90), value=0, mask_value=0, p=0.5):
        self.limit = (limit, -limit) if np.isscalar(limit) else tuple(limit)
        self.value = value
        self.mask_value = mask_value
        self.p = p

    def apply(self, image, mask, rng):
        angle = rng.uniform(min(self.limit), max(self.limit))
        h, w = image.shape[:2]
        m = rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
        image = warp_affine(image, m, (w, h), border_value=self.value)
        if mask is not None:
            mask = warp_affine(mask, m, (w, h), nearest=True, border_value=self.mask_value)
            if mask.ndim == 2:
                mask = mask[..., None]
        return image, mask


# cv2's uint8 RGB → HSV (H in 0..179) in fixed point: 12-bit reciprocal
# tables of V (for S) and of 6·(max − min) (for H), rounded to nearest
_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
_SDIV = np.where(_I == 0, 0, np.rint((255 << _HSV_SHIFT) / np.maximum(_I, 1))).astype(np.int64)
_HDIV = np.where(_I == 0, 0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(_I, 1)))).astype(
    np.int64)
# HSV → RGB: per 60° sector, which of (v, p, q, t) are b, g and r
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of a uint8 HWC image (bit-exact)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of a uint8 HWC image: the sector
    formula in f32 on S and V over 255, truncated to uint8 as OpenCV 5 does
    (within one level of it)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1 / 255.0)
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(f32)
    tab = np.stack([v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[np.clip(sector, 0, 5)], -1)
    return np.clip(np.floor(bgr * f32(255)), 0, 255).astype(np.uint8)[..., ::-1]


class HueSaturationValue(Transform):
    """uint8 HSV shifts (albumentations.HueSaturationValue): H (mod 180),
    S and V (clipped) through lookup tables built as the JAX class builds
    them (the shift added in f64, mod or clip, then truncated). The
    conversion is cv2's RGB one whatever the channel order, as
    albumentations applies it to the reference's BGR images. A gray image
    passes unchanged."""

    def __init__(self, hue_shift_limit=20, sat_shift_limit=30, val_shift_limit=20, p=0.5):
        self.hue = hue_shift_limit
        self.sat = sat_shift_limit
        self.val = val_shift_limit
        self.p = p

    def apply(self, image, mask, rng):
        if image.ndim != 3 or image.shape[2] != 3:
            return image, mask
        hs = rng.uniform(-self.hue, self.hue)
        ss = rng.uniform(-self.sat, self.sat)
        vs = rng.uniform(-self.val, self.val)
        hsv = rgb_to_hsv(image)
        levels = np.arange(256, dtype=np.float64)
        luts = (np.mod(levels + hs, 180), np.clip(levels + ss, 0, 255),
                np.clip(levels + vs, 0, 255))
        hsv = np.stack([lut.astype(np.uint8)[hsv[..., i]] for i, lut in enumerate(luts)], -1)
        return hsv_to_rgb(hsv), mask


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


def _linear_taps(dst: int, src: int):
    """cv2.resize INTER_LINEAR's source index and 11-bit weights per
    destination index (half-pixel centres, clamped at the edges): the
    fraction in f32, each weight rounded on its own."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i = np.floor(f).astype(np.int64)
    a = (f - i).astype(np.float32)
    a[i < 0] = 0
    i[i < 0] = 0
    hi = i >= src - 1
    a[hi] = 0
    i[hi] = src - 1
    scale = np.float32(1 << 11)
    return (i, np.minimum(i + 1, src - 1), np.rint((1 - a) * scale).astype(np.int64),
            np.rint(a * scale).astype(np.int64))


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), INTER_LINEAR) of a uint8 HW or HWC
    image in cv2's fixed point: an 11-bit horizontal pass, then the
    vertical one with its 4-bit pre-shift and 16-bit products (within one
    level of OpenCV 5, equal on most pixels)."""
    x = img.astype(np.int64)
    x = x[..., None] if img.ndim == 2 else x
    y0, y1, b0, b1 = _linear_taps(height, img.shape[0])
    x0, x1, a0, a1 = _linear_taps(width, img.shape[1])
    rows = (x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]) >> 4
    out = (((rows[y0] * b0[:, None, None]) >> 16) + ((rows[y1] * b1[:, None, None]) >> 16)
           + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), INTER_NEAREST): source index
    ``floor(dst · src / dst_size)``, clamped."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (h / height)).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (w / width)).astype(np.int64), w - 1)
    return img[ys][:, xs]


# PIL's 8-bit resampling: coefficients in fixed point with 22 fraction bits
_PIL_PRECISION = 22


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter, a = −0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_taps(src: int, dst: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter: per destination index the source indices and their
    fixed-point weights (the support widened by the scale when
    downsampling; weights normalized in f64, rounded half away from 0)."""
    scale = src / dst
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(dst) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int): toward 0
    count = np.minimum((center + support + 0.5).astype(np.int64), src) - xmin
    k = np.arange(ksize)
    w = _pil_bicubic((k[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / fscale))
    w = np.where(k[None] < count[:, None], w, 0.0)
    total = np.zeros(dst)
    for t in range(ksize):  # PIL's summation order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    s = w * (1 << _PIL_PRECISION)
    fixed = np.where(w < 0, np.trunc(s - 0.5), np.trunc(s + 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + k[None], src - 1), fixed


def _pil_pass(img: np.ndarray, axis: int, size: int) -> np.ndarray:
    idx, fixed = _pil_taps(img.shape[axis], size)
    x = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((size,) + x.shape[1:], 1 << (_PIL_PRECISION - 1), np.int64)
    shape = (-1,) + (1,) * (x.ndim - 1)
    for t in range(fixed.shape[1]):
        acc += x[idx[:, t]] * fixed[:, t].reshape(shape)
    return np.moveaxis(np.clip(acc >> _PIL_PRECISION, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic_pil(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``Image.resize((width, height), Image.BICUBIC)`` of a uint8 HW or HWC
    image, as Pillow's 8-bit convolution resample computes it: the
    horizontal pass, rounded to uint8, then the vertical one; an axis whose
    size does not change is not resampled. Bit-exact to Pillow 12."""
    out = img
    if width != img.shape[1]:
        out = _pil_pass(out, 1, width)
    if height != img.shape[0]:
        out = _pil_pass(out, 0, height)
    return out if out is not img else img.copy()


class Resize(Transform):
    """albumentations.Resize(height, width), always applied: the image
    bilinear (cv2 INTER_LINEAR), the mask nearest (INTER_NEAREST); a size
    that already matches is copied, as cv2.resize does."""

    def __init__(self, height: int, width: int, p=1.0):
        self.height = int(height)
        self.width = int(width)
        self.p = p

    def __call__(self, image, mask, rng):
        return self.apply(image, mask, rng)

    def apply(self, image, mask, rng):
        same = image.shape[:2] == (self.height, self.width)
        if image.dtype != np.uint8 and not same:
            raise TypeError(f"Resize takes uint8 images, got {image.dtype}")
        image = image.copy() if same else resize_linear(image, self.height, self.width)
        if image.ndim == 2:
            image = image[..., None]
        if mask is not None:
            mask = resize_nearest(mask, self.height, self.width).copy()
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
    brightness/contrast, Resize, Normalize; the rng draws come in the JAX
    pipeline's order, so a seeded Compose takes the same branches and
    parameters."""
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
