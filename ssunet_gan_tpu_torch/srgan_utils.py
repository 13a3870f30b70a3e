"""SRGAN data and utility helpers (the JAX package's srgan_utils.py;
reference srgan_utils.py), numpy only:

- :func:`create_data_lists` (srgan_utils.py:19-51): image paths of at least
  ``min_size`` in both sides → JSON lists; PNG sizes are read from the
  file's header (``data/png.py`` ``png_size``), other formats through PIL
  where it imports;
- :func:`convert_image` (srgan_utils.py:54-103) between "pil", "[0, 1]",
  "[-1, 1]", "[0, 255]", "imagenet-norm" and the PSNR/SSIM "y-channel"
  (4-pixel border cropped). The card machine has no PIL, so "pil" is an
  HWC uint8 RGB array (HW for one channel), what ``np.asarray`` of a PIL
  image gives;
- :class:`ImageTransforms` (srgan_utils.py:106-162): the HR crop and its
  bicubic LR, PIL's resize in numpy (``data/transforms.py``
  :func:`resize_bicubic_pil`);
- :func:`adjust_learning_rate` (srgan_utils.py:207-217) on a scheduler of
  ``train.optim``.

``clip_gradient`` is inside the GAN step (``train/gan_step.py``).
Arrays are HWC (one image) or NHWC (a batch), RGB, float32.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from ssunet_gan_tpu_torch.data.png import png_size
from ssunet_gan_tpu_torch.data.transforms import resize_bicubic_pil

RGB_WEIGHTS = np.array([65.481, 128.553, 24.966], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

SOURCES = {"pil", "[0, 1]", "[-1, 1]"}
TARGETS = {"pil", "[0, 255]", "[0, 1]", "[-1, 1]", "imagenet-norm", "y-channel"}


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file."""
    if path.lower().endswith(".png"):
        return png_size(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"cannot size {path!r}: the port reads PNG headers itself and needs "
                         f"PIL for other formats, which does not import") from None
    with Image.open(path) as im:
        return im.width, im.height


def _sized(folder: str, min_size: int) -> List[str]:
    paths = [os.path.join(folder, name) for name in sorted(os.listdir(folder))]
    return [p for p in paths if min(image_size(p)) >= min_size]


def create_data_lists(train_folders: Sequence[str], test_folders: Sequence[str],
                      min_size: int, output_folder: str) -> None:
    """``train_images.json`` and ``<folder>_test_images.json`` in
    ``output_folder``: the paths of each folder's images of at least
    ``min_size`` in both sides, in name order."""
    print("\nCreating data lists... this may take some time.\n")
    train_images = [p for d in train_folders for p in _sized(d, min_size)]
    print("There are %d images in the training data.\n" % len(train_images))
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, "train_images.json"), "w") as j:
        json.dump(train_images, j)
    for d in test_folders:
        test_name = d.rstrip("/").split("/")[-1]
        test_images = _sized(d, min_size)
        print("There are %d images in the %s test data.\n" % (len(test_images), test_name))
        with open(os.path.join(output_folder, test_name + "_test_images.json"), "w") as j:
            json.dump(test_images, j)


def convert_image(img, source: str, target: str):
    """``img`` (HWC or NHWC RGB) from the ``source`` format to ``target``."""
    if source not in SOURCES:
        raise ValueError("Cannot convert from source format %s!" % source)
    if target not in TARGETS:
        raise ValueError("Cannot convert to target format %s!" % target)
    if source == "pil":
        img = np.asarray(img, np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
    else:
        img = np.asarray(img, np.float32)
    if source == "[-1, 1]":
        img = (img + 1.0) / 2.0
    if target == "pil":
        arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        return arr[..., 0] if arr.shape[-1] == 1 else arr
    if target == "[0, 255]":
        return 255.0 * img
    if target == "[0, 1]":
        return img
    if target == "[-1, 1]":
        return 2.0 * img - 1.0
    if target == "imagenet-norm":
        return (img - IMAGENET_MEAN) / IMAGENET_STD
    # y-channel: luminance with the reference's 4-pixel border crop
    batched = img if img.ndim == 4 else img[None]
    y = np.matmul(255.0 * batched[:, 4:-4, 4:-4, :], RGB_WEIGHTS) / 255.0 + 16.0
    return y if img.ndim == 4 else y[0]


class ImageTransforms:
    """HR crop + bicubic LR downsample (srgan_utils.py:106-162) of an HWC
    uint8 RGB image ("pil"): in the train split a random ``crop_size``²
    crop, its corner drawn from ``np.random.default_rng(seed)`` as the JAX
    package draws it; in the test split the largest centred crop whose
    sides divide by ``scaling_factor``. Returns ``(lr, hr)`` converted to
    ``lr_img_type`` and ``hr_img_type``."""

    def __init__(self, split: str, crop_size: int, scaling_factor: int,
                 lr_img_type: str, hr_img_type: str, seed: int = 0):
        self.split = split.lower()
        if self.split not in {"train", "test"}:
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        self.crop_size = crop_size
        self.scaling_factor = scaling_factor
        self.lr_img_type = lr_img_type
        self.hr_img_type = hr_img_type
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        if self.split == "train":
            left = int(self._rng.integers(1, w - self.crop_size + 1))
            top = int(self._rng.integers(1, h - self.crop_size + 1))
            hr = img[top:top + self.crop_size, left:left + self.crop_size]
        else:
            xr, yr = w % self.scaling_factor, h % self.scaling_factor
            hr = img[yr // 2:yr // 2 + h - yr, xr // 2:xr // 2 + w - xr]
        if hr.shape[1] % self.scaling_factor:
            raise ValueError(f"crop {hr.shape[1]} is not a multiple of the scaling factor "
                             f"{self.scaling_factor}")
        lr = resize_bicubic_pil(hr, hr.shape[0] // self.scaling_factor,
                                hr.shape[1] // self.scaling_factor)
        return (convert_image(lr, "pil", self.lr_img_type),
                convert_image(hr, "pil", self.hr_img_type))


def adjust_learning_rate(scheduler, shrink_factor: float) -> float:
    """Shrink a scheduler's base rate (and a plateau scheduler's current
    one) by ``shrink_factor``; returns the new base rate."""
    print("\nDECAYING learning rate.")
    scheduler.base_lr *= shrink_factor
    if hasattr(scheduler, "current"):
        scheduler.current *= shrink_factor
    print("The new learning rate is %f\n" % scheduler.base_lr)
    return scheduler.base_lr
