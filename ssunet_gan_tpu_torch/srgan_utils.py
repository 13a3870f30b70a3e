"""SRGAN data and utility helpers (the JAX package's srgan_utils.py;
reference srgan_utils.py), numpy only:

- :func:`create_data_lists` (srgan_utils.py:19-51): image paths of at least
  ``min_size`` in both sides → JSON lists; PNG sizes are read from the
  file's header (``data/png.py`` ``png_size``), other formats through PIL
  where it imports;
- :func:`convert_image` (srgan_utils.py:54-103) between "[0, 1]", "[-1,
  1]", "[0, 255]", "imagenet-norm" and the PSNR/SSIM "y-channel" (4-pixel
  border cropped); the "pil" endpoints need PIL, which the card machine
  lacks, and raise;
- :func:`adjust_learning_rate` (srgan_utils.py:207-217) on a scheduler of
  ``train.optim``.

``ImageTransforms`` (HR crop + PIL bicubic LR) is not ported (ROADMAP.md);
``clip_gradient`` is inside the GAN step (``train/gan_step.py``).
Arrays are HWC (one image) or NHWC (a batch), RGB, float32.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from ssunet_gan_tpu_torch.data.png import png_size

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
    if "pil" in (source, target):
        raise NotImplementedError(
            "the 'pil' formats need PIL, which the port does not use; ImageTransforms and "
            "the PIL conversions are queued in ROADMAP.md")
    img = np.asarray(img, np.float32)
    if source == "[-1, 1]":
        img = (img + 1.0) / 2.0
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


def adjust_learning_rate(scheduler, shrink_factor: float) -> float:
    """Shrink a scheduler's base rate (and a plateau scheduler's current
    one) by ``shrink_factor``; returns the new base rate."""
    print("\nDECAYING learning rate.")
    scheduler.base_lr *= shrink_factor
    if hasattr(scheduler, "current"):
        scheduler.current *= shrink_factor
    print("The new learning rate is %f\n" % scheduler.base_lr)
    return scheduler.base_lr
