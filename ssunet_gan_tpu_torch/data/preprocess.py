"""Offline raster preprocessing: tile giant scenes into training patches
(the JAX package's data/preprocess.py; reference preprocess_satellite.py
and preprocess_SN7.py), numpy only: no cv2, no sklearn.

- **colour-label scenes ("chicago")**: ``<root>/<name>/*_image.*`` with
  ``*_labels.*`` beside each; a 2-pass grid (TL- and BR-anchored) with
  stride ``stride_frac·patch_size`` (1.0: no overlap); the BGR label
  decoded per class ((255,255,255)→0, (255,0,0)→1, (0,0,255)→2), resized
  to ``img_size`` and binarized at 125;
- **SpaceNet-7**: ``<root>/<name>/image/*.png`` with per-class grayscale
  labels under ``label/<c>/`` (``img`` → ``label`` in the file name),
  binarized before and after the resize; stride_frac 0.5.

Both split the scenes 80/10/10 as ``train_test_split(random_state=41)``
twice (:func:`split_scenes`) and write the ``images/{split}`` +
``annotations/{split}/<class>`` tree that
:class:`~ssunet_gan_tpu_torch.data.dataset.SegmentationDataset` reads,
plus ``list/{split}.txt``.

cv2's calls map onto the port's numpy: ``cv2.imread`` →
:func:`data.png.read_image` (BGR, an alpha channel dropped; the labels'
``IMREAD_GRAYSCALE`` → ``read_image(gray=True)``, libpng's fixed-point
weights, equal to cv2's on gray, RGB and RGBA PNGs), ``cv2.resize`` →
:func:`data.transforms.resize_linear` (within one level of OpenCV; at
``img_size == patch_size`` cv2 copies, and so does this module, so the
tree is then equal pixel for pixel), ``cv2.imwrite`` →
:func:`data.png.write_image` (other bytes, the same decoded pixels).
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import List, Sequence, Tuple

import numpy as np

from ssunet_gan_tpu_torch.data.png import read_image, write_image
from ssunet_gan_tpu_torch.data.transforms import resize_linear

SPLITS = ("training", "validation", "test")
SPLIT_SEED = 41  # the reference's random_state


def preprocess_grid_coords(img_h: int, img_w: int, p_size: int,
                           stride_frac: float = 1.0) -> List[Tuple[int, int]]:
    """2-pass preprocess grid (preprocess_satellite.py:26-59): TL-anchored
    then BR-anchored, count = floor(size/stride) − 1 per axis."""
    step = int(stride_frac * p_size)
    i_w = int(math.floor(img_w / step)) - 1
    i_h = int(math.floor(img_h / step)) - 1
    coords: List[Tuple[int, int]] = []
    for i in range(i_w):
        for j in range(i_h):
            coords.append((j * step, i * step))
    for i in range(i_w):
        for j in range(i_h):
            coords.append((img_h - j * step - p_size, img_w - i * step - p_size))
    return coords


def binarize_mask(mask: np.ndarray, threshold: int = 125) -> np.ndarray:
    """uint8 → {0, 255} at the preprocess threshold (preprocess_satellite.py:63-69)."""
    out = mask.copy()
    out[(out > threshold) & (out < 255)] = 255
    out[(out > 0) & (out <= threshold)] = 0
    return out


def color_class_mask(label_bgr: np.ndarray, idx: int) -> np.ndarray:
    """Colour-coded BGR label → binary uint8 mask for one class
    (preprocess_satellite.py:102-112)."""
    keys = {0: (255, 255, 255), 1: (255, 0, 0), 2: (0, 0, 255)}
    b, g, r = keys.get(idx, (255, 255, 255))
    hit = (label_bgr[:, :, 0] == b) & (label_bgr[:, :, 1] == g) & (label_bgr[:, :, 2] == r)
    return np.where(hit, 255, 0).astype(np.uint8)


def train_test_split(items: Sequence, test_size: float, seed: int = SPLIT_SEED):
    """``sklearn.model_selection.train_test_split(items, test_size=...,
    random_state=seed)``: ``ceil(test_size·n)`` items held out, from one
    ``RandomState(seed).permutation(n)``; the test part is its head, the
    train part the rest, each in permutation order. Raises ValueError where
    either part would be empty, as sklearn does."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_test == 0 or n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and train_size=None, "
                         "the resulting train set will be empty.")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def split_scenes(paths: Sequence[str]) -> Tuple[List[str], List[str], List[str]]:
    """80/10/10 scene split, ``random_state=41`` twice
    (preprocess_satellite.py:139-141); a single held-out scene serves both
    evaluation splits."""
    train, val_test = train_test_split(list(paths), 0.2)
    if len(val_test) < 2:
        # tiny scene counts: reuse the held-out scene for both eval splits
        # (the reference crashes here)
        return train, list(val_test), list(val_test)
    val, test = train_test_split(val_test, 0.5)
    return train, val, test


def _make_dirs(out_base: str, num_class: int) -> None:
    for split in SPLITS:
        os.makedirs(os.path.join(out_base, "images", split), exist_ok=True)
        os.makedirs(os.path.join(out_base, "annotations", split), exist_ok=True)
        for c in range(num_class):
            os.makedirs(os.path.join(out_base, "annotations", split, str(c)), exist_ok=True)
    os.makedirs(os.path.join(out_base, "masks"), exist_ok=True)


def make_data_list(out_base: str) -> None:
    """Write list/{split}.txt of 'image annotation' pairs
    (preprocess_satellite.py:165-216)."""
    os.makedirs(os.path.join(out_base, "list"), exist_ok=True)
    for split in SPLITS:
        imgs = sorted(glob(os.path.join(out_base, "images", split, "*.*")))
        anns = sorted(glob(os.path.join(out_base, "annotations", split, "*.*")))
        with open(os.path.join(out_base, "list", f"{split}.txt"), "w") as f:
            for i_path, a_path in zip(imgs, anns):
                f.write(f"images/{split}/{os.path.basename(i_path)} "
                        f"annotations/{split}/{os.path.basename(a_path)}\n")


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size))``: a copy where the size matches."""
    if img.shape[:2] == (size, size):
        return img.copy()
    return resize_linear(img, size, size)


def _write_patch(out_base, split, file_name, p_img, masks, img_size) -> None:
    """The resized image, each class's mask (resized, binarized) and the
    combined class-index mask of one patch."""
    write_image(os.path.join(out_base, "images", split, file_name), _resize(p_img, img_size))
    all_mask = np.zeros((img_size, img_size), np.uint8)
    for c, mask in enumerate(masks):
        resized = binarize_mask(_resize(mask, img_size))
        all_mask[resized > 0] = c
        write_image(os.path.join(out_base, "annotations", split, str(c), file_name), resized)
    write_image(os.path.join(out_base, "annotations", split, file_name), all_mask)


def preprocess_color_label_scenes(
    input_root: str,
    image_name: str = "chicago",
    img_size: int = 512,
    patch_size: int = 512,
    num_class: int = 3,
    stride_frac: float = 1.0,
) -> str:
    """The preprocess_satellite pipeline; returns the output dataset dir."""
    image_paths = sorted(glob(os.path.join(input_root, image_name, "*_image.*")))
    if not image_paths:
        raise FileNotFoundError(os.path.join(input_root, image_name, "*_image.*"))
    out_base = os.path.join(input_root, f"{image_name}_{img_size}")
    _make_dirs(out_base, num_class)

    for split, paths in zip(SPLITS, split_scenes(image_paths)):
        data_cnt = 0
        for img_path in paths:
            img = read_image(img_path)
            label = read_image(img_path.replace("image", "labels"))
            coords = preprocess_grid_coords(img.shape[0], img.shape[1], patch_size,
                                            stride_frac)
            for (y, x) in coords:
                data_cnt += 1
                file_name = "{:s}_{:05d}.png".format(image_name, data_cnt)
                p_lab = label[y:y + patch_size, x:x + patch_size]
                _write_patch(out_base, split, file_name, img[y:y + patch_size, x:x + patch_size],
                             [color_class_mask(p_lab, c) for c in range(num_class)], img_size)
        print(f"{split}: {data_cnt} patches from {len(paths)} scenes")
    make_data_list(out_base)
    return out_base


def preprocess_grayscale_label_scenes(
    input_root: str,
    image_name: str = "SN7",
    img_size: int = 512,
    patch_size: int = 512,
    num_class: int = 2,
    stride_frac: float = 0.5,
) -> str:
    """The preprocess_SN7 pipeline (per-class grayscale label dirs)."""
    image_paths = sorted(glob(os.path.join(input_root, image_name, "image", "*.png")))
    if not image_paths:
        raise FileNotFoundError(os.path.join(input_root, image_name, "image", "*.png"))
    out_base = os.path.join(input_root, f"{image_name}_{img_size}")
    _make_dirs(out_base, num_class)

    for split, paths in zip(SPLITS, split_scenes(image_paths)):
        data_cnt = 0
        for img_path in paths:
            i_name = os.path.basename(img_path)
            label_dir = os.path.dirname(img_path).replace("image", "label")
            img = read_image(img_path)
            coords = preprocess_grid_coords(img.shape[0], img.shape[1], patch_size,
                                            stride_frac)
            # 'img' → 'label' name substitution (preprocess_SN7.py:201-203)
            class_masks = [binarize_mask(read_image(
                os.path.join(label_dir, str(c), i_name).replace("img", "label"), gray=True))
                for c in range(num_class)]
            for k, (y, x) in enumerate(coords):
                file_name = "{:s}_{:05d}.png".format(image_name, data_cnt + k + 1)
                _write_patch(out_base, split, file_name, img[y:y + patch_size, x:x + patch_size],
                             [m[y:y + patch_size, x:x + patch_size] for m in class_masks],
                             img_size)
            data_cnt += len(coords)
        print(f"{split}: {data_cnt} patches from {len(paths)} scenes")
    make_data_list(out_base)
    return out_base
