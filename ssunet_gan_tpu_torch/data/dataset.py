"""Datasets of the supervised trainer (the JAX package's data/dataset.py).

Items are ``(ori_img, img, mask, meta)`` with HWC float32 image and mask.
:class:`SegmentationDataset` reads the reference's directory layout
(dataset.py:47-144) through :func:`data.png.read_image`, which returns
what ``cv2.imread`` does:

    <dataset>/images/<split>/<id><img_ext>
    <dataset>/annotations/<split>/<class_index>/<id><mask_ext>   (num_classes > 1)
    <dataset>/annotations/<split>/<id><mask_ext>                 (num_classes == 1)

3-channel images are read BGR, others as one gray plane; per-class masks
are binarized by ``/255`` then a uint8 cast (255 → 1, anything else → 0);
a one-class mask is read as is. :class:`SyntheticDataset` makes scenes
without files.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ssunet_gan_tpu_torch.data.png import read_image


def list_split_ids(input_folder: str, dataset: str, split: str, img_ext: str) -> List[str]:
    """The sorted image ids of a split (train.py:333-336)."""
    paths = glob(os.path.join(input_folder, dataset, "images", split, "*" + img_ext))
    return sorted(os.path.splitext(os.path.basename(p))[0] for p in paths)


class SegmentationDataset:
    """Map-style dataset of the reference's ``Dataset``; ``from_file`` is
    :func:`image_to_afile`'s preloaded ``{id: {"img": array}}``, used for
    3-channel images."""

    def __init__(self, img_ids: Sequence[str], img_dir: str, mask_dir: str, img_ext: str,
                 mask_ext: str, num_classes: int, input_channels: int = 3, transform=None,
                 from_file: Optional[Dict[str, Dict[str, np.ndarray]]] = None):
        self.img_ids = list(img_ids)
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.img_ext = img_ext
        self.mask_ext = mask_ext
        self.num_classes = int(num_classes)
        self.input_channels = int(input_channels)
        self.transform = transform
        self.from_file = from_file

    def __len__(self) -> int:
        return len(self.img_ids)

    def _read_image(self, img_id: str) -> np.ndarray:
        if self.from_file is not None and self.input_channels == 3:
            return self.from_file[str(img_id)]["img"]
        path = os.path.join(self.img_dir, img_id + self.img_ext)
        if self.input_channels == 3:
            return read_image(path)
        return read_image(path, gray=True)[..., None]

    def _read_mask(self, img_id: str) -> np.ndarray:
        if self.num_classes == 1:
            return read_image(os.path.join(self.mask_dir, img_id + self.mask_ext),
                              gray=True)[..., None]
        chans = []
        for i in range(self.num_classes):
            m = read_image(os.path.join(self.mask_dir, str(i), img_id + self.mask_ext),
                           gray=True)
            chans.append((m.astype(np.float32) / 255.0).astype(np.uint8)[..., None])
        return np.dstack(chans)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        img_id = self.img_ids[idx]
        img = self._read_image(img_id)
        ori_img = img
        mask = self._read_mask(img_id)
        if self.transform is not None:
            augmented = self.transform(image=img, mask=mask)
            img, mask = augmented["image"], augmented["mask"]
        return (ori_img, np.ascontiguousarray(img, dtype=np.float32),
                np.ascontiguousarray(mask, dtype=np.float32), {"img_id": img_id})


def image_to_afile(img_dir: str, mask_dir: str, base_name, img_ids: Sequence[str],
                   config: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Preload images into ``{id: {"img": BGR array}}`` (dataset.py:27-45),
    the ``from_file`` fast path; ``mask_dir`` and ``base_name`` are the
    reference's unused arguments."""
    return {str(i): {"img": read_image(os.path.join(img_dir, i + config["img_ext"]))}
            for i in img_ids}


class SyntheticDataset:
    """Deterministic synthetic scenes (no files): random uint8 textures
    with one inverted disc per class, the mask its indicator
    (data/dataset.py:180-220, bit-equal)."""

    def __init__(self, n: int, h: int, w: int, num_classes: int,
                 input_channels: int = 3, transform=None, seed: int = 0):
        self.n, self.h, self.w = n, h, w
        self.num_classes = num_classes
        self.input_channels = input_channels
        self.transform = transform
        self.seed = seed
        self.img_ids = [f"synth_{i:04d}" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        img = rng.integers(0, 256, (self.h, self.w, self.input_channels), np.uint8)
        mask = np.zeros((self.h, self.w, self.num_classes), np.uint8)
        for c in range(self.num_classes):
            cy, cx = rng.integers(0, self.h), rng.integers(0, self.w)
            r = int(rng.integers(self.h // 8, self.h // 3))
            yy, xx = np.mgrid[: self.h, : self.w]
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            mask[..., c] = blob
            ch = c % self.input_channels
            img[..., ch] = np.where(blob, 255 - img[..., ch], img[..., ch])
        ori = img
        if self.transform is not None:
            augmented = self.transform(image=img, mask=mask)
            img, mask = augmented["image"], augmented["mask"]
        return (ori, np.ascontiguousarray(img, np.float32),
                np.ascontiguousarray(mask, np.float32), {"img_id": self.img_ids[idx]})
