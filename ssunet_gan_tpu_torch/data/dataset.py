"""Datasets of the supervised trainer (the JAX package's data/dataset.py).

Items are ``(ori_img, img, mask, meta)`` with HWC float32 image and mask.
Only :class:`SyntheticDataset` is ported; the file-backed
``SegmentationDataset`` needs cv2 and waits (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


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
