"""Small shared utilities (the JAX package's utils.py; reference
scripts/utils.py): the running average, the CLI's boolean parser, the
parameter count, the reference's seeding (train.py:35-39) and the HSV
brightness renormalisation, numpy only (no cv2)."""

from __future__ import annotations

import argparse
import random
from typing import Any

import numpy as np
import torch

from ssunet_gan_tpu_torch.data.transforms import hsv_to_rgb, rgb_to_hsv


class AverageMeter:
    """Computes and stores the running average of a scalar series."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def str2bool(v: Any) -> bool:
    """argparse type: "true"/"1" and "false"/"0" (any case), or a bool."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1"):
        return True
    if str(v).lower() in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def count_params(model: torch.nn.Module) -> int:
    """Total number of parameters (utils.py:54-55)."""
    return sum(p.numel() for p in model.parameters())


def seed_everything(torch_seed: int = 41, numpy_seed: int = 101) -> int:
    """Seed ``random`` and numpy's global state with ``numpy_seed`` and
    torch's with ``torch_seed`` (the reference's 41 and 101); returns
    ``torch_seed``, the model's weight seed (``build_model(seed=)``)."""
    np.random.seed(numpy_seed)
    random.seed(numpy_seed)
    torch.manual_seed(torch_seed)
    return torch_seed


def adjust_brightness(img: np.ndarray, target_v: int = 90) -> np.ndarray:
    """HSV V-channel renormalisation to a target mean (utils.py:5-42).

    BGR uint8 in, BGR uint8 out: V shifted so that its mean becomes
    ``target_v`` (the reference hardcodes 90), rounded and clipped to [1,
    255]. cv2's 8-bit BGR↔HSV through :func:`data.transforms.rgb_to_hsv`
    (bit-exact) and :func:`data.transforms.hsv_to_rgb` (within one level of
    OpenCV 5) on the channels reversed."""
    hsv = rgb_to_hsv(img[..., ::-1])
    v = hsv[..., 2]
    diff = target_v - float(np.average(v))
    hsv[..., 2] = np.clip(np.round(v.astype(np.float64) + diff), 1, 255).astype(np.uint8)
    return np.ascontiguousarray(hsv_to_rgb(hsv)[..., ::-1])
