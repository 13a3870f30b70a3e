"""Segmentation metrics on the device, the JAX package's ops/metrics.py
(reference metrics.py:6-35). Callers slice off the background channel
first (:func:`foreground_slice`, train.py:101-102)."""

from __future__ import annotations

import torch

SMOOTH = 1e-5


def iou_score(output_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Thresholded IoU: sigmoid > 0.5 (NaN counts as False) against
    target > 0.5, smoothed intersection over union of all elements."""
    probs = torch.sigmoid(output_logits.float())
    out_bin = probs > 0.5  # NaN compares False
    tar_bin = target.float() > 0.5
    inter = (out_bin & tar_bin).sum().float()
    union = (out_bin | tar_bin).sum().float()
    return (inter + SMOOTH) / (union + SMOOTH)


def dice_coef(output_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice of sigmoid probabilities, no threshold."""
    probs = torch.sigmoid(output_logits.float()).reshape(-1)
    target = target.float().reshape(-1)
    return (2.0 * (probs * target).sum() + SMOOTH) / (probs.sum() + target.sum() + SMOOTH)


def foreground_slice(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Channels 1..C−1 of an NHWC tensor (background excluded)."""
    return x[..., 1:num_classes]
