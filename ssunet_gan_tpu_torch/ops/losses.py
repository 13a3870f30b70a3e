"""Segmentation losses on logits (NHWC), the JAX package's ops/losses.py
(reference losses.py:130-136, 274-302; train.py:243-244).

:func:`get_loss` knows ``BCEDiceLoss`` and ``BCEWithLogitsLoss``; the
Lovász losses are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

SMOOTH = 1e-5


def stable_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean BCE on logits (losses.py:133-136), in f32."""
    logits, targets = logits.float(), targets.float()
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (mean reduction): the same math as
    :func:`stable_bce`."""
    return stable_bce(logits, targets)


def soft_dice(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 − the per-sample soft dice of sigmoid probabilities, averaged over
    the batch (losses.py:286-292)."""
    num = logits.shape[0]
    probs = torch.sigmoid(logits.float()).reshape(num, -1)
    targets = targets.float().reshape(num, -1)
    dice = (2.0 * (probs * targets).sum(1) + SMOOTH) / (
        probs.sum(1) + targets.sum(1) + SMOOTH)
    return 1.0 - dice.sum() / num


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """0.5·stable BCE + soft dice, or 2·dice when the BCE is not finite
    (losses.py:280-302)."""
    bce = stable_bce(logits, targets)
    dice = soft_dice(logits, targets)
    return torch.where(torch.isfinite(bce), 0.5 * bce + dice, 2.0 * dice)


LOSS_REGISTRY = {
    "BCEDiceLoss": bce_dice_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
}


def get_loss(name: str):
    """The loss function registered as ``name``."""
    if name not in LOSS_REGISTRY:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ported: {list(LOSS_REGISTRY)}); "
            "see ROADMAP.md")
    return LOSS_REGISTRY[name]
