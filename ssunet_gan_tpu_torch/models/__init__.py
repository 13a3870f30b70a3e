"""Model registry: the reference's ``archs.__dict__[name](num_classes,
input_channels, deep_supervision)`` lookup (train.py:252-254), with the
JAX package's 11 names in its order (models/__init__.py:18-37): the
reference's eight exported archs (:data:`ARCH_NAMES`), ``ProgUNet``,
``effnet_unet`` and the flagship's ``UNet_R_SS_v2_wide`` variant."""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.models.effnet_unet import EffNetUNet
from ssunet_gan_tpu_torch.models.ssunet import SSUNet, UNetBSS, UNetRSS, UNetRSSv2
from ssunet_gan_tpu_torch.models.unet import AttUNet, NestedUNet, ProgUNet, UNet, UNetOri

ARCH_REGISTRY = {
    "UNet": UNet,
    "NestedUNet": NestedUNet,
    "SSUNet": SSUNet,
    "UNet_ori": UNetOri,
    "UNet_B_SS": UNetBSS,
    "AttUNet": AttUNet,
    "UNet_R_SS": UNetRSS,
    "UNet_R_SS_v2": UNetRSSv2,
    "ProgUNet": ProgUNet,  # not in the reference's __all__ (archs.py:745)
    "effnet_unet": EffNetUNet,  # AttentiveCNN + decoder (the reference's latent path)
    # the 64-channel levels at 128 (not reference-checkpoint-compatible)
    "UNet_R_SS_v2_wide": functools.partial(UNetRSSv2, filters=(128, 128, 256, 384, 512, 768)),
}
ARCH_NAMES = list(ARCH_REGISTRY)[:8]  # the reference's exported set (archs.py:8)


def build_model(arch: str, num_classes: int, input_channels: int = 3,
                deep_supervision: bool = False,
                filters: Optional[Sequence[int]] = None, seed: int = 0,
                device="cuda"):
    """Build ``arch`` in eval mode on ``device`` with weights drawn on the
    CPU from a ``torch.Generator`` seeded with ``seed`` (so every device
    gets the same weights). ``filters`` overrides the ss-UNets' stage
    widths."""
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {list(ARCH_REGISTRY)}")
    dev = resolve_device(device)
    kw = {} if filters is None else {"filters": tuple(filters)}
    gen = torch.Generator().manual_seed(seed)
    model = ARCH_REGISTRY[arch](num_classes=num_classes,
                                input_channels=input_channels,
                                deep_supervision=deep_supervision,
                                generator=gen, **kw)
    return model.eval().to(dev)
