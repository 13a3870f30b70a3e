"""Model registry: the reference's ``archs.__dict__[name](num_classes,
input_channels, deep_supervision)`` lookup (train.py:252-254). The port
carries the self-SPADE U-Nets ``UNet_R_SS_v2`` (the flagship), ``UNet_R_SS``
and ``UNet_B_SS``; :data:`NOT_PORTED` names the reference's other
architectures."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.models.ssunet import UNetBSS, UNetRSS, UNetRSSv2

ARCH_REGISTRY = {"UNet_B_SS": UNetBSS, "UNet_R_SS": UNetRSS, "UNet_R_SS_v2": UNetRSSv2}
# the JAX package's other registry names, in the order ROADMAP.md queues them
NOT_PORTED = ("SSUNet", "UNet", "NestedUNet", "UNet_ori", "AttUNet", "ProgUNet",
              "effnet_unet", "UNet_R_SS_v2_wide")


def build_model(arch: str, num_classes: int, input_channels: int = 3,
                deep_supervision: bool = False,
                filters: Optional[Sequence[int]] = None, seed: int = 0,
                device="cuda"):
    """Build ``arch`` in eval mode on ``device`` with weights drawn on the
    CPU from a ``torch.Generator`` seeded with ``seed`` (so every device
    gets the same weights). ``filters`` overrides the stage widths."""
    if arch not in ARCH_REGISTRY:
        known = "not ported yet" if arch in NOT_PORTED else "unknown"
        raise KeyError(
            f"arch {arch!r} is {known} (ported: {list(ARCH_REGISTRY)}; still to port: "
            f"{list(NOT_PORTED)}); see ROADMAP.md for the order of the port"
        )
    dev = resolve_device(device)
    kw = {} if filters is None else {"filters": tuple(filters)}
    gen = torch.Generator().manual_seed(seed)
    model = ARCH_REGISTRY[arch](num_classes=num_classes,
                                input_channels=input_channels,
                                deep_supervision=deep_supervision,
                                generator=gen, **kw)
    return model.eval().to(dev)
