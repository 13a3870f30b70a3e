"""The GAN generator (the JAX package's models/gan.py:119-147; reference
models_seg_gan.py:193-243): a registry arch as submodule ``net``, so a
GAN-trained ``model.pth`` with ``net.``-prefixed keys loads into it.
``Discriminator`` and ``SRResNet`` are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch

from ssunet_gan_tpu_torch.models import build_model


class Generator(torch.nn.Module):
    """``net`` is ``build_model(arch, num_classes, input_channels,
    deep_supervision, ...)``; the forward is ``net(x)``."""

    def __init__(self, arch: str, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False, device="cuda"):
        super().__init__()
        self.net = build_model(arch, num_classes, input_channels, deep_supervision,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    @classmethod
    def from_config(cls, config: dict, device="cuda") -> "Generator":
        """From a model card (train_seg_gan.py:445-448)."""
        return cls(config["arch"], config["num_classes"], config["input_channels"],
                   bool(config["deep_supervision"]), device=device).eval()
