"""The GAN's networks (the JAX package's models/gan.py; reference
models_seg_gan.py:100-300), NHWC, under the reference's module names:

- :class:`Discriminator`: the SRGAN discriminator over segmentation maps
  (``num_classes`` channels in), ``conv_blocks.{i}.conv_block.{0,1}``,
  AdaptiveAvgPool(6, 6), ``fc1`` → LeakyReLU(0.2) → ``fc2``. It flattens
  the pooled map in torch's NCHW order, so a reference ``fc1.weight``
  loads unchanged (the JAX package flattens NHWC and permutes fc1's rows
  instead). ``fc2`` takes ``fc_size`` inputs, as the JAX package's does;
  the reference hardcodes 1024, the only size it runs.
- :class:`SRResNet` (present but unused in the reference's training).
- :class:`Generator`: a registry arch as submodule ``net``, so a
  GAN-trained ``model.pth`` with ``net.``-prefixed keys loads into it; the
  warm start from a supervised checkpoint is
  ``train.checkpoint.warm_start_generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops.blocks import SRConvBlock, SubPixelConvBlock
from ssunet_gan_tpu_torch.ops.conv import Dense
from ssunet_gan_tpu_torch.ops.resize import adaptive_avg_pool


class Discriminator(nn.Module):
    """SRGAN discriminator on NHWC segmentation maps; one logit per image."""

    def __init__(self, num_classes: int, kernel_size: int = 3, n_channels: int = 64,
                 n_blocks: int = 8, fc_size: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_channels = out_channels = num_classes
        blocks = []
        for i in range(n_blocks):
            out_channels = ((n_channels if i == 0 else in_channels * 2) if i % 2 == 0
                            else in_channels)
            blocks.append(SRConvBlock(in_channels, out_channels, kernel_size,
                                      stride=1 if i % 2 == 0 else 2, batch_norm=i != 0,
                                      activation="leakyrelu", generator=generator))
            in_channels = out_channels
        self.conv_blocks = nn.Sequential(*blocks)
        self.fc1 = Dense(out_channels * 6 * 6, fc_size, generator=generator)
        self.fc2 = Dense(fc_size, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool(self.conv_blocks(x), 6, 6)
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)  # torch's NCHW flatten
        return self.fc2(F.leaky_relu(self.fc1(x), 0.2))


class _SRResidualBlock(nn.Module):
    """conv-BN-PReLU, conv-BN, plus the input (models_seg_gan.py:100-131)."""

    def __init__(self, kernel_size: int = 3, n_channels: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_block1 = SRConvBlock(n_channels, n_channels, kernel_size, batch_norm=True,
                                       activation="prelu", generator=generator)
        self.conv_block2 = SRConvBlock(n_channels, n_channels, kernel_size, batch_norm=True,
                                       generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block2(self.conv_block1(x)) + x


class SRResNet(nn.Module):
    """SRResNet super-resolution net, RGB in, tanh RGB out at
    ``scaling_factor`` (2, 4 or 8) times the size (models_seg_gan.py:134-190)."""

    def __init__(self, large_kernel_size: int = 9, small_kernel_size: int = 3,
                 n_channels: int = 64, n_blocks: int = 16, scaling_factor: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if int(scaling_factor) not in (2, 4, 8):
            raise ValueError(f"scaling_factor must be 2, 4 or 8, got {scaling_factor}")
        g = generator
        self.conv_block1 = SRConvBlock(3, n_channels, large_kernel_size, activation="prelu",
                                       generator=g)
        self.residual_blocks = nn.Sequential(*[
            _SRResidualBlock(small_kernel_size, n_channels, generator=g)
            for _ in range(n_blocks)])
        self.conv_block2 = SRConvBlock(n_channels, n_channels, small_kernel_size,
                                       batch_norm=True, generator=g)
        self.subpixel_convolutional_blocks = nn.Sequential(*[
            SubPixelConvBlock(small_kernel_size, n_channels, 2, generator=g)
            for _ in range(int(math.log2(int(scaling_factor))))])
        self.conv_block3 = SRConvBlock(n_channels, 3, large_kernel_size, activation="tanh",
                                       generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_block1(x)
        x = self.conv_block2(self.residual_blocks(x)) + x
        return self.conv_block3(self.subpixel_convolutional_blocks(x))


class Generator(nn.Module):
    """``net`` is ``build_model(arch, num_classes, input_channels,
    deep_supervision, ...)``; the forward is ``net(x)``."""

    def __init__(self, arch: str, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False, device="cuda", seed: int = 0):
        super().__init__()
        self.net = build_model(arch, num_classes, input_channels, deep_supervision,
                               seed=seed, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    @classmethod
    def from_config(cls, config: dict, device="cuda", seed: int = 0) -> "Generator":
        """From a model card (train_seg_gan.py:445-448)."""
        return cls(config["arch"], config["num_classes"], config["input_channels"],
                   bool(config["deep_supervision"]), device=device, seed=seed).eval()
