"""The ResNet-101 conv trunk over NHWC: AttentiveCNN's other backend (the
JAX package's models/resnet.py; reference archs.py:446-449,
``torchvision.models.resnet101`` with avgpool and fc dropped, wrapped in an
``nn.Sequential``):

    conv7×7/2 → BN → ReLU → maxpool3×3/2 →
    layer1 (3×Bottleneck,  64→256, stride 1) →
    layer2 (4×Bottleneck, 128→512, stride 2) →
    layer3 (23×Bottleneck, 256→1024, stride 2) →
    layer4 (3×Bottleneck, 512→2048, stride 2)

The stride sits on each Bottleneck's 3×3 conv, and every layer's first
block projects its input through ``downsample`` (1×1 conv + BN). Module
names are the ``nn.Sequential``'s: ``0`` (conv1), ``1`` (bn1), ``4`` ..
``7`` (layer1 .. layer4, each a Sequential of blocks), so a reference
checkpoint's ``resnet_conv.<i>...`` keys load.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.pool import max_pool_3x3_s2

# (planes, blocks, first-block stride) per layer: torchvision resnet101
LAYER_SPECS = ((64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2))
EXPANSION = 4


class Bottleneck101(nn.Module):
    """torchvision's ``Bottleneck`` (expansion 4, stride on the 3×3 conv,
    no conv biases)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        out = planes * EXPANSION
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False, generator=generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, bias=False, generator=generator,
                            stride=stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, generator=generator)
        self.bn3 = BatchNorm(out)
        self.downsample = (
            nn.Sequential(Conv2d(in_planes, out, 1, bias=False, generator=generator,
                                 stride=stride), BatchNorm(out))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class _MaxPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_3x3_s2(x)


class ResNet101Trunk(nn.Sequential):
    """(B, H, W, C) → (B, H/32, W/32, 2048)."""

    def __init__(self, in_channels: int = 3, generator: Optional[torch.Generator] = None):
        layers = [Conv2d(in_channels, 64, 7, 3, bias=False, generator=generator, stride=2),
                  BatchNorm(64), nn.ReLU(), _MaxPool()]
        in_planes = 64
        for planes, blocks, stride in LAYER_SPECS:
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck101(in_planes, planes, stride if bi == 0 else 1,
                                           downsample=bi == 0, generator=generator))
                in_planes = planes * EXPANSION
            layers.append(nn.Sequential(*layer))
        super().__init__(*layers)
