"""The EfficientNet-encoder segmentation model (the JAX package's
models/effnet_unet.py): an ``encoder`` attribute holding
:class:`models.efficientnet.AttentiveCNN` (its 1024-channel maps at 1/32
of the variant's resolution), four levels of bilinear ×2
(``align_corners=False``) → ``dec_conv{i}`` 3×3 (no bias) →
``dec_bn{i}`` → ReLU at 512, 256, 128 and 64 channels, the 1×1 ``final``
head, and a bilinear resize back to the input's size.

The trainer splits ``encoder.eff_conv`` onto a second Adam (the arch name
holds ``effnet``; ``train/optim.py`` ``encoder_param_labels``), which
stays frozen for the first two epochs (reference train.py:118-120,
274-301).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.models.efficientnet import AttentiveCNN
from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear

DECODER = (512, 256, 128, 64)


class EffNetUNet(nn.Module):
    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False, eff_model_name: str = "efficientnet-b2",
                 eff_flag: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = AttentiveCNN(eff_model_name, eff_flag=eff_flag,
                                    in_channels=input_channels, generator=generator)
        prev = 1024
        for i, ch in enumerate(DECODER):
            setattr(self, f"dec_conv{i}", Conv2d(prev, ch, 3, 1, bias=False,
                                                 generator=generator))
            setattr(self, f"dec_bn{i}", BatchNorm(ch))
            prev = ch
        self.final = Conv2d(prev, num_classes, 1, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = self.encoder(x, generator)
        for i in range(len(DECODER)):
            y = upsample_bilinear(y, 2, align_corners=False)
            y = getattr(self, f"dec_conv{i}")(y)
            y = torch.relu(getattr(self, f"dec_bn{i}")(y))
        return resize_bilinear(self.final(y), h, w, align_corners=False)
