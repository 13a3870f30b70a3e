"""The U-Net family without SPADE conditioning over NHWC (the JAX package's
models/unet.py; reference archs.py:271-342, 745-996):

- :class:`UNet`: VGG blocks, bilinear ×2 decoder (archs.py:791-829);
- :class:`UNetOri`: ``conv_block`` encoder, ``up_conv`` decoder (:935-996);
- :class:`AttUNet`: :class:`UNetOri` with an attention gate on each skip
  (:271-342);
- :class:`NestedUNet`: UNet++ with dense nested skips; under
  ``deep_supervision`` a list of four heads (:863-933);
- :class:`ProgUNet`: :class:`UNet` with a head per decoder level, always a
  list of four (:745-789).

Widths are the reference's 64…1024 (:data:`NB_FILTER`). Skips join as
``(skip, up)`` split-concat parts, the reference's ``cat([skip, up], 1)``.
The decoders' upsample is the ×2 ``align_corners=True`` bilinear
(:func:`ops.resize.upsample_bilinear`), materialized. Every block runs its
module composition under :func:`ops.blocks.maybe_remat` (the JAX
package's per-block remat); none reaches a fused stage kernel, as in the
JAX package, where these models run XLA's convs. Module names are the
reference's (``Conv1``, ``Up5``, ``Att5``, ``Up_conv5``, ``Conv_1x1`` in
:class:`UNetOri` and :class:`AttUNet`), so a reference ``model.pth``
loads.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.blocks import (
    AttentionBlock,
    ConvBlockBNReLU,
    UpConv,
    VGGBlock,
    maybe_remat,
)
from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.pool import max_pool_2x2
from ssunet_gan_tpu_torch.ops.resize import upsample_bilinear

NB_FILTER = (64, 128, 256, 512, 1024)  # archs.py:796, 868, 939


class _VGGUNet(nn.Module):
    """UNet's encoder and decoder of VGG blocks (``conv0_0`` .. ``conv0_4``),
    shared by :class:`UNet` and :class:`ProgUNet`."""

    def __init__(self, input_channels: int, generator: Optional[torch.Generator]):
        super().__init__()
        f = NB_FILTER
        self.conv0_0 = VGGBlock(input_channels, f[0], f[0], generator)
        self.conv1_0 = VGGBlock(f[0], f[1], f[1], generator)
        self.conv2_0 = VGGBlock(f[1], f[2], f[2], generator)
        self.conv3_0 = VGGBlock(f[2], f[3], f[3], generator)
        self.conv4_0 = VGGBlock(f[3], f[4], f[4], generator)
        self.conv3_1 = VGGBlock(f[3] + f[4], f[3], f[3], generator)
        self.conv2_2 = VGGBlock(f[2] + f[3], f[2], f[2], generator)
        self.conv1_3 = VGGBlock(f[1] + f[2], f[1], f[1], generator)
        self.conv0_4 = VGGBlock(f[0] + f[1], f[0], f[0], generator)

    def levels(self, x: torch.Tensor):
        """The decoder's outputs (x0_4, x1_3, x2_2, x3_1)."""
        x0_0 = maybe_remat(self.conv0_0, x)
        x1_0 = maybe_remat(self.conv1_0, max_pool_2x2(x0_0))
        x2_0 = maybe_remat(self.conv2_0, max_pool_2x2(x1_0))
        x3_0 = maybe_remat(self.conv3_0, max_pool_2x2(x2_0))
        x4_0 = maybe_remat(self.conv4_0, max_pool_2x2(x3_0))
        x3_1 = maybe_remat(self.conv3_1, (x3_0, upsample_bilinear(x4_0)))
        x2_2 = maybe_remat(self.conv2_2, (x2_0, upsample_bilinear(x3_1)))
        x1_3 = maybe_remat(self.conv1_3, (x1_0, upsample_bilinear(x2_2)))
        x0_4 = maybe_remat(self.conv0_4, (x0_0, upsample_bilinear(x1_3)))
        return x0_4, x1_3, x2_2, x3_1


class UNet(_VGGUNet):
    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_channels, generator)
        self.final = Conv2d(NB_FILTER[0], num_classes, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.levels(x)[0])


class ProgUNet(_VGGUNet):
    """Heads ``final0`` .. ``final3`` on x0_4, x1_3, x2_2 and x3_1 (full,
    ½, ¼ and ⅛ resolution), returned in that order."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_channels, generator)
        f = NB_FILTER
        self.final0 = Conv2d(f[0], num_classes, 1, generator=generator)
        self.final1 = Conv2d(f[1], num_classes, 1, generator=generator)
        self.final2 = Conv2d(f[2], num_classes, 1, generator=generator)
        self.final3 = Conv2d(f[3], num_classes, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        heads = (self.final0, self.final1, self.final2, self.final3)
        return [head(y) for head, y in zip(heads, self.levels(x))]


class UNetOri(nn.Module):
    """``conv_block`` encoder (``Conv1`` .. ``Conv5``), ``up_conv`` decoder
    (``Up5`` .. ``Up2``, ``Up_conv5`` .. ``Up_conv2``), head ``Conv_1x1``.
    :class:`AttUNet` adds the gates ``Att5`` .. ``Att2``."""

    attention = False

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = NB_FILTER
        self.Conv1 = ConvBlockBNReLU(input_channels, f[0], generator)
        self.Conv2 = ConvBlockBNReLU(f[0], f[1], generator)
        self.Conv3 = ConvBlockBNReLU(f[1], f[2], generator)
        self.Conv4 = ConvBlockBNReLU(f[2], f[3], generator)
        self.Conv5 = ConvBlockBNReLU(f[3], f[4], generator)
        for level in (5, 4, 3, 2):
            out = f[level - 2]
            setattr(self, f"Up{level}", UpConv(f[level - 1], out, generator))
            if self.attention:
                setattr(self, f"Att{level}", AttentionBlock(out, out, out // 2, generator))
            setattr(self, f"Up_conv{level}", ConvBlockBNReLU(2 * out, out, generator))
        self.Conv_1x1 = Conv2d(f[0], num_classes, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [maybe_remat(self.Conv1, x)]
        for level in (2, 3, 4, 5):
            conv = getattr(self, f"Conv{level}")
            skips.append(maybe_remat(conv, max_pool_2x2(skips[-1])))
        d = skips.pop()
        for level in (5, 4, 3, 2):
            d = getattr(self, f"Up{level}")(d)
            skip = skips.pop()
            if self.attention:
                skip = getattr(self, f"Att{level}")(d, skip)
            d = maybe_remat(getattr(self, f"Up_conv{level}"), (skip, d))
        return self.Conv_1x1(d)


class AttUNet(UNetOri):
    attention = True


class NestedUNet(nn.Module):
    """UNet++: node ``conv{i}_{j}`` takes the level's earlier nodes and
    the upsampled ``conv{i+1}_{j-1}``; heads ``final1`` .. ``final4`` on
    x0_1 .. x0_4 under ``deep_supervision`` (a list), else ``final`` on
    x0_4."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = NB_FILTER
        self.deep_supervision = deep_supervision
        for i in range(5):
            for j in range(5 - i):
                c_in = input_channels if (i, j) == (0, 0) else (
                    f[i - 1] if j == 0 else j * f[i] + f[i + 1])
                setattr(self, f"conv{i}_{j}", VGGBlock(c_in, f[i], f[i], generator))
        if deep_supervision:
            for k in range(1, 5):
                setattr(self, f"final{k}", Conv2d(f[0], num_classes, 1, generator=generator))
        else:
            self.final = Conv2d(f[0], num_classes, 1, generator=generator)

    def forward(self, x: torch.Tensor):
        nodes = {}
        # the JAX package's order of evaluation: column by column of the
        # encoder, each followed by its diagonal
        for j0 in range(5):
            prev = x if j0 == 0 else max_pool_2x2(nodes[j0 - 1, 0])
            nodes[j0, 0] = maybe_remat(getattr(self, f"conv{j0}_0"), prev)
            for j in range(1, j0 + 1):
                i = j0 - j
                up = upsample_bilinear(nodes[i + 1, j - 1])
                parts = tuple(nodes[i, k] for k in range(j)) + (up,)
                nodes[i, j] = maybe_remat(getattr(self, f"conv{i}_{j}"), parts)
        if self.deep_supervision:
            return [getattr(self, f"final{k}")(nodes[0, k]) for k in range(1, 5)]
        return self.final(nodes[0, 4])
