"""ResNet blocks, expansion 1, over NHWC: :class:`BasicBlock` (reference
archs.py:205-241) and :class:`Bottleneck` (archs.py:244-269).

A shortcut is present iff ``in_planes != planes`` (stride is always 1 in
the SS-UNets): a 1×1 conv without BatchNorm in the BasicBlock, a 1×1 conv
with BatchNorm in the Bottleneck. The module names ``shortcut.0`` and
``shortcut.1`` are the reference's ``nn.Sequential`` indices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import Conv2d, as_parts
from ssunet_gan_tpu_torch.ops.norm import BatchNorm


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_planes, self.planes = in_planes, planes
        self.conv1 = Conv2d(in_planes, planes, 3, 1, bias=False, generator=generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, bias=False, generator=generator)
        self.bn2 = BatchNorm(planes)
        self.shortcut = (
            nn.Sequential(Conv2d(in_planes, planes, 1, bias=False, generator=generator))
            if in_planes != planes else None
        )

    def forward(self, x) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.shortcut is not None:
            sc = self.shortcut(x)
        else:
            parts = as_parts(x)
            sc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return torch.relu(out + sc)

    def stage_params(self):
        """(w1, (s1, t1), w2, (s2, t2), ws or None): OIHW weights with the
        eval BatchNorms folded to affines — the block half of a fused
        stage's parameters."""
        ws = None if self.shortcut is None else self.shortcut[0].weight
        return (self.conv1.weight, self.bn1.eval_affine(), self.conv2.weight,
                self.bn2.eval_affine(), ws)

    def train_params(self):
        """(w1, (γ1, β1), w2, (γ2, β2), ws or None): the raw parameters —
        the block half of a fused train stage's parameters (the JAX
        package's ``BasicBlock(None, True)``)."""
        ws = None if self.shortcut is None else self.shortcut[0].weight
        return (self.conv1.weight, (self.bn1.weight, self.bn1.bias),
                self.conv2.weight, (self.bn2.weight, self.bn2.bias), ws)


class Bottleneck(nn.Module):
    """conv1 1×1 → bn1 → relu → conv2 3×3 → bn2 → relu → conv3 1×1 → bn3,
    plus the shortcut (1×1 conv + BatchNorm, or the identity), then relu."""

    def __init__(self, in_planes: int, planes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_planes, self.planes = in_planes, planes
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False, generator=generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, bias=False, generator=generator)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes, 1, bias=False, generator=generator)
        self.bn3 = BatchNorm(planes)
        self.shortcut = (
            nn.Sequential(Conv2d(in_planes, planes, 1, bias=False, generator=generator),
                          BatchNorm(planes))
            if in_planes != planes else None
        )

    def forward(self, x) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.shortcut is not None:
            sc = self.shortcut(x)
        else:
            parts = as_parts(x)
            sc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return torch.relu(out + sc)

    def stage_params(self):
        """(w1, (s1, t1), w2, (s2, t2), w3, (s3, t3), ws, (ss, ts)): OIHW
        weights with the eval BatchNorms folded to affines — the block half
        of a fused bottleneck stage's parameters (the JAX package's
        ``Bottleneck(None, False)``); ``ws`` and ``(ss, ts)`` are None for
        the identity shortcut."""
        ws = asb = None
        if self.shortcut is not None:
            ws, asb = self.shortcut[0].weight, self.shortcut[1].eval_affine()
        return (self.conv1.weight, self.bn1.eval_affine(), self.conv2.weight,
                self.bn2.eval_affine(), self.conv3.weight, self.bn3.eval_affine(), ws, asb)
