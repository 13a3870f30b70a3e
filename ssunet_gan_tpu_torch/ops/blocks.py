"""ResNet basic block, expansion 1 (reference archs.py:205-241), over NHWC.

The shortcut is a 1×1 conv without BatchNorm, present iff
``in_planes != planes`` (stride is always 1 in the SS-UNets); its module
name ``shortcut.0`` is the reference's ``nn.Sequential`` index.
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
