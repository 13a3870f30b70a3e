"""The ss-UNets' conv blocks over NHWC: :class:`VGGBlock` (reference
archs.py:94-112) and the ResNet blocks of expansion 1, :class:`BasicBlock`
(archs.py:205-241) and :class:`Bottleneck` (archs.py:244-269).

A ResNet block's shortcut is present iff ``in_planes != planes`` (stride is
always 1 in the SS-UNets): a 1×1 conv without BatchNorm in the BasicBlock,
a 1×1 conv with BatchNorm in the Bottleneck. The module names
``shortcut.0`` and ``shortcut.1`` are the reference's ``nn.Sequential``
indices. A VGG block has no shortcut and no residual: its stage is the
BasicBlock stage with a zero shortcut.

:func:`set_remat` is the JAX package's per-block rematerialization
(ops/blocks.py:45-54, the ``remat`` config key): in training the blocks of
the module composition run under ``torch.utils.checkpoint``, so their
activations are recomputed in the backward instead of kept.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssunet_gan_tpu_torch.ops.conv import Conv2d, as_parts
from ssunet_gan_tpu_torch.ops.norm import BatchNorm, frozen_running

_REMAT = False


def set_remat(enabled: bool) -> None:
    """Per-block rematerialization in training on (True) or off."""
    global _REMAT
    _REMAT = bool(enabled)


def remat_enabled() -> bool:
    return _REMAT


def maybe_remat(block: nn.Module, parts) -> torch.Tensor:
    """``block(parts)``; in training with the remat mode on and gradients
    recorded, under ``torch.utils.checkpoint`` (non-reentrant). The
    backward's recomputation normalizes with the same batch statistics and
    leaves the BatchNorms' running averages alone, so they move once per
    forward, as without remat."""
    parts = as_parts(parts)
    if not (_REMAT and block.training and torch.is_grad_enabled()):
        return block(parts)
    calls = []

    def run(*xs):
        calls.append(None)
        if len(calls) == 1:
            return block(xs)
        with frozen_running(block):
            return block(xs)

    return checkpoint(run, *parts, use_reentrant=False)


class VGGBlock(nn.Module):
    """conv3 (bias) → BN → ReLU → conv3 (bias) → BN → ReLU with separate
    middle and out widths (``out_channels`` defaults to the middle's)."""

    shortcut = None  # a VGG stage is the BasicBlock stage with a zero shortcut

    def __init__(self, in_channels: int, middle_channels: int,
                 out_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_channels = middle_channels if out_channels is None else out_channels
        self.in_planes, self.planes = in_channels, out_channels
        self.conv1 = Conv2d(in_channels, middle_channels, 3, 1, generator=generator)
        self.bn1 = BatchNorm(middle_channels)
        self.conv2 = Conv2d(middle_channels, out_channels, 3, 1, generator=generator)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)))

    def stage_params(self):
        """(w1, (s1, s1·b1 + t1), w2, (s2, s2·b2 + t2), None): the eval
        BatchNorms folded to affines with the conv biases folded into
        their offsets, and no shortcut (the JAX package's
        ``VGGBlock(None, False)``, ops/blocks.py:84-90)."""
        (s1, t1), (s2, t2) = self.bn1.eval_affine(), self.bn2.eval_affine()
        return (self.conv1.weight, (s1, s1 * self.conv1.bias.float() + t1),
                self.conv2.weight, (s2, s2 * self.conv2.bias.float() + t2), None)


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
