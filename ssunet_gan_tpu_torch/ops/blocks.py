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

The SRGAN blocks (the JAX package's ops/blocks.py:281-330; reference
models_seg_gan.py:13-97): :class:`SRConvBlock`, conv [+ BN] [+ PReLU,
LeakyReLU(0.2) or tanh] as the reference's ``nn.Sequential``
``conv_block.{0,1,2}``, and :class:`SubPixelConvBlock`, conv → pixel
shuffle → PReLU.

The other families' blocks (the JAX package's ops/blocks.py:96-153,
332-432), under the reference's torch module names so that a reference
``model.pth`` loads: :class:`ConvBlockBNReLU` (``conv_block``,
archs.py:831: ``conv.0/.1/.3/.4``), :class:`UpConv` (``up_conv``, :848:
nearest ×2 then ``up.1/.2``), :class:`AttentionBlock` (``Attention_block``,
:115: ``W_g``, ``W_x``, ``psi``), :class:`SELayer` (:18: ``fc.0/.2``),
and the blocks no model of the JAX package uses: :class:`Modulecell`
(xresidualblock.py:9: ``features.0``, ``module.0/.2/.3``),
:class:`xResidualBlock`, :class:`xBasicBlock` and
:class:`SPADEResnetBlock` (archs.py:35-90, on :class:`ops.spade.SPADE` and
:class:`ops.spectral.SNConv2d`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssunet_gan_tpu_torch.ops.conv import Conv2d, Dense, PReLU, as_parts
from ssunet_gan_tpu_torch.ops.norm import BatchNorm, frozen_running
from ssunet_gan_tpu_torch.ops.pool import global_avg_pool
from ssunet_gan_tpu_torch.ops.resize import pixel_shuffle, upsample_nearest
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.ops.spectral import SNConv2d

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


class SRConvBlock(nn.Module):
    """conv (padding k // 2) [+ BatchNorm] [+ activation]: ``activation``
    None, "prelu", "leakyrelu" (slope 0.2) or "tanh", in any case."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, batch_norm: bool = False, activation: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        act = None if activation is None else activation.lower()
        acts = {None: None, "prelu": PReLU, "leakyrelu": lambda: nn.LeakyReLU(0.2),
                "tanh": nn.Tanh}
        if act not in acts:
            raise ValueError(f"unknown activation {activation!r}")
        layers = [Conv2d(in_channels, out_channels, kernel_size, kernel_size // 2,
                         generator=generator, stride=stride)]
        if batch_norm:
            layers.append(BatchNorm(out_channels))
        if acts[act] is not None:
            layers.append(acts[act]())
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(x)


class SubPixelConvBlock(nn.Module):
    """conv to n·r² channels → pixel shuffle ×r → PReLU."""

    def __init__(self, kernel_size: int = 3, n_channels: int = 64, scaling_factor: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.conv = Conv2d(n_channels, n_channels * scaling_factor ** 2, kernel_size,
                           kernel_size // 2, generator=generator)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(pixel_shuffle(self.conv(x), self.scaling_factor))


class ConvBlockBNReLU(nn.Module):
    """conv3 (bias) → BN → ReLU → conv3 (bias) → BN → ReLU at one width,
    as the reference's ``nn.Sequential`` ``conv``; takes split-concat
    parts."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, 1, generator=generator),
            BatchNorm(out_channels), nn.ReLU(),
            Conv2d(out_channels, out_channels, 3, 1, generator=generator),
            BatchNorm(out_channels), nn.ReLU())

    def forward(self, x) -> torch.Tensor:
        return self.conv(x)


class _Nearest(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, 2)


class UpConv(nn.Module):
    """Nearest ×2 → conv3 (bias) → BN → ReLU (``up.0`` .. ``up.3``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = nn.Sequential(_Nearest(),
                                Conv2d(in_channels, out_channels, 3, 1, generator=generator),
                                BatchNorm(out_channels), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class AttentionBlock(nn.Module):
    """The Attention U-Net gate: ``x · σ(BN(psi(relu(BN(W_g g) + BN(W_x
    x)))))`` with 1×1 convs (bias)."""

    def __init__(self, f_g: int, f_l: int, f_int: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.W_g = nn.Sequential(Conv2d(f_g, f_int, 1, generator=generator), BatchNorm(f_int))
        self.W_x = nn.Sequential(Conv2d(f_l, f_int, 1, generator=generator), BatchNorm(f_int))
        self.psi = nn.Sequential(Conv2d(f_int, 1, 1, generator=generator), BatchNorm(1),
                                 nn.Sigmoid())
        self.relu = nn.ReLU()

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x * self.psi(self.relu(self.W_g(g) + self.W_x(x)))


class SELayer(nn.Module):
    """Squeeze-and-excitation: ``x · σ(fc2(relu(fc1(mean_HW x))))``, the
    two ``nn.Linear`` without bias."""

    def __init__(self, channel: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = nn.Sequential(Dense(channel, channel // reduction, bias=False,
                                      generator=generator), nn.ReLU(),
                                Dense(channel // reduction, channel, bias=False,
                                      generator=generator), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(global_avg_pool(x, keepdims=False))[:, None, None, :]


def gaussian_activation(x: torch.Tensor) -> torch.Tensor:
    """exp(−x²) (xresidualblock.py:5-7)."""
    return torch.exp(-(x * x))


class Modulecell(nn.Module):
    """The feature conv times a Gaussian-activated depthwise mask:
    ``features(x) · exp(−BN(dw(relu(BN(features(x)))))²)``."""

    def __init__(self, in_channels: int, out_channels: int = 64, kernel_size: int = 3,
                 skernel_size: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = nn.Sequential(Conv2d(in_channels, out_channels, kernel_size,
                                             (kernel_size - 1) // 2, generator=generator))
        self.module = nn.Sequential(
            BatchNorm(out_channels), nn.ReLU(),
            Conv2d(out_channels, out_channels, skernel_size, (skernel_size - 1) // 2,
                   generator=generator, groups=out_channels),
            BatchNorm(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.features(x)
        return x1 * gaussian_activation(self.module(x1))


class xResidualBlock(nn.Module):
    """Modulecell → conv (padding 1) → BN, plus the input. As in the
    reference and the JAX package, the sum needs ``in_planes == planes``
    and a shape-keeping conv (kernel 3, stride 1)."""

    def __init__(self, in_planes: int, planes: int = 64, kernel_size: int = 3,
                 stride: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.md = Modulecell(in_planes, planes, kernel_size, generator=generator)
        self.conv2 = Conv2d(planes, planes, kernel_size, 1, generator=generator,
                            stride=stride)
        self.bn1 = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(self.conv2(self.md(x))) + x


class xBasicBlock(nn.Module):
    """Two xResidualBlocks (ReLU between) plus a shortcut: an
    xResidualBlock of kernel 1 when ``stride != 1`` or the width changes,
    else the input; then ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = xResidualBlock(in_planes, planes, 3, stride, generator=generator)
        self.conv2 = xResidualBlock(planes, planes, 3, 1, generator=generator)
        self.shortcut = (xResidualBlock(in_planes, planes, 1, stride, generator=generator)
                         if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class SPADEResnetBlock(nn.Module):
    """SPADE ResNet block: ``x_s + conv_1(lrelu(norm_1(conv_0(lrelu(norm_0(x,
    seg))), seg)))`` with spectral-normed 3×3 convs, ``fmiddle`` =
    min(fin, fout) for ``opt_type`` 1 else max, and the learned shortcut
    ``conv_s(norm_s(x, seg))`` (1×1, no bias) when fin ≠ fout. Every SPADE
    is "spadesyncbatch3x3" with ``semantic_nc`` labels; ``seg_nc`` is the
    segmap's channels (default ``fin``)."""

    def __init__(self, fin: int, fout: int, opt_type: int = 1, semantic_nc: int = 2,
                 seg_nc: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        fmiddle = min(fin, fout) if opt_type == 1 else max(fin, fout)
        seg_nc = fin if seg_nc is None else seg_nc
        cfg = "spadesyncbatch3x3"
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.norm_s = SPADE(cfg, fin, semantic_nc, generator=generator, seg_nc=seg_nc)
            self.conv_s = Conv2d(fin, fout, 1, bias=False, generator=generator)
        self.norm_0 = SPADE(cfg, fin, semantic_nc, generator=generator, seg_nc=seg_nc)
        self.conv_0 = SNConv2d(fin, fmiddle, 3, padding=1, generator=generator)
        self.norm_1 = SPADE(cfg, fmiddle, semantic_nc, generator=generator, seg_nc=seg_nc)
        self.conv_1 = SNConv2d(fmiddle, fout, 3, padding=1, generator=generator)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(nn.functional.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(nn.functional.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx
