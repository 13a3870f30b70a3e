"""torch-``nn.Conv2d``-shaped convolution over NHWC tensors, and the
``nn.Linear`` and ``nn.PReLU`` of the GAN's networks.

Weights are OIHW (``weight``, ``bias``), as in the reference. The input may
be a tuple of NHWC parts standing for their channel concatenation:
``conv(cat(a, b)) == conv_a(a) + conv_b(b)`` with the one weight sliced
along its input-channel axis, so no concatenated tensor is built. A conv
takes ``groups`` (the depthwise convs of EfficientNet's MBConv and the
Modulecell; parts only with ``groups == 1``, as in the JAX package) and
an asymmetric padding ``((top, bottom), (left, right))`` (TF "same"
padding, ``models/efficientnet.py`` ``SamePadConv``).

Initialisation follows torch's defaults, drawn from an explicit
:class:`torch.Generator`: U(−1/√fan_in, 1/√fan_in) for weight and bias,
or ``kaiming_uniform_(mode='fan_in')`` with a zero bias for the SS-UNet
final 1×1 convs (reference archs.py:522-524). :class:`Dense` and
:class:`PReLU` are the JAX package's ops/conv.py:178-204 under torch's
parameter names (``weight`` (out, in) and ``bias``; one slope ``weight``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def as_parts(x):
    """A tensor or a tuple/list of tensors → tuple of parts."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def conv2d_nhwc(x, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                padding: Padding = 0, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Conv of NHWC ``x`` (or split-concat parts) with an OIHW weight,
    computed in the activation dtype; returns NHWC (contiguous).
    ``padding`` is an int (every side) or ``((top, bottom), (left,
    right))``."""
    parts = as_parts(x)
    if len(parts) > 1 and groups != 1:
        raise ValueError("split-concat parts need groups=1")
    dtype = parts[0].dtype
    w = weight.to(dtype)
    pre = None  # an asymmetric pad, applied before the conv
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            pre, padding = (left, right, top, bottom), 0
    y = None
    off = 0
    for p in parts:
        c = p.shape[-1]
        xp = p.permute(0, 3, 1, 2)
        if pre is not None:
            xp = F.pad(xp, pre)
        wp = w[:, off:off + c] if groups == 1 else w
        yp = F.conv2d(xp, wp, padding=padding, stride=stride, groups=groups)
        y = yp if y is None else y + yp
        off += c
    if bias is not None:
        y = y + bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
    """Conv on NHWC tensors, padded by ``padding`` (see :func:`conv2d_nhwc`);
    ``groups`` splits the channels as torch's (the weight is (out,
    in / groups, k, k))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: Padding = 0, bias: bool = True, init: str = "torch",
                 generator: Optional[torch.Generator] = None, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"{in_channels} -> {out_channels} channels in {groups} groups")
        self.padding = padding
        self.stride = stride
        self.groups = groups
        fan_in = in_channels // groups * kernel_size * kernel_size
        if init == "kaiming_fan_in":
            bound = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        elif init == "torch":
            bound = 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size)
            .uniform_(-bound, bound, generator=generator)
        )
        if not bias:
            self.bias = None
        elif init == "kaiming_fan_in":
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.bias = nn.Parameter(
                torch.empty(out_channels).uniform_(-bound, bound, generator=generator)
            )

    def forward(self, x) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, self.padding, self.stride, self.groups)


class Dense(nn.Module):
    """torch ``nn.Linear``: ``weight`` (out, in) and ``bias`` drawn from
    U(−1/√in, 1/√in). The products of the activation-dtype operands sum in
    f32 and the bias is added in f32 before the result takes the
    activation dtype, as the JAX package's ``Dense`` does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features)
                                   .uniform_(-bound, bound, generator=generator))
        self.bias = (nn.Parameter(torch.empty(out_features).uniform_(-bound, bound,
                                                                     generator=generator))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).float()
        b = None if self.bias is None else self.bias.float()
        return F.linear(x.float(), w, b).to(x.dtype)


class PReLU(nn.Module):
    """torch ``nn.PReLU()``: one slope ``weight`` of shape (1,), 0.25 at
    init, applied in the activation dtype."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
