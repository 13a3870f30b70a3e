"""Spectral normalization of a conv weight, the JAX package's
ops/spectral.py (torch's ``nn.utils.spectral_norm`` on the reference's
SPADEResnetBlock convs, archs.py:55-56), on NHWC tensors.

The power-iteration vectors are buffers under torch's names: ``weight_u``
(out channels) and ``weight_v`` (in·kh·kw, torch's (I, kh, kw) order of the
weight's matrix view; the JAX package keeps v in (kh, kw, I) order, which
``compat.from_jax_variables`` permutes). The weight itself is
``weight_orig`` (OIHW). A training forward runs one power iteration and
stores u and v; an eval forward reuses them. sigma = uᵀ·W·v carries the
gradient through W only, and l2 normalization divides by ‖v‖ + 1e-12, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import conv2d_nhwc

EPS = 1e-12


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (v.norm() + EPS)


class SNConv2d(nn.Module):
    """Conv2d with a spectrally normalized weight; u and v drawn from a
    normal distribution and normalized at init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 power_iterations: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.power_iterations = power_iterations
        fan_in = in_channels * kernel_size * kernel_size
        bound = 1.0 / math.sqrt(fan_in)
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
            .uniform_(-bound, bound, generator=generator))
        self.bias = (nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound,
                                                                     generator=generator))
                     if bias else None)
        self.register_buffer("weight_u", _l2_normalize(
            torch.randn(out_channels, generator=generator)))
        self.register_buffer("weight_v", _l2_normalize(torch.randn(fan_in, generator=generator)))

    def sigma(self) -> torch.Tensor:
        """uᵀ·W·v at the stored u and v; in training, after one power
        iteration on the current weight that updates them."""
        mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.training:
            with torch.no_grad():
                for _ in range(self.power_iterations):
                    v = _l2_normalize(mat.t() @ u)
                    u = _l2_normalize(mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        # the new u and v, not the buffers: a later training forward in the
        # same graph updates the buffers in place
        return u @ (mat @ v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight_orig / self.sigma()).to(x.dtype)
        return conv2d_nhwc(x, w, self.bias, self.padding, self.stride)
