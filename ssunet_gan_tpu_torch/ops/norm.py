"""BatchNorm with torch's semantics over NHWC tensors.

Parameters and buffers carry ``nn.BatchNorm2d``'s names (``weight``,
``bias``, ``running_mean``, ``running_var``); eps 1e-5, momentum 0.1.

Eval folds the running statistics into one per-channel affine ``y = x·k +
b`` (:meth:`BatchNorm.eval_affine`), computed in f32 and applied in the
activation dtype, as the JAX package does (ops/norm.py:85-105).

Train (the JAX package's ops/norm.py:108-130) normalizes with the batch
statistics, two-pass in f32 (the biased variance), returns the activation
dtype, and moves the running statistics with the unbiased variance.
:meth:`BatchNorm.update_running` is that update alone, for the fused train
stage, which computes the batch statistics itself (ops/norm.py:65-73).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

MOMENTUM = 0.1  # torch's running-average rate


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The folded eval affine (k, b) in f32: y = x·k + b."""
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        k = inv * self.weight.float()
        b = (-self.running_mean.float() * inv) * self.weight.float() + self.bias.float()
        return k, b

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, unbiased_var: torch.Tensor) -> None:
        """running = (1 − MOMENTUM)·running + MOMENTUM·batch (torch)."""
        m = MOMENTUM
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean.float())
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased_var.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            k, b = self.eval_affine()
            return x * k.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        mean = xf.mean((0, 1, 2))
        var = (xf - mean).square().mean((0, 1, 2))
        count = x.numel() // x.shape[-1]
        self.update_running(mean.detach(), var.detach() * (count / max(count - 1, 1)))
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)
