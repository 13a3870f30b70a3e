"""BatchNorm with torch's semantics over NHWC tensors.

Parameters and buffers carry ``nn.BatchNorm2d``'s names (``weight``,
``bias``, ``running_mean``, ``running_var``); eps 1e-5 and momentum 0.1
unless a module is built with its own (EfficientNet's: 1e-3 and 0.01).

Eval folds the running statistics into one per-channel affine ``y = x·k +
b`` (:meth:`BatchNorm.eval_affine`), computed in f32 and applied in the
activation dtype, as the JAX package does (ops/norm.py:85-105).

Train (the JAX package's ops/norm.py:108-130) normalizes with the batch
statistics, two-pass in f32 (the biased variance), returns the activation
dtype, and moves the running statistics with the unbiased variance. Under
a data-parallel step (``ops/collectives.py`` ``train_axis``) both means
cross the ranks, so equal slices give the global batch's statistics
(SyncBN).
:meth:`BatchNorm.update_running` is that update alone, for the fused train
stage, which computes the batch statistics itself (ops/norm.py:65-73).
:func:`frozen_running` holds the running statistics still while a block's
forward is recomputed for its backward (``ops/blocks.py`` ``maybe_remat``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.collectives import axis_size, pmean_if

MOMENTUM = 0.1  # torch's running-average rate


@contextlib.contextmanager
def frozen_running(module: nn.Module):
    """The running statistics of every BatchNorm in ``module`` do not move
    while active (training forwards still normalize with batch
    statistics)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


class BatchNorm(nn.Module):
    frozen = False  # see frozen_running

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # None: the module constant MOMENTUM
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
        """running = (1 − m)·running + m·batch (torch), m the module's
        momentum or MOMENTUM."""
        if self.frozen:
            return
        m = MOMENTUM if self.momentum is None else self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean.float())
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased_var.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            k, b = self.eval_affine()
            return x * k.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        # under a mesh's train axis the batch is this rank's slice: the
        # statistics are the means over the ranks, two-pass as in JAX
        mean = pmean_if(xf.mean((0, 1, 2)))
        var = pmean_if((xf - mean).square().mean((0, 1, 2)))
        count = x.numel() // x.shape[-1] * axis_size()
        self.update_running(mean.detach(), var.detach() * (count / max(count - 1, 1)))
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)
