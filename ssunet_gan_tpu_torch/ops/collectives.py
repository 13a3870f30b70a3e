"""The data-parallel hooks of the train path (the JAX package's
ops/collectives.py).

Under a mesh each rank runs the step on its local slice of the batch, so
every reduction over the batch must cross the ranks: the BatchNorm batch
statistics of the module composition (``ops/norm.py``), the fused train
stage's per-channel sums between its kernels and in both backwards
(``ops/stage_kernel_train.py``, ``ops/train_bwd.py``) and the metrics
(``ops/metrics.py``). :func:`train_axis` is the switch the step enters; the
reductions go through :func:`psum_if` / :func:`pmean_if`, which are the
identity outside it. The axis size is a Python number, so counts and
unbiased-variance factors stay exact.

:func:`psum_if` is an autograd Function: its forward all-reduces (sum) a
copy, its backward all-reduces the cotangent, the transpose of a sum over
ranks being that sum. A CUDA tensor under a group whose backend is not
NCCL raises: a copy through the host would hide the device.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional

import torch
import torch.distributed as dist

_GROUP: Optional[Any] = None
_SIZE: int = 1
# collectives run and the bytes they reduce or gather, for the data-parallel
# paths' record
calls = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


@contextmanager
def train_axis(group, size: int):
    """Reduce over ``group``'s ``size`` ranks while active (``group`` None:
    no axis, as at world size 1 without a process group)."""
    global _GROUP, _SIZE
    prev = (_GROUP, _SIZE)
    _GROUP, _SIZE = group, int(size)
    try:
        yield
    finally:
        _GROUP, _SIZE = prev


def current_axis():
    """The active group, or None."""
    return _GROUP


def axis_size() -> int:
    """The active axis's size (1 when inactive)."""
    return _SIZE if _GROUP is not None else 1


def check_device(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, after refusing a CUDA tensor under a group that is not NCCL."""
    if t.is_cuda and dist.get_backend(group) != "nccl":
        raise ValueError(f"a CUDA tensor under a {dist.get_backend(group)} group: "
                         "reductions over the card take an NCCL group")
    return t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``t`` over ``group``'s ranks in place; returns it."""
    dist.all_reduce(check_device(t, group), group=group)
    calls["all_reduce"] += 1
    calls["bytes"] += t.numel() * t.element_size()
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks of a copy of ``t``."""
    t = check_device(t, group).detach()
    return all_reduce_(t.clone(memory_format=torch.contiguous_format), group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def psum_if(x: torch.Tensor) -> torch.Tensor:
    """The sum over the active axis's ranks, the identity when none is."""
    return _PSum.apply(x, _GROUP) if _GROUP is not None else x


def pmean_if(x: torch.Tensor) -> torch.Tensor:
    """The mean over the active axis's ranks, the identity when none is."""
    return psum_if(x) / _SIZE if _GROUP is not None else x


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all), stacked in rank order."""
    t = check_device(t, group).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    calls["all_gather"] += 1
    calls["bytes"] += t.numel() * t.element_size() * len(parts)
    return torch.stack(parts)
