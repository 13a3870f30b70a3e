"""2×2 max-pool with window-local indices, and the matching unpool (NHWC).

``UNet_R_SS_v2`` pools with ``nn.MaxPool2d(2, 2, return_indices=True)`` and
un-pools with ``nn.MaxUnpool2d(2, stride=2)`` (reference archs.py:571-572,
628-659). Indices are kept as a window-local code 0..3 (int8) in row-major
window order TL, TR, BL, BR; ties go to the first maximum, as torch's flat
indices do. Odd spatial sizes are floor-cropped (``ceil_mode=False``).

Gradients follow torch's (and the JAX package's custom VJPs): a pool sends
each window's cotangent to its first-maximum corner alone, ties included
(autograd of the ``torch.maximum`` chain would split a tie), and the
unpool gathers that corner.

A producer-quantized activation (:class:`ops.stage_kernel_int8.QTensor`)
pools on its s8 payload and keeps its scale: max-pooling commutes with
symmetric quantization (the JAX package's ``ops/wminor.py`` ``pool2x2``).
Its codes are those of the s8 values, where ties are common and go to the
first maximum as everywhere. The unpool takes plain tensors.

The encoder seams of an eval forward are pooled by the consuming stage
kernel while it loads its window (bf16: ``csrc/eval_conv.cuh`` read mode
2; int8: ``csrc/int8_conv.cuh`` read mode 2, on s8; the JAX package's lazy
``DownTensor`` and ``DownQTensor``, ``ops/acts.py:68``, :99), so the
pooled tensor is never written; :func:`max_pool_2x2` is the same maximum
for every consumer that does not read the seam. :func:`set_lazy_pool` is
the JAX toggle.

The other families' pools: :func:`global_avg_pool` (``SELayer``; the JAX
package's ops/pool.py:76) and :func:`max_pool_3x3_s2` (the ResNet-101
trunk's ``nn.MaxPool2d(3, 2, 1)``: windows padded with −inf, as
``nn.max_pool`` in ``models/resnet.py:69``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import QTensor

# Encoder seams read in the eval stage kernels: on unless set to False (JAX
# ``set_lazy_pool``, ssunet_gan_tpu/ops/wminor.py:309, default on).
_LAZY_POOL: Optional[bool] = None


def set_lazy_pool(enabled: Optional[bool]) -> None:
    """The bf16 eval forwards' encoder pool seams: read by the consuming
    fused stage (True, or None: the default) or materialized by
    :func:`max_pool_2x2` (False)."""
    global _LAZY_POOL
    _LAZY_POOL = enabled


def lazy_pool_enabled() -> bool:
    return _LAZY_POOL is None or bool(_LAZY_POOL)


def lazy_pool_ok(x) -> bool:
    """Whether the pool seam of ``x`` (NHWC, before the pool) may be read
    by its consumer: the mode on, even H and W, and a bf16 tensor or a
    QTensor (a calibrated producer's s8 output, whose pool the int8 stage
    takes in s8; JAX ``ops/wminor.py:322`` ``_lazy_poolable``)."""
    return (lazy_pool_enabled() and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            and (isinstance(x, QTensor) or x.dtype == torch.bfloat16))


def _quads(x: torch.Tensor):
    h, w = x.shape[1] - x.shape[1] % 2, x.shape[2] - x.shape[2] % 2
    x = x[:, :h, :w]
    return x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2], x[:, 1::2, 1::2]


def _pool(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b, c, d = _quads(x)
    pooled = torch.maximum(torch.maximum(a, b), torch.maximum(c, d)).contiguous()
    code = torch.where(
        a == pooled, 0, torch.where(b == pooled, 1, torch.where(c == pooled, 2, 3))
    ).to(torch.int8)
    return pooled, code


def _unpool(values: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    n, h, w, c = values.shape
    out = values.new_zeros((n, 2 * h, 2 * w, c))
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    out[:, 0::2, 0::2] = torch.where(code == 0, values, zero)
    out[:, 0::2, 1::2] = torch.where(code == 1, values, zero)
    out[:, 1::2, 0::2] = torch.where(code == 2, values, zero)
    out[:, 1::2, 1::2] = torch.where(code == 3, values, zero)
    return out


def _gather(g: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    a, b, c, d = _quads(g)
    return torch.where(code == 0, a, torch.where(code == 1, b, torch.where(code == 2, c, d)))


class _MaxPool(torch.autograd.Function):
    """Backward: the cotangent goes to the recorded first-maximum corner of
    each window only (torch's MaxPool2d; the JAX package's custom VJP,
    ops/wminor.py:241-276), zeros at a floor-cropped odd row or column."""

    @staticmethod
    def forward(ctx, x):
        pooled, code = _pool(x)
        ctx.save_for_backward(code)
        ctx.in_shape = x.shape
        ctx.mark_non_differentiable(code)
        return pooled, code

    @staticmethod
    def backward(ctx, g, _):
        (code,) = ctx.saved_tensors
        gx = _unpool(g, code)
        h, w = ctx.in_shape[1:3]
        return F.pad(gx, (0, 0, 0, w - gx.shape[2], 0, h - gx.shape[1]))


class _MaxUnpool(torch.autograd.Function):
    """Backward: gather each window's recorded corner (ops/wminor.py:279-298)."""

    @staticmethod
    def forward(ctx, values, code):
        ctx.save_for_backward(code)
        return _unpool(values, code)

    @staticmethod
    def backward(ctx, g):
        (code,) = ctx.saved_tensors
        return _gather(g, code), None


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def max_pool_2x2(x):
    """``nn.MaxPool2d(2, 2)`` on NHWC (a tensor or a QTensor)."""
    if isinstance(x, QTensor):
        return QTensor(max_pool_2x2(x.q), x.scale, x.dtype)
    if _needs_grad(x):
        return _MaxPool.apply(x)[0]
    a, b, c, d = _quads(x)
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d)).contiguous()


def max_pool_2x2_with_indices(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.MaxPool2d(2, 2, return_indices=True)`` → (pooled, int8 code);
    a QTensor pools to a QTensor."""
    if isinstance(x, QTensor):
        pooled, code = _pool(x.q)
        return QTensor(pooled, x.scale, x.dtype), code
    return _MaxPool.apply(x) if _needs_grad(x) else _pool(x)


def max_unpool_2x2(values: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """``nn.MaxUnpool2d(2, stride=2)`` from :func:`max_pool_2x2_with_indices`
    codes: zeros except at each window's argmax."""
    return _MaxUnpool.apply(values, code) if _needs_grad(values) else _unpool(values, code)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d(1)`` on NHWC: the mean over H and W."""
    return x.mean((1, 2), keepdim=keepdims)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(3, stride=2, padding=1)`` on NHWC (−inf padding; the
    gradient goes to each window's first maximum, as torch's)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()
