"""Bilinear ×2 upsample with torch's ``align_corners=True`` semantics (NHWC).

The reference decoders use ``nn.Upsample(scale_factor=2, mode='bilinear',
align_corners=True)`` (archs.py:573). Each output row (column) of a linear
resize mixes at most two input rows (columns), with the weights of the
interpolation matrix :func:`_linear_matrix`; :func:`upsample_bilinear`
applies them as a two-tap lerp along H, then along W. Weights are rounded
to the activation dtype and the lerps accumulate in f32, the numerics of
the JAX package's matmul form (ops/resize.py:63-90).

The decoder seams of a bf16 eval forward split the upsample as the JAX
package's lazy form does (``ops/wminor.py:608-621``, ``ops/acts.py``
``UpTensor``): :func:`upsample_w` interpolates the half-height tensor
along W, and the consuming stage kernel interpolates along H while it
loads its window (``csrc/eval_conv.cuh`` read mode 1; in the int8 mode
kernel 7 on the half tensor quantized, ``csrc/int8_conv.cuh`` read mode
1), so the full-resolution tensor is never written; :func:`materialize_up`
is that H-interpolation in plain PyTorch, for every consumer that does not
read the seam. :func:`set_lazy_upsample` is the JAX toggle.

The other families' resizes (the JAX package's ops/resize.py:93-117):
:func:`upsample_bilinear` at any integer scale and either corner mode
(``EffNetUNet``'s decoder: ×2, ``align_corners=False``),
:func:`resize_bilinear`, torch's ``F.interpolate(..., mode='bilinear')``
to any size (AttentiveCNN's input, EffNetUNet's output), both as the same
two-tap lerps, and :func:`upsample_nearest` (``UpConv``).

The SRGAN networks' resizes: :func:`adaptive_avg_pool`, torch's
``nn.AdaptiveAvgPool2d`` as the JAX package's separable averaging
matrices (ops/resize.py:119), and :func:`pixel_shuffle`, torch's
``nn.PixelShuffle`` on NHWC (ops/resize.py:127).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

# Decoder seams read in the eval stage kernels: on unless set to False (JAX
# ``set_lazy_upsample``, ssunet_gan_tpu/ops/wminor.py:444, default on).
_LAZY_UPSAMPLE: Optional[bool] = None


def set_lazy_upsample(enabled: Optional[bool]) -> None:
    """The bf16 eval forwards' decoder seams: read by the consuming fused
    stage (True, or None: the default) or materialized by
    :func:`upsample_bilinear` (False)."""
    global _LAZY_UPSAMPLE
    _LAZY_UPSAMPLE = enabled


def lazy_upsample_enabled() -> bool:
    return _LAZY_UPSAMPLE is None or bool(_LAZY_UPSAMPLE)


@functools.lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear-interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            pos = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            pos = (i + 0.5) * in_size / out_size - 0.5
            pos = min(max(pos, 0.0), in_size - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        frac = pos - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@functools.lru_cache(maxsize=None)
def _two_taps(in_size: int, out_size: int, align_corners: bool):
    """(lo, hi, w_lo, w_hi) per output index: the two nonzero columns of
    :func:`_linear_matrix` and their weights (w_hi = 0 when lo == hi)."""
    m = _linear_matrix(in_size, out_size, align_corners)
    rows = np.arange(out_size)
    lo = np.array([np.flatnonzero(r)[0] for r in m])
    hi = np.array([np.flatnonzero(r)[-1] for r in m])
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], 0.0).astype(np.float32)
    return lo, hi, w_lo, w_hi


def _lerp(x: torch.Tensor, axis: int, wdtype: torch.dtype, out_size: Optional[int] = None,
          align_corners: bool = True) -> torch.Tensor:
    """Linear resize along ``axis`` to ``out_size`` (default ×2) with the
    weights of :func:`_linear_matrix` rounded to ``wdtype``."""
    out_size = 2 * x.shape[axis] if out_size is None else out_size
    lo, hi, w_lo, w_hi = _two_taps(x.shape[axis], out_size, align_corners)
    shape = [1] * x.ndim
    shape[axis] = out_size

    def weights(w):
        return torch.as_tensor(w, device=x.device).to(wdtype).float().reshape(shape)

    ilo = torch.as_tensor(lo, device=x.device)
    ihi = torch.as_tensor(hi, device=x.device)
    return (x.index_select(axis, ilo) * weights(w_lo)
            + x.index_select(axis, ihi) * weights(w_hi))


def upsample_bilinear(x: torch.Tensor, scale: int = 2,
                      align_corners: bool = True) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale, mode='bilinear', align_corners=...)``
    on NHWC (default: the decoders' ×2 with ``align_corners=True``)."""
    if scale != 2 or not align_corners:
        return resize_bilinear(x, scale * x.shape[1], scale * x.shape[2], align_corners)
    dtype = x.dtype
    y = _lerp(_lerp(x.float(), 1, dtype), 2, dtype)
    return y.to(dtype).contiguous()


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(x, (out_h, out_w), mode='bilinear',
    align_corners=...)`` on NHWC: H, then W, each output mixing two input
    rows (columns) with the interpolation weights rounded to the activation
    dtype, summed in f32 and rounded once (the JAX package's two matrix
    products, ops/resize.py:60-90)."""
    dtype = x.dtype
    y = _lerp(x.float(), 1, dtype, out_h, align_corners)
    y = _lerp(y, 2, dtype, out_w, align_corners)
    return y.to(dtype).contiguous()


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale)`` (nearest) on NHWC."""
    return x.repeat_interleave(scale, 1).repeat_interleave(scale, 2)


@functools.lru_cache(maxsize=None)
def _up_rows(hh: int):
    """The 2× H-interpolation of an ``hh``-row tensor as the kernel computes
    it for each full-resolution row p: source rows j0 = ⌊(p−1)/2⌋ and
    j0 + 1 (zero outside the image) with the f32 weights
    w1 = f32(p·(hh−1) − j0·(2hh−1)) / f32(2hh−1) and
    w0 = f32((j0+1)·(2hh−1) − p·(hh−1)) / f32(2hh−1): exact integer
    numerators over one correctly rounded division (JAX ``ops/acts.py``
    ``up_weights_exact``). Returns (j0, w0, w1)."""
    p = np.arange(2 * hh, dtype=np.int64)
    j0 = (p - 1) // 2
    den = np.float32(2 * hh - 1)
    w1 = (p * (hh - 1) - j0 * (2 * hh - 1)).astype(np.float32) / den
    w0 = ((j0 + 1) * (2 * hh - 1) - p * (hh - 1)).astype(np.float32) / den
    return j0, w0, w1


def _rounded(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """f32 tensor of ``a``'s values rounded to ``dtype``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).float()


@functools.lru_cache(maxsize=None)
def up_weights_exact(hh: int) -> bool:
    """Whether :func:`_up_rows`'s weights, rounded to bf16, rebuild the
    rows of :func:`_linear_matrix` rounded to bf16 exactly (and are
    finite): the condition under which the seam's H-interpolation equals
    the matmul form's (JAX ``ops/acts.py:141``); cached per size. Holds
    for every hh from 2 to 1024."""
    if hh < 2:
        return False
    j0, w0, w1 = _up_rows(hh)
    if not (np.isfinite(w0).all() and np.isfinite(w1).all()):
        return False
    rows = torch.arange(2 * hh)
    got = torch.zeros(2 * hh, hh + 2)  # columns 1..hh: the rows j0 + 1 in [0, hh]
    got[rows, torch.from_numpy(j0 + 1)] += _rounded(w0, torch.bfloat16)
    got[rows, torch.from_numpy(j0 + 2)] += _rounded(w1, torch.bfloat16)
    want = _rounded(_linear_matrix(hh, 2 * hh, True), torch.bfloat16)
    return bool(torch.equal(got[:, 1:hh + 1], want))


def lazy_up_ok(x: torch.Tensor) -> bool:
    """Whether the decoder seam of ``x`` (NHWC, before the upsample) takes
    the split form: the mode on, bf16, and an exact half height (JAX
    ``ops/wminor.py`` ``upsample2x``)."""
    return (lazy_upsample_enabled() and isinstance(x, torch.Tensor)
            and x.dtype == torch.bfloat16 and up_weights_exact(x.shape[1]))


def upsample_w(x: torch.Tensor) -> torch.Tensor:
    """The seam's first half: ×2 along W of the half-height tensor, the
    bf16 weights summed in f32 and rounded once (JAX ``ops/wminor.py:615-621``,
    an einsum outside the TPU kernel). NHWC in, (N, H, 2W, C) out."""
    return _lerp(x.float(), 2, x.dtype).to(x.dtype).contiguous()


def materialize_up(half: torch.Tensor) -> torch.Tensor:
    """The seam's second half in plain PyTorch: ×2 along H of
    :func:`upsample_w`'s output with :func:`_up_rows`'s weights rounded to
    its dtype, the two-term lerp in f32, out-of-image rows zero, one
    rounding (JAX ``ops/acts.py:201`` ``materialize_up``, and what the
    kernel's read mode 1 computes). (N, H, W, C) in, (N, 2H, W, C) out."""
    hh = half.shape[1]
    j0, w0, w1 = _up_rows(hh)
    dev = half.device
    x = torch.nn.functional.pad(half.float(), (0, 0, 0, 0, 1, 1))  # rows -1 and hh are zero
    shape = (1, 2 * hh, 1, 1)
    wa = _rounded(w0, half.dtype).to(dev).reshape(shape)
    wb = _rounded(w1, half.dtype).to(dev).reshape(shape)
    ia = torch.from_numpy(j0 + 1).to(dev)
    return (x.index_select(1, ia) * wa + x.index_select(1, ia + 1) * wb).to(half.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix of torch's AdaptiveAvgPool bins:
    bin i covers [floor(i·in/out), ceil((i+1)·in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d((out_h, out_w))`` on NHWC, down or up: the
    averaging weights rounded to the activation dtype, both matrix products
    summed in f32, one rounding at the end (the JAX package's numerics)."""
    _, h, w, _ = x.shape
    rm = _rounded(_adaptive_avg_matrix(h, out_h), x.dtype).to(x.device)
    cm = _rounded(_adaptive_avg_matrix(w, out_w), x.dtype).to(x.device)
    y = torch.einsum("ph,bhwc->bpwc", rm, x.float())
    return torch.einsum("qw,bpwc->bpqc", cm, y).to(x.dtype)


def pixel_shuffle(x: torch.Tensor, upscale: int = 2) -> torch.Tensor:
    """``nn.PixelShuffle(upscale)`` on NHWC: the channels read as torch's
    (C_out, r, r) blocks, each spread over an r×r patch."""
    b, h, w, c = x.shape
    r = upscale
    x = x.reshape(b, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c // (r * r))
