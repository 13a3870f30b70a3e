"""Standalone fused self-SPADE stage: CUDA kernel, plain version and mode.

Replaces the TPU kernel ``ssunet_gan_tpu/ops/spade_kernel.py``
``fused_spade_stage`` (:518 → ``_stage_core`` :466 → ``pl.pallas_call``
:474, body ``_stage_kernel`` :447 around ``_spade_tail``). A self-SPADE
stage, as every ss-UNet applies it (``SPADE(y, y)``), is

    seg  = conv3x3(x; K1) + b1
    actv = relu(conv3x3(seg; K2) + b2)
    out  = x·(1 + conv3x3(actv; Kγ) + bγ) + conv3x3(actv; Kβ) + bβ

What bounds it on the H100: about 40 FLOP per byte of x and out at 64
channels, far under the ridge point, so it is bound by bytes. The kernel
(``csrc/spade_stage.cu``) is one launch that reads x and writes out; seg,
actv and γ|β stay in shared memory and registers. Its narrow convs
(3 labels, ≤ 16 hidden channels) run as f32 FMAs.

The f32 route (kernel 9f): the TPU kernel casts its weights to the
activation dtype (:536-546), so an f32 self-SPADE runs it in f32. On the
card that is three launches of kernel 1f's f32 conv core
(``csrc/f32_conv.cuh`` through ``csrc/fused_stage_f32.cu``: 3xTF32 on
``mma.sync``): seg, act with ReLU, and γ|β with the modulate in its
epilogue (``ops/stage_kernel.py`` ``f32_tail_launches``), with no width
limits. Its operands (``pack_spade_f32``: the weights split into TF32 big
and small parts) are kept per weight version (:func:`spade_f32_operands`),
so a step repacks them once after the optimizer updates the weights.

The mode is the JAX package's (``spade_kernel.py:70-95``) and is opt-in
there as here: ``"off"`` is the module composition; ``"fast"`` computes
γ|β as one 1×1 conv over the im2col of the small actv tensor
(:func:`fast_gamma_beta_modulate`, plain PyTorch); ``"pallas"`` — the JAX
package's name for the mode, kept as the key — runs a self-SPADE the gate
admits through :func:`fused_spade_stage`, and everything else as
``"fast"``. Auto (None) is ``"off"``.

:func:`fused_spade_stage` is differentiable: its backward is autograd of
the module composition on the saved inputs, as the JAX package's custom
VJP (``_stage_bwd_rule``) differentiates the plain composition; there is
no backward kernel. It decides by the tensor's device: a CPU tensor takes
:func:`self_spade_reference`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops.conv import conv2d_nhwc
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    TAIL_MAX_HIDDEN,
    TAIL_MAX_LAB,
    _ptr,
    f32_conv,
    f32_tail_launches,
    pack_spade,
    pack_spade_f32,
    spade_tail_reference,
    tail_args,
)

SOURCE = "spade_stage.cu"
REPLACES = "ssunet_gan_tpu/ops/spade_kernel.py:518"  # fused_spade_stage
# the f32 route (kernel 9f) launches kernel 1f's conv core
SOURCE_F32 = stage_kernel.SOURCE_F32

# Fused self-SPADE stages run on the card (one CUDA launch each); f32 ones
# (kernel 9f) apart, one per stage (three f32 conv launches each, counted in
# ``stage_kernel.f32_conv_launches``).
launches = 0
launches_f32 = 0

# the f32 route's packed operands per x2map weight: (the eight weights'
# identities, storages and versions, the operands)
_F32_OPERANDS = WeakIdKeyDictionary()

# the kernel's channel chunk (csrc/stage_common.cuh); its label and hidden
# bounds are the tail's (stage_kernel.TAIL_MAX_*)
CHANNEL_MULTIPLE = 32

_FUSED = None


def set_fused_spade(mode) -> None:
    """Select the SPADE implementation: None (auto → "off"), False/"off",
    True/"fast", or "pallas"."""
    global _FUSED
    if mode not in (None, False, True, "off", "fast", "pallas"):
        raise ValueError(f"unknown fused-SPADE mode {mode!r}")
    _FUSED = mode


def fused_spade_mode() -> str:
    if _FUSED is None or _FUSED is False:
        return "off"
    if _FUSED is True:
        return "fast"
    return _FUSED


def fused_spade_supported(x: torch.Tensor, ks: int, labels: int, hidden: int) -> bool:
    """Whether :func:`fused_spade_stage` takes this self-SPADE: 3×3 convs on
    a 4-D NHWC tensor, labels ≤ 8; on a CUDA device also channels a
    multiple of 32, hidden within the tail's ``TAIL_MAX_HIDDEN`` and
    bfloat16 (the kernel's terms; the plain version on the CPU has none of
    them, and like the JAX gate no hidden term), or float32 for the f32
    route (kernel 9f), which has no width limits. What it refuses runs the
    module's other paths."""
    if ks != 3 or x.dim() != 4:
        return False
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return True
    if labels > TAIL_MAX_LAB:
        return False
    if x.device.type == "cuda":
        return (x.shape[-1] % CHANNEL_MULTIPLE == 0 and hidden <= TAIL_MAX_HIDDEN
                and x.dtype == torch.bfloat16)
    return x.device.type == "cpu"


def self_spade_reference(x, spade_params):
    """The self-SPADE stage in plain PyTorch with the kernel's numerics
    (f32 sums over values rounded to ``x``'s dtype; seg, actv and γ|β
    rounded to it; the modulate in it). ``spade_params``: ``(wx, bx, wm,
    bm, wg, bg, wb, bb)``, OIHW weights."""
    return spade_tail_reference(x, spade_params)[0]


def self_spade_composition(x, wx, bx, wm, bm, wg, bg, wb, bb):
    """The module composition (every conv in the activation dtype): the
    function :func:`fused_spade_stage`'s backward differentiates."""
    seg = conv2d_nhwc(x, wx, bx, 1)
    actv = torch.relu(conv2d_nhwc(seg, wm, bm, 1))
    return x * (1 + conv2d_nhwc(actv, wg, bg, 1)) + conv2d_nhwc(actv, wb, bb, 1)


def im2col_3x3(a: torch.Tensor) -> torch.Tensor:
    """(N, H, W, nh) → (N, H, W, 9·nh): 3×3 neighbourhoods with a zero
    border, tap-major (dy, dx) then channel."""
    h, w = a.shape[1:3]
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    return torch.cat([ap[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)


def fast_gamma_beta_modulate(x, actv, wg, bg, wb, bb):
    """``x·(1 + conv3x3(actv; Kγ) + bγ) + conv3x3(actv; Kβ) + bβ`` with both
    3×3 convs as one 1×1 conv over the im2col of ``actv`` (a contraction of
    9·hidden instead of hidden): the same sums in another order."""
    c = x.shape[-1]
    k = torch.cat([wg.permute(0, 2, 3, 1).reshape(c, -1),
                   wb.permute(0, 2, 3, 1).reshape(c, -1)])[:, :, None, None]
    gb = conv2d_nhwc(im2col_3x3(actv), k, torch.cat([bg, bb]))
    return x * (1 + gb[..., :c]) + gb[..., c:]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_spade_stage.argtypes = [p, i, i, i, i, p, p, i, p, p, i, p, p, p, p]
    lib.ssu_spade_stage.restype = i
    return lib


def spade_f32_operands(spade_params) -> dict:
    """The f32 route's operands of these eight weights
    (``stage_kernel.pack_spade_f32``), kept until one of them changes (its
    object, its storage or its version, as an optimizer's in-place update
    bumps it)."""
    key = tuple((id(t), t.data_ptr(), t._version) for t in spade_params)
    hit = _F32_OPERANDS.get(spade_params[0])
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, pack_spade_f32(spade_params))
        _F32_OPERANDS[spade_params[0]] = hit
    return hit[1]


def _run_cuda(x: torch.Tensor, spade_params) -> torch.Tensor:
    global launches, launches_f32
    lab, nh = spade_params[0].shape[0], spade_params[2].shape[0]
    if not fused_spade_supported(x, spade_params[0].shape[-1], lab, nh):
        raise ValueError(
            f"the CUDA self-SPADE stage does not take x {tuple(x.shape)} {x.dtype}, "
            f"labels={lab} (<= {TAIL_MAX_LAB}), hidden={nh} (<= {TAIL_MAX_HIDDEN}): 3x3 convs, "
            f"channels "
            f"a multiple of {CHANNEL_MULTIPLE}, bfloat16 (or float32 without those limits)")
    if spade_params[0].shape[1] != x.shape[-1]:
        raise ValueError(f"x2map takes {spade_params[0].shape[1]} channels, x has {x.shape[-1]}")
    if any(t.device != x.device for t in spade_params):
        raise ValueError("SPADE weights must lie on x's device")
    x = x.contiguous()
    if x.dtype == torch.float32:  # kernel 9f
        pk = spade_f32_operands(spade_params)
        with torch.cuda.device(x.device):
            out = f32_tail_launches(x, pk, f32_conv)
        launches_f32 += 1
        return out
    n, h, w, c = x.shape
    pk = pack_spade(spade_params, None, x.dtype)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = _lib().ssu_spade_stage(
            x.data_ptr(), n, h, w, c, *tail_args(pk)[:8], out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused self-SPADE stage launch failed: cudaError {err}")
    launches += 1
    return out


class _FusedSpadeStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        if x.device.type == "cpu":
            return self_spade_reference(x, params)
        if x.device.type == "cuda":
            return _run_cuda(x, params)
        raise ValueError(f"fused self-SPADE stage has no path for device {x.device}")

    @staticmethod
    def backward(ctx, g):
        # autograd of the composition on the saved inputs; x enters it as
        # input and as segmap, so its gradient holds both contributions
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = self_spade_composition(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_spade_stage(x, wx, bx, wm, bm, wg, bg, wb, bb) -> torch.Tensor:
    """Self-SPADE stage ``x → x·(1 + γ(x)) + β(x)`` on one NHWC tensor, with
    the module's OIHW weights. Forward: the hand-written kernel on a CUDA
    tensor (an f32 one its f32 route, kernel 9f; or it raises),
    :func:`self_spade_reference` on a CPU tensor.
    Backward: autograd of :func:`self_spade_composition`, for x and all
    eight parameters."""
    return _FusedSpadeStage.apply(x, wx, bx, wm, bm, wg, bg, wb, bb)
