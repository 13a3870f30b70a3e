"""The train kernels in float32: kernels 2-6 of the training-mode fused
stage for a model trained in f32 (``mixed_precision: "False"``), as the
JAX package's Pallas kernels take the activation dtype
(``_conv_stats_call`` ssunet_gan_tpu/ops/stage_kernel_train.py:245,
``_tail_call`` :447, ``_wgrad_w`` :766, ``fused_conv3_call``
ssunet_gan_tpu/ops/train_bwd.py:193, ``fused_wgrad_call`` :392).

The wrappers of ``ops/stage_kernel_train.py`` and ``ops/train_bwd.py``
launch these for CUDA f32 tensors (bf16 ones keep their kernels): the
conv core's launch (:func:`launch_conv3`) and the weight-gradient core's
(:func:`launch_wgrad`) take the bf16 cores' arguments, and
:func:`train_tail` is kernel 3. ``csrc/train_f32.cu`` holds the kernels:
3xTF32 on ``mma.sync`` (each f32 operand split into big = tf32(x) and
small = tf32(x − big), products small·big + big·small + big·big in f32
sums), the convs on the core of ``csrc/f32_conv.cuh`` (shared with kernel
1's f32 route) with each chain mode's prologue run in f32 on segment 0's
window before the split, the weight gradient as a GEMM over the pixels.
The weights change every step, so every call packs and splits them anew
(``ops/stage_kernel.py`` ``pack_f32_conv``); nothing is kept per model.

The plain versions are the modules' own (dtype-generic); the kernels'
arithmetic in plain PyTorch is the ``*_emulated`` functions here (the
plain versions with their products in 3xTF32, :func:`conv_tf32x3` and
:func:`conv_weight_tf32x3`), which the CPU tests hold against the plain
versions and against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops.conv import as_parts
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    _check,
    _ptr,
    f32_conv_emulated,
    pack_f32_conv,
    split_in,
    split_tf32,
)
from ssunet_gan_tpu_torch.ops.stage_kernel_train import (
    _vec,
    conv_stats_reference,
    train_tail_reference,
    wgrad_reference,
)
from ssunet_gan_tpu_torch.ops.train_bwd import fused_conv3_reference, fused_wgrad_reference

SOURCE = "train_f32.cu"

# csrc/f32_conv.cuh F32Mode: the train modes (0 and 1 are the eval route's)
FM_STD, FM_AFF, FM_MODGRAD, FM_PRE, FM_BN2, FM_BN1, FM_RES, FM_SEG, FM_GB = range(2, 11)
# the bf16 conv core's modes (csrc/bwd_core.cuh ConvMode, which ops/train_bwd.py
# passes) as the f32 core's, and where each mode's constants go: (prologue
# constants, epilogue constants) of its ``consts``
_MODES = {0: FM_STD, 1: FM_MODGRAD, 2: FM_PRE, 3: FM_BN2, 4: FM_BN1, 5: FM_AFF}
_CONSTS = {FM_STD: (0, 0), FM_MODGRAD: (0, 0), FM_PRE: (0, 2), FM_BN2: (4, 4),
           FM_BN1: (4, 0), FM_AFF: (2, 0)}

# ssu_train_f32_conv's pointer and integer arguments, by position
_CONV_PTRS = ("seg0", "seg1", "seg2", "weight", "bias", "y", "pro_f",
              *(f"pc{i}" for i in range(4)), *(f"ec{i}" for i in range(4)),
              *(f"band{i}" for i in range(4)), "out0", "out1", "partial", "stats")
_CONV_INTS = ("nseg", "c0", "c1", "c2", "k0", "k1", "k2", "kq", "bn", "n", "h", "w", "cout",
              "split", "relu")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssu_train_f32_blocks.argtypes = [i, i, i, i]
    lib.ssu_train_f32_blocks.restype = ll
    lib.ssu_train_f32_conv.argtypes = [i, p, p, p]
    lib.ssu_train_f32_conv.restype = i
    lib.ssu_train_f32_wgrad.argtypes = [i, p, i, p, i, p, p, p, p, p, i, i, p, i, i, i, p]
    lib.ssu_train_f32_wgrad.restype = i
    return lib


def conv_launch(mode, sources, conv, *, y=None, pro_f=None, pc=(), ec=(), bands=(),
                out_ch=None, rows=0):
    """One launch of the f32 conv core (``ssu_train_f32_conv``) in ``mode``
    (an ``F32Mode``): ``sources`` the segments' tensors (f32 NHWC, one
    N×H×W), ``conv`` their weight as :func:`pack_f32_conv` packs it.
    Returns the outputs (one per ``out_ch`` entry, default one of all
    output channels; with ``y`` the modulate's C) and the ``rows`` stat rows
    (or None); the caller counts the launch."""
    x0 = sources[0]
    n, h, w = x0.shape[:3]
    dev = x0.device
    cout = conv["cout"]
    if tuple(s.shape[-1] for s in sources) != conv["chans"] or len(sources) > 3:
        raise ValueError(f"f32 conv: sources of {[s.shape[-1] for s in sources]} channels "
                         f"for segments of {conv['chans']}")
    out_ch = tuple(out_ch or ((cout // 2,) if y is not None else (cout,)))
    lib = _lib()
    with torch.cuda.device(dev):
        outs = [torch.empty((n, h, w, c), dtype=torch.float32, device=dev) for c in out_ch]
        partial = sums = None
        if rows:
            nb = lib.ssu_train_f32_blocks(cout, n, h, w)
            partial = torch.empty(rows * cout * nb, dtype=torch.float32, device=dev)
            sums = torch.empty((rows, cout), dtype=torch.float32, device=dev)
        ptrs = {f"seg{i}": s for i, s in enumerate(sources)}
        ptrs.update({"weight": conv["wk"], "bias": conv["bk"], "y": y, "pro_f": pro_f,
                     "out0": outs[0], "out1": outs[1] if len(outs) > 1 else None,
                     "partial": partial, "stats": sums})
        ptrs.update({f"pc{i}": _vec(c) for i, c in enumerate(pc)})
        ptrs.update({f"ec{i}": _vec(c) for i, c in enumerate(ec)})
        ptrs.update({f"band{i}": t for i, t in enumerate(bands)})
        ints = {"nseg": len(sources), "kq": conv["kq"], "bn": conv["bn"], "n": n, "h": h, "w": w,
                "cout": cout, "split": out_ch[0], "relu": int(conv["relu"])}
        for i in range(3):
            ints[f"c{i}"] = conv["chans"][i] if i < len(sources) else 0
            ints[f"k{i}"] = conv["ks"][i] if i < len(sources) else 0
        parr = (ctypes.c_void_p * len(_CONV_PTRS))(*(_ptr(ptrs.get(k)) for k in _CONV_PTRS))
        iarr = (ctypes.c_int * len(_CONV_INTS))(*(ints[k] for k in _CONV_INTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.ssu_train_f32_conv(mode, parr, iarr, stream), f"f32 conv core (mode {mode})")
    return outs, sums


def launch_conv3(kmode, sources, segments, pro_f=None, consts=(), bands=(), bias=None,
                 out_ch=None, rows=0):
    """``ops/train_bwd.py`` ``launch_conv3``'s arguments (``kmode`` the bf16
    core's mode) on f32 tensors: the same conv on the f32 core, its weight
    packed and split at this call. Returns (outputs, stat rows or None)."""
    mode = _MODES[kmode]
    npc, nec = _CONSTS[mode]
    return conv_launch(mode, tuple(t for t, _ in sources), pack_f32_conv(segments, bias, False),
                       pro_f=pro_f, pc=consts[:npc], ec=consts[npc:npc + nec], bands=bands,
                       out_ch=out_ch, rows=rows)


def launch_wgrad(gmode, x, g, consts, prologue, cout):
    """``ops/train_bwd.py`` ``launch_wgrad``'s arguments on f32 tensors: dW
    (OIHW, f32) of ``cout`` rows over the input parts ``x`` (≤ 2), the
    cotangent in mode ``gmode`` (0 as it is, 1 [g·y ; g], 2 the BN chain)."""
    channels = [p.shape[-1] for p in x]
    n, h, w = x[0].shape[:3]
    dev = g[0].device
    lib = _lib()
    with torch.cuda.device(dev):
        pa, pb = (None, None) if prologue is None else map(_vec, prologue)
        cvs = [_vec(c) for c in consts]
        carr = (ctypes.c_void_p * 4)(*([c.data_ptr() for c in cvs] + [None] * (4 - len(cvs))))
        # the blocks' f32 sums go into dW (OIHW) with f64 atomics
        dw = torch.zeros((cout, sum(channels), 3, 3), dtype=torch.float64, device=dev)
        x1 = x[1] if len(x) > 1 else None
        _check(lib.ssu_train_f32_wgrad(gmode, x[0].data_ptr(), channels[0], _ptr(x1),
                                       channels[1] if x1 is not None else 0, _ptr(pa), _ptr(pb),
                                       g[0].data_ptr(), _ptr(g[1] if len(g) > 1 else None), carr,
                                       cout, g[0].shape[-1], dw.data_ptr(), n, h, w,
                                       torch.cuda.current_stream(dev).cuda_stream),
               f"f32 weight-gradient core (mode {gmode})")
    return dw.float()


def train_tail(f2, parts, a2, b2, ws, spade_params, head=None):
    """Kernel 3 in f32 (arguments and result as ``ops/stage_kernel_train.py``
    ``train_tail_reference``): y = relu(f2·a2 + b2 + conv1x1(parts; ws)) in
    the residual launch, then seg, act, γ|β with the modulate [and the
    head] as kernel 1's f32 route runs them (with the train modes' flush of
    the tensor cores' sums), their weights packed at this call. Returns
    ``(out, y, seg, actv)``."""
    wx, bx, wm, bm, wg, bg, wb, bb = spade_params
    res = pack_f32_conv(split_in(ws, [p.shape[-1] for p in parts]), None, False)
    (y,), _ = conv_launch(FM_RES, parts, res, bands=(f2,), ec=(a2, b2))
    (seg,), _ = conv_launch(FM_SEG, (y,), pack_f32_conv([wx], bx, False))
    (act,), _ = conv_launch(FM_SEG, (seg,), pack_f32_conv([wm], bm, True))
    gb = pack_f32_conv([torch.cat([wg, wb])], torch.cat([bg, bb]), False, modulate=True)
    (out,), _ = conv_launch(FM_GB, (act,), gb, y=y)
    if head is not None:
        (out,), _ = conv_launch(FM_SEG, (out,), pack_f32_conv([head[0]], head[1], False))
    return out, y, seg, act


# ---------------------------------------------------------------------------
# The kernels' arithmetic in plain PyTorch (3xTF32 products)
# ---------------------------------------------------------------------------


def conv_tf32x3(x, weight, bias=None, padding=0):
    """``ops/conv.py`` ``conv2d_nhwc`` (a 3×3 conv with padding 1, or a
    1×1) with the f32 kernels' products: the taps and the weight split
    into TF32 big and small parts, small·big + big·small + big·big summed in
    f32 (``ops/stage_kernel.py`` ``f32_conv_emulated`` on the weight as
    :func:`pack_f32_conv` packs it), then the bias."""
    parts = as_parts(x)
    k = weight.shape[-1]
    if padding != (k - 1) // 2:
        raise ValueError(f"conv_tf32x3 takes a {k}x{k} conv with padding {(k - 1) // 2}")
    conv = pack_f32_conv(split_in(weight.float(), [p.shape[-1] for p in parts]), bias, False)
    return f32_conv_emulated(tuple(p.float() for p in parts), conv)


def conv_weight_tf32x3(x, weight_size, grad_output, padding=1):
    """``torch.nn.grad.conv2d_weight`` (NCHW) with the weight-gradient
    kernel's products: the input and the cotangent split into TF32 big and
    small parts, small·big + big·small + big·big summed in f32."""
    xb, xs = split_tf32(x)
    gb, gs = split_tf32(grad_output)
    cw = functools.partial(torch.nn.grad.conv2d_weight, weight_size=weight_size, padding=padding)
    return (cw(xs, grad_output=gb) + cw(xb, grad_output=gs)) + cw(xb, grad_output=gb)


def conv_stats_emulated(parts, weight, bias=None, prologue=None, stats=True):
    return conv_stats_reference(parts, weight, bias, prologue, stats, conv=conv_tf32x3)


def train_tail_emulated(f2, parts, a2, b2, ws, spade_params, head=None):
    return train_tail_reference(f2, parts, a2, b2, ws, spade_params, head, conv=conv_tf32x3)


def wgrad_emulated(parts, g, prologue=None):
    return wgrad_reference(parts, g, prologue, conv_weight=conv_weight_tf32x3)


def fused_conv3_emulated(mode, src, weight, side=(), consts=(), bias=None, shortcut=None,
                         out_ch=None):
    return fused_conv3_reference(mode, src, weight, side, consts, bias, shortcut, out_ch,
                                 conv=conv_tf32x3)


def fused_wgrad_emulated(mode, x, g, consts=(), prologue=None):
    return fused_wgrad_reference(mode, x, g, consts, prologue, conv_weight=conv_weight_tf32x3)
