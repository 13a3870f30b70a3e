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
:func:`train_tail` is kernel 3. The products run as 3xTF32 (each f32
operand split into big = tf32(x) and small = tf32(x − big), products
small·big + big·small + big·big in f32 sums). ``csrc/train_f32.cu`` holds
the convs, each chain mode's prologue run in f32 on segment 0's window
before the split, on one of two cores by the kernel's own launch plan
(:func:`conv_plan` asks for it): the wide modes (conv1 / conv2 of kernel 2,
κ1, κ3, κ6, κ7 of kernel 5 at more than 16 output channels) on ``wgmma``
(``csrc/f32_wgmma_conv.cuh``), the rest on ``mma.sync``
(``csrc/f32_conv.cuh``, shared with kernel 1's f32 route); the
weights change every step, so every call packs and splits them anew
(``ops/stage_kernel.py`` ``pack_f32_conv``); nothing is kept per model.
``csrc/wgrad_f32.cu`` holds the weight gradient, a GEMM over the pixels on
``wgmma``: a pre-pass (:func:`wgrad_prep`) runs the cotangent's chain and
split once per value into planes laid out as the product
(:func:`wgrad_product`) reads them, on the launch plan of
:func:`wgrad_plan`.

The plain versions are the modules' own (dtype-generic); the kernels'
arithmetic in plain PyTorch is the ``*_emulated`` functions here (the
plain versions with their products in 3xTF32, :func:`conv_tf32x3` and
:func:`conv_weight_tf32x3`), which the CPU tests hold against the plain
versions and against the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

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
    _prologued,
    _vec,
    conv_stats_reference,
    train_tail_reference,
    wgrad_reference,
)
from ssunet_gan_tpu_torch.ops.train_bwd import fused_conv3_reference, fused_wgrad_reference

SOURCE = "train_f32.cu"
WGMMA_HEADER = "f32_wgmma_conv.cuh"  # the wide convs' kernel, built into SOURCE
WGRAD_SOURCE = "wgrad_f32.cu"  # kernels 4 and 6 in f32
# Kernel runs on the card: the weight gradient's pre-pass (its products count
# as the callers' wgrad and fused_wgrad launches), and the conv launches that
# the kernel's plan routes to the wgmma kernel (counted also as the callers'
# conv_stats and fused_conv3 launches)
launches = {"wgrad_prep": 0, "wgmma_conv": 0}

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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_train_f32_conv.argtypes = [i, p, p, p]
    lib.ssu_train_f32_conv.restype = i
    lib.ssu_train_f32_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.ssu_train_f32_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def conv_plan(mode: int, cout: int, n: int, h: int, w: int) -> tuple[bool, int]:
    """The kernel's launch plan (``csrc/train_f32.cu`` ``conv_plan``) for a
    conv of ``cout`` columns in ``mode`` over n images of h × w: (whether
    the wgmma kernel runs it, its blocks along the pixels, the columns of the
    stat rows' per-block partial sums)."""
    blocks = ctypes.c_longlong()
    wide = _lib().ssu_train_f32_plan(mode, cout, n, h, w, ctypes.byref(blocks))
    return bool(wide), blocks.value


def conv_launch(mode, sources, conv, *, y=None, pro_f=None, pc=(), ec=(), bands=(),
                out_ch=None, rows=0):
    """One launch of the f32 conv core (``ssu_train_f32_conv``) in ``mode``
    (an ``F32Mode``): ``sources`` the segments' tensors (f32 NHWC, one
    N×H×W), ``conv`` their weight as :func:`pack_f32_conv` packs it.
    Returns the outputs (one per ``out_ch`` entry, default one of all
    output channels; with ``y`` the modulate's C) and the ``rows`` stat rows
    (or None); the caller counts the launch, :data:`launches` its route to
    the wgmma kernel."""
    x0 = sources[0]
    n, h, w = x0.shape[:3]
    dev = x0.device
    cout = conv["cout"]
    if tuple(s.shape[-1] for s in sources) != conv["chans"] or len(sources) > 3:
        raise ValueError(f"f32 conv: sources of {[s.shape[-1] for s in sources]} channels "
                         f"for segments of {conv['chans']}")
    out_ch = tuple(out_ch or ((cout // 2,) if y is not None else (cout,)))
    wide, blocks = conv_plan(mode, cout, n, h, w)
    lib = _lib()
    with torch.cuda.device(dev):
        outs = [torch.empty((n, h, w, c), dtype=torch.float32, device=dev) for c in out_ch]
        partial = sums = None
        if rows:
            partial = torch.empty(rows * cout * blocks, dtype=torch.float32, device=dev)
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
    if wide:
        launches["wgmma_conv"] += 1
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
    (OIHW, f32) of ``cout`` rows over the input parts ``x`` (≤ 2; the
    ``prologue`` relu(x·a + b) on a single one), the cotangent in mode
    ``gmode`` (0 as it is, 1 [g·y ; g], 2 the BN chain): the pre-pass
    (:func:`wgrad_prep`) and the product (:func:`wgrad_product`) of one
    :func:`wgrad_plan`."""
    n, h, w = x[0].shape[:3]
    plan = wgrad_plan(tuple(p.shape[-1] for p in x), cout, n, h, w)
    planes, x = wgrad_prep(gmode, g, consts, cout, plan, x, prologue)
    return wgrad_product(x, planes, cout, plan)


# ---------------------------------------------------------------------------
# The weight gradient (csrc/wgrad_f32.cu): the launch plan, the pre-pass and
# the product, each with its plain version
# ---------------------------------------------------------------------------

WG_TH, WG_TW = 4, 16  # the pixel tile (csrc/wgrad_f32.cu WG_TH, WG_TW)
WG_TP = WG_TH * WG_TW
WG_RING = 4  # the ring's slots: a window and a B tile each (csrc/wgrad_f32.cu)


def wg_xfloats(nb: int) -> int:
    """Window rows × row stride that a slot holds (csrc ``wg_xfloats``)."""
    return 4 * 72 if nb == 64 else (WG_TH + 2) * 72


def wg_slot_bytes(nb: int) -> int:
    """A ring slot's bytes: its window and its B tile (csrc ``wg_slot_bytes``)."""
    return (WG_TW + 2) * wg_xfloats(nb) * 4 + nb * WG_TP * 8


SMS = 132  # the H100's SMs; the product keeps one block on each
# ssu_wgrad_f32_prep's and ssu_wgrad_f32's plan integers, by position
# (csrc/wgrad_f32.cu L_*)
_PLAN_INTS = ("cc", "xs", "nb", "mt", "nrb", "nblk", "coutp", "tiles_h", "tiles_w", "ntiles",
              "tiles_per_split", "splits")
WgradPlan = collections.namedtuple("WgradPlan", _PLAN_INTS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def wgrad_plan(channels: tuple, cout: int, n: int, h: int, w: int) -> WgradPlan:
    """The product's launch (``csrc/wgrad_f32.cu`` wgrad_f32_kernel): input
    chunks of ``cc`` channels (64, or the narrow parts' width as a power of
    two from 4) whose (tap, channel) rows fall in row blocks of 3·``mt`` m64
    tiles, N blocks of ``nb`` dW rows (``coutp`` padded): past 32 rows, 64
    over one tap row of 64 channels (``mt`` 1), else 8–32 over all nine taps
    (``mt`` 3); ``ntiles`` pixel tiles of WG_TH × WG_TW split into
    ``splits`` runs of ``tiles_per_split``, as many as fill the SMs in whole
    waves. ``xs`` is the window's row stride (8 floats of padding from 16
    channels: the A reads' lanes fall on distinct banks)."""
    widest = max(channels)
    cc = 64 if widest > 32 else max(4, 1 << (widest - 1).bit_length())
    xs = cc + 8 if cc >= 16 else cc
    nb = 8 if cout <= 8 else 16 if cout <= 16 else 32 if cout <= 32 else 64
    mt = 1 if nb == 64 else 3
    nrb = _cdiv(9 * cc, 64 * 3 * mt)
    nblk = _cdiv(cout, nb)
    tiles_h, tiles_w = _cdiv(h, WG_TH), _cdiv(w, WG_TW)
    ntiles = n * tiles_h * tiles_w
    base = sum(_cdiv(c, cc) for c in channels) * nrb * nblk

    def cost(s):  # whole waves of one block per SM, each its tiles plus two
        return _cdiv(base * s, SMS) * (_cdiv(ntiles, s) + 2)

    splits = min((min(ntiles, _cdiv(SMS * k, base)) for k in range(1, 17)), key=cost)
    tps = _cdiv(ntiles, splits)
    return WgradPlan(cc, xs, nb, mt, nrb, nblk, nblk * nb, tiles_h, tiles_w, ntiles, tps,
                     _cdiv(ntiles, tps))


@functools.lru_cache(maxsize=None)
def _wgrad_lib() -> ctypes.CDLL:
    lib = _build.load(WGRAD_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_wgrad_f32_prep.argtypes = [i, p, p, p, i, i, p, i, i, p, p, i, p, p, p,
                                       ctypes.c_longlong, p]
    lib.ssu_wgrad_f32_prep.restype = i
    lib.ssu_wgrad_f32.argtypes = [p, i, p, i, p, i, p, i, i, i, p, p]
    lib.ssu_wgrad_f32.restype = i
    return lib


def _plan_ints(plan: WgradPlan):
    return (ctypes.c_int * len(_PLAN_INTS))(*plan)


def wgrad_prep(gmode, g, consts, cout, plan, x, prologue=None):
    """The pre-pass: the cotangent of mode ``gmode`` from ``g`` (one or two
    NHWC f32 tensors) and ``consts``, split into TF32 big and small parts,
    in the planes' layout (:func:`wgrad_prep_reference`); with a
    ``prologue``, also the single input part through relu(x·a + b). Returns
    (planes, the product's input parts). On the card one launch of
    ``wgrad_prep_kernel``, counted in :data:`launches`; CPU tensors take the
    plain version."""
    if g[0].device.type == "cpu":
        return wgrad_prep_reference(gmode, g, consts, cout, plan, x, prologue)
    n, h, w, c_g = g[0].shape
    dev = g[0].device
    lib = _wgrad_lib()
    with torch.cuda.device(dev):
        cvs = [_vec(c) for c in consts]
        carr = (ctypes.c_void_p * 4)(*([c.data_ptr() for c in cvs] + [None] * (4 - len(cvs))))
        planes = torch.empty(plan.ntiles * plan.coutp * WG_TP * 2, dtype=torch.float32,
                             device=dev)
        pa = pb = xout = None
        if prologue is not None:
            if len(x) != 1:
                raise ValueError("the prologue takes a single input")
            pa, pb = map(_vec, prologue)
            xout = torch.empty_like(x[0])
        _check(lib.ssu_wgrad_f32_prep(gmode, g[0].data_ptr(), _ptr(g[1] if len(g) > 1 else None),
                                      carr, cout, c_g, planes.data_ptr(), h, w, _plan_ints(plan),
                                      _ptr(x[0] if xout is not None else None), x[0].shape[-1],
                                      _ptr(pa), _ptr(pb), _ptr(xout), n * h * w,
                                      torch.cuda.current_stream(dev).cuda_stream),
               f"f32 weight-gradient pre-pass (mode {gmode})")
    launches["wgrad_prep"] += 1
    return planes, (tuple(x) if xout is None else (xout,))


def wgrad_product(x, planes, cout, plan):
    """The product: dW (OIHW, f32) over the input parts ``x`` (≤ 2) and the
    pre-pass's ``planes``. On the card one launch of ``wgrad_f32_kernel``
    (3xTF32 on wgmma, the blocks' f32 sums into dW with f64 atomics; the
    caller counts it); CPU tensors take the plain version."""
    if x[0].device.type == "cpu":
        return wgrad_product_reference(x, planes, cout, plan)
    channels = [p.shape[-1] for p in x]
    n, h, w = x[0].shape[:3]
    dev = x[0].device
    lib = _wgrad_lib()
    with torch.cuda.device(dev):
        dw = torch.zeros((cout, sum(channels), 3, 3), dtype=torch.float64, device=dev)
        x1 = x[1] if len(x) > 1 else None
        _check(lib.ssu_wgrad_f32(x[0].data_ptr(), channels[0], _ptr(x1),
                                 channels[1] if x1 is not None else 0, planes.data_ptr(), cout,
                                 dw.data_ptr(), n, h, w, _plan_ints(plan),
                                 torch.cuda.current_stream(dev).cuda_stream),
               "f32 weight-gradient product")
    return dw.float()


def wgrad_cotangent(gmode, g, consts):
    """The pre-pass's chain in plain PyTorch, per dW row as the kernel runs
    it (each operation rounded in f32): ``g``; [g·y ; g]; or p·((g − q) −
    (f·r′ − m′))."""
    g0 = g[0].float()
    if gmode == 0:
        return g0
    if gmode == 1:
        return torch.cat([g0 * g[1].float(), g0], -1)
    p, q, r, m = (c.float() for c in consts)
    return p * ((g0 - q) - (g[1].float() * r - m))


def _tiled(t, plan):
    """NHWC ``t`` [.., cout] zero-padded to whole tiles and ``coutp`` and
    laid out as the planes: [tile][N block][nb / 8][WG_TP / 4][8][4]."""
    n, h, w, c = t.shape
    t = F.pad(t, (0, plan.coutp - c, 0, plan.tiles_w * WG_TW - w, 0, plan.tiles_h * WG_TH - h))
    t = t.reshape(n, plan.tiles_h, WG_TH, plan.tiles_w, WG_TW // 4, 4, plan.nblk, plan.nb // 8, 8)
    # -> n, tiles_h, tiles_w, N block, row group, tile row, pixel quad, row, pixel
    return t.permute(0, 1, 3, 6, 7, 2, 4, 8, 5)


def wgrad_prep_reference(gmode, g, consts, cout, plan, x, prologue=None):
    """The pre-pass in plain PyTorch: :func:`wgrad_cotangent` split into
    TF32 big and small parts (``ops/stage_kernel.py`` ``split_tf32``), zero
    outside the image and past ``cout``, flat in the kernel's layout
    [tile][N block][big | small][nb / 8][WG_TP / 4][8 rows][4 pixels]; and
    the input parts, the single one through the ``prologue``."""
    big, small = split_tf32(wgrad_cotangent(gmode, g, consts))
    planes = torch.stack([_tiled(big, plan), _tiled(small, plan)], 4).reshape(-1)
    parts = as_parts(x)
    if prologue is not None:
        if len(parts) != 1:
            raise ValueError("the prologue takes a single input")
        parts = (_prologued(parts[0].float(), prologue),)
    return planes, tuple(p.float() for p in parts)


def wgrad_planes(planes, plan, n, h, w, cout):
    """The pre-pass's planes back to NHWC (big, small), [n, h, w, cout]
    each."""
    t = planes.reshape(n, plan.tiles_h, plan.tiles_w, plan.nblk, 2, plan.nb // 8, WG_TH,
                       WG_TW // 4, 8, 4)
    t = t.permute(4, 0, 1, 6, 2, 7, 9, 3, 5, 8).reshape(
        2, n, plan.tiles_h * WG_TH, plan.tiles_w * WG_TW, plan.coutp)
    return t[0, :, :h, :w, :cout], t[1, :, :h, :w, :cout]


def wgrad_product_reference(x, planes, cout, plan):
    """The product in plain PyTorch: the input parts split into TF32 big and
    small parts, the planes' cotangent parts, small·big + big·small +
    big·big summed in f32 (``torch.nn.grad.conv2d_weight``)."""
    xt = torch.cat([p.float() for p in as_parts(x)], -1).permute(0, 3, 1, 2)
    n, _, h, w = xt.shape
    gb, gs = (t.permute(0, 3, 1, 2) for t in wgrad_planes(planes, plan, n, h, w, cout))
    xb, xs = split_tf32(xt)
    cw = functools.partial(torch.nn.grad.conv2d_weight, weight_size=(cout, xt.shape[1], 3, 3),
                           padding=1)
    return (cw(xs, grad_output=gb) + cw(xb, grad_output=gs)) + cw(xb, grad_output=gb)


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
