"""Training-mode fused [BasicBlock + self-SPADE] stage: three CUDA kernels,
their plain versions, and the stage's autograd Function.

Replaces the TPU kernels of ``ssunet_gan_tpu/ops/stage_kernel_train.py``
that the v2 analytic backward (``_train_bwd_rule``) runs:

- :func:`conv_stats` ← ``_conv_stats_call`` (:232): ``out = conv3x3(parts;
  W) [+ b]``, an optional prologue ``relu(x·a + b)`` on a single input, and
  the per-channel (Σ, Σx²) of the rounded output. The forward's conv1 and
  conv2, the backward's γ|β recompute and every backward-data conv
  (:func:`conv_transpose`) run on it.
- :func:`train_tail` ← ``_tail_call`` (:435): ``y = relu(f2·a2 + b2 +
  conv1x1(parts; Ws))``, the self-SPADE tail and the optional folded head,
  saving y, seg and actv for the backward.
- :func:`wgrad` ← ``_wgrad_w`` (:766): the f32 weight gradient of a 3×3
  conv, with the optional prologue recomputing conv2's input.

:func:`conv_stats` and :func:`wgrad` run on the Hopper cores of
``csrc/bwd_core.cuh`` (``csrc/train_bwd.cu``, launched through
``ops/train_bwd.py`` ``launch_conv3`` / ``launch_wgrad``): the conv in
spatial tiles with each input value brought into shared memory once per
block through ``cp.async`` and the taps read as shifted ``ldmatrix`` views
(one or two parts as K-segments; the prologue applied once per window
value), the weight gradient as a GEMM over the pixels with f64 sums.
:func:`train_tail` is ``csrc/train_stage.cu``: the residual conv on the
eval conv core of ``csrc/eval_conv.cuh`` (``ops/stage_kernel.py``
``pack_eval_conv`` packs its weight at every call), then the SPADE tail.
What bounds them, and the designs, are in the sources' headers. On the TPU
the shape envelopes of ``_wgrad_w`` and ``_convT_w`` send some products to
XLA (VMEM limits); on the card every such product of the stage goes
through the kernels.

:func:`fused_train_stage` is the stage: forward K1 → stats → K2 with the
BN1 affine+ReLU prologue → stats → K3, returning the output and the two
batch-stat pairs for the running averages. Its backward is the v3 one of
``ops/train_bwd.py`` (the chains inside the kernels of that module) unless
:func:`set_train_bwd_v3` selects the v2 body of ``_train_bwd_rule``
(:969-1110): every conv and 3×3 weight gradient on this module's kernels,
γ|β recomputed from the saved actv, and the pointwise and BN chains, the
1×1 shortcut's and head's products and the bias sums as plain tensor ops,
as the JAX package leaves them to XLA. The rounding points are
the JAX package's: f1, f2, y, seg and actv in the activation dtype, the
stats from sums of the rounded outputs with the one-pass variance
``max(E[x²] − μ², 0)``, the cotangent casts at the same places.

Each wrapper decides by the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel (bf16 only) or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops import collectives
from ssunet_gan_tpu_torch.ops.conv import as_parts, conv2d_nhwc
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    TAIL_MAX_CLS,
    TAIL_MAX_HIDDEN,
    TAIL_MAX_LAB,
    _q,
    _refused,
    conv_args,
    pack_eval_conv,
    pack_spade,
    spade_tail_reference,
    split_in,
    stage_supported,
    tail_args,
)

SOURCE = "train_stage.cu"  # train_tail's; _lib() loads it
# each kernel's source: conv_stats and wgrad run on csrc/bwd_core.cuh's cores
KERNEL_SOURCE = {"conv_stats": "train_bwd.cu", "train_tail": SOURCE, "wgrad": "train_bwd.cu"}
REPLACES = {
    "conv_stats": "ssunet_gan_tpu/ops/stage_kernel_train.py:232",  # _conv_stats_call
    "train_tail": "ssunet_gan_tpu/ops/stage_kernel_train.py:435",  # _tail_call
    "wgrad": "ssunet_gan_tpu/ops/stage_kernel_train.py:766",       # _wgrad_w
}
BN_EPS = 1e-5

# The backward the stage runs: v3 (ops/train_bwd.py, the chains inside the
# kernels) by default, as in the JAX package, or v2 (``_train_bwd``).
_TRAIN_BWD_V3 = True


def set_train_bwd_v3(enabled: bool) -> None:
    """Select the stage's backward: v3 (True, the default) or v2."""
    global _TRAIN_BWD_V3
    _TRAIN_BWD_V3 = bool(enabled)


# The fused train stage: on unless set to False (JAX ``set_fused_train``,
# ssunet_gan_tpu/ops/stage_kernel_train.py:100, whose default is on for one
# TPU; the card's default is on, under a data-parallel step too, whose
# ``train_axis`` carries the stage's sums across the ranks: the JAX package
# takes its composition there unless ``fused_train_dp`` builds a
# ``shard_map`` step, because GSPMD cannot split a Pallas call).
_FUSED_TRAIN: Optional[bool] = None


def set_fused_train(enabled: Optional[bool]) -> None:
    """Fused train stages on (True, or None: the default) or off (False:
    every BasicBlock stage of a training forward runs the module
    composition under autograd)."""
    global _FUSED_TRAIN
    _FUSED_TRAIN = enabled


def fused_train_enabled() -> bool:
    return _FUSED_TRAIN is None or bool(_FUSED_TRAIN)


# Kernel runs on the card, one per wrapper call that launches its kernel
# (train_tail's call is two CUDA launches, conv_stats's with sums two).
launches = {"conv_stats": 0, "train_tail": 0, "wgrad": 0}


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the comparison on the card)
# ---------------------------------------------------------------------------


def _prologued(x: torch.Tensor, prologue) -> torch.Tensor:
    """relu(x·a + b) in f32, rounded to x's dtype (BN1's affine + ReLU)."""
    a, b = prologue
    return torch.relu(x.float() * a.float() + b.float()).to(x.dtype)


def conv_stats_reference(parts, weight, bias=None, prologue=None, stats=True):
    """``out = conv3x3(parts; weight) [+ bias]`` (pad 1, NHWC, OIHW weight)
    with the kernel's numerics: the input optionally ``relu(x·a + b)``
    first (a single part; the zero padding comes after it), weights and
    bias rounded to the activation dtype, f32 sums, ``out`` rounded to it.
    Returns ``(out, sums)`` with ``sums`` (2, C) f32 = (Σ, Σx²) of the
    rounded ``out`` over N, H, W, or None without ``stats``."""
    parts = as_parts(parts)
    dtype = parts[0].dtype
    if prologue is not None:
        if len(parts) != 1:
            raise ValueError("the prologue takes a single input")
        parts = (_prologued(parts[0], prologue),)
    out = conv2d_nhwc(tuple(p.float() for p in parts), _q(weight, dtype),
                      None if bias is None else _q(bias, dtype), 1).to(dtype)
    if not stats:
        return out, None
    of = out.float()
    return out, torch.stack([of.sum((0, 1, 2)), (of * of).sum((0, 1, 2))])


def train_tail_reference(f2, parts, a2, b2, ws, spade_params, head=None):
    """K3 in plain PyTorch: ``y = relu(f2·a2 + b2 + conv1x1(parts; ws))``
    (f32, rounded to the activation dtype), then the self-SPADE tail [+
    head] on y. Returns ``(out, y, seg, actv)``."""
    parts = as_parts(parts)
    dtype = f2.dtype
    sc = conv2d_nhwc(tuple(p.float() for p in parts), _q(ws, dtype))
    y = torch.relu(f2.float() * a2.float() + b2.float() + sc).to(dtype)
    out, seg, act = spade_tail_reference(y, spade_params, head)
    return out, y, seg, act


def wgrad_reference(parts, g, prologue=None):
    """dW (OIHW, f32) of ``g = conv3x3(concat(parts), W)`` (pad 1): the
    inputs (optionally ``relu(x·a + b)``, rounded) and ``g`` in their
    dtype's values, summed in f32."""
    parts = as_parts(parts)
    if prologue is not None:
        if len(parts) != 1:
            raise ValueError("the prologue takes a single input")
        parts = (_prologued(parts[0], prologue),)
    x = torch.cat([p.float() for p in parts], -1).permute(0, 3, 1, 2)
    cout = g.shape[-1]
    return torch.nn.grad.conv2d_weight(x, (cout, x.shape[1], 3, 3),
                                       g.float().permute(0, 3, 1, 2), padding=1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_conv_res.argtypes = [i, p, p, i, p, i, p, p, p, p, i, i, i, i, p]
    lib.ssu_conv_res.restype = i
    lib.ssu_spade_tail_train.argtypes = [p, i, i, i, i, p, p, i, p, p, i, p, p, p,
                                         p, i, p, p, p, p]
    lib.ssu_spade_tail_train.restype = i
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"train stage {what} launch failed: cudaError {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def _check_nhwc(tensors, what: str, max_parts: int = 2) -> Tuple[int, int, int]:
    """(N, H, W) of bf16, contiguous NHWC tensors of one device and size."""
    x0 = tensors[0]
    if len(tensors) > max_parts:
        raise ValueError(f"{what} takes at most {max_parts} parts, got {len(tensors)}")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA {what} takes bfloat16 tensors, got {t.dtype}")
        if t.device != x0.device or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous 4-D NHWC tensors of one device")
        if tuple(t.shape[:3]) != tuple(x0.shape[:3]):
            raise ValueError(f"{what}: N, H or W differ: {[tuple(u.shape) for u in tensors]}")
    return tuple(x0.shape[:3])


def _conv_cuda(parts, weight, bias, prologue, stats):
    _check_nhwc(parts, "conv_stats")
    channels = [p.shape[-1] for p in parts]
    if tuple(weight.shape[1:]) != (sum(channels), 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit parts of {channels}")
    if prologue is not None and len(parts) != 1:
        raise ValueError("the prologue takes a single input")
    from ssunet_gan_tpu_torch.ops import train_bwd  # imports this module

    # one K-segment per part; the prologue's a and b are the core's constants
    kmode = train_bwd.K_STD if prologue is None else train_bwd.K_AFF
    (out,), sums = train_bwd.launch_conv3(kmode, [(p, 3) for p in parts],
                                          split_in(weight, channels),
                                          consts=() if prologue is None else prologue,
                                          bias=bias, rows=2 if stats else 0)
    launches["conv_stats"] += 1
    return out, sums


def _tail_cuda(f2, parts, a2, b2, ws, spade_params, head):
    n, h, w = _check_nhwc((f2,) + parts, "train_tail", max_parts=3)
    channels = [p.shape[-1] for p in parts]
    c = f2.shape[-1]
    if tuple(ws.shape) != (c, sum(channels), 1, 1):
        raise ValueError(f"shortcut {tuple(ws.shape)} does not fit parts of {channels}")
    lab, nh = spade_params[0].shape[0], spade_params[2].shape[0]
    ncls = 0 if head is None else head[0].shape[0]
    if c % 32 or lab > TAIL_MAX_LAB or nh > TAIL_MAX_HIDDEN or ncls > TAIL_MAX_CLS:
        raise ValueError(f"unsupported stage widths: planes={c} (multiple of 32), "
                         f"labels={lab} (<= {TAIL_MAX_LAB}), hidden={nh} "
                         f"(<= {TAIL_MAX_HIDDEN}), classes={ncls} (<= {TAIL_MAX_CLS})")
    dev, dtype = f2.device, f2.dtype
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        conv = pack_eval_conv(split_in(ws.float(), channels), None, dtype)
        a2f, b2f = _vec(a2), _vec(b2)
        y = torch.empty_like(f2)
        nseg, ptrs, chans = conv_args(parts, conv)[:3]  # all 1x1, plain
        _check(lib.ssu_conv_res(nseg, ptrs, chans, conv["nt"], _ptr(conv["w"]),
                                conv["steps"], _ptr(f2), _ptr(a2f), _ptr(b2f), _ptr(y), n, h, w,
                                c, stream), "train tail y")
        pk = pack_spade(spade_params, head, dtype)
        out = torch.empty((n, h, w, ncls or c), dtype=dtype, device=dev)
        seg = torch.empty((n, h, w, lab), dtype=dtype, device=dev)
        act = torch.empty((n, h, w, nh), dtype=dtype, device=dev)
        _check(lib.ssu_spade_tail_train(_ptr(y), n, h, w, c, *tail_args(pk), _ptr(out),
                                        _ptr(seg), _ptr(act), stream),
               "train tail SPADE")
    launches["train_tail"] += 1
    return out, y, seg, act


def _wgrad_cuda(parts, g, prologue):
    _check_nhwc(tuple(parts) + (g,), "wgrad", max_parts=3)
    from ssunet_gan_tpu_torch.ops import train_bwd  # imports this module

    # the weight-gradient core with the cotangent as it is (G_RAW)
    dw = train_bwd.launch_wgrad(0, parts, (g,), (), prologue, g.shape[-1])
    launches["wgrad"] += 1
    return dw


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------


def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no path for device {t.device}")
    return t.device.type


def conv_stats(parts, weight, bias=None, prologue=None, stats=True):
    """Arguments and result as :func:`conv_stats_reference`. CPU tensors run
    the plain version; CUDA tensors run the kernel, or raise."""
    parts = as_parts(parts)
    if _device(parts[0], "conv_stats") == "cpu":
        return conv_stats_reference(parts, weight, bias, prologue, stats)
    return _conv_cuda(parts, weight, bias, prologue, stats)


def conv_transpose(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx of ``y = conv3x3(x; weight)`` (pad 1) for the cotangent ``g`` of
    y: the same conv kernel run on ``g`` with the 180°-rotated, I/O-swapped
    weight (``_convT_w``), packed anew at every call, no sums."""
    return conv_stats((g,), weight.flip(2, 3).transpose(0, 1), stats=False)[0]


def train_tail(f2, parts, a2, b2, ws, spade_params, head=None):
    """Arguments and result as :func:`train_tail_reference`."""
    parts = as_parts(parts)
    if _device(f2, "train_tail") == "cpu":
        return train_tail_reference(f2, parts, a2, b2, ws, spade_params, head)
    return _tail_cuda(f2, parts, a2, b2, ws, spade_params, head)


def wgrad(parts, g, prologue=None):
    """Arguments and result as :func:`wgrad_reference`."""
    parts = as_parts(parts)
    if _device(g, "wgrad") == "cpu":
        return wgrad_reference(parts, g, prologue)
    return _wgrad_cuda(parts, g, prologue)


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------


def _stats_from_sums(sums, count: int):
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0)  # biased
    unbiased = var * (count / max(count - 1, 1))
    return mean, var, unbiased


def _affine(scale, bias, mean, var):
    a = scale * torch.rsqrt(var + BN_EPS)
    return a, bias - mean * a


def _train_fwd(parts, bp, sp, head):
    w1, (g1, be1), w2, (g2, be2), ws = bp
    n, h, w = parts[0].shape[:3]
    # under a data-parallel step the kernels see this rank's slice: the sums
    # cross the ranks between the kernels and count all their pixels (SyncBN)
    count = n * h * w * collectives.axis_size()
    f1, sums1 = conv_stats(parts, w1)
    mean1, var1, uvar1 = _stats_from_sums(collectives.psum_if(sums1), count)
    f2, sums2 = conv_stats((f1,), w2, prologue=_affine(g1, be1, mean1, var1))
    mean2, var2, uvar2 = _stats_from_sums(collectives.psum_if(sums2), count)
    a2, b2 = _affine(g2, be2, mean2, var2)
    out, y, seg, act = train_tail(f2, parts, a2, b2, ws, sp, head)
    saved = (f1, f2, y, seg, act, mean1, var1, mean2, var2)
    return out, ((mean1, uvar1), (mean2, uvar2)), saved


def _train_bwd(parts, bp, sp, head, saved, g_out, want_parts: bool):
    """``_train_bwd_rule``'s v2 body (ssunet_gan_tpu/ops/stage_kernel_train.py
    :969-1110) over NHWC tensors. Returns (part grads or None, block grads,
    SPADE grads, head grads or None)."""
    f1, f2, y, seg, act, mean1, var1, mean2, var2 = saved
    w1, (g1, be1), w2, (g2, be2), ws = bp
    wx, bx, wm, bm, wg, bg, wb, bb = sp
    dtype = f1.dtype
    c = w2.shape[0]
    n, h, w = f1.shape[:3]
    count = n * h * w * collectives.axis_size()  # global under a data-parallel step
    csum = sum(p.shape[-1] for p in parts)
    px = (0, 1, 2)

    # γ|β recompute (one nh → 2C conv with bias; the forward saved actv)
    wgb, bgb = torch.cat([wg, wb]), torch.cat([bg, bb])
    gb, _ = conv_stats((act,), wgb, bias=bgb, stats=False)
    gamma, beta = gb[..., :c], gb[..., c:]

    # folded head: out = conv1x1(out0; wf) + bf
    g_head = None
    if head is not None:
        wf, bf = head
        ncls = wf.shape[0]
        out0 = y * (1 + gamma) + beta
        go = g_out.reshape(-1, ncls)
        g_wf = (go.float().t() @ out0.reshape(-1, c).float()).reshape(ncls, c, 1, 1)
        g_head = (g_wf, go.float().sum(0))
        g_out0 = (go @ wf[:, :, 0, 0].to(dtype)).reshape(n, h, w, c)
    else:
        g_out0 = g_out

    # SPADE modulate: out0 = y·(1+γ) + β
    gf = g_out0.float()
    g_y = gf * (1.0 + gamma.float())
    g_gamma = (gf * y.float()).to(dtype)
    g_beta = g_out0.to(dtype)

    # γ|β convs: one backward-data conv to actv, one weight gradient
    g_gb = torch.cat([g_gamma, g_beta], -1)
    g_act = conv_transpose(g_gb, wgb)
    g_wgb = wgrad((act,), g_gb)
    g_bg, g_bb = g_gamma.float().sum(px), g_beta.float().sum(px)

    # mlp_shared conv + ReLU (actv = relu(conv(seg)))
    g_pre2s = torch.where(act > 0, g_act, 0).to(dtype)
    g_seg = conv_transpose(g_pre2s, wm).to(dtype)
    g_wm = wgrad((seg,), g_pre2s)
    g_bm = g_pre2s.float().sum(px)

    # x2map conv (seg = conv(y))
    g_y = g_y + conv_transpose(g_seg, wx).float()
    g_wx = wgrad((y,), g_seg)
    g_bx = g_seg.float().sum(px)

    # block ReLU: y = relu(bn2(f2) + shortcut)
    g_pre = torch.where(y > 0, g_y, 0.0)

    # 1×1 shortcut: plain products, as the JAX package's einsums
    g_pre_d = g_pre.to(dtype).reshape(-1, c)
    xcat = (parts[0] if len(parts) == 1 else torch.cat(parts, -1)).reshape(-1, csum)
    g_ws = (g_pre_d.float().t() @ xcat.float()).reshape(c, csum, 1, 1)

    # bn2 with the batch-stat terms
    r2 = torch.rsqrt(var2 + BN_EPS)
    xhat2 = (f2.float() - mean2) * r2
    s_g2, s_gx2 = g_pre.sum(px), (g_pre * xhat2).sum(px)
    # the parameter gradients stay this rank's partial sums (the step
    # averages them); the input gradient's batch-stat terms take the global
    # sums, the transpose of the forward's
    t_g2, t_gx2 = collectives.psum_if(torch.stack([s_g2, s_gx2]))
    g_f2 = ((g2 * r2) * (g_pre - t_g2 / count - xhat2 * (t_gx2 / count))).to(dtype)

    # conv2: backward-data, and the weight gradient on h1r recomputed from f1
    a1, b1 = _affine(g1, be1, mean1, var1)
    g_h1r = conv_transpose(g_f2, w2)
    g_w2 = wgrad((f1,), g_f2, prologue=(a1, b1))

    # bn1 + ReLU (h1r = relu(bn1(f1)))
    r1 = torch.rsqrt(var1 + BN_EPS)
    xhat1 = (f1.float() - mean1) * r1
    g_n1 = torch.where(xhat1 * g1 + be1 > 0, g_h1r.float(), 0.0)
    s_g1, s_gx1 = g_n1.sum(px), (g_n1 * xhat1).sum(px)
    t_g1, t_gx1 = collectives.psum_if(torch.stack([s_g1, s_gx1]))
    g_f1 = ((g1 * r1) * (g_n1 - t_g1 / count - xhat1 * (t_gx1 / count))).to(dtype)

    # conv1
    g_w1 = wgrad(parts, g_f1)
    g_parts = None
    if want_parts:
        g_xcat = ((g_pre_d @ ws[:, :, 0, 0].to(dtype)).float().reshape(n, h, w, csum)
                  + conv_transpose(g_f1, w1).float())
        g_parts, off = [], 0
        for p in parts:
            cp = p.shape[-1]
            g_parts.append(g_xcat[..., off:off + cp].to(p.dtype))
            off += cp
    g_bp = (g_w1, (s_gx1, s_g1), g_w2, (s_gx2, s_g2), g_ws)
    g_sp = (g_wx, g_bx, g_wm, g_bm, g_wgb[:c], g_bg, g_wgb[c:], g_bb)
    return g_parts, g_bp, g_sp, g_head


class _FusedTrainStage(torch.autograd.Function):
    """Tensors in: parts, w1, γ1, β1, w2, γ2, β2, ws, the eight SPADE
    tensors, [wf, bf]. Out: the stage output and (μ1, uσ1², μ2, uσ2²)."""

    @staticmethod
    def forward(ctx, n_parts: int, has_head: bool, *tensors):
        parts, bp, sp, head = _unflatten(n_parts, has_head, tensors)
        out, ((m1, u1), (m2, u2)), saved = _train_fwd(parts, bp, sp, head)
        ctx.n_parts, ctx.has_head = n_parts, has_head
        ctx.save_for_backward(*tensors, *saved)
        ctx.mark_non_differentiable(m1, u1, m2, u2)
        return out, m1, u1, m2, u2

    @staticmethod
    def backward(ctx, g_out, *unused):
        n_in = len(ctx.saved_tensors) - 9
        tensors, saved = ctx.saved_tensors[:n_in], ctx.saved_tensors[n_in:]
        parts, bp, sp, head = _unflatten(ctx.n_parts, ctx.has_head, tensors)
        want_parts = any(ctx.needs_input_grad[2:2 + ctx.n_parts])
        from ssunet_gan_tpu_torch.ops import train_bwd  # imports this module

        bwd = _train_bwd
        if _TRAIN_BWD_V3 and train_bwd.bwd_v3_supported([p.shape[-1] for p in parts],
                                                        bp[2].shape[0]):
            bwd = train_bwd.train_bwd_v3
        g_parts, g_bp, g_sp, g_head = bwd(parts, bp, sp, head, saved, g_out.contiguous(),
                                          want_parts)
        g_w1, (g_g1, g_be1), g_w2, (g_g2, g_be2), g_ws = g_bp
        grads = (list(g_parts or [None] * ctx.n_parts)
                 + [g_w1, g_g1, g_be1, g_w2, g_g2, g_be2, g_ws, *g_sp]
                 + (list(g_head) if g_head is not None else []))
        return (None, None, *grads)


def _unflatten(n_parts: int, has_head: bool, tensors):
    parts = tuple(tensors[:n_parts])
    w1, g1, be1, w2, g2, be2, ws = tensors[n_parts:n_parts + 7]
    sp = tuple(tensors[n_parts + 7:n_parts + 15])
    head = tuple(tensors[n_parts + 15:n_parts + 17]) if has_head else None
    return parts, (w1, (g1, be1), w2, (g2, be2), ws), sp, head


def fused_train_stage(parts, block_params, spade_params, head=None):
    """Training-mode fused stage. Returns ``(out, ((μ1, uσ1²), (μ2,
    uσ2²)))``: the stage output (the logits when ``head`` folds the final
    1×1 conv) and the batch mean and unbiased variance of f1 and f2 for the
    BatchNorms' running averages (no gradient flows through them).

    ``block_params`` = ``(w1, (γ1, β1), w2, (γ2, β2), ws)``, the raw
    parameters of :meth:`BasicBlock.train_params` (the shortcut ``ws`` must
    exist); ``spade_params`` as :meth:`SPADE.stage_params`; ``head`` =
    ``(wf, bf)`` or None. Gradients flow to every part and parameter. On
    the card it raises for what :func:`ops.stage_kernel.stage_supported`
    refuses."""
    parts = tuple(p.contiguous() for p in as_parts(parts))
    w1, (g1, be1), w2, (g2, be2), ws = block_params
    if ws is None:
        raise ValueError("the fused train stage needs the block's shortcut conv")
    if _device(parts[0], "fused_train_stage") == "cuda":
        widths = (w2.shape[0], spade_params[0].shape[0], spade_params[2].shape[0],
                  0 if head is None else head[0].shape[0])
        if not stage_supported(parts, *widths, train=True):
            raise _refused(parts, *widths, train=True)
    tensors = (*parts, w1, g1, be1, w2, g2, be2, ws, *spade_params,
               *(() if head is None else head))
    out, m1, u1, m2, u2 = _FusedTrainStage.apply(len(parts), head is not None, *tensors)
    return out, ((m1, u1), (m2, u2))
