"""The v3 backward of the training-mode fused stage: the pointwise and BN
chains inside the backward-data and weight-gradient kernels.

Replaces the TPU kernels of ``ssunet_gan_tpu/ops/train_bwd.py``:

- :func:`fused_conv3` ← ``fused_conv3_call`` (:167, body
  ``_make_fused_kernel`` :60): ``out = epilogue(conv3x3(prologue(src)))``
  with up to four per-channel stat rows.
- :func:`fused_wgrad` ← ``fused_wgrad_call`` (:374, body
  ``_make_wgrad_fused_kernel`` :291): the f32 weight gradient of a 3×3 conv
  whose input (x side) and cotangent (g side) are rebuilt from saved tensors
  inside the kernel.

The TPU kernels take Python callables for their prologue and epilogue; the
port names a fixed list of chain modes instead, shared by the plain version
and the CUDA kernel (``csrc/train_bwd.cu``). Conv modes (``src`` feeds the
conv, ``side`` bands sit beside the output, constants are per-channel f32
``(C,)`` vectors; "round" is a rounding to the activation dtype):

=========  ==================  ==============================================  =====
mode       src                 epilogue, output                                stats
=========  ==================  ==============================================  =====
gamma      actv                round(conv + bias)  (γ, or γ|β with a head)     —
modgrad    g0, y               where(actv > 0, round(out), 0);  input          Σ
                               [round(g0·y) ; g0]
seg        g_pre2s             round(out)                                      Σ
pre        g_seg               gp = where(y > 0, g0·(1+γ) + round(out));       Σgp, Σgp·x̂₂,
                               out round(gp); side (g0, γ, y, f2)              Σg0·y, Σg0
bn2        g_pre, f2           input round(p·(g − q − (f·r′ − m′)));           Σgn, Σgn·x̂₁
                               gn = where(f1·a₁ + b₁ > 0, round(out), 0)
bn1        g_n1, f1            input as bn2; round(round(out) + ksᵀ·g_pre),    —
                               written per part; side (g_pre,)
=========  ==================  ==============================================  =====

Weight-gradient modes (x side with the halo; g side output-aligned):
``gb`` (actv; [round(g0·y) ; g0]), ``mlp`` (seg; g_pre2s), ``x2map`` (y;
g_seg), ``conv2`` (relu(f1·a₁ + b₁); the bn2 input chain from g_pre, f2),
``conv1`` (the parts; the bn1 input chain from g_n1, f1).

:func:`train_bwd_v3` is ``train_bwd_v3`` (:486-777) over NHWC tensors: the
rounding points are the JAX package's, which differ from v2's (``g_pre`` is
stored rounded and the BN2 backward is built from the rounded value; the γ
and β bias gradients sum unrounded f32 products; x̂ enters as ``f·r − μ·r``).
The head's products and the shortcut's weight gradient stay plain tensor
ops, as the JAX package leaves them to XLA.

:func:`launch_conv3` and :func:`launch_wgrad` launch the two cores
(``csrc/bwd_core.cuh``); ``ops/stage_kernel_train.py``'s ``conv_stats``
(kernel modes ``K_STD`` and ``K_AFF``) and ``wgrad`` (the cotangent as it
is) run on them too, counted under their own names.

Each wrapper decides by the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel (bf16 only) or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops import collectives
from ssunet_gan_tpu_torch.ops.conv import as_parts, conv2d_nhwc
from ssunet_gan_tpu_torch.ops.stage_kernel import _q, eval_chunk, split_in
from ssunet_gan_tpu_torch.ops.stage_kernel_train import (
    BN_EPS,
    _check,
    _check_nhwc,
    _device,
    _ptr,
    _vec,
    wgrad_reference,
)

SOURCE = "train_bwd.cu"
REPLACES = {
    "fused_conv3": "ssunet_gan_tpu/ops/train_bwd.py:167",  # fused_conv3_call
    "fused_wgrad": "ssunet_gan_tpu/ops/train_bwd.py:374",  # fused_wgrad_call
}

# Kernel runs on the card, one per wrapper call that launches its kernel
# (a fused_conv3 call with stat rows is two CUDA launches).
launches = {"fused_conv3": 0, "fused_wgrad": 0}

# csrc/bwd_core.cuh ConvMode of conv_stats (ops/stage_kernel_train.py),
# which runs on the same core: a plain conv of one or two parts, and one
# with the prologue relu(x·a + b)
K_STD, K_AFF = 0, 5

# mode: (kernel mode, conv sources, side bands, constants, stat rows)
CONV_MODES = {
    "gamma": (0, 1, 0, 0, 0),
    "modgrad": (1, 2, 1, 0, 1),
    "seg": (0, 1, 0, 0, 1),  # the plain conv's (Σ, Σx²) rows, Σ kept
    "pre": (2, 1, 4, 2, 4),
    "bn2": (3, 2, 1, 8, 2),
    "bn1": (4, 2, 1, 4, 0),
}
# the kernel modes whose sources have the stage's planes, in 32-channel chunks
_K_CHAIN = {CONV_MODES[m][0] for m in ("modgrad", "bn2", "bn1")}
# mode: (g-side kernel mode, g tensors, constants)
WGRAD_MODES = {
    "gb": (1, 2, 0),
    "mlp": (0, 1, 0),
    "x2map": (0, 1, 0),
    "conv2": (2, 2, 4),
    "conv1": (2, 2, 4),
}
_PX = (0, 1, 2)


def _check_mode(table, mode, counts) -> None:
    """``counts``: the (tensors, [side bands,] constants) a call passes."""
    if mode not in table:
        raise ValueError(f"unknown mode {mode!r}; modes: {sorted(table)}")
    want = table[mode][1:4] if table is CONV_MODES else table[mode][1:]
    if tuple(counts) != tuple(want):
        raise ValueError(f"mode {mode!r} takes {want} tensors/bands/constants, got {counts}")


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the comparison on the card)
# ---------------------------------------------------------------------------


def _bn_input(g, f, consts, dtype):
    """BN's backward as one affine chain: round(p·(g − q − (f·r′ − m′)))."""
    p, q, rp, mrp = consts
    return (p * (g.float() - q - (f.float() * rp - mrp))).to(dtype)


def fused_conv3_reference(mode, src, weight, side=(), consts=(), bias=None,
                          shortcut=None, out_ch=None):
    """``epilogue(conv3x3(prologue(src); weight))`` of one chain mode (module
    doc), NHWC, OIHW weight (the conv as it runs: a backward-data conv gets
    the rotated, I/O-swapped weight), pad 1 after the prologue, weights
    rounded to the activation dtype, f32 sums. ``bias`` only with "gamma";
    ``shortcut`` (OIHW 1×1, ΣCp × C) and ``out_ch`` (the parts' channels)
    only with "bn1". Returns ``(out, stats)``: ``out`` a tensor, or a tuple
    of per-part tensors with ``out_ch``; ``stats`` (rows, Cout) f32 or None."""
    _check_mode(CONV_MODES, mode, (len(src), len(side), len(consts)))
    dtype = src[0].dtype
    if mode == "modgrad":
        g0, y = src
        x = ((g0.float() * y.float()).to(dtype), g0)
    elif mode in ("bn2", "bn1"):
        x = (_bn_input(src[0], src[1], consts[:4], dtype),)
    else:
        x = (src[0],)
    acc = conv2d_nhwc(tuple(p.float() for p in x), _q(weight, dtype),
                      None if bias is None else _q(bias, dtype), 1)
    r = acc.to(dtype).float()
    stats = None
    if mode == "gamma":
        out = r
    elif mode == "modgrad":
        out = torch.where(side[0].float() > 0, r, 0.0)
        stats = out.sum(_PX)[None]
    elif mode == "seg":
        out = r
        stats = out.sum(_PX)[None]
    elif mode == "pre":
        g0, gamma, y, f2 = (t.float() for t in side)
        r2, m2r2 = consts
        gp = torch.where(y > 0, g0 * (1.0 + gamma) + r, 0.0)
        xhat2 = f2 * r2 - m2r2
        out = gp
        stats = torch.stack([gp.sum(_PX), (gp * xhat2).sum(_PX), (g0 * y).sum(_PX),
                             g0.sum(_PX)])
    elif mode == "bn2":
        f1 = side[0].float()
        a1, b1, r1, m1r1 = consts[4:]
        out = torch.where(f1 * a1 + b1 > 0, r, 0.0)
        xhat1 = f1 * r1 - m1r1
        stats = torch.stack([out.sum(_PX), (out * xhat1).sum(_PX)])
    else:  # bn1
        out = r + conv2d_nhwc(side[0].float(), _q(shortcut, dtype))
    out = out.to(dtype)
    if out_ch is not None:
        return tuple(torch.split(out, list(out_ch), -1)), stats
    return out, stats


def _cotangent(mode, g, consts, dtype):
    """The weight gradient's cotangent built from its g-side tensors."""
    if mode == "gb":
        g0, y = g
        return torch.cat([(g0.float() * y.float()).to(dtype), g0], -1)
    if mode in ("conv2", "conv1"):
        return _bn_input(g[0], g[1], consts, dtype)
    return g[0]


def fused_wgrad_reference(mode, x, g, consts=(), prologue=None):
    """dW (OIHW, f32) of ``cotangent = conv3x3(input; W)`` for one chain mode
    (module doc): the input is ``x`` (≤ 2 parts, or ``relu(x·a + b)`` with
    ``prologue``), the cotangent is rebuilt from ``g`` (and ``consts``)."""
    x = as_parts(x)
    _check_mode(WGRAD_MODES, mode, (len(g), len(consts)))
    return wgrad_reference(x, _cotangent(mode, g, consts, x[0].dtype), prologue)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

# ssu_fused_conv3's pointer and integer arguments, by position
_CONV_PTRS = ("src0", "src1", "weight", "bias", "pro_f", *(f"cst{i}" for i in range(8)),
              *(f"band{i}" for i in range(4)), "out0", "out1", "partial", "stats")
_CONV_INTS = ("c0", "k0", "c1", "k1", "kp", "n", "h", "w", "cout", "split")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssu_conv3_blocks.argtypes = [i, i, i, i, i]
    lib.ssu_conv3_blocks.restype = ll
    lib.ssu_fused_conv3.argtypes = [i, p, p, p]
    lib.ssu_fused_conv3.restype = i
    lib.ssu_fused_wgrad.argtypes = [i, p, i, p, i, p, p, p, p, p, i, i, p, i, i, i, p]
    lib.ssu_fused_wgrad.restype = i
    return lib


def conv3_chunk(kmode: int, channels) -> int:
    """Channels per K chunk of the conv core's 3×3 sources of ``channels``
    (csrc/bwd_core.cuh ``chunk_channels``, shared by the parts): 32 for the
    chain modes (their sources have the stage's planes), else the widest
    part's: a narrow part's 8 or 16 channels whole, so its taps pack into
    K, else 32."""
    if kmode in _K_CHAIN:
        return 32
    return max(eval_chunk(c) for c in channels)


def _conv3_weight(segments, dtype, cc: int) -> torch.Tensor:
    """[cout][K] weight operand of the conv3 kernel: per segment (OIHW,
    3×3 or 1×1), per chunk of ``cc`` input channels, (tap, channel) with
    channels zero-padded to the chunk, each chunk zero-padded to a multiple
    of 32 K values. One zero fill and one copy per segment."""
    cout = segments[0].shape[0]
    geo = []  # (taps, chunks, K per chunk) of each segment
    for w in segments:
        taps, nch = w.shape[2] * w.shape[3], -(-w.shape[1] // cc)
        geo.append((taps, nch, -(-taps * cc // 32) * 32))
    wt = torch.zeros((cout, sum(n * k for _, n, k in geo)), dtype=dtype, device=segments[0].device)
    k0 = 0
    for w, (taps, nch, kc) in zip(segments, geo):
        cin = w.shape[1]
        dst = wt[:, k0:k0 + nch * kc].view(cout, nch, kc)[:, :, :taps * cc]
        src = w.permute(0, 2, 3, 1).reshape(cout, taps, cin)
        if cin % cc:
            src = F.pad(src, (0, nch * cc - cin))
        dst.view(cout, nch, taps, cc).copy_(src.reshape(cout, taps, nch, cc).transpose(1, 2))
        k0 += nch * kc
    return wt


def _conv3_cuda(mode, src, weight, side, consts, bias, shortcut, out_ch):
    kmode, _, _, _, rows = CONV_MODES[mode]
    _check_nhwc(tuple(src) + tuple(side), f"fused_conv3 {mode}", max_parts=5)
    cout = weight.shape[0]
    c_in = src[0].shape[-1]
    # (tensor, kernel size) of each K-segment, its weight, the prologue's second tensor
    sources, segments, pro_f = [(src[0], 3)], [weight], None
    if mode == "modgrad":
        sources, segments, pro_f = [(src[0], 3)] * 2, split_in(weight, [c_in] * 2), src[1]
    elif mode in ("bn2", "bn1"):
        pro_f = src[1]
    if pro_f is not None and pro_f.shape[-1] != c_in:
        raise ValueError(f"fused_conv3 {mode}: {tuple(pro_f.shape)} does not pair with "
                         f"{c_in} channels")
    if sum(s.shape[1] for s in segments) != sum(t.shape[-1] for t, _ in sources) or \
            tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"fused_conv3 {mode}: weight {tuple(weight.shape)} does not fit "
                         f"{[t.shape[-1] for t, _ in sources]} channels")
    bands = tuple(side)
    if mode == "bn1":
        if shortcut is None or tuple(shortcut.shape) != (cout, side[0].shape[-1], 1, 1):
            raise ValueError("fused_conv3 bn1 takes the 1x1 shortcut weight (ΣCp, C, 1, 1)")
        sources.append((side[0], 1))
        segments.append(shortcut)
        bands = ()
    elif any(b.shape[-1] != cout for b in bands):
        raise ValueError(f"fused_conv3 {mode}: side bands must have {cout} channels")
    split_out = out_ch is not None
    out_ch = tuple(out_ch) if split_out else (cout,)
    if sum(out_ch) != cout or len(out_ch) > 2 or (len(out_ch) > 1 and mode != "bn1"):
        raise ValueError(f"fused_conv3 {mode}: outputs {out_ch} for {cout} channels")
    # the plain conv always sums (Σ, Σx²); "seg" keeps Σ
    outs, sums = launch_conv3(kmode, sources, segments, pro_f=pro_f, consts=consts,
                              bands=bands, bias=bias, out_ch=out_ch,
                              rows=2 if rows and kmode == K_STD else rows)
    launches["fused_conv3"] += 1
    return (tuple(outs) if split_out else outs[0]), None if sums is None else sums[:rows]


def launch_conv3(kmode, sources, segments, pro_f=None, consts=(), bands=(), bias=None,
                 out_ch=None, rows=0):
    """One launch of the conv core (``ssu_fused_conv3``) in kernel mode
    ``kmode``: ``sources`` are ``(tensor, kernel size)`` K-segments (NHWC,
    bf16, one N×H×W), ``segments`` their OIHW weights, packed by
    :func:`_conv3_weight` at the core's chunk width. Returns the outputs
    (one per ``out_ch`` entry, default one of all output channels) and the
    ``rows`` stat rows (or None); the caller counts the launch."""
    x0 = sources[0][0]
    n, h, w = x0.shape[:3]
    dev, dtype = x0.device, x0.dtype
    cout = segments[0].shape[0]
    out_ch = out_ch or (cout,)
    lib = _lib()
    with torch.cuda.device(dev):
        cc = conv3_chunk(kmode, [t.shape[-1] for t, k in sources if k == 3])
        wt = _conv3_weight(segments, dtype, cc)
        cvs = [_vec(c) for c in consts]
        outs = [torch.empty((n, h, w, c), dtype=dtype, device=dev) for c in out_ch]
        partial = sums = None
        if rows:
            nb = lib.ssu_conv3_blocks(kmode, cout, n, h, w)
            partial = torch.empty(rows * cout * nb, dtype=torch.float32, device=dev)
            sums = torch.empty((rows, cout), dtype=torch.float32, device=dev)
        b = None if bias is None else _q(bias, dtype).contiguous()
        ptrs = {"src0": sources[0][0], "src1": sources[1][0] if len(sources) > 1 else None,
                "weight": wt, "bias": b, "pro_f": pro_f,
                "out0": outs[0], "out1": outs[1] if len(outs) > 1 else None,
                "partial": partial, "stats": sums}
        ptrs.update({f"cst{i}": c for i, c in enumerate(cvs)})
        ptrs.update({f"band{i}": t for i, t in enumerate(bands)})
        ints = {"c0": sources[0][0].shape[-1], "k0": sources[0][1],
                "c1": sources[1][0].shape[-1] if len(sources) > 1 else 0,
                "k1": sources[1][1] if len(sources) > 1 else 0, "kp": wt.shape[1],
                "n": n, "h": h, "w": w, "cout": cout, "split": out_ch[0]}
        parr = (ctypes.c_void_p * len(_CONV_PTRS))(*(_ptr(ptrs.get(k)) for k in _CONV_PTRS))
        iarr = (ctypes.c_int * len(_CONV_INTS))(*(ints[k] for k in _CONV_INTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.ssu_fused_conv3(kmode, parr, iarr, stream), f"conv core (mode {kmode})")
    return outs, sums


def _wgrad_cuda(mode, x, g, consts, prologue):
    gmode = WGRAD_MODES[mode][0]
    _check_nhwc(tuple(x) + tuple(g), f"fused_wgrad {mode}", max_parts=4)
    if len(g) == 2 and g[1].shape[-1] != g[0].shape[-1]:
        raise ValueError(f"fused_wgrad {mode}: g-side tensors differ in channels")
    cout = 2 * g[0].shape[-1] if mode == "gb" else g[0].shape[-1]
    dw = launch_wgrad(gmode, x, g, consts, prologue, cout)
    launches["fused_wgrad"] += 1
    return dw


def launch_wgrad(gmode, x, g, consts, prologue, cout):
    """One launch of the weight-gradient core (``ssu_fused_wgrad``) with
    cotangent mode ``gmode`` (0: ``g[0]`` as it is): dW (OIHW, f32) of
    ``cout`` rows over the input parts ``x`` (≤ 2; ``prologue`` only on a
    single part). The caller counts the launch."""
    if len(x) > 2:
        raise ValueError(f"the weight gradient takes at most 2 input parts, got {len(x)}")
    if prologue is not None and len(x) != 1:
        raise ValueError("the prologue takes a single input")
    channels = [p.shape[-1] for p in x]
    n, h, w = x[0].shape[:3]
    dev = g[0].device
    lib = _lib()
    with torch.cuda.device(dev):
        pa, pb = (None, None) if prologue is None else map(_vec, prologue)
        cvs = [_vec(c) for c in consts]
        carr = (ctypes.c_void_p * 4)(*([c.data_ptr() for c in cvs] + [None] * (4 - len(cvs))))
        # the kernel sums its blocks' f32 partial sums into dW (OIHW) with f64
        # atomics, so the order of hundreds of adds per element costs nothing
        dw = torch.zeros((cout, sum(channels), 3, 3), dtype=torch.float64, device=dev)
        x1 = x[1] if len(x) > 1 else None
        _check(lib.ssu_fused_wgrad(gmode, x[0].data_ptr(), channels[0], _ptr(x1),
                                   channels[1] if x1 is not None else 0, _ptr(pa), _ptr(pb),
                                   g[0].data_ptr(), _ptr(g[1] if len(g) > 1 else None), carr,
                                   cout, g[0].shape[-1], dw.data_ptr(), n, h, w,
                                   torch.cuda.current_stream(dev).cuda_stream),
               f"weight-gradient core (mode {gmode})")
    return dw.float()


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------


def fused_conv3(mode, src, weight, side=(), consts=(), bias=None, shortcut=None,
                out_ch=None):
    """Arguments and result as :func:`fused_conv3_reference`. CPU tensors run
    the plain version; CUDA tensors run the kernel, or raise."""
    src = as_parts(src)
    _check_mode(CONV_MODES, mode, (len(src), len(side), len(consts)))
    if _device(src[0], "fused_conv3") == "cpu":
        return fused_conv3_reference(mode, src, weight, side, consts, bias, shortcut, out_ch)
    return _conv3_cuda(mode, src, weight, side, consts, bias, shortcut, out_ch)


def fused_wgrad(mode, x, g, consts=(), prologue=None):
    """Arguments and result as :func:`fused_wgrad_reference`."""
    x, g = as_parts(x), as_parts(g)
    _check_mode(WGRAD_MODES, mode, (len(g), len(consts)))
    if _device(g[0], "fused_wgrad") == "cpu":
        return fused_wgrad_reference(mode, x, g, consts, prologue)
    return _wgrad_cuda(mode, x, g, consts, prologue)


# ---------------------------------------------------------------------------
# The v3 backward of the fused train stage
# ---------------------------------------------------------------------------


# csrc/bwd_core.cuh CHAIN_MAX_C: the BN chains' constants per block
MAX_PLANES = 512


def bwd_v3_supported(part_channels, planes: int) -> bool:
    """Whether the v3 backward takes a stage with parts of these channels
    and ``planes`` output channels: the kernels' own limits, at most two
    parts (κ7 writes each part through its own pointer; the weight gradient
    reads at most two) and at most ``MAX_PLANES`` planes (the BN chains'
    constants staged in shared memory). The JAX package's envelope
    (``bwd_v3_supported``: W ≥ 128, C ≤ 256, ΣCp ≤ 512) answers the TPU's
    VMEM limits, which the card does not have; every stage the port fuses
    (planes ≤ 256) runs v3."""
    return 1 <= len(part_channels) <= 2 and planes <= MAX_PLANES


def _convT(w: torch.Tensor) -> torch.Tensor:
    """The backward-data conv's weight: rotated 180°, I/O swapped."""
    return w.flip(2, 3).transpose(0, 1)


def train_bwd_v3(parts, bp, sp, head, saved, g_out, want_parts: bool):
    """``train_bwd_v3`` (ssunet_gan_tpu/ops/train_bwd.py:486-777) over NHWC
    tensors (``count = N·H·W`` times the data-parallel axis's ranks: under a
    mesh the κ5 / κ6 sums that feed the input gradient's BN terms cross the
    ranks, and the parameter gradients stay this rank's). Returns (part
    grads or None, block grads, SPADE grads, head grads or None), as the v2
    body."""
    f1, f2, y, seg, act, mean1, var1, mean2, var2 = saved
    w1, (g1, be1), w2, (g2, be2), ws = bp
    wx, bx, wm, bm, wg, bg, wb, bb = sp
    dtype = f1.dtype
    c = w2.shape[0]
    n, h, w = f1.shape[:3]
    count = n * h * w * collectives.axis_size()

    # κ1: γ recompute (γ|β when the head needs out0)
    if head is not None:
        gb, _ = fused_conv3("gamma", (act,), torch.cat([wg, wb]), bias=torch.cat([bg, bb]))
        gamma, beta = gb[..., :c].contiguous(), gb[..., c:]
    else:
        gamma, _ = fused_conv3("gamma", (act,), wg, bias=bg)

    # folded head: out = conv1x1(out0; wf) + bf (plain products)
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

    # κ3: g_pre2s = actv-mask(convT([g·y ; g], k_γ|β)); Σ → mlp_shared bias
    wgb = torch.cat([wg, wb])
    g_pre2s, st3 = fused_conv3("modgrad", (g_out0, y), _convT(wgb), side=(act,))
    g_wgb = fused_wgrad("gb", (act,), (g_out0, y))

    # κ4: g_seg = convT(g_pre2s, k_mlp); Σ → x2map bias
    g_seg, st4 = fused_conv3("seg", (g_pre2s,), _convT(wm))
    g_wm = fused_wgrad("mlp", (seg,), (g_pre2s,))

    # κ5: g_pre = where(y > 0, g·(1+γ) + convT(g_seg, k_x2map)); 4 stat rows
    r2 = torch.rsqrt(var2 + BN_EPS)
    g_pre, st5 = fused_conv3("pre", (g_seg,), _convT(wx), side=(g_out0, gamma, y, f2),
                             consts=(r2, mean2 * r2))
    s_g2, s_gx2 = st5[0], st5[1]  # the parameter gradients: this rank's sums
    t_g2, t_gx2 = collectives.psum_if(st5[:2])  # the BN2 backward's: global
    g_wx = fused_wgrad("x2map", (y,), (g_seg,))

    # 1×1 shortcut weight gradient, per part (plain products)
    gp2 = g_pre.reshape(-1, c).float()
    g_ws = torch.cat([gp2.t() @ p.reshape(-1, p.shape[-1]).float() for p in parts], 1)
    g_ws = g_ws.reshape(c, -1, 1, 1)

    # κ6: g_n1 = pre₁-mask(convT(bn2-backward(g_pre, f2), k2)); Σgn, Σgn·x̂₁
    r1 = torch.rsqrt(var1 + BN_EPS)
    a1 = g1 * r1
    bn2 = (g2 * r2, t_g2 / count, r2 * t_gx2 / count, mean2 * r2 * t_gx2 / count)
    g_n1, st6 = fused_conv3("bn2", (g_pre, f2), _convT(w2), side=(f1,),
                            consts=bn2 + (a1, be1 - mean1 * a1, r1, mean1 * r1))
    s_g1, s_gx1 = st6[0], st6[1]
    t_g1, t_gx1 = collectives.psum_if(st6[:2])
    g_w2 = fused_wgrad("conv2", (f1,), (g_pre, f2), consts=bn2,
                       prologue=(a1, be1 - mean1 * a1))

    # κ7: g_x = convT(bn1-backward(g_n1, f1), k1) + ksᵀ·g_pre, per part
    bn1 = (a1, t_g1 / count, r1 * t_gx1 / count, mean1 * r1 * t_gx1 / count)
    g_parts = None
    if want_parts:
        g_parts, _ = fused_conv3("bn1", (g_n1, f1), _convT(w1), side=(g_pre,), consts=bn1,
                                 shortcut=ws.transpose(0, 1).clone(),  # no view of ws
                                 out_ch=[p.shape[-1] for p in parts])
        g_parts = [gp.to(p.dtype) for gp, p in zip(g_parts, parts)]
    g_w1 = fused_wgrad("conv1", parts, (g_n1, f1), consts=bn1)

    g_bp = (g_w1, (s_gx1, s_g1), g_w2, (s_gx2, s_g2), g_ws)
    g_sp = (g_wx, st4[0], g_wm, st3[0], g_wgb[:c], st5[2], g_wgb[c:], st5[3])
    return g_parts, g_bp, g_sp, g_head
