"""int8 fused eval-mode [BasicBlock + self-SPADE] stage: CUDA kernel, plain
version, the deep stages' s8 block, and the calibration state.

Replaces the TPU kernel ``ssunet_gan_tpu/ops/stage_kernel_int8.py``
``fused_eval_stage_int8`` (→ ``_stage_call_int8`` → ``pl.pallas_call``, body
``_make_kernel_int8``). Symmetric quantization, zero-points 0 everywhere:

    qx_p = clip(round(x_p / s_p))            per part, s_p static or dynamic
    Wq1, d1 = rows(K1·s1·s_p)                per-output-channel s8 weights
    h1  = relu(f32(conv3x3_s8(qx; Wq1))·d1 + t1)           → activation dtype
    s_b = max(max(h1 over band b ± 4 rows)/127, 1e-12)     per image and band
    y   = relu(f32(conv3x3_s8(q_b(h1); Wq2))·(d2·s_b)
               + f32(conv1x1_s8(qx; Wqs))·ds + t2)         → activation dtype
    out = SPADE tail of y in the activation dtype          [logits | s8 out]

What bounds it on the H100: as in the bf16 stage the two big convs carry
~95% of the multiply-adds, far above the s8 ridge point, so the stage is
bound by tensor-core operations. The kernel (``csrc/int8_stage.cu``) first
quantizes each bf16 input in one pass (:func:`quantize_tensor`), then runs
conv1 and conv2 + shortcut on the s8 conv core (``csrc/int8_conv.cuh``:
``wgmma`` m64nNk32 with both operands in shared memory, exact s32 sums; the
weights packed once per model in the descriptor's order, :func:`pack_s8_conv`);
a small launch between them turns the per-row maxima of h1 into band
scales and writes q(h1) band by band; the SPADE tail is the bf16 stage's,
with an epilogue that emits s8 at a calibrated output scale. Each conv
launch has its plain version (:func:`s8_conv1_reference`,
:func:`band_quant_reference`, :func:`s8_conv2_reference`), which composes
to :func:`int8_stage_reference`'s h1 and y bit for bit.

Numerics choices of the port (where the TPU kernel left room):

- **Band height.** h1's scale is per image and per band of ``th`` rows plus
  four halo rows each side. ``th`` is :func:`band_rows`: the largest of 64,
  32, 16, 8 that divides H (what the TPU kernel resolves to where none of
  its memory probes rejects a candidate), else H.
- **One scale per row of y.** The TPU kernel recomputes a band's three halo
  rows of y with that band's scale; here a row of y is computed once, with
  the scale of the band that owns it (the TPU kernel's own halo-carry mode
  makes the same kind of choice). With one band the two agree.
- Integer sums are exact everywhere (f64 convs in the plain version, s32 on
  the card), so launches A and B agree with the plain version bit for bit;
  so do the quantized inputs (an IEEE division, round half to even).
- The TPU kernel's s8 on-read seams (``_upsample_on_read_s8`` :330,
  ``_pool_on_read_s8`` :360) are still to port: the int8 mode takes its
  seams materialized. Lane packing, pair dots and halo carry are TPU
  scheduling devices and are not ported.

:func:`fused_eval_stage_int8` decides by the tensors' device: CPU tensors
take :func:`int8_stage_reference`; CUDA tensors launch the kernel (bf16
activations only) or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops.conv import as_parts
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    _ptr,
    _refused,
    eval_conv_weight,
    pack_spade,
    spade_tail_reference,
    split_in,
    stage_supported,
    tail_args,
    tail_widths,
)

SOURCE = "int8_stage.cu"
REPLACES = "ssunet_gan_tpu/ops/stage_kernel_int8.py:740"  # fused_eval_stage_int8

# int8 fused stages run on the card, one per stage (four CUDA launches each,
# after the quantization of its bf16 inputs).
launches = 0
# launches A and B of the s8 conv core (csrc/int8_conv.cuh), two per stage
conv_launches = 0
# one-pass quantizations of a CUDA tensor (launch P, csrc/int8_stage.cu)
quant_launches = 0

TH_CANDIDATES = (64, 32, 16, 8)

# ---------------------------------------------------------------------------
# Mode and calibration state. int8 is opt-in (config key "int8" /
# set_int8_stage): it is a quantized approximation, so the caller owns the
# trade. ``_CALIB_SCALES`` maps "<stage>:<part>" → abs-max; ``_RECORD_SINK``
# (a dict) switches the model's dispatch into record mode: stages run the
# plain composition and write their inputs' abs-max into the sink.
# ---------------------------------------------------------------------------

_INT8_STAGE = False
_CALIB_SCALES: Optional[Dict[str, float]] = None
_RECORD_SINK: Optional[dict] = None


def set_int8_stage(enabled: bool) -> None:
    global _INT8_STAGE
    _INT8_STAGE = bool(enabled)


def int8_stage_enabled() -> bool:
    return _INT8_STAGE


def set_int8_calibration(scales: Optional[Dict[str, float]]) -> None:
    """Install static activation ranges ({"stage:i": abs_max}), or None to
    return to dynamic per-tensor quantization."""
    global _CALIB_SCALES
    _CALIB_SCALES = dict(scales) if scales is not None else None


def int8_calibration() -> Optional[Dict[str, float]]:
    return _CALIB_SCALES


def set_record_sink(sink: Optional[dict]) -> None:
    global _RECORD_SINK
    _RECORD_SINK = sink


def record_sink() -> Optional[dict]:
    return _RECORD_SINK


def record_range(key: str, amax: torch.Tensor) -> None:
    """Record-mode hook: keep the larger of ``amax`` (a 0-dim tensor) and
    what the active sink already holds under ``key``."""
    if _RECORD_SINK is None:
        return
    prev = _RECORD_SINK.get(key)
    _RECORD_SINK[key] = amax if prev is None else torch.maximum(prev, amax)


def record_stage_inputs(key: str, parts) -> None:
    """Record-mode hook of the model's dispatch: each stage input's abs-max."""
    if _RECORD_SINK is None:
        return
    for i, p in enumerate(parts):
        record_range(f"{key}:{i}", p.float().abs().max())


def _calibrated(calib_key: Optional[str], i: int) -> Optional[float]:
    if _CALIB_SCALES is None or calib_key is None:
        return None
    return _CALIB_SCALES.get(f"{calib_key}:{i}")


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A producer-quantized activation between stages: ``q`` is the s8 NHWC
    tensor, ``scale`` its dequantization scale (``x ≈ q·scale``, a Python
    float: it exists only under static calibration), ``dtype`` the
    activation dtype it stands in for. Max-pooling commutes with symmetric
    quantization, so a pooled QTensor keeps its producer's scale."""

    q: torch.Tensor
    scale: float
    dtype: torch.dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def dequant(self) -> torch.Tensor:
        return (self.q.float() * _f32(self.scale, self.q.device)).to(self.dtype)


Part = Union[torch.Tensor, QTensor]


def _f32(v, device) -> torch.Tensor:
    """``v`` (a float or a 0-dim tensor) as a 0-dim f32 tensor on ``device``.
    Scales divide and multiply as device tensors: a Python scalar divisor
    may become a multiplication by its reciprocal, which rounds otherwise."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _over_127(m: torch.Tensor) -> torch.Tensor:
    """max(m / 127, 1e-12) in f32."""
    return torch.clamp_min(m / _f32(127.0, m.device), 1e-12)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    """clip(round half to even, ±127) as s8."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def static_scale(abs_max: float) -> float:
    """The scale of a calibrated range, max(abs_max/127, 1e-12) in f32."""
    return float(max(np.float32(abs_max) / np.float32(127.0), np.float32(1e-12)))


def quantize_reference(x: torch.Tensor, abs_max: Optional[float] = None):
    """Per-tensor symmetric s8 quantization in plain PyTorch: ``(q, scale)``
    with ``x ≈ q·scale``, q ∈ [−127, 127]. With ``abs_max`` (a calibrated
    range) the scale is static, a Python float, and values beyond the range
    saturate; without it the scale is the tensor's own abs-max over 127, a
    0-dim tensor on ``x``'s device (no host sync)."""
    xf = x.float()
    s = _over_127(xf.abs().max()) if abs_max is None else static_scale(abs_max)
    return _round_clip(xf / _f32(s, x.device)), s


def quantize_tensor(x: torch.Tensor, abs_max: Optional[float] = None):
    """:func:`quantize_reference` on the tensor's device: CPU tensors take
    it; a bf16 or f32 CUDA tensor takes the one-pass kernel (launch P of
    ``csrc/int8_stage.cu``: ``clip(rint(x / s), ±127)``, under a dynamic
    scale after an abs-max pass that leaves the scale in device memory, so
    no host sync), which agrees with it bit for bit; anything else raises.
    Counts ``quant_launches``."""
    global quant_launches
    if x.device.type == "cpu":
        return quantize_reference(x, abs_max)
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the quantization kernel takes bf16 or f32 CUDA tensors, got "
                        f"{x.dtype} on {x.device}")
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib, n, f32 = _lib(), x.numel(), int(x.dtype == torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if abs_max is None:
            work = torch.zeros(2, dtype=torch.int32, device=x.device)
            s = torch.empty((), dtype=torch.float32, device=x.device)
            _check(lib.ssu_q_absmax(_ptr(x), n, f32, _ptr(work), _ptr(s), stream), "abs-max")
            _check(lib.ssu_q_quant(_ptr(x), n, f32, _ptr(s), 0.0, _ptr(q), stream), "quantize")
        else:
            s = static_scale(abs_max)
            _check(lib.ssu_q_quant(_ptr(x), n, f32, None, s, _ptr(q), stream), "quantize")
    quant_launches += 1
    return q, s


def quant_rows(w: torch.Tensor):
    """Per-row (output channel) symmetric s8 quantization of a (C, K) f32
    matrix: ``(q, scales)``."""
    s = _over_127(w.abs().amax(1))
    return _round_clip(w / s[:, None]), s


def quant_oihw(w: torch.Tensor):
    """Per-output-channel symmetric s8 quantization of an OIHW f32 weight."""
    s = _over_127(w.abs().amax((1, 2, 3)))
    return _round_clip(w / s[:, None, None, None]), s


def band_rows(h: int) -> int:
    """Rows per band of h1's requantization: the largest of 64, 32, 16, 8
    that divides ``h``, else ``h`` (one band)."""
    for th in TH_CANDIDATES:
        if h % th == 0:
            return th
    return h


def _quantize_parts(parts: Sequence[Part], calib_key: Optional[str], quantize=None):
    """(s8 parts, scales, activation dtype). A QTensor part brings its
    producer's scale (the stage's own calibrated key is ignored for it); a
    tensor part is quantized by ``quantize`` (:func:`quantize_tensor` when
    None, looked up at call time) with the calibrated range under
    ``"<calib_key>:<i>"`` if installed, else dynamically."""
    if quantize is None:
        quantize = quantize_tensor
    qs, scales = [], []
    for i, p in enumerate(parts):
        if isinstance(p, QTensor):
            qs.append(p.q)
            scales.append(float(np.float32(p.scale)))  # the f32 value consumers fold in
        else:
            q, s = quantize(p, _calibrated(calib_key, i))
            qs.append(q)
            scales.append(s)
    return tuple(qs), tuple(scales), parts[0].dtype


def _rows3x3(w: torch.Tensor) -> torch.Tensor:
    """OIHW → (O, taps·I), tap-major (dy, dx) then input channel."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def fold_block(block_params) -> dict:
    """The scale-independent half of a stage's s8 operands: BN folded into
    the f32 weights, conv2 quantized per output channel, the f32 biases."""
    w1, (s1, t1), w2, (s2, t2), ws = block_params
    k1f = w1.float() * s1.float()[:, None, None, None]
    k2f = w2.float() * s2.float()[:, None, None, None]
    wq2, d2 = quant_rows(_rows3x3(k2f))
    return {"k1f": k1f, "ksf": None if ws is None else ws.float()[:, :, 0, 0],
            "wq2": wq2, "d2": d2, "t1": t1.float().contiguous(),
            "t2": t2.float().contiguous()}


def fold_input_scales(folded: dict, part_channels, scales, device):
    """conv1's and the shortcut's s8 rows with the per-part input scales
    folded into their columns before quantization: ``(wq1 parts, d1, wqs
    parts, ds)``, rows tap-major per part. Device ops only (no host sync),
    so dynamic scales cost no stall."""
    k1_parts = [_rows3x3(w * _f32(s, device))
                for w, s in zip(split_in(folded["k1f"], part_channels), scales)]
    wq1, d1 = quant_rows(torch.cat(k1_parts, 1))
    c = wq1.shape[0]
    if folded["ksf"] is None:  # no shortcut conv: zero columns
        ks_parts = [torch.zeros((c, cp), dtype=torch.float32, device=device)
                    for cp in part_channels]
    else:
        offs = np.cumsum([0] + list(part_channels))
        ks_parts = [folded["ksf"][:, a:b] * _f32(s, device)
                    for a, b, s in zip(offs, offs[1:], scales)]
    wqs, ds = quant_rows(torch.cat(ks_parts, 1))
    split1 = torch.split(wq1, [9 * cp for cp in part_channels], 1)
    splits = torch.split(wqs, list(part_channels), 1)
    return split1, d1, splits, ds


def _oihw3x3(rows: torch.Tensor) -> torch.Tensor:
    """(O, 9·I) tap-major rows → OIHW."""
    o = rows.shape[0]
    return rows.reshape(o, 3, 3, -1).permute(0, 3, 1, 2)


_INT_MM_CHUNK = 1 << 30  # bytes of one gathered 9-tap operand


def _int_mm_fits(m: int, k: int, n: int) -> bool:
    return hasattr(torch, "_int_mm") and m > 16 and k % 8 == 0 and n % 8 == 0


def tap_operand(qparts, k: int, padding: int) -> torch.Tensor:
    """The gathered tap operand of s8 NHWC split-concat parts for a k×k
    conv: (N·H·W, k²·ΣC) s8, part by part, taps (dy, dx) major, then the
    part's channels (the K order of the weights' ``permute(2, 3, 1, 0)``)."""
    n, h, w = qparts[0].shape[:3]
    cols = []
    for q in qparts:
        if k == 1:
            cols.append(q)
        else:
            qp = F.pad(q, (0, 0, padding, padding, padding, padding))
            cols += [qp[:, dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)]
    return torch.cat(cols, -1).reshape(n * h * w, -1)


def int_conv(qparts, wparts, padding: int, library: bool = False) -> torch.Tensor:
    """Exact integer stride-1 conv of s8 NHWC split-concat parts with s8
    OIHW weights (one per part): the sums as f64 NHWC (every value an exact
    integer). f64 convs, a few images at a time; with ``library`` and CUDA
    tensors whose shapes it takes, ``torch._int_mm`` over the gathered taps
    (exact s32 sums) instead."""
    n, h, w = qparts[0].shape[:3]
    cout = wparts[0].shape[0]
    k = wparts[0].shape[-1]
    ktot = sum(wp[0].numel() for wp in wparts)
    if (library and qparts[0].is_cuda and _int_mm_fits(h * w, ktot, cout)):
        wmat = torch.cat([wp.permute(2, 3, 1, 0).reshape(-1, cout) for wp in wparts]).contiguous()
        per = max(1, _INT_MM_CHUNK // (h * w * ktot))
        outs = []
        for i in range(0, n, per):
            a = tap_operand([q[i:i + per] for q in qparts], k, padding)
            outs.append(torch._int_mm(a, wmat).reshape(-1, h, w, cout))
        return torch.cat(outs).double()
    per = max(1, (1 << 28) // (h * w * max(q.shape[-1] for q in qparts)))
    outs = []
    for i in range(0, n, per):
        acc = None
        for q, wp in zip(qparts, wparts):
            a = F.conv2d(q[i:i + per].permute(0, 3, 1, 2).double(), wp.double(),
                         padding=padding)
            acc = a if acc is None else acc + a
        outs.append(acc.permute(0, 2, 3, 1))
    return torch.cat(outs).contiguous()


# ---------------------------------------------------------------------------
# The deep (unfused) stages' s8 block.
# ---------------------------------------------------------------------------


def int8_block(parts: Sequence[Part], block_params, calib_key: Optional[str] = None,
               residual: bool = True) -> torch.Tensor:
    """Eval BasicBlock on s8 convs for the stages the fused kernel does not
    take (the JAX package's ``xla_int8_block``, there an XLA s8 conv outside
    any Pallas kernel): static-or-dynamic per-tensor input scales folded
    into per-output-channel s8 weights, f32 dequantization with the BN
    affine and ReLU, h1 (kept in f32) requantized per tensor, dynamically.
    A block without a shortcut conv adds the (dequantized) input when
    ``residual``, nothing otherwise (a plain conv chain). Returns the block
    output before SPADE, in the activation dtype. The integer convs are
    exact on either device; on the card they go to ``torch._int_mm`` over
    the gathered taps where the shapes fit it (a library route: this block
    is not one of the TPU kernels), else to f64 convs."""
    parts = as_parts(parts)
    w1, (s1, t1), w2, (s2, t2), ws = block_params
    dev = parts[0].device
    chans = [p.shape[-1] for p in parts]
    qparts, scales, dtype = _quantize_parts(parts, calib_key)

    k1f = w1.float() * s1.float()[:, None, None, None]
    k1f = torch.cat([w * _f32(s, dev) for w, s in zip(split_in(k1f, chans), scales)], 1)
    wq1, d1 = quant_oihw(k1f)
    acc1 = int_conv(qparts, split_in(wq1, chans), 1, library=True).float()
    h1 = torch.relu(acc1 * d1 + t1.float())

    qh1, sh1 = quantize_tensor(h1)
    wq2, d2 = quant_oihw(w2.float() * s2.float()[:, None, None, None])
    acc2 = int_conv((qh1,), (wq2,), 1, library=True).float() * (d2 * sh1) + t2.float()
    if ws is not None:
        ksf = torch.cat([w * _f32(s, dev) for w, s in zip(split_in(ws.float(), chans), scales)], 1)
        wqs, dsc = quant_oihw(ksf)
        acc2 = acc2 + int_conv(qparts, split_in(wqs, chans), 0, library=True).float() * dsc
    elif residual:
        fparts = [p.dequant() if isinstance(p, QTensor) else p for p in parts]
        acc2 = acc2 + (fparts[0] if len(fparts) == 1 else torch.cat(fparts, -1)).float()
    return torch.relu(acc2).to(dtype)


def emit_s8(y: torch.Tensor, abs_max: float) -> QTensor:
    """Producer-side s8 emission of a stage output computed outside the
    fused kernel: ``clip(round(y / s))`` at the calibrated output scale."""
    s = max(float(abs_max) / 127.0, 1e-12)
    return QTensor(_round_clip(y.float() / _f32(s, y.device)), s, y.dtype)


# ---------------------------------------------------------------------------
# The fused stage: plain version.
# ---------------------------------------------------------------------------


def _band_scale(h1: torch.Tensor, i: int, th: int) -> torch.Tensor:
    """(N,) scale of band ``i``: the abs-max of h1 over the band's rows and
    four halo rows each side (those inside the image) over 127."""
    h = h1.shape[1]
    rows = h1[:, max(i * th - 4, 0):min(i * th + th + 4, h)]
    return _over_127(rows.float().amax((1, 2, 3)))


def _out_scale(out_abs_max: float) -> Tuple[float, float]:
    """(scale, inverse scale) of an emitted s8 output."""
    s = max(float(out_abs_max) / 127.0, 1e-12)
    return s, 1.0 / s


def int8_stage_reference(parts, block_params, spade_params, head=None,
                         calib_key: Optional[str] = None,
                         out_abs_max: Optional[float] = None,
                         th: Optional[int] = None, intermediates: bool = False):
    """The int8 stage in plain PyTorch, step by step as the kernel computes
    it. ``parts``: NHWC tensors or :class:`QTensor`\\ s; the parameter
    bundles as in :func:`ops.stage_kernel.fused_stage_reference`.
    ``calib_key`` names the stage's calibrated input ranges; with
    ``out_abs_max`` the output leaves as a :class:`QTensor` at that range
    (no folded head then); ``th`` is the band height (:func:`band_rows` by
    default). With ``intermediates`` returns ``(out, h1, y)``."""
    parts = as_parts(parts)
    if out_abs_max is not None and head is not None:
        raise ValueError("a stage with the folded head emits logits, not s8")
    dev = parts[0].device
    chans = tuple(p.shape[-1] for p in parts)
    qparts, scales, dtype = _quantize_parts(parts, calib_key, quantize_reference)
    folded = fold_block(block_params)
    wq1, d1, wqs, ds = fold_input_scales(folded, chans, scales, dev)
    n, h, w = qparts[0].shape[:3]
    th = band_rows(h) if th is None else th
    if h % th:
        raise ValueError(f"band height {th} does not divide H = {h}")

    acc1 = int_conv(qparts, [_oihw3x3(r) for r in wq1], 1).float()
    h1 = torch.relu(acc1 * d1 + folded["t1"]).to(dtype)
    accs = int_conv(qparts, [r[:, :, None, None] for r in wqs], 0).float() * ds
    wq2 = _oihw3x3(folded["wq2"])
    bands = []
    for i in range(h // th):
        s = _band_scale(h1, i, th)[:, None, None, None]
        a0, a1 = max(i * th - 1, 0), min(i * th + th + 1, h)
        qh = _round_clip(h1[:, a0:a1].float() / s)
        acc2 = int_conv((qh,), (wq2,), 1)[:, i * th - a0:i * th - a0 + th].float()
        bands.append(acc2 * (folded["d2"] * s) + accs[:, i * th:i * th + th] + folded["t2"])
    y = torch.relu(torch.cat(bands, 1)).to(dtype)

    out = spade_tail_reference(y, spade_params, head)[0]
    if out_abs_max is not None:
        s_out, inv = _out_scale(out_abs_max)
        out = QTensor(_round_clip(out.float() * _f32(inv, dev)), s_out, dtype)
    return (out, h1, y) if intermediates else out


# ---------------------------------------------------------------------------
# The fused stage: CUDA kernel. Launches A and B run on the s8 conv core
# (csrc/int8_conv.cuh); below, its operands, its per-launch plain versions
# and the wrappers, then the whole stage.
# ---------------------------------------------------------------------------

# The N of launch A's instantiations (the output channels padded up to one)
# and of launch B's N blocks: B keeps two s32 sums (the 3×3's and the
# shortcut's), so its blocks are at most 128 channels wide (256 run as two).
S8_NT_H1 = (64, 128, 192, 256)
S8_NT_Y = (64, 128)
S8_GROUP = 16  # s8 channels of one K core matrix (16 bytes)


def s8_nt(cout: int, launch: str) -> Tuple[int, int]:
    """(N, N blocks) of the s8 conv core for ``cout`` output channels:
    launch ``"h1"`` (A) one block of the smallest N in ``S8_NT_H1`` that
    holds them, launch ``"y"`` (B) blocks of 64 or 128."""
    if launch == "h1":
        for nt in S8_NT_H1:
            if cout <= nt:
                return nt, 1
        raise ValueError(f"the s8 conv core takes at most {S8_NT_H1[-1]} output channels, "
                         f"got {cout}")
    nt = S8_NT_Y[0] if cout <= S8_NT_Y[0] else S8_NT_Y[1]
    return nt, -(-cout // nt)


def s8_conv_weight(segments, nt: int, nblk: int = 1) -> torch.Tensor:
    """The s8 conv core's weight operand [nblk·steps][nt/8][2][8][16] in the
    order its wgmma descriptor reads it: N block by N block (output channels
    b·nt ..), the ``eval_conv_weight`` order with 16-channel groups — per
    K-segment (an s8 OIHW weight), per chunk of 16, 32 or 64 input channels,
    per k32 step of two (tap, 16-channel group) pairs, the step's K-major
    core matrices (8 output channels × 16 K values, the two K halves side
    by side); zeros past each segment's channels, the block's channels and
    the chunk's last pair."""
    return torch.cat([eval_conv_weight([w[b * nt:(b + 1) * nt] for w in segments], nt,
                                       torch.int8, S8_GROUP) for b in range(nblk)])


def pack_s8_conv(segments, launch: str) -> dict:
    """One launch's weight operand: ``segments`` are the s8 OIHW weights of
    its K-segments in the kernel's K order (launch ``"h1"``: conv1's 3×3 per
    part; ``"y"``: the shortcut's 1×1 per part, then conv2's 3×3, summed
    apart), kept for the plain versions."""
    cout = segments[0].shape[0]
    nt, nblk = s8_nt(cout, launch)
    w = s8_conv_weight(segments, nt, nblk)
    return {"w": w, "nt": nt, "nblk": nblk, "steps": w.shape[0] // nblk, "cout": cout,
            "segs": tuple((s.shape[1], s.shape[2]) for s in segments), "oihw": tuple(segments)}


def s8_conv1_reference(qparts, conv: dict, d1, t1, dtype=torch.bfloat16):
    """Launch A in plain PyTorch: ``(h1, rowmax)``, h1 =
    relu(f32(conv3x3_s8(qx))·d1 + t1) in ``dtype`` (exact integer sums,
    :func:`int_conv`), rowmax (N, H) f32 the maximum of each image row of
    h1."""
    acc = int_conv(qparts, conv["oihw"], 1).float()
    h1 = torch.relu(acc * d1 + t1).to(dtype)
    return h1, h1.float().amax((2, 3))


def band_quant_reference(h1, rowmax, th: int):
    """Launch Q in plain PyTorch: ``(q(h1), band scales)``, the band-local
    s8 buffer (N, H/th, th + 2, W, C) (band b's rows b·th − 1 .. b·th + th,
    zeros outside the image) and the scales (N, H/th) from the row maxima
    of the band's rows and four halo rows each side."""
    n, h, w, c = h1.shape
    nb = h // th
    qh1 = torch.zeros((n, nb, th + 2, w, c), dtype=torch.int8, device=h1.device)
    scales = []
    for i in range(nb):
        s = _over_127(rowmax[:, max(i * th - 4, 0):min(i * th + th + 4, h)].amax(1))
        a0, a1 = max(i * th - 1, 0), min(i * th + th + 1, h)
        qh1[:, i, a0 - i * th + 1:a1 - i * th + 1] = _round_clip(
            h1[:, a0:a1].float() / s[:, None, None, None])
        scales.append(s)
    return qh1, torch.stack(scales, 1)


def s8_conv2_reference(qh1, bandscale, qparts, conv: dict, d2, ds, t2, dtype=torch.bfloat16):
    """Launch B in plain PyTorch: y = relu(f32(conv3x3_s8(q_b(h1)))·(d2·s_b)
    + f32(conv1x1_s8(qx))·ds + t2) in ``dtype``, band by band of the
    band-local buffer ``qh1`` (:func:`band_quant_reference`), each f32 step
    rounded in the kernel's order."""
    nb, th = qh1.shape[1], qh1.shape[2] - 2
    wsc, w2 = conv["oihw"][:-1], conv["oihw"][-1]
    accs = int_conv(qparts, wsc, 0).float() * ds
    bands = []
    for i in range(nb):
        acc2 = int_conv((qh1[:, i],), (w2,), 1)[:, 1:th + 1].float()
        s = bandscale[:, i][:, None, None, None]
        bands.append(acc2 * (d2 * s) + accs[:, i * th:(i + 1) * th] + t2)
    return torch.relu(torch.cat(bands, 1)).to(dtype)


def _s8_sources(sources, conv: dict):
    """The parts' (pointer, channels) pairs after checking them against the
    packed operands (``conv["segs"]``: the parts' widths, then launch B's
    3×3 segment)."""
    segs = conv["segs"][:len(sources)]
    if tuple(s.shape[-1] for s in sources) != tuple(c for c, _ in segs):
        raise ValueError(f"the conv's weights are packed for {conv['segs']}, got parts of "
                         f"{[tuple(s.shape) for s in sources]}")
    if len(sources) > 2:
        raise ValueError(f"the s8 conv core takes at most 2 parts, got {len(sources)}")
    src = [(s.data_ptr(), s.shape[-1]) for s in sources] + [(None, 0)] * (2 - len(sources))
    return [v for p in src for v in p]


def s8_conv1(qparts, conv: dict, d1, t1):
    """Launch A on the card: ``(h1, rowmax)`` as :func:`s8_conv1_reference`
    (bf16 h1), from contiguous s8 NHWC CUDA parts and :func:`pack_s8_conv`'s
    ``"h1"`` operand. Counts ``conv_launches``."""
    global conv_launches
    n, h, w = qparts[0].shape[:3]
    dev = qparts[0].device
    h1 = torch.empty((n, h, w, conv["cout"]), dtype=torch.bfloat16, device=dev)
    rowmax = torch.zeros((n, h), dtype=torch.float32, device=dev)
    _check(_lib().ssu_s8_conv1(*_s8_sources(qparts, conv), conv["nt"], _ptr(conv["w"]),
                               conv["steps"], _ptr(d1), _ptr(t1), _ptr(h1),
                               _ptr(rowmax), n, h, w, conv["cout"],
                               torch.cuda.current_stream(dev).cuda_stream), "conv1")
    conv_launches += 1
    return h1, rowmax


def band_quant(h1, rowmax, th: int):
    """Launch Q on the card: ``(q(h1), band scales)`` as
    :func:`band_quant_reference`."""
    n, h, w, c = h1.shape
    qh1 = torch.empty((n, h // th, th + 2, w, c), dtype=torch.int8, device=h1.device)
    bandscale = torch.empty((n, h // th), dtype=torch.float32, device=h1.device)
    _check(_lib().ssu_q_band(_ptr(h1), _ptr(rowmax), _ptr(qh1), _ptr(bandscale), n, h, w, c, th,
                             torch.cuda.current_stream(h1.device).cuda_stream),
           "band quantization")
    return qh1, bandscale


def s8_conv2(qh1, bandscale, qparts, conv: dict, d2, ds, t2):
    """Launch B on the card: y as :func:`s8_conv2_reference` (bf16), from
    :func:`band_quant`'s buffer and scales, the s8 parts and
    :func:`pack_s8_conv`'s ``"y"`` operand. Counts ``conv_launches``."""
    global conv_launches
    n, nb, th, w, c = qh1.shape
    th -= 2
    y = torch.empty((n, nb * th, w, conv["cout"]), dtype=torch.bfloat16, device=qh1.device)
    if conv["segs"][-1] != (c, 3) or len(conv["segs"]) != len(qparts) + 1:
        raise ValueError(f"the conv's weights are packed for {conv['segs']}, got q(h1) of {c}")
    _check(_lib().ssu_s8_conv2(*_s8_sources(qparts, conv), _ptr(qh1), c, th, conv["nt"],
                               _ptr(conv["w"]), conv["steps"], conv["nblk"], _ptr(d2), _ptr(ds),
                               _ptr(t2), _ptr(bandscale), _ptr(y), n, nb * th, w, conv["cout"],
                               torch.cuda.current_stream(qh1.device).cuda_stream), "conv2")
    conv_launches += 1
    return y


def pack_stage_int8(block_params, spade_params, head, dtype) -> dict:
    """The operands of the CUDA stage that do not depend on the input
    scales (kept by a caller whose weights are fixed): the folded block and
    the SPADE tail's operands."""
    pk = fold_block(block_params)
    pk["dtype"] = dtype
    pk.update(pack_spade(spade_params, head, dtype))
    pk["_scaled"] = None  # (static scales, operands) of the last static call
    return pk


def _scaled_operands(pk: dict, chans, scales, dev) -> dict:
    """Launch A's and B's s8 operands for these input scales
    (:func:`pack_s8_conv`). Static scales (Python floats) make them a
    per-model constant, kept on ``pk``; dynamic ones are rebuilt on the
    device every call (no host sync)."""
    static = all(not isinstance(s, torch.Tensor) for s in scales)
    key = (tuple(chans), tuple(scales)) if static else None
    if static and pk["_scaled"] is not None and pk["_scaled"][0] == key:
        return pk["_scaled"][1]
    wq1, d1, wqs, ds = fold_input_scales(pk, chans, scales, dev)
    ops = {
        "conv1": pack_s8_conv([_oihw3x3(r) for r in wq1], "h1"),
        "conv2": pack_s8_conv([r[:, :, None, None] for r in wqs] + [_oihw3x3(pk["wq2"])], "y"),
        "d1": d1.contiguous(), "ds": ds.contiguous(),
    }
    if static:
        pk["_scaled"] = (key, ops)
    return ops


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.ssu_q_absmax.argtypes = [p, ll, i, p, p, p]
    lib.ssu_q_quant.argtypes = [p, ll, i, p, f, p, p]
    lib.ssu_s8_conv1.argtypes = [p, i, p, i, i, p, i, p, p, p, p, i, i, i, i, p]
    lib.ssu_q_band.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.ssu_s8_conv2.argtypes = [p, i, p, i, p, i, i, i, p, i, i, p, p, p, p, p, i, i, i, i, p]
    lib.ssu_q_spade_tail.argtypes = [p, i, i, i, i, p, p, i, p, p, i, p, p, p, p, i, p, p, f, p]
    for fn in (lib.ssu_q_absmax, lib.ssu_q_quant, lib.ssu_s8_conv1, lib.ssu_q_band,
               lib.ssu_s8_conv2, lib.ssu_q_spade_tail):
        fn.restype = i
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"int8 fused stage {what} launch failed: cudaError {err}")


def _run_cuda(qparts, scales, dtype, pk: dict, th: int, out_abs_max, intermediates: bool):
    global launches
    q0 = qparts[0]
    dev = q0.device
    if len(qparts) > 2:
        raise ValueError(f"the fused stage takes at most 2 parts, got {len(qparts)}")
    n, h, w = q0.shape[:3]
    for q in qparts:
        if q.device != dev or q.dtype != torch.int8 or q.dim() != 4:
            raise ValueError("quantized stage parts must be 4-D NHWC int8 tensors of one device")
        if tuple(q.shape[:3]) != (n, h, w):
            raise ValueError(f"stage parts differ in N, H or W: {[tuple(t.shape) for t in qparts]}")
        if not q.is_contiguous():
            raise ValueError("stage parts must be contiguous NHWC tensors")
    if pk["dtype"] != dtype:
        raise ValueError(f"packed operands are for {pk['dtype']} activations, got {dtype}")
    for t in pk.values():
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError("stage weights must lie on the parts' device")
    chans = tuple(q.shape[-1] for q in qparts)
    if pk["k1f"].shape[1] != sum(chans):
        raise ValueError(f"packed operands are for {pk['k1f'].shape[1]} input channels, "
                         f"got parts of {chans}")
    c = pk["wq2"].shape[0]
    ncls = tail_widths(pk)[2]
    if h % th:
        raise ValueError(f"band height {th} does not divide H = {h}")
    if out_abs_max is not None and ncls:
        raise ValueError("a stage with the folded head emits logits, not s8")
    ops = _scaled_operands(pk, chans, scales, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        h1, rowmax = s8_conv1(qparts, ops["conv1"], ops["d1"], pk["t1"])
        qh1, bandscale = band_quant(h1, rowmax, th)
        y = s8_conv2(qh1, bandscale, qparts, ops["conv2"], pk["d2"], ops["ds"], pk["t2"])
        out = out_q = None
        inv = 0.0
        if out_abs_max is None:
            out = torch.empty((n, h, w, ncls or c), dtype=dtype, device=dev)
        else:
            s_out, inv = _out_scale(out_abs_max)
            out_q = torch.empty((n, h, w, c), dtype=torch.int8, device=dev)
        _check(_lib().ssu_q_spade_tail(_ptr(y), n, h, w, c, *tail_args(pk), _ptr(out),
                                       _ptr(out_q), inv, stream), "SPADE tail")
    launches += 1
    if out_q is not None:
        out = QTensor(out_q, s_out, dtype)
    return (out, h1, y) if intermediates else out


def fused_eval_stage_int8(parts, block_params, spade_params, head=None,
                          calib_key: Optional[str] = None,
                          out_abs_max: Optional[float] = None,
                          th: Optional[int] = None, packed: Optional[dict] = None,
                          intermediates: bool = False):
    """int8 eval [BasicBlock + self-SPADE] stage (+ folded head), NHWC.

    Arguments as in :func:`int8_stage_reference`; ``packed``, if given, is
    :func:`pack_stage_int8` of the same weights, which spares the CUDA path
    its packing. The stage inputs are quantized here by
    :func:`quantize_tensor` (static calibrated scales, else dynamic
    per-tensor ones; a :class:`QTensor` arrives quantized). CPU tensors run
    the plain version;
    CUDA tensors run the hand-written kernel, or raise for what
    :func:`ops.stage_kernel.stage_supported` refuses."""
    parts = as_parts(parts)
    dev = parts[0].device
    if dev.type == "cpu":
        return int8_stage_reference(parts, block_params, spade_params, head, calib_key,
                                    out_abs_max, th, intermediates)
    if dev.type == "cuda":
        dtype = parts[0].dtype
        if dtype != torch.bfloat16:
            raise TypeError(f"the CUDA int8 stage takes bfloat16 activations, got {dtype}")
        widths = (block_params[2].shape[0], spade_params[0].shape[0],
                  spade_params[2].shape[0], 0 if head is None else head[0].shape[0])
        if not stage_supported(parts, *widths, int8=True):
            raise _refused(parts, *widths, int8=True)
        qparts, scales, _ = _quantize_parts(parts, calib_key)
        if packed is None:
            packed = pack_stage_int8(block_params, spade_params, head, dtype)
        th = band_rows(parts[0].shape[1]) if th is None else th
        return _run_cuda(qparts, scales, dtype, packed, th, out_abs_max, intermediates)
    raise ValueError(f"int8 fused stage has no path for device {dev}")
