"""Fused eval-mode [Bottleneck + self-SPADE] stage: CUDA kernel and plain version.

Replaces the TPU kernel ``ssunet_gan_tpu/ops/stage_kernel.py``
``fused_eval_stage_bneck`` (:1603 → ``_bneck_call`` :1694 →
``pl.pallas_call`` :1761, body ``_make_bneck_kernel`` :1335 with
``ops/spade_kernel.py`` ``_spade_tail``); the JAX package keeps it inside
its stage-kernel module, the port gives it a module of its own. For a stage
with parts x = (skip[, up]), NHWC and of one H×W, and every BatchNorm
folded into its weights:

    h1  = relu(conv1x1(x; K1·s1) + t1)
    h2  = relu(conv3x3(h1; K2·s2) + t2)
    y   = relu(conv1x1(h2; K3·s3) + shortcut(x) + (t3 + ts))
    out = self-SPADE tail of y          [logits = conv1x1(out; Kf) + bf]

with ``shortcut(x) = conv1x1(x; Ks·ss)`` or, for ``in_planes == planes``,
x itself (the parts' concatenation; then ``ts = 0``).

What bounds it on the H100: only conv2 sits above the bf16 ridge point;
the 1×1 convs are bound by the bytes of their inputs and outputs, so at
64-256 planes the stage is bound by the activations it moves. The kernel
(``csrc/bneck_stage.cu``) runs the three convs on the eval conv core of
``csrc/eval_conv.cuh`` (``wgmma`` over a spatial tile with every output
channel of its N block, the 512-plane stages that ``set_pack_max_planes``
admits in two blocks of 256; the 1×1 launches load no halo, so each input
pixel is read once per N block and each output written once), a 1×1 conv
being a K-segment of one tap;
conv3 and the shortcut are K-segments of one sum, so they share one
accumulator and one rounding. Four launches from one host call; h1, h2
and y go through device memory, the tail's seg, act and γ|β stay on chip.
A decoder part marked ``up`` is the half-height tensor after its
W-interpolation (``ops/resize.py`` ``upsample_w``), interpolated along H
while conv1's and the shortcut's windows load (the TPU kernel's
``_upsample_on_read`` at its 4-row halo, :1368; ``csrc/eval_conv.cuh``
read mode 1), so the full-resolution up tensor is never written. The TPU
devices (W-minor layout, lane packing, band heights and their probe cache,
halo carry, stacked seg dots, lookahead grids) answer the TPU's constraints
and are not ported.

Numerics match the TPU kernel: the BN scales are folded into the weights
in f32, then weights and biases are rounded to the activation dtype;
``t3 + ts`` is added in f32 and rounded once; each conv zero-pads its own
input at the image border (h1 outside the image is 0, not relu(t1)); sums
run in f32; h1, h2, y and the tail's intermediates are rounded to the
activation dtype.

The f32 route (kernel 8f): the TPU kernel takes the activation dtype, so
an f32 evaluation (the trainers' val and test passes) runs it in f32. On
the card such a stage runs as six or seven launches of the f32 conv core
of kernel 1f (``csrc/f32_conv.cuh`` through ``csrc/fused_stage_f32.cu``:
3xTF32 on ``mma.sync``, up to three K-segments of 3×3 or 1×1): conv1 1×1
over the parts, conv2 3×3, conv3 1×1 over h2 with the shortcut's 1×1
segments over the parts in the same sum (the identity shortcut as a unit
weight per part, as the TPU kernel's ``jnp.eye`` columns, :1636), then
seg, act and γ|β with the modulate [and the head] as
``ops/stage_kernel.py`` ``f32_tail_launches``. BN is folded in f32
(:func:`pack_stage_bneck_f32`); up seams are materialized first.

:func:`bneck_supported` is the one gate: the model's dispatch and the
wrapper both call it. :func:`fused_eval_stage_bneck` decides by the
tensors' device: CPU tensors take :func:`fused_bneck_reference`; CUDA
tensors launch the kernel (bf16) or its f32 route, or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops.conv import as_parts, conv2d_nhwc
from ssunet_gan_tpu_torch.ops.resize import up_weights_exact
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    TAIL_MAX_CLS,
    TAIL_MAX_HIDDEN,
    TAIL_MAX_LAB,
    _ptr,
    _q,
    f32_conv,
    f32_conv_reference,
    f32_tail_launches,
    materialize_seams,
    pack_eval_conv,
    pack_f32_conv,
    pack_spade,
    pack_spade_f32,
    packed_tensors,
    seam_modes,
    seam_shape,
    spade_tail_reference,
    split_in,
    tail_args,
    tail_widths,
)

SOURCE = "bneck_stage.cu"
REPLACES = "ssunet_gan_tpu/ops/stage_kernel.py:1603"  # fused_eval_stage_bneck
# the f32 route (kernel 8f) launches kernel 1f's conv core
SOURCE_F32 = stage_kernel.SOURCE_F32

# Fused bottleneck stages run on the card, one per stage (four CUDA launches
# each); the up seams they read count in ``stage_kernel.up_reads``.
launches = 0
# f32 stages run on the card (kernel 8f), one per stage; their conv launches
# (six per stage, seven with the head) count in ``stage_kernel.f32_conv_launches``
f32_launches = 0

# the kernel's planes multiple (csrc/stage_common.cuh: the tail's channel
# chunk); the planes limit is the one gate's (``stage_kernel.max_planes``),
# label, hidden and class bounds are the tail's (stage_kernel.TAIL_MAX_*)
PLANES_MULTIPLE = 32


def bneck_supported(parts, planes: int, labels: int, hidden: int, classes: int = 0, *,
                    up=None) -> bool:
    """Whether the fused bottleneck stage takes this stage: at most two NHWC
    parts of one logical N×H×W, device and dtype, planes ≤
    ``stage_kernel.max_planes()`` (256, or up to ``set_pack_max_planes``'
    value: JAX ``fused_bneck_supported`` asks ``fused_stage_supported`` with
    ``pack=True``, :1593), labels ≤ 8, head classes ≤ 8; an ``up`` part (a
    bool per part) bf16 with an exact half height (``ops/resize.py`` ``up_weights_exact``), its logical
    height twice its own; on a CUDA device also planes a multiple of 32,
    hidden within the tail's ``TAIL_MAX_HIDDEN`` and bfloat16 (the kernel's
    terms; the plain version on the CPU has none of them, and like the JAX
    gate no hidden term), or float32 with contiguous parts for the f32 route
    (kernel 8f), which has no width limits but the planes limit (an up part
    is bf16, so f32 seams are materialized). What it refuses runs the
    module composition."""
    parts = as_parts(parts)
    x0 = parts[0]
    if not 1 <= len(parts) <= 2 or any(p.dim() != 4 for p in parts):
        return False
    modes = seam_modes(len(parts), up)
    if any(m and (p.dtype != torch.bfloat16 or not up_weights_exact(p.shape[1]))
           for p, m in zip(parts, modes)):
        return False
    shape = seam_shape(x0, modes[0])
    if any(seam_shape(p, m) != shape or p.device != x0.device or p.dtype != x0.dtype
           for p, m in zip(parts, modes)):
        return False
    if planes > stage_kernel.max_planes():
        return False
    if x0.device.type == "cuda" and x0.dtype == torch.float32:
        return all(p.is_contiguous() for p in parts)
    if labels > TAIL_MAX_LAB or classes > TAIL_MAX_CLS:
        return False
    if x0.device.type == "cuda":
        return (planes % PLANES_MULTIPLE == 0 and hidden <= TAIL_MAX_HIDDEN
                and x0.dtype == torch.bfloat16)
    return x0.device.type == "cpu"


def _folded(block_params, dtype):
    """The three convs' weights with their BN scales folded in (f32, then
    rounded to ``dtype``), the shortcut's likewise (None for the identity),
    and the three biases rounded to ``dtype`` (``t3 + ts`` summed in f32
    first), all as f32 tensors."""
    w1, (s1, t1), w2, (s2, t2), w3, (s3, t3), ws, asb = block_params

    def fold(w, s):
        return _q(w.float() * s.float()[:, None, None, None], dtype)

    wsf, b3 = None, t3.float()
    if ws is not None:
        ss, ts = asb
        wsf, b3 = fold(ws, ss), b3 + ts.float()
    return (fold(w1, s1), fold(w2, s2), fold(w3, s3), wsf,
            _q(t1, dtype), _q(t2, dtype), _q(b3, dtype))


def fused_bneck_reference(parts, block_params, spade_params, head=None):
    """The stage in plain PyTorch (``F.conv2d``), with the kernel's numerics:
    f32 sums over inputs and weights rounded to the activation dtype,
    conv3 and the shortcut in one f32 sum, intermediates rounded to the
    dtype. NHWC in and out.

    ``block_params``: ``(w1, (s1, t1), w2, (s2, t2), w3, (s3, t3), ws,
    (ss, ts))`` — OIHW weights and folded BN affines, ``ws`` and ``(ss,
    ts)`` None for the identity shortcut (:meth:`ops.blocks.Bottleneck
    .stage_params`). ``spade_params`` and ``head`` as in
    :func:`ops.stage_kernel.fused_stage_reference`.

    On the card, compare with TF32 off (``torch.backends.cudnn.allow_tf32``)
    or the f32 convs lose ~3 digits."""
    parts = as_parts(parts)
    dtype = parts[0].dtype
    k1, k2, k3, ks, b1, b2, b3 = _folded(block_params, dtype)
    xs = tuple(p.float() for p in parts)
    h1 = torch.relu(conv2d_nhwc(xs, k1) + b1).to(dtype)
    h2 = torch.relu(conv2d_nhwc(h1.float(), k2, padding=1) + b2).to(dtype)
    y = conv2d_nhwc(h2.float(), k3) + b3
    if ks is not None:
        y = y + conv2d_nhwc(xs, ks)
    else:
        if sum(x.shape[-1] for x in xs) != k3.shape[0]:
            raise ValueError("an identity shortcut needs parts of planes channels in all")
        y = y + (xs[0] if len(xs) == 1 else torch.cat(xs, -1))
    y = torch.relu(y).to(dtype)
    return spade_tail_reference(y, spade_params, head)[0]


def _shortcut(part_channels, ks, like: torch.Tensor):
    """The shortcut's 1×1 weight, or for the identity a unit matrix (exact
    in bf16, and split by the f32 route into 1 and 0)."""
    if ks is not None:
        return ks
    planes = like.shape[0]
    if sum(part_channels) != planes:
        raise ValueError("an identity shortcut needs parts of planes channels in all")
    return torch.eye(planes, dtype=like.dtype, device=like.device)[:, :, None, None]


def pack_stage_bneck(part_channels, block_params, spade_params, head, dtype) -> dict:
    """Fold BN into the weights and lay every operand out for the kernel:
    the three convs' operands (``ops/stage_kernel.py`` ``pack_eval_conv``):
    ``conv1`` over the parts, ``conv2`` over h1, ``conv3`` over h2 then the
    parts through the shortcut's weight or, for the identity, a unit matrix
    (exact in bf16); each with its f32 bias (``t3 + ts`` summed in f32 and
    rounded once). The result depends on the weights alone, so a caller
    whose weights are fixed (eval) makes it once and hands it to
    :func:`fused_eval_stage_bneck` as ``packed``."""
    part_channels = tuple(part_channels)
    k1, k2, k3, ks, b1, b2, b3 = _folded(block_params, dtype)
    ks = _shortcut(part_channels, ks, k3)
    packed = {
        "channels": part_channels, "dtype": dtype,
        "conv1": pack_eval_conv(split_in(k1, part_channels), b1, dtype),
        "conv2": pack_eval_conv([k2], b2, dtype),
        "conv3": pack_eval_conv([k3] + split_in(ks, part_channels), b3, dtype, main=1),
    }
    packed.update(pack_spade(spade_params, head, dtype))
    return packed


def pack_stage_bneck_f32(part_channels, block_params, spade_params, head) -> dict:
    """The f32 route's operands of a stage (arguments as
    :func:`fused_bneck_reference`), each conv packed by ``ops/stage_kernel.py``
    ``pack_f32_conv`` (BN folded in f32, the weights split into TF32 big and
    small parts once): ``conv1`` 1×1 over the parts with t1 and ReLU,
    ``conv2`` 3×3 with t2 and ReLU, ``conv3`` 1×1 over h2 and the
    shortcut's 1×1 segments over the parts (a unit weight for the identity)
    in one sum with ``t3 + ts`` and ReLU; the tail as ``pack_spade_f32``."""
    part_channels = tuple(part_channels)
    k1, k2, k3, ks, b1, b2, b3 = _folded(block_params, torch.float32)
    ks = _shortcut(part_channels, ks, k3)
    return {
        "route": "f32", "channels": part_channels, "dtype": torch.float32,
        "conv1": pack_f32_conv(split_in(k1, part_channels), b1, True),
        "conv2": pack_f32_conv([k2], b2, True),
        "conv3": pack_f32_conv([k3] + split_in(ks, part_channels), b3, True),
        **pack_spade_f32(spade_params, head),
    }


def f32_bneck_launches(parts, pk: dict, conv=f32_conv_reference) -> torch.Tensor:
    """A stage as the f32 route runs it, launch by launch (``conv``: the
    CUDA launch ``stage_kernel.f32_conv``, or by default its plain version):
    conv1, conv2, conv3 with the shortcut's segments, then the tail
    (``stage_kernel.f32_tail_launches``)."""
    parts = tuple(parts)
    h2 = conv((conv(parts, pk["conv1"]),), pk["conv2"])
    y = conv((h2,) + parts, pk["conv3"])
    return f32_tail_launches(y, pk, conv)


def _run_cuda_f32(parts: Tuple[torch.Tensor, ...], pk: dict, up=None) -> torch.Tensor:
    global f32_launches
    c = pk["conv2"]["cout"]
    if not bneck_supported(parts, c, pk["seg"]["cout"], pk["act"]["cout"],
                           0 if pk["head"] is None else pk["head"]["cout"], up=up):
        raise ValueError(f"the f32 route does not take this bottleneck stage (bneck_supported): "
                         f"parts {[(tuple(p.shape), p.dtype) for p in parts]}, planes={c} "
                         f"(<= {stage_kernel.max_planes()}), up={up}: f32, contiguous, seams "
                         f"materialized")
    if pk["channels"] != tuple(p.shape[-1] for p in parts):
        raise ValueError(f"packed operands are for parts of {pk['channels']} channels, got "
                         f"{[tuple(p.shape) for p in parts]}")
    if any(t.device != parts[0].device for t in packed_tensors(pk)):
        raise ValueError("stage weights must lie on the parts' device")
    with torch.cuda.device(parts[0].device):
        out = f32_bneck_launches(parts, pk, f32_conv)
    f32_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_bneck_stage.argtypes = [p, i, i, p, i, i, i, i, i, i, i, p, i, p, p, i, p, p, i,
                                    p, p, p, p, p, p, i, p, p, i, p, p, p, p, i, p, p]
    lib.ssu_bneck_stage.restype = i
    return lib


def _run_cuda(parts: Tuple[torch.Tensor, ...], pk: dict, up=None) -> torch.Tensor:
    global launches
    x0 = parts[0]
    dev, dtype = x0.device, x0.dtype
    modes = seam_modes(len(parts), up) + (0,)
    n, h, w = seam_shape(x0, modes[0])
    c = pk["conv2"]["cout"]
    lab, nh, ncls = tail_widths(pk)
    if not bneck_supported(parts, c, lab, nh, ncls, up=up):
        raise ValueError(
            f"the CUDA bottleneck stage does not take this stage: parts "
            f"{[(tuple(p.shape), p.dtype) for p in parts]}, planes={c} (a multiple of "
            f"{PLANES_MULTIPLE}, <= {stage_kernel.max_planes()}: set_pack_max_planes), "
            f"labels={lab} (<= {TAIL_MAX_LAB}), "
            f"hidden={nh} (<= {TAIL_MAX_HIDDEN}), classes={ncls} (<= {TAIL_MAX_CLS}); "
            f"bfloat16 only; up={up} (an exact half height)")
    if any(not p.is_contiguous() for p in parts):
        raise ValueError("stage parts must be contiguous NHWC tensors")
    if pk["channels"] != tuple(p.shape[-1] for p in parts) or pk["dtype"] != dtype:
        raise ValueError(f"packed operands are for parts of {pk['channels']} channels "
                         f"in {pk['dtype']}, got {[tuple(p.shape) for p in parts]} {dtype}")
    if any(t.device != dev for t in packed_tensors(pk)):
        raise ValueError("stage weights must lie on the parts' device")
    x1 = parts[1] if len(parts) > 1 else None
    with torch.cuda.device(dev):
        h1, h2, y = (torch.empty((n, h, w, c), dtype=dtype, device=dev) for _ in range(3))
        out = torch.empty((n, h, w, ncls or c), dtype=dtype, device=dev)
        err = _lib().ssu_bneck_stage(
            x0.data_ptr(), x0.shape[-1], modes[0], _ptr(x1), 0 if x1 is None else x1.shape[-1],
            modes[1], n, h, w, c, pk["conv2"]["nt"], _ptr(pk["conv1"]["w"]), pk["conv1"]["steps"],
            _ptr(pk["conv1"]["bias"]), _ptr(pk["conv2"]["w"]), pk["conv2"]["steps"],
            _ptr(pk["conv2"]["bias"]), _ptr(pk["conv3"]["w"]), pk["conv3"]["steps"],
            _ptr(pk["conv3"]["bias"]),
            _ptr(h1), _ptr(h2), _ptr(y), *tail_args(pk), _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused bottleneck stage launch failed: cudaError {err}")
    launches += 1
    stage_kernel.up_reads += modes.count(1)
    return out


def fused_eval_stage_bneck(parts, block_params, spade_params, head=None,
                           packed: Optional[dict] = None, up=None) -> torch.Tensor:
    """Eval [Bottleneck + self-SPADE] stage (+ folded head), NHWC in/out.

    Arguments as in :func:`fused_bneck_reference`; ``packed``, if given, is
    :func:`pack_stage_bneck` of the same weights (for f32 CUDA parts
    :func:`pack_stage_bneck_f32`), which spares the CUDA path its packing;
    ``up`` (a bool per part) marks decoder seams, each the half-height
    tensor after its W-interpolation. CPU tensors run the plain version on
    ``stage_kernel.materialize_seams``' parts; CUDA tensors run the
    hand-written kernel, which reads the seams (f32 ones its f32 route,
    which reads none), or raise for what :func:`bneck_supported` refuses."""
    parts = as_parts(parts)
    dev = parts[0].device
    if dev.type == "cpu":
        return fused_bneck_reference(materialize_seams(parts, up), block_params, spade_params,
                                     head)
    if dev.type == "cuda" and parts[0].dtype == torch.float32:
        if packed is None or packed.get("route") != "f32":
            packed = pack_stage_bneck_f32(tuple(p.shape[-1] for p in parts), block_params,
                                          spade_params, head)
        return _run_cuda_f32(parts, packed, up)
    if dev.type == "cuda":
        if packed is None:
            packed = pack_stage_bneck(tuple(p.shape[-1] for p in parts), block_params,
                                      spade_params, head, parts[0].dtype)
        return _run_cuda(parts, packed, up)
    raise ValueError(f"fused bottleneck stage has no path for device {dev}")
