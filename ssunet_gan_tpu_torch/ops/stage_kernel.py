"""Fused eval-mode [BasicBlock + self-SPADE] stage: CUDA kernel and plain version.

Replaces the TPU kernel ``ssunet_gan_tpu/ops/stage_kernel.py``
``fused_eval_stage`` (→ ``_stage_call`` → ``pl.pallas_call``, body
``_make_kernel`` with ``ops/spade_kernel.py`` ``_spade_tail``). For a stage
with parts x = (skip[, up]), NHWC and of one H×W, and BatchNorm folded into
the weights:

    h1  = relu(conv3x3(x; K1·s1) + t1)
    y   = relu(conv3x3(h1; K2·s2) + t2 + conv1x1(x; Ks))
    seg = conv3x3(y; Kx2map) + b
    act = relu(conv3x3(seg; Kmlp) + b)
    γ|β = conv3x3(act; Kγ|Kβ) + b
    out = y·(1+γ) + β              [logits = conv1x1(out; Kf) + bf]

What bounds it on the H100: the two big convs carry ~95% of the
multiply-adds at an arithmetic intensity far above the bf16 ridge point, so
the stage is bound by tensor-core operations, not bytes. Both convs run on
the eval conv core (``csrc/eval_conv.cuh``, shared with kernels 8 and 3):
a block owns a spatial tile and every output channel, a chunk's halo window
arrives once through ``cp.async``, the nine taps are shifted ``wgmma``
matrix descriptors into it (m64nNk16, f32 sums), and the weights come
packed once per model (:func:`pack_eval_conv`) in the order their
descriptor reads them. The split-concat parts and the shortcut are
K-segments read through their own pointers (no ``torch.cat``);
:func:`eval_conv_reference` is one launch in plain PyTorch. A part may be
a seam, read through it while the windows load (the TPU kernel's
``_upsample_on_read`` :744 and ``_pool_on_read`` :789): with ``up`` the
decoder's half-height tensor after its W-interpolation
(``ops/resize.py`` ``upsample_w``), interpolated along H; with ``down`` an
encoder stage's full-resolution input, max-pooled 2×2; conv1's segments
and conv2's shortcut segments both read it so
(:func:`materialize_seams` is the plain version of the read). The SPADE tail
keeps seg, act and γ|β in shared memory and registers. Three launches per
stage (``csrc/fused_stage.cu``); h1 and y go through device memory. The
TPU devices (W-minor layout, lane packing, bias tiles, band probing)
answer the TPU's constraints and are not ported.

Numerics match the TPU kernel: each conv zero-pads its own input at the
image border, sums run in f32, h1/y/seg/act/γ|β are rounded to the
activation dtype, weights and biases are rounded to it too, and the
modulate runs in the activation dtype.

:func:`stage_supported` is the one gate of the BasicBlock stage kernels
(this eval stage, the train stage of ``ops/stage_kernel_train.py`` and the
int8 stage of ``ops/stage_kernel_int8.py``): the model's dispatch and the
three wrappers call it, and what it refuses runs the module composition.
:func:`set_fused_stage` turns the fused eval stages off (the JAX toggle).
:func:`fused_eval_stage` decides by the tensors' device: CPU tensors take
:func:`fused_stage_reference`; CUDA tensors launch the kernel (bf16), its
f32 route (``csrc/fused_stage_f32.cu``, f32 eval stages: the section at
the end of this module), or raise for what the gate refuses.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch import _build
from ssunet_gan_tpu_torch.ops.conv import as_parts, conv2d_nhwc
from ssunet_gan_tpu_torch.ops.resize import materialize_up, up_weights_exact

SOURCE = "fused_stage.cu"
REPLACES = "ssunet_gan_tpu/ops/stage_kernel.py:1182"  # fused_eval_stage
# the f32 route of the same TPU kernel (it takes the activation dtype)
SOURCE_F32 = "fused_stage_f32.cu"

# Fused stages run on the card, one per stage (three CUDA launches each).
launches = 0
# f32 stages run on the card (the f32 route), and their conv launches (five
# per stage, six with the folded head); the modulate rides the γ|β conv's
# epilogue, so no modulate launch is counted

f32_launches = 0
f32_conv_launches = 0
f32_modulate_launches = 0
# Seam parts the eval conv core read on the card, one per stage call and
# part (kernel 1 here, kernel 8 in ops/stage_kernel_bneck.py): decoder
# upsample seams (read mode 1) and encoder pool seams (read mode 2).
up_reads = 0
pool_reads = 0

# csrc/stage_common.cuh TAIL_MAX_LAB, TAIL_MAX_NH, TAIL_MAX_CLS: the SPADE
# tail kernel's limits (seg's and the head's N is one 8-wide MMA tile; act
# and the streamed γ|β weights fill shared memory at 64 hidden channels).
# Every gate of a kernel that ends in the tail reads them here.
TAIL_MAX_LAB, TAIL_MAX_HIDDEN, TAIL_MAX_CLS = 8, 64, 8
MAX_PLANES = 256  # the JAX gate's widest fused stage
PLANES_MULTIPLE = 32  # csrc/stage_common.cuh: the tail's channel chunk

# The fused eval stages (this one and the int8 one): on unless set to False
# (JAX ``set_fused_stage``, ssunet_gan_tpu/ops/stage_kernel.py:84, whose
# default is on for the TPU; the card's default is on).
_FUSED_STAGE: Optional[bool] = None


def set_fused_stage(enabled: Optional[bool]) -> None:
    """Fused eval stages on (True, or None: the default) or off (False:
    every BasicBlock stage of an eval forward runs the module composition,
    the int8 mode's deep s8 block)."""
    global _FUSED_STAGE
    _FUSED_STAGE = enabled


def fused_stage_enabled() -> bool:
    return _FUSED_STAGE is None or bool(_FUSED_STAGE)


def _pack_factor(n: int, w: int) -> int:
    """Images the JAX eval kernel packs side by side on its 128 lanes."""
    return 128 // w if w < 128 and 128 % w == 0 and n % (128 // w) == 0 else 1


def seam_modes(n: int, up=None, down=None) -> Tuple[int, ...]:
    """The eval conv core's read mode of each of ``n`` parts: 1 where
    ``up`` (a bool per part, or None) marks a decoder upsample seam, 2
    where ``down`` marks an encoder pool seam, else 0."""
    up = tuple(up) if up else (False,) * n
    down = tuple(down) if down else (False,) * n
    if len(up) != n or len(down) != n or any(u and d for u, d in zip(up, down)):
        raise ValueError(f"up={up} and down={down} must mark at most one seam per part "
                         f"of {n} parts")
    return tuple(1 if u else 2 if d else 0 for u, d in zip(up, down))


def seam_shape(p, mode: int) -> Tuple[int, ...]:
    """The logical N×H×W of a part read in ``mode``: mode 1 takes the
    half-height tensor to twice its height, mode 2 the full-resolution one
    to half its height and width."""
    n, h, w = p.shape[:3]
    return (n, 2 * h, w) if mode == 1 else (n, h // 2, w // 2) if mode == 2 else (n, h, w)


def materialize_seams(parts, up=None, down=None):
    """The parts as the stage reads them: each up seam through
    ``ops/resize.py`` ``materialize_up``, each pool seam through
    ``ops/pool.py`` ``max_pool_2x2`` — the plain version of the kernel's
    read modes, and what a consumer that does not read the seam takes."""
    from ssunet_gan_tpu_torch.ops.pool import max_pool_2x2

    parts = as_parts(parts)
    return tuple(materialize_up(p) if m == 1 else max_pool_2x2(p) if m == 2 else p
                 for p, m in zip(parts, seam_modes(len(parts), up, down)))


def _seam_readable(p, mode: int, int8: bool) -> bool:
    """Whether an eval stage may read part ``p`` as a seam of ``mode``: an up
    part (1) a bf16 tensor of an exact half height (``ops/resize.py``
    ``up_weights_exact``), and for the int8 stage in bands of a multiple of
    16 rows (``stage_kernel_int8.band_rows`` of its full height: the JAX
    package's int8 kernel reads half bands of whole 8-row tiles and
    resolves no band height to a stage that has none, ``resolve_band_th``);
    a pool part (2) of even height and width, bf16, or for the int8 stage a
    QTensor (any activation dtype: its pool is exact in s8)."""
    if mode == 1:
        from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import band_rows

        return (isinstance(p, torch.Tensor) and p.dtype == torch.bfloat16
                and up_weights_exact(p.shape[1])
                and (not int8 or band_rows(2 * p.shape[1]) % 16 == 0))
    return (p.shape[1] % 2 == 0 and p.shape[2] % 2 == 0
            and (p.dtype == torch.bfloat16 or (int8 and not isinstance(p, torch.Tensor))))


def stage_supported(parts, planes: int, labels: int, hidden: int, classes: int = 0, *,
                    train: bool = False, int8: bool = False, up=None, down=None) -> bool:
    """Whether the BasicBlock stage kernel that would run for these parts
    (eval, ``train`` or ``int8``) takes the stage. Always: one or two NHWC
    parts (tensors or QTensors) of one logical N×H×W, device and dtype, and
    planes ≤ ``MAX_PLANES``. Seams (``up``/``down``, a bool per part, as
    :func:`fused_eval_stage` and the int8 stage take them): eval stages
    only, each part as :func:`_seam_readable` takes it; the logical shape
    is the one the seam reads (:func:`seam_shape`). On a CUDA device, the kernels' own
    limits: bfloat16, contiguous parts, planes a multiple of 32, labels,
    hidden and classes within the tail's ``TAIL_MAX_*``, and for training
    what the v3 backward takes (``ops/train_bwd.py`` ``bwd_v3_supported``). On the CPU, what the JAX
    gate takes there (``fused_stage_supported`` with its interpret-mode
    terms, ssunet_gan_tpu/ops/stage_kernel.py:438; its probe passes in
    interpret mode): H a multiple of 8, and W ≥ 8 after the eval path's
    lane packing. The JAX gate's VMEM estimate answers the TPU's memory and
    is not ported. An f32 eval stage on the card takes the f32 route
    (``csrc/fused_stage_f32.cu``, no width limits but MAX_PLANES) with
    contiguous parts and its seams materialized; f32 training and int8
    stages are refused. What it refuses runs the module composition."""
    parts = as_parts(parts)
    x0 = parts[0]
    if not 1 <= len(parts) <= 2 or any(len(p.shape) != 4 for p in parts):
        return False
    modes = seam_modes(len(parts), up, down)
    if any(modes) and (train or not all(_seam_readable(p, m, int8)
                                        for p, m in zip(parts, modes) if m)):
        return False
    n, h, w = seam_shape(x0, modes[0])
    if any(seam_shape(p, m) != (n, h, w) or p.device != x0.device or p.dtype != x0.dtype
           for p, m in zip(parts, modes)):
        return False
    if planes > MAX_PLANES:
        return False
    if x0.device.type == "cuda":
        if x0.dtype == torch.float32 and not train and not int8:
            return not any(modes) and all(p.is_contiguous() for p in parts)
        if (x0.dtype != torch.bfloat16 or planes % PLANES_MULTIPLE or labels > TAIL_MAX_LAB
                or hidden > TAIL_MAX_HIDDEN or classes > TAIL_MAX_CLS
                or not all(getattr(p, "q", p).is_contiguous() for p in parts)):
            return False
        if train:
            from ssunet_gan_tpu_torch.ops.train_bwd import bwd_v3_supported

            return bwd_v3_supported([p.shape[-1] for p in parts], planes)
        return True
    if x0.device.type != "cpu":
        return False
    wp = w if train else w * _pack_factor(n, w)
    return h % 8 == 0 and h >= 8 and wp >= 8


def _refused(parts, c, lab, nh, ncls, **kw) -> ValueError:
    return ValueError(
        f"the CUDA stage kernel does not take this stage (stage_supported): parts "
        f"{[(tuple(p.shape), p.dtype) for p in parts]}, planes={c} (a multiple of "
        f"{PLANES_MULTIPLE}, <= {MAX_PLANES}), labels={lab} (<= {TAIL_MAX_LAB}), hidden={nh} "
        f"(<= {TAIL_MAX_HIDDEN}), classes={ncls} (<= {TAIL_MAX_CLS}), bfloat16, contiguous"
        + (f", {kw}" if kw else ""))


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """f32 tensor holding ``t``'s values rounded to ``dtype``."""
    return t.float().to(dtype).float()


def spade_tail_reference(y, spade_params, head=None):
    """The self-SPADE tail on ``y`` (NHWC) in plain PyTorch with the
    kernels' numerics: seg, act and γ|β rounded to ``y``'s dtype, the
    modulate in that dtype, the folded head summed in f32. Returns
    ``(out, seg, act)``; ``out`` is the logits when ``head`` is given."""
    dtype = y.dtype
    wx, bx, wm, bm, wg, bg, wb, bb = spade_params
    seg = conv2d_nhwc(y.float(), _q(wx, dtype), _q(bx, dtype), 1).to(dtype)
    act = torch.relu(conv2d_nhwc(seg.float(), _q(wm, dtype), _q(bm, dtype), 1)).to(dtype)
    gamma = conv2d_nhwc(act.float(), _q(wg, dtype), _q(bg, dtype), 1).to(dtype)
    beta = conv2d_nhwc(act.float(), _q(wb, dtype), _q(bb, dtype), 1).to(dtype)
    out = y * (1 + gamma) + beta
    if head is not None:
        wf, bf = head
        out = conv2d_nhwc(out.float(), _q(wf, dtype), _q(bf, dtype)).to(dtype)
    return out, seg, act


def fused_stage_reference(parts, block_params, spade_params, head=None):
    """The stage in plain PyTorch (``F.conv2d``), with the kernel's
    numerics: f32 sums over inputs and weights rounded to the activation
    dtype, intermediates rounded to it. NHWC in and out.

    ``block_params``: ``(w1, (s1, t1), w2, (s2, t2), ws)`` — OIHW weights,
    folded BN affines, ``ws`` the 1×1 shortcut or None (zero shortcut).
    ``spade_params``: ``(wx, bx, wm, bm, wg, bg, wb, bb)``. ``head``:
    ``(wf, bf)`` of the folded final 1×1 conv, or None.

    On the card, compare with TF32 off (``torch.backends.cudnn.allow_tf32``)
    or the f32 convs lose ~3 digits."""
    parts = as_parts(parts)
    dtype = parts[0].dtype
    w1, (s1, t1), w2, (s2, t2), ws = block_params

    xs = tuple(p.float() for p in parts)
    h1 = conv2d_nhwc(xs, _q(w1.float() * s1.float()[:, None, None, None], dtype),
                     padding=1) + _q(t1, dtype)
    h1 = torch.relu(h1).to(dtype)
    y = conv2d_nhwc(h1.float(), _q(w2.float() * s2.float()[:, None, None, None], dtype),
                    padding=1) + _q(t2, dtype)
    if ws is not None:
        y = y + conv2d_nhwc(xs, _q(ws, dtype))
    y = torch.relu(y).to(dtype)
    return spade_tail_reference(y, spade_params, head)[0]


# The eval conv core (csrc/eval_conv.cuh): the N of its instantiations, the
# output channels padded up to one (at 64 the weights are wgmma's A, 64 rows)
EVAL_NT = (64, 128, 192, 256)

# Eval conv launches on the card (kernel 1's two per stage and the
# per-launch timing both come through :func:`eval_conv`; kernel 8's three
# launch from its own entry point, kernel 3's residual from its own).
conv_launches = 0


def eval_nt(cout: int) -> int:
    """The N instantiation of the eval conv core for ``cout`` channels."""
    for nt in EVAL_NT:
        if cout <= nt:
            return nt
    raise ValueError(f"the eval conv core takes at most {EVAL_NT[-1]} output channels, got {cout}")


def eval_chunk(c: int, group: int = 8) -> int:
    """Channels per K chunk of a source of ``c`` channels (csrc/conv_tile.cuh
    ``chunk_channels``): one or two channel groups of ``group`` whole when
    narrow (a 3×3 source's taps then pack into K), else four. Groups are 8
    channels in bf16 (16 bytes), 16 in s8 (csrc/int8_conv.cuh)."""
    return group if c <= group else 2 * group if c <= 2 * group else 4 * group


def _descriptor_order(segments, nt: int, group: int = 8):
    """The segments' weights laid out in the core's order (dtype kept)."""
    cout = segments[0].shape[0]
    blocks = []
    for w in segments:
        cin, k = w.shape[1], w.shape[2]
        cc, taps = eval_chunk(cin, group), k * k
        ngrp, nch = cc // group, -(-cin // cc)
        steps = (taps * ngrp + 1) // 2
        x = w.permute(0, 2, 3, 1).reshape(cout, taps, cin)
        x = F.pad(x, (0, nch * cc - cin, 0, 0, 0, nt - cout))
        x = x.reshape(nt, taps, nch, ngrp, group).permute(2, 1, 3, 0, 4).reshape(
            nch, taps * ngrp, nt, group)
        x = F.pad(x, (0, 0, 0, 0, 0, 2 * steps - taps * ngrp))
        x = x.reshape(nch, steps, 2, nt // 8, 8, group).permute(0, 1, 3, 2, 4, 5)
        blocks.append(x.reshape(nch * steps, nt // 8, 2, 8, group))
    return torch.cat(blocks)


@functools.lru_cache(maxsize=None)
def _layout_index(shapes, nt: int, device, group: int = 8) -> torch.Tensor:
    """For each element of the packed weight, its index into the segments'
    flattened weights behind one leading zero (0: a padding zero)."""
    ids, off = [], 1
    for shape in shapes:
        n = math.prod(shape)
        ids.append(torch.arange(off, off + n, dtype=torch.float64).reshape(shape))
        off += n
    return _descriptor_order(ids, nt, group).long().to(device)


def eval_conv_weight(segments, nt: int, dtype, group: int = 8) -> torch.Tensor:
    """The eval conv core's weight operand [steps][nt/8][2][8][8] in the
    order its wgmma descriptor reads it: per K-segment (an OIHW weight, 3×3
    or 1×1), per chunk of :func:`eval_chunk` input channels, per k16 step of
    two (tap, 8-channel group) pairs — tap-major, the chunk's channel groups
    within a tap, a last odd pair padded with zeros — the step's K-major
    core matrices: output channels in groups of 8 (rows past the weight's
    zero), then the two k8 halves, then 8 rows of 8 K values. One gather
    through an index laid out once per shape. With ``group`` 16 the same
    order for the s8 core's k32 steps of (tap, 16-channel group) pairs:
    [steps][nt/8][2][8][16]."""
    w0 = segments[0]
    idx = _layout_index(tuple(tuple(w.shape) for w in segments), nt, w0.device, group)
    flat = torch.cat([_zero(w0.device, w0.dtype)] + [w.reshape(-1) for w in segments])
    return flat[idx].to(dtype)


@functools.lru_cache(maxsize=None)
def _zero(device, dtype) -> torch.Tensor:
    return torch.zeros(1, device=device, dtype=dtype)


def pack_eval_conv(segments, bias, dtype, main: Optional[int] = None) -> dict:
    """One eval conv launch's operands: ``segments`` are the OIHW weights of
    its K-segments (f32; the packed weight rounds them to ``dtype``),
    ``bias`` the f32 bias or None, ``main`` the leading segments that the
    plain version sums as one conv before the bias (default all; the rest,
    a shortcut, is added after); the weights are kept for the plain
    version."""
    cout = segments[0].shape[0]
    nt = eval_nt(cout)
    w = eval_conv_weight(segments, nt, dtype)
    return {"w": w, "nt": nt, "steps": w.shape[0], "cout": cout,
            "segs": tuple((s.shape[1], s.shape[2]) for s in segments),
            "bias": None if bias is None else bias.float().contiguous(),
            "main": len(segments) if main is None else main, "oihw": tuple(segments)}


def eval_conv_reference(sources, weights, bias=None, main: Optional[int] = None, res=None):
    """One launch of the eval conv core in plain PyTorch: NHWC ``sources``
    with their OIHW ``weights`` (3×3 zero-padded at the border, or 1×1),
    the first ``main`` (default all) summed as one conv in f32 [+ bias],
    the rest added after; then ReLU, or with ``res = (r, a, b)`` the
    residual ``relu(r·a + b + acc)``; one rounding to the sources' dtype.
    The kernels' plain versions (:func:`fused_stage_reference`,
    ``stage_kernel_bneck.fused_bneck_reference``,
    ``stage_kernel_train.train_tail_reference``) are compositions of it."""
    dtype = sources[0].dtype
    main = len(sources) if main is None else main

    def conv(xs, ws):
        return conv2d_nhwc(tuple(x.float() for x in xs), torch.cat(list(ws), 1),
                           padding=ws[0].shape[-1] // 2)

    acc = conv(sources[:main], weights[:main])
    if bias is not None:
        acc = acc + bias
    if main < len(sources):
        acc = acc + conv(sources[main:], weights[main:])
    if res is None:
        return torch.relu(acc).to(dtype)
    r, a, b = res
    return torch.relu(r.float() * a.float() + b.float() + acc).to(dtype)


def conv_args(sources, conv: dict, modes=None) -> tuple:
    """The K-segment arguments of the eval conv core's C entry points:
    (count, pointers, channels, kernel sizes, read modes), after checking
    the sources against the packed operands."""
    segs = tuple((s.shape[-1], k) for s, (_, k) in zip(sources, conv["segs"]))
    if len(sources) != len(conv["segs"]) or segs != conv["segs"]:
        raise ValueError(f"the conv's weights are packed for {conv['segs']}, got sources of "
                         f"{[tuple(s.shape) for s in sources]}")
    n = len(sources)
    modes = tuple(modes) if modes else (0,) * n
    return (n, (ctypes.c_void_p * n)(*(s.data_ptr() for s in sources)),
            (ctypes.c_int * n)(*(c for c, _ in segs)), (ctypes.c_int * n)(*(k for _, k in segs)),
            (ctypes.c_int * n)(*modes))


def eval_conv(sources, conv: dict, modes=None) -> torch.Tensor:
    """One launch of the eval conv core (bias + ReLU epilogue) on CUDA
    tensors: ``sources`` NHWC bf16 of one logical N×H×W, each read in its
    mode of ``modes`` (:func:`seam_modes`; None: all plain; mode 1 needs
    an even output height of at least 4), ``conv`` from
    :func:`pack_eval_conv` on their device. Returns the NHWC bf16 output;
    counts the launch in ``conv_launches``."""
    global conv_launches
    x0 = sources[0]
    modes = tuple(modes) if modes else (0,) * len(sources)
    n, h, w = seam_shape(x0, modes[0])
    if x0.device.type != "cuda" or len(modes) != len(sources) or any(
            s.dtype != torch.bfloat16 or s.device != x0.device or seam_shape(s, m) != (n, h, w)
            or not s.is_contiguous() or (m == 2 and (s.shape[1] % 2 or s.shape[2] % 2))
            for s, m in zip(sources, modes)):
        raise ValueError("eval_conv takes contiguous bf16 NHWC CUDA tensors of one logical "
                         "N×H×W (a pool seam of even height and width)")
    out = torch.empty((n, h, w, conv["cout"]), dtype=x0.dtype, device=x0.device)
    with torch.cuda.device(x0.device):
        _check(_lib().ssu_eval_conv(*conv_args(sources, conv, modes), conv["nt"], _ptr(conv["w"]),
                                    conv["steps"], _ptr(conv["bias"]), _ptr(out), n, h, w,
                                    conv["cout"], torch.cuda.current_stream(x0.device).cuda_stream),
               "conv")
    conv_launches += 1
    return out


def split_in(w: torch.Tensor, part_channels):
    """An OIHW weight sliced along I into one weight per part."""
    offs = [0]
    for c in part_channels:
        offs.append(offs[-1] + c)
    return [w[:, a:b] for a, b in zip(offs, offs[1:])]


def tail_gb_steps(hidden: int) -> int:
    """k16 steps of the tail kernel's γ|β GEMM (csrc/stage_common.cuh
    ``tail_gb_steps``): K runs over (tap, 8-channel group of hidden) pairs,
    two per step, the last pair padded when their count is odd."""
    return (9 * -(-hidden // 8) + 1) // 2


def pack_spade(spade_params, head, dtype) -> dict:
    """The SPADE tail's operands (and the folded head's) as the tail kernel
    reads them (``csrc/stage_common.cuh`` ``TailArgs``), rounded to
    ``dtype``: the GEMM operands in ``dtype``, the biases and act's FMA
    weights as f32 holding rounded values.

    ``k1t`` [8][9][C]: x2map, labels padded to 8 (seg's N), tap-major then
    channel (seg's K). ``k2s`` [9][labels][hidden]: mlp_shared. ``kgbt``
    [2C][16·steps]: mlp_gamma and mlp_beta as N rows interleaved per 8
    output channels (rows 16i..16i+7 γ of channels 8i..8i+7, the next 8
    rows β of the same channels), K over (tap, 8-channel group of hidden)
    with zeros past hidden and in the odd last pair. ``kft`` [8][C]: the
    head's 1×1 weight, classes padded to 8; ``bgb`` is γ's bias then β's."""
    wx, bx, wm, bm, wg, bg, wb, bb = spade_params
    lab, c, nh = wx.shape[0], wx.shape[1], wm.shape[0]

    def q(t):
        return _q(t, dtype).contiguous()

    def gemm_b(w):  # (C, hidden, 3, 3) → [C][K]: (tap, group, channel), padded
        ngrp = -(-nh // 8)
        k = w.float().permute(0, 2, 3, 1).reshape(c, 9, nh)
        k = F.pad(k, (0, 8 * ngrp - nh)).reshape(c, 72 * ngrp)
        return F.pad(k, (0, 16 * tail_gb_steps(nh) - 72 * ngrp))

    c8 = -(-c // 8) * 8  # whole 8-channel groups (the card's C is a multiple of 32)
    gb = torch.stack([F.pad(gemm_b(w), (0, 0, 0, c8 - c)).reshape(c8 // 8, 8, -1)
                      for w in (wg, wb)], 1).reshape(2 * c8, -1)
    packed = {
        "k1t": F.pad(wx.float().permute(0, 2, 3, 1).reshape(lab, 9, c),
                     (0, 0, 0, 0, 0, max(8 - lab, 0))).to(dtype).contiguous(),
        "b1s": q(bx),
        "k2s": q(wm.permute(2, 3, 1, 0).reshape(9, lab, nh)),
        "b2s": q(bm),
        "kgbt": gb.to(dtype).contiguous(),
        "bgb": q(torch.cat([bg, bb])),
        "kft": None, "bf": None,
    }
    if head is not None:
        wf, bf = head
        packed["kft"] = F.pad(wf.float()[:, :, 0, 0], (0, 0, 0, max(8 - wf.shape[0], 0))).to(
            dtype).contiguous()
        packed["bf"] = q(bf)
    return packed


def tail_widths(pk: dict):
    """(labels, hidden, head classes) of :func:`pack_spade`'s operands."""
    return pk["k2s"].shape[1], pk["k2s"].shape[2], 0 if pk["bf"] is None else pk["bf"].shape[0]


def tail_args(pk: dict) -> tuple:
    """The tail's operand arguments of the C entry points, from
    :func:`pack_spade`'s dict: (k1t, b1s, labels, k2s, b2s, hidden, kgbt,
    bgb, kft, bf, classes)."""
    lab, nh, ncls = tail_widths(pk)
    return (_ptr(pk["k1t"]), _ptr(pk["b1s"]), lab, _ptr(pk["k2s"]), _ptr(pk["b2s"]), nh,
            _ptr(pk["kgbt"]), _ptr(pk["bgb"]), _ptr(pk["kft"]), _ptr(pk["bf"]), ncls)


def pack_stage(part_channels, block_params, spade_params, head, dtype) -> dict:
    """Fold BN into the weights and lay every operand out for the kernel.

    ``part_channels`` are the channels of the stage's parts; ``dtype`` is
    the activation dtype the operands are rounded to. The result depends on
    the weights alone, so a caller whose weights are fixed (eval) makes it
    once and hands it to :func:`fused_eval_stage` as ``packed``."""
    w1, (s1, t1), w2, (s2, t2), ws = block_params
    w1f = _q(w1.float() * s1.float()[:, None, None, None], dtype)
    w2f = _q(w2.float() * s2.float()[:, None, None, None], dtype)
    short = [] if ws is None else split_in(_q(ws, dtype), part_channels)
    packed = {
        "channels": tuple(part_channels), "dtype": dtype, "shortcut": ws is not None,
        "conv1": pack_eval_conv(split_in(w1f, part_channels), _q(t1, dtype), dtype),
        "conv2": pack_eval_conv([w2f] + short, _q(t2, dtype), dtype, main=1),
    }
    packed.update(pack_spade(spade_params, head, dtype))
    return packed


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_eval_conv.argtypes = [i, p, p, p, p, i, p, i, p, p, i, i, i, i, p]
    lib.ssu_eval_conv.restype = i
    lib.ssu_spade_tail.argtypes = [p, i, i, i, i, p, p, i, p, p, i, p, p,
                                   p, p, i, p, p]
    lib.ssu_spade_tail.restype = i
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused stage {what} launch failed: cudaError {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def packed_tensors(pk: dict):
    """The tensors of a packed stage, the convs' operands included."""
    for v in pk.values():
        if isinstance(v, dict):
            yield from packed_tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _run_cuda(parts: Tuple[torch.Tensor, ...], pk: dict, up=None, down=None) -> torch.Tensor:
    global launches, up_reads, pool_reads
    x0 = parts[0]
    dev, dtype = x0.device, x0.dtype
    modes = seam_modes(len(parts), up, down)
    n, h, w = seam_shape(x0, modes[0])
    c = pk["conv2"]["cout"]
    lab, nh, ncls = tail_widths(pk)
    if dtype != torch.bfloat16:
        raise TypeError(f"the CUDA fused stage takes bfloat16 tensors, got {dtype}")
    if not stage_supported(parts, c, lab, nh, ncls, up=up, down=down):
        raise _refused(parts, c, lab, nh, ncls, up=up, down=down)
    if pk["channels"] != tuple(p.shape[-1] for p in parts) or pk["dtype"] != dtype:
        raise ValueError(f"packed operands are for parts of {pk['channels']} channels "
                         f"in {pk['dtype']}, got {[tuple(p.shape) for p in parts]} {dtype}")
    if any(t.device != dev for t in packed_tensors(pk)):
        raise ValueError("stage weights must lie on the parts' device")
    with torch.cuda.device(dev):
        h1 = eval_conv(parts, pk["conv1"], modes)
        if pk["shortcut"]:
            y = eval_conv((h1,) + parts, pk["conv2"], (0,) + modes)
        else:
            y = eval_conv((h1,), pk["conv2"])
        out = torch.empty((n, h, w, ncls or c), dtype=dtype, device=dev)
        _check(_lib().ssu_spade_tail(_ptr(y), n, h, w, c, *tail_args(pk), _ptr(out),
                                     torch.cuda.current_stream(dev).cuda_stream), "SPADE tail")
    launches += 1
    up_reads += modes.count(1)
    pool_reads += modes.count(2)
    return out


def fused_eval_stage(parts, block_params, spade_params, head=None,
                     packed: Optional[dict] = None, up=None, down=None) -> torch.Tensor:
    """Eval [BasicBlock + self-SPADE] stage (+ folded head), NHWC in/out.

    Arguments as in :func:`fused_stage_reference`; ``packed``, if given, is
    :func:`pack_stage` of the same weights, which spares the CUDA path its
    packing. ``up`` / ``down`` (a bool per part) mark seams that the stage
    reads (:func:`seam_modes`): an up part is the half-height tensor after
    its W-interpolation, a pool part its producer's full-resolution output.
    CPU tensors run the plain version on :func:`materialize_seams`' parts;
    CUDA tensors run the hand-written kernel, which reads the seams (f32
    ones its f32 route, which reads none), or raise for what
    :func:`stage_supported` refuses."""
    parts = as_parts(parts)
    dev = parts[0].device
    if dev.type == "cpu":
        return fused_stage_reference(materialize_seams(parts, up, down), block_params,
                                     spade_params, head)
    if dev.type == "cuda" and parts[0].dtype == torch.float32:
        if packed is None or packed.get("route") != "f32":
            packed = pack_stage_f32(tuple(p.shape[-1] for p in parts), block_params,
                                    spade_params, head)
        return _run_cuda_f32(parts, packed, up, down)
    if dev.type == "cuda":
        if packed is None:
            packed = pack_stage(tuple(p.shape[-1] for p in parts), block_params,
                                spade_params, head, parts[0].dtype)
        return _run_cuda(parts, packed, up, down)
    raise ValueError(f"fused stage has no path for device {dev}")


# ---- the f32 route (csrc/fused_stage_f32.cu) ----------------------------------
#
# Each launch is one conv of the stage on the tensor cores in 3xTF32: the
# weights are split at pack time into big = tf32(w) and small = tf32(w -
# big) (:func:`split_tf32`), the activations as their windows land in
# shared memory, and each product is big·big + big·small + small·big in f32
# sums. :func:`f32_conv_reference` is a launch's plain version (exact f32
# products), :func:`f32_conv_emulated` the kernel's arithmetic in plain
# PyTorch (for the CPU tests); the γ|β conv carries the modulate in its
# epilogue. K is walked in chunks of 8 channels (4 for a source of ≤ 4),
# each chunk as (tap, 4-channel quad) pairs, padded to an even count.


def f32_bn(cout: int) -> int:
    """The kernel's N tile for a conv of ``cout`` columns (as
    ``csrc/fused_stage_f32.cu`` ``f32_bn``, which checks it): 8, 16, or 64
    in N blocks."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 64


def f32_chunks(c: int, k: int) -> Tuple[int, int, int]:
    """(quads per chunk, chunks, pairs per chunk padded to even) of a
    segment of ``c`` channels and kernel size ``k``."""
    q = 1 if c <= 4 else 2
    pairs = k * k * q
    return q, -(-c // (4 * q)), pairs + (pairs & 1)


def f32_k_index(chans, ks) -> torch.Tensor:
    """For each K row of the kernel's packed weight (segment, chunk,
    (tap, quad) pair, channel of the quad), its row in the natural weight
    ``[sum k·k·c][cout]`` ((tap, channel) within each segment, segments in
    order), or -1 where the row is zero (channels past a segment's width,
    the padded pair)."""
    rows, base = [], 0
    for c, k in zip(chans, ks):
        q, nchunk, pairs = f32_chunks(c, k)
        for jc in range(nchunk):
            for p in range(pairs):
                for j in range(4):
                    tap, qq = divmod(p, q)
                    ch = jc * 4 * q + qq * 4 + j
                    rows.append(base + tap * c + ch if p < k * k * q and ch < c else -1)
        base += k * k * c
    return torch.tensor(rows, dtype=torch.long)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of f32 ``x`` as the kernel splits it: big = tf32(x)
    rounded to nearest, ties away (toward zero where rounding up would
    overflow), small = tf32(x - big); an inf or NaN splits as (x, 0)."""
    x = x.float().contiguous()
    u = x.view(torch.int32)
    m = u & 0x7FFFFFFF
    big = torch.where(m < 0x7F7FF000, (u + 0x1000) & -0x2000, u & -0x2000).view(torch.float32)
    fin = m < 0x7F800000
    small = (((x - big).view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(fin, big, x), torch.where(fin, small, torch.zeros_like(x))


def pack_f32_conv(segments, bias, relu: bool, modulate: bool = False) -> dict:
    """One conv of the f32 route: ``w``, the OIHW weights of its segments as
    ``[K][cout]`` with K over the segments in order and (tap, channel)
    within each (what the plain version reads), f32; ``wk``, the kernel's
    operand: the same weight in its K order (:func:`f32_k_index`), split
    into big and small parts (:func:`split_tf32`), ``[2][N blocks][K
    quads][bn][4]``; the bias (``bk`` in the kernel's column order, padded
    to the N blocks); ReLU or not. ``modulate``: the γ|β conv (2C columns,
    γ then β), whose kernel columns interleave γ_c and β_c and whose
    epilogue is the modulate."""
    w = torch.cat([s.float().permute(2, 3, 1, 0).reshape(-1, s.shape[0]) for s in segments])
    chans = tuple(s.shape[1] for s in segments)
    ks = tuple(s.shape[-1] for s in segments)
    cout = segments[0].shape[0]
    bn = f32_bn(cout)
    nb = -(-cout // bn)
    cols = torch.arange(cout, device=w.device)
    if modulate:
        cols = torch.stack([cols[:cout // 2], cols[cout // 2:]], 1).reshape(-1)
    idx = f32_k_index(chans, ks).to(w.device)
    wk = torch.zeros((idx.numel(), nb * bn), dtype=torch.float32, device=w.device)
    wk[:, :cout] = torch.where((idx >= 0)[:, None], w[idx.clamp_min(0)][:, cols], 0.0)
    wk = wk.reshape(-1, 4, nb, bn).permute(2, 0, 3, 1)
    bk = None
    if bias is not None:
        bk = torch.zeros(nb * bn, dtype=torch.float32, device=w.device)
        bk[:cout] = bias.float()[cols]
    return {"w": w.contiguous(), "bias": None if bias is None else bias.float().contiguous(),
            "wk": torch.stack(split_tf32(wk)).contiguous(), "bk": bk, "kq": idx.numel() // 4,
            "bn": bn, "chans": chans, "ks": ks, "cout": cout, "relu": relu,
            "modulate": modulate}


def f32_weight_parts(conv: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The big and small parts of a packed conv's weight (``wk``), walked
    back from the kernel's K and column order to ``w``'s ``[K][cout]``."""
    cout = conv["cout"]
    idx = f32_k_index(conv["chans"], conv["ks"]).to(conv["wk"].device)
    flat = conv["wk"].permute(0, 2, 4, 1, 3).reshape(2, idx.numel(), -1)[:, idx >= 0, :cout]
    flat = flat[:, torch.argsort(idx[idx >= 0])]
    if conv["modulate"]:
        flat = torch.cat([flat[..., 0::2], flat[..., 1::2]], -1)
    return flat[0], flat[1]


def pack_stage_f32(part_channels, block_params, spade_params, head) -> dict:
    """The f32 route's operands of a stage (arguments as
    :func:`fused_stage_reference`): BN folded into the convs in f32, conv2
    with the shortcut's parts as K-segments, γ and β as one conv of 2C
    outputs with the modulate in its epilogue."""
    w1, (s1, t1), w2, (s2, t2), ws = block_params
    wx, bx, wm, bm, wg, bg, wb, bb = spade_params
    w1f = w1.float() * s1.float()[:, None, None, None]
    w2f = w2.float() * s2.float()[:, None, None, None]
    short = [] if ws is None else split_in(ws.float(), part_channels)
    return {
        "route": "f32", "channels": tuple(part_channels), "dtype": torch.float32,
        "shortcut": ws is not None,
        "conv1": pack_f32_conv(split_in(w1f, part_channels), t1, True),
        "conv2": pack_f32_conv([w2f] + short, t2, True),
        "seg": pack_f32_conv([wx], bx, False),
        "act": pack_f32_conv([wm], bm, True),
        "gb": pack_f32_conv([torch.cat([wg, wb])], torch.cat([bg, bb]), False, modulate=True),
        "head": None if head is None else pack_f32_conv([head[0]], head[1], False),
    }


def _f32_cols(sources, ks) -> torch.Tensor:
    """The launch's A operand: each segment's taps (zero padding at the
    image border) in ``w``'s K order, ``[n, h, w, K]``."""
    cols = []
    for x, k in zip(sources, ks):
        x = x.float()
        if k == 3:
            h, w = x.shape[1:3]
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))
            cols += [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
        else:
            cols.append(x)
    return torch.cat(cols, -1)


def _f32_epilogue(acc, conv: dict, y) -> torch.Tensor:
    if conv["bias"] is not None:
        acc = acc + conv["bias"]
    if conv["modulate"]:
        return f32_modulate_reference(y, acc)
    return torch.relu(acc) if conv["relu"] else acc


def f32_conv_reference(sources, conv: dict, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of one f32 conv launch: one product of the taps
    with ``w`` in exact f32, the bias, then ReLU, or for the γ|β conv the
    modulate with ``y``."""
    return _f32_epilogue(_f32_cols(sources, conv["ks"]) @ conv["w"], conv, y)


def f32_conv_emulated(sources, conv: dict, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic for one launch in plain PyTorch: the taps
    and the weight split (:func:`split_tf32`, the weight's parts read back
    from ``wk``), small·big + big·small + big·big summed in f32 (products of
    TF32 values are exact in f32), an inf or NaN tap contributing only its
    big·big product; then the epilogue of :func:`f32_conv_reference`."""
    a = _f32_cols(sources, conv["ks"])
    wb, ws = f32_weight_parts(conv)
    ab, asmall = split_tf32(a)
    ab2 = torch.where(torch.isfinite(a), ab, torch.zeros_like(ab))
    return _f32_epilogue(asmall @ wb + ab2 @ ws + ab @ wb, conv, y)


def f32_modulate_reference(y: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """The modulate: y·(1 + γ) + β, γ|β the halves of ``gb``'s channels,
    each operation rounded in f32."""
    c = y.shape[-1]
    return y * (1 + gb[..., :c]) + gb[..., c:]


def f32_stage_launches(parts, pk: dict, conv=f32_conv_reference) -> torch.Tensor:
    """A stage as the f32 route runs it, launch by launch (``conv``: the
    CUDA launch, or by default its plain version): conv1, conv2 with the
    shortcut's segments, seg, act, γ|β with the modulate, [the head]."""
    h1 = conv(parts, pk["conv1"])
    y = conv((h1,) + tuple(parts) if pk["shortcut"] else (h1,), pk["conv2"])
    act = conv((conv((y,), pk["seg"]),), pk["act"])
    out = conv((act,), pk["gb"], y)
    return out if pk["head"] is None else conv((out,), pk["head"])


@functools.lru_cache(maxsize=None)
def _lib_f32() -> ctypes.CDLL:
    lib = _build.load(SOURCE_F32)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssu_f32_conv.argtypes = [i, p, p, p, p, i, i, p, i, p, p, i, i, i, i, p]
    lib.ssu_f32_conv.restype = i
    return lib


def f32_conv(sources, conv: dict, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv launch of the f32 route on the card (its plain version:
    :func:`f32_conv_reference`); ``y`` for the γ|β conv's modulate."""
    global f32_conv_launches
    x0 = sources[0]
    n, h, w = x0.shape[:3]
    nseg = len(sources)
    if any(s.dtype != torch.float32 or not s.is_contiguous() or s.shape[:3] != (n, h, w)
           for s in sources) or tuple(s.shape[-1] for s in sources) != conv["chans"]:
        raise ValueError(f"f32 conv: sources {[(tuple(s.shape), s.dtype) for s in sources]} "
                         f"for segments of {conv['chans']} channels, contiguous f32")
    cout = conv["cout"]
    if conv["modulate"] != (y is not None) or (y is not None and (
            y.dtype != torch.float32 or not y.is_contiguous()
            or tuple(y.shape) != (n, h, w, cout // 2))):
        raise ValueError(f"f32 conv: the γ|β conv takes y [n, h, w, {cout // 2}] f32, the "
                         f"others none (modulate={conv['modulate']}, y={y is not None})")
    if any(t.device != x0.device for t in (conv["wk"], conv["bk"], y) if t is not None):
        raise ValueError("f32 conv: operands must lie on the sources' device")
    out = torch.empty((n, h, w, cout // 2 if y is not None else cout), dtype=torch.float32,
                      device=x0.device)
    ptrs = (ctypes.c_void_p * nseg)(*[s.data_ptr() for s in sources])
    chans = (ctypes.c_int * nseg)(*conv["chans"])
    ks = (ctypes.c_int * nseg)(*conv["ks"])
    _check(_lib_f32().ssu_f32_conv(nseg, ptrs, chans, ks, _ptr(conv["wk"]), conv["kq"],
                                   conv["bn"], _ptr(conv["bk"]), int(conv["relu"]), _ptr(y),
                                   _ptr(out), n, h, w, cout,
                                   torch.cuda.current_stream(x0.device).cuda_stream),
           "f32 conv")
    f32_conv_launches += 1
    return out


def _run_cuda_f32(parts: Tuple[torch.Tensor, ...], pk: dict, up=None, down=None) -> torch.Tensor:
    global f32_launches
    c = pk["conv2"]["cout"]
    if not stage_supported(parts, c, pk["seg"]["cout"], pk["act"]["cout"],
                           0 if pk["head"] is None else pk["head"]["cout"], up=up, down=down):
        raise ValueError(f"the f32 route does not take this stage (stage_supported): parts "
                         f"{[(tuple(p.shape), p.dtype) for p in parts]}, planes={c}, seams "
                         f"up={up} down={down}: f32, contiguous, seams materialized")
    if pk["channels"] != tuple(p.shape[-1] for p in parts):
        raise ValueError(f"packed operands are for parts of {pk['channels']} channels, got "
                         f"{[tuple(p.shape) for p in parts]}")
    if any(t.device != parts[0].device for t in packed_tensors(pk)):
        raise ValueError("stage weights must lie on the parts' device")
    with torch.cuda.device(parts[0].device):
        out = f32_stage_launches(parts, pk, f32_conv)
    f32_launches += 1
    return out
