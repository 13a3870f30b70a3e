"""The self-SPADE U-Nets, NHWC: the flagship ``UNet_R_SS_v2`` (reference
archs.py:559-671), ``UNet_R_SS`` (archs.py:469-556), ``UNet_B_SS``
(archs.py:346-406) and ``SSUNet`` (archs.py:673-743). Every stage is a conv
block followed by a SPADE conditioned on the block's own output
(``SPADE0_0(x0_0, x0_0)``). Module names are the reference's, so its
``model.pth`` loads with ``load_state_dict``.

``UNet_R_SS_v2``: BasicBlock encoder; the decoder un-pools the top three
levels through the saved max-pool codes with bias-free 1×1 channel heads,
and upsamples the bottom two bilinearly. ``UNet_R_SS``: six BasicBlock
levels and a bilinear decoder. ``UNet_B_SS``: five Bottleneck levels and a
bilinear decoder. ``SSUNet``: five VGG levels (filters 32-512, ``ss_scale``
4) and a bilinear decoder.

BasicBlock stages with a shortcut conv and VGG stages that the one gate
:func:`ops.stage_kernel.stage_supported` admits run fused (the JAX
dispatch, ssunet_gan_tpu/models/ssunet.py:227-238 and 261-293, with
:func:`ops.stage_kernel.set_fused_stage` and
:func:`ops.stage_kernel_train.set_fused_train` as its toggles): in eval
through :func:`ops.stage_kernel.fused_eval_stage` (a VGG stage with no
shortcut, its conv biases folded into the BN offsets), in training, for
the BasicBlock stages only and not under remat
(:func:`ops.blocks.set_remat`), through
:func:`ops.stage_kernel_train.fused_train_stage`, whose batch statistics
then move the BatchNorms' running averages. What the gate refuses (f32 on
the card, planes not a multiple of 32, more than 8 labels or classes,
more than ``TAIL_MAX_HIDDEN`` (64) hidden channels) runs the module
composition, as in JAX (:316-330). In the flagship these are
conv0_0, conv1_0, conv2_0, conv2_1, conv1_1 and conv0_1, the last with
``final`` folded in; in ``UNet_R_SS`` conv0_0, conv1_0, conv2_0, conv2_2,
conv1_3 and conv0_4; in ``SSUNet`` every stage but conv4_0 (512 planes).
Bottleneck stages that
:func:`ops.stage_kernel_bneck.bneck_supported` admits run in eval through
:func:`ops.stage_kernel_bneck.fused_eval_stage_bneck` (the same six names
in ``UNet_B_SS``); in training, and in the int8 mode, they are the module
composition (JAX models/ssunet.py:246-260, 323-329). The composition's
SPADE follows :func:`ops.spade_kernel.set_fused_spade`. The deep stages,
channel heads, unpools and the seams no kernel stage reads stay plain
PyTorch (autograd in training).

The bilinear decoder seams and the encoder max-pool seams are handed to
the consuming stage as keywords (``up`` / ``down``, a bool per part: the
part as it stands before its ×2 upsample or its 2×2 pool), and the stage
takes them as the JAX package's lazy forms are taken
(ssunet_gan_tpu/models/ssunet.py:174-211): in a bf16 eval forward, with
:func:`ops.resize.set_lazy_upsample` / :func:`ops.pool.set_lazy_pool` on
(the default), an up part is interpolated along W at half height
(:func:`ops.resize.upsample_w`) and a pool part is left as it is; where
the one gate admits the stage with its seams, the kernel reads them
(kernels 1 and 8; Bottleneck stages read up seams only); elsewhere they
are materialized (:func:`ops.stage_kernel.materialize_seams`: W then H,
and the pool). Training, f32, the int8 mode and record mode materialize
every seam as before (:func:`ops.resize.upsample_bilinear`, H then W, and
:func:`ops.pool.max_pool_2x2`).

With the int8 mode on (:func:`ops.stage_kernel_int8.set_int8_stage`) the
eval forward dispatches as the JAX package's does (models/ssunet.py:214-322):
the fused stages run :func:`ops.stage_kernel_int8.fused_eval_stage_int8`
(a VGG stage with zero shortcut columns), the deep stages the s8 block
(without the residual for a VGG block) with the bf16 SPADE after it, and
under static calibration the encoder stages emit their outputs as s8 at
the scale their skip consumer recorded, so pools and consumers read s8.
While a record sink is active every stage runs the plain composition and
records its inputs' ranges (:mod:`infer.calibrate`).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.blocks import (
    BasicBlock,
    Bottleneck,
    VGGBlock,
    maybe_remat,
    remat_enabled,
)
from ssunet_gan_tpu_torch.ops.conv import Conv2d, as_parts
from ssunet_gan_tpu_torch.ops.pool import (
    lazy_pool_ok,
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from ssunet_gan_tpu_torch.ops.resize import _lerp, lazy_up_ok, upsample_bilinear, upsample_w
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    fused_eval_stage,
    fused_stage_enabled,
    materialize_seams,
    pack_stage,
    seam_modes,
    stage_supported,
)
from ssunet_gan_tpu_torch.ops.stage_kernel_bneck import (
    bneck_supported,
    fused_eval_stage_bneck,
    pack_stage_bneck,
)
from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import (
    QTensor,
    emit_s8,
    fused_eval_stage_int8,
    int8_block,
    int8_calibration,
    int8_stage_enabled,
    pack_stage_int8,
    record_range,
    record_sink,
    record_stage_inputs,
)
from ssunet_gan_tpu_torch.ops.stage_kernel_train import fused_train_enabled, fused_train_stage

SPADE_CONTEXT = "spadebatch3x3"  # archs.py:483 (its param-free norm is bypassed)
FUSED_MAX_PLANES = 256  # the JAX gate's _PACK_MAX_PLANES
# the seam keywords of the forwards: an encoder stage's one part before its
# pool, a decoder stage's second part before its upsample
POOL, UP = (True,), (False, True)


def _stage_operands(parts, block, spade: SPADE, final: Optional[Conv2d],
                    int8: bool = False):
    """The fused stage's (block params, SPADE params, head, packed), kept on
    ``block`` until a weight or buffer changes (its storage or its version)
    or the parts change device, dtype or channels: eval weights are fixed,
    so the BN fold and the kernel's packing run once, not every forward.
    The block's class picks the packing (BasicBlock or Bottleneck). The
    bf16 and the int8 stage keep their operands side by side; the int8
    ones hold, besides, the s8 weights of the last static input scales
    (:func:`ops.stage_kernel_int8.pack_stage_int8`)."""
    x0 = parts[0]
    key = (x0.device, x0.dtype, tuple(p.shape[-1] for p in parts)) + tuple(
        (t.data_ptr(), t._version)
        for m in (block, spade, final) if m is not None
        for t in itertools.chain(m.parameters(), m.buffers()))
    attr = "_fused_operands_int8" if int8 else "_fused_operands"
    cached = getattr(block, attr, None)
    if cached is None or cached[0] != key:
        with torch.no_grad():  # eval only: the kept operands carry no graph
            bp, sp = block.stage_params(), spade.stage_params()
            head = None if final is None else (final.weight, final.bias)
            if int8:
                packed = pack_stage_int8(bp, sp, head, x0.dtype)
            else:
                pack = pack_stage_bneck if isinstance(block, Bottleneck) else pack_stage
                packed = pack(key[2], bp, sp, head, x0.dtype)
            cached = (key, bp, sp, head, packed)
        setattr(block, attr, cached)
    return cached[1:]


def _out_amax(key: Optional[str]) -> Optional[float]:
    """The calibrated abs-max that covers a stage's output: ``key`` names
    the skip consumer's recorded input, which is this very tensor (pooled
    views are subsets of it, never larger)."""
    cal = int8_calibration()
    return None if key is None or cal is None else cal.get(key)


def _dequantized(parts):
    return tuple(p.dequant() if isinstance(p, QTensor) else p for p in parts)


def _composition(parts, block, spade: SPADE, final: Optional[Conv2d]):
    y = maybe_remat(block, parts)
    y = spade(y, y)
    return y if final is None else final(y)


def _seams(parts, up, down, read_up: bool, read_pool: bool, half_key: Optional[str]):
    """The stage's parts with its seams (``up`` / ``down``: a bool per part
    given before its ×2 upsample or its 2×2 pool) in the form the stage
    takes them. Where ``read_up`` / ``read_pool`` and the seam's own terms
    hold (:func:`ops.resize.lazy_up_ok`, :func:`ops.pool.lazy_pool_ok`),
    an up part becomes the half-height tensor after its W-interpolation
    and a pool part stays as it is, for the stage to read; every other
    seam is materialized as before (``upsample_bilinear``: H, then W;
    ``max_pool_2x2``). Returns (parts, up, down) with the flags of the
    seams left to read (None where none is). ``half_key`` (record mode):
    the abs-max of each up part's f32 W-interpolation goes under
    ``"<half_key>:<part>:half"``, the range of the half-height tensor that
    the JAX package's int8 on-read upsample quantizes, so a scales file
    holds the same keys whichever package wrote it."""
    out, ups, downs = [], [], []
    for i, (p, m) in enumerate(zip(parts, seam_modes(len(parts), up, down))):
        if m == 1 and half_key is not None:
            record_range(f"{half_key}:{i}:half", _lerp(p.float(), 2, torch.float32).abs().max())
        read = (m == 1 and read_up and lazy_up_ok(p)) or (m == 2 and read_pool and lazy_pool_ok(p))
        if m == 1:
            p = upsample_w(p) if read else upsample_bilinear(p)
        elif m == 2 and not read:
            p = max_pool_2x2(p)
        out.append(p)
        ups.append(read and m == 1)
        downs.append(read and m == 2)
    return tuple(out), tuple(ups) if any(ups) else None, tuple(downs) if any(downs) else None


def _admit(gate, parts, up, down):
    """The stage's gate, asked with the seams left to read; where it
    refuses them, the seams are materialized (JAX ``_spade_stage``'s
    ``materialize_up`` / ``materialize_down``) and the gate is asked again.
    Returns (fused, parts, up, down)."""
    if gate(parts, up, down):
        return True, parts, up, down
    if up or down:
        parts = materialize_seams(parts, up, down)
        return gate(parts, None, None), parts, None, None
    return False, parts, up, down


def spade_stage(parts, block, spade: SPADE,
                final: Optional[Conv2d] = None, name: Optional[str] = None,
                out_key: Optional[str] = None, up=None, down=None):
    """One stage: conv block (BasicBlock, VGGBlock or Bottleneck, told by
    the block's class) + self-SPADE [+ the final 1×1 conv].

    ``name`` is the stage's calibration key (its block's module name) and
    ``out_key`` the calibration key of its output's consumer; both matter
    only to the int8 mode. ``up`` / ``down`` (a bool per part) mark the
    parts given before their bilinear ×2 upsample or their 2×2 max-pool:
    a bf16 eval stage that the gate admits with them reads them in its
    kernel, every other stage takes them materialized (:func:`_seams`,
    :func:`_admit`). Returns the stage output (a QTensor where the int8
    mode emits s8), or the logits when ``final`` is given."""
    parts = as_parts(parts)
    record = not block.training and record_sink() is not None
    int8 = not block.training and int8_stage_enabled()
    bneck = isinstance(block, Bottleneck)
    if up or down:
        # the Bottleneck kernel reads up seams only (JAX materializes its pools)
        lazy = not (block.training or record or int8)
        parts, up, down = _seams(parts, up, down, lazy, lazy and not bneck,
                                 name if record and not bneck else None)
    if record:
        # calibration pass: the plain composition, recording input ranges
        parts = _dequantized(parts)
        record_stage_inputs(name, parts)
        return _composition(parts, block, spade, final)
    widths = (block.planes, spade.label_nc, spade.nhidden,
              0 if final is None else final.weight.shape[0])
    if bneck:
        # the int8 mode covers the BasicBlock stages only; training is the
        # composition, whose SPADE follows the fused-SPADE mode
        parts = _dequantized(parts)
        ok = not block.training and not int8 and block.planes <= FUSED_MAX_PLANES
        fused, parts, up, _ = _admit(
            lambda p, u, d: ok and bneck_supported(p, *widths, up=u), parts, up, down)
        if fused:
            bp, sp, head, packed = _stage_operands(parts, block, spade, final)
            return fused_eval_stage_bneck(parts, bp, sp, head, packed, up=up)
        return _composition(parts, block, spade, final)
    vgg = isinstance(block, VGGBlock)
    # a BasicBlock's fused packing needs its shortcut conv; a VGG block has
    # none (zero shortcut columns); training fuses BasicBlock stages only,
    # and not under remat, whose composition bounds the memory (JAX :227-293)
    if block.training:
        mode = not vgg and fused_train_enabled() and not remat_enabled()
    else:
        mode = fused_stage_enabled()
    ok = (vgg or block.shortcut is not None) and block.planes <= FUSED_MAX_PLANES and mode
    fused, parts, up, down = _admit(
        lambda p, u, d: ok and stage_supported(p, *widths, train=block.training, int8=int8,
                                               up=u, down=d), parts, up, down)
    if int8:
        am = None if final is not None else _out_amax(out_key)
        if fused:
            bp, sp, head, packed = _stage_operands(parts, block, spade, final, int8=True)
            return fused_eval_stage_int8(parts, bp, sp, head, calib_key=name,
                                         out_abs_max=am, packed=packed)
        # a deep stage: s8 convs, the SPADE composition after them, and
        # producer-side s8 emission where the output's range is calibrated
        with torch.no_grad():
            y = int8_block(parts, block.stage_params(), calib_key=name, residual=not vgg)
        y = spade(y, y)
        if am is not None:
            return emit_s8(y, am)
        return y if final is None else final(y)
    parts = _dequantized(parts)
    if fused:
        if block.training:
            head = None if final is None else (final.weight, final.bias)
            out, (st1, st2) = fused_train_stage(parts, block.train_params(),
                                                spade.stage_params(), head)
            block.bn1.update_running(*st1)
            block.bn2.update_running(*st2)
            return out
        bp, sp, head, packed = _stage_operands(parts, block, spade, final)
        return fused_eval_stage(parts, bp, sp, head, packed, up=up, down=down)
    return _composition(parts, block, spade, final)


class _SelfSpadeUNet(nn.Module):
    """What the self-SPADE U-Nets share: stages named ``conv<l>_<k>`` /
    ``SPADE<l>_<k>`` with ``ss_scale`` 16 (archs.py:357, 484, 575) and the
    dispatch of one stage. ``BLOCK`` is the stages' conv block."""

    BLOCK = BasicBlock
    SS = 16

    def _add_stage(self, name: str, in_ch: int, planes: int, generator) -> None:
        setattr(self, "conv" + name, self.BLOCK(in_ch, planes, generator=generator))
        setattr(self, "SPADE" + name,
                SPADE(SPADE_CONTEXT, planes, self.num_classes, planes / self.SS,
                      generator=generator))

    def _stage(self, name, x, final=None, out_key=None, up=None, down=None):
        return spade_stage(x, getattr(self, "conv" + name),
                           getattr(self, "SPADE" + name), final,
                           name="conv" + name, out_key=out_key, up=up, down=down)


class UNetRSSv2(_SelfSpadeUNet):
    """``filters`` defaults to the reference widths (archs.py:568);
    ``deep_supervision`` is accepted and unused, as in the reference."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 filters: Sequence[int] = (64, 128, 256, 384, 512, 768),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        g = generator
        self.num_classes = num_classes
        self.filters = f

        def stage(name, in_ch, planes):
            self._add_stage(name, in_ch, planes, g)

        stage("0_0", input_channels, f[0])
        stage("1_0", f[0], f[1])
        stage("2_0", f[1], f[2])
        stage("3_0", f[2], f[3])
        stage("4_0", f[3], f[4])
        stage("5_0", f[4], f[5])
        self.conv_head5_0 = Conv2d(f[5], f[4], 1, bias=False, generator=g)
        stage("4_1", 2 * f[4], f[4])
        self.conv_head4_1 = Conv2d(f[4], f[3], 1, bias=False, generator=g)
        stage("3_1", 2 * f[3], f[3])
        self.conv_head3_1 = Conv2d(f[3], f[2], 1, bias=False, generator=g)
        stage("2_1", 2 * f[2], f[2])
        stage("1_1", f[1] + f[2], f[1])
        stage("0_1", f[0] + f[1], f[0])
        self.final = Conv2d(f[0], num_classes, 1, init="kaiming_fan_in", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → NHWC logits, in the input's dtype. In training mode
        the BatchNorms normalize with batch statistics and move their
        running averages."""
        # the encoder stages name their skip consumer's input: under int8
        # with static calibration they emit s8 at that scale
        enc_0 = self._stage("0_0", x, out_key="conv0_1:0")
        enc_1 = self._stage("1_0", enc_0, out_key="conv1_1:0", down=POOL)
        enc_2 = self._stage("2_0", enc_1, out_key="conv2_1:0", down=POOL)
        p2, idx2 = max_pool_2x2_with_indices(enc_2)
        enc_3 = self._stage("3_0", p2, out_key="conv3_1:0")
        p3, idx3 = max_pool_2x2_with_indices(enc_3)
        enc_4 = self._stage("4_0", p3, out_key="conv4_1:0")
        p4, idx4 = max_pool_2x2_with_indices(enc_4)
        enc_5 = self._stage("5_0", p4)

        up = max_unpool_2x2(self.conv_head5_0(enc_5), idx4)
        dec_4 = self._stage("4_1", (enc_4, up))
        up = max_unpool_2x2(self.conv_head4_1(dec_4), idx3)
        dec_3 = self._stage("3_1", (enc_3, up))
        up = max_unpool_2x2(self.conv_head3_1(dec_3), idx2)
        dec_2 = self._stage("2_1", (enc_2, up))
        dec_1 = self._stage("1_1", (enc_1, dec_2), up=UP)
        return self._stage("0_1", (enc_0, dec_1), self.final, up=UP)


class UNetRSS(_SelfSpadeUNet):
    """Six BasicBlock levels with self-SPADE and a bilinear decoder
    (reference archs.py:469-556; JAX models/ssunet.py:430-471).
    ``filters`` defaults to the reference widths (archs.py:478)."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 filters: Sequence[int] = (64, 128, 256, 384, 512, 768),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        g = generator
        self.num_classes = num_classes
        self.filters = f
        for name, in_ch, planes in (
                ("0_0", input_channels, f[0]), ("1_0", f[0], f[1]), ("2_0", f[1], f[2]),
                ("3_0", f[2], f[3]), ("4_0", f[3], f[4]), ("5_0", f[4], f[5]),
                ("4_1", f[4] + f[5], f[4]), ("3_1", f[3] + f[4], f[3]),
                ("2_2", f[2] + f[3], f[2]), ("1_3", f[1] + f[2], f[1]),
                ("0_4", f[0] + f[1], f[0])):
            self._add_stage(name, in_ch, planes, g)
        self.final = Conv2d(f[0], num_classes, 1, init="kaiming_fan_in", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → NHWC logits, in the input's dtype."""
        # the encoder stages name their skip consumer's input (int8 mode);
        # x5_0 feeds only the bilinear upsample and stays in the float dtype
        x0_0 = self._stage("0_0", x, out_key="conv0_4:0")
        x1_0 = self._stage("1_0", x0_0, out_key="conv1_3:0", down=POOL)
        x2_0 = self._stage("2_0", x1_0, out_key="conv2_2:0", down=POOL)
        x3_0 = self._stage("3_0", x2_0, out_key="conv3_1:0", down=POOL)
        x4_0 = self._stage("4_0", x3_0, out_key="conv4_1:0", down=POOL)
        x5_0 = self._stage("5_0", x4_0, down=POOL)
        x4_1 = self._stage("4_1", (x4_0, x5_0), up=UP)
        x3_1 = self._stage("3_1", (x3_0, x4_1), up=UP)
        x2_2 = self._stage("2_2", (x2_0, x3_1), up=UP)
        x1_3 = self._stage("1_3", (x1_0, x2_2), up=UP)
        return self._stage("0_4", (x0_0, x1_3), self.final, up=UP)


class UNetBSS(_SelfSpadeUNet):
    """Five Bottleneck levels with self-SPADE and a bilinear decoder
    (reference archs.py:346-406; JAX models/ssunet.py:388-427).
    ``filters`` defaults to the reference widths (archs.py:351)."""

    BLOCK = Bottleneck

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        g = generator
        self.num_classes = num_classes
        self.filters = f
        for name, in_ch, planes in (
                ("0_0", input_channels, f[0]), ("1_0", f[0], f[1]), ("2_0", f[1], f[2]),
                ("3_0", f[2], f[3]), ("4_0", f[3], f[4]),
                ("3_1", f[3] + f[4], f[3]), ("2_2", f[2] + f[3], f[2]),
                ("1_3", f[1] + f[2], f[1]), ("0_4", f[0] + f[1], f[0])):
            self._add_stage(name, in_ch, planes, g)
        self.final = Conv2d(f[0], num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → NHWC logits, in the input's dtype."""
        x0_0 = self._stage("0_0", x)
        x1_0 = self._stage("1_0", max_pool_2x2(x0_0))
        x2_0 = self._stage("2_0", max_pool_2x2(x1_0))
        x3_0 = self._stage("3_0", max_pool_2x2(x2_0))
        x4_0 = self._stage("4_0", max_pool_2x2(x3_0))
        # conv3_1 (512 planes) never fuses: its seam is materialized H then
        # W, as the JAX package forces there (models/ssunet.py:411-415); the
        # Bottleneck stages' pools are materialized as in JAX
        x3_1 = self._stage("3_1", (x3_0, upsample_bilinear(x4_0)))
        x2_2 = self._stage("2_2", (x2_0, x3_1), up=UP)
        x1_3 = self._stage("1_3", (x1_0, x2_2), up=UP)
        return self._stage("0_4", (x0_0, x1_3), self.final, up=UP)


class SSUNet(_SelfSpadeUNet):
    """VGGBlock U-Net with self-SPADE at every stage and a bilinear decoder
    (reference archs.py:673-743; JAX models/ssunet.py:346-391). ``filters``
    defaults to the reference widths (archs.py:680). ``final`` keeps
    ``Conv2d``'s default init, as the JAX model builds it (:380-382)."""

    BLOCK = VGGBlock
    SS = 4  # archs.py:689

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 filters: Sequence[int] = (32, 64, 128, 256, 512),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        g = generator
        self.num_classes = num_classes
        self.filters = f
        for name, in_ch, planes in (
                ("0_0", input_channels, f[0]), ("1_0", f[0], f[1]), ("2_0", f[1], f[2]),
                ("3_0", f[2], f[3]), ("4_0", f[3], f[4]),
                ("3_1", f[3] + f[4], f[3]), ("2_2", f[2] + f[3], f[2]),
                ("1_3", f[1] + f[2], f[1]), ("0_4", f[0] + f[1], f[0])):
            self._add_stage(name, in_ch, planes, g)
        self.final = Conv2d(f[0], num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input → NHWC logits, in the input's dtype."""
        # the encoder stages name their skip consumer's input (int8 mode);
        # x4_0 feeds only the bilinear upsample and stays in the float dtype
        x0_0 = self._stage("0_0", x, out_key="conv0_4:0")
        x1_0 = self._stage("1_0", x0_0, out_key="conv1_3:0", down=POOL)
        x2_0 = self._stage("2_0", x1_0, out_key="conv2_2:0", down=POOL)
        x3_0 = self._stage("3_0", x2_0, out_key="conv3_1:0", down=POOL)
        x4_0 = self._stage("4_0", x3_0, down=POOL)
        x3_1 = self._stage("3_1", (x3_0, x4_0), up=UP)
        x2_2 = self._stage("2_2", (x2_0, x3_1), up=UP)
        x1_3 = self._stage("1_3", (x1_0, x2_2), up=UP)
        return self._stage("0_4", (x0_0, x1_3), self.final, up=UP)
