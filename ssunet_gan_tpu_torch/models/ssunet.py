"""The self-SPADE U-Nets, NHWC: the flagship ``UNet_R_SS_v2`` (reference
archs.py:559-671), ``UNet_R_SS`` (archs.py:469-556) and ``UNet_B_SS``
(archs.py:346-406). Every stage is a conv block followed by a SPADE
conditioned on the block's own output (``SPADE0_0(x0_0, x0_0)``). Module
names are the reference's, so its ``model.pth`` loads with
``load_state_dict``.

``UNet_R_SS_v2``: BasicBlock encoder; the decoder un-pools the top three
levels through the saved max-pool codes with bias-free 1×1 channel heads,
and upsamples the bottom two bilinearly. ``UNet_R_SS``: six BasicBlock
levels and a bilinear decoder. ``UNet_B_SS``: five Bottleneck levels and a
bilinear decoder.

BasicBlock stages with a shortcut conv that the one gate
:func:`ops.stage_kernel.stage_supported` admits run fused (the JAX
dispatch, ssunet_gan_tpu/models/ssunet.py:227-238 and 261-293, with
:func:`ops.stage_kernel.set_fused_stage` and
:func:`ops.stage_kernel_train.set_fused_train` as its toggles): in eval
through :func:`ops.stage_kernel.fused_eval_stage`, in training through
:func:`ops.stage_kernel_train.fused_train_stage`, whose batch statistics
then move the BatchNorms' running averages. What the gate refuses (f32 on
the card, planes not a multiple of 32, more than 8 labels or classes,
more than 16 hidden channels) runs the module composition, as in JAX
(:316-330). In the flagship these are
conv0_0, conv1_0, conv2_0, conv2_1, conv1_1 and conv0_1, the last with
``final`` folded in; in ``UNet_R_SS`` conv0_0, conv1_0, conv2_0, conv2_2,
conv1_3 and conv0_4. Bottleneck stages that
:func:`ops.stage_kernel_bneck.bneck_supported` admits run in eval through
:func:`ops.stage_kernel_bneck.fused_eval_stage_bneck` (the same six names
in ``UNet_B_SS``); in training, and in the int8 mode, they are the module
composition (JAX models/ssunet.py:246-260, 323-329), whose SPADE follows
:func:`ops.spade_kernel.set_fused_spade`. The deep stages, channel heads,
pools and unpools stay plain PyTorch (autograd in training).

With the int8 mode on (:func:`ops.stage_kernel_int8.set_int8_stage`) the
eval forward dispatches as the JAX package's does (models/ssunet.py:214-322):
the fused stages run :func:`ops.stage_kernel_int8.fused_eval_stage_int8`,
the deep stages the s8 block with the bf16 SPADE after it, and under static
calibration the encoder stages emit their outputs as s8 at the scale their
skip consumer recorded, so pools and consumers read s8. While a record sink
is active every stage runs the plain composition and records its inputs'
ranges (:mod:`infer.calibrate`).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.blocks import BasicBlock, Bottleneck
from ssunet_gan_tpu_torch.ops.conv import Conv2d, as_parts
from ssunet_gan_tpu_torch.ops.pool import (
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from ssunet_gan_tpu_torch.ops.resize import _lerp, upsample_bilinear
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    fused_eval_stage,
    fused_stage_enabled,
    pack_stage,
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
    y = block(parts)
    y = spade(y, y)
    return y if final is None else final(y)


def spade_stage(parts, block, spade: SPADE,
                final: Optional[Conv2d] = None, name: Optional[str] = None,
                out_key: Optional[str] = None):
    """One stage: conv block (BasicBlock or Bottleneck, told by the block's
    class) + self-SPADE [+ the final 1×1 conv].

    ``name`` is the stage's calibration key (its block's module name) and
    ``out_key`` the calibration key of its output's consumer; both matter
    only to the int8 mode. Returns the stage output (a QTensor where the
    int8 mode emits s8), or the logits when ``final`` is given."""
    parts = as_parts(parts)
    if not block.training and record_sink() is not None:
        # calibration pass: the plain composition, recording input ranges
        parts = _dequantized(parts)
        record_stage_inputs(name, parts)
        return _composition(parts, block, spade, final)
    if isinstance(block, Bottleneck):
        # the int8 mode covers the BasicBlock stages only; training is the
        # composition, whose SPADE follows the fused-SPADE mode
        parts = _dequantized(parts)
        if (not block.training and not int8_stage_enabled()
                and block.planes <= FUSED_MAX_PLANES
                and bneck_supported(parts, block.planes, spade.label_nc, spade.nhidden,
                                    0 if final is None else final.weight.shape[0])):
            bp, sp, head, packed = _stage_operands(parts, block, spade, final)
            return fused_eval_stage_bneck(parts, bp, sp, head, packed)
        return _composition(parts, block, spade, final)
    int8 = not block.training and int8_stage_enabled()
    fused = (block.shortcut is not None and block.planes <= FUSED_MAX_PLANES
             and (fused_train_enabled() if block.training else fused_stage_enabled())
             and stage_supported(parts, block.planes, spade.label_nc, spade.nhidden,
                                 0 if final is None else final.weight.shape[0],
                                 train=block.training, int8=int8))
    if int8:
        am = None if final is not None else _out_amax(out_key)
        if fused:
            bp, sp, head, packed = _stage_operands(parts, block, spade, final, int8=True)
            return fused_eval_stage_int8(parts, bp, sp, head, calib_key=name,
                                         out_abs_max=am, packed=packed)
        # a deep stage: s8 convs, the SPADE composition after them, and
        # producer-side s8 emission where the output's range is calibrated
        with torch.no_grad():
            y = int8_block(parts, block.stage_params(), calib_key=name)
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
        return fused_eval_stage(parts, bp, sp, head, packed)
    return _composition(parts, block, spade, final)


def _up(x: torch.Tensor, calib_key: Optional[str] = None) -> torch.Tensor:
    """Bilinear ×2. In record mode the abs-max of the W-interpolated
    half-height tensor goes under ``"<calib_key>:half"``: the JAX
    package's on-read upsample quantizes that tensor, and a scales file
    holds the same keys whichever package wrote it."""
    if calib_key is not None and record_sink() is not None:
        record_range(f"{calib_key}:half", _lerp(x.float(), 2, torch.float32).abs().max())
    return upsample_bilinear(x)


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

    def _stage(self, name, x, final=None, out_key=None):
        return spade_stage(x, getattr(self, "conv" + name),
                           getattr(self, "SPADE" + name), final,
                           name="conv" + name, out_key=out_key)


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
        enc_1 = self._stage("1_0", max_pool_2x2(enc_0), out_key="conv1_1:0")
        enc_2 = self._stage("2_0", max_pool_2x2(enc_1), out_key="conv2_1:0")
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
        dec_1 = self._stage("1_1", (enc_1, _up(dec_2, "conv1_1:1")))
        return self._stage("0_1", (enc_0, _up(dec_1, "conv0_1:1")), self.final)


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
        x1_0 = self._stage("1_0", max_pool_2x2(x0_0), out_key="conv1_3:0")
        x2_0 = self._stage("2_0", max_pool_2x2(x1_0), out_key="conv2_2:0")
        x3_0 = self._stage("3_0", max_pool_2x2(x2_0), out_key="conv3_1:0")
        x4_0 = self._stage("4_0", max_pool_2x2(x3_0), out_key="conv4_1:0")
        x5_0 = self._stage("5_0", max_pool_2x2(x4_0))
        x4_1 = self._stage("4_1", (x4_0, _up(x5_0, "conv4_1:1")))
        x3_1 = self._stage("3_1", (x3_0, _up(x4_1, "conv3_1:1")))
        x2_2 = self._stage("2_2", (x2_0, _up(x3_1, "conv2_2:1")))
        x1_3 = self._stage("1_3", (x1_0, _up(x2_2, "conv1_3:1")))
        return self._stage("0_4", (x0_0, _up(x1_3, "conv0_4:1")), self.final)


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
        x3_1 = self._stage("3_1", (x3_0, _up(x4_0)))
        x2_2 = self._stage("2_2", (x2_0, _up(x3_1)))
        x1_3 = self._stage("1_3", (x1_0, _up(x2_2)))
        return self._stage("0_4", (x0_0, _up(x1_3)), self.final)
