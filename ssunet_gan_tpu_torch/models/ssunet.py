"""The flagship ``UNet_R_SS_v2`` (reference archs.py:559-671), NHWC.

BasicBlock encoder with self-SPADE after every stage (``SPADE0_0(x0_0,
x0_0)``); the decoder un-pools the top three levels through the saved
max-pool codes with bias-free 1×1 channel heads, and upsamples the bottom
two bilinearly. Module names are the reference's, so its ``model.pth``
loads with ``load_state_dict``.

Stages that meet the fused kernels' terms (a BasicBlock with a shortcut
conv, planes ≤ 256, at most two parts — the JAX gates,
ssunet_gan_tpu/models/ssunet.py:227-238 and 261-293) run fused: in eval
through :func:`ops.stage_kernel.fused_eval_stage`, in training through
:func:`ops.stage_kernel_train.fused_train_stage`, whose batch statistics
then move the BatchNorms' running averages. In the flagship these are
conv0_0, conv1_0, conv2_0, conv2_1, conv1_1 and conv0_1, the last with
``final`` folded in. The deep stages, channel heads, pools and unpools stay
plain PyTorch (autograd in training).

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

from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
from ssunet_gan_tpu_torch.ops.conv import Conv2d, as_parts
from ssunet_gan_tpu_torch.ops.pool import (
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from ssunet_gan_tpu_torch.ops.resize import _lerp, upsample_bilinear
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.ops.stage_kernel import fused_eval_stage, pack_stage
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
from ssunet_gan_tpu_torch.ops.stage_kernel_train import fused_train_stage

SPADE_CONTEXT = "spadebatch3x3"  # archs.py:483 (its param-free norm is bypassed)
FUSED_MAX_PLANES = 256  # the JAX gate's _PACK_MAX_PLANES


def _stage_operands(parts, block: BasicBlock, spade: SPADE, final: Optional[Conv2d],
                    int8: bool = False):
    """The fused stage's (block params, SPADE params, head, packed), kept on
    ``block`` until a weight or buffer changes (its storage or its version)
    or the parts change device, dtype or channels: eval weights are fixed,
    so the BN fold and the kernel's packing run once, not every forward.
    The bf16 and the int8 stage keep their operands side by side; the int8
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
            packed = (pack_stage_int8(bp, sp, head, x0.dtype) if int8
                      else pack_stage(key[2], bp, sp, head, x0.dtype))
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


def spade_stage(parts, block: BasicBlock, spade: SPADE,
                final: Optional[Conv2d] = None, name: Optional[str] = None,
                out_key: Optional[str] = None):
    """One stage: BasicBlock + self-SPADE [+ the final 1×1 conv].

    ``name`` is the stage's calibration key (its block's module name) and
    ``out_key`` the calibration key of its output's consumer; both matter
    only to the int8 mode. Returns the stage output (a QTensor where the
    int8 mode emits s8), or the logits when ``final`` is given."""
    parts = as_parts(parts)
    if not block.training and record_sink() is not None:
        # calibration pass: the plain composition, recording input ranges
        parts = _dequantized(parts)
        record_stage_inputs(name, parts)
        y = block(parts)
        y = spade(y, y)
        return y if final is None else final(y)
    fused = (block.shortcut is not None and block.planes <= FUSED_MAX_PLANES
             and len(parts) <= 2)
    if not block.training and int8_stage_enabled():
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
    y = block(parts)
    y = spade(y, y)
    return y if final is None else final(y)


class UNetRSSv2(nn.Module):
    """``filters`` defaults to the reference widths (archs.py:568);
    ``deep_supervision`` is accepted and unused, as in the reference."""

    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False,
                 filters: Sequence[int] = (64, 128, 256, 384, 512, 768),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = tuple(filters)
        ss = 16  # archs.py:575
        g = generator
        self.num_classes = num_classes
        self.filters = f

        def stage(name, in_ch, planes):
            setattr(self, "conv" + name, BasicBlock(in_ch, planes, generator=g))
            setattr(self, "SPADE" + name,
                    SPADE(SPADE_CONTEXT, planes, num_classes, planes / ss, generator=g))

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

    def _stage(self, name, x, final=None, out_key=None):
        return spade_stage(x, getattr(self, "conv" + name),
                           getattr(self, "SPADE" + name), final,
                           name="conv" + name, out_key=out_key)

    @staticmethod
    def _up(x: torch.Tensor, calib_key: str) -> torch.Tensor:
        """Bilinear ×2. In record mode the abs-max of the W-interpolated
        half-height tensor goes under ``"<calib_key>:half"``: the JAX
        package's on-read upsample quantizes that tensor, and a scales file
        holds the same keys whichever package wrote it."""
        if record_sink() is not None:
            record_range(f"{calib_key}:half", _lerp(x.float(), 2, torch.float32).abs().max())
        return upsample_bilinear(x)

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
        dec_1 = self._stage("1_1", (enc_1, self._up(dec_2, "conv1_1:1")))
        return self._stage("0_1", (enc_0, self._up(dec_1, "conv0_1:1")), self.final)
