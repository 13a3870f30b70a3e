"""The eval conv core's operands and per-launch plain version, on the CPU.

Every conv launch of the fused eval stages (kernels 1 and 8) and the train
tail's residual conv (kernel 3) run on ``csrc/eval_conv.cuh``: K-segments
of their own widths, 3×3 or 1×1, summed into one f32 accumulator, then
bias + ReLU or the residual affine, one rounding. Its weight is packed per
model (``ops/stage_kernel.py`` ``eval_conv_weight``) in the order its
wgmma descriptor reads it. Here that order is walked element by element,
each launch is rebuilt from the packed weight in the kernel's K order
(``torch_port_helpers.conv_from_packed``, f32) and held against
``F.conv2d`` (only the summation order differs: atol 1e-5 of the output's
largest magnitude), and the per-launch plain version
(``eval_conv_reference``) is shown to compose to the stages' plain
versions bit for bit — those are held against the JAX kernels in interpret
mode (``test_torch_stage.py``, ``test_torch_bneck.py``,
``test_torch_train_stage.py``). The kernel against its plain version on
the card: ``tests/test_torch_gpu.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck, stage_kernel_train
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock, Bottleneck
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.ops.stage_kernel import (
    eval_chunk,
    eval_conv_reference,
    eval_conv_weight,
    pack_eval_conv,
    split_in,
)
from torch_port_helpers import conv_from_packed


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.parametrize("segs,cout", [
    (((3, 3),), 64),              # conv0_0: one chunk of 8, 9 pairs in 5 k16 steps
    (((16, 3),), 32),             # a chunk of 16: 18 pairs
    (((40, 3), (24, 3)), 96),     # unequal parts, a partial chunk, N padded to 128
    (((3, 1), (48, 1)), 40),      # 1x1 chunks of 8 and 32 (one partial)
    (((32, 3), (100, 1)), 192),   # 3x3 + a 1x1 shortcut of 4 chunks of 32
])
def test_packed_weight_is_the_descriptors_order(segs, cout):
    """Element (step, n-group, k half, row, col) of the packed weight is
    weight[n = 8·group + row, channel, tap] of the segment, chunk and
    (tap, 8-channel group) pair that step and half stand for; pairs past a
    chunk's last, channels past a source's and rows past cout are 0."""
    gen = torch.Generator().manual_seed(0)
    ws = [_randn(gen, cout, c, k, k) for c, k in segs]
    nt = stage_kernel.eval_nt(cout)
    got = eval_conv_weight(ws, nt, torch.float32)
    want = []
    for w, (c, k) in zip(ws, segs):
        cc, taps = eval_chunk(c), k * k
        ngrp = cc // 8
        for ch in range(-(-c // cc)):
            for s in range((taps * ngrp + 1) // 2):
                step = torch.zeros(nt // 8, 2, 8, 8)
                for half in range(2):
                    q = 2 * s + half
                    if q >= taps * ngrp:
                        continue
                    tap, grp = divmod(q, ngrp)
                    for col in range(8):
                        ci = ch * cc + grp * 8 + col
                        if ci < c:
                            col_w = w[:, ci].reshape(cout, taps)[:, tap]
                            step[:cout // 8, half, :, col] = col_w.reshape(cout // 8, 8)
                want.append(step)
    assert got.shape == (len(want), nt // 8, 2, 8, 8)
    assert torch.equal(got, torch.stack(want))


def _conv_f32(sources, weights):
    return sum(F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
               for x, w in zip(sources, weights)).permute(0, 2, 3, 1)


LAUNCHES = {
    # (source channels, kernel sizes, cout)
    "rgb-3x3": ((3,), (3,), 64),
    "two-unequal-parts": ((24, 40), (3, 3), 32),
    "3x3-and-shortcut": ((32, 8, 40), (3, 1, 1), 32),
    "1x1-only": ((48, 20), (1, 1), 64),
    "bneck-conv3-and-identity": ((32, 16, 16), (1, 1, 1), 32),
}


@pytest.mark.parametrize("name", list(LAUNCHES))
def test_launch_from_packed_weight_is_the_conv(name):
    """A launch rebuilt from its packed weight in the kernel's K order (f32,
    no roundings) is the sum of its segments' convs (``F.conv2d``)."""
    chans, ks, cout = LAUNCHES[name]
    gen = torch.Generator().manual_seed(1)
    sources = [_randn(gen, 2, 7, 9, c) for c in chans]
    weights = [_randn(gen, cout, c, k, k, scale=0.2) for c, k in zip(chans, ks)]
    if name == "bneck-conv3-and-identity":  # the identity's unit matrix over the parts
        weights[1:] = split_in(torch.eye(cout)[:, :, None, None], chans[1:])
    conv = pack_eval_conv(weights, None, torch.float32)
    got = conv_from_packed(sources, conv)
    want = _conv_f32(sources, weights)
    if name == "bneck-conv3-and-identity":
        assert torch.allclose(want - _conv_f32(sources[:1], weights[:1]), torch.cat(sources[1:], -1),
                              atol=1e-6)
    scale = want.abs().max()
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def test_residual_epilogue():
    """The residual epilogue relu(res·a + b + acc), one rounding, as the
    train tail's plain version computes y."""
    gen = torch.Generator().manual_seed(2)
    parts = [_randn(gen, 2, 6, 5, c).bfloat16() for c in (3, 40)]
    f2 = _randn(gen, 2, 6, 5, 32).bfloat16()
    a2, b2 = torch.rand(32, generator=gen) + 0.5, _randn(gen, 32, scale=0.3)
    ws = _randn(gen, 32, 43, 1, 1, scale=0.2)
    wq = split_in(ws.bfloat16().float(), (3, 40))
    conv = pack_eval_conv(wq, None, torch.bfloat16)
    acc = conv_from_packed(parts, conv)
    want = torch.relu(f2.float() * a2 + b2 + acc).bfloat16()
    got = eval_conv_reference(parts, wq, res=(f2, a2, b2))
    assert got.dtype == torch.bfloat16
    # only acc's summation order differs: a rare 1-ulp flip
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()
    y = stage_kernel_train.train_tail_reference(f2, parts, a2, b2, ws, _spade(gen, 32))[1]
    assert torch.equal(got, y)


def _spade(gen, planes):
    return SPADE("spadebatch3x3", planes, 3, planes / 16, generator=gen).stage_params()


def _bn_stats(module, gen):
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)


@pytest.mark.parametrize("chans,planes", [((3,), 32), ((32, 64), 32), ((32,), 64)])
def test_per_launch_plain_composes_to_the_stage(chans, planes):
    """conv1 and conv2 (+ shortcut) as two per-launch plain versions from
    the packed operands, then the tail, equal ``fused_stage_reference``
    bit for bit (bf16)."""
    gen = torch.Generator().manual_seed(3)
    block = BasicBlock(sum(chans), planes, generator=gen).eval()
    _bn_stats(block, gen)
    sp = _spade(gen, planes)
    parts = tuple(_randn(gen, 2, 8, 8, c).bfloat16() for c in chans)
    bp = block.stage_params()
    with torch.no_grad():
        pk = stage_kernel.pack_stage(chans, bp, sp, None, torch.bfloat16)
        c1, c2 = pk["conv1"], pk["conv2"]
        h1 = eval_conv_reference(parts, c1["oihw"], c1["bias"], c1["main"])
        y = eval_conv_reference((h1,) + (parts if pk["shortcut"] else ()), c2["oihw"],
                                c2["bias"], c2["main"])
        got = stage_kernel.spade_tail_reference(y, sp)[0]
        want = stage_kernel.fused_stage_reference(parts, bp, sp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chans,planes", [((3,), 32), ((32, 64), 32), ((16, 16), 32)],
                         ids=["rgb", "two-parts", "identity"])
def test_per_launch_plain_composes_to_the_bneck_stage(chans, planes):
    """The bottleneck stage's three launches as per-launch plain versions
    from the packed operands, then the tail, equal ``fused_bneck_reference``
    bit for bit (bf16), the identity shortcut's unit matrix included."""
    gen = torch.Generator().manual_seed(4)
    block = Bottleneck(sum(chans), planes, generator=gen).eval()
    _bn_stats(block, gen)
    sp = _spade(gen, planes)
    parts = tuple(_randn(gen, 2, 8, 8, c).bfloat16() for c in chans)
    bp = block.stage_params()
    with torch.no_grad():
        pk = stage_kernel_bneck.pack_stage_bneck(chans, bp, sp, None, torch.bfloat16)
        run = lambda xs, cv: eval_conv_reference(xs, cv["oihw"], cv["bias"], cv["main"])
        h1 = run(parts, pk["conv1"])
        y = run((run((h1,), pk["conv2"]),) + parts, pk["conv3"])
        got = stage_kernel.spade_tail_reference(y, sp)[0]
        want = stage_kernel_bneck.fused_bneck_reference(parts, bp, sp)
    assert torch.equal(got, want)
