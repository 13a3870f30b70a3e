"""The weight operand of the port's conv core (``ops/train_bwd.py``
``_conv3_weight``) as the card reads it, on the CPU.

``conv_stats`` and ``fused_conv3`` launch ``csrc/bwd_core.cuh``'s conv core
with this packed weight: K runs over segment (one per part), chunk of the
core's chunk width (``conv3_chunk``: the widest part's), then (tap, channel)
with channels zero-padded to the chunk and each chunk zero-padded to a
multiple of 32 K values. Here the input taps are gathered in that order with
plain torch ops (the zero ring of the padding after the prologue, as the
kernel leaves the window's out-of-image pixels 0), multiplied by the packed
weight, and held against ``conv_stats_reference`` on the same f32 inputs.
Only the summation order differs, so the bar is atol 1e-5 on outputs of
order 1.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssunet_gan_tpu_torch.ops import train_bwd as ttb
from ssunet_gan_tpu_torch.ops.stage_kernel import split_in
from ssunet_gan_tpu_torch.ops.stage_kernel_train import _prologued, conv_stats_reference


def _taps_in_k_order(parts, cc):
    """[N·H·W][K] input operand in the conv core's K order."""
    cols = []
    for x in parts:
        n, h, w, c = x.shape
        nch = -(-c // cc)
        # channels to whole chunks, then the conv's zero ring
        xp = F.pad(x, (0, nch * cc - c, 1, 1, 1, 1))
        kc = -(-9 * cc // 32) * 32
        for ch in range(nch):
            taps = [xp[:, dy:dy + h, dx:dx + w, ch * cc:(ch + 1) * cc]
                    for dy in range(3) for dx in range(3)]
            cols.append(F.pad(torch.cat(taps, -1).reshape(n * h * w, 9 * cc),
                              (0, kc - 9 * cc)))
    return torch.cat(cols, 1)


@pytest.mark.parametrize(
    "chans,cout,prologue",
    [
        ((24, 40), 16, False),  # two parts of unequal width: chunks of 32, both padded
        ((3,), 8, False),       # a narrow 3-channel part: (tap, channel) packed, 72 → 96
        ((16,), 12, True),      # 16-channel chunks with the prologue (conv2's input)
        ((3, 20), 5, False),    # a narrow part beside a wide one: the wider chunk
        ((40,), 7, True),       # a wide part with the prologue, odd output width
    ],
)
def test_conv3_weight_k_walk_rebuilds_the_conv(chans, cout, prologue):
    rng = np.random.default_rng(7)
    n, h, w = 2, 6, 9
    parts = tuple(torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32))
                  for c in chans)
    weight = torch.from_numpy(
        (0.1 * rng.standard_normal((cout, sum(chans), 3, 3))).astype(np.float32))
    pro = None
    if prologue:
        c = chans[0]
        pro = (torch.from_numpy((rng.random(c) + 0.5).astype(np.float32)),
               torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32)))
    kmode = ttb.K_STD if pro is None else ttb.K_AFF
    cc = ttb.conv3_chunk(kmode, chans)
    assert cc == max(8 if c <= 8 else 16 if c <= 16 else 32 for c in chans)
    wt = ttb._conv3_weight(split_in(weight, chans), torch.float32, cc)
    xs = parts if pro is None else (_prologued(parts[0], pro),)
    a = _taps_in_k_order(xs, cc)
    assert wt.shape == (cout, a.shape[1])
    got = (a @ wt.t()).reshape(n, h, w, cout)
    want, _ = conv_stats_reference(parts, weight, prologue=pro, stats=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
