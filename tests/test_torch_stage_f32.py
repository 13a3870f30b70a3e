"""The f32 route of kernel 1 (``csrc/fused_stage_f32.cu``, 3xTF32 on the
tensor cores) on the CPU: its conv launch's plain version against
convolutions over the unpacked weights; the kernel's weight operand (its K
order, its split into TF32 big and small parts) walked back to the weight;
the stage as the route runs it, launch by launch (the γ|β launch with the
modulate in its epilogue), against the stage's plain version and against
the JAX package's ``fused_eval_stage`` in f32 (Pallas interpret mode),
which takes the activation dtype; the kernel's 3xTF32 arithmetic in plain
PyTorch (``f32_conv_emulated``) at flagship-like widths against both, and
with inf and NaN inputs; and the one gate's f32 decisions on the card.

f32 throughout. Between the port's functions (the same products summed in
another order; 3xTF32 products within ~2^-22): relative L2 and max error
over max |·| ≤ 1e-5. Against JAX: rtol = atol = 2e-4,
tests/test_torch_stage.py's bar (both fold BN into the weights but sum in
other orders). The split's big + small is each weight to within 2^-21
relative (rounding to nearest gives ~2^-22).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops.conv import conv2d_nhwc
from test_torch_stage import _stage
from torch_port_helpers import jax_toggles


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True):
        yield


def _close(got, want, tol=1e-5):
    diff = (got - want).double()
    scale = want.double().abs().max().item()
    l2 = (diff.norm() / want.double().norm()).item()
    assert diff.abs().max().item() <= tol * scale and l2 <= tol, (diff.abs().max().item(),
                                                                  scale, l2)


@pytest.mark.parametrize("segs", [((5, 3),), ((8, 3), (16, 3)), ((16, 3), (8, 1), (24, 1))],
                         ids=["one", "two_parts", "conv2_with_shortcut"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_f32_conv_launch_walks_its_packed_weight(rng, segs, relu):
    """One launch over up to three K-segments (3×3 parts, 1×1 shortcut
    parts) on a ragged 9×7 map: the packed weight walked in the kernel's K
    order (segment, tap, channel) equals the sum of the segments' convs,
    the bias added, then ReLU."""
    cout = 12
    xs = [torch.from_numpy(rng.normal(size=(2, 9, 7, c)).astype(np.float32)) for c, _ in segs]
    ws = [torch.from_numpy((rng.normal(size=(cout, c, k, k)) * 0.2).astype(np.float32))
          for c, k in segs]
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    conv = stage_kernel.pack_f32_conv(ws, bias, relu)
    assert conv["w"].shape == (sum(9 * c if k == 3 else c for c, k in segs), cout)
    got = stage_kernel.f32_conv_reference(xs, conv)
    want = sum(conv2d_nhwc(x, w, padding=w.shape[-1] // 2) for x, w in zip(xs, ws)) + bias
    _close(got, torch.relu(want) if relu else want)
    _close(stage_kernel.f32_conv_emulated(xs, conv), got)


@pytest.mark.parametrize("segs,cout,modulate", [
    (((3, 3),), 64, False),                 # conv0_0's conv1: one quad per chunk
    (((64, 3), (3, 1)), 64, False),         # conv2 with a 3-channel shortcut
    (((256, 3), (256, 3)), 256, False),     # conv2_1's conv1, four N blocks
    (((16, 3), (24, 1), (6, 1)), 3, False), # widths off the chunk grid, N tile 8
    (((4, 3),), 128, True),                 # the γ|β launch, interleaved columns
], ids=["cin3", "shortcut3", "wide", "ragged", "gamma_beta"])
def test_f32_split_rebuilds_each_packed_weight(rng, segs, cout, modulate):
    """The kernel's weight operand ``wk``: its big and small parts are TF32
    values (13 low bits zero), and walked back from the kernel's K and
    column order (``f32_weight_parts``) big + small rebuilds every weight
    of ``w`` to within 2^-21 of its magnitude; the rows the kernel pads
    (channels past a segment's width, the odd pair) are zero."""
    ws = [torch.from_numpy((rng.normal(size=(cout, c, k, k)) * 0.2).astype(np.float32))
          for c, k in segs]
    conv = stage_kernel.pack_f32_conv(ws, None, False, modulate=modulate)
    wk = conv["wk"]
    assert wk.shape == (2, -(-cout // conv["bn"]), conv["kq"], conv["bn"], 4)
    assert not bool((wk.view(torch.int32) & 0x1FFF).any())
    big, small = stage_kernel.f32_weight_parts(conv)
    w = conv["w"]
    assert bool(((big + small - w).abs() <= 2.0 ** -21 * w.abs()).all())
    idx = stage_kernel.f32_k_index(conv["chans"], conv["ks"])
    assert sorted(idx[idx >= 0].tolist()) == list(range(w.shape[0]))
    padded = wk.permute(0, 2, 4, 1, 3).reshape(2, idx.numel(), -1)[:, idx < 0]
    assert not bool(padded.any())


@pytest.mark.parametrize(
    "planes,label,shapes,nh,ncls",
    [
        (16, 3, [(2, 16, 8, 8)], 4.0, 0),                       # encoder, 1 part
        (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 0),       # decoder, 2 parts
        (8, 2, [(2, 8, 8, 3)], 4.0, 0),                         # 3-ch first block
        (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 3),       # folded final head
    ],
    ids=["encoder", "decoder", "first", "head"],
)
def test_f32_route_matches_the_stage_and_jax(rng, planes, label, shapes, nh, ncls):
    """The stage launch by launch as the f32 route runs it (the plain
    versions of its conv and modulate launches, on ``pack_stage_f32``'s
    operands) against the stage's plain version (``fused_stage_reference``
    in f32, what the wrapper runs on the CPU) and against the JAX
    package's ``fused_eval_stage`` on f32 parts in interpret mode."""
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    pk = stage_kernel.pack_stage_f32(tuple(p.shape[-1] for p in parts), st["tbp"], st["tsp"],
                                     st["thead"])
    got = stage_kernel.f32_stage_launches(parts, pk)
    _close(got, stage_kernel.fused_stage_reference(parts, st["tbp"], st["tsp"], st["thead"]))
    kernel = np.asarray(jax_fused_eval_stage(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))
    assert kernel.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), kernel, rtol=2e-4, atol=2e-4)


def test_f32_route_without_a_shortcut(rng):
    """A VGG stage (zero shortcut: no 1×1 segment in conv2) on the route's
    launches against the stage's plain version."""
    st = _stage(rng, 16, 3, [(2, 8, 8, 8)], 4.0, 0)
    w1, s1, w2, s2, _ = st["tbp"]
    bp = (w1, s1, w2, s2, None)
    parts = (torch.from_numpy(st["xs"][0]),)
    pk = stage_kernel.pack_stage_f32((8,), bp, st["tsp"], None)
    assert not pk["shortcut"] and pk["conv2"]["chans"] == (16,)
    _close(stage_kernel.f32_stage_launches(parts, pk),
           stage_kernel.fused_stage_reference(parts, bp, st["tsp"]))


class _Part:
    """What the gate reads of a part on the card (shape, dtype, device,
    contiguity), without a card."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device("cuda", 0)
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("parts,planes,lab,nh,ncls,kw,takes", [
    ([(8, 512, 512, 3)], 64, 3, 4, 0, {}, True),
    ([(8, 128, 128, 256), (8, 128, 128, 256)], 256, 3, 16, 0, {}, True),
    ([(2, 19, 13, 6), (2, 19, 13, 10)], 24, 5, 4, 2, {}, True),
    ([(1, 8, 8, 64)], 96, 9, 80, 12, {}, True),       # past the bf16 tail's limits
    ([(1, 8, 8, 64)], 288, 3, 18, 0, {}, False),      # past MAX_PLANES
    ([(1, 8, 8, 64)], 64, 3, 4, 0, {"train": True}, True),   # the f32 train kernels
    ([(1, 8, 8, 64)], 64, 3, 4, 0, {"int8": True}, False),
    ([(1, 16, 16, 64)], 64, 3, 4, 0, {"down": (True,)}, False),
    ([(1, 8, 8, 64), (1, 4, 8, 64)], 64, 3, 4, 0, {"up": (False, True)}, False),
    ([(1, 8, 8, 64)] * 3, 64, 3, 4, 0, {}, False),
], ids=["first", "widest", "ragged", "wide_tail", "too_wide", "train", "int8", "pool_seam",
        "up_seam", "three_parts"])
def test_gate_takes_the_f32_stages_it_took(parts, planes, lab, nh, ncls, kw, takes):
    """The one gate's decision for f32 stages on the card, which the
    redesigned route takes as the route before it did: any widths up to
    MAX_PLANES (no tail limits), one or two contiguous parts, no seams; f32
    training taken too (the f32 train kernels, ops/train_f32.py), int8
    refused."""
    ps = [_Part(s) for s in parts]
    assert stage_kernel.stage_supported(ps, planes, lab, nh, ncls, **kw) is takes
    if takes:
        ps[0]._contiguous = False
        assert not stage_kernel.stage_supported(ps, planes, lab, nh, ncls, **kw)
