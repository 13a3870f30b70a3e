"""The f32 route of kernel 8 (kernel 8f: the bottleneck stage as launches of
the 3xTF32 conv core of ``csrc/f32_conv.cuh``) on the CPU: the stage as the
route runs it, launch by launch, with each launch's plain version
(``f32_conv_reference``) and with the kernel's arithmetic in plain PyTorch
(``f32_conv_emulated``), against the JAX package's
``fused_eval_stage_bneck`` on f32 parts (Pallas interpret mode; it takes
the activation dtype) and against the stage's plain version; the packed
convs walked in the kernel's K order; the one gate's f32 terms on a
CUDA-shaped stand-in; the model's packing choice; and a narrow
``UNet_B_SS`` f32 forward with the route's launches in place of the
stages, against the port's own CPU forward.

f32 throughout. Between the port's functions (the same products summed in
another order; 3xTF32 products within ~2^-22): relative L2 and max error
over max |·| ≤ 1e-5. Against JAX: rtol = atol = 2e-4, the bar
tests/test_torch_bneck.py holds the stage to (both fold BN into the
weights but sum in other orders). The narrow model carries the stages'
differences through its decoder: 1e-5 of its logits' scale as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage_bneck as jax_fused_bneck
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck
from ssunet_gan_tpu_torch.ops.blocks import Bottleneck
from ssunet_gan_tpu_torch.ops.conv import conv2d_nhwc
from ssunet_gan_tpu_torch.ops.spade import SPADE
from test_torch_bneck import _stage
from torch_port_helpers import B_FILTERS, jax_toggles


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


def _counted(conv, log):
    def launch(sources, pk, y=None):
        log.append((tuple(s.shape[-1] for s in sources), pk["cout"], y is not None))
        return conv(sources, pk, y)

    return launch


@pytest.mark.parametrize("planes,label,shapes,nh,ncls", [
    (16, 3, [(2, 16, 8, 8)], 4.0, 0),                      # encoder: projection shortcut
    (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 3),      # decoder: two parts, folded head
    (16, 3, [(1, 16, 16, 16)], 4.0, 0),                    # identity shortcut
], ids=["projection", "two_parts_head", "identity"])
def test_f32_route_matches_the_stage_and_jax(rng, planes, label, shapes, nh, ncls):
    """The stage launch by launch as kernel 8f runs it (conv1, conv2, conv3
    with the shortcut's segments, seg, act, γ|β with the modulate, [the
    head]) on ``pack_stage_bneck_f32``'s operands, with the launches' plain
    versions and with the kernel's emulated arithmetic, against JAX
    ``fused_eval_stage_bneck`` in f32 and the stage's plain version."""
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    chans = tuple(p.shape[-1] for p in parts)
    pk = stage_kernel_bneck.pack_stage_bneck_f32(chans, st["tbp"], st["tsp"], st["thead"])
    log = []
    got = stage_kernel_bneck.f32_bneck_launches(
        parts, pk, _counted(stage_kernel.f32_conv_reference, log))
    assert [c for c, _, _ in log[:3]] == [chans, (planes,), (planes,) + chans]
    assert len(log) == 6 + bool(ncls) and [m for _, _, m in log].count(True) == 1
    emulated = stage_kernel_bneck.f32_bneck_launches(parts, pk, stage_kernel.f32_conv_emulated)
    want = stage_kernel_bneck.fused_bneck_reference(parts, st["tbp"], st["tsp"], st["thead"])
    _close(got, want)
    _close(emulated, want)
    kernel = np.asarray(jax_fused_bneck(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))
    assert kernel.dtype == np.float32 and kernel.shape == got.shape
    for out in (got, emulated):
        np.testing.assert_allclose(out.numpy(), kernel, rtol=2e-4, atol=2e-4)


def _block(chans, planes, gen, labels=3, ncls=0):
    block = Bottleneck(sum(chans), planes, generator=gen).eval()
    for m in block.modules():
        if hasattr(m, "running_var"):
            m.running_var.copy_(torch.rand(planes, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(planes, generator=gen) * 0.3)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 4, generator=gen)
    head = None
    if ncls:
        head = (torch.randn((ncls, planes, 1, 1), generator=gen) * 0.3,
                torch.randn((ncls,), generator=gen) * 0.1)
    return block, spade, head


@pytest.mark.parametrize("chans", [(3,), (8, 40), (32,), (8, 24)],
                         ids=["rgb", "two_parts", "identity", "identity_two_parts"])
def test_packed_convs_walk_their_weights(chans):
    """Each conv of ``pack_stage_bneck_f32`` walked in the kernel's K order
    (segment, then (tap, channel)) is the folded convolution it stands for:
    conv1 the 1×1 over the parts, conv2 the 3×3, conv3 the 1×1 over h2 and
    the shortcut's 1×1 over the parts in one sum with ``t3 + ts`` (for the
    identity a unit weight per part, whose TF32 split is exactly 1 and 0);
    composed, the stage's plain version."""
    gen = torch.Generator().manual_seed(0)
    planes = 32
    block, spade, _ = _block(chans, planes, gen)
    parts = tuple(torch.randn((2, 6, 7, c), generator=gen) for c in chans)
    bp, sp = block.stage_params(), spade.stage_params()
    with torch.no_grad():
        pk = stage_kernel_bneck.pack_stage_bneck_f32(chans, bp, sp, None)
        k1, k2, k3, ks, b1, b2, b3 = stage_kernel_bneck._folded(bp, torch.float32)
        c1, c2, c3 = pk["conv1"], pk["conv2"], pk["conv3"]
        assert (c1["chans"], c1["ks"]) == (chans, (1,) * len(chans))
        assert (c2["chans"], c2["ks"]) == ((planes,), (3,))
        assert (c3["chans"], c3["ks"]) == ((planes,) + chans, (1,) * (1 + len(chans)))
        h1 = stage_kernel.f32_conv_reference(parts, c1)
        _close(h1, torch.relu(conv2d_nhwc(parts, k1) + b1))
        h2 = stage_kernel.f32_conv_reference((h1,), c2)
        _close(h2, torch.relu(conv2d_nhwc(h1, k2, padding=1) + b2))
        short = torch.cat(parts, -1) if ks is None else conv2d_nhwc(parts, ks)
        y = stage_kernel.f32_conv_reference((h2,) + parts, c3)
        _close(y, torch.relu(conv2d_nhwc(h2, k3) + b3 + short))
        for conv in (c1, c2, c3):
            big, small = stage_kernel.f32_weight_parts(conv)
            assert bool(((big + small - conv["w"]).abs() <= 2.0 ** -21 * conv["w"].abs()).all())
        if ks is None:  # the unit rows of conv3's weight split exactly
            big, small = stage_kernel.f32_weight_parts(c3)
            assert torch.equal(big[planes:], torch.eye(planes)) and not bool(small[planes:].any())
        _close(stage_kernel_bneck.f32_bneck_launches(parts, pk),
               stage_kernel_bneck.fused_bneck_reference(parts, bp, sp))


class _Part:
    """What the gate reads of a part on the card (shape, dtype, device,
    contiguity), without a card."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device("cuda", 0)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


BF16 = torch.bfloat16


@pytest.mark.parametrize("parts,planes,lab,nh,ncls,kw,takes", [
    ([(8, 512, 512, 3)], 64, 3, 4, 0, {}, True),                  # conv0_0
    ([(8, 64, 64, 512), (8, 64, 64, 256)], 256, 3, 16, 0, {}, True),
    ([(2, 19, 13, 6), (2, 19, 13, 10)], 24, 5, 4, 2, {}, True),   # ragged widths
    ([(1, 8, 8, 64)], 96, 9, 80, 12, {}, True),        # past the bf16 tail's limits
    ([(1, 8, 8, 64)], 512, 3, 32, 0, {}, False),       # past max_planes()
    ([(1, 8, 8, 64), (1, 4, 8, 64)], 64, 3, 4, 0, {"up": (False, True)}, False),
    ([(1, 8, 8, 64)] * 3, 64, 3, 4, 0, {}, False),
    # the bf16 kernel's decisions, as before
    ([(8, 64, 64, 512), (8, 64, 64, 256)], 256, 3, 16, 0, {"dtype": BF16}, True),
    ([(1, 8, 8, 64), (1, 4, 8, 64)], 64, 3, 4, 0, {"up": (False, True), "dtype": BF16}, True),
    ([(1, 8, 8, 64)], 48, 3, 4, 0, {"dtype": BF16}, False),       # planes % 32
    ([(1, 8, 8, 64)], 64, 3, 80, 0, {"dtype": BF16}, False),      # hidden past the tail
    ([(1, 8, 8, 64)], 64, 9, 4, 0, {"dtype": BF16}, False),       # labels past the tail
], ids=["first", "widest", "ragged", "wide_tail", "too_wide", "up_seam", "three_parts",
        "bf16_widest", "bf16_up_seam", "bf16_planes", "bf16_hidden", "bf16_labels"])
def test_gate_takes_f32_bottleneck_stages(parts, planes, lab, nh, ncls, kw, takes):
    """``bneck_supported`` on the card: f32 stages of one or two contiguous
    parts at any widths up to ``max_planes()`` (the f32 conv core has no
    tail limits), no up part (f32 seams are materialized before the gate
    is asked); the bf16 kernel's terms unchanged."""
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float32)
    ps = [_Part(s, dtype) for s in parts]
    assert stage_kernel_bneck.bneck_supported(ps, planes, lab, nh, ncls, **kw) is takes
    if takes and dtype == torch.float32:  # (the bf16 wrapper checks contiguity itself)
        ps[0]._contiguous = False
        assert not stage_kernel_bneck.bneck_supported(ps, planes, lab, nh, ncls, **kw)


def test_gate_follows_the_planes_limit_in_f32():
    """The f32 route's only width term is the one planes limit, which the
    deep-stage opt-in raises for both routes."""
    ps = [_Part((1, 16, 16, 1536))]
    assert not stage_kernel_bneck.bneck_supported(ps, 512, 3, 32)
    stage_kernel.set_pack_max_planes(512)
    try:
        assert stage_kernel_bneck.bneck_supported(ps, 512, 3, 32)
    finally:
        stage_kernel.set_pack_max_planes(256)


def test_stage_operands_choose_the_f32_bottleneck_packing():
    """The model's kept operands: for f32 parts on the card the f32 route's
    packing (``pack_stage_bneck_f32``), for bf16 ones the bf16 kernel's,
    each made once per weight version."""
    gen = torch.Generator().manual_seed(1)
    block, spade, head = _block((8, 24), 32, gen, ncls=3)
    final = torch.nn.Module()
    final.weight, final.bias = (torch.nn.Parameter(t) for t in head)
    f32 = (_Part((1, 8, 8, 8)), _Part((1, 8, 8, 24)))
    packed = ssunet._stage_operands(f32, block, spade, final)[3]
    assert packed["route"] == "f32" and packed["conv3"]["chans"] == (32, 8, 24)
    assert packed["head"]["cout"] == 3
    assert ssunet._stage_operands(f32, block, spade, final)[3] is packed
    bf16 = tuple(_Part(p.shape, BF16) for p in f32)
    other = ssunet._stage_operands(bf16, block, spade, final)[3]
    assert "route" not in other and other["dtype"] == BF16 and "nt" in other["conv3"]
    with torch.no_grad():
        block.conv2.weight.mul_(2.0)
    again = ssunet._stage_operands(f32, block, spade, final)[3]
    assert again is not packed and again["route"] == "f32"


def test_narrow_model_runs_the_f32_route(monkeypatch):
    """A narrow ``UNet_B_SS`` f32 forward with kernel 8f's launches (the
    emulated 3xTF32 arithmetic) in place of its six fused stages equals the
    port's own CPU forward (the stages' plain version): six stages, six
    launches each and one for the folded head."""
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32)
    model = build_model("UNet_B_SS", 3, filters=B_FILTERS, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
    x = torch.randn((2, 32, 32, 3), generator=gen)
    with torch.no_grad():
        want = model(x)
    stages, log = [], []
    launch = _counted(stage_kernel.f32_conv_emulated, log)

    def route(parts, bp, sp, head=None, packed=None, up=None):
        assert up is None and all(p.dtype == torch.float32 for p in parts)
        stages.append(tuple(p.shape[-1] for p in parts))
        pk = stage_kernel_bneck.pack_stage_bneck_f32(stages[-1], bp, sp, head)
        return stage_kernel_bneck.f32_bneck_launches(parts, pk, launch)

    monkeypatch.setattr(ssunet, "fused_eval_stage_bneck", route)
    with torch.no_grad():
        got = model(x)
    assert len(stages) == 6 and len(log) == 6 * 6 + 1
    assert got.shape == want.shape == (2, 32, 32, 3)
    _close(got, want)


def test_fused_stage_toggle_sends_bottleneck_stages_to_the_composition(monkeypatch):
    """``set_fused_stage(False)`` turns the Bottleneck stages off as well, as
    the JAX dispatch does (ssunet_gan_tpu/models/ssunet.py:249): a narrow
    ``UNet_B_SS`` forward then calls no fused bottleneck stage and equals
    its forward with the planes limit at 0 bit for bit; with the toggle
    back on its six stages are fused again."""
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32)
    model = build_model("UNet_B_SS", 3, filters=B_FILTERS, seed=0, device="cpu")
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    calls = []
    fused = ssunet.fused_eval_stage_bneck

    def counted(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    monkeypatch.setattr(ssunet, "fused_eval_stage_bneck", counted)
    stage_kernel.set_fused_stage(False)
    try:
        with torch.no_grad():
            off = model(x)
    finally:
        stage_kernel.set_fused_stage(None)
    assert calls == []
    with torch.no_grad():
        model(x)
    assert len(calls) == 6
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 0)
    with torch.no_grad():
        assert torch.equal(model(x), off)
