"""The deep-stage opt-in of the fused eval kernels (``ops/stage_kernel.py``
``set_pack_max_planes``, the JAX package's opt-in of the same name), on the
CPU: the port's gates against the JAX package's at the limits 256 / 384 /
512 / 768, and on the card's terms; the N blocks of the conv cores and
their packed weight; the int8 stage at 384 planes against JAX's
``fused_eval_stage_int8`` in Pallas interpret mode
(``tests/test_torch_int8.py``'s bars: rel L2 ≤ 1e-4 with one band,
``tracks_f32``); a narrow flagship whose two 8×8 stages take the deep
route, against the JAX module composition (``tests/test_torch_model.py``'s
bar, rtol = atol = 5e-4), and its int8 forward against the port's f32
composition (the JAX int8 bar). Kernels 1 and 8's deep stages against the
JAX kernels are in ``tests/test_torch_deep_stages_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jq8
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from test_torch_int8 import rel_l2, tracks_f32
from torch_port_helpers import conv_from_packed, jax_eval_stage, jax_toggles

LIMITS = (256, 384, 512, 768)


@pytest.fixture(autouse=True)
def _modes():
    """JAX's fused stages on and both packages' limits at 768 unless a test
    sets its own; the port's modes back at their defaults after."""
    with jax_toggles(fused_stage=True, pack_max_planes=768):
        yield
    q8.set_int8_stage(False)
    q8.set_int8_calibration(None)


# ---- the gate ----------------------------------------------------------------

# (part shapes, planes, block): the flagship's and UNet_B_SS's deep signatures
# at 8×8, a shallow one, a deep one at 4×4 (H not a multiple of 8), and
# stages past 768
GATE_SIGS = [
    ([(2, 8, 8, 256)], 384, "basic"),                    # conv3_0
    ([(2, 8, 8, 384)], 512, "basic"),                    # conv4_0
    ([(2, 8, 8, 512)], 768, "basic"),                    # conv5_0
    ([(2, 8, 8, 512), (2, 8, 8, 512)], 512, "basic"),    # conv4_1
    ([(2, 8, 8, 384), (2, 8, 8, 384)], 384, "basic"),    # conv3_1
    ([(2, 16, 16, 64)], 128, "basic"),                   # shallow
    ([(2, 4, 4, 384)], 512, "basic"),                    # H = 4
    ([(2, 8, 8, 768)], 1024, "basic"),                   # past 768
    ([(2, 8, 8, 256)], 512, "bneck"),                    # UNet_B_SS conv3_0
    ([(2, 8, 8, 512), (2, 8, 8, 1024)], 512, "bneck"),   # UNet_B_SS conv3_1
    ([(2, 8, 8, 512)], 1024, "bneck"),                   # UNet_B_SS conv4_0
]


@pytest.mark.parametrize("limit", LIMITS)
def test_gate_admits_what_the_jax_gate_admits(limit):
    """At each limit the port's one gate admits exactly the stages JAX's
    ``fused_stage_supported(pack=True)`` (eval, int8) and
    ``fused_bneck_supported`` admit: planes up to the limit at H ≥ 8; in
    training (JAX without ``pack``) never past 256."""
    stage_kernel.set_pack_max_planes(limit)
    jax_stage_kernel.set_pack_max_planes(limit)
    assert stage_kernel.max_planes() == limit and stage_kernel.max_planes(train=True) == 256
    for shapes, planes, kind in GATE_SIGS:
        parts = [torch.zeros(s) for s in shapes]
        jparts = [jnp.zeros(s) for s in shapes]
        widths = (planes, 3, planes // 16, 0)
        want = planes <= limit and shapes[0][1] >= 8
        if kind == "bneck":
            got = stage_kernel_bneck.bneck_supported(parts, *widths)
            assert got == jax_stage_kernel.fused_bneck_supported(jparts, planes) == want
            continue
        assert (stage_kernel.stage_supported(parts, *widths)
                == jax_stage_kernel.fused_stage_supported(jparts, planes, pack=True) == want)
        assert (stage_kernel.stage_supported(parts, *widths, int8=True)
                == jax_stage_kernel.fused_stage_supported(jparts, planes, pack=True, int8=True)
                == want)
        assert (stage_kernel.stage_supported(parts, *widths, train=True)
                == jax_stage_kernel.fused_stage_supported(jparts, planes)
                == (planes <= 256 and shapes[0][1] >= 8))


class OnCard:
    """What the gates read of a tensor on the card (this machine has none)."""

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return True

    def dim(self):
        return len(self.shape)


# (parts, planes, hidden, dtype, what the card's gates say at the default
# limit and at 768: eval, train, int8, Bottleneck)
CARD_SIGS = [
    ([(8, 64, 64, 256)], 384, 24, torch.bfloat16, (False,) * 4, (True, False, True, True)),
    ([(8, 32, 32, 512)] * 2, 512, 32, torch.bfloat16, (False,) * 4, (True, False, True, True)),
    ([(8, 16, 16, 512)], 768, 48, torch.bfloat16, (False,) * 4, (True, False, True, True)),
    ([(8, 16, 16, 512)], 768, 48, torch.float32, (False,) * 4, (True, False, False, True)),
    ([(8, 32, 32, 256)], 512, 128, torch.bfloat16, (False,) * 4, (False,) * 4),  # SSUNet 4_0
    ([(8, 16, 16, 768)], 800, 50, torch.bfloat16, (False,) * 4, (False,) * 4),   # past 768
    ([(8, 64, 64, 64)], 128, 8, torch.bfloat16, (True,) * 4, (True,) * 4),       # shallow
]


@pytest.mark.parametrize("shapes,planes,nh,dtype,at256,at768", CARD_SIGS,
                         ids=[str(i) for i in range(len(CARD_SIGS))])
def test_card_gates_take_the_deep_stages_only_when_raised(shapes, planes, nh, dtype, at256,
                                                         at768):
    """On the card the deep stages enter kernels 1 (bf16 and its f32
    route), 7 and 8 (bf16 and its f32 route) with the limit raised and
    never in training; hidden 128 (SSUNet's 512-plane stage) stays past
    the SPADE tail's 64."""
    parts = [OnCard(s, dtype) for s in shapes]
    for limit, want in ((256, at256), (768, at768)):
        stage_kernel.set_pack_max_planes(limit)
        got = (stage_kernel.stage_supported(parts, planes, 3, nh),
               stage_kernel.stage_supported(parts, planes, 3, nh, train=True),
               stage_kernel.stage_supported(parts, planes, 3, nh, int8=True),
               stage_kernel_bneck.bneck_supported(parts, planes, 3, nh))
        assert got == want, limit


# ---- the eval conv core's N blocks ----------------------------------------------


@pytest.mark.parametrize("cout,nt,nblk", [(256, 256, 1), (288, 192, 2), (384, 192, 2),
                                          (512, 256, 2), (768, 256, 3), (1024, 256, 4)])
def test_n_blocks_of_the_conv_cores(cout, nt, nblk):
    """Past 256 output channels the eval conv core and launch A of the s8
    core run in N blocks of at most 256 (an even share: 384 = 2 × 192);
    launch B keeps its blocks of 128."""
    assert (stage_kernel.eval_nt(cout), stage_kernel.eval_blocks(cout, nt)) == (nt, nblk)
    assert q8.s8_nt(cout, "h1") == (nt, nblk)
    assert q8.s8_nt(cout, "y") == (128, -(-cout // 128))


@pytest.mark.parametrize("cout", [320, 384, 768])
def test_packed_n_blocks_are_the_kernels_gemm(cout):
    """``pack_eval_conv``'s operand past 256 channels (320: a partial last N
    block; 384 in two blocks of 192; 768 in three of 256), a 3×3 and a 1×1
    K-segment, walked N block by N block in the eval conv core's K order
    (``conv_from_packed``), gives the plain convs' sums (f32: exact up to
    the summation order, 1e-4)."""
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn((cout, 8, 3, 3), generator=gen), torch.randn((cout, 24, 1, 1), generator=gen)]
    xs = [torch.randn((1, 4, 5, 8), generator=gen), torch.randn((1, 4, 5, 24), generator=gen)]
    conv = stage_kernel.pack_eval_conv(ws, None, torch.float32)
    nt = stage_kernel.eval_nt(cout)
    assert (conv["nt"], conv["nblk"]) == (nt, -(-cout // nt))
    assert conv["w"].shape[0] == conv["nblk"] * conv["steps"]
    got = conv_from_packed(xs, conv)
    want = stage_kernel.eval_conv_reference(xs, ws, main=1)  # ReLU of the same sum
    np.testing.assert_allclose(torch.relu(got).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# ---- kernel 7 at 384 planes against the JAX kernel -------------------------------


def test_deep_int8_stage_matches_jax(rng):
    """The int8 stage at 384 planes (dynamic scales, one band) against JAX's
    ``fused_eval_stage_int8``: relative L2 ≤ 1e-4, both tracking the f32
    composition."""
    st = jax_eval_stage(rng, 384, [(1, 8, 8, 64)])
    parts = (torch.from_numpy(st["xs"][0]),)
    want = np.asarray(jq8.fused_eval_stage_int8(st["jparts"], st["jbp"], st["jsp"]))
    got, h1, y = q8.fused_eval_stage_int8(parts, st["tbp"], st["tsp"], intermediates=True)
    assert h1.shape == y.shape == got.shape == (1, 8, 8, 384)
    got = got.numpy()
    assert rel_l2(got, want) <= 1e-4, rel_l2(got, want)
    tracks_f32(got, st["composition"])
    tracks_f32(want, st["composition"])


# ---- a narrow flagship ------------------------------------------------------------

# at 64² the levels are 64, 32, 16, 8, 4 and 2 rows: conv3_0 and conv3_1
# (288 planes) take the deep route at 8², the 4² and 2² levels are refused
FILTERS = (8, 16, 32, 288, 320, 384)


@pytest.fixture(scope="module")
def narrow():
    """The port's narrow flagship (seeded, random BN statistics) and the JAX
    model on the same weights through the JAX package's torch converter
    (its variables' tree from ``eval_shape``: no JAX init is run)."""
    gen = torch.Generator().manual_seed(3)
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu", seed=0)
    for m in port.modules():
        if isinstance(m, BatchNorm):
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
    model = JUNetRSSv2(num_classes=3, input_channels=3, filters=FILTERS)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    with jax_toggles(fused_stage=False):
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x0, train=False))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    variables, report = convert_torch_state_dict(port.state_dict(), template)
    assert report["unmatched"] == [] and report["skipped"] == []
    tiles = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return model, variables, port, tiles


def _spy(monkeypatch, name, seen):
    fn = getattr(ssunet, name)

    def counted(parts, block_params, *args, **kwargs):
        seen.append((name, block_params[2].shape[0]))
        return fn(parts, block_params, *args, **kwargs)
    monkeypatch.setattr(ssunet, name, counted)


def test_narrow_flagship_takes_the_deep_route(narrow, monkeypatch):
    """At the limit 384 the two 288-plane stages run through the fused
    wrapper (8 stages, 6 at the default limit; the kept operands are packed
    when a stage is first admitted), and the forward matches JAX's module
    composition (rtol = atol = 5e-4, ``tests/test_torch_model.py``'s bar);
    with the limit at its default the port's forward is the same."""
    model, variables, port, tiles = narrow
    with jax_toggles(fused_stage=False):
        want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, False))(variables, tiles))
    seen = []
    _spy(monkeypatch, "fused_eval_stage", seen)
    x = torch.from_numpy(tiles)
    outs = {}
    for limit in (256, 384):
        stage_kernel.set_pack_max_planes(limit)
        seen.clear()
        with torch.no_grad():
            outs[limit] = port(x).numpy()
        deep = sorted(p for _, p in seen if p > 256)
        assert (len(seen), deep) == ((6, []) if limit == 256 else (8, [288, 288])), seen
        assert (getattr(port.conv3_0, "_fused_operands", None) is None) == (limit == 256)
    for got in outs.values():
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_narrow_int8_forward_takes_the_deep_int8_stages(narrow, monkeypatch):
    """The int8 mode at the limit 384: conv3_0 and conv3_1 on the int8
    stage (8 in all) and only the three refused 4² / 2² stages on the deep
    s8 block; the logits track the port's own f32 composition by the JAX
    int8 bar (relative RMS < 0.02, correlation > 0.999)."""
    _, _, port, tiles = narrow
    x = torch.from_numpy(tiles)
    stage_kernel.set_fused_stage(False)
    try:
        with torch.no_grad():
            f32 = port(x).numpy()
    finally:
        stage_kernel.set_fused_stage(None)
    seen = []
    for name in ("fused_eval_stage_int8", "int8_block"):
        _spy(monkeypatch, name, seen)
    stage_kernel.set_pack_max_planes(384)
    q8.set_int8_stage(True)
    with torch.no_grad():
        got = port(x).numpy()
    names = [n for n, _ in seen]
    assert (names.count("fused_eval_stage_int8"), names.count("int8_block")) == (8, 3), seen
    assert sorted(p for n, p in seen if n == "fused_eval_stage_int8" and p > 256) == [288, 288]
    tracks_f32(got, f32)
