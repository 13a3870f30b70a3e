"""The port's CUDA kernels (the fused eval stage, the train kernels, the int8
fused stage) against their plain PyTorch versions, on the card. Every test
here needs a CUDA card and skips without one; run them on the card with ``python -m pytest tests/test_torch_gpu.py --noconftest -q``
(``tests/conftest.py`` imports JAX, which the card's machine lacks).

Tolerance: both sides round h1, y, seg, act and γ|β to bf16 and differ
only in the order of their f32 sums, so an occasional 1-ulp flip of an
intermediate propagates; a stage's output must agree within 2% of its
largest magnitude (about 5 bf16 ulps there) plus 1e-3, and within 1e-2 in
relative L2 norm. The full forward has its own bound (its test).
"""

import pytest
import torch

from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.spade import SPADE


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False  # f32 plain convs stay f32
    return torch.device("cuda")


def _randomize_bn(module, gen):
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)


def _plain_eval_stage(parts, bp, sp, head=None, packed=None, up=None, down=None):
    """Kernel 1's plain version with its wrapper's signature (seams
    materialized)."""
    return stage_kernel.fused_stage_reference(stage_kernel.materialize_seams(parts, up, down),
                                              bp, sp, head)


def _close(got, want):
    diff = got.float() - want.float()
    err, scale = diff.abs().max().item(), want.float().abs().max().item()
    l2 = (diff.norm() / want.float().norm()).item()
    return (err, scale, l2), err <= 2e-2 * scale + 1e-3 and l2 <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,planes,labels,nhw,ncls",
    [
        ((3,), 64, 3, (2, 40, 36), 0),          # 3-channel first block, ragged tiles
        ((64,), 128, 3, (1, 32, 32), 0),        # encoder
        ((128, 128), 128, 3, (1, 24, 20), 0),   # decoder, two parts
        ((256, 256), 256, 3, (2, 16, 16), 0),   # widest fused stage
        ((64, 128), 64, 3, (2, 48, 40), 3),     # folded final head
        ((32, 32), 64, 2, (1, 9, 13), 2),       # odd sizes, M tail < 128
    ],
)
def test_fused_stage_kernel_matches_plain(chans, planes, labels, nhw, ncls):
    dev = _card()
    gen = torch.Generator().manual_seed(0)
    block = BasicBlock(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16, generator=gen)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen)
        head = (final.weight.to(dev), final.bias.to(dev))
    block.to(dev).eval()
    spade.to(dev)
    n, h, w = nhw
    parts = tuple(torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
                  for c in chans)
    before = stage_kernel.launches
    got = stage_kernel.fused_eval_stage(parts, block.stage_params(),
                                        spade.stage_params(), head)
    torch.cuda.synchronize()
    assert stage_kernel.launches == before + 1
    want = stage_kernel.fused_stage_reference(parts, block.stage_params(),
                                              spade.stage_params(), head)
    assert got.shape == want.shape == (n, h, w, ncls or planes)
    errs, ok = _close(got, want)
    assert ok, errs


# The eval conv core (csrc/eval_conv.cuh), one launch against its plain
# version: (source channels, kernel sizes, cout, segments summed before the
# bias, identity shortcut over the 1x1 segments after the first)
EVAL_CONV_CASES = {
    "3x3-rgb": ((3,), (3,), 64, None, False),
    "3x3-64": ((64,), (3,), 128, None, False),
    "3x3-two-unequal-parts": ((128, 256), (3, 3), 128, None, False),
    "3x3-and-1x1-shortcut": ((256, 128, 256), (3, 1, 1), 256, 1, False),
    "1x1-and-identity": ((64, 32, 32), (1, 1, 1), 64, 1, True),
    "1x1-two-parts": ((256, 512), (1, 1), 256, None, False),
    "planes-32": ((32,), (3,), 32, None, False),
    "planes-96": ((96, 48), (3, 1), 96, 1, False),
    "planes-192": ((16, 64), (3, 3), 192, None, False),
    # narrow sources over many tiles: a k16 step's padded half must not read
    # past the window (uninitialized shared memory times a zero weight can
    # be a NaN)
    "3x3-rgb-many-tiles": ((3,), (3,), 64, None, False, (2, 128, 96)),
    "1x1-rgb-many-tiles": ((3, 8), (1, 1), 256, None, False, (2, 64, 96)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EVAL_CONV_CASES))
def test_eval_conv_kernel_matches_plain(name):
    from ssunet_gan_tpu_torch.ops.stage_kernel import split_in

    dev = _card()
    chans, ks, cout, main, identity, *nhw = EVAL_CONV_CASES[name]
    gen = torch.Generator().manual_seed(5)
    n, h, w = nhw[0] if nhw else (3, 9, 13)
    sources = tuple(torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
                    for c in chans)
    weights = [(torch.randn((cout, c, k, k), generator=gen) / (c * k * k) ** 0.5).bfloat16()
               .float().to(dev) for c, k in zip(chans, ks)]
    if identity:
        weights[1:] = split_in(torch.eye(cout, device=dev)[:, :, None, None], chans[1:])
    bias = (torch.randn(cout, generator=gen) * 0.1).bfloat16().float().to(dev)
    conv = stage_kernel.pack_eval_conv(weights, bias, torch.bfloat16, main)
    before = stage_kernel.conv_launches
    got = stage_kernel.eval_conv(sources, conv)
    torch.cuda.synchronize()
    assert stage_kernel.conv_launches == before + 1
    want = stage_kernel.eval_conv_reference(sources, weights, bias, main)
    assert got.shape == want.shape == (n, h, w, cout)
    errs, ok = _close(got, want)
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("chans,planes", [((3,), 64), ((128, 256), 128), ((96,), 256),
                                          ((16, 48), 32)])
def test_eval_conv_residual_matches_plain(chans, planes):
    """The residual epilogue (the train tail's y) on the eval conv core."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops.stage_kernel import _q, split_in

    dev = _card()
    gen = torch.Generator().manual_seed(6)
    n, h, w = 3, 9, 13
    parts = tuple(_bf16(gen, (n, h, w, c), dev) for c in chans)
    f2 = _bf16(gen, (n, h, w, planes), dev)
    a2 = (torch.rand(planes, generator=gen) + 0.5).to(dev)
    b2 = (torch.randn(planes, generator=gen) * 0.3).to(dev)
    ws = (torch.randn((planes, sum(chans), 1, 1), generator=gen) * 0.1).to(dev)
    sp = SPADE("spadebatch3x3", planes, 3, planes / 16, generator=gen).to(dev).stage_params()
    before = tst.launches["train_tail"]
    y = tst.train_tail(f2, parts, a2, b2, ws, sp)[1]
    torch.cuda.synchronize()
    assert tst.launches["train_tail"] == before + 1
    want = stage_kernel.eval_conv_reference(parts, split_in(_q(ws, torch.bfloat16), chans),
                                            res=(f2, a2, b2))
    errs, ok = _close(y, want)
    assert ok, errs


@pytest.mark.gpu
def test_fused_stage_kernel_refuses_float32():
    """The bf16 kernel's launcher raises for f32 parts; the wrapper sends
    f32 stages to the f32 route (``test_f32_stage_route_matches_plain``)."""
    dev = _card()
    block = BasicBlock(64, 128).to(dev)
    spade = SPADE("spadebatch3x3", 128, 3, 8.0).to(dev)
    x = torch.zeros((1, 16, 16, 64), device=dev)
    pk = stage_kernel.pack_stage((64,), block.stage_params(), spade.stage_params(), None,
                                 torch.bfloat16)
    with pytest.raises(TypeError):
        stage_kernel._run_cuda((x,), pk)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,planes,labels,nhw,ncls",
    [
        ((3,), 64, 3, (2, 40, 36), 0),          # 3-channel first block, ragged tiles
        ((64,), 128, 3, (1, 32, 32), 0),        # encoder
        ((128, 128), 128, 3, (1, 24, 20), 0),   # decoder, two parts
        ((256, 256), 256, 3, (2, 16, 16), 0),   # widest fused stage
        ((64, 128), 64, 3, (2, 48, 40), 3),     # folded final head
        ((6, 10), 24, 5, (1, 19, 13), 2),       # widths off the chunk grid, odd map
    ],
)
def test_f32_stage_route_matches_plain(chans, planes, labels, nhw, ncls):
    """The f32 route of kernel 1 (``csrc/fused_stage_f32.cu``, 3xTF32 on
    the tensor cores) against the stage's plain version in f32 (TF32 off):
    the same products to ~2^-22 summed in another order, so max error ≤
    1e-4 of max |plain| and relative L2 ≤ 1e-4; one stage, five conv
    launches (six with the head; the modulate rides the γ|β launch)."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    block = BasicBlock(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    block.to(dev).eval()
    spade = SPADE("spadebatch3x3", planes, labels, max(planes / 16, 4), generator=gen).to(dev)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen).to(dev)
        head = (final.weight, final.bias)
    parts = tuple(torch.randn(nhw + (c,), generator=gen).to(dev) for c in chans)
    bp, sp = block.stage_params(), spade.stage_params()
    before = (stage_kernel.f32_launches, stage_kernel.f32_conv_launches,
              stage_kernel.f32_modulate_launches, stage_kernel.launches)
    got = stage_kernel.fused_eval_stage(parts, bp, sp, head)
    torch.cuda.synchronize()
    assert (stage_kernel.f32_launches, stage_kernel.f32_conv_launches,
            stage_kernel.f32_modulate_launches, stage_kernel.launches) == (
        before[0] + 1, before[1] + (6 if ncls else 5), before[2], before[3])
    want = stage_kernel.fused_stage_reference(parts, bp, sp, head)
    diff = got - want
    err, scale = diff.abs().max().item(), want.abs().max().item()
    l2 = (diff.norm() / want.norm()).item()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert err <= 1e-4 * scale and l2 <= 1e-4, (err, scale, l2)


@pytest.mark.gpu
@pytest.mark.parametrize("chans", [(3,), (64, 128)], ids=["first", "decoder"])
def test_f32_stage_route_keeps_non_finite_classes(chans):
    """+inf, -inf and NaN planted in a stage's first part: each output's
    class (finite, NaN, +inf, -inf) equals the one the per-launch plain
    versions give (exact f32 products, whose classes do not depend on the
    summation order)."""
    dev = _card()
    gen = torch.Generator().manual_seed(8)
    planes = 64
    block = BasicBlock(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    block.to(dev).eval()
    spade = SPADE("spadebatch3x3", planes, 3, 4.0, generator=gen).to(dev)
    parts = [torch.randn((2, 32, 24, c), generator=gen) for c in chans]
    flat = parts[0].view(-1)
    pos = torch.randperm(flat.numel(), generator=gen)[:9]
    flat[pos] = torch.tensor([float("inf"), float("-inf"), float("nan")] * 3)
    parts = tuple(p.to(dev) for p in parts)
    pk = stage_kernel.pack_stage_f32(chans, block.stage_params(), spade.stage_params(), None)
    got = stage_kernel.fused_eval_stage(parts, block.stage_params(), spade.stage_params(),
                                        None, pk)
    want = stage_kernel.f32_stage_launches(parts, pk)

    def classes(t):
        return torch.isnan(t) * 1 + torch.isposinf(t) * 2 + torch.isneginf(t) * 3

    assert bool(torch.isnan(want).any())
    assert torch.equal(classes(got), classes(want))
    fin = torch.isfinite(want)
    assert torch.allclose(got[fin], want[fin], rtol=1e-4,
                          atol=1e-4 * want[fin].abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stage_keeps_a_planted_nan(dtype):
    """A NaN in one channel of one input pixel: kernel 1 (bf16, and its f32
    route) gives NaN exactly where the stage's receptive field reaches it
    (Chebyshev radius 5 around it: conv1, conv2, seg, act and γ|β, each
    3×3, every weight nonzero) and finite values elsewhere, as the plain
    version and the JAX package do (``torch.relu`` and ``jnp.maximum``
    keep NaN). A ReLU written as ``fmaxf(v, 0)`` turns the NaN into 0 and
    the whole output finite."""
    dev = _card()
    gen = torch.Generator().manual_seed(9)
    block = BasicBlock(64, 128, generator=gen)
    _randomize_bn(block, gen)
    block.to(dev).eval()
    spade = SPADE("spadebatch3x3", 128, 3, 8.0, generator=gen).to(dev)
    x = torch.randn((2, 32, 32, 64), generator=gen)
    b, py, px = 1, 9, 20
    x[b, py, px, 7] = float("nan")
    before = stage_kernel.launches, stage_kernel.f32_launches
    out = stage_kernel.fused_eval_stage((x.to(dev, dtype),), block.stage_params(),
                                        spade.stage_params())
    assert (stage_kernel.launches - before[0], stage_kernel.f32_launches - before[1]) == (
        (1, 0) if dtype == torch.bfloat16 else (0, 1))
    yy, xx = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    want = torch.zeros((2, 32, 32), dtype=torch.bool)
    want[b] = torch.maximum((yy - py).abs(), (xx - px).abs()) <= 5
    nan = torch.isnan(out.float()).cpu()
    assert torch.equal(nan, want[..., None].expand_as(nan))
    assert bool(torch.isfinite(out.float()[~want.to(dev)]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("modulate", [False, True], ids=["conv", "gamma_beta_modulate"])
def test_f32_conv_launch_matches_its_plain_version(modulate):
    """One f32 conv launch over three K-segments (a 3×3 part, two 1×1
    parts, widths off the chunk grid) on a ragged map against its plain
    version; and the γ|β launch with the modulate in its epilogue:
    relative L2 ≤ 1e-5."""
    dev = _card()
    gen = torch.Generator().manual_seed(6)
    segs = ((4, 3),) if modulate else ((40, 3), (24, 1), (6, 1))
    cout = 140 if modulate else 70
    xs = [torch.randn((2, 19, 13, c), generator=gen).to(dev) for c, _ in segs]
    ws = [(torch.randn((cout, c, k, k), generator=gen) * 0.1).to(dev) for c, k in segs]
    conv = stage_kernel.pack_f32_conv(ws, torch.randn(cout, generator=gen).to(dev), True,
                                      modulate=modulate)
    y = torch.randn((2, 19, 13, cout // 2), generator=gen).to(dev) if modulate else None
    got = stage_kernel.f32_conv(xs, conv, y)
    want = stage_kernel.f32_conv_reference(xs, conv, y)
    assert ((got - want).norm() / want.norm()).item() <= 1e-5


@pytest.mark.gpu
def test_flagship_f32_forward_runs_the_composition():
    """With the fused stages off, an f32 forward on the card runs every
    stage through the module composition (no kernel stage, no f32 stage)
    and agrees with the CPU's f32 forward with the fused stages off: the
    same f32 modules in another summation order (TF32 off), to
    chip_smoke.py's bar of 1e-2 relative L2 (a last-bit difference can
    move a max-pool's winner)."""
    import copy

    dev = _card()
    model = build_model("UNet_R_SS_v2", 3, 3, seed=0, device=dev).eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    before = stage_kernel.launches, stage_kernel.f32_launches
    stage_kernel.set_fused_stage(False)
    try:
        with torch.no_grad():
            got = model(x.to(dev)).cpu()
            want = cpu_model(x)
    finally:
        stage_kernel.set_fused_stage(None)
    assert (stage_kernel.launches, stage_kernel.f32_launches) == before
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.gpu
def test_flagship_f32_forward_takes_the_f32_route():
    """An f32 forward on the card runs its six fused stages on the f32
    route of kernel 1 (no bf16 stage) and agrees with the CPU's f32 forward
    with the fused stages off to the same bar of 1e-2 relative L2."""
    import copy

    dev = _card()
    model = build_model("UNet_R_SS_v2", 3, 3, seed=0, device=dev).eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    before = stage_kernel.launches, stage_kernel.f32_launches
    with torch.no_grad():
        got = model(x.to(dev)).cpu()
    assert (stage_kernel.launches, stage_kernel.f32_launches) == (before[0], before[1] + 6)
    stage_kernel.set_fused_stage(False)
    try:
        with torch.no_grad():
            want = cpu_model(x)
    finally:
        stage_kernel.set_fused_stage(None)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.gpu
def test_flagship_forward_kernel_matches_plain(monkeypatch):
    """Full-width flagship at 64×64: six kernel stages per forward, logits
    against the same forward with every stage on the plain version, in bf16
    and in f32. Two correct bf16 forwards differ by more than one stage
    does (a rounding flip moves a max-pool's winner, which the unpool
    carries to another pixel), so the bound is the plain bf16 forward's own
    distance from f32: the kernel's relative L2 distance from f32 at most
    1.25 times it, and kernel and plain no further apart than it."""
    dev = _card()
    model = build_model("UNet_R_SS_v2", 3, 3, seed=0, device=dev)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(dev, torch.bfloat16)
    before = stage_kernel.launches
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert stage_kernel.launches == before + 6
    from ssunet_gan_tpu_torch.models import ssunet

    monkeypatch.setattr(ssunet, "fused_eval_stage",
                        _plain_eval_stage)
    with torch.no_grad():
        plain = model(x)
        f32 = model(x.float())
    rel = lambda u, v: ((u.float() - v.float()).norm() / v.float().norm()).item()
    e_k, e_p, e_kp = rel(got, f32), rel(plain, f32), rel(got, plain)
    assert torch.isfinite(got.float()).all() and got.shape == f32.shape
    assert e_k <= 1.25 * e_p and e_kp <= e_p, (e_k, e_p, e_kp)


@pytest.mark.gpu
def test_tile_forward_defaults_to_bf16_on_the_card():
    """The entry point's own defaults reach the bf16-only kernel."""
    from ssunet_gan_tpu_torch.infer.api import tile_forward

    dev = _card()
    # six fused stages, as in the flagship: planes <= 256 on the top three levels
    model = build_model("UNet_R_SS_v2", 3, filters=(32, 64, 96, 288, 320, 352), seed=0)
    x = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    before = stage_kernel.launches
    p = tile_forward(model, x)
    torch.cuda.synchronize()
    assert stage_kernel.launches == before + 6
    assert p.device.type == dev.type and p.dtype == torch.bfloat16
    assert p.shape == (2, 32, 32, 3) and torch.isfinite(p.float()).all()


# ---- train-stage kernels (conv_stats and wgrad on csrc/bwd_core.cuh's cores,
# train_tail in csrc/train_stage.cu) against their plain versions.
# Outputs: the bar above (both sides round to bf16 at the same places). The
# per-channel sums of the rounded outputs: relative error ≤ 1e-3 of the
# largest sum plus 1e-3 (a rare 1-ulp output flip moves a sum by ~1e-5 of
# it). Weight gradients: relative L2 ≤ 1e-3 (the same bf16 products summed
# in another order).


def _bf16(gen, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,cout,nhw,prologue,bias",
    [
        ((3,), 64, (2, 40, 36), False, False),      # conv1 of the first block, ragged
        ((64,), 64, (2, 32, 32), True, False),      # conv2 with the BN1+ReLU prologue
        ((128, 128), 128, (1, 24, 20), False, False),  # two parts
        ((8,), 128, (2, 16, 16), False, True),      # γ|β recompute (nh → 2C, bias)
        ((16,), 3, (2, 16, 16), False, False),      # backward-data to 3 labels
        ((3,), 16, (1, 9, 13), False, False),       # from 3 channels, odd sizes
        ((512,), 384, (1, 16, 16), False, False),   # backward-data to the 2-part input
        # the forward's conv1 at the flagship's widths, small images
        ((64,), 128, (2, 12, 20), False, False),
        ((128,), 256, (1, 10, 18), False, False),
        ((64, 128), 64, (2, 12, 20), False, False),
        ((128, 256), 128, (1, 10, 18), False, False),
        ((256, 256), 256, (1, 8, 16), False, False),
        # conv2 with the prologue at 128 and 256 planes
        ((128,), 128, (2, 10, 20), True, False),
        ((256,), 256, (1, 12, 18), True, False),
        # narrow images: W = 5, H = 1, batch 3
        ((64, 128), 64, (3, 7, 5), False, False),
        ((128,), 128, (3, 1, 21), True, False),
        ((3,), 64, (3, 1, 5), False, False),
    ],
)
def test_conv_stats_kernel_matches_plain(chans, cout, nhw, prologue, bias):
    """conv_stats on the conv core of csrc/bwd_core.cuh (counted as
    conv_stats, not as the v3 backward's fused_conv3)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    gen = torch.Generator().manual_seed(0)
    n, h, w = nhw
    parts = tuple(_bf16(gen, (n, h, w, c), dev) for c in chans)
    wt = (torch.randn((cout, sum(chans), 3, 3), generator=gen) * 0.1).to(dev)
    b = (torch.randn(cout, generator=gen) * 0.3).to(dev) if bias else None
    pro = None
    if prologue:
        pro = ((torch.rand(chans[0], generator=gen) + 0.5).to(dev),
               (torch.randn(chans[0], generator=gen) * 0.3).to(dev))
    before, before3 = tst.launches["conv_stats"], ttb.launches["fused_conv3"]
    out, sums = tst.conv_stats(parts, wt, b, pro)
    torch.cuda.synchronize()
    assert tst.launches["conv_stats"] == before + 1
    assert ttb.launches["fused_conv3"] == before3
    want, want_sums = tst.conv_stats_reference(parts, wt, b, pro)
    errs, ok = _close(out, want)
    assert ok, errs
    d = (sums - want_sums).abs().max().item()
    assert d <= 1e-3 * want_sums.abs().max().item() + 1e-3, d


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,planes,labels,nhw,ncls",
    [
        ((3,), 64, 3, (2, 40, 36), 0),
        ((128, 256), 128, 3, (1, 24, 20), 0),
        ((64, 128), 64, 3, (2, 48, 40), 3),
    ],
)
def test_train_tail_kernel_matches_plain(chans, planes, labels, nhw, ncls):
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    dev = _card()
    gen = torch.Generator().manual_seed(1)
    n, h, w = nhw
    parts = tuple(_bf16(gen, (n, h, w, c), dev) for c in chans)
    f2 = _bf16(gen, (n, h, w, planes), dev)
    a2 = (torch.rand(planes, generator=gen) + 0.5).to(dev)
    b2 = (torch.randn(planes, generator=gen) * 0.3).to(dev)
    ws = (torch.randn((planes, sum(chans), 1, 1), generator=gen) * 0.1).to(dev)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16, generator=gen).to(dev)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen).to(dev)
        head = (final.weight, final.bias)
    sp = spade.stage_params()
    got = tst.train_tail(f2, parts, a2, b2, ws, sp, head)
    torch.cuda.synchronize()
    want = tst.train_tail_reference(f2, parts, a2, b2, ws, sp, head)
    for name, g, wv in zip(("out", "y", "seg", "actv"), got, want):
        assert g.shape == wv.shape, name
        errs, ok = _close(g, wv)
        assert ok, (name, errs)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,cout,nhw,prologue",
    [
        ((3,), 64, (2, 40, 36), False),
        ((64,), 64, (2, 32, 32), True),
        ((128, 256), 128, (1, 24, 20), False),
        ((8,), 512, (2, 16, 16), False),     # γ|β weights: 2C rows
        ((3,), 4, (1, 9, 13), False),        # 3 labels → nh rows
        ((64, 128), 64, (2, 12, 20), False),  # the decoder's conv1: two parts
        ((256,), 256, (1, 10, 18), True),    # conv2 at 256 planes with the prologue
    ],
)
def test_wgrad_kernel_matches_plain(chans, cout, nhw, prologue):
    """wgrad on the weight-gradient core of csrc/bwd_core.cuh (counted as
    wgrad, not as the v3 backward's fused_wgrad)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    gen = torch.Generator().manual_seed(2)
    n, h, w = nhw
    parts = tuple(_bf16(gen, (n, h, w, c), dev) for c in chans)
    g = _bf16(gen, (n, h, w, cout), dev)
    pro = None
    if prologue:
        pro = ((torch.rand(chans[0], generator=gen) + 0.5).to(dev),
               (torch.randn(chans[0], generator=gen) * 0.3).to(dev))
    before, before6 = tst.launches["wgrad"], ttb.launches["fused_wgrad"]
    got = tst.wgrad(parts, g, pro)
    torch.cuda.synchronize()
    assert tst.launches["wgrad"] == before + 1
    assert ttb.launches["fused_wgrad"] == before6
    want = tst.wgrad_reference(parts, g, pro)
    assert got.shape == want.shape == (cout, sum(chans), 3, 3)
    assert got.dtype == torch.float32
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-3, rel


def _stage_kernel_vs_plain(monkeypatch):
    """Forward, stats and gradients of one stage with the kernels against
    the same Function on the plain versions, both in bf16, and against f32:
    for the output, each statistic, each input gradient and all parameter
    gradients as one vector, the kernel no further from f32 than 1.1 × the
    plain bf16 path and no further from it than that path is from f32. One
    parameter's gradient alone may be a sum that cancels (a bias
    gradient), where both bf16 paths carry noise of the order of the value:
    kernel-plain within 3 × plain-f32 (chip_smoke.py's GRAD_KP)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    gen = torch.Generator().manual_seed(3)
    block = BasicBlock(64 + 128, 64, generator=gen).to(dev)
    spade = SPADE("spadebatch3x3", 64, 3, 4.0, generator=gen).to(dev)
    final = Conv2d(64, 3, 1, generator=gen).to(dev)
    xs = [torch.randn((2, 32, 32, c), generator=gen).to(dev) for c in (64, 128)]
    cot = torch.randn((2, 32, 32, 3), generator=gen).to(dev)
    params = [*block.parameters(), *spade.parameters(), *final.parameters()]

    def run(dtype):
        parts = tuple(x.to(dtype).requires_grad_() for x in xs)
        out, stats = tst.fused_train_stage(parts, block.train_params(),
                                           spade.stage_params(),
                                           (final.weight, final.bias))
        grads = torch.autograd.grad((out.float() * cot).sum(), [*parts, *params])
        flat = torch.cat([g.float().reshape(-1) for g in grads[2:]])
        return [out, *[s for pair in stats for s in pair], *grads[:2], flat], grads[2:]

    kern, kern_p = run(torch.bfloat16)
    for mod, names in ((tst, ("conv_stats", "train_tail", "wgrad")),
                       (ttb, ("fused_conv3", "fused_wgrad"))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name + "_reference"))
    # the f32 run: the same Function on the plain versions, past the gate
    # (which refuses f32 on the card, where the model runs the composition)
    monkeypatch.setattr(tst, "stage_supported", lambda *a, **k: True)
    plain, plain_p = run(torch.bfloat16)
    f32, f32_p = run(torch.float32)
    rel = lambda u, v: ((u.float() - v.float()).norm() / v.float().norm()).item()
    for i, (k, p, f) in enumerate(zip(kern, plain, f32)):
        e_k, e_p, e_kp = rel(k, f), rel(p, f), rel(k, p)
        assert torch.isfinite(k.float()).all()
        assert e_k <= 1.1 * e_p and e_kp <= e_p, (i, e_k, e_p, e_kp)
    for i, (k, p, f) in enumerate(zip(kern_p, plain_p, f32_p)):
        assert rel(k, p) <= 3 * rel(p, f), (i, rel(k, p), rel(p, f))


@pytest.mark.gpu
def test_fused_train_stage_kernel_matches_plain(monkeypatch):
    """The stage with its default backward, v3 (``_stage_kernel_vs_plain``)."""
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    before = dict(ttb.launches)
    _stage_kernel_vs_plain(monkeypatch)
    # κ1, κ3-κ7 and five weight gradients (the kernel run only)
    assert ttb.launches["fused_conv3"] == before["fused_conv3"] + 6
    assert ttb.launches["fused_wgrad"] == before["fused_wgrad"] + 5


@pytest.mark.gpu
def test_fused_train_stage_v2_kernel_matches_plain(monkeypatch):
    """The stage with the v2 backward (``_stage_kernel_vs_plain``)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    monkeypatch.setattr(tst, "_TRAIN_BWD_V3", False)
    before = dict(ttb.launches)
    _stage_kernel_vs_plain(monkeypatch)
    assert ttb.launches == before


# ---- the v3 backward's kernels (csrc/train_bwd.cu) against their plain
# versions, bf16, one test per chain mode; the bars of the train kernels
# above, the stat rows each against their own largest magnitude.


def _bn_consts(gen, c, dev, n):
    """n per-channel f32 constants of BN's backward scale (p, q, r', m', ...)."""
    return tuple(((torch.rand(c, generator=gen) + 0.5) if i % 2 == 0
                  else torch.randn(c, generator=gen) * 0.3).to(dev) for i in range(n))


CONV3_CASES = [
    # mode, C (planes), hidden, labels, parts (bn1), (n, h, w)
    ("gamma", 64, 4, 3, None, (2, 40, 36)),
    ("modgrad", 128, 8, 3, None, (2, 40, 36)),
    ("seg", 64, 16, 3, None, (2, 24, 20)),
    ("pre", 128, 8, 3, None, (2, 40, 36)),
    ("bn2", 64, 4, 3, None, (2, 40, 36)),
    ("bn1", 64, 4, 3, (3,), (2, 40, 36)),
    ("bn1", 64, 4, 3, (64, 128), (1, 24, 20)),
    # the edges of the 8x16 output tile: W not a multiple of 16, W < 16,
    # H = 1, batch 3 (tiles never cross images)
    ("bn2", 64, 4, 3, None, (2, 12, 5)),
    ("modgrad", 64, 4, 3, None, (1, 1, 20)),
    ("pre", 64, 4, 3, None, (3, 9, 21)),
    ("bn1", 128, 8, 3, (128, 256), (1, 12, 20)),  # cout 384 > 256: two N blocks
    # the flagship's narrow widths: labels 3, hidden 4 and 16
    ("gamma", 256, 16, 3, None, (2, 10, 18)),     # 2C = 512: two N blocks
    ("modgrad", 256, 16, 3, None, (2, 10, 18)),
    ("seg", 64, 4, 3, None, (3, 9, 21)),
    ("pre", 256, 16, 3, None, (1, 16, 16)),
    ("bn2", 256, 16, 3, None, (2, 16, 16)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,c,nh,lab,parts,nhw", CONV3_CASES,
                         ids=[f"{i}-{m}" for i, (m, *_) in enumerate(CONV3_CASES)])
def test_fused_conv3_kernel_matches_plain(mode, c, nh, lab, parts, nhw):
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    gen = torch.Generator().manual_seed(4)
    n, h, w = nhw
    band = lambda ch: _bf16(gen, (n, h, w, ch), dev)
    wt = lambda o, i, k=3: (torch.randn((o, i, k, k), generator=gen) * 0.1).to(dev)
    side, consts, bias, shortcut, out_ch = (), (), None, None, None
    if mode == "gamma":
        src, weight = (band(nh),), wt(2 * c, nh)
        bias = (torch.randn(2 * c, generator=gen) * 0.3).to(dev)
    elif mode == "modgrad":
        src, side, weight = (band(c), band(c)), (band(nh),), wt(nh, 2 * c)
    elif mode == "seg":
        src, weight = (band(nh),), wt(lab, nh)
    elif mode == "pre":
        src, side, weight = (band(lab),), tuple(band(c) for _ in range(4)), wt(c, lab)
        consts = _bn_consts(gen, c, dev, 2)
    elif mode == "bn2":
        src, side, weight = (band(c), band(c)), (band(c),), wt(c, c)
        consts = _bn_consts(gen, c, dev, 8)
    else:
        csum = sum(parts)
        src, side, weight = (band(c), band(c)), (band(c),), wt(csum, c)
        consts = _bn_consts(gen, c, dev, 4)
        shortcut, out_ch = wt(csum, c, 1), list(parts)
    before = ttb.launches["fused_conv3"]
    got, stats = ttb.fused_conv3(mode, src, weight, side, consts, bias, shortcut, out_ch)
    torch.cuda.synchronize()
    assert ttb.launches["fused_conv3"] == before + 1
    want, want_stats = ttb.fused_conv3_reference(mode, src, weight, side, consts, bias,
                                                 shortcut, out_ch)
    for g, wv in zip(got if out_ch else (got,), want if out_ch else (want,)):
        assert g.shape == wv.shape and g.dtype == torch.bfloat16
        errs, ok = _close(g, wv)
        assert ok, errs
    assert (stats is None) == (want_stats is None)
    if stats is not None:
        assert stats.shape == want_stats.shape
        for r, (s, ws) in enumerate(zip(stats, want_stats)):
            d = (s - ws).abs().max().item()
            assert d <= 1e-3 * ws.abs().max().item() + 1e-3, (r, d)


WGRAD3_CASES = [
    # mode, x part channels, C (planes), hidden, labels, (n, h, w)
    ("gb", (8,), 256, 8, 3, (2, 24, 20)),
    ("mlp", (3,), 64, 4, 3, (2, 40, 36)),
    ("x2map", (64,), 64, 4, 3, (2, 40, 36)),
    ("conv2", (64,), 64, 4, 3, (2, 32, 32)),
    ("conv1", (64, 128), 64, 4, 3, (1, 24, 20)),
    # the edges of the 8x16 pixel tile: W not a multiple of 16, W < 16,
    # H = 1, batch 3 (tiles never cross images); conv2 with its prologue
    ("conv2", (128,), 128, 8, 3, (2, 12, 5)),
    ("x2map", (128,), 128, 8, 3, (1, 1, 20)),
    ("conv1", (3,), 64, 4, 3, (3, 9, 21)),        # the 3-channel image input
    ("conv1", (128, 256), 128, 8, 3, (1, 12, 20)),
    # the flagship's narrow widths: labels 3, hidden 4 and 16
    ("gb", (4,), 64, 4, 3, (3, 17, 33)),
    ("gb", (16,), 256, 16, 3, (2, 16, 16)),
    ("mlp", (3,), 256, 16, 3, (2, 16, 16)),
    ("x2map", (256,), 256, 16, 3, (2, 16, 16)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,xch,c,nh,lab,nhw", WGRAD3_CASES,
                         ids=[f"{i}-{m[0]}" for i, m in enumerate(WGRAD3_CASES)])
def test_fused_wgrad_kernel_matches_plain(mode, xch, c, nh, lab, nhw):
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    gen = torch.Generator().manual_seed(5)
    n, h, w = nhw
    band = lambda ch: _bf16(gen, (n, h, w, ch), dev)
    x = tuple(band(cp) for cp in xch)
    consts, prologue = (), None
    g = {"gb": lambda: (band(c), band(c)), "mlp": lambda: (band(nh),),
         "x2map": lambda: (band(lab),)}.get(mode, lambda: (band(c), band(c)))()
    if mode in ("conv2", "conv1"):
        consts = _bn_consts(gen, c, dev, 4)
    if mode == "conv2":
        prologue = _bn_consts(gen, c, dev, 2)
    before = ttb.launches["fused_wgrad"]
    got = ttb.fused_wgrad(mode, x, g, consts, prologue)
    torch.cuda.synchronize()
    assert ttb.launches["fused_wgrad"] == before + 1
    want = ttb.fused_wgrad_reference(mode, x, g, consts, prologue)
    assert got.shape == want.shape and got.dtype == torch.float32
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-3, rel


@pytest.mark.gpu
def test_v3_wrappers_refuse_float32():
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    dev = _card()
    x = torch.zeros((1, 16, 16, 8), device=dev)
    with pytest.raises(TypeError):
        ttb.fused_conv3("seg", (x,), torch.zeros((3, 8, 3, 3), device=dev))
    with pytest.raises(TypeError):
        ttb.fused_wgrad("mlp", (x,), (x,))


# ---------------------------------------------------------------------------
# The int8 fused stage (ops/stage_kernel_int8.py): launches A and B sum s8
# products exactly in s32 and repeat the plain version's f32 roundings, so
# h1 and y must equal the plain version's bit for bit; the bf16 SPADE tail
# keeps the tolerance above, and an emitted s8 output equals the plain
# version's on >= 99.9% of the elements and is never more than one step off.
# ---------------------------------------------------------------------------


def _int8_stage(dev, chans, planes, labels, nhw, ncls, seed=0, nh=None):
    gen = torch.Generator().manual_seed(seed)
    block = BasicBlock(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16 if nh is None else float(nh),
                  generator=gen)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen)
        head = (final.weight.to(dev), final.bias.to(dev))
    block.to(dev).eval()
    spade.to(dev)
    n, h, w = nhw
    parts = tuple(torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
                  for c in chans)
    return parts, block.stage_params(), spade.stage_params(), head


def _int8_both(parts, bp, sp, head, **kw):
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    before = q8.launches
    got = q8.fused_eval_stage_int8(parts, bp, sp, head, intermediates=True, **kw)
    torch.cuda.synchronize()
    assert q8.launches == before + 1
    want = q8.int8_stage_reference(parts, bp, sp, head, intermediates=True, **kw)
    assert torch.equal(got[1], want[1]), "h1 differs from the plain version"
    assert torch.equal(got[2], want[2]), "y differs from the plain version"
    return got[0], want[0]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,planes,labels,nhw,ncls,th,mode",
    [
        ((3,), 64, 3, (2, 40, 36), 0, 8, "dynamic"),         # 3-channel first block, 5 bands
        ((64,), 128, 3, (1, 32, 32), 0, None, "static"),     # encoder, one band
        ((128, 128), 128, 3, (1, 24, 20), 0, 8, "qtensor"),  # decoder, QTensor parts, 3 bands
        ((256, 256), 256, 3, (2, 16, 16), 0, None, "emit"),  # widest stage, s8 output
        ((64, 128), 64, 3, (2, 48, 40), 3, 16, "dynamic"),   # folded head, 3 bands
        ((32, 48), 64, 2, (1, 9, 13), 2, None, "static"),    # odd sizes, M tail < 128
        ((64,), 128, 3, (2, 128, 16), 0, None, "emit"),      # two bands of 64, s8 output
    ],
)
def test_int8_stage_kernel_matches_plain(chans, planes, labels, nhw, ncls, th, mode):
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    parts, bp, sp, head = _int8_stage(dev, chans, planes, labels, nhw, ncls)
    kw = {"th": th}
    try:
        if mode == "static":
            q8.set_int8_calibration({f"s:{i}": 2.5 for i in range(len(parts))})
            kw["calib_key"] = "s"
        if mode == "qtensor":
            parts = tuple(q8.QTensor(q8.quantize_tensor(p, 3.0)[0], 3.0 / 127.0, torch.bfloat16)
                          for p in parts)
        if mode == "emit":
            kw["out_abs_max"] = 6.0
        got, want = _int8_both(parts, bp, sp, head, **kw)
    finally:
        q8.set_int8_calibration(None)
    if mode == "emit":
        assert got.scale == want.scale and got.q.dtype == torch.int8
        d = (got.q.int() - want.q.int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    else:
        n, h, w = nhw
        assert got.shape == want.shape == (n, h, w, ncls or planes)
        errs, ok = _close(got, want)
        assert ok, errs


# The s8 conv core (csrc/int8_conv.cuh) alone, launch by launch, against its
# per-launch plain versions: exact s32 sums and the same f32 roundings, so
# h1, rowmax and y are equal bit for bit. (parts' widths, output channels,
# N x H x W, band rows for launch B)
S8_CONV_CASES = {
    "rgb-n64": ((3,), 64, (2, 40, 36), 8),
    "w16-n128": ((16,), 128, (1, 32, 24), 32),
    "w20-n192": ((20,), 192, (1, 16, 24), 16),
    "3+20-n256": ((3, 20), 256, (1, 24, 16), 8),  # th = 8: tiles of 16 rows idle half
    "64+128-n128": ((64, 128), 128, (2, 16, 16), 16),
    "128+128-n256": ((128, 128), 256, (1, 16, 16), 16),
    "64-n64-th=H=12": ((64,), 64, (2, 12, 20), 12),  # one band, shorter than a tile
    "48-n128-th=H=36": ((48,), 128, (1, 36, 8), 36),  # one band of 36: 3 tiles down
    "96-n96-many-tiles": ((96,), 96, (3, 64, 72), 64),
    "256-n256-many-tiles": ((256,), 256, (3, 64, 48), 32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(S8_CONV_CASES))
def test_s8_conv_core_matches_plain(name):
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    chans, cout, (n, h, w), th = S8_CONV_CASES[name]
    gen = torch.Generator().manual_seed(7)
    s8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen).to(torch.int8).to(dev)
    qparts = tuple(s8(n, h, w, c) for c in chans)
    conv1 = q8.pack_s8_conv([s8(cout, c, 3, 3) for c in chans], "h1")
    conv2 = q8.pack_s8_conv([s8(cout, c, 1, 1) for c in chans] + [s8(cout, cout, 3, 3)], "y")
    vec = lambda scale: (torch.rand(cout, generator=gen) * scale).to(dev)
    d1, t1, d2, ds, t2 = vec(1e-5), vec(0.5) - 0.2, vec(1e-2), vec(1e-5), vec(0.5) - 0.2
    before = q8.conv_launches
    h1, rowmax = q8.s8_conv1(qparts, conv1, d1, t1)
    qh1, bandscale = q8.band_quant(h1, rowmax, th)
    y = q8.s8_conv2(qh1, bandscale, qparts, conv2, d2, ds, t2)
    torch.cuda.synchronize()
    assert q8.conv_launches == before + 2
    want_h1, want_rowmax = q8.s8_conv1_reference(qparts, conv1, d1, t1)
    assert torch.equal(h1, want_h1) and torch.equal(rowmax, want_rowmax)
    assert h1.max() > 0 and (h1 == 0).any()  # ReLU both ways
    want_qh1, want_bs = q8.band_quant_reference(h1, rowmax, th)
    assert torch.equal(qh1, want_qh1) and torch.equal(bandscale, want_bs)
    want_y = q8.s8_conv2_reference(qh1, bandscale, qparts, conv2, d2, ds, t2)
    assert y.shape == (n, h, w, cout) and torch.equal(y, want_y)


# The s8 conv core reading a seam (csrc/int8_conv.cuh read modes: 1 the
# decoder's upsample seam from its s8 half-height tensor, 2 the encoder's
# pool seam from its full-resolution s8 tensor) in launch A and in launch
# B's shortcut, at every N instantiation, against the per-launch plain
# versions with the same flags (``read_seams_s8``) and the same launch on
# the materialized s8 seam, bit for bit. (kind, parts' widths, output
# channels, logical N x H x W, band rows, the seam part)
S8_SEAM_CASES = {
    "up-n64": ("up", (64, 128), 64, (2, 32, 24), 16, 1),
    "up-n128-hh-odd": ("up", (128, 256), 128, (1, 22, 16), 22, 1),
    "up-n192": ("up", (16, 20), 192, (1, 16, 24), 16, 1),
    "up-n256-unaligned": ("up", (24, 40), 256, (2, 8, 20), 8, 1),
    "pool-n64-rgb": ("pool", (3,), 64, (2, 20, 18), 20, 0),
    "pool-n128": ("pool", (64,), 128, (1, 32, 32), 16, 0),
    "pool-n192-narrow": ("pool", (20,), 192, (1, 16, 24), 16, 0),
    "pool-n256": ("pool", (128,), 256, (2, 16, 16), 16, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(S8_SEAM_CASES))
def test_s8_conv_core_reads_its_seams_as_plain(name):
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    kind, chans, cout, (n, h, w), th, i = S8_SEAM_CASES[name]
    gen = torch.Generator().manual_seed(11)
    s8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen).to(torch.int8).to(dev)
    shapes = [(n, h, w, c) for c in chans]
    shapes[i] = (n, h // 2, w, chans[i]) if kind == "up" else (n, 2 * h, 2 * w, chans[i])
    qparts = tuple(s8(*sh) for sh in shapes)
    flags = tuple(j == i for j in range(len(chans)))
    kw = dict(up=flags) if kind == "up" else dict(down=flags)
    conv1 = q8.pack_s8_conv([s8(cout, c, 3, 3) for c in chans], "h1")
    conv2 = q8.pack_s8_conv([s8(cout, c, 1, 1) for c in chans] + [s8(cout, cout, 3, 3)], "y")
    vec = lambda scale: (torch.rand(cout, generator=gen) * scale).to(dev)
    d1, t1, d2, ds, t2 = vec(1e-5), vec(0.5) - 0.2, vec(1e-2), vec(1e-5), vec(0.5) - 0.2
    before = q8.conv_launches
    h1, rowmax = q8.s8_conv1(qparts, conv1, d1, t1, **kw)
    qh1, bandscale = q8.band_quant(h1, rowmax, th)
    y = q8.s8_conv2(qh1, bandscale, qparts, conv2, d2, ds, t2, **kw)
    torch.cuda.synchronize()
    assert q8.conv_launches == before + 2
    want_h1, want_rowmax = q8.s8_conv1_reference(qparts, conv1, d1, t1, **kw)
    assert h1.shape == (n, h, w, cout) and torch.equal(h1, want_h1)
    assert torch.equal(rowmax, want_rowmax) and h1.max() > 0
    assert torch.equal(y, q8.s8_conv2_reference(qh1, bandscale, qparts, conv2, d2, ds, t2, **kw))
    mat = q8.read_seams_s8(qparts, **kw)
    assert torch.equal(h1, q8.s8_conv1(mat, conv1, d1, t1)[0])
    assert torch.equal(y, q8.s8_conv2(qh1, bandscale, mat, conv2, d2, ds, t2))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,chans,planes,nhw,ncls,th,mode", [
    ("up", (64, 128), 64, (2, 32, 24), 3, None, "dynamic"),   # conv0_1-like, folded head
    ("up", (128, 256), 128, (1, 64, 16), 0, 32, "static"),    # conv1_1-like, ":half" range
    ("pool", (64,), 128, (2, 16, 24), 0, None, "qtensor"),    # conv1_0-like, s8 producer
    ("pool", (128,), 256, (1, 32, 16), 0, 16, "dynamic"),     # conv2_0-like, two bands
])
def test_int8_stage_reads_its_seam_as_plain(kind, chans, planes, nhw, ncls, th, mode):
    """Kernel 7 reading a seam (launch A's windows and launch B's shortcut)
    against its plain version: h1 and y bit for bit; the seam counts one
    read per stage call."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    n, h, w = nhw
    _, bp, sp, head = _int8_stage(dev, chans, planes, 3, nhw, ncls, seed=12)
    gen = torch.Generator().manual_seed(13)
    if kind == "up":
        parts = (_bf16(gen, (n, h, w, chans[0]), dev), _bf16(gen, (n, h // 2, w, chans[1]), dev))
        seams = dict(up=(False, True))
    else:
        parts = (_bf16(gen, (n, 2 * h, 2 * w, chans[0]), dev),)
        seams = dict(down=(True,))
    kw = dict(seams, th=th)
    try:
        if mode == "static":
            q8.set_int8_calibration({"s:0": 2.5, "s:1": 2.0, "s:1:half": 2.2})
            kw["calib_key"] = "s"
        if mode == "qtensor":
            parts = (q8.QTensor(q8.quantize_tensor(parts[0], 3.0)[0], 3.0 / 127.0,
                                torch.bfloat16),)
        reads = (q8.up_reads, q8.pool_reads)
        got, want = _int8_both(parts, bp, sp, head, **kw)
        assert (q8.up_reads - reads[0], q8.pool_reads - reads[1]) == (
            (1, 0) if kind == "up" else (0, 1))
    finally:
        q8.set_int8_calibration(None)
    assert got.shape == want.shape == (n, h, w, ncls or planes)
    errs, ok = _close(got, want)
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("abs_max", [None, 63.5, 3.0], ids=["dynamic", "static", "saturating"])
def test_quantize_kernel_matches_plain(dtype, abs_max):
    """Launch P (one pass; a dynamic scale from the abs-max pass, in device
    memory) against ``quantize_reference``: the same s8 values and scale.
    Values at exact half steps of the scale 0.5 (static 63.5 / 127) round
    to even; a range of 3.0 saturates; an odd element count and a view that
    is not 16-byte aligned take the element-wise path."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    gen = torch.Generator().manual_seed(3)
    halves = (torch.arange(-200, 200) * 0.5 + 0.25).to(dtype)  # x / 0.5 = k + 0.5
    xs = [
        (torch.randn((2, 33, 17, 24), generator=gen) * 4).to(dtype).to(dev),
        torch.cat([halves, -halves]).to(dev),
        (torch.randn(1001, generator=gen) * 10).to(dtype).to(dev)[3:],  # misaligned, odd
    ]
    for x in xs:
        before = q8.quant_launches
        q, s = q8.quantize_tensor(x, abs_max)
        torch.cuda.synchronize()
        assert q8.quant_launches == before + 1
        want_q, want_s = q8.quantize_reference(x, abs_max)
        assert q.dtype == torch.int8 and torch.equal(q, want_q)
        if abs_max is None:
            assert isinstance(s, torch.Tensor) and s.is_cuda and torch.equal(s, want_s)
        else:
            assert s == want_s
    with pytest.raises(TypeError):
        q8.quantize_tensor(torch.zeros(8, dtype=torch.float16, device=dev))


@pytest.mark.gpu
def test_int8_stage_kernel_refuses_float32():
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    block = BasicBlock(64, 128).to(dev)
    spade = SPADE("spadebatch3x3", 128, 3, 8.0).to(dev)
    x = torch.zeros((1, 16, 16, 64), device=dev)
    with pytest.raises(TypeError):
        q8.fused_eval_stage_int8((x,), block.stage_params(), spade.stage_params())


@pytest.mark.gpu
def test_int8_block_library_route_is_exact():
    """The deep block's integer convs through torch._int_mm equal the f64
    convs, sum for sum."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    gen = torch.Generator().manual_seed(0)
    qs = tuple(torch.randint(-127, 128, (2, 16, 16, c), generator=gen).to(dev, torch.int8)
               for c in (384, 384))
    ws = tuple(torch.randint(-127, 128, (512, 384, 3, 3), generator=gen).to(dev, torch.int8)
               for _ in qs)
    assert torch.equal(q8.int_conv(qs, ws, 1, library=True), q8.int_conv(qs, ws, 1))
    w1 = tuple(w[:, :, :1, :1].contiguous() for w in ws)
    assert torch.equal(q8.int_conv(qs, w1, 0, library=True), q8.int_conv(qs, w1, 0))


@pytest.mark.gpu
def test_int8_flagship_forward_kernel_matches_plain(monkeypatch):
    """Full-width flagship at 64x64, calibrated int8: six int8 kernel stages
    per forward, reading 2 up and 2 pool seams in s8, and s8 between the
    encoder stages; the logits against the same forward with every stage on
    the plain version and against f32, by the bf16 forward's bar (the
    kernel no further from f32 than 1.25 times the plain int8 forward,
    kernel and plain closer than plain and f32)."""
    from ssunet_gan_tpu_torch.infer.calibrate import calibrate_int8
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    dev = _card()
    model = build_model("UNet_R_SS_v2", 3, 3, seed=0, device=dev)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    monkeypatch.setattr(ssunet, "fused_eval_stage",
                        _plain_eval_stage)
    try:
        with torch.no_grad():
            f32 = model(x)  # the all-plain f32 forward
        calibrate_int8(model, x.cpu().numpy(), batch_size=2)
        q8.set_int8_stage(True)
        before = q8.launches, q8.up_reads, q8.pool_reads
        with torch.no_grad():
            got = model(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert (q8.launches, q8.up_reads, q8.pool_reads) == (before[0] + 6, before[1] + 2,
                                                             before[2] + 2)
        monkeypatch.setattr(
            ssunet, "fused_eval_stage_int8",
            lambda parts, bp, sp, head=None, calib_key=None, out_abs_max=None, packed=None,
            up=None, down=None:
            q8.int8_stage_reference(parts, bp, sp, head, calib_key, out_abs_max, up=up,
                                    down=down))
        with torch.no_grad():
            plain = model(x.to(torch.bfloat16))
    finally:
        q8.set_int8_stage(False)
        q8.set_int8_calibration(None)
    rel = lambda u, v: ((u.float() - v.float()).norm() / v.float().norm()).item()
    e_k, e_p, e_kp = rel(got, f32), rel(plain, f32), rel(got, plain)
    assert torch.isfinite(got.float()).all() and got.shape == f32.shape
    assert e_k <= 1.25 * e_p and e_kp <= e_p, (e_k, e_p, e_kp)


# ---- the bottleneck stage (kernel 8) and the standalone self-SPADE (kernel 9)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "chans,planes,labels,nhw,ncls",
    [
        ((3,), 64, 3, (2, 40, 36), 0),          # 3-channel first block, ragged tiles
        ((64,), 128, 3, (1, 32, 32), 0),        # encoder
        ((128,), 128, 3, (2, 24, 20), 0),       # identity shortcut
        ((256, 512), 256, 3, (1, 16, 16), 0),   # widest fused stage, two parts
        ((64, 128), 64, 3, (2, 48, 40), 3),     # folded final head
        ((32, 32), 64, 2, (1, 9, 13), 2),       # odd sizes, identity over two parts
        ((32, 64), 64, 2, (1, 9, 13), 2),       # odd sizes, M tail < 128
    ],
)
def test_bneck_stage_kernel_matches_plain(chans, planes, labels, nhw, ncls):
    from ssunet_gan_tpu_torch.ops import stage_kernel_bneck
    from ssunet_gan_tpu_torch.ops.blocks import Bottleneck

    dev = _card()
    gen = torch.Generator().manual_seed(0)
    block = Bottleneck(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16, generator=gen)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen)
        head = (final.weight.to(dev), final.bias.to(dev))
    block.to(dev).eval()
    spade.to(dev)
    n, h, w = nhw
    parts = tuple(torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
                  for c in chans)
    before = stage_kernel_bneck.launches
    got = stage_kernel_bneck.fused_eval_stage_bneck(parts, block.stage_params(),
                                                    spade.stage_params(), head)
    torch.cuda.synchronize()
    assert stage_kernel_bneck.launches == before + 1
    want = stage_kernel_bneck.fused_bneck_reference(parts, block.stage_params(),
                                                    spade.stage_params(), head)
    assert got.shape == want.shape == (n, h, w, ncls or planes)
    errs, ok = _close(got, want)
    assert ok, errs


@pytest.mark.gpu
def test_bneck_stage_kernel_refuses_float32_and_the_model_composes_it():
    """The wrapper raises for f32 on the card; the model's gate sends an f32
    forward to the module composition instead (no launch)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_bneck
    from ssunet_gan_tpu_torch.ops.blocks import Bottleneck

    dev = _card()
    block = Bottleneck(64, 128).to(dev).eval()
    spade = SPADE("spadebatch3x3", 128, 3, 8.0).to(dev)
    x = torch.zeros((1, 16, 16, 64), device=dev)
    with pytest.raises(ValueError):
        stage_kernel_bneck.fused_eval_stage_bneck((x,), block.stage_params(),
                                                  spade.stage_params())
    model = build_model("UNet_B_SS", 3, filters=(32, 64, 96, 288, 320), seed=0, device=dev)
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    before = stage_kernel_bneck.launches
    with torch.no_grad():
        f32 = model(x)
        assert stage_kernel_bneck.launches == before
        got = model(x.bfloat16())
    torch.cuda.synchronize()
    assert stage_kernel_bneck.launches == before + 6
    rel = ((got.float() - f32).norm() / f32.norm()).item()
    assert torch.isfinite(got.float()).all() and rel < 0.2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("c,labels,nh,nhw", [
    (64, 3, 4, (2, 40, 36)), (128, 3, 8, (1, 32, 32)), (256, 3, 16, (2, 16, 16)),
    (32, 2, 4, (1, 9, 13)),
])
def test_spade_stage_kernel_matches_plain_forward_and_backward(c, labels, nh, nhw):
    """Forward against the plain version; backward against autograd of the
    plain composition on the same inputs (the same cuDNN calls, so equal to
    the forward's bar at the least)."""
    from ssunet_gan_tpu_torch.ops import spade_kernel

    dev = _card()
    gen = torch.Generator().manual_seed(0)
    spade = SPADE("spadebatch3x3", c, labels, float(nh), generator=gen).to(dev)
    n, h, w = nhw
    x = torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16).requires_grad_()
    cot = torch.randn((n, h, w, c), generator=gen).to(dev, torch.bfloat16)
    params = spade.stage_params()
    before = spade_kernel.launches
    got = spade_kernel.fused_spade_stage(x, *params)
    torch.cuda.synchronize()
    assert spade_kernel.launches == before + 1
    want = spade_kernel.self_spade_reference(x.detach(), params)
    errs, ok = _close(got, want)
    assert ok, errs
    grads = torch.autograd.grad(got, [x, *params], cot)
    x2 = x.detach().clone().requires_grad_()
    plain = torch.autograd.grad(spade_kernel.self_spade_composition(x2, *params),
                                [x2, *params], cot)
    for g, p in zip(grads, plain):
        errs, ok = _close(g, p)
        assert ok and g.shape == p.shape and g.dtype == p.dtype, errs


# The SPADE tail kernel (csrc/stage_common.cuh spade_tail_kernel) through
# each entry point that launches it: (path, planes, labels, hidden, N·H·W).
# "spade": the self-SPADE stage, the tail alone (bf16 out); "head": the eval
# stage with the folded head; "s8": the int8 stage emitting s8; "saves": the
# train tail with its seg and act saves.
TAIL_CASES = [
    ("spade", 64, 3, 4, (2, 40, 36)),      # the flagship's level 0, ragged tiles
    ("spade", 128, 3, 8, (3, 32, 32)),     # level 1, batch 3
    ("spade", 256, 3, 16, (2, 16, 16)),    # level 2
    ("spade", 128, 3, 32, (2, 32, 48)),    # SSUNet's wide hidden widths
    ("spade", 256, 3, 64, (2, 32, 32)),
    ("spade", 64, 8, 64, (3, 9, 13)),      # widest labels and hidden, odd sizes
    ("spade", 32, 3, 24, (1, 9, 13)),      # an odd count of 8-channel groups
    ("head", 64, 3, 32, (2, 24, 20)),
    ("head", 128, 3, 64, (3, 9, 13)),
    ("s8", 128, 3, 32, (2, 16, 24)),
    ("s8", 256, 3, 64, (3, 9, 13)),
    ("saves", 64, 3, 32, (2, 24, 20)),
    ("saves", 128, 3, 64, (3, 9, 13)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("path,c,labels,nh,nhw", TAIL_CASES,
                         ids=[f"{p}-c{c}-lab{lab}-nh{nh}-{'x'.join(map(str, s))}"
                              for p, c, lab, nh, s in TAIL_CASES])
def test_tail_kernel_matches_plain(path, c, labels, nh, nhw):
    """The tail against its plain version at the stage bar (s8: equal on
    99.9% of the elements, one step apart at most; int8's h1 and y bit for
    bit), each entry point's launch counter moved once."""
    from ssunet_gan_tpu_torch.ops import spade_kernel
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    dev = _card()
    gen = torch.Generator().manual_seed(3)
    n, h, w = nhw
    if path == "s8":
        parts, bp, sp, head = _int8_stage(dev, (c,), c, labels, nhw, 0, seed=3, nh=nh)
        got, want = _int8_both(parts, bp, sp, head, out_abs_max=6.0)
        d = (got.q.int() - want.q.int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
        return
    spade = SPADE("spadebatch3x3", c, labels, float(nh), generator=gen).to(dev)
    assert spade.nhidden == nh
    sp = spade.stage_params()
    if path == "spade":
        x = _bf16(gen, (n, h, w, c), dev)
        before = spade_kernel.launches
        got = [spade_kernel.fused_spade_stage(x, *sp)]
        torch.cuda.synchronize()
        assert spade_kernel.launches == before + 1
        want = [spade_kernel.self_spade_reference(x, sp)]
    elif path == "head":
        block = BasicBlock(c, c, generator=gen)
        _randomize_bn(block, gen)
        block.to(dev).eval()
        final = Conv2d(c, 3, 1, generator=gen).to(dev)
        head = (final.weight, final.bias)
        parts = (_bf16(gen, (n, h, w, c), dev),)
        before = stage_kernel.launches
        got = [stage_kernel.fused_eval_stage(parts, block.stage_params(), sp, head)]
        torch.cuda.synchronize()
        assert stage_kernel.launches == before + 1
        want = [stage_kernel.fused_stage_reference(parts, block.stage_params(), sp, head)]
    else:
        parts = (_bf16(gen, (n, h, w, c), dev),)
        f2 = _bf16(gen, (n, h, w, c), dev)
        a2 = (torch.rand(c, generator=gen) + 0.5).to(dev)
        b2 = (torch.randn(c, generator=gen) * 0.3).to(dev)
        ws = (torch.randn((c, c, 1, 1), generator=gen) * 0.1).to(dev)
        before = tst.launches["train_tail"]
        got = tst.train_tail(f2, parts, a2, b2, ws, sp, None)
        torch.cuda.synchronize()
        assert tst.launches["train_tail"] == before + 1
        want = tst.train_tail_reference(f2, parts, a2, b2, ws, sp, None)
    for name, g, wv in zip(("out", "y", "seg", "actv"), got, want):
        assert g.shape == wv.shape, name
        errs, ok = _close(g, wv)
        assert ok, (name, errs)


@pytest.mark.gpu
def test_spade_module_pallas_mode_launches_only_for_self_spade():
    from ssunet_gan_tpu_torch.ops import spade_kernel

    dev = _card()
    spade = SPADE("spadebatch3x3", 64, 3, 4.0, generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn((1, 32, 32, 64), generator=torch.Generator().manual_seed(1))
    x = x.to(dev, torch.bfloat16)
    with torch.no_grad():
        off = spade(x, x)
        spade_kernel.set_fused_spade("pallas")
        try:
            before = spade_kernel.launches
            got = spade(x, x)
            assert spade_kernel.launches == before + 1
            spade(x, x.clone())          # a general segmap: the composition
            xf = x.float()
            spade(xf, xf)                # f32 on the card: refused by the gate
            assert spade_kernel.launches == before + 1
        finally:
            spade_kernel.set_fused_spade(None)
    errs, ok = _close(got, off)
    assert ok, errs


# ---- the seams read in the eval conv core (csrc/eval_conv.cuh read modes:
# 1 the decoder's bilinear x2 seam from its half-height, W-interpolated
# tensor; 2 the encoder's 2x2 max-pool seam from its full-resolution one),
# at every N instantiation: a launch reading the seam equals the same
# launch on the materialized source bit for bit (the H-interpolation's
# weights and single rounding, and the maximum, are exact on both sides).
# (kind, source channels, kernel sizes, cout, logical n h w, seam segment)
SEAM_CASES = {
    "up-n64-swap": ("up", (32, 48), (3, 3), 32, (2, 20, 24), 1),
    "up-n128": ("up", (64, 128), (3, 3), 128, (1, 16, 16), 1),
    "up-n192-hh-odd": ("up", (16, 64), (3, 3), 192, (1, 22, 12), 1),
    "up-n256": ("up", (256, 128), (3, 3), 256, (2, 8, 40), 1),
    "up-1x1-shortcut": ("up", (64, 32, 48), (3, 1, 1), 64, (2, 12, 20), 2),
    "up-chunk-tail": ("up", (8, 40), (3, 3), 96, (1, 10, 9), 1),
    "up-unaligned-channels": ("up", (16, 12), (3, 3), 64, (1, 8, 16), 1),
    "pool-n64-swap": ("pool", (32,), (3,), 64, (2, 9, 13), 0),
    "pool-n128": ("pool", (64,), (3,), 128, (1, 16, 16), 0),
    "pool-n192": ("pool", (40,), (3,), 192, (2, 12, 20), 0),
    "pool-n256": ("pool", (128,), (3,), 256, (1, 32, 8), 0),
    "pool-1x1-shortcut": ("pool", (64, 32), (3, 1), 64, (2, 16, 12), 1),
    "pool-unaligned-channels": ("pool", (12,), (3,), 32, (1, 8, 8), 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SEAM_CASES))
def test_eval_conv_seam_read_equals_materialized(name):
    dev = _card()
    kind, chans, ks, cout, (n, h, w), i = SEAM_CASES[name]
    gen = torch.Generator().manual_seed(7)
    shapes = [(n, h, w, c) for c in chans]
    shapes[i] = (n, h // 2, w, chans[i]) if kind == "up" else (n, 2 * h, 2 * w, chans[i])
    sources = tuple(_bf16(gen, s, dev) for s in shapes)
    modes = tuple((1 if kind == "up" else 2) if j == i else 0 for j in range(len(chans)))
    weights = [(torch.randn((cout, c, k, k), generator=gen) / (c * k * k) ** 0.5).bfloat16()
               .float().to(dev) for c, k in zip(chans, ks)]
    main = 1 if len(set(ks)) > 1 else None  # the 1x1 segments after the 3x3 one
    conv = stage_kernel.pack_eval_conv(weights, torch.zeros(cout, device=dev), torch.bfloat16,
                                       main)
    flags = (tuple(m == 1 for m in modes), tuple(m == 2 for m in modes))
    mat = stage_kernel.materialize_seams(sources, *flags)
    got = stage_kernel.eval_conv(sources, conv, modes)
    want = stage_kernel.eval_conv(mat, conv)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h, w, cout)
    assert torch.equal(got, want)
    errs, ok = _close(got, stage_kernel.eval_conv_reference(mat, conv["oihw"], conv["bias"],
                                                            main))
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("kind,chans,planes,nhw,ncls", [
    ("up", (64, 128), 64, (2, 32, 24), 3),     # conv0_1-like, folded head
    ("up", (128, 256), 128, (1, 16, 16), 0),
    ("pool", (64,), 128, (2, 16, 24), 0),      # conv1_0-like
    ("pool", (128,), 256, (1, 8, 16), 0),
])
def test_fused_stage_reads_its_seam_as_the_materialized_stage(kind, chans, planes, nhw, ncls):
    """Kernel 1 reading a seam (conv1's segment and conv2's shortcut
    segment) against kernel 1 on the materialized seam, bit for bit; the
    seam counts one read per stage call."""
    dev = _card()
    gen = torch.Generator().manual_seed(8)
    block = BasicBlock(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    spade = SPADE("spadebatch3x3", planes, 3, planes / 16, generator=gen)
    head = None
    if ncls:
        final = Conv2d(planes, ncls, 1, generator=gen)
        head = (final.weight.to(dev), final.bias.to(dev))
    block.to(dev).eval()
    spade.to(dev)
    n, h, w = nhw
    if kind == "up":
        parts = (_bf16(gen, (n, h, w, chans[0]), dev), _bf16(gen, (n, h // 2, w, chans[1]), dev))
        up, down = (False, True), None
    else:
        parts = (_bf16(gen, (n, 2 * h, 2 * w, chans[0]), dev),)
        up, down = None, (True,)
    bp, sp = block.stage_params(), spade.stage_params()
    reads = (stage_kernel.up_reads, stage_kernel.pool_reads)
    got = stage_kernel.fused_eval_stage(parts, bp, sp, head, up=up, down=down)
    torch.cuda.synchronize()
    assert (stage_kernel.up_reads - reads[0], stage_kernel.pool_reads - reads[1]) == (
        (1, 0) if kind == "up" else (0, 1))
    mat = stage_kernel.materialize_seams(parts, up, down)
    assert torch.equal(got, stage_kernel.fused_eval_stage(mat, bp, sp, head))
    errs, ok = _close(got, stage_kernel.fused_stage_reference(mat, bp, sp, head))
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("chans,planes,nhw", [((64, 128), 64, (2, 32, 24)),
                                              ((256, 256), 256, (1, 8, 16))])
def test_bneck_stage_reads_its_up_seam_as_the_materialized_stage(chans, planes, nhw):
    """Kernel 8 reading an up seam (launches A and C) against kernel 8 on
    the materialized seam, bit for bit."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_bneck as kb
    from ssunet_gan_tpu_torch.ops.blocks import Bottleneck

    dev = _card()
    gen = torch.Generator().manual_seed(9)
    block = Bottleneck(sum(chans), planes, generator=gen)
    _randomize_bn(block, gen)
    spade = SPADE("spadebatch3x3", planes, 3, planes / 16, generator=gen)
    block.to(dev).eval()
    spade.to(dev)
    n, h, w = nhw
    parts = (_bf16(gen, (n, h, w, chans[0]), dev), _bf16(gen, (n, h // 2, w, chans[1]), dev))
    bp, sp = block.stage_params(), spade.stage_params()
    reads = stage_kernel.up_reads
    got = kb.fused_eval_stage_bneck(parts, bp, sp, up=(False, True))
    torch.cuda.synchronize()
    assert stage_kernel.up_reads == reads + 1
    mat = stage_kernel.materialize_seams(parts, (False, True))
    assert torch.equal(got, kb.fused_eval_stage_bneck(mat, bp, sp))
    errs, ok = _close(got, kb.fused_bneck_reference(mat, bp, sp))
    assert ok, errs


def _scene_2048(seed=0):
    """A 2048² smooth field plus noise: 36 tiles of 512² at patch 1024."""
    import numpy as np

    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:2048, :2048]
    img = np.stack([(xx // 3 + yy // 5), (xx * yy) // 4096, 255 - yy // 8], -1) % 256
    return np.clip(img + g.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.gpu
def test_pipelined_scene_forward_equals_segmentation_inference():
    """The pipelined forward (tile server chunks in pinned buffers, copies on
    a side stream, quantized probabilities) and segmentation_inference on
    the tile server's tiles give the same masks bit for bit on a 2048²
    scene (the same kernels at the same batch, the same floor)."""
    import numpy as np

    from ssunet_gan_tpu_torch.data.tiling import merge_patches_device
    from ssunet_gan_tpu_torch.infer import api

    dev = _card()
    model = build_model("UNet_R_SS_v2", 3, seed=0, device=dev)
    _randomize_bn(model, torch.Generator().manual_seed(1))
    scene = _scene_2048()
    config = {"patch_size": 1024, "patch_overlap": 0.5, "num_classes": 3, "input_h": 512,
              "input_w": 512, "deep_supervision": False}
    tiles, masks = api.patch_and_preprocess(scene, scene, config, raw_uint8=True)
    want, _ = api.segmentation_inference(model, scene, tiles, masks, config, False)
    before = stage_kernel.launches
    probs, coords, p = api.pipelined_scene_forward(model, scene, config, quantize_probs=True)
    assert stage_kernel.launches - before == 12  # 6 stages per forward, 2 chunks
    assert probs.dtype == torch.uint8 and probs.device.type == "cuda" and len(probs) == 36
    merged = merge_patches_device(probs, coords, 2048, 2048, p, 3, overlap=0.5).cpu().numpy()
    for c in range(3):
        np.testing.assert_array_equal(merged[..., c], want[c])
    assert any(0 < m.mean() < 255 for m in want)


@pytest.mark.gpu
def test_load_segmentation_models_puts_the_model_on_the_card(tmp_path):
    import json

    from ssunet_gan_tpu_torch.config import dump_model_card
    from ssunet_gan_tpu_torch.infer import api
    from ssunet_gan_tpu_torch.train.checkpoint import save_model

    _card()
    model = build_model("UNet_R_SS_v2", 3, seed=2, device="cpu")
    model_dir = tmp_path / "models" / "m"
    dump_model_card({"arch": "UNet_R_SS_v2", "num_classes": 3, "input_channels": 3,
                     "deep_supervision": False, "input_h": 512, "input_w": 512}, str(model_dir))
    save_model(str(model_dir), model)
    path = tmp_path / "experiment.json"
    path.write_text(json.dumps({"file_path": {"model_path": str(tmp_path / "models")},
                                "val_config": {"name": "m", "patch_overlap": 0.5}}))
    loaded, config = api.load_segmentation_models(str(path))
    assert config["patch_size"] == 1024 and not loaded.training
    assert all(t.device.type == "cuda" for t in loaded.state_dict().values())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k].cpu(), v), k
