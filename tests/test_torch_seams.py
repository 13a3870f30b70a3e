"""The decoder's bilinear seams and the encoder's pool seams read inside the
eval stage kernels (the on-read functions of the JAX package's TPU kernels
1 and 8, ``ops/stage_kernel.py`` ``_upsample_on_read`` and
``_pool_on_read``), on the CPU against the JAX package: the exact-weight
guard, the seam's two halves (``upsample_w`` at half height, then the
H-interpolation ``materialize_up``) and the pool, the fused BasicBlock and
Bottleneck stages reading a seam against the JAX kernels reading the lazy
``UpTensor`` / ``DownTensor`` in Pallas interpret mode, the one gate's
seam terms, and narrow models whose forwards hand their stages the seams.

Inputs come from numpy with a seed and cross between the frameworks as
numpy (the JAX side in its (N, H, C, W) layout). Tolerances: the seam
itself bit for bit in bf16 (the weights rounded to bf16 before the
two-term f32 lerp, one rounding); in f32 the interpolation to 1e-6 (the
JAX package's f32 weights come from its f64 matrix, the port's from the
kernel's division, ≤ 1 ulp apart); the stages in f32 to rtol = atol =
2e-4 (the JAX kernel's own parity bar) and in bf16 to rtol 0.1, atol 0.3
(tests/test_torch_stage.py's bf16 bar); the narrow forwards in bf16 to the
same bar against the JAX forward with its lazy seams on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.ops import acts as jax_acts
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import wminor as jax_wminor
from ssunet_gan_tpu.ops.blocks import BasicBlock as JBasicBlock
from ssunet_gan_tpu.ops.blocks import Bottleneck as JBottleneck
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import pool, resize, stage_kernel, stage_kernel_bneck
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
from ssunet_gan_tpu_torch.ops.spade import SPADE
from torch_port_helpers import (
    B_FILTERS,
    R_FILTERS,
    S_FILTERS,
    NarrowSSUNet,
    bneck_bundle,
    jax_toggles,
    nhwc_of_wminor,
    oihw,
    randomize_batch_stats,
    vec,
    wminor,
)

BF16_BAR = dict(rtol=0.1, atol=0.3)


@pytest.fixture(autouse=True)
def _modes():
    """The JAX package's and the port's lazy seams on, as by default."""
    with jax_toggles(fused_stage=True, lazy_upsample=True, lazy_pool=True):
        yield


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(x: np.ndarray, dtype):
    """``x`` in ``dtype`` as a port tensor and as a JAX array."""
    t = torch.from_numpy(x).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


# ---- the seams themselves ------------------------------------------------------


def test_up_weights_exact_matches_jax():
    """The exact-weight guard on every half height up to 64 and on the
    model families' deeper ones (the whole range 2-1024 under ``slow``)."""
    for hh in list(range(1, 65)) + [96, 127, 128, 255, 256, 512]:
        assert resize.up_weights_exact(hh) == jax_acts.up_weights_exact(hh), hh


@pytest.mark.slow
def test_up_weights_exact_matches_jax_to_1024():
    for hh in range(2, 1025):
        assert resize.up_weights_exact(hh) == jax_acts.up_weights_exact(hh), hh


@pytest.mark.parametrize("shape", [(2, 8, 6, 5), (1, 16, 16, 8), (1, 3, 5, 4)])
def test_upsample_halves_match_jax_lazy_form(rng, shape):
    """``upsample_w`` equals the payload of JAX's lazy ``upsample2x`` (its
    W-interpolation at half height) and ``materialize_up`` JAX's
    ``materialize_up`` of it, bit for bit in bf16; in f32 the
    H-interpolation to 1e-6."""
    x = rng.normal(size=shape).astype(np.float32)
    xt, xj = _both(x, torch.bfloat16)
    lazy = jax_wminor.upsample2x(jax_wminor.WTensor(wminor(xj)))
    assert isinstance(lazy, jax_acts.UpTensor)
    half = resize.upsample_w(xt)
    assert half.dtype == torch.bfloat16 and half.shape == (shape[0], shape[1], 2 * shape[2],
                                                            shape[3])
    np.testing.assert_array_equal(half.float().numpy(), nhwc_of_wminor(_f32(lazy.v)))
    full = resize.materialize_up(half)
    want = nhwc_of_wminor(_f32(jax_acts.materialize_up(lazy).v))
    np.testing.assert_array_equal(full.float().numpy(), want)
    h32 = half.float()
    got32 = resize.materialize_up(h32).numpy()
    want32 = nhwc_of_wminor(np.asarray(jax_acts.materialize_up(
        jax_acts.UpTensor(wminor(h32.numpy()))).v))
    np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_materialized_pool_matches_jax(rng, dtype):
    """The pool seam's materialization (``materialize_seams``) equals JAX's
    ``materialize_down`` bit for bit."""
    x = rng.normal(size=(2, 12, 10, 6)).astype(np.float32)
    xt, xj = _both(x, dtype)
    got = stage_kernel.materialize_seams((xt,), down=(True,))[0]
    want = nhwc_of_wminor(_f32(jax_acts.materialize_down(jax_acts.DownTensor(wminor(xj))).v))
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---- the stages reading a seam ---------------------------------------------------


def _basic_stage(rng, planes, label, chans, nh, ncls):
    """JAX BasicBlock + SPADE bundles (random BN statistics) and the port's."""
    block = JBasicBlock(planes)
    spade = JSPADE("spadebatch3x3", planes, label, nh)
    x0 = tuple(jnp.zeros((1, 8, 8, c), jnp.float32) for c in chans)
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(
        jax.random.PRNGKey(0), x0 if len(x0) > 1 else x0[0], True))())
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, planes)),
                                       jnp.zeros((1, 8, 8, planes))))()
    jbp = JBasicBlock(planes, in_planes=sum(chans)).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    head = None
    if ncls:
        head = (rng.normal(size=(1, 1, planes, ncls)).astype(np.float32) * 0.3,
                rng.normal(size=(ncls,)).astype(np.float32) * 0.1)
    k1, (s1, t1), k2, (s2, t2), ks = jbp
    tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), oihw(ks))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    thead = None if head is None else (oihw(head[0]), vec(head[1]))
    jhead = None if head is None else tuple(map(jnp.asarray, head))
    return jbp, jsp, jhead, tbp, tsp, thead


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["up", "pool"])
def test_stage_reads_its_seam_as_jax(rng, dtype, kind):
    """``fused_eval_stage`` with an up part (a decoder stage of two parts,
    the folded head) or a pool part (an encoder stage of one) against the
    JAX ``fused_eval_stage`` on ``UpTensor`` / ``DownTensor`` parts in
    interpret mode."""
    if kind == "up":
        planes, chans, ncls = 16, (8, 16), 3
        skip = rng.normal(size=(1, 16, 8, 8)).astype(np.float32)
        half = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
        (st, sj), (ht, hj) = _both(skip, dtype), _both(half, dtype)
        tparts, up, down = (st, ht), (False, True), None
        jparts = (sj, jax_acts.UpTensor(wminor(hj)))
    else:
        planes, chans, ncls = 16, (8,), 0
        full = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
        ft, fj = _both(full, dtype)
        tparts, up, down = (ft,), None, (True,)
        jparts = (jax_acts.DownTensor(wminor(fj)),)
    jbp, jsp, jhead, tbp, tsp, thead = _basic_stage(rng, planes, 3, chans, 4.0, ncls)
    before = stage_kernel.launches, stage_kernel.up_reads, stage_kernel.pool_reads
    got = stage_kernel.fused_eval_stage(tparts, tbp, tsp, thead, up=up, down=down)
    # CPU tensors run the plain version: no launch, no seam read counted
    assert (stage_kernel.launches, stage_kernel.up_reads, stage_kernel.pool_reads) == before
    want = jax_stage_kernel.fused_eval_stage(jparts, jbp, jsp, final_head=jhead)
    assert got.dtype == dtype and got.shape == (1, 16 if kind == "up" else 8, 8, ncls or planes)
    bar = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else BF16_BAR
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **bar)


@pytest.mark.parametrize("dtype", [pytest.param(torch.float32, marks=pytest.mark.slow),
                                   torch.bfloat16], ids=["f32", "bf16"])
def test_bneck_stage_reads_its_up_seam_as_jax(rng, dtype):
    """``fused_eval_stage_bneck`` with an up part against the JAX kernel on
    an ``UpTensor`` part in interpret mode, its band height pinned as the
    JAX package's own test pins it (tests/test_stage_kernel.py:804); f32
    under ``slow``."""
    planes, chans = 16, (8, 16)
    skip = rng.normal(size=(1, 16, 8, 8)).astype(np.float32)
    half = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    (st, sj), (ht, hj) = _both(skip, dtype), _both(half, dtype)
    block = JBottleneck(planes, in_planes=sum(chans))
    x0 = (jnp.zeros((1, 8, 8, 8)), jnp.zeros((1, 8, 8, 16)))
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(jax.random.PRNGKey(3), x0, True))())
    spade = JSPADE("spadebatch3x3", planes, 3, 4.0)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, planes)),
                                       jnp.zeros((1, 8, 8, planes))))()
    jbp = block.apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    got = stage_kernel_bneck.fused_eval_stage_bneck((st, ht), bneck_bundle(jbp), tsp,
                                                    up=(False, True))
    jax_stage_kernel.set_band_rows(16)  # restored by jax_toggles
    want = jax_stage_kernel.fused_eval_stage_bneck((sj, jax_acts.UpTensor(wminor(hj))), jbp, jsp)
    assert got.dtype == dtype and got.shape == (1, 16, 8, planes)
    bar = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else BF16_BAR
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **bar)


# ---- the gate and the dispatch ----------------------------------------------------


def test_gate_takes_the_seams_it_can_read(monkeypatch):
    """``stage_supported`` / ``bneck_supported`` with seams judge the
    logical shape, take eval stages only (bf16; the int8 stage's own terms:
    tests/test_torch_int8_seams_stage.py), and refuse a pool seam of odd
    height or width and an up seam whose half height has no exact weights
    (1, or one the guard rejects)."""
    bf = torch.bfloat16
    skip, half = torch.zeros((1, 16, 8, 8), dtype=bf), torch.zeros((1, 8, 8, 16), dtype=bf)
    up, pooled = (False, True), (True,)
    ok = stage_kernel.stage_supported
    assert ok((skip, half), 16, 3, 4, up=up)
    assert not ok((skip, half), 16, 3, 4)                         # shapes differ unread
    assert not ok((skip, half.float()), 16, 3, 4, up=up)          # f32 takes no seam
    assert not ok((skip.float(), half.float()), 16, 3, 4, up=up)
    assert not ok((skip, half), 16, 3, 4, up=up, train=True)      # training materializes
    assert ok((skip, half), 16, 3, 4, up=up, int8=True)           # the int8 stage, in s8
    assert ok((torch.zeros((1, 32, 16, 8), dtype=bf),), 16, 3, 4, down=pooled)
    assert not ok((torch.zeros((1, 32, 17, 8), dtype=bf),), 16, 3, 4, down=pooled)
    assert not ok((torch.zeros((1, 33, 16, 8), dtype=bf),), 16, 3, 4, down=pooled)
    assert not ok((torch.zeros((1, 8, 8, 8), dtype=bf), torch.zeros((1, 1, 8, 8), dtype=bf)),
                  16, 3, 4, up=up)                                # half height 1
    assert stage_kernel_bneck.bneck_supported((skip, half), 16, 3, 4, up=up)
    assert not stage_kernel_bneck.bneck_supported((skip, half), 16, 3, 4)
    for module in (stage_kernel, stage_kernel_bneck):
        monkeypatch.setattr(module, "up_weights_exact", lambda hh: False)
    assert not ok((skip, half), 16, 3, 4, up=up)
    assert not stage_kernel_bneck.bneck_supported((skip, half), 16, 3, 4, up=up)
    with pytest.raises(ValueError):
        stage_kernel.seam_modes(2, up=(False, True), down=(False, True))


def _spied_stage(monkeypatch):
    """Record the seams ``spade_stage`` hands the fused eval stage."""
    seen = []
    fn = ssunet.fused_eval_stage

    def spy(parts, *args, up=None, down=None, **kw):
        seen.append((tuple(tuple(p.shape) for p in parts), up, down))
        return fn(parts, *args, up=up, down=down, **kw)

    monkeypatch.setattr(ssunet, "fused_eval_stage", spy)
    return seen


@pytest.mark.parametrize("case", ["pool-odd", "up-inexact", "up-read", "pool-read"])
def test_spade_stage_reads_or_materializes_the_seam(monkeypatch, case):
    """``spade_stage`` hands the fused stage a seam only where it can read
    it; an odd pool source or an up seam without exact weights is
    materialized as before the split (``max_pool_2x2``, floor-cropped;
    ``upsample_bilinear``, H then W) and the stage takes plain parts. The
    output equals the stage on the materialized parts."""
    gen = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    if case.startswith("pool"):
        side = 17 if case == "pool-odd" else 16
        parts = (torch.randn((1, side, side, 8), generator=gen).to(bf),)
        block = BasicBlock(8, 16, generator=gen).eval()
        kw = dict(down=(True,))
        mat = (pool.max_pool_2x2(parts[0]),) if case == "pool-odd" else \
            stage_kernel.materialize_seams(parts, down=(True,))
    else:
        parts = (torch.randn((1, 16, 16, 8), generator=gen).to(bf),
                 torch.randn((1, 8, 8, 16), generator=gen).to(bf))
        block = BasicBlock(24, 16, generator=gen).eval()
        kw = dict(up=(False, True))
        if case == "up-inexact":
            monkeypatch.setattr(resize, "up_weights_exact", lambda hh: False)
            mat = (parts[0], resize.upsample_bilinear(parts[1]))
        else:
            mat = (parts[0], resize.materialize_up(resize.upsample_w(parts[1])))
    spade = SPADE("spadebatch3x3", 16, 3, 1.0, generator=gen)
    seen = _spied_stage(monkeypatch)
    with torch.no_grad():
        got = ssunet.spade_stage(parts, block, spade, name="conv1_0", **kw)
        want = ssunet.spade_stage(mat, block, spade, name="conv1_0")
    assert len(seen) == 2 and seen[1] == (tuple(tuple(p.shape) for p in mat), None, None)
    if case.endswith("read"):
        assert seen[0][1:] == (kw.get("up"), kw.get("down"))
    else:
        assert seen[0] == seen[1]
    assert torch.equal(got, want)


# ---- narrow models ------------------------------------------------------------------

FLAGSHIP_FILTERS = (8, 16, 32, 48, 64, 64)  # tests/test_torch_gate.py's narrow flagship


def _seam_counts(seen):
    return (sum(any(u or ()) for _, u, _ in seen), sum(any(d or ()) for _, _, d in seen))


@pytest.mark.parametrize("arch", ["UNet_R_SS_v2", "SSUNet"])
def test_narrow_forward_reads_its_seams_as_jax(monkeypatch, arch):
    """A narrow flagship (32×32: levels 0-2 fuse) and a narrow SSUNet
    (64×64: levels 0-3 fuse) in bf16: the seams the forward hands its
    kernel stages are those of the full-width models (flagship: up
    conv1_1, conv0_1, pool conv1_0, conv2_0; SSUNet: up conv3_1, conv2_2,
    conv1_3, conv0_4, pool conv1_0, conv2_0, conv3_0), and the logits
    match the JAX forward with its lazy seams on (its stages run the module
    composition, as in tests/test_torch_gate.py and test_torch_ssunet.py)."""
    side = 32 if arch == "UNet_R_SS_v2" else 64
    with jax_toggles(fused_stage=False, lazy_upsample=True, lazy_pool=True):
        if arch == "UNet_R_SS_v2":
            jmodel = JUNetRSSv2(num_classes=3, input_channels=3, filters=FLAGSHIP_FILTERS)
            port = build_model(arch, 3, 3, filters=FLAGSHIP_FILTERS, device="cpu")
        else:
            jmodel = NarrowSSUNet(num_classes=3)
            port = build_model(arch, 3, 3, filters=S_FILTERS, device="cpu")
        x0 = jnp.zeros((1, side, side, 3), jnp.float32)
        variables = randomize_batch_stats(jax.device_get(
            jit_init(jmodel, jax.random.PRNGKey(0), x0, train=False)))
        port.load_state_dict(from_jax_variables(variables))
        x = np.random.default_rng(5).normal(size=(1, side, side, 3)).astype(np.float32)
        want = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, False))(
            variables, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    seen = _spied_stage(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    assert _seam_counts(seen) == ((2, 2) if arch == "UNet_R_SS_v2" else (4, 3))
    assert got.dtype == torch.bfloat16 and got.shape == (1, side, side, 3)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_BAR)


@pytest.mark.parametrize("arch,filters,want", [("UNet_R_SS", R_FILTERS, (3, 2)),
                                                ("UNet_B_SS", B_FILTERS, (3, 0))])
def test_narrow_forward_seam_counts(monkeypatch, arch, filters, want):
    """``UNet_R_SS`` and ``UNet_B_SS`` at narrow widths with the port's
    planes cap at the level-2 width (so levels 0-2 fuse, as at full width):
    the seams their bf16 forwards hand the kernel stages, (up, pool) as the
    full-width models' (UNet_R_SS: up conv2_2, conv1_3, conv0_4, pool
    conv1_0, conv2_0; UNet_B_SS: its three fused decoders' up seams, no
    pool: the Bottleneck stages' pools are materialized, as in JAX)."""
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32)
    port = build_model(arch, 3, 3, filters=filters, device="cpu", seed=0)
    seen = []
    for name in ("fused_eval_stage", "fused_eval_stage_bneck"):
        def spy(parts, *args, fn=getattr(ssunet, name), **kw):
            seen.append((None, kw.get("up"), kw.get("down")))
            return fn(parts, *args, **kw)

        monkeypatch.setattr(ssunet, name, spy)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = port(x.to(torch.bfloat16))
    assert len(seen) == 6 and _seam_counts(seen) == want
    assert torch.isfinite(out.float()).all()
