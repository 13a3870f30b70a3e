"""The f32 train convs' wgmma route (``csrc/f32_wgmma_conv.cuh``, rows 2f
and 5f) on the CPU, where no kernel runs: the route's plain version, the
``*_emulated`` functions of ``ops/train_f32.py`` (the wrappers' plain
versions with the kernel's arithmetic: the chains in f32, the products in
3xTF32), holds against the JAX package's ``_conv_stats_call`` and
``fused_conv3_call`` in f32 (Pallas interpret mode) at the widths the wgmma
kernel takes (more than 16 output channels), for FM_STD, FM_AFF,
FM_MODGRAD, FM_BN2 and FM_BN1; with +inf, -inf and NaN planted in segment
0, every output's class equals JAX's. Which calls take the wgmma kernel is
the kernel's own launch plan (``csrc/train_f32.cu`` ``conv_plan``), read
on the card (tests/test_torch_gpu.py).

Inputs from numpy with a seed, f32, H 16, W 8, ≤ 32 channels. Tolerances
as tests/test_torch_train_bwd.py: outputs rtol = atol = 2e-4 (f32 sums in
other orders, 3xTF32 products within ~2^-21), stat rows rtol 2e-4 with atol
2e-3 (sums of ~10³ products of O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import stage_kernel_train as jst
from ssunet_gan_tpu.ops import train_bwd as jtb
from ssunet_gan_tpu_torch.ops import train_bwd as ttb
from ssunet_gan_tpu_torch.ops import train_f32
from torch_port_helpers import (
    STAGES,
    jax_toggles,
    nhwc_of_wminor,
    normal,
    oihw,
    stage_bundle,
    tensor,
    vec,
    wminor,
)


class _Recorded(Exception):
    """Ends the recording backward after its sixth fused_conv3 call (κ7)."""


@pytest.fixture(scope="module")
def jax_chains():
    """The prologue/epilogue callables of one JAX ``train_bwd_v3`` (a
    folded-head stage, so κ1 computes γ|β), by the port's mode names, as
    tests/test_torch_train_bwd.py records them; the backward stops once κ7's
    are recorded."""
    conv = []
    f3 = jtb.fused_conv3_call

    def rec3(*args, **kw):
        conv.append(kw)
        if len(conv) == 6:
            raise _Recorded
        return f3(*args, **kw)

    rng = np.random.default_rng(0)
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        jtb.fused_conv3_call = rec3
        try:
            planes, lab, shapes, nh, ncls = STAGES[3]
            bp, sp, head, *_ = stage_bundle(rng, planes, shapes, lab, nh, ncls)
            x = jnp.asarray(normal(rng, shapes[0]))
            jax.grad(lambda x: jnp.sum(jst.fused_train_stage((x,), bp, sp, head)[0]))(x)
        except _Recorded:
            pass
        finally:
            jtb.fused_conv3_call = f3
    assert len(conv) == 6
    return dict(zip(("gamma", "modgrad", "seg", "pre", "bn2", "bn1"), conv))


def _pos(rng, shape):
    return (rng.random(shape) + 0.5).astype(np.float32)


N, H, W = 2, 16, 8


def _conv_stats_pair(rng, shapes, c, prologue, bias, plant=False):
    """One conv_stats call on the route's plain version and on JAX
    ``_conv_stats_call``: ((out, sums), (JAX out as NHWC, JAX sums))."""
    xs = [normal(rng, s) for s in shapes]
    if plant:
        xs[0] = _planted(rng, xs[0])
    chans = [s[-1] for s in shapes]
    k = normal(rng, (3, 3, sum(chans), c), 0.2)
    b = normal(rng, (c,), 0.3) if bias else None
    pro = (_pos(rng, chans[0]), normal(rng, (chans[0],), 0.3)) if prologue else None
    kp = jst._pack_conv(jnp.asarray(k), chans, None if b is None else jnp.asarray(b),
                        dtype=jnp.float32)
    jpro = None if pro is None else tuple(jst._tile(jnp.asarray(v), W) for v in pro)
    with jax_toggles(fused_stage=True, fused_train=True):
        out_v, sums = jst._conv_stats_call([wminor(x) for x in xs], kp, prologue=jpro)
    got = train_f32.conv_stats_emulated(tuple(tensor(x) for x in xs), oihw(k),
                                        None if b is None else vec(b),
                                        None if pro is None else (vec(pro[0]), vec(pro[1])))
    return got, (nhwc_of_wminor(out_v), np.asarray(sums))


@pytest.mark.parametrize("shapes,c,prologue,bias", [
    ([(N, H, W, 8)], 32, False, False),                   # FM_STD, one part
    ([(N, H, W, 8), (N, H, W, 16)], 32, False, False),    # FM_STD, two parts
    ([(N, H, W, 16)], 32, True, False),                   # FM_AFF: conv2's prologue
    ([(N, H, W, 4)], 32, False, True),                    # FM_STD with κ1's bias
], ids=["std", "std_two_parts", "aff", "std_bias"])
def test_conv_stats_route_matches_jax(rng, shapes, c, prologue, bias):
    """Kernel 2 on the f32 route's plain version
    (``train_f32.conv_stats_emulated``) against JAX ``_conv_stats_call`` in
    f32."""
    (got, got_sums), (want, want_sums) = _conv_stats_pair(rng, shapes, c, prologue, bias)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_sums.numpy(), want_sums, rtol=2e-4, atol=2e-3)


def _planted(rng, x):
    """``x`` with +inf, -inf and NaN at seeded positions, two of each."""
    x = x.copy()
    pos = rng.choice(x.size, 6, replace=False)
    x.reshape(-1)[pos] = np.array([np.inf, -np.inf, np.nan] * 2, np.float32)
    return x


def _classes(a):
    """Each element's class: 0 finite, 1 NaN, 2 +inf, 3 -inf."""
    a = np.asarray(a)
    return np.isnan(a) * 1 + np.isposinf(a) * 2 + np.isneginf(a) * 3


@pytest.mark.parametrize("prologue", [False, True], ids=["std", "aff"])
def test_conv_stats_route_keeps_non_finite_classes_of_jax(rng, prologue):
    """+inf, -inf and NaN planted in segment 0 (before conv2's prologue):
    the kernel runs a window that holds one with its big part as 0 in the
    big × small(weight) product, so every output's class equals JAX's
    plain f32 conv's, and the plants reach the output."""
    (got, _), (want, _) = _conv_stats_pair(rng, [(N, H, W, 8)], 32, prologue, False, plant=True)
    np.testing.assert_array_equal(_classes(got.numpy()), _classes(want))
    assert np.isnan(want).any()
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=2e-4, atol=2e-4)


def _convT_pack(k_hwio):
    """JAX side: a forward HWIO kernel as the backward-data conv's packing
    (train_bwd_v3's convT_pack)."""
    k = jnp.flip(jnp.asarray(k_hwio), axis=(0, 1)).transpose(0, 1, 3, 2)
    return jst._pack_conv(k, [k.shape[2]], bias=None, dtype=jnp.float32)


def _fused_conv3_pair(rng, chains, mode, parts, plant=False):
    """One fused_conv3 call of ``mode`` on the route's plain version and on
    JAX ``fused_conv3_call``: ((outputs, stats), (JAX outputs as NHWC, JAX
    stats)), the outputs as tuples."""
    c, nh = 16 if mode == "modgrad" else 32, 32
    band = lambda ch: normal(rng, (N, H, W, ch))
    side, consts, shortcut, out_ch = (), (), None, None
    if mode == "modgrad":
        src, side = (band(c), band(c)), (band(nh),)
        k = normal(rng, (3, 3, nh, 2 * c), 0.2)
        kp, weight, cout = _convT_pack(k), ttb._convT(oihw(k)), nh
    elif mode == "bn2":
        src, side = (band(c), band(c)), (band(c),)
        k = normal(rng, (3, 3, c, c), 0.1)
        kp, weight, cout = _convT_pack(k), ttb._convT(oihw(k)), c
        consts = (_pos(rng, c), normal(rng, (c,), 0.1), normal(rng, (c,), 0.1),
                  normal(rng, (c,), 0.1), _pos(rng, c), normal(rng, (c,), 0.3),
                  _pos(rng, c), normal(rng, (c,), 0.3))
    else:  # bn1
        csum = sum(parts)
        src, side = (band(c), band(c)), (band(c),)
        k = normal(rng, (3, 3, csum, c), 0.1)
        ks = normal(rng, (1, 1, csum, c), 0.3)
        kp, weight, cout = _convT_pack(k), ttb._convT(oihw(k)), csum
        consts = (_pos(rng, c), normal(rng, (c,), 0.1), normal(rng, (c,), 0.1),
                  normal(rng, (c,), 0.1))
        shortcut, out_ch = oihw(ks).transpose(0, 1), list(parts)
    if plant:
        src = (_planted(rng, src[0]),) + src[1:]
    assert cout > 16  # the wgmma route's widths
    n_stats = ttb.CONV_MODES[mode][4]
    j_consts = ([jst._tile(jnp.asarray(v), W) for v in consts]
                + ([jnp.asarray(ks[0, 0])] if mode == "bn1" else []))
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        want, want_stats = jtb.fused_conv3_call(
            [wminor(s) for s in src], kp, pro_fn=chains.get("pro_fn"),
            epi_bands=[wminor(s) for s in side], epi_fn=chains.get("epi_fn"), consts=j_consts,
            out_ch=tuple(out_ch) if out_ch else cout, th=H, n_stats=n_stats, c_stat=cout)
    got, stats = train_f32.fused_conv3_emulated(mode, tuple(tensor(s) for s in src), weight,
                                                tuple(tensor(s) for s in side),
                                                tuple(vec(v) for v in consts), None, shortcut,
                                                out_ch)
    gots = tuple(got) if out_ch else (got,)
    wants = tuple(nhwc_of_wminor(v) for v in (want if out_ch else (want,)))
    assert len(gots) == len(wants)
    return (gots, stats), (wants, want_stats)


@pytest.mark.parametrize("mode,parts", [
    ("modgrad", None), ("bn2", None), ("bn1", (24,)), ("bn1", (8, 24)),
], ids=["modgrad", "bn2", "bn1", "bn1_two_parts"])
def test_fused_conv3_route_matches_jax(rng, jax_chains, mode, parts):
    """Kernel 5's chain modes on the f32 route's plain version
    (``train_f32.fused_conv3_emulated``): κ3 (FM_MODGRAD at hidden 32), κ6
    (FM_BN2), κ7 (FM_BN1, the shortcut segment, one or two output parts)
    against JAX ``fused_conv3_call`` in f32 with the callables JAX's
    ``train_bwd_v3`` builds (κ1's γ|β, FM_STD with a bias, is the conv_stats
    case above)."""
    (gots, stats), (wants, want_stats) = _fused_conv3_pair(rng, jax_chains[mode], mode, parts)
    for g, wv in zip(gots, wants):
        np.testing.assert_allclose(g.numpy(), wv, rtol=2e-4, atol=2e-4)
    n_stats = ttb.CONV_MODES[mode][4]
    if n_stats:
        assert stats.shape == (n_stats, gots[0].shape[-1])
        np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats), rtol=2e-4, atol=2e-3)
    else:
        assert stats is None and want_stats is None


@pytest.mark.parametrize("mode,parts", [("bn2", None), ("bn1", (8, 24))],
                         ids=["bn2", "bn1_two_parts"])
def test_fused_conv3_route_keeps_non_finite_classes_of_jax(rng, jax_chains, mode, parts):
    """+inf, -inf and NaN planted in segment 0, before the BN backward's
    chain: every output's class equals JAX's, and the plants
    reach the output."""
    (gots, _), (wants, _) = _fused_conv3_pair(rng, jax_chains[mode], mode, parts, plant=True)
    assert any(np.isnan(wv).any() for wv in wants)
    for g, wv in zip(gots, wants):
        np.testing.assert_array_equal(_classes(g.numpy()), _classes(wv))
        finite = np.isfinite(wv)
        np.testing.assert_allclose(g.numpy()[finite], wv[finite], rtol=2e-4, atol=2e-4)
