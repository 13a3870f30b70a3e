"""The port's train-stage kernels (their plain versions, on the CPU) and its
``fused_train_stage`` against the JAX package's Pallas kernels in interpret
mode and its ``fused_train_stage`` with the v2 backward, at the shapes of
tests/test_train_kernel.py.

Inputs and weights come from numpy with a seed, in f32, and cross between
the frameworks as numpy. Tolerances: conv, tail and stage forwards rtol =
atol = 2e-4 (both sides sum f32 products in different orders; the JAX
package's own eval-stage pin); the per-channel sums rtol 2e-4 with atol
2e-3 (sums of ~10³ squares of O(1) values); weight gradients rtol = atol =
1e-4 (tests/test_train_kernel.py:194, f32 sums over N·H·W terms); stage
gradients max |Δ| ≤ 1e-3 · max |JAX| (the JAX package's own gradient bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ssunet_gan_tpu.ops import stage_kernel_train as jst
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from torch_port_helpers import (
    STAGES,
    jax_toggles,
    nhwc_of_wminor as _nhwc,
    normal as _normal,
    oihw,
    spade_weights as _spade,
    stage_matches_jax,
    tensor as _t,
    vec,
    wminor as _wminor,
)


@pytest.fixture(autouse=True)
def _jax_modes():
    """Both sides run the v2 backward (the port's v3 is tests/test_torch_train_bwd.py's)."""
    tst.set_train_bwd_v3(False)
    try:
        with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=False):
            yield
    finally:
        tst.set_train_bwd_v3(True)


@pytest.mark.parametrize(
    "shapes,c,prologue,bias",
    [
        ([(2, 16, 8, 8)], 16, False, False),                  # conv1, one part
        ([(1, 16, 16, 8), (1, 16, 16, 16)], 16, False, False),  # two parts
        ([(2, 24, 16, 16)], 32, True, False),                 # conv2: BN1+ReLU prologue
        ([(1, 16, 8, 4)], 32, False, True),                   # γ|β recompute: nh → 2C, bias
        ([(1, 16, 8, 16)], 3, False, False),                  # backward-data to 3 channels
    ],
)
def test_conv_stats_matches_jax(rng, shapes, c, prologue, bias):
    xs = [_normal(rng, s) for s in shapes]
    chans = [s[-1] for s in shapes]
    k = _normal(rng, (3, 3, sum(chans), c), 0.2)
    b = _normal(rng, (c,), 0.3) if bias else None
    pro = ((rng.random(chans[0]) + 0.5).astype(np.float32),
           _normal(rng, (chans[0],), 0.3)) if prologue else None
    w = shapes[0][2]
    kp = jst._pack_conv(jnp.asarray(k), chans, None if b is None else jnp.asarray(b),
                        dtype=jnp.float32)
    jpro = None if pro is None else tuple(jst._tile(jnp.asarray(v), w) for v in pro)
    out_v, sums = jst._conv_stats_call([_wminor(x) for x in xs], kp, prologue=jpro)

    got, got_sums = tst.conv_stats_reference(
        tuple(_t(x) for x in xs), oihw(k), None if b is None else vec(b),
        None if pro is None else (vec(pro[0]), vec(pro[1])))
    np.testing.assert_allclose(got.numpy(), _nhwc(out_v), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("planes,lab,shapes,nh,ncls", STAGES)
def test_train_tail_matches_jax(rng, planes, lab, shapes, nh, ncls):
    n, h, w = shapes[0][:3]
    chans = [s[-1] for s in shapes]
    xs = [_normal(rng, s) for s in shapes]
    f2 = _normal(rng, (n, h, w, planes))
    a2 = (rng.random(planes) + 0.5).astype(np.float32)
    b2 = _normal(rng, (planes,), 0.3)
    ks = _normal(rng, (1, 1, sum(chans), planes), 0.3)
    sp, tsp = _spade(rng, planes, lab, nh)
    head = None
    if ncls:
        head = (_normal(rng, (1, 1, planes, ncls), 0.3), _normal(rng, (ncls,), 0.1))

    ws = jnp.concatenate([jnp.asarray(ks[0, 0, o:o + c]).T
                          for o, c in zip(np.cumsum([0] + chans[:-1]), chans)], axis=1)
    k1s, k2s, k3s = jst._pack_spade(tuple(jnp.asarray(a) for a in sp), planes, jnp.float32)
    kf = None if head is None else jnp.concatenate(
        [jnp.asarray(head[0][0, 0]).T, jnp.asarray(head[1]).reshape(ncls, 1)], axis=1)
    want = jst._tail_call(_wminor(f2), [_wminor(x) for x in xs], jst._tile(jnp.asarray(a2), w),
                          jst._tile(jnp.asarray(b2), w), ws, k1s, k2s, k3s, KF=kf,
                          lab=lab, nhid=nh)

    got = tst.train_tail_reference(
        _t(f2), tuple(_t(x) for x in xs), vec(a2), vec(b2), oihw(ks), tsp,
        None if head is None else (oihw(head[0]), vec(head[1])))
    for name, g, wv in zip(("out", "y", "seg", "actv"), got, want):
        np.testing.assert_allclose(g.numpy(), _nhwc(wv), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize(
    "n,h,w,cps,c,prologue",
    [
        (2, 16, 8, (8,), 16, False),     # test_train_kernel.py:179
        (1, 24, 16, (8, 4), 8, False),
        (2, 16, 8, (16,), 32, False),
        (2, 16, 8, (16,), 16, True),     # conv2's weight gradient: h1r recomputed
    ],
)
def test_wgrad_matches_jax(rng, n, h, w, cps, c, prologue):
    parts = [_normal(rng, (n, h, w, cp)) for cp in cps]
    g = _normal(rng, (n, h, w, c))
    pro = ((rng.random(cps[0]) + 0.5).astype(np.float32),
           _normal(rng, (cps[0],), 0.3)) if prologue else None
    if pro is None:
        want = jst._conv3_wgrad([jnp.asarray(p) for p in parts], jnp.asarray(g))
    else:
        want = jst._wgrad_w([_wminor(parts[0])], _wminor(g),
                            prologue=tuple(jst._tile(jnp.asarray(v), w) for v in pro))
    got = tst.wgrad_reference(tuple(_t(p) for p in parts), _t(g),
                              None if pro is None else (vec(pro[0]), vec(pro[1])))
    np.testing.assert_allclose(got.numpy(), oihw(want).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("planes,lab,shapes,nh,ncls", STAGES)
def test_fused_train_stage_matches_jax(rng, planes, lab, shapes, nh, ncls):
    """Forward, batch stats and every gradient against ``jax.vjp``-style
    grads of the JAX fused stage (Pallas interpret mode, v2 backward)."""
    stage_matches_jax(rng, planes, lab, shapes, nh, ncls)


def test_wrappers_take_the_plain_path_on_the_cpu(rng):
    """CPU tensors run the plain versions (no launch counted); the
    backward-data conv is the forward conv's transpose."""
    before = dict(tst.launches)
    x = _t(_normal(rng, (1, 8, 8, 4)))
    wt = _t(_normal(rng, (6, 4, 3, 3)))
    g = _t(_normal(rng, (1, 8, 8, 6)))
    y, sums = tst.conv_stats((x,), wt)
    assert y.shape == (1, 8, 8, 6) and sums.shape == (2, 6)
    # <conv(x), g> == <x, convT(g)>
    lhs = (y.double() * g.double()).sum()
    rhs = (x.double() * tst.conv_transpose(g, wt).double()).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)
    assert tst.wgrad((x,), g).shape == (6, 4, 3, 3)
    assert tst.launches == before
