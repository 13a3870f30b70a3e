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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import stage_kernel_train as jst
from ssunet_gan_tpu.ops.wminor import to_nhwc
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from torch_port_helpers import jax_toggles, oihw, vec


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True, fused_train=True):
        yield


def _wminor(x):
    """NHWC numpy → the JAX kernels' (N, H, C, W) view."""
    return jnp.swapaxes(jnp.asarray(x), 2, 3)


def _nhwc(v):
    return np.swapaxes(np.asarray(v), 2, 3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


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


def _spade(rng, planes, lab, nh):
    """SPADE weights: HWIO for JAX, OIHW for the port."""
    hwio = (_normal(rng, (3, 3, planes, lab), 0.1), _normal(rng, (lab,), 0.1),
            _normal(rng, (3, 3, lab, nh), 0.3), _normal(rng, (nh,), 0.1),
            _normal(rng, (3, 3, nh, planes), 0.2), _normal(rng, (planes,), 0.1),
            _normal(rng, (3, 3, nh, planes), 0.2), _normal(rng, (planes,), 0.1))
    return hwio, tuple(oihw(a) if a.ndim == 4 else vec(a) for a in hwio)


STAGES = [
    (16, 3, [(2, 16, 16, 8)], 4, 0),                       # test_train_kernel.py:48
    (16, 3, [(1, 16, 16, 8), (1, 16, 16, 16)], 4, 0),      # :49, split-concat
    (32, 2, [(2, 24, 16, 16)], 8, 0),                      # :50
    (16, 3, [(1, 16, 16, 8)], 4, 3),                       # :147, folded head
]


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


def _stage_bundle(rng, planes, shapes, lab, nh, ncls):
    """Random raw train parameters: JAX (HWIO) and port (OIHW) forms."""
    csum = sum(s[-1] for s in shapes)
    bp = (_normal(rng, (3, 3, csum, planes), 0.2),
          ((rng.random(planes) + 0.5).astype(np.float32), _normal(rng, (planes,), 0.2)),
          _normal(rng, (3, 3, planes, planes), 0.1),
          ((rng.random(planes) + 0.5).astype(np.float32), _normal(rng, (planes,), 0.2)),
          _normal(rng, (1, 1, csum, planes), 0.3))
    sp, tsp = _spade(rng, planes, lab, nh)
    head = thead = None
    if ncls:
        head = (_normal(rng, (1, 1, planes, ncls), 0.3), _normal(rng, (ncls,), 0.1))
        thead = (oihw(head[0]), vec(head[1]))
    k1, (g1, b1), k2, (g2, b2), ks = bp
    tbp = (oihw(k1), (vec(g1), vec(b1)), oihw(k2), (vec(g2), vec(b2)), oihw(ks))
    return bp, sp, head, tbp, tsp, thead


@pytest.mark.parametrize("planes,lab,shapes,nh,ncls", STAGES)
def test_fused_train_stage_matches_jax(rng, planes, lab, shapes, nh, ncls):
    """Forward, batch stats and every gradient against ``jax.vjp``-style
    grads of the JAX fused stage (Pallas interpret mode, v2 backward)."""
    xs = [_normal(rng, s) for s in shapes]
    bp, sp, head, tbp, tsp, thead = _stage_bundle(rng, planes, shapes, lab, nh, ncls)
    n, h, w = shapes[0][:3]
    cot = _normal(rng, (n, h, w, ncls or planes))

    def jax_loss(parts, bp, sp, head):
        out, stats = jst.fused_train_stage(parts, bp, sp, head)
        out = out if head is not None else to_nhwc(out)
        return jnp.sum(out * cot), (out, stats)

    jparts = tuple(jnp.asarray(x) for x in xs)
    jbp = jax.tree_util.tree_map(jnp.asarray, bp)
    jsp = tuple(jnp.asarray(a) for a in sp)
    jhead = None if head is None else tuple(jnp.asarray(a) for a in head)
    argnums = (0, 1, 2) if head is None else (0, 1, 2, 3)
    (_, (want_out, want_stats)), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(jparts, jbp, jsp, jhead)

    parts = tuple(_t(x).requires_grad_() for x in xs)
    params = [t.requires_grad_() for t in
              (tbp[0], *tbp[1], tbp[2], *tbp[3], tbp[4], *tsp, *(thead or ()))]
    out, stats = tst.fused_train_stage(parts, tbp, tsp, thead)
    grads = torch.autograd.grad((out * _t(cot)).sum(), [*parts, *params])

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    for got_pair, want_pair in zip(stats, want_stats):
        for g, wv in zip(got_pair, want_pair):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=2e-4, atol=2e-4)

    # JAX grads in the port's order and layout: parts, then the parameters
    jg_parts, (gk1, (gg1, gb1), gk2, (gg2, gb2), gks), jg_sp = jgrads[:3]
    want = list(jg_parts) + [gk1, gg1, gb1, gk2, gg2, gb2, gks] + list(jg_sp)
    if head is not None:
        want += list(jgrads[3])
    assert len(want) == len(grads)
    for i, (g, wv) in enumerate(zip(grads, want)):
        wv = np.asarray(wv, np.float64)
        if wv.ndim == 4 and g.dim() == 4 and i >= len(parts):
            wv = oihw(wv).numpy()
        rel = np.abs(g.double().numpy() - wv).max() / (np.abs(wv).max() + 1e-6)
        assert rel < 1e-3, (i, rel)


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
