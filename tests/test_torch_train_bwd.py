"""The port's v3 backward (ops/train_bwd.py): each chain mode's plain
version against the JAX package's ``fused_conv3_call`` and
``fused_wgrad_call`` in Pallas interpret mode, and ``fused_train_stage``
with the v3 backward against the JAX package's under v3.

The JAX kernels take the prologue and epilogue as callables; the tests use
the very callables the JAX ``train_bwd_v3`` builds, recorded from one JAX
stage backward, so both sides compute the chains of that code. Inputs come
from numpy with a seed, in f32; H = 16 (the JAX band height is 16 there,
which the recorded κ7 epilogue loops over) and W ≥ 8, inside the JAX
interpret-mode envelope, so the JAX side really runs v3. Tolerances, as
tests/test_torch_train_stage.py: conv outputs rtol = atol = 2e-4 (f32
sums in other orders); stat rows rtol 2e-4, atol 2e-3 (sums of ~10³
products of O(1) values); weight gradients rtol = atol = 1e-4 (f32 sums
over N·H·W terms); stage gradients max |Δ| ≤ 1e-3 · max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import stage_kernel_train as jst
from ssunet_gan_tpu.ops import train_bwd as jtb
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from ssunet_gan_tpu_torch.ops import train_bwd as ttb
from torch_port_helpers import (
    STAGES,
    jax_toggles,
    nhwc_of_wminor,
    normal,
    oihw,
    stage_bundle,
    stage_matches_jax,
    tensor,
    vec,
    wminor,
)

TH = 16
CONV_ORDER = ("gamma", "modgrad", "seg", "pre", "bn2", "bn1")
WGRAD_ORDER = ("gb", "mlp", "x2map", "conv2", "conv1")


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        yield


@pytest.fixture(scope="module")
def jax_chains():
    """The prologue/epilogue callables of one JAX ``train_bwd_v3`` (a
    folded-head stage, so κ1 computes γ|β), by the port's mode names."""
    conv, wgrad = [], []
    f3, fw = jtb.fused_conv3_call, jtb.fused_wgrad_call

    def rec3(*args, **kw):
        conv.append(kw)
        return f3(*args, **kw)

    def recw(*args, **kw):
        wgrad.append(kw)
        return fw(*args, **kw)

    rng = np.random.default_rng(0)
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        jtb.fused_conv3_call, jtb.fused_wgrad_call = rec3, recw
        try:
            planes, lab, shapes, nh, ncls = STAGES[3]
            bp, sp, head, *_ = stage_bundle(rng, planes, shapes, lab, nh, ncls)
            x = jnp.asarray(normal(rng, shapes[0]))

            def loss(x):
                return jnp.sum(jst.fused_train_stage((x,), bp, sp, head)[0])

            jax.grad(loss)(x)
        finally:
            jtb.fused_conv3_call, jtb.fused_wgrad_call = f3, fw
    assert len(conv) == 6 and len(wgrad) == 5, (len(conv), len(wgrad))
    return dict(zip(CONV_ORDER, conv)), dict(zip(WGRAD_ORDER, wgrad))


def _convT_pack(k_hwio, bias=None):
    """JAX side: a forward HWIO kernel as the backward-data conv's packing
    (train_bwd_v3's convT_pack); with ``bias`` the plain forward packing."""
    k = jnp.asarray(k_hwio)
    if bias is None:
        k = jnp.flip(k, axis=(0, 1)).transpose(0, 1, 3, 2)
    return jst._pack_conv(k, [k.shape[2]], bias=None if bias is None else jnp.asarray(bias),
                          dtype=jnp.float32)


def _port_convT(k_hwio):
    return ttb._convT(oihw(k_hwio))


def _tiles(vs, w):
    return [jst._tile(jnp.asarray(v), w) for v in vs]


def _pos(rng, shape):
    return (rng.random(shape) + 0.5).astype(np.float32)


CONV_CASES = [
    # mode, part channels (bn1) | None, C, hidden, labels
    ("gamma", None, 16, 4, 3),
    ("modgrad", None, 16, 4, 3),
    ("seg", None, 16, 4, 3),
    ("pre", None, 16, 4, 3),
    ("bn2", None, 16, 4, 3),
    ("bn1", (8,), 16, 4, 3),
    ("bn1", (8, 16), 16, 4, 3),
]


@pytest.mark.parametrize("mode,parts,c,nh,lab", CONV_CASES,
                         ids=[f"{m}-{len(p) if p else 1}" for m, p, *_ in CONV_CASES])
def test_fused_conv3_matches_jax(rng, jax_chains, mode, parts, c, nh, lab):
    chains = jax_chains[0][mode]
    n, h, w = 2, 16, 8
    band = lambda ch: normal(rng, (n, h, w, ch))
    side, consts, bias, shortcut, out_ch = (), (), None, None, None
    if mode == "gamma":  # the head's γ|β: nh → 2C with the bias
        src = (band(nh),)
        k, b = normal(rng, (3, 3, nh, 2 * c), 0.2), normal(rng, (2 * c,), 0.1)
        kp, weight, bias = _convT_pack(k, b), oihw(k), vec(b)
        cout = 2 * c
    elif mode == "modgrad":
        src, side = (band(c), band(c)), (band(nh),)
        k = normal(rng, (3, 3, nh, 2 * c), 0.2)
        kp, weight, cout = _convT_pack(k), _port_convT(k), nh
    elif mode == "seg":
        src = (band(nh),)
        k = normal(rng, (3, 3, lab, nh), 0.3)
        kp, weight, cout = _convT_pack(k), _port_convT(k), lab
    elif mode == "pre":
        src, side = (band(lab),), (band(c), band(c), band(c), band(c))
        k = normal(rng, (3, 3, c, lab), 0.1)
        kp, weight, cout = _convT_pack(k), _port_convT(k), c
        consts = (_pos(rng, c), normal(rng, (c,), 0.3))
    elif mode == "bn2":
        src, side = (band(c), band(c)), (band(c),)
        k = normal(rng, (3, 3, c, c), 0.1)
        kp, weight, cout = _convT_pack(k), _port_convT(k), c
        consts = (_pos(rng, c), normal(rng, (c,), 0.1), normal(rng, (c,), 0.1),
                  normal(rng, (c,), 0.1), _pos(rng, c), normal(rng, (c,), 0.3),
                  _pos(rng, c), normal(rng, (c,), 0.3))
    else:  # bn1
        csum = sum(parts)
        src, side = (band(c), band(c)), (band(c),)
        k = normal(rng, (3, 3, csum, c), 0.1)
        ks = normal(rng, (1, 1, csum, c), 0.3)
        kp, weight, cout = _convT_pack(k), _port_convT(k), csum
        consts = (_pos(rng, c), normal(rng, (c,), 0.1), normal(rng, (c,), 0.1),
                  normal(rng, (c,), 0.1))
        shortcut, out_ch = oihw(ks).transpose(0, 1), list(parts)
    n_stats = ttb.CONV_MODES[mode][4]
    j_consts = _tiles(consts, w) + ([jnp.asarray(ks[0, 0])] if mode == "bn1" else [])
    want, want_stats = jtb.fused_conv3_call(
        [wminor(s) for s in src], kp, pro_fn=chains.get("pro_fn"),
        epi_bands=[wminor(s) for s in side], epi_fn=chains.get("epi_fn"), consts=j_consts,
        out_ch=tuple(out_ch) if out_ch else cout, th=TH, n_stats=n_stats, c_stat=cout)

    got, stats = ttb.fused_conv3_reference(
        mode, tuple(tensor(s) for s in src), weight, tuple(tensor(s) for s in side),
        tuple(vec(v) for v in consts), bias, shortcut, out_ch)
    gots = got if out_ch else (got,)
    wants = want if out_ch else (want,)
    assert len(gots) == len(wants)
    for g, wv in zip(gots, wants):
        np.testing.assert_allclose(g.numpy(), nhwc_of_wminor(wv), rtol=2e-4, atol=2e-4)
    if n_stats:
        assert stats.shape == (n_stats, cout)
        np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats), rtol=2e-4, atol=2e-3)
    else:
        assert stats is None and want_stats is None


WGRAD_CASES = [
    # mode, x part channels, C, hidden, labels
    ("gb", (4,), 16, 4, 3),
    ("mlp", (3,), 16, 4, 3),
    ("x2map", (16,), 16, 4, 3),
    ("conv2", (16,), 16, 4, 3),
    ("conv1", (8, 16), 16, 4, 3),
]


@pytest.mark.parametrize("mode,xch,c,nh,lab", WGRAD_CASES, ids=[m[0] for m in WGRAD_CASES])
def test_fused_wgrad_matches_jax(rng, jax_chains, mode, xch, c, nh, lab):
    chains = jax_chains[1][mode]
    n, h, w = 2, 16, 8
    band = lambda ch: normal(rng, (n, h, w, ch))
    xs = [band(cp) for cp in xch]
    consts, prologue, j_consts = (), None, []
    if mode == "gb":
        g, c_out = (band(c), band(c)), 2 * c
    elif mode == "mlp":
        g, c_out = (band(nh),), nh
    elif mode == "x2map":
        g, c_out = (band(lab),), lab
    else:
        g, c_out = (band(c), band(c)), c
        consts = (_pos(rng, c), normal(rng, (c,), 0.1), normal(rng, (c,), 0.1),
                  normal(rng, (c,), 0.1))
        j_consts = _tiles(consts, w)
        if mode == "conv2":
            prologue = (_pos(rng, c), normal(rng, (c,), 0.3))
            j_consts += _tiles(prologue, w)
    want = jtb.fused_wgrad_call(
        [wminor(x) for x in xs], [wminor(t) for t in g], c_out=c_out, c_in=sum(xch), th=TH,
        x_pro_fn=chains.get("x_pro_fn"), g_pro_fn=chains.get("g_pro_fn"), consts=j_consts)
    got = ttb.fused_wgrad_reference(
        mode, tuple(tensor(x) for x in xs), tuple(tensor(t) for t in g),
        tuple(vec(v) for v in consts), None if prologue is None else tuple(map(vec, prologue)))
    assert got.shape == (c_out, sum(xch), 3, 3)
    np.testing.assert_allclose(got.numpy(), oihw(want).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("planes,lab,shapes,nh,ncls", STAGES)
def test_fused_train_stage_v3_matches_jax(rng, planes, lab, shapes, nh, ncls):
    """Forward, batch stats and every gradient against the JAX fused stage
    (Pallas interpret mode) with the v3 backward on both sides."""
    assert tst._TRAIN_BWD_V3
    assert jtb.bwd_v3_supported((jnp.zeros((1, shapes[0][1], planes, shapes[0][2])),),
                                [s[-1] for s in shapes])
    stage_matches_jax(rng, planes, lab, shapes, nh, ncls)


def _stage_grads(rng_seed, planes, lab, shapes, nh, ncls):
    rng = np.random.default_rng(rng_seed)
    xs = [normal(rng, s) for s in shapes]
    _, _, _, tbp, tsp, thead = stage_bundle(rng, planes, shapes, lab, nh, ncls)
    n, h, w = shapes[0][:3]
    cot = tensor(normal(rng, (n, h, w, ncls or planes)))
    parts = tuple(tensor(x).requires_grad_() for x in xs)
    params = [t.requires_grad_() for t in
              (tbp[0], *tbp[1], tbp[2], *tbp[3], tbp[4], *tsp, *(thead or ()))]
    out, _ = tst.fused_train_stage(parts, tbp, tsp, thead)
    return torch.autograd.grad((out * cot).sum(), [*parts, *params])


@pytest.mark.parametrize("planes,lab,shapes,nh,ncls", STAGES)
def test_v3_matches_v2_on_the_port(planes, lab, shapes, nh, ncls):
    """The two backwards of the port, f32: the same gradients to max |Δ| ≤
    1e-3 · max |v2| (they differ in f32 rounding points only)."""
    v3 = _stage_grads(3, planes, lab, shapes, nh, ncls)
    tst.set_train_bwd_v3(False)
    try:
        v2 = _stage_grads(3, planes, lab, shapes, nh, ncls)
    finally:
        tst.set_train_bwd_v3(True)
    for i, (a, b) in enumerate(zip(v3, v2)):
        rel = (a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-6)
        assert rel < 1e-3, (i, rel.item())


def test_dispatch_defaults_to_v3_and_counts_no_launch_on_the_cpu(monkeypatch):
    """v3 is the default; ``set_train_bwd_v3(False)`` runs v2; CPU tensors
    take the plain versions and count no launch."""
    used = []
    v3, v2 = ttb.train_bwd_v3, tst._train_bwd
    monkeypatch.setattr(ttb, "train_bwd_v3", lambda *a: used.append("v3") or v3(*a))
    monkeypatch.setattr(tst, "_train_bwd", lambda *a: used.append("v2") or v2(*a))
    before = (dict(tst.launches), dict(ttb.launches))
    args = (16, 3, [(1, 16, 8, 8)], 4, 0)
    _stage_grads(0, *args)
    tst.set_train_bwd_v3(False)
    try:
        _stage_grads(0, *args)
    finally:
        tst.set_train_bwd_v3(True)
    _stage_grads(0, *args)
    assert used == ["v3", "v2", "v3"]
    assert (tst.launches, ttb.launches) == before
    assert ttb.bwd_v3_supported([3], 64) and ttb.bwd_v3_supported([256, 256], 256)
    assert not ttb.bwd_v3_supported([8, 8, 8], 16)
    assert not ttb.bwd_v3_supported([8], ttb.MAX_PLANES + 32)


def test_wrappers_check_their_modes(rng):
    x = tensor(normal(rng, (1, 8, 8, 4)))
    with pytest.raises(ValueError, match="unknown mode"):
        ttb.fused_conv3("nope", (x,), torch.zeros(4, 4, 3, 3))
    with pytest.raises(ValueError, match="takes"):
        ttb.fused_conv3("pre", (x,), torch.zeros(4, 4, 3, 3))  # no side bands
    with pytest.raises(ValueError, match="takes"):
        ttb.fused_wgrad("conv2", (x,), (x,))  # no f, no constants
