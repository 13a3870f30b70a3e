"""The f32 weight gradient (kernels 4 and 6 in float32: ``ops/train_f32.py``
``launch_wgrad`` on ``csrc/wgrad_f32.cu``, a pre-pass that runs the
cotangent's chain and split once per value, then the product on ``wgmma``)
on the CPU, where no kernel runs and each wrapper takes its plain version:

- the pre-pass's plain version (``wgrad_prep_reference``) for each
  cotangent mode, one and two parts, with and without conv2's prologue: its
  planes hold exactly ``split_tf32`` of the chain that
  ``fused_wgrad_reference`` builds (``ops/train_bwd.py`` ``_cotangent``),
  bit for bit, zero outside the image and past cout; big + small rebuilds
  each value within 2^-22 of it, big with TF32's 10-bit mantissa;
- the product's plain version (3xTF32 over the planes) against
  ``fused_wgrad_emulated`` and ``wgrad_emulated`` within 1e-6 relative;
- both against the JAX package's ``fused_wgrad_call`` (each chain mode) and
  ``_wgrad_w`` in f32, Pallas interpret mode, at rtol = atol = 2e-4, the
  bar of tests/test_torch_train_f32.py. The JAX chain callables are
  restated from ssunet_gan_tpu/ops/train_bwd.py (``gpro_modgrad`` :585,
  ``xpro_h1r`` / ``gpro_bn2`` :709-717, ``gpro_bn1`` :756), since recording
  them from a JAX backward takes most of this file's time budget;
- the launch plan (``wgrad_plan``, mirrored from the kernel's block
  mapping): every (dW row, input channel, tap) is summed by exactly one
  block and m64 tile and every pixel by exactly one tile and k8 step, for
  the flagship's 30 weight gradients of a step (batch 8, 512²) and for odd
  H and W; its shared memory fits the card.

Inputs from numpy with a seed, f32, batch 2, 8-37 pixels a side, 3-40
channels.
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
from ssunet_gan_tpu_torch.ops import train_f32 as tf
from ssunet_gan_tpu_torch.ops.stage_kernel import split_tf32
from torch_port_helpers import jax_toggles, normal, oihw, tensor, vec, wminor

GMODE = {"gb": 1, "mlp": 0, "x2map": 0, "conv2": 2, "conv1": 2}

CASES = [
    # mode, x part channels, C (g's channels), (n, h, w), conv2's prologue
    ("conv1", (3,), 8, (2, 16, 16), False),      # the image input: one m64 tile, K split
    ("conv1", (24, 40), 16, (2, 17, 23), False),  # two parts, odd H and W
    ("conv2", (40,), 40, (2, 32, 20), True),     # 40 rows: N blocks of 64 over a tap row
    ("conv2", (16,), 8, (2, 16, 16), True),
    ("gb", (4,), 12, (2, 16, 16), False),        # [g·y ; g]: 24 rows
    ("gb", (8,), 20, (2, 20, 18), False),        # 40 rows, the halves inside one quad
    ("mlp", (3,), 4, (2, 16, 16), False),
    ("x2map", (33,), 3, (2, 19, 32), False),     # cout 3 padded to 8, 33 channels
]
IDS = [f"{m}-{'+'.join(map(str, x))}-{c}{'-pro' if p else ''}" for m, x, c, _, p in CASES]


def _inputs(rng, mode, xch, c, nhw, pro):
    """(x, g, consts, prologue, cout) of one call, f32 CPU tensors."""
    n, h, w = nhw
    band = lambda ch: tensor(normal(rng, (n, h, w, ch)))
    x = tuple(band(k) for k in xch)
    g = (band(c), band(c)) if mode in ("gb", "conv1", "conv2") else (band(c),)
    consts = ()
    if GMODE[mode] == 2:
        consts = (vec((rng.random(c) + 0.5).astype(np.float32)), vec(normal(rng, (c,), 0.3)),
                  vec((rng.random(c) + 0.5).astype(np.float32)), vec(normal(rng, (c,), 0.3)))
    prologue = None
    if pro:
        prologue = (vec((rng.random(xch[0]) + 0.5).astype(np.float32)),
                    vec(normal(rng, (xch[0],), 0.3)))
    return x, g, consts, prologue, 2 * c if mode == "gb" else c


def _plan(x, cout):
    n, h, w = x[0].shape[:3]
    return tf.wgrad_plan(tuple(p.shape[-1] for p in x), cout, n, h, w)


@pytest.mark.parametrize("mode,xch,c,nhw,pro", CASES, ids=IDS)
def test_prep_holds_the_split_chain_bit_for_bit(rng, mode, xch, c, nhw, pro):
    x, g, consts, prologue, cout = _inputs(rng, mode, xch, c, nhw, pro)
    plan = _plan(x, cout)
    planes, parts = tf.wgrad_prep(GMODE[mode], g, consts, cout, plan, x, prologue)
    assert planes.shape == (plan.ntiles * plan.coutp * tf.WG_TP * 2,)
    # the product's input: the parts as given, or the single one's prologue
    want_parts = x if prologue is None else (tst._prologued(x[0], prologue),)
    assert len(parts) == len(want_parts)
    assert all(torch.equal(p, q) for p, q in zip(parts, want_parts))
    chain = ttb._cotangent(mode, g, consts, torch.float32)
    assert torch.equal(tf.wgrad_cotangent(GMODE[mode], g, consts), chain)
    want_big, want_small = split_tf32(chain)
    big, small = tf.wgrad_planes(planes, plan, *nhw, cout)
    assert torch.equal(big, want_big) and torch.equal(small, want_small)
    # the padding (pixels of a tile outside the image, rows past cout) is 0
    assert (planes != 0).sum() == (big != 0).sum() + (small != 0).sum()


@pytest.mark.parametrize("mode,xch,c,nhw,pro", CASES[:3] + CASES[4:5], ids=IDS[:3] + IDS[4:5])
def test_split_rebuilds_each_value(rng, mode, xch, c, nhw, pro):
    x, g, consts, _, cout = _inputs(rng, mode, xch, c, nhw, pro)
    v = ttb._cotangent(mode, g, consts, torch.float32)
    big, small = split_tf32(v)
    err = (big.double() + small.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())
    for part in (big, small):  # TF32: the low 13 mantissa bits are zero
        assert not bool((part.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("mode,xch,c,nhw,pro", CASES, ids=IDS)
def test_product_matches_the_emulated_route(rng, mode, xch, c, nhw, pro):
    x, g, consts, prologue, cout = _inputs(rng, mode, xch, c, nhw, pro)
    got = tf.launch_wgrad(GMODE[mode], x, g, consts, prologue, cout)
    want = tf.fused_wgrad_emulated(mode, x, g, consts, prologue)
    assert got.shape == want.shape == (cout, sum(xch), 3, 3) and got.dtype == torch.float32
    assert ((got - want).norm() / want.norm()).item() <= 1e-6
    if mode == "conv2":  # the v2 weight gradient of the same input and cotangent
        cot = ttb._cotangent(mode, g, consts, torch.float32)
        got = tf.launch_wgrad(0, x, (cot,), (), prologue, cout)
        want = tf.wgrad_emulated(x, cot, prologue)
        assert ((got - want).norm() / want.norm()).item() <= 1e-6


# ---- against the JAX package (Pallas interpret mode, f32) ----

def _jax_chains():
    def gpro_modgrad(gv, cv):
        g0b, yb = gv
        gg = (g0b.astype(jnp.float32) * yb.astype(jnp.float32)).astype(jnp.float32)
        return jnp.concatenate([gg, g0b], axis=1)

    def xpro_h1r(slabs, cv):
        return jax.nn.relu(slabs[0].astype(jnp.float32) * cv[4] + cv[5])

    def gpro_bn(gv, cv):
        gf, ff = (t.astype(jnp.float32) for t in gv)
        return cv[0] * (gf - cv[1] - (ff * cv[2] - cv[3]))

    return {"gb": {"g_pro_fn": gpro_modgrad}, "mlp": {}, "x2map": {},
            "conv2": {"x_pro_fn": xpro_h1r, "g_pro_fn": gpro_bn}, "conv1": {"g_pro_fn": gpro_bn}}


JAX_CASES = [("gb", (4,), 16), ("mlp", (3,), 4), ("x2map", (16,), 3), ("conv2", (16,), 16),
             ("conv1", (8, 16), 16)]


@pytest.mark.parametrize("mode,xch,c", JAX_CASES, ids=[m[0] for m in JAX_CASES])
def test_matches_jax_fused_wgrad_call(rng, mode, xch, c):
    n, h, w = 2, 16, 8
    x, g, consts, prologue, cout = _inputs(rng, mode, xch, c, (n, h, w), mode == "conv2")
    j_consts = [jst._tile(jnp.asarray(t.numpy()), w) for t in consts + (prologue or ())]
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        want = jtb.fused_wgrad_call(
            [wminor(t.numpy()) for t in x], [wminor(t.numpy()) for t in g], c_out=cout,
            c_in=sum(xch), th=16, consts=j_consts, **_jax_chains()[mode])
    got = tf.launch_wgrad(GMODE[mode], x, g, consts, prologue, cout)
    np.testing.assert_allclose(got.numpy(), oihw(want).numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cps,c,pro", [((8,), 16, False), ((8, 4), 8, False), ((16,), 16, True)],
                         ids=["one", "two", "prologue"])
def test_matches_jax_wgrad_w(rng, cps, c, pro):
    n, h, w = 2, 16, 8
    x = tuple(tensor(normal(rng, (n, h, w, cp))) for cp in cps)
    g = tensor(normal(rng, (n, h, w, c)))
    prologue = None
    if pro:
        prologue = (vec((rng.random(cps[0]) + 0.5).astype(np.float32)),
                    vec(normal(rng, (cps[0],), 0.3)))
    with jax_toggles(fused_stage=True, fused_train=True):
        want = jst._wgrad_w([wminor(p.numpy()) for p in x], wminor(g.numpy()), prologue=None if (
            prologue is None) else tuple(jst._tile(jnp.asarray(v.numpy()), w) for v in prologue))
    got = tf.launch_wgrad(0, x, (g,), (), prologue, c)
    np.testing.assert_allclose(got.numpy(), oihw(want).numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), tst.wgrad_reference(x, g, prologue).numpy(),
                               rtol=2e-4, atol=2e-4)


# ---- the launch plan ----

def _plan_coverage(channels, cout, n, h, w):
    """The kernel's block mapping (csrc/wgrad_f32.cu wgrad_f32_kernel) over
    the plan: how many times each (dW row, input channel, tap) is summed,
    each pixel covered, and the largest window row a block reads."""
    p = tf.wgrad_plan(tuple(channels), cout, n, h, w)
    cnt = np.zeros((cout, sum(channels), 9), np.int64)
    rows = 64 * 3 * p.mt
    xoff = np.cumsum((0,) + tuple(channels))
    for part, xc in enumerate(channels):
        for chunk in range(-(-xc // p.cc)):
            cb = chunk * p.cc
            for rb in range(p.nrb):
                r0, rend = rb * rows, min(9 * p.cc, rb * rows + rows)
                nmt = -(-(rend - r0) // 64)
                dlo, dhi = (r0 // p.cc) // 3, ((rend - 1) // p.cc) // 3
                assert (tf.WG_TH + dhi - dlo) * p.xs <= tf.wg_xfloats(p.nb)  # the slot's window
                if nmt == 1:  # the three warpgroups split the tile's k8 steps
                    steps = sorted(k for wg in range(3) for k in (wg, wg + 3, wg + 6) if k < 8)
                    assert steps == list(range(tf.WG_TP // 8))
                tiles = sorted(wg + 3 * i for wg in range(3) for i in range(p.mt)
                               if wg + 3 * i < nmt) if nmt > 1 else [0]
                assert tiles == list(range(nmt))
                for nbi in range(p.nblk):
                    n0 = nbi * p.nb
                    for mt in tiles:
                        r = r0 + mt * 64 + np.arange(64)
                        r = r[r < rend]
                        tap, ch = r // p.cc, cb + r % p.cc
                        keep = ch < xc
                        np.add.at(cnt, (slice(n0, min(n0 + p.nb, cout)),
                                        xoff[part] + ch[keep], tap[keep]), 1)
    tiles = np.concatenate([np.arange(s * p.tiles_per_split,
                                      min((s + 1) * p.tiles_per_split, p.ntiles))
                            for s in range(p.splits)])
    assert np.array_equal(tiles, np.arange(p.ntiles))
    px = np.zeros((n, p.tiles_h * tf.WG_TH, p.tiles_w * tf.WG_TW), np.int64)
    for t in tiles:  # each tile's pixels, image by image (csrc wg_tile_at)
        tw, th, img = t % p.tiles_w, (t // p.tiles_w) % p.tiles_h, t // (p.tiles_w * p.tiles_h)
        px[img, th * tf.WG_TH:(th + 1) * tf.WG_TH, tw * tf.WG_TW:(tw + 1) * tf.WG_TW] += 1
    assert (px == 1).all()
    smem = tf.WG_RING * tf.wg_slot_bytes(p.nb)
    assert p.xs <= 72 and smem <= 232448, (p, smem)
    return cnt


FLAGSHIP = [  # per stage (H = W): conv1, conv2, x2map, mlp, gb (ops/train_bwd.py:496-534)
    (hw, shapes) for hw, shapes in (
        (512, [((3,), 64), ((64,), 64), ((64,), 3), ((3,), 4), ((4,), 128)]),
        (256, [((64,), 128), ((128,), 128), ((128,), 3), ((3,), 8), ((8,), 256)]),
        (128, [((128,), 256), ((256,), 256), ((256,), 3), ((3,), 16), ((16,), 512)]),
        (128, [((256, 384), 256), ((256,), 256), ((256,), 3), ((3,), 16), ((16,), 512)]),
        (256, [((128, 256), 128), ((128,), 128), ((128,), 3), ((3,), 8), ((8,), 256)]),
        (512, [((64, 128), 64), ((64,), 64), ((64,), 3), ((3,), 4), ((4,), 128)]))]
PLAN_CASES = [(ch, co, 8, hw, hw) for hw, shapes in FLAGSHIP for ch, co in shapes] + [
    ((40,), 40, 2, 37, 21), ((24, 40), 16, 3, 9, 5), ((3,), 64, 1, 1, 33),
    ((20, 12), 24, 2, 7, 9), ((16,), 512, 1, 13, 47)]


def test_plan_covers_every_entry_once():
    assert len(PLAN_CASES) == 30 + 5
    for channels, cout, n, h, w in PLAN_CASES:
        cnt = _plan_coverage(channels, cout, n, h, w)
        assert (cnt == 1).all(), (channels, cout, n, h, w, np.unique(cnt))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(rng):
    before = (dict(tf.launches), dict(ttb.f32_launches), dict(tst.f32_launches))
    x, g, consts, prologue, cout = _inputs(rng, "conv2", (16,), 8, (2, 16, 16), True)
    got = ttb.fused_wgrad("conv2", x, g, consts, prologue)
    torch.testing.assert_close(got, ttb.fused_wgrad_reference("conv2", x, g, consts, prologue),
                               rtol=0, atol=0)
    tf.launch_wgrad(2, x, g, consts, prologue, cout)
    assert (tf.launches, ttb.f32_launches, tst.f32_launches) == before
    assert set(tf.launches) == {"wgrad_prep", "wgmma_conv"}
