"""The port's int8 eval path (plain versions, on the CPU) against the JAX
package's: the quantizers, the int8 fused stage against
``fused_eval_stage_int8`` in Pallas interpret mode, the deep stages' s8
block against ``xla_int8_block``, calibration, the narrow flagship end to
end, QTensor pooling, and the mode switch.

Inputs and weights come from numpy with a seed and cross between the
frameworks as numpy, in f32. Integer sums are exact on both sides and the
port repeats every rounding of the JAX package's quantizers, so quantized
operands are compared for equality; what differs is the f32 summation order
of the SPADE tail's convs (and, with several bands, the port's one scale
per row of y), so outputs are held to a relative L2 bar stated at each
test, a little above what was measured, and both sides to the JAX tests'
own bar against the f32 composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.infer import calibrate as jax_calibrate
from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jq8
from ssunet_gan_tpu.ops import wminor as jax_wminor
from ssunet_gan_tpu.ops.blocks import BasicBlock as JBasicBlock
from ssunet_gan_tpu.ops.blocks import VGGBlock as JVGGBlock
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.infer import api as port_api
from ssunet_gan_tpu_torch.infer import calibrate as port_calibrate
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import pool as port_pool
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from test_torch_stage import _jax_composition, _stage
from torch_port_helpers import jax_toggles, oihw, randomize_batch_stats, s8_conv_from_packed, vec

# the narrow flagship: every block has a shortcut conv, and the fused gates
# of the two packages split it alike at 32x32 (levels 0-2 fused, 3-5 deep)
FILTERS = (8, 16, 32, 40, 48, 64)
FUSED_PLANES = 32


@pytest.fixture(autouse=True)
def _modes():
    """JAX: fused stages on, int8 state cleared and restored; the port's
    int8 state cleared before and after."""
    def clear():
        q8.set_int8_stage(False)
        q8.set_int8_calibration(None)
        q8.set_record_sink(None)

    clear()
    with jax_toggles(fused_stage=True):
        yield
    clear()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def tracks_f32(got, want):
    """The JAX int8 tests' bar against the f32 composition
    (tests/test_int8_stage.py:76-82): relative RMS < 0.02, correlation >
    0.999."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean((got - want) ** 2)) / (np.abs(want).max() + 1e-6)
    cc = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert rms < 0.02 and cc > 0.999, (rms, cc)


def steps_apart(q_got, q_want):
    """Emitted s8: equal on >= 99.9% of the elements, never more than one
    step apart."""
    d = np.abs(np.asarray(q_got, np.int32) - np.asarray(q_want, np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())


# ---- (a) quantizers ---------------------------------------------------------


@pytest.mark.parametrize("abs_max", [None, 2.5, 0.7], ids=["dynamic", "static", "saturating"])
def test_quantize_tensor_matches_jax(rng, abs_max):
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    jq, js = jq8.quantize_tensor(jnp.asarray(x), abs_max)
    q, s = q8.quantize_tensor(torch.from_numpy(x), abs_max)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(float(s)) == np.float32(js)
    assert isinstance(s, torch.Tensor) == (abs_max is None)


@pytest.mark.parametrize("which", ["rows", "hwio"])
def test_weight_quantizers_match_jax(rng, which):
    w = rng.normal(size=(3, 3, 7, 12)).astype(np.float32)  # HWIO
    w[..., 4] = 0.0  # an all-zero output channel takes the 1e-12 floor
    if which == "rows":
        rows = np.ascontiguousarray(w.reshape(63, 12).T)
        jq, js = jq8._quant_rows(jnp.asarray(rows))
        q, s = q8.quant_rows(torch.from_numpy(rows))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    else:
        jq, js = jq8._quant_hwio(jnp.asarray(w))
        q, s = q8.quant_oihw(oihw(w))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[4] == np.float32(1e-12)


# ---- (b) the fused stage ----------------------------------------------------

# (planes, labels, part shapes, hidden, head classes, band rows, mode);
# batches keep the JAX lane-packing factor at 1
STAGE_CASES = {
    "one_part": (16, 3, [(2, 16, 16, 8)], 4.0, 0, None, "dynamic"),
    "two_parts": (16, 3, [(1, 16, 16, 8), (1, 16, 16, 16)], 4.0, 0, None, "dynamic"),
    "head": (16, 3, [(1, 16, 16, 8), (1, 16, 16, 16)], 4.0, 3, None, "dynamic"),
    "static": (16, 3, [(2, 16, 16, 8), (2, 16, 16, 16)], 4.0, 0, None, "static"),
    "qtensor_emit": (16, 3, [(2, 16, 16, 8), (2, 16, 16, 16)], 4.0, 0, None, "qtensor"),
    "four_bands": (16, 3, [(1, 32, 16, 8)], 4.0, 0, 8, "dynamic"),
    "two_bands_emit": (32, 2, [(2, 16, 8, 16)], 8.0, 0, 8, "emit"),
}
# Relative L2 of the port's stage output from the JAX kernel's. With one
# band the two compute the same function (measured <= 1.2e-7, the tail's
# f32 summation order; 0 where both emit s8); the bar leaves room for a
# one-step flip of a quantized value. With several bands the port computes
# each row of y once, with its owner band's scale, where the JAX kernel
# recomputes a band's halo rows with that band's scale (measured 1.7e-4
# over four bands).
STAGE_L2 = {1: 1e-4, 2: 1e-3, 4: 1e-3}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_int8_stage_matches_jax(rng, case):
    planes, label, shapes, nh, ncls, th, mode = STAGE_CASES[case]
    st = _stage(rng, planes, label, shapes, nh, ncls)
    amax = [float(np.abs(x).max()) for x in st["xs"]]
    out_amax = None
    calib_key = None
    tparts = [torch.from_numpy(x) for x in st["xs"]]
    jparts = list(st["jparts"])
    if mode == "static":
        calib_key = "stage"
        scales = {f"stage:{i}": a * 0.9 for i, a in enumerate(amax)}  # saturates a little
        jq8.set_int8_calibration(scales)
        q8.set_int8_calibration(scales)
    if mode == "qtensor":
        for i, x in enumerate(st["xs"]):
            s = max(amax[i] / 127.0, 1e-12)
            q = np.clip(np.round(x / np.float32(s)), -127, 127).astype(np.int8)
            tparts[i] = q8.QTensor(torch.from_numpy(q), s, torch.float32)
            jparts[i] = jq8.QTensor(jnp.asarray(q), s, jnp.float32)
    jax_stage_kernel.set_band_rows(th)
    jhead = None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))
    composition = _jax_composition(st)
    if mode in ("qtensor", "emit"):
        out_amax = float(np.abs(composition).max()) * 1.05

    want = jq8.fused_eval_stage_int8(tuple(jparts), st["jbp"], st["jsp"], final_head=jhead,
                                     calib_key=calib_key, out_abs_max=out_amax)
    before = q8.launches
    got, h1, y = q8.fused_eval_stage_int8(tuple(tparts), st["tbp"], st["tsp"], st["thead"],
                                          calib_key=calib_key, out_abs_max=out_amax, th=th,
                                          intermediates=True)
    assert q8.launches == before  # CPU tensors never launch
    n, h, w = shapes[0][:3]
    assert h1.shape == y.shape == (n, h, w, planes)
    if out_amax is not None:
        assert isinstance(got, q8.QTensor) and isinstance(want, jq8.QTensor)
        assert got.scale == want.scale and got.q.dtype == torch.int8
        steps_apart(got.q.numpy(), np.asarray(want.q))
        got, want = got.dequant().numpy(), np.asarray(want.dequant())
    else:
        got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (n, h, w, ncls or planes)
    assert rel_l2(got, want) <= STAGE_L2[h // (th or h)], rel_l2(got, want)
    tracks_f32(got, composition)
    tracks_f32(want, composition)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_stage_operands_match_jax(rng, mode):
    """The quantized operands of the stage are the JAX kernel's, integer for
    integer: inputs, conv1 / conv2 / shortcut weights, dequant vectors."""
    st = _stage(rng, 16, 3, [(2, 16, 16, 8), (2, 16, 16, 16)], 4.0, 0)
    static = [2.0, 3.0] if mode == "static" else [None, None]
    jq, js = zip(*(jq8.quantize_tensor(p, a) for p, a in zip(st["jparts"], static)))
    tq, ts = zip(*(q8.quantize_tensor(torch.from_numpy(x), a)
                   for x, a in zip(st["xs"], static)))
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    k1, (s1, t1), k2, (s2, t2), ks = st["jbp"]
    k1f = (k1 * s1).astype(jnp.float32)
    offs = [0, 8, 24]
    jw1, jd1 = jq8._quant_rows(jnp.concatenate(
        [(k1f[:, :, offs[i]:offs[i + 1], :] * js[i]).reshape(9 * (offs[i + 1] - offs[i]), 16).T
         for i in range(2)], axis=1))
    jw2, jd2 = jq8._quant_rows((k2 * s2).astype(jnp.float32).reshape(9 * 16, 16).T)
    jws, jds = jq8._quant_rows(jnp.concatenate(
        [(ks[0, 0, offs[i]:offs[i + 1], :] * js[i]).astype(jnp.float32).T for i in range(2)],
        axis=1))
    folded = q8.fold_block(st["tbp"])
    w1, d1, ws, ds = q8.fold_input_scales(folded, (8, 16), ts, torch.device("cpu"))
    np.testing.assert_array_equal(torch.cat(w1, 1).numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(folded["wq2"].numpy(), np.asarray(jw2))
    np.testing.assert_array_equal(torch.cat(ws, 1).numpy(), np.asarray(jws))
    for got, want in ((d1, jd1), (folded["d2"], jd2), (ds, jds)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_rows_follow_the_jax_candidates():
    assert q8.TH_CANDIDATES == jax_stage_kernel._TH_CANDIDATES_INT8
    assert [q8.band_rows(h) for h in (512, 256, 128, 96, 48, 24, 12)] == [64, 64, 64, 32, 16, 8, 12]
    st_parts = (jnp.zeros((1, 48, 16, 8), jnp.float32),)
    assert jax_stage_kernel.resolve_band_th(st_parts, 16, 3, 4, None, pack=True,
                                            int8=True) == q8.band_rows(48)


def test_int8_stage_refuses_what_it_does_not_take():
    x = torch.zeros((1, 8, 8, 4), device="meta")
    with pytest.raises(ValueError):
        q8.fused_eval_stage_int8((x,), None, None)
    st_x = torch.zeros((1, 12, 8, 4))
    with pytest.raises(ValueError, match="band height"):
        q8.int8_stage_reference((st_x,), (torch.zeros(8, 4, 3, 3), (torch.ones(8), torch.zeros(8)),
                                          torch.zeros(8, 8, 3, 3), (torch.ones(8), torch.zeros(8)),
                                          torch.zeros(8, 4, 1, 1)), None, th=8)


def test_kernel_gemm_layout_is_the_plain_convs(rng):
    """The CUDA path's packed s8 operands (``pack_s8_conv``), walked in the
    s8 conv core's K order (``s8_conv_from_packed``: per N block, chunk and
    k32 step, the (tap, 16-channel group) pairs against their core
    matrices), give the plain version's integer sums exactly: conv1 over a
    3-channel part and over two unequal parts (3 + 20), and launch B's
    shortcut over the parts with conv2's 3×3 as its second sum, also at 160
    output channels (two N blocks of 128)."""
    for shapes, planes in (([(1, 8, 8, 3)], 16), ([(1, 8, 8, 3), (1, 8, 8, 20)], 16),
                           ([(1, 8, 8, 40)], 160)):
        st = _stage(rng, planes, 3, shapes, 4.0, 0)
        chans = tuple(s[-1] for s in shapes)
        tq, ts = zip(*(q8.quantize_tensor(torch.from_numpy(x)) for x in st["xs"]))
        pk = q8.pack_stage_int8(st["tbp"], st["tsp"], None, torch.float32)
        ops = q8._scaled_operands(pk, chans, ts, torch.device("cpu"))
        w1, _, ws, _ = q8.fold_input_scales(pk, chans, ts, torch.device("cpu"))
        conv1, conv2 = ops["conv1"], ops["conv2"]
        assert conv1["segs"] == tuple((c, 3) for c in chans)
        assert conv2["segs"] == tuple((c, 1) for c in chans) + ((planes, 3),)
        assert conv2["nblk"] == -(-planes // 128) and conv2["nt"] == (64 if planes <= 64 else 128)
        want1 = q8.int_conv(tq, [q8._oihw3x3(r) for r in w1], 1)
        assert torch.equal(sum(s8_conv_from_packed(tq, conv1)), want1)
        qh = torch.from_numpy(rng.integers(-127, 128, (1, 8, 8, planes)).astype(np.int8))
        sums = s8_conv_from_packed(tq + (qh,), conv2)
        assert torch.equal(sum(sums[:-1]), q8.int_conv(tq, [r[:, :, None, None] for r in ws], 0))
        assert torch.equal(sums[-1], q8.int_conv((qh,), (q8._oihw3x3(pk["wq2"]),), 1))


# (part shapes, planes, band rows, calibrated): one band and several, a band
# of 8 rows, one band of H = 12 (no candidate divides it)
COMPOSE_CASES = {
    "one_part_dynamic": ([(2, 16, 16, 8)], 16, None, False),
    "two_parts_static": ([(1, 16, 16, 3), (1, 16, 16, 20)], 32, None, True),
    "four_bands": ([(1, 32, 16, 8)], 16, 8, False),
    "one_band_of_12": ([(2, 12, 8, 16)], 32, None, True),
}


@pytest.mark.parametrize("case", list(COMPOSE_CASES))
def test_per_launch_plain_versions_compose_to_the_stage(rng, case):
    """Launches A, Q and B in plain PyTorch (``s8_conv1_reference``,
    ``band_quant_reference``, ``s8_conv2_reference``, the card's per-launch
    yardsticks), fed the packed operands as the CUDA path builds them,
    compose to ``int8_stage_reference``'s h1 and y bit for bit."""
    shapes, planes, th, static = COMPOSE_CASES[case]
    st = _stage(rng, planes, 3, shapes, 4.0, 0)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    chans = tuple(s[-1] for s in shapes)
    calib_key = None
    if static:
        calib_key = "s"
        q8.set_int8_calibration({f"s:{i}": 0.9 * float(np.abs(x).max())
                                 for i, x in enumerate(st["xs"])})
    qparts, scales, dtype = q8._quantize_parts(parts, calib_key, q8.quantize_reference)
    pk = q8.pack_stage_int8(st["tbp"], st["tsp"], None, dtype)
    ops = q8._scaled_operands(pk, chans, scales, torch.device("cpu"))
    th = q8.band_rows(shapes[0][1]) if th is None else th
    h1, rowmax = q8.s8_conv1_reference(qparts, ops["conv1"], ops["d1"], pk["t1"], dtype)
    qh1, bandscale = q8.band_quant_reference(h1, rowmax, th)
    assert qh1.shape == (shapes[0][0], shapes[0][1] // th, th + 2) + tuple(h1.shape[2:])
    y = q8.s8_conv2_reference(qh1, bandscale, qparts, ops["conv2"], pk["d2"], ops["ds"],
                              pk["t2"], dtype)
    _, want_h1, want_y = q8.int8_stage_reference(parts, st["tbp"], st["tsp"], None, calib_key,
                                                 th=th, intermediates=True)
    assert torch.equal(rowmax, want_h1.float().amax((2, 3)))
    assert torch.equal(h1, want_h1) and torch.equal(y, want_y)


# ---- (c) the deep stages' s8 block -----------------------------------------

BLOCK_L2 = 1e-5  # f32 on both sides, exact integer sums (measured 0)


@pytest.mark.parametrize("kind,shapes,planes", [
    ("projection", [(2, 8, 8, 8)], 16),
    ("projection_two_parts_static", [(2, 8, 8, 8), (2, 8, 8, 16)], 16),
    ("identity", [(2, 8, 8, 16)], 16),
    ("vgg", [(2, 8, 8, 12)], 12),
])
def test_int8_block_matches_jax(rng, kind, shapes, planes):
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    xin = jparts if len(jparts) > 1 else jparts[0]
    cin = sum(s[-1] for s in shapes)
    if kind == "vgg":
        block = JVGGBlock(planes, planes, in_channels=cin)
    else:
        block = JBasicBlock(planes, in_planes=cin)
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(jax.random.PRNGKey(5), xin, True))())
    f32 = np.asarray(block.apply(bvars, xin, False))
    bp = block.apply(bvars, None, False)
    k1, (s1, t1), k2, (s2, t2), ks = bp
    tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)),
           None if ks is None else oihw(ks))
    calib_key = None
    if kind.endswith("static"):
        calib_key = "deep"
        scales = {f"deep:{i}": float(np.abs(x).max()) * 0.9 for i, x in enumerate(xs)}
        jq8.set_int8_calibration(scales)
        q8.set_int8_calibration(scales)
    want = np.asarray(jq8.xla_int8_block(jparts, bp, calib_key=calib_key,
                                         residual=kind != "vgg"))
    got = q8.int8_block(tuple(torch.from_numpy(x) for x in xs), tbp, calib_key=calib_key,
                        residual=kind != "vgg").numpy()
    assert got.shape == want.shape
    assert rel_l2(got, want) <= BLOCK_L2, rel_l2(got, want)
    rms = np.sqrt(np.mean((got - f32) ** 2)) / (np.abs(f32).max() + 1e-6)
    assert rms < 0.02, rms  # the JAX test's bar (tests/test_int8_stage.py:130-132)


def test_int8_block_takes_a_qtensor_identity(rng):
    """An identity block adds the dequantized input of a QTensor part."""
    x = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    s = float(np.abs(x).max()) / 127.0
    q = np.clip(np.round(x / np.float32(s)), -127, 127).astype(np.int8)
    block = JBasicBlock(16, in_planes=16)
    bvars = jax.jit(lambda: block.init(jax.random.PRNGKey(2), jnp.asarray(x), True))()
    bp = block.apply(bvars, None, False)
    k1, (s1, t1), k2, (s2, t2), ks = bp
    assert ks is None
    tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), None)
    want = np.asarray(jq8.xla_int8_block((jq8.QTensor(jnp.asarray(q), s, jnp.float32),), bp))
    got = q8.int8_block((q8.QTensor(torch.from_numpy(q), s, torch.float32),), tbp).numpy()
    assert rel_l2(got, want) <= BLOCK_L2


# ---- (d), (e) calibration and the narrow flagship ---------------------------


@pytest.fixture(scope="module")
def narrow():
    """The narrow JAX flagship (random BN statistics), the port loaded from
    its variables, and tiles."""
    with jax_toggles(fused_stage=False):
        model = jax_ssunet.UNetRSSv2(num_classes=3, filters=FILTERS)
        x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = randomize_batch_stats(
            jax.device_get(jit_init(model, jax.random.PRNGKey(0), x0, train=False)))
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    tiles = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    return model, variables, port, tiles


@pytest.fixture
def fused_like_jax(monkeypatch):
    """The port's fused gate set to split the narrow flagship as the JAX
    gate does at 32x32."""
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: FUSED_PLANES)


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_recorded_ranges_match_jax(narrow, fused_like_jax, tmp_path):
    model, variables, port, tiles = narrow
    want = jax_calibrate.record_activation_ranges(model, variables, tiles, batch_size=2)
    got = port_calibrate.record_activation_ranges(port, tiles, batch_size=2, device="cpu")
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(":half") for k in got) == 2
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
    # a scales file written by one package loads in the other
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    port_calibrate.save_calibration(str(a), got)
    jax_calibrate.save_calibration(str(b), want)
    assert jax_calibrate.load_calibration(str(a)) == got
    assert port_calibrate.load_calibration(str(b)) == want
    assert port_calibrate.load_calibration(str(tmp_path)) is None


def test_calibrate_and_model_card(narrow, fused_like_jax, tmp_path):
    """calibrate_int8 installs and writes the scales; a model card's "int8"
    key switches the mode and installs the file's scales."""
    _, _, port, tiles = narrow
    scales = port_calibrate.calibrate_int8(port, tiles, model_dir=str(tmp_path), batch_size=4,
                                           device="cpu")
    assert q8.int8_calibration() == scales and not q8.int8_stage_enabled()
    q8.set_int8_calibration(None)
    assert port_api.configure_int8({"arch": "UNet_R_SS_v2"}, str(tmp_path)) is False
    assert q8.int8_calibration() is None
    assert port_api.configure_int8({"int8": True}, str(tmp_path)) is True
    assert q8.int8_calibration() == scales
    assert port_api.configure_int8({"int8": False}, str(tmp_path)) is False
    with pytest.raises(ValueError, match="at least one tile"):
        port_calibrate.record_activation_ranges(port, tiles[:0], device="cpu")


# Relative L2 of the port's int8 logits from the JAX package's over eleven
# quantized stages, each level one band (measured 1.9e-7 dynamic, 1.8e-7
# calibrated); the bar leaves room for a one-step flip of a quantized value
# (int8 itself is ~3e-2 from f32).
FLAGSHIP_L2 = 1e-3


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
def test_narrow_flagship_matches_jax(narrow, fused_like_jax, monkeypatch, calibrated):
    model, variables, port, tiles = narrow
    x = tiles[:2]
    with torch.no_grad():
        f32 = port(torch.from_numpy(x)).numpy()
    if calibrated:
        scales = jax_calibrate.record_activation_ranges(model, variables, tiles, batch_size=4)
        jq8.set_int8_calibration(scales)
        q8.set_int8_calibration(scales)
    jq8.set_int8_stage(True)
    q8.set_int8_stage(True)
    jcounts, counts = {}, {}
    _count(monkeypatch, jax_ssunet, "fused_eval_stage_int8", jcounts)
    _count(monkeypatch, jax_ssunet, "xla_int8_block", jcounts)
    _count(monkeypatch, ssunet, "fused_eval_stage_int8", counts)
    _count(monkeypatch, ssunet, "int8_block", counts)
    want = np.asarray(model.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert jcounts == {"fused_eval_stage_int8": 6, "xla_int8_block": 5}
    assert counts == {"fused_eval_stage_int8": 6, "int8_block": 5}
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert rel_l2(got, want) <= FLAGSHIP_L2, rel_l2(got, want)
    # int8 tracks f32 (the JAX flagship test's bars, tests/test_int8_stage.py:101-107)
    for out in (got, want):
        assert np.mean((out > 0) == (f32 > 0)) > 0.98
        assert np.corrcoef(out.ravel(), f32.ravel())[0, 1] > 0.99


def test_calibrated_forward_barely_depends_on_the_batch(narrow, fused_like_jax):
    """Static scales take the batch out of every stage input's scale; only
    the deep block's dynamic h1 scale still spans the batch tensor, as in
    the JAX package."""
    _, _, port, tiles = narrow
    port_calibrate.calibrate_int8(port, tiles, batch_size=4, device="cpu")
    q8.set_int8_stage(True)
    with torch.no_grad():
        both = port(torch.from_numpy(tiles[:2]))
        one = port(torch.from_numpy(tiles[:1]))
    # measured 5.2e-3
    assert rel_l2(one.numpy(), both[:1].numpy()) < 2e-2


# ---- (f) QTensor pooling ----------------------------------------------------


def test_qtensor_pool_matches_jax(rng):
    q = rng.integers(-5, 6, (2, 8, 6, 4)).astype(np.int8)  # many ties
    jq = jq8.QTensor(jnp.asarray(q), 0.25, jnp.float32)
    tq = q8.QTensor(torch.from_numpy(q), 0.25, torch.float32)
    jp, jcode = jax_wminor.pool2x2_with_indices(jq, lazy=False)
    p, code = port_pool.max_pool_2x2_with_indices(tq)
    assert isinstance(p, q8.QTensor) and p.scale == 0.25 and p.dtype == torch.float32
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(jp.q))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    p2 = port_pool.max_pool_2x2(tq)
    np.testing.assert_array_equal(p2.q.numpy(), np.asarray(jax_wminor.pool2x2(jq, lazy=False).q))
    # pooling commutes with dequantization
    np.testing.assert_array_equal(p2.dequant().numpy(),
                                  port_pool.max_pool_2x2(tq.dequant()).numpy())


# ---- (g) the mode switch ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mode_off_leaves_the_forward_bit_identical(narrow, fused_like_jax, monkeypatch, dtype):
    _, _, port, tiles = narrow
    x = torch.from_numpy(tiles[:1]).to(dtype)
    with torch.no_grad():
        before = port(x)
        scales = port_calibrate.calibrate_int8(port, tiles, batch_size=4, device="cpu")
        q8.set_int8_stage(True)
        on = port(x)
        q8.set_int8_stage(False)
        counts = {}
        _count(monkeypatch, ssunet, "fused_eval_stage_int8", counts)
        _count(monkeypatch, ssunet, "int8_block", counts)
        after = port(x)  # scales still installed, mode off
    assert scales and counts == {}
    assert after.dtype == dtype and torch.equal(after, before)
    assert not torch.equal(on, before)
