"""The int8 stage's seams read in s8 (the on-read functions of the JAX
package's TPU kernel 7, ``ops/stage_kernel_int8.py`` ``_upsample_on_read_s8``
and ``_pool_on_read_s8``), on the CPU against the JAX package: the two s8
reads bit for bit, the int8 stage's plain version reading an up or a pool
seam against ``fused_eval_stage_int8`` on ``UpTensor`` / ``DownTensor`` /
``DownQTensor`` parts in Pallas interpret mode (its band height pinned),
the per-launch plain versions composing with seams, the one gate's int8
seam terms, and the narrow SSUNet's int8 forwards reading their seams where
the JAX package's do, with both packages' lazy seams on (the narrow
flagship's and UNet_R_SS's: tests/test_torch_int8_seams_flagship.py and
tests/test_torch_int8_seams_rss.py; shared code:
tests/torch_int8_seams_helpers.py).

Inputs come from numpy with a seed and cross between the frameworks as
numpy (the JAX side in its (N, H, C, W) layout). Tolerances: the s8 reads
and every quantized operand bit for bit (integer sums, the same f32 steps);
a stage in f32 to ``STAGE_L2`` (the f32 summation order of the SPADE
tail's convs, as tests/test_torch_int8.py); a forward in bf16 to
``FLAGSHIP_L2`` with dynamic scales and to ``BF16_CALIBRATED_L2`` with
calibrated ones (tests/torch_int8_seams_helpers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import acts as jax_acts
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jq8
from ssunet_gan_tpu_torch.models import ssunet
from ssunet_gan_tpu_torch.ops import pool, resize, stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
from ssunet_gan_tpu_torch.ops.spade import SPADE
from test_torch_stage import _jax_composition, _stage
from torch_int8_seams_helpers import (  # noqa: F401 (_modes: the autouse fixture)
    _modes,
    _s8,
    check_narrow_int8_forward,
    rel_l2,
)
from torch_port_helpers import wminor


# ---- the two s8 reads ----------------------------------------------------------

# (half height, band rows): one band and several, the smallest band the
# JAX kernel takes with an up seam (16), and half heights whose weights are
# not dyadic (the rounding of the lerp then matters)
UP_CASES = [(8, 16), (16, 16), (32, 16), (24, 16), (64, 64), (96, 64)]


@pytest.mark.parametrize("hh,th", UP_CASES)
def test_upsample_on_read_s8_matches_jax(rng, hh, th):
    """``upsample_on_read_s8_reference`` against the JAX kernel's
    ``_upsample_on_read_s8`` band by band (jitted, as interpret mode runs
    it), every full-resolution row of every band window bit for bit: the
    first and last rows of the image, the rows at band edges, the halo rows
    outside the image zero on the JAX side."""
    n, w, c = 2, 16, 8
    q = _s8(rng, (n, hh, w, c))
    got = q8.upsample_on_read_s8_reference(torch.from_numpy(q))
    assert got.dtype == torch.int8 and got.shape == (n, 2 * hh, w, c)
    got = got.numpy()
    h, thh = 2 * hh, th // 2
    # the half rows around each band, W-minor; rows outside the image hold
    # noise, which the JAX kernel must zero
    pad = _s8(rng, (n, hh + 20, c, w))
    pad[:, 10:10 + hh] = np.swapaxes(q, 2, 3)
    read = jax.jit(jq8._upsample_on_read_s8, static_argnums=(4, 5))
    for img in range(n):
        for i in range(h // th):
            b0 = 10 + i * thh
            out = np.asarray(read(jnp.asarray(pad[img, b0 - 5:b0]),
                                  jnp.asarray(pad[img, b0:b0 + thh]),
                                  jnp.asarray(pad[img, b0 + thh:b0 + thh + 8]),
                                  jnp.int32(i), th, h))
            rows = np.arange(i * th - 5, i * th + th + 5)
            inside = (rows >= 0) & (rows < h)
            np.testing.assert_array_equal(np.swapaxes(out[inside], 1, 2), got[img, rows[inside]])
            assert not out[~inside].any()


@pytest.mark.parametrize("h,th", [(8, 8), (16, 8), (32, 16)])
def test_pool_on_read_s8_matches_jax(rng, h, th):
    """``pool_on_read_s8_reference`` against the JAX kernel's
    ``_pool_on_read_s8`` band by band, bit for bit (values from a small
    range, so windows tie often)."""
    n, w, c = 2, 8, 8
    q = rng.integers(-4, 5, (n, 2 * h, 2 * w, c)).astype(np.int8)
    got = q8.pool_on_read_s8_reference(torch.from_numpy(q))
    assert got.dtype == torch.int8 and got.shape == (n, h, w, c)
    got = got.numpy()
    pad = _s8(rng, (n, 2 * h + 40, c, 2 * w))
    pad[:, 20:20 + 2 * h] = np.swapaxes(q, 2, 3)
    sel = np.zeros((2 * w, w), np.float32)
    sel[np.arange(0, 2 * w, 2), np.arange(w)] = 1.0
    sel = jnp.asarray(sel, jnp.bfloat16)
    read = jax.jit(jq8._pool_on_read_s8, static_argnums=(5, 6))
    for img in range(n):
        for i in range(h // th):
            b0 = 20 + 2 * i * th
            out = np.asarray(read(jnp.asarray(pad[img, b0 - 10:b0]),
                                  jnp.asarray(pad[img, b0:b0 + 2 * th]),
                                  jnp.asarray(pad[img, b0 + 2 * th:b0 + 2 * th + 16]), sel,
                                  jnp.int32(i), th, h))
            rows = np.arange(i * th - 5, i * th + th + 5)
            inside = (rows >= 0) & (rows < h)
            np.testing.assert_array_equal(np.swapaxes(out[inside], 1, 2), got[img, rows[inside]])
            assert not out[~inside].any()


# ---- the int8 stage reading a seam ------------------------------------------------

# Relative L2 of the port's stage output from the JAX kernel's, f32 (as
# tests/test_torch_int8.py STAGE_L2): with one band the two compute the same
# function, the tail's f32 summation order aside (measured <= 1.2e-7); with
# two the port computes each row of y once, with its owner band's scale.
STAGE_L2 = {1: 1e-4, 2: 1e-3}

# (kind, part form, scales, band rows): an up part (a decoder stage of two
# parts at 32x16) and a pool part (an encoder stage at 16x8 from 32x16),
# bf16-valued f32 tensors or a QTensor, dynamic or static scales, one band
# or two (the ":half" fallback: test_quantized_seam_parts_match_jax)
SEAM_STAGE_CASES = {
    "up-dynamic": ("up", "tensor", "dynamic", 32),
    "up-static": ("up", "tensor", "static", 32),
    "up-two-bands": ("up", "tensor", "dynamic", 16),
    "pool-dynamic": ("pool", "tensor", "dynamic", 16),
    "pool-qtensor": ("pool", "qtensor", "static", 8),
}


@pytest.mark.parametrize("case", list(SEAM_STAGE_CASES))
def test_int8_stage_reads_its_seam_as_jax(rng, case):
    """``fused_eval_stage_int8`` (CPU: the plain version) with ``up`` or
    ``down`` against the JAX ``fused_eval_stage_int8`` on ``UpTensor`` /
    ``DownTensor`` / ``DownQTensor`` parts in interpret mode, with the band
    height pinned (``set_band_rows``); the port's quantized up part is the
    half tensor at its ``":half"`` range; both also against the f32
    composition on the materialized parts by the JAX int8 tests' bar."""
    kind, form, scales, th = SEAM_STAGE_CASES[case]
    planes = 16
    if kind == "up":
        shapes = [(1, 32, 16, 8), (1, 32, 16, 16)]
        skip = rng.normal(size=shapes[0]).astype(np.float32)
        half = resize.upsample_w(torch.from_numpy(
            rng.normal(size=(1, 16, 8, 16)).astype(np.float32)).to(torch.bfloat16)).float()
        tparts = (torch.from_numpy(skip), half)
        jparts = (jnp.asarray(skip), jax_acts.UpTensor(wminor(half.numpy())))
        up, down = (False, True), None
        full = (tparts[0], resize.materialize_up(half))
    else:
        shapes = [(2, 16, 8, 8)]
        src = rng.normal(size=(2, 32, 16, 8)).astype(np.float32)
        tparts = (torch.from_numpy(src),)
        jparts = (jax_acts.DownTensor(wminor(src)),)
        up, down = None, (True,)
        full = (pool.max_pool_2x2(tparts[0]),)
    st = _stage(rng, planes, 3, shapes, 4.0, 0)
    st["xs"] = [p.numpy() for p in full]
    st["jparts"] = tuple(jnp.asarray(x) for x in st["xs"])
    calib_key = None
    if scales != "dynamic":
        calib_key = "stage"
        cal = {f"stage:{i}": 0.9 * float(p.abs().max()) for i, p in enumerate(full)}
        if kind == "up" and scales == "static":
            cal["stage:1:half"] = 0.95 * float(tparts[1].abs().max())
        jq8.set_int8_calibration(cal)
        q8.set_int8_calibration(cal)
    if form == "qtensor":
        s = cal["stage:0"] / 127.0
        q = np.clip(np.round(src / np.float32(s)), -127, 127).astype(np.int8)
        tparts = (q8.QTensor(torch.from_numpy(q), s, torch.float32),)
        jparts = (jax_acts.DownQTensor(wminor(q), s, jnp.float32),)
    jax_stage_kernel.set_band_rows(th)  # restored by jax_toggles
    want = np.asarray(jq8.fused_eval_stage_int8(jparts, st["jbp"], st["jsp"], calib_key=calib_key))
    before = (q8.launches, q8.up_reads, q8.pool_reads)
    got = q8.fused_eval_stage_int8(tparts, st["tbp"], st["tsp"], calib_key=calib_key, th=th,
                                   up=up, down=down)
    assert (q8.launches, q8.up_reads, q8.pool_reads) == before  # CPU tensors never launch
    got = got.numpy()
    n, h, w = shapes[0][:3]
    assert got.shape == want.shape == (n, h, w, planes)
    assert rel_l2(got, want) <= STAGE_L2[h // th], rel_l2(got, want)
    composition = _jax_composition(st)
    for out in (got, want):
        rms = np.sqrt(np.mean((out - composition) ** 2)) / (np.abs(composition).max() + 1e-6)
        cc = np.corrcoef(out.ravel(), composition.ravel())[0, 1]
        assert rms < 0.02 and cc > 0.999, (rms, cc)


@pytest.mark.parametrize("kind", ["up", "pool"])
def test_quantized_seam_parts_match_jax(rng, kind):
    """The quantized seam part is the JAX kernel's operand, integer for
    integer, scale for scale: an up part's half tensor at its ``":half"``
    range, falling back to the stage key, else dynamically over the half
    tensor; a pool part's full-resolution tensor as it is."""
    x = rng.normal(size=(1, 8, 16, 4)).astype(np.float32)
    flags = (True,) if kind == "up" else None
    for cal in (None, {"k:0": 2.0}, {"k:0": 2.0, "k:0:half": 1.5}):
        q8.set_int8_calibration(cal)
        jq8.set_int8_calibration(cal)
        key = None if cal is None else "k"
        (tq,), (ts,), _ = q8._quantize_parts((torch.from_numpy(x),), key, up=flags)
        amax = None if cal is None else cal.get("k:0:half" if kind == "up" else "k:0", cal["k:0"])
        jq, js = jq8.quantize_tensor(jnp.asarray(x), amax)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(float(ts)) == np.float32(js)


# (parts' logical shapes, planes, seam kind, band rows, calibrated)
COMPOSE_CASES = {
    "up": ([(2, 32, 16, 8), (2, 32, 16, 16)], 32, "up", 16, False),
    "up-static": ([(1, 16, 8, 16), (1, 16, 8, 16)], 16, "up", 16, True),
    "pool": ([(2, 16, 16, 8)], 16, "pool", 8, False),
}


@pytest.mark.parametrize("case", list(COMPOSE_CASES))
def test_per_launch_plain_versions_compose_with_seams(rng, case):
    """Launches A, Q and B in plain PyTorch with the seam flags
    (``s8_conv1_reference``, ``band_quant_reference``,
    ``s8_conv2_reference``, the card's per-launch yardsticks), fed the
    packed operands as the CUDA path builds them from the raw s8 parts,
    compose to ``int8_stage_reference``'s h1 and y bit for bit; and the
    seam reads are the plain reads of :func:`read_seams_s8`."""
    shapes, planes, kind, th, static = COMPOSE_CASES[case]
    st = _stage(rng, planes, 3, shapes, 4.0, 0)
    if kind == "up":
        half = resize.upsample_w(torch.from_numpy(rng.normal(
            size=(shapes[1][0], shapes[1][1] // 2, shapes[1][2] // 2, shapes[1][3])
        ).astype(np.float32)).to(torch.bfloat16)).float()
        parts = (torch.from_numpy(st["xs"][0]), half)
        up, down = (False, True), None
    else:
        n, h, w, c = shapes[0]
        parts = (torch.from_numpy(rng.normal(size=(n, 2 * h, 2 * w, c)).astype(np.float32)),)
        up, down = None, (True,)
    chans = tuple(s[-1] for s in shapes)
    calib_key = None
    if static:
        calib_key = "s"
        q8.set_int8_calibration({"s:0": 2.5, "s:1": 2.0, "s:1:half": 2.2})
    qparts, scales, dtype = q8._quantize_parts(parts, calib_key, q8.quantize_reference, up)
    pk = q8.pack_stage_int8(st["tbp"], st["tsp"], None, dtype)
    ops = q8._scaled_operands(pk, chans, scales, torch.device("cpu"))
    h1, rowmax = q8.s8_conv1_reference(qparts, ops["conv1"], ops["d1"], pk["t1"], dtype,
                                       up=up, down=down)
    assert h1.shape[:3] == shapes[0][:3]
    qh1, bandscale = q8.band_quant_reference(h1, rowmax, th)
    y = q8.s8_conv2_reference(qh1, bandscale, qparts, ops["conv2"], pk["d2"], ops["ds"],
                              pk["t2"], dtype, up=up, down=down)
    _, want_h1, want_y = q8.int8_stage_reference(parts, st["tbp"], st["tsp"], None, calib_key,
                                                 th=th, intermediates=True, up=up, down=down)
    assert torch.equal(h1, want_h1) and torch.equal(y, want_y)
    read = q8.read_seams_s8(qparts, up, down)
    i = 1 if kind == "up" else 0
    want_read = (q8.upsample_on_read_s8_reference(qparts[i]) if kind == "up"
                 else pool.max_pool_2x2(qparts[i]))
    assert torch.equal(read[i], want_read)


# ---- the gate and the dispatch ----------------------------------------------------


def test_int8_gate_takes_the_seams_jax_reads():
    """``stage_supported(..., int8=True)`` with seams: an up part (bf16, an
    exact half height) where the stage's band height is a multiple of 16,
    a pool part of even height and width, bf16 or a QTensor of any
    activation dtype; training takes none, and the bf16 eval stage no
    QTensor seam. ``lazy_pool_ok`` takes a QTensor."""
    bf = torch.bfloat16
    ok = stage_kernel.stage_supported
    skip, half = torch.zeros((1, 32, 8, 8), dtype=bf), torch.zeros((1, 16, 8, 16), dtype=bf)
    up = (False, True)
    assert ok((skip, half), 16, 3, 4, up=up, int8=True)
    assert not ok((skip, half), 16, 3, 4, up=up, int8=True, train=True)
    assert not ok((skip.float(), half.float()), 16, 3, 4, up=up, int8=True)
    q8.set_band_rows(8)  # bands of 8 rows: the JAX kernel resolves no height
    try:
        assert not ok((skip, half), 16, 3, 4, up=up, int8=True)
        assert ok((skip, half), 16, 3, 4, up=up)  # the bf16 stage has no bands
        assert ok((skip, resize.materialize_up(half)), 16, 3, 4, int8=True)
    finally:
        q8.set_band_rows(None)
    full = torch.zeros((1, 32, 16, 8))
    qt = q8.QTensor(torch.zeros((1, 32, 16, 8), dtype=torch.int8), 0.1, torch.float32)
    assert ok((full.to(bf),), 16, 3, 4, down=(True,), int8=True)
    assert ok((qt,), 16, 3, 4, down=(True,), int8=True)
    assert not ok((qt,), 16, 3, 4, down=(True,))                 # bf16 eval: no QTensor
    assert not ok((full,), 16, 3, 4, down=(True,), int8=True)    # f32 tensor
    odd = q8.QTensor(torch.zeros((1, 32, 15, 8), dtype=torch.int8), 0.1, torch.float32)
    assert not ok((odd,), 16, 3, 4, down=(True,), int8=True)
    assert pool.lazy_pool_ok(qt) and not pool.lazy_pool_ok(odd)
    pool.set_lazy_pool(False)
    try:
        assert not pool.lazy_pool_ok(qt)
    finally:
        pool.set_lazy_pool(None)


def test_int8_up_seam_refused_runs_the_deep_block(monkeypatch):
    """An int8 stage whose gate refuses its up seam (here: bands of 8 rows)
    runs the deep s8 block on the materialized parts, as the JAX package's
    dispatch does when its band resolution finds no height; a fused
    stage's output is marked, a deep one's is not, and only a marked part's
    seam is read."""
    gen = torch.Generator().manual_seed(4)
    bf = torch.bfloat16
    block = BasicBlock(24, 16, generator=gen).eval()
    spade = SPADE("spadebatch3x3", 16, 3, 1.0, generator=gen)
    skip = torch.randn((1, 32, 16, 8), generator=gen).to(bf)
    low = torch.randn((1, 16, 8, 16), generator=gen).to(bf)
    seen = []
    for name in ("fused_eval_stage_int8", "int8_block"):
        def spy(parts, *a, fn=getattr(ssunet, name), name=name, **kw):
            seen.append((name, kw.get("up"), tuple(tuple(p.shape) for p in parts)))
            return fn(parts, *a, **kw)

        monkeypatch.setattr(ssunet, name, spy)
    q8.set_int8_stage(True)
    with torch.no_grad():
        unmarked = ssunet.spade_stage((skip, low), block, spade, name="conv1_1", up=(False, True))
        low.fused = True  # as a fused producer's output
        read = ssunet.spade_stage((skip, low), block, spade, name="conv1_1", up=(False, True))
        q8.set_band_rows(8)
        try:
            deep = ssunet.spade_stage((skip, low), block, spade, name="conv1_1", up=(False, True))
        finally:
            q8.set_band_rows(None)
    full = ((1, 32, 16, 8), (1, 32, 16, 16))
    assert seen == [("fused_eval_stage_int8", None, full),
                    ("fused_eval_stage_int8", (False, True), ((1, 32, 16, 8), (1, 16, 16, 16))),
                    ("int8_block", None, full)]
    assert getattr(unmarked, "fused", False) and getattr(read, "fused", False)
    assert not getattr(deep, "fused", False)


# ---- the narrow SSUNet ----------------------------------------------------------


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("arch", ["SSUNet"])
def test_narrow_int8_forward_reads_its_seams_as_jax(monkeypatch, arch, calibrated):
    """The bf16 int8 forward of a narrow flagship, UNet_R_SS and SSUNet with
    both packages' lazy seams on: the stages, s8 seams and deep blocks per
    forward equal the JAX package's (a deep producer's up seam
    materialized, a fused one's read; each encoder's pool read), and the
    logits are JAX's to ``FLAGSHIP_L2`` (dynamic) or ``BF16_CALIBRATED_L2``
    (calibrated)."""
    check_narrow_int8_forward(monkeypatch, arch, calibrated)
