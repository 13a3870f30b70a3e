"""The f32 train kernels (``ops/train_f32.py``, ``csrc/train_f32.cu``:
kernels 2-6 in float32, 3xTF32 on the tensor cores) on the CPU, where no
kernel runs: their arithmetic in plain PyTorch (the ``*_emulated``
functions: the plain versions with each product split into TF32 big and
small parts, small·big + big·small + big·big summed in f32) against the
plain versions in f32, mode by mode; one stage's forward and v3 backward on
the emulated route against the JAX package's ``fused_train_stage`` under v3
(Pallas interpret mode), which takes the activation dtype; weights changed
in place between two calls; and the wrappers' f32 dispatch on the CPU.

Inputs from numpy with a seed, f32, at H 16, W 8 and ≤ 32 channels.
Between the port's functions (the same products summed in another order;
3xTF32 products within ~2^-21): outputs in relative L2 and max error over
max |plain| ≤ 1e-5, stat rows within 1e-5 of each row's largest |sum|,
weight gradients in relative L2 ≤ 1e-5. Against JAX: ``stage_matches_jax``'s
bars (forward and batch stats rtol = atol = 2e-4, gradients max |Δ| ≤
1e-3 · max |JAX|).
"""

import numpy as np
import pytest
import torch

from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from ssunet_gan_tpu_torch.ops import train_bwd as ttb
from ssunet_gan_tpu_torch.ops import train_f32
from torch_port_helpers import STAGES, jax_toggles, normal, stage_matches_jax, tensor

N, H, W = 2, 16, 8
TOL = 1e-5


def _t(rng, *shape, scale=1.0):
    return tensor(normal(rng, shape, scale))


def _pos(rng, n):
    return tensor((rng.random(n) + 0.5).astype(np.float32))


def _close(got, want):
    got, want = got.double(), want.double()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    l2 = ((got - want).norm() / want.norm()).item()
    assert got.shape == want.shape and err <= TOL * scale and l2 <= TOL, (err, scale, l2)


def _sums_close(got, want):
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), (g, w)


def _outputs_close(got, want):
    (out, sums), (w_out, w_sums) = got, want
    outs = out if isinstance(out, tuple) else (out,)
    w_outs = w_out if isinstance(w_out, tuple) else (w_out,)
    assert len(outs) == len(w_outs)
    for o, w in zip(outs, w_outs):
        _close(o, w)
    assert (sums is None) == (w_sums is None)
    if sums is not None:
        _sums_close(sums, w_sums)


def _conv_case(rng, case):
    """(function name, args, kwargs) of one conv call per mode, at the
    widths the stage gives it: C 32 planes, 4 hidden, 3 labels."""
    c, nh, lab = 32, 4, 3
    x = _t(rng, N, H, W, 16)
    g0, y, act = _t(rng, N, H, W, c), torch.relu(_t(rng, N, H, W, c)), torch.relu(
        _t(rng, N, H, W, nh))
    f1, f2 = _t(rng, N, H, W, c), _t(rng, N, H, W, c)
    bn4 = (_pos(rng, c), _t(rng, c, scale=0.1), _pos(rng, c), _t(rng, c, scale=0.1))
    if case == "conv_stats one part":
        return "conv_stats", ((x,), _t(rng, c, 16, 3, 3, scale=0.2)), {}
    if case == "conv_stats two parts":
        return "conv_stats", ((x, _t(rng, N, H, W, 8)), _t(rng, c, 24, 3, 3, scale=0.2)), {}
    if case == "conv_stats prologue":
        return "conv_stats", ((f1,), _t(rng, c, c, 3, 3, scale=0.2)), {
            "prologue": (_pos(rng, c), _t(rng, c, scale=0.3))}
    if case == "conv_stats bias":
        return "conv_stats", ((act,), _t(rng, 2 * c, nh, 3, 3, scale=0.3)), {
            "bias": _t(rng, 2 * c), "stats": False}
    wT = lambda o, i, s: ttb._convT(_t(rng, i, o, 3, 3, scale=s))  # (o, i, 3, 3)
    if case == "gamma":
        return "fused_conv3", ("gamma", (act,), _t(rng, c, nh, 3, 3, scale=0.3)), {
            "bias": _t(rng, c)}
    if case == "modgrad":
        return "fused_conv3", ("modgrad", (g0, y), wT(nh, 2 * c, 0.2)), {"side": (act,)}
    if case == "seg":
        return "fused_conv3", ("seg", (_t(rng, N, H, W, nh),), wT(lab, nh, 0.3)), {}
    if case == "pre":
        return "fused_conv3", ("pre", (_t(rng, N, H, W, lab),), wT(c, lab, 0.3)), {
            "side": (g0, _t(rng, N, H, W, c, scale=0.3), y, f2),
            "consts": (_pos(rng, c), _t(rng, c))}
    if case == "bn2":
        return "fused_conv3", ("bn2", (g0, f2), wT(c, c, 0.2)), {
            "side": (f1,), "consts": bn4 + (_pos(rng, c), _t(rng, c, scale=0.3), _pos(rng, c),
                                            _t(rng, c))}
    parts = (16,) if case == "bn1 one part" else (16, 8)
    cin = sum(parts)
    return "fused_conv3", ("bn1", (g0, f1), wT(cin, c, 0.2)), {
        "side": (y,), "consts": bn4, "shortcut": _t(rng, cin, c, 1, 1, scale=0.2),
        "out_ch": list(parts)}


CONV_CASES = ["conv_stats one part", "conv_stats two parts", "conv_stats prologue",
              "conv_stats bias", "gamma", "modgrad", "seg", "pre", "bn2", "bn1 one part",
              "bn1 two parts"]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_mode_3xtf32_matches_plain(rng, case):
    """Kernels 2 (conv_stats: one or two parts, the prologue, the γ|β
    recompute's bias) and 5 (each chain mode of fused_conv3): the 3xTF32
    products against the plain version's exact f32 ones."""
    name, args, kw = _conv_case(rng, case)
    module = tst if name == "conv_stats" else ttb
    got = getattr(train_f32, name + "_emulated")(*args, **kw)
    _outputs_close(got, getattr(module, name + "_reference")(*args, **kw))


def _wgrad_case(rng, case):
    c, nh, lab = 32, 4, 3
    g0, f = _t(rng, N, H, W, c), _t(rng, N, H, W, c)
    bn4 = (_pos(rng, c), _t(rng, c, scale=0.1), _pos(rng, c), _t(rng, c, scale=0.1))
    if case == "wgrad one part":
        return "wgrad", ((_t(rng, N, H, W, 16),), g0), {}
    if case == "wgrad two parts":
        return "wgrad", ((_t(rng, N, H, W, 16), _t(rng, N, H, W, 8)), g0), {}
    if case == "wgrad prologue":
        return "wgrad", ((f,), g0), {"prologue": (_pos(rng, c), _t(rng, c, scale=0.3))}
    if case == "gb":
        return "fused_wgrad", ("gb", (torch.relu(_t(rng, N, H, W, nh)),),
                               (g0, torch.relu(_t(rng, N, H, W, c)))), {}
    if case == "mlp":
        return "fused_wgrad", ("mlp", (_t(rng, N, H, W, lab),), (_t(rng, N, H, W, nh),)), {}
    if case == "x2map":
        return "fused_wgrad", ("x2map", (_t(rng, N, H, W, c),), (_t(rng, N, H, W, lab),)), {}
    if case == "conv2":
        return "fused_wgrad", ("conv2", (f,), (g0, _t(rng, N, H, W, c))), {
            "consts": bn4, "prologue": (_pos(rng, c), _t(rng, c, scale=0.3))}
    return "fused_wgrad", ("conv1", (_t(rng, N, H, W, 16), _t(rng, N, H, W, 8)),
                           (g0, f)), {"consts": bn4}


WGRAD_CASES = ["wgrad one part", "wgrad two parts", "wgrad prologue", "gb", "mlp", "x2map",
               "conv2", "conv1"]


@pytest.mark.parametrize("case", WGRAD_CASES)
def test_wgrad_mode_3xtf32_matches_plain(rng, case):
    """Kernels 4 (wgrad: one or two parts, conv2's prologue) and 6 (each
    fused_wgrad mode): the 3xTF32 weight gradient against the plain one."""
    name, args, kw = _wgrad_case(rng, case)
    module = tst if name == "wgrad" else ttb
    got = getattr(train_f32, name + "_emulated")(*args, **kw)
    _close(got, getattr(module, name + "_reference")(*args, **kw))


@pytest.mark.parametrize("parts,ncls", [((16,), 0), ((16, 8), 3)], ids=["one", "two_head"])
def test_train_tail_3xtf32_matches_plain(rng, parts, ncls):
    """Kernel 3: y, seg, actv and the output (the head's logits) in 3xTF32
    against the plain version."""
    c, lab, nh = 32, 3, 4
    xs = tuple(_t(rng, N, H, W, p) for p in parts)
    f2 = _t(rng, N, H, W, c)
    sp = (_t(rng, lab, c, 3, 3, scale=0.1), _t(rng, lab), _t(rng, nh, lab, 3, 3, scale=0.3),
          _t(rng, nh), _t(rng, c, nh, 3, 3, scale=0.3), _t(rng, c),
          _t(rng, c, nh, 3, 3, scale=0.3), _t(rng, c))
    head = (_t(rng, ncls, c, 1, 1, scale=0.2), _t(rng, ncls)) if ncls else None
    args = (f2, xs, _pos(rng, c), _t(rng, c, scale=0.3), _t(rng, c, sum(parts), 1, 1, scale=0.2),
            sp, head)
    for got, want in zip(train_f32.train_tail_emulated(*args), tst.train_tail_reference(*args)):
        _close(got, want)


@pytest.fixture
def emulated(monkeypatch):
    """The train stage's wrappers on the emulated route; counts its calls."""
    calls = []
    for module, name in ((tst, "conv_stats"), (tst, "train_tail"), (tst, "wgrad"),
                         (ttb, "fused_conv3"), (ttb, "fused_wgrad")):
        fn = getattr(train_f32, name + "_emulated")
        monkeypatch.setattr(module, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


def test_stage_v3_on_the_3xtf32_route_matches_jax(rng, emulated):
    """One stage (two split-concat parts) forward, batch stats and every
    gradient with each train kernel call on its 3xTF32 arithmetic, against
    the JAX fused stage under v3 in f32 (Pallas interpret mode): 12 + 6 + 35
    + 30 calls in a flagship step are these calls, two conv_stats, one tail,
    five or six fused_conv3 and five fused_wgrad per stage."""
    assert tst._TRAIN_BWD_V3
    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=True):
        stage_matches_jax(rng, *STAGES[1])
    counts = {n: emulated.count(n) for n in set(emulated)}
    assert counts == {"conv_stats": 2, "train_tail": 1, "fused_conv3": 6, "fused_wgrad": 5}


def test_weights_changed_in_place_between_calls(rng):
    """Adam updates the parameters in place: the second call of each
    weight-taking kernel sees the new weights (the f32 kernels pack them
    at every call; the eval route's pack kept per model is not theirs)."""
    x = _t(rng, N, H, W, 16)
    w = _t(rng, 32, 16, 3, 3, scale=0.2)
    first = train_f32.conv_stats_emulated((x,), w)[0]
    w.add_(_t(rng, *w.shape, scale=0.05))
    second = train_f32.conv_stats_emulated((x,), w)[0]
    _close(second, tst.conv_stats_reference((x,), w)[0])
    assert ((second - first).norm() / first.norm()).item() > 100 * TOL
    act = torch.relu(_t(rng, N, H, W, 4))
    wg = _t(rng, 32, 4, 3, 3, scale=0.3)
    first = train_f32.fused_conv3_emulated("gamma", (act,), wg)[0]
    wg.mul_(1.1)
    second = train_f32.fused_conv3_emulated("gamma", (act,), wg)[0]
    _close(second, ttb.fused_conv3_reference("gamma", (act,), wg)[0])
    _close(second, first * 1.1)


def test_f32_cpu_tensors_take_the_plain_versions(rng):
    """On the CPU an f32 call runs the plain version and counts no launch,
    in all or in f32."""
    before = (dict(tst.launches), dict(tst.f32_launches), dict(ttb.launches),
              dict(ttb.f32_launches))
    name, args, kw = _conv_case(rng, "bn2")
    got = ttb.fused_conv3(*args, **kw)
    _outputs_close(got, ttb.fused_conv3_reference(*args, **kw))
    name, args, kw = _wgrad_case(rng, "conv1")
    torch.testing.assert_close(ttb.fused_wgrad(*args, **kw),
                               ttb.fused_wgrad_reference(*args, **kw), rtol=0, atol=0)
    assert (tst.launches, tst.f32_launches, ttb.launches, ttb.f32_launches) == before
    assert set(tst.f32_launches) == {"conv_stats", "train_tail", "wgrad"}
    assert set(ttb.f32_launches) == {"fused_conv3", "fused_wgrad"}


def test_conv_modes_map_their_constants():
    """Each bf16 core mode that ops/train_bwd.py passes has an f32 mode,
    and its constants split into prologue and epilogue constants as the
    f32 core reads them (bn2: four of each; pre: two epilogue constants;
    bn1: four prologue constants; the affine: two)."""
    assert set(train_f32._MODES) == {ttb.K_STD, ttb.K_AFF} | {m[0] for m in ttb.CONV_MODES.values()}
    for kmode, mode in train_f32._MODES.items():
        pro, epi = train_f32._CONSTS[mode]
        want = {ttb.K_AFF: 2, ttb.K_STD: 0}.get(kmode)
        if want is None:
            want = next(m[3] for m in ttb.CONV_MODES.values() if m[0] == kmode)
        assert pro + epi == want, (kmode, pro, epi)
