"""The port's ``SSUNet`` slice (on the CPU) against the JAX package: the
``VGGBlock``, the VGG stage's plain versions (bf16 eval stage against
``fused_eval_stage`` in Pallas interpret mode, the int8 stage against
``fused_eval_stage_int8``, the deep s8 block without its residual against
``xla_int8_block``), a narrow ``SSUNet`` (forward with the fused stages on
and off, calibration, two Adam steps) and the registry's new names.

Inputs and weights come from numpy with a seed and cross between the
frameworks as numpy, in f32. Tolerances: the block 1e-5 (rtol = atol, the
same convs summed in other orders); the bf16 stage's plain version
rtol = atol = 2e-4 (the JAX kernel's own parity bar); the int8 stage at
one band to the relative L2 bars of tests/test_torch_int8.py; the narrow
model's forward to 2e-4, its recorded ranges to 1e-6 relative, its train
steps to tests/test_torch_train.py's bars.

The JAX ``SSUNet`` fixes its widths, so ``torch_port_helpers.NarrowSSUNet``
repeats its body at ``S_FILTERS`` through the JAX package's own
``_spade_stage`` dispatch. At 32×32 both gates fuse levels 0-2 (H a
multiple of 8): six stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.infer import calibrate as jax_calibrate
from ssunet_gan_tpu.models import build_model as jax_build_model
from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.ops import stage_kernel_int8 as jq8
from ssunet_gan_tpu.ops.blocks import VGGBlock as JVGGBlock
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.infer import calibrate as port_calibrate
from ssunet_gan_tpu_torch.models import ARCH_REGISTRY, build_model, ssunet
from ssunet_gan_tpu_torch.ops import losses, stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.ops.blocks import VGGBlock
from ssunet_gan_tpu_torch.train import optim
from ssunet_gan_tpu_torch.train.step import make_train_step
from torch_port_helpers import (
    S_FILTERS,
    NarrowSSUNet,
    jax_toggles,
    oihw,
    randomize_batch_stats,
    vec,
)


@pytest.fixture(autouse=True)
def _modes():
    """JAX: fused stages on, the other modes cleared and restored; the
    port's int8 state cleared before and after."""
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


def vgg_bundle(jbp):
    """A JAX VGG bundle ``(k1, (s1, t1), k2, (s2, t2), None)`` in the port's
    layout."""
    k1, (s1, t1), k2, (s2, t2), ks = jbp
    assert ks is None
    return (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), None)


# ---- the block ---------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shapes,middle,out", [
    ([(2, 8, 8, 3)], 16, 16),
    ([(1, 8, 8, 4), (1, 8, 8, 8)], 12, 16),    # split-concat parts, middle != out
], ids=["rgb", "two-parts"])
def test_vgg_block_matches_jax(rng, shapes, middle, out, train):
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jx = tuple(jnp.asarray(x) for x in xs)
    jx = jx if len(jx) > 1 else jx[0]
    cin = sum(s[-1] for s in shapes)
    block = JVGGBlock(middle, out)
    variables = randomize_batch_stats(
        jax.device_get(jax.jit(lambda: block.init(jax.random.PRNGKey(0), jx, True))()))
    port = VGGBlock(cin, middle, out)
    sd = from_jax_variables(variables)
    assert {"conv1.bias", "conv2.bias", "bn2.running_var"} <= set(sd)
    port.load_state_dict(sd)
    port.train(train)
    parts = tuple(torch.from_numpy(x) for x in xs)
    if train:
        want, updates = block.apply(variables, jx, True, mutable=["batch_stats"])
        got = port(parts).detach().numpy()
        stats = jax.device_get(updates["batch_stats"])
        for bn, jname in ((port.bn1, "bn1"), (port.bn2, "bn2")):
            np.testing.assert_allclose(bn.running_mean.numpy(), stats[jname]["mean"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), stats[jname]["var"],
                                       rtol=1e-5, atol=1e-5)
    else:
        want = block.apply(variables, jx, False)
        with torch.no_grad():
            got = port(parts).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:
        return
    # the eval bundle (conv biases folded into the BN offsets) is the JAX
    # param-fetch path's
    jbp = JVGGBlock(middle, out, in_channels=cin).apply(variables, None, False)
    flat = lambda b: [t for a in b for t in (a if isinstance(a, tuple) else (a,))]
    for g, w in zip(flat(port.stage_params()), flat(vgg_bundle(jbp))):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


# ---- the stage ---------------------------------------------------------------


def _vgg_stage(rng, planes, label, shapes, nh, ncls, zero_spade=False):
    """JAX VGG block + SPADE and variables, numpy inputs, both param
    bundles. ``zero_spade`` zeroes the SPADE's weights and biases, so the
    stage's output is its block output y."""
    block = JVGGBlock(planes, planes)
    spade = JSPADE("spadebatch3x3", planes, label, nh)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    xin = jparts if len(jparts) > 1 else jparts[0]
    bvars = randomize_batch_stats(
        jax.jit(lambda: block.init(jax.random.PRNGKey(0), xin, True))())
    y0 = jnp.zeros(shapes[0][:3] + (planes,), jnp.float32)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), y0, y0))()
    if zero_spade:
        svars = jax.tree_util.tree_map(jnp.zeros_like, svars)
    cin = sum(s[-1] for s in shapes)
    jbp = JVGGBlock(planes, planes, in_channels=cin).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    head = thead = None
    if ncls:
        head = (rng.normal(size=(1, 1, planes, ncls)).astype(np.float32) * 0.3,
                rng.normal(size=(ncls,)).astype(np.float32) * 0.1)
        thead = (oihw(head[0]), vec(head[1]))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    return dict(block=block, spade=spade, bvars=bvars, svars=svars, xs=xs, jparts=jparts,
                jbp=jbp, jsp=jsp, head=head, tbp=vgg_bundle(jbp), tsp=tsp, thead=thead)


def _jax_composition(st):
    jparts = st["jparts"]
    y = st["block"].apply(st["bvars"], jparts if len(jparts) > 1 else jparts[0], False)
    out = np.asarray(st["spade"].apply(st["svars"], y, y))
    if st["head"] is not None:
        kf, bf = st["head"]
        out = out @ kf[0, 0] + bf
    return out


# (planes, labels, part shapes, hidden, head classes): SSUNet's level-0
# widths (32 planes, hidden 8) on a 3-channel input, a split-concat pair, and
# the folded head; 8x8, the least height both gates take (a multiple of 8),
# and batches that keep the JAX lane-packing factor at 1
VGG_STAGES = {
    "rgb": (32, 3, [(2, 8, 8, 3)], 8.0, 0),
    "two-parts": (16, 3, [(1, 8, 8, 8), (1, 8, 8, 16)], 4.0, 0),
    "head": (16, 3, [(1, 8, 8, 8), (1, 8, 8, 16)], 4.0, 3),
}


@pytest.mark.parametrize("case", list(VGG_STAGES))
def test_vgg_stage_matches_jax(rng, case):
    planes, label, shapes, nh, ncls = VGG_STAGES[case]
    st = _vgg_stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    before = stage_kernel.launches
    got = stage_kernel.fused_eval_stage(parts, st["tbp"], st["tsp"], st["thead"]).numpy()
    assert stage_kernel.launches == before  # CPU tensors never launch
    kernel = np.asarray(jax_fused_eval_stage(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _jax_composition(st), rtol=2e-4, atol=2e-4)
    # the packed operands: no shortcut segment in conv2
    pk = stage_kernel.pack_stage(tuple(s[-1] for s in shapes), st["tbp"], st["tsp"],
                                 st["thead"], torch.float32)
    assert not pk["shortcut"] and pk["conv2"]["segs"] == ((planes, 3),)


# Relative L2 of the port's int8 VGG stage from the JAX kernel's at one band
# (tests/test_torch_int8.py STAGE_L2[1], measured there <= 1.2e-7); y alone
# (the stage with a zeroed SPADE, whose output is y): integer sums equal,
# the f32 dequantization rounded in another order on about 40% of the
# elements, by at most 2.4e-7 at values up to 1.7 (measured 1.4e-7); h1 to
# the issue's 1.2e-7.
INT8_STAGE_L2, INT8_Y_L2, INT8_H1_L2 = 1e-4, 2e-7, 1.2e-7


def _jax_int8_h1(st):
    """The stage's h1 from the JAX package's own int8 pieces, the recipe
    its kernel applies to conv1: each part quantized per tensor
    (``quantize_tensor``, dynamic), the BN-scaled conv1 weight with each
    part's input scale folded in quantized per output channel
    (``_quant_rows``), the s8 convs summed in s32 (``_conv_s8``), then
    relu(acc * dequant + t1). The JAX kernel returns only the stage
    output, so its h1 is rebuilt here."""
    k1, (s1, t1), _, _, _ = st["jbp"]
    jq, js = zip(*(jq8.quantize_tensor(p) for p in st["jparts"]))
    k1f = (k1 * s1).astype(jnp.float32)
    offs = np.cumsum([0] + [p.shape[-1] for p in st["jparts"]])
    planes = k1.shape[-1]
    w, d = jq8._quant_rows(jnp.concatenate(
        [(k1f[:, :, offs[i]:offs[i + 1], :] * js[i]).reshape(9 * (offs[i + 1] - offs[i]),
                                                              planes).T
         for i in range(len(jq))], axis=1))
    acc = sum(jq8._conv_s8(q, w[:, 9 * offs[i]:9 * offs[i + 1]].T.reshape(
        3, 3, offs[i + 1] - offs[i], planes), 1) for i, q in enumerate(jq))
    return np.asarray(jnp.maximum(acc.astype(jnp.float32) * d + t1, 0.0))


@pytest.mark.parametrize("case", ["rgb", "two-parts", "head", "y"])
def test_vgg_int8_stage_matches_jax(rng, case):
    planes, label, shapes, nh, ncls = VGG_STAGES["two-parts" if case == "y" else case]
    st = _vgg_stage(rng, planes, label, shapes, nh, ncls, zero_spade=case == "y")
    jhead = None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))
    want = np.asarray(jq8.fused_eval_stage_int8(st["jparts"], st["jbp"], st["jsp"],
                                                final_head=jhead))
    before = q8.launches
    got, h1, y = q8.fused_eval_stage_int8(tuple(torch.from_numpy(x) for x in st["xs"]),
                                          st["tbp"], st["tsp"], st["thead"],
                                          intermediates=True)
    assert q8.launches == before  # CPU tensors never launch
    n, h, w = shapes[0][:3]
    assert h1.shape == y.shape == (n, h, w, planes) and q8.band_rows(h) == h
    assert rel_l2(h1.numpy(), _jax_int8_h1(st)) <= INT8_H1_L2
    assert got.shape == want.shape == (n, h, w, ncls or planes)
    if case == "y":
        assert torch.equal(got, y)
        assert rel_l2(y.numpy(), want) <= INT8_Y_L2, rel_l2(y.numpy(), want)
    else:
        assert rel_l2(got.numpy(), want) <= INT8_STAGE_L2, rel_l2(got.numpy(), want)
    # int8 tracks the f32 composition (tests/test_int8_stage.py:76-82)
    f32 = _jax_composition(st)
    rms = np.sqrt(np.mean((got.numpy() - f32) ** 2)) / (np.abs(f32).max() + 1e-6)
    assert rms < 0.02, rms


def test_vgg_int8_block_without_residual_matches_jax(rng):
    """The deep s8 block of a VGG stage (``residual=False``: a plain conv
    chain) on a split-concat pair, dynamic and static scales."""
    shapes, planes = [(2, 8, 8, 8), (2, 8, 8, 16)], 16
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    block = JVGGBlock(planes, planes, in_channels=24)
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(jax.random.PRNGKey(5), jparts,
                                                             True))())
    bp = block.apply(bvars, None, False)
    tparts = tuple(torch.from_numpy(x) for x in xs)
    for calib_key in (None, "deep"):
        if calib_key:
            scales = {f"deep:{i}": float(np.abs(x).max()) * 0.9 for i, x in enumerate(xs)}
            jq8.set_int8_calibration(scales)
            q8.set_int8_calibration(scales)
        want = np.asarray(jq8.xla_int8_block(jparts, bp, calib_key=calib_key, residual=False))
        got = q8.int8_block(tparts, vgg_bundle(bp), calib_key=calib_key, residual=False)
        assert rel_l2(got.numpy(), want) <= 1e-5  # tests/test_torch_int8.py BLOCK_L2


# ---- the narrow model --------------------------------------------------------


@pytest.fixture(scope="module")
def narrow():
    """The narrow JAX SSUNet (random BN statistics), the port loaded from
    its variables, and tiles."""
    with jax_toggles(fused_stage=False):
        model = NarrowSSUNet(num_classes=3)
        x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = randomize_batch_stats(
            jax.device_get(jit_init(model, jax.random.PRNGKey(0), x0, train=False)))
    port = build_model("SSUNet", 3, 3, filters=S_FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    tiles = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    return model, variables, port, tiles


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composition"])
def test_narrow_ssunet_matches_jax(narrow, monkeypatch, fused):
    """Eval logits against the JAX model, with the fused stages on (six VGG
    stages through the eval kernel's plain version on the port's side) and
    off (none). The JAX side runs its plain reference, the module
    composition, as the JAX package's own stage tests hold its kernel: its
    gate is asked as with the fused stages on, and each stage that reaches
    its last term, the compile probe (which passes in interpret mode; it
    answers the TPU's compiler), is counted and refused. The stage tests
    above hold the port's plain version against the JAX kernel in
    interpret mode."""
    model, variables, port, tiles = narrow
    x = tiles[:1]
    jcounts, counts = {}, {}

    def jax_gate(*args, **kwargs):
        jcounts["fused_eval_stage"] = jcounts.get("fused_eval_stage", 0) + 1
        return False

    monkeypatch.setattr(jax_ssunet, "fused_stage_probe_ok", jax_gate)
    _count(monkeypatch, ssunet, "fused_eval_stage", counts)
    stage_kernel.set_fused_stage(fused)
    try:
        with jax_toggles(fused_stage=fused):
            # traced once under jit: the gate is asked at trace time
            want = np.asarray(jax.jit(lambda v, t: model.apply(v, t, False))(
                variables, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
    finally:
        stage_kernel.set_fused_stage(None)
    assert jcounts == counts == ({"fused_eval_stage": 6} if fused else {})
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_narrow_ssunet_calibration_matches_jax(narrow, monkeypatch):
    """The recorded ranges: JAX's 17 keys (13 stage inputs of 9 stages, 4
    of them split-concat pairs, and 4 ``":half"`` keys), values to 1e-6
    relative; then the calibrated int8 forward routes as JAX's: six fused
    int8 stages, and three deep s8 blocks without the residual."""
    model, variables, port, tiles = narrow
    want = jax_calibrate.record_activation_ranges(model, variables, tiles, batch_size=3)
    got = port_calibrate.record_activation_ranges(port, tiles, batch_size=3, device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 17
    assert sum(k.endswith(":half") for k in got) == 4
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * abs(v), (k, got[k], v)
    q8.set_int8_calibration(got)
    q8.set_int8_stage(True)
    counts, seen = {}, []
    _count(monkeypatch, ssunet, "fused_eval_stage_int8", counts)
    block_fn = ssunet.int8_block

    def deep(parts, bp, calib_key=None, residual=True):
        seen.append(residual)
        return block_fn(parts, bp, calib_key=calib_key, residual=residual)

    monkeypatch.setattr(ssunet, "int8_block", deep)
    with torch.no_grad():
        out = port(torch.from_numpy(tiles[:1]))
    assert counts == {"fused_eval_stage_int8": 6} and seen == [False] * 3
    assert out.shape == (1, 32, 32, 3) and torch.isfinite(out).all()


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_narrow_ssunet_train_steps_match_jax(narrow):
    """Two Adam steps of the port's make_train_step (VGG stages train
    through the module composition, as in JAX) against JAX make_train_step,
    to tests/test_torch_train.py's bars: loss and Dice 1e-4, IoU one
    element of its union, parameters 2·lr (Adam's first step is ≈
    lr·sign(g)), the BN running statistics 1e-4 after step 1 and 2·lr after
    step 2."""
    model, variables, _, _ = narrow
    g = np.random.default_rng(6)
    x = g.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = (g.random((2, 32, 32, 3)) > 0.5).astype(np.float32)
    lr = 1e-3
    config = {"optimizer": "Adam", "lr": lr, "weight_decay": 1e-7}
    port = build_model("SSUNet", 3, 3, filters=S_FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    step = make_train_step(port, losses.bce_dice_loss,
                           optim.build_optimizer(port.parameters(), config), 3, clip=0.7)
    tx = joptim.build_optimizer(config)
    state = TrainState.create(variables, tx)
    with jax_toggles(fused_stage=False):
        jstep = jax_make_train_step(model, jlosses.bce_dice_loss, tx, 3, clip=0.7)
        template = jax.tree_util.tree_map(np.zeros_like, variables)
        for i in range(2):
            got = step(torch.from_numpy(x), torch.from_numpy(y), lr)
            state, want = jstep(state, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(lr))
            for k, atol in (("loss", 1e-4), ("iou", 1 / 2048), ("dice", 1e-4)):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                           atol=atol, err_msg=k)
            back, report = convert_torch_state_dict(port.state_dict(), template)
            assert report["unmatched"] == [] and report["skipped"] == []
            ours, theirs = _leaves(back), _leaves(jax.device_get(state.variables()))
            assert ours.keys() == theirs.keys()
            for path, want_leaf in theirs.items():
                name = f"step {i + 1} {jax.tree_util.keystr(path)}"
                tol = 2 * lr if i == 1 or "batch_stats" not in str(path[0]) else 1e-4
                np.testing.assert_allclose(np.asarray(ours[path]), np.asarray(want_leaf),
                                           rtol=1e-4 if "batch_stats" in str(path[0]) else 0,
                                           atol=tol, err_msg=name)


# ---- the registry ------------------------------------------------------------


@pytest.mark.parametrize("arch", ["SSUNet", "UNet_R_SS_v2_wide"])
def test_registry_gives_the_jax_models_names_and_shapes(arch):
    """``build_model`` of the two new names against the JAX model's
    variables (shapes only, ``jax.eval_shape``), by name through the JAX
    package's torch converter: every leaf matched, none left over."""
    port = build_model(arch, 3, device="cpu")
    assert not port.training and arch in ARCH_REGISTRY
    model = jax_build_model(arch, num_classes=3, input_channels=3)
    with jax_toggles(fused_stage=False):
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3)), False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    back, report = convert_torch_state_dict(port.state_dict(), template)
    assert report["unmatched"] == [] and report["skipped"] == []
    got, want = _leaves(back), _leaves(template)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert np.shape(got[path]) == leaf.shape, jax.tree_util.keystr(path)
    if arch == "SSUNet":
        assert port.filters == (32, 64, 128, 256, 512)
        assert port.conv0_0.conv1.bias.shape == (32,) and port.conv0_4.shortcut is None
        assert port.SPADE0_0.nhidden == 8 and port.SPADE4_0.nhidden == 128
    else:
        assert port.filters == (128, 128, 256, 384, 512, 768)
