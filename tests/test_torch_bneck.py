"""The port's Bottleneck block, its fused bottleneck stage (plain path, on
the CPU) and the ``UNet_B_SS`` / ``UNet_R_SS`` models against the JAX
package: ``Bottleneck``, ``fused_eval_stage_bneck`` in Pallas interpret
mode, and the models with fused stages on and off.

Inputs and weights come from numpy with a seed and cross between the
frameworks as numpy. Tolerances: the block in f32 to 1e-5 (rtol = atol, the
same convs summed in other orders); the stage in f32 to rtol = atol = 2e-4
(the JAX kernel's own parity bar, tests/test_stage_kernel.py:258) and in
bf16 to rtol 0.1, atol 0.3 against the f32 composition (the bar
tests/test_torch_stage.py uses for the BasicBlock stage); the models in f32
to rtol = atol = 5e-4 (the JAX package's fused-vs-composition pin).

The JAX models fix their widths, so the narrow models
(``torch_port_helpers.NarrowUNetBSS`` / ``NarrowUNetRSS``) are subclasses
that repeat their bodies with narrow ``filters`` through the JAX package's
own ``_spade_stage`` dispatch. At 32×32 the JAX gate fuses levels 0-2 (H a
multiple of 8); the port's planes cap is patched to the level-2 width so it
splits the model the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops.blocks import Bottleneck as JBottleneck
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage_bneck as jax_fused_bneck
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.ops.blocks import Bottleneck
from ssunet_gan_tpu_torch.ops.spade import SPADE
from torch_port_helpers import (
    B_FILTERS,
    R_FILTERS,
    NarrowUNetBSS,
    NarrowUNetRSS,
    bneck_bundle,
    conv_from_packed,
    jax_toggles,
    oihw,
    randomize_batch_stats,
    tail_from_packed,
    vec,
)


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True):
        yield


# ---- the block ---------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shapes,planes", [
    ([(2, 8, 8, 6)], 16),                      # projection shortcut
    ([(1, 8, 8, 4), (1, 8, 8, 8)], 16),        # projection, split-concat parts
    ([(2, 8, 8, 16)], 16),                     # identity shortcut
], ids=["projection", "two-parts", "identity"])
def test_bottleneck_matches_jax(rng, shapes, planes, train):
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jx = tuple(jnp.asarray(x) for x in xs)
    jx = jx if len(jx) > 1 else jx[0]
    block = JBottleneck(planes)
    variables = randomize_batch_stats(
        jax.device_get(jax.jit(lambda: block.init(jax.random.PRNGKey(0), jx, True))()))
    in_planes = sum(s[-1] for s in shapes)
    port = Bottleneck(in_planes, planes)
    sd = from_jax_variables(variables)
    assert ("shortcut.1.running_var" in sd) == (in_planes != planes)
    port.load_state_dict(sd)
    port.train(train)
    parts = tuple(torch.from_numpy(x) for x in xs)
    if train:
        want, updates = block.apply(variables, jx, True, mutable=["batch_stats"])
        got = port(parts).detach().numpy()
        stats = jax.device_get(updates["batch_stats"])
        for bn, jname in ((port.bn1, "bn1"), (port.bn2, "bn2"), (port.bn3, "bn3")) + (
                ((port.shortcut[1], "shortcut_bn"),) if port.shortcut is not None else ()):
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
    # the eval bundle equals the JAX param-fetch path's
    jbp = JBottleneck(planes, in_planes=in_planes).apply(variables, None, False)
    flat = lambda b: [t for a in b for t in (a if isinstance(a, tuple) else (a,))]
    for g, w in zip(flat(port.stage_params()), flat(bneck_bundle(jbp))):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


# ---- the stage ---------------------------------------------------------------


def _stage(rng, planes, label, shapes, nh, ncls):
    """JAX modules + variables, numpy inputs, and both param bundles."""
    block = JBottleneck(planes)
    spade = JSPADE("spadebatch3x3", planes, label, nh)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    xin = jparts if len(jparts) > 1 else jparts[0]
    bvars = randomize_batch_stats(
        jax.jit(lambda: block.init(jax.random.PRNGKey(0), xin, True))())
    y0 = jnp.zeros(shapes[0][:3] + (planes,), jnp.float32)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), y0, y0))()
    in_planes = sum(s[-1] for s in shapes)
    jbp = JBottleneck(planes, in_planes=in_planes).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    head = thead = None
    if ncls:
        head = (rng.normal(size=(1, 1, planes, ncls)).astype(np.float32) * 0.3,
                rng.normal(size=(ncls,)).astype(np.float32) * 0.1)
        thead = (oihw(head[0]), vec(head[1]))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    return dict(block=block, spade=spade, bvars=bvars, svars=svars, xs=xs, jparts=jparts,
                jbp=jbp, jsp=jsp, head=head, tbp=bneck_bundle(jbp), tsp=tsp, thead=thead)


def _jax_composition(st):
    jparts = st["jparts"]
    y = st["block"].apply(st["bvars"], jparts if len(jparts) > 1 else jparts[0], False)
    out = np.asarray(st["spade"].apply(st["svars"], y, y))
    if st["head"] is not None:
        kf, bf = st["head"]
        out = out @ kf[0, 0] + bf
    return out


STAGES = [
    (16, 3, [(2, 16, 8, 8)], 4.0, 0),                       # encoder, 1 part
    (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 0),       # decoder, 2 parts
    (16, 3, [(1, 16, 16, 16)], 4.0, 0),                     # identity shortcut
    (8, 2, [(2, 8, 8, 3)], 4.0, 0),                         # 3-channel first block
    (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 3),       # folded final head
]
STAGE_IDS = ["one-part", "two-parts", "identity", "rgb", "head"]


@pytest.mark.parametrize("planes,label,shapes,nh,ncls", STAGES, ids=STAGE_IDS)
def test_bneck_stage_matches_jax(rng, planes, label, shapes, nh, ncls):
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    before = stage_kernel_bneck.launches
    got = stage_kernel_bneck.fused_eval_stage_bneck(
        parts, st["tbp"], st["tsp"], st["thead"]).numpy()
    assert stage_kernel_bneck.launches == before  # CPU tensors never launch
    kernel = np.asarray(jax_fused_bneck(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _jax_composition(st), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("planes,label,shapes,nh,ncls", [STAGES[1], STAGES[2]],
                         ids=["two-parts", "identity"])
def test_bneck_stage_bf16(rng, planes, label, shapes, nh, ncls):
    """bf16 plain path against the f32 JAX composition (rtol 0.1, atol 0.3:
    every intermediate rounds to bf16), and against the JAX kernel in bf16,
    which rounds at the same places: at most 2% of the largest magnitude
    apart and 1e-2 in relative L2 (a 1-ulp flip of an intermediate
    propagates)."""
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x).bfloat16() for x in st["xs"])
    got = stage_kernel_bneck.fused_eval_stage_bneck(parts, st["tbp"], st["tsp"])
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, _jax_composition(st), rtol=0.1, atol=0.3)
    kernel = np.asarray(jax_fused_bneck(
        tuple(p.astype(jnp.bfloat16) for p in st["jparts"]), st["jbp"], st["jsp"]),
        np.float32)
    assert np.abs(got - kernel).max() <= 2e-2 * np.abs(kernel).max() + 1e-3
    assert np.linalg.norm(got - kernel) <= 1e-2 * np.linalg.norm(kernel)


def test_gate_and_wrapper_refusals():
    x = torch.zeros((1, 8, 8, 4))
    ok = stage_kernel_bneck.bneck_supported
    assert ok((x,), 16, 3, 4) and ok((x, x), 256, 8, 16, 8)
    assert not ok((x, x, x), 16, 3, 4)                       # three parts
    assert not ok((x, torch.zeros((1, 4, 4, 4))), 16, 3, 4)  # parts of two sizes
    assert not ok((x, x.bfloat16()), 16, 3, 4)               # parts of two dtypes
    assert not ok((x,), 512, 3, 4)                           # planes
    assert not ok((x,), 16, 9, 4) and not ok((x,), 16, 3, 4, 9)  # labels, classes > 8
    assert ok((x,), 16, 3, 32) and ok((x,), 16, 3, 128)  # no hidden term on the CPU, as JAX
    meta = torch.zeros((1, 8, 8, 4), device="meta")
    assert not ok((meta,), 16, 3, 4)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no path is chosen
        stage_kernel_bneck.fused_eval_stage_bneck((meta,), None, None)
    # an identity shortcut needs parts of planes channels in all
    block = Bottleneck(16, 16).eval()
    spade = SPADE("spadebatch3x3", 16, 3, 4.0)
    with pytest.raises(ValueError, match="identity"), torch.no_grad():
        stage_kernel_bneck.pack_stage_bneck((8, 4), block.stage_params(),
                                            spade.stage_params(), None, torch.float32)


@pytest.mark.parametrize("chans,ncls",
                         [((3,), 0), ((8, 40), 0), ((32,), 0), ((8, 24), 0), ((8, 40), 3)],
                         ids=["rgb", "two-parts", "identity", "identity-two-parts", "head"])
def test_pack_stage_bneck_layout_is_the_kernels_gemm(chans, ncls):
    """The CUDA path's operands from ``pack_stage_bneck`` (f32, so exact),
    used as the kernels use them — the three convs walked in the eval conv
    core's K order (``conv_from_packed``), conv3 and the shortcut (or the
    identity's unit matrix) in one sum — reproduce the plain stage; f32
    tolerance 1e-4 for the different summation order."""
    gen = torch.Generator().manual_seed(0)
    planes, labels = 32, 3
    block = Bottleneck(sum(chans), planes, generator=gen).eval()
    assert (block.shortcut is None) == (sum(chans) == planes)
    for m in block.modules():
        if hasattr(m, "running_var"):
            m.running_var.copy_(torch.rand(planes, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(planes, generator=gen) * 0.3)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16, generator=gen)
    head = None
    if ncls:
        head = (torch.randn((ncls, planes, 1, 1), generator=gen) * 0.3,
                torch.randn((ncls,), generator=gen) * 0.1)
    parts = tuple(torch.randn((2, 6, 7, c), generator=gen) for c in chans)
    bp, sp = block.stage_params(), spade.stage_params()
    with torch.no_grad():
        pk = stage_kernel_bneck.pack_stage_bneck(chans, bp, sp, head, torch.float32)
        c1, c2, c3 = pk["conv1"], pk["conv2"], pk["conv3"]
        assert c1["segs"] == tuple((c, 1) for c in chans) and c2["segs"] == ((planes, 3),)
        assert c3["segs"] == ((planes, 1),) + c1["segs"]
        h1 = torch.relu(conv_from_packed(parts, c1) + c1["bias"])
        h2 = torch.relu(conv_from_packed((h1,), c2) + c2["bias"])
        y = torch.relu(conv_from_packed((h2,) + parts, c3) + c3["bias"])
        out = tail_from_packed(y, pk)  # the tail's operands in its kernel's K orders
        want = stage_kernel_bneck.fused_bneck_reference(parts, bp, sp, head)
        composed = spade(block(parts), block(parts))
        if ncls:
            composed = composed @ head[0][:, :, 0, 0].t() + head[1]
    assert out.shape == want.shape == (2, 6, 7, ncls or planes)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(want.numpy(), composed.numpy(), rtol=1e-4, atol=1e-4)


# ---- the models --------------------------------------------------------------

MODELS = {"UNet_B_SS": (NarrowUNetBSS, B_FILTERS), "UNet_R_SS": (NarrowUNetRSS, R_FILTERS)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def narrow(request):
    """A narrow JAX model (random BN statistics) and the port loaded from it."""
    arch = request.param
    cls, filters = MODELS[arch]
    with jax_toggles(fused_stage=False):
        model = cls(num_classes=3)
        x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = randomize_batch_stats(
            jax.device_get(jit_init(model, jax.random.PRNGKey(0), x0, train=False)))
    port = build_model(arch, 3, 3, filters=filters, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return arch, model, variables, port


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composition"])
def test_narrow_model_matches_jax(narrow, monkeypatch, rng, fused):
    """Eval logits against the JAX model with fused stages on (six stages
    through the bottleneck or the BasicBlock kernel on either side) and off
    (none)."""
    arch, model, variables, port = narrow
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32 if fused else 0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jcounts, counts = {}, {}
    for name in ("fused_eval_stage", "fused_eval_stage_bneck"):
        _count(monkeypatch, jax_ssunet, name, jcounts)
        _count(monkeypatch, ssunet, name, counts)
    with jax_toggles(fused_stage=fused):
        want = np.asarray(model.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    kernel = "fused_eval_stage_bneck" if arch == "UNet_B_SS" else "fused_eval_stage"
    assert jcounts == counts == ({kernel: 6} if fused else {})
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_full_width_registry_and_names():
    """Full reference widths: the registry, the default filters and the
    reference's module names."""
    b = build_model("UNet_B_SS", 3, device="cpu")
    r = build_model("UNet_R_SS", 3, device="cpu")
    assert isinstance(b, ssunet.UNetBSS) and b.filters == (64, 128, 256, 512, 1024)
    assert isinstance(r, ssunet.UNetRSS) and r.filters == (64, 128, 256, 384, 512, 768)
    assert not b.training and not r.training
    names = set(b.state_dict())
    assert {"conv0_0.shortcut.0.weight", "conv0_0.shortcut.1.running_mean",
            "conv3_1.conv3.weight", "SPADE0_4.mlp_shared.0.bias", "final.bias"} <= names
    assert b.conv3_1.conv1.weight.shape == (512, 512 + 1024, 1, 1)
    assert b.SPADE4_0.mlp_gamma.weight.shape == (1024, 64, 3, 3)
    assert r.conv0_4.conv1.weight.shape == (64, 64 + 128, 3, 3)
    assert r.conv5_0.shortcut is not None and "conv2_2.bn2.weight" in r.state_dict()


def test_int8_mode_leaves_the_bottleneck_model_on_its_composition(narrow, monkeypatch, rng):
    """The int8 mode covers BasicBlock stages only: ``UNet_B_SS`` with it on
    runs every stage as the composition, bit for bit its unfused forward,
    in f32 and in bf16; ``UNet_R_SS`` takes the int8 stages."""
    arch, _, _, port = narrow
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32)
    x = torch.from_numpy(rng.normal(size=(1, 32, 32, 3)).astype(np.float32))
    counts = {}
    for name in ("fused_eval_stage_int8", "int8_block", "fused_eval_stage_bneck"):
        _count(monkeypatch, ssunet, name, counts)
    q8.set_int8_stage(True)
    try:
        with torch.no_grad():
            on = [port(x.to(dt)) for dt in (torch.float32, torch.bfloat16)]
    finally:
        q8.set_int8_stage(False)
    if arch == "UNet_R_SS":
        assert counts == {"fused_eval_stage_int8": 12, "int8_block": 10}
        return
    assert counts == {}
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 0)
    with torch.no_grad():
        for got, dt in zip(on, (torch.float32, torch.bfloat16)):
            assert got.dtype == dt and torch.equal(got, port(x.to(dt)))


def test_stage_operands_follow_the_bottleneck_weights():
    """The fused bottleneck stages keep their folded operands between
    forwards and drop them when a weight or a BN statistic changes (f32,
    CPU; the outputs compared are the same computation, so equal to 1e-6)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, 32, 3), generator=gen)
    model = build_model("UNet_B_SS", 3, filters=(8, 8, 16, 16, 16), seed=0, device="cpu")
    other = build_model("UNet_B_SS", 3, filters=(8, 8, 16, 16, 16), seed=1, device="cpu")
    with torch.no_grad():
        first = model(x)
        kept = model.conv1_0._fused_operands  # an identity-shortcut stage (8 → 8)
        assert model.conv1_0.shortcut is None and "conv3" in kept[4]
        assert torch.equal(model(x), first)
        assert model.conv1_0._fused_operands is kept
        model.load_state_dict(other.state_dict())
        np.testing.assert_allclose(model(x).numpy(), other(x).numpy(), rtol=1e-6, atol=1e-6)
        assert model.conv1_0._fused_operands is not kept
        model.conv0_4.shortcut[1].running_var.mul_(4.0)
        other.conv0_4.shortcut[1].running_var.mul_(4.0)
        np.testing.assert_allclose(model(x).numpy(), other(x).numpy(), rtol=1e-6, atol=1e-6)
