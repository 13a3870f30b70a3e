"""The port's standalone fused self-SPADE stage (plain path, on the CPU),
its mode switch and the ``SPADE`` module's dispatch against the JAX
package's ``ops/spade_kernel.py`` (the Pallas kernel in interpret mode) and
``ops/spade.py``; and one narrow ``UNet_B_SS`` train step with the mode
``"pallas"`` on both sides.

Inputs and weights come from numpy with a seed and cross between the
frameworks as numpy. f32 tolerances are the JAX package's own
(tests/test_spade_kernel.py): forwards rtol = atol = 3e-5, gradients 2e-4
(the same sums in other orders). bf16: both kernels round seg, actv and γ|β
to bf16, so they agree within 2% of the largest magnitude and 1e-2 in
relative L2 (a 1-ulp flip of an intermediate propagates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.ops import spade as jax_spade
from ssunet_gan_tpu.ops import spade_kernel as jax_spade_kernel
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops import losses, spade, spade_kernel
from ssunet_gan_tpu_torch.train import optim
from ssunet_gan_tpu_torch.train.step import make_train_step
from torch_port_helpers import (
    B_FILTERS,
    NarrowUNetBSS,
    jax_toggles,
    oihw,
    spade_weights,
    tensor,
)

NAMES = ["x", "k1", "b1", "k2", "b2", "kg", "bg", "kb", "bb"]


@pytest.fixture(autouse=True)
def _modes():
    """Both packages' SPADE modes start at auto and are restored after."""
    with jax_toggles(fused_stage=False):
        spade_kernel.set_fused_spade(None)
        try:
            yield
        finally:
            spade_kernel.set_fused_spade(None)


def _case(rng, n, h, w, c, lab, nh):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    hwio, tsp = spade_weights(rng, c, lab, nh)
    return x, hwio, tsp


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("n,h,w,c,lab,nh", [
    (2, 8, 8, 16, 3, 4),      # one band
    (2, 24, 16, 32, 3, 8),    # several bands of 8 rows
    (1, 8, 32, 48, 2, 16),    # two labels, the widest hidden the kernel takes
])
def test_stage_forward_matches_jax(rng, n, h, w, c, lab, nh):
    x, hwio, tsp = _case(rng, n, h, w, c, lab, nh)
    want = np.asarray(jax_spade_kernel.fused_spade_stage(jnp.asarray(x), *map(jnp.asarray, hwio)))
    before = spade_kernel.launches
    got = spade_kernel.fused_spade_stage(tensor(x), *tsp).numpy()
    assert spade_kernel.launches == before  # a CPU tensor never launches
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    ref = spade_kernel.self_spade_reference(tensor(x), tsp).numpy()
    np.testing.assert_array_equal(got, ref)
    comp = spade_kernel.self_spade_composition(tensor(x), *tsp).numpy()
    np.testing.assert_allclose(got, comp, rtol=3e-5, atol=3e-5)


def test_stage_gradients_match_jax(rng):
    """x (input and segmap at once, counted once) and all eight parameters
    against ``jax.grad`` through the JAX kernel's custom VJP."""
    x, hwio, tsp = _case(rng, 2, 16, 8, 16, 3, 4)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_spade_kernel.fused_spade_stage(*a) * cot),
                    argnums=tuple(range(9)))(jnp.asarray(x), *map(jnp.asarray, hwio))
    args = [t.requires_grad_() for t in (tensor(x), *tsp)]
    (spade_kernel.fused_spade_stage(*args) * tensor(cot)).sum().backward()
    for t, w, name in zip(args, want, NAMES):
        w = np.asarray(w)
        w = oihw(w).numpy() if w.ndim == 4 and name != "x" else w
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_stage_gradients_only_where_needed(rng):
    """Inputs that need no gradient get none; the others are unchanged."""
    x, _, tsp = _case(rng, 1, 8, 8, 16, 3, 4)
    args = [tensor(x).requires_grad_(), *tsp]
    args[5].requires_grad_()
    out = spade_kernel.fused_spade_stage(*args)
    gx, gk = torch.autograd.grad(out.sum(), [args[0], args[5]])
    full = [t.detach().clone().requires_grad_() for t in args]
    spade_kernel.self_spade_composition(*full).sum().backward()
    np.testing.assert_allclose(gx.numpy(), full[0].grad.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gk.numpy(), full[5].grad.numpy(), rtol=1e-6, atol=1e-6)


def test_stage_bf16_rounds_where_the_jax_kernel_does(rng):
    x, hwio, tsp = _case(rng, 1, 16, 16, 32, 3, 4)
    want = np.asarray(jax_spade_kernel.fused_spade_stage(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, hwio)), np.float32)
    got = spade_kernel.fused_spade_stage(tensor(x).bfloat16(), *tsp)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max() + 1e-3
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_fast_gamma_beta_modulate_matches_jax(rng):
    x, hwio, tsp = _case(rng, 2, 8, 12, 16, 3, 4)
    actv = np.maximum(rng.normal(size=(2, 8, 12, 4)), 0).astype(np.float32)
    want = jax_spade_kernel.fast_gamma_beta_modulate(
        jnp.asarray(x), jnp.asarray(actv), *map(jnp.asarray, hwio[4:]))
    got = spade_kernel.fast_gamma_beta_modulate(tensor(x), tensor(actv), *tsp[4:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        spade_kernel.im2col_3x3(tensor(actv)).numpy(),
        np.asarray(jax_spade_kernel.im2col_3x3(jnp.asarray(actv))))


def test_mode_switch_follows_jax():
    for mode in (None, False, True, "off", "fast", "pallas"):
        spade_kernel.set_fused_spade(mode)
        jax_spade_kernel.set_fused_spade(mode)
        assert spade_kernel.fused_spade_mode() == jax_spade_kernel.fused_spade_mode()
    spade_kernel.set_fused_spade(None)
    assert spade_kernel.fused_spade_mode() == "off"  # auto stays off, as in JAX
    with pytest.raises(ValueError):
        spade_kernel.set_fused_spade("triton")


def test_gate_refusals():
    x = torch.zeros((1, 8, 8, 16))
    ok = spade_kernel.fused_spade_supported
    assert ok(x, 3, 3, 4) and ok(x, 3, 8, 16)
    assert not ok(x, 1, 3, 4)            # 1×1 SPADE convs
    assert not ok(x, 3, 9, 4)            # labels > 8
    assert ok(x, 3, 3, 32) and ok(x, 3, 3, 128)  # no hidden term on the CPU, as the JAX gate
    assert not ok(x[0], 3, 3, 4)         # not NHWC
    assert not ok(torch.zeros((1, 8, 8, 16), device="meta"), 3, 3, 4)
    with pytest.raises(ValueError):      # neither CPU nor CUDA: no path is chosen
        spade_kernel.fused_spade_stage(torch.zeros((1, 8, 8, 16), device="meta"),
                                       *[torch.zeros(1, device="meta")] * 8)


def _module_pair(rng, c, lab, nh, seg_ch):
    """A JAX SPADE with random variables and the port's loaded from it."""
    jmod = jax_spade.SPADE("spadebatch3x3", c, lab, float(nh))
    x0, s0 = jnp.zeros((1, 8, 8, c)), jnp.zeros((1, 8, 8, seg_ch))
    variables = jax.device_get(jax.jit(lambda: jmod.init(jax.random.PRNGKey(3), x0, s0))())
    g = np.random.default_rng(9)
    variables = jax.tree_util.tree_map(
        lambda a: a + g.normal(size=a.shape).astype(np.float32) * 0.1, variables)
    port = spade.SPADE("spadebatch3x3", c, lab, float(nh))
    assert (port.ks, port.label_nc, port.nhidden) == (3, lab, nh)
    port.load_state_dict(from_jax_variables(variables))
    return jmod, variables, port


@pytest.mark.parametrize("mode", ["off", "fast", "pallas"])
@pytest.mark.parametrize("segmap", ["self", "general"])
def test_spade_module_modes_match_jax(rng, monkeypatch, mode, segmap):
    """Only ``"pallas"`` with ``segmap is x`` takes the fused stage; a
    general segmap (equal values in another tensor included) takes the
    composition, with γ|β restructured under ``"fast"`` and ``"pallas"``."""
    c, lab, nh = 16, 3, 4
    jmod, variables, port = _module_pair(rng, c, lab, nh, c)
    x = rng.normal(size=(2, 16, 8, c)).astype(np.float32)
    seg = x if segmap == "self" else rng.normal(size=x.shape).astype(np.float32)
    counts, jcounts = {}, {}
    for name in ("fused_spade_stage", "fast_gamma_beta_modulate"):
        _count(monkeypatch, spade, name, counts)
        _count(monkeypatch, jax_spade, name, jcounts)
    spade_kernel.set_fused_spade(mode)
    jax_spade_kernel.set_fused_spade(mode)
    jx = jnp.asarray(x)
    want = np.asarray(jmod.apply(variables, jx, jx if segmap == "self" else jnp.asarray(seg)))
    tx = tensor(x)
    with torch.no_grad():
        got = port(tx, tx if segmap == "self" else tensor(seg)).numpy()
        if segmap == "self":
            other = port(tx, tx.clone()).numpy()  # equal values, not the same tensor
            np.testing.assert_allclose(other, got, rtol=3e-5, atol=3e-5)
    expect = {"off": {}, "fast": {"fast_gamma_beta_modulate": 1},
              "pallas": ({"fused_spade_stage": 1} if segmap == "self"
                         else {"fast_gamma_beta_modulate": 1})}[mode]
    assert jcounts == expect
    if segmap == "self" and mode != "off":  # the clone took the fast path
        expect = dict(expect, fast_gamma_beta_modulate=expect.get("fast_gamma_beta_modulate", 0) + 1)
    assert counts == expect
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_wide_hidden_takes_the_fast_path(monkeypatch, rng):
    """hidden 32 (SSUNet's widths) is within the tail kernel's limit:
    ``"pallas"`` takes the fused stage, the fast path, on both sides, and
    the port matches JAX (its kernel in interpret mode)."""
    c, lab, nh = 32, 3, 32
    jmod, variables, port = _module_pair(rng, c, lab, nh, c)
    counts, jcounts = {}, {}
    for name in ("fused_spade_stage", "fast_gamma_beta_modulate"):
        _count(monkeypatch, spade, name, counts)
        _count(monkeypatch, jax_spade, name, jcounts)
    spade_kernel.set_fused_spade("pallas")
    jax_spade_kernel.set_fused_spade("pallas")
    x = rng.normal(size=(1, 8, 8, c)).astype(np.float32)
    jx = jnp.asarray(x)
    want = np.asarray(jmod.apply(variables, jx, jx))
    tx = tensor(x)
    with torch.no_grad():
        got = port(tx, tx)
    assert counts == jcounts == {"fused_spade_stage": 1}
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_bottleneck_train_step_with_fused_spade_matches_jax(monkeypatch):
    """One SGD step (no momentum, no weight decay, no clamp) of a narrow
    ``UNet_B_SS`` with the mode ``"pallas"`` on both sides, f32. The loss to
    1e-4; the step's gradient vector, read off the parameters as
    (before − after) / lr, to 1e-3 of its largest entry in every tensor and
    1e-3 in relative L2 as a whole (tests/test_torch_train.py's bar for an
    SGD step: f32 sums in other orders through nine stages); BN running
    statistics to 1e-4. The JAX gate (H a multiple of 8) sends the six
    level-0-2 stages to its kernel at 32×32, the port's sends all nine to
    the fused stage's plain version."""
    lr = 0.05
    config = {"optimizer": "SGD", "lr": lr, "momentum": 0.0, "weight_decay": 0.0}
    g = np.random.default_rng(5)
    x = g.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = (g.random((2, 32, 32, 3)) > 0.5).astype(np.float32)
    model = NarrowUNetBSS(num_classes=3)
    variables = jax.device_get(jit_init(model, jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    port = build_model("UNet_B_SS", 3, 3, filters=B_FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    before, _ = convert_torch_state_dict(port.state_dict(), template)

    counts, jcounts = {}, {}
    _count(monkeypatch, spade, "fused_spade_stage", counts)
    _count(monkeypatch, jax_spade, "fused_spade_stage", jcounts)
    spade_kernel.set_fused_spade("pallas")
    jax_spade_kernel.set_fused_spade("pallas")
    step = make_train_step(port, losses.bce_dice_loss, optim.build_optimizer(port.parameters(), config), 3)
    got = step(torch.from_numpy(x), torch.from_numpy(y), lr)
    tx = joptim.build_optimizer(config)
    jstep = jax_make_train_step(model, jlosses.bce_dice_loss, tx, 3)
    state, want = jstep(TrainState.create(variables, tx), (jnp.asarray(x), jnp.asarray(y)),
                        jnp.float32(lr))
    assert counts == {"fused_spade_stage": 9} and jcounts == {"fused_spade_stage": 6}
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-4, atol=1e-4)

    after, report = convert_torch_state_dict(port.state_dict(), template)
    assert report["unmatched"] == [] and report["skipped"] == []
    ours, theirs, start = _leaves(after), _leaves(jax.device_get(state.variables())), _leaves(before)
    assert ours.keys() == theirs.keys()
    g_ours, g_theirs = [], []
    for path, leaf in theirs.items():
        a, b, s = np.asarray(ours[path]), np.asarray(leaf), np.asarray(start[path])
        name = jax.tree_util.keystr(path)
        if "batch_stats" in str(path[0]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
            continue
        ga, gb = (s - a) / lr, (s - b) / lr
        assert np.abs(ga - gb).max() <= 1e-3 * np.abs(gb).max() + 1e-5, name
        g_ours.append(ga.ravel())
        g_theirs.append(gb.ravel())
    ga, gb = np.concatenate(g_ours), np.concatenate(g_theirs)
    assert np.abs(gb).max() > 1e-3  # the step moved the parameters
    assert np.linalg.norm(ga - gb) <= 1e-3 * np.linalg.norm(gb)
