"""The f32 route of kernel 9 (kernel 9f: the self-SPADE stage as three
launches of the 3xTF32 conv core of ``csrc/f32_conv.cuh``: seg, act, γ|β
with the modulate) on the CPU: the launches' plain versions
(``f32_conv_reference``) and the kernel's arithmetic in plain PyTorch
(``f32_conv_emulated``) against the JAX package's ``fused_spade_stage`` in
f32 (Pallas interpret mode; it casts its weights to the activation dtype),
forward and, through the port's autograd Function with the route in its
forward, gradients; the gate's f32 terms on a CUDA-shaped stand-in; and
the kept operands following the weights.

Tolerances: against JAX rtol = atol = 2e-4 (the bar of the f32 stage
kernels, tests/test_torch_stage_f32.py); between the port's functions
(the same sums in another order, 3xTF32 products within ~2^-22) relative
L2 and max error over max |·| ≤ 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import spade_kernel as jax_spade_kernel
from ssunet_gan_tpu_torch.ops import spade_kernel, stage_kernel
from torch_port_helpers import jax_toggles, oihw, spade_weights, tensor

NAMES = ["x", "k1", "b1", "k2", "b2", "kg", "bg", "kb", "bb"]


@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        spade_kernel.set_fused_spade(None)
        try:
            yield
        finally:
            spade_kernel.set_fused_spade(None)


def _close(got, want, tol=1e-5):
    diff = (got - want).double()
    scale = want.double().abs().max().item()
    l2 = (diff.norm() / want.double().norm()).item()
    assert diff.abs().max().item() <= tol * scale and l2 <= tol, (diff.abs().max().item(),
                                                                  scale, l2)


def _route(conv, log=None):
    """Kernel 9f's launches with ``conv`` in each launch's place, on the
    kept operands: what the wrapper runs on a CUDA f32 tensor."""
    def run(x, params):
        def launch(sources, pk, y=None):
            if log is not None:
                log.append((pk["cout"], pk["relu"], y is not None))
            return conv(sources, pk, y)

        return stage_kernel.f32_tail_launches(x, spade_kernel.spade_f32_operands(params), launch)

    return run


@pytest.mark.parametrize("n,h,w,c,lab,nh,grads", [
    (2, 8, 8, 16, 3, 4, True),       # SSUNet-like: the narrowest hidden
    (1, 16, 8, 48, 2, 16, False),    # channels off the bf16 kernel's multiple of 32
    (1, 8, 16, 32, 3, 64, False),
    (1, 8, 8, 32, 9, 128, True),     # past the bf16 tail's labels and hidden
], ids=["hidden4", "hidden16", "hidden64", "hidden128"])
def test_f32_route_matches_jax(rng, monkeypatch, n, h, w, c, lab, nh, grads):
    """Forward: the three launches, plain and emulated, against JAX
    ``fused_spade_stage`` in f32 and against ``self_spade_reference``.
    Gradients: ``fused_spade_stage`` with the route in its forward and its
    backward (autograd of the composition) against ``jax.vjp`` of the JAX
    kernel's custom VJP, for x and all eight weights."""
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    hwio, tsp = spade_weights(rng, c, lab, nh)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(jax_spade_kernel.fused_spade_stage, jnp.asarray(x),
                        *map(jnp.asarray, hwio))
    want = np.asarray(want)
    log = []
    got = _route(stage_kernel.f32_conv_reference, log)(tensor(x), tsp)
    assert log == [(lab, False, False), (nh, True, False), (2 * c, False, True)]
    emulated = _route(stage_kernel.f32_conv_emulated)(tensor(x), tsp)
    ref = spade_kernel.self_spade_reference(tensor(x), tsp)
    _close(got, ref)
    _close(emulated, ref)
    for out in (got, emulated):
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-4)
    if not grads:
        return
    monkeypatch.setattr(spade_kernel, "self_spade_reference",
                        _route(stage_kernel.f32_conv_emulated))
    args = [t.clone().requires_grad_() for t in (tensor(x), *tsp)]
    out = spade_kernel.fused_spade_stage(*args)
    _close(out.detach(), emulated)
    (out * tensor(cot)).sum().backward()
    for t, g, name in zip(args, vjp(jnp.asarray(cot)), NAMES):
        g = np.asarray(g)
        g = oihw(g).numpy() if g.ndim == 4 and name != "x" else g
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=name)


class _X:
    """What the gate reads of x on the card, without a card."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)


BF16 = torch.bfloat16


@pytest.mark.parametrize("shape,dtype,ks,lab,nh,takes", [
    ((8, 512, 512, 64), torch.float32, 3, 3, 4, True),
    ((8, 32, 32, 1024), torch.float32, 3, 3, 64, True),
    ((2, 19, 13, 48), torch.float32, 3, 9, 128, True),   # no width limits in f32
    ((2, 16, 16, 64), torch.float32, 1, 3, 4, False),    # 3×3 convs only
    ((16, 16, 64), torch.float32, 3, 3, 4, False),       # NHWC
    ((8, 512, 512, 64), BF16, 3, 3, 4, True),            # the bf16 kernel's terms, as before
    ((8, 32, 32, 48), BF16, 3, 3, 4, False),
    ((8, 32, 32, 64), BF16, 3, 3, 128, False),
    ((8, 32, 32, 64), BF16, 3, 9, 4, False),
    ((8, 32, 32, 64), torch.float16, 3, 3, 4, False),
], ids=["level0", "level4", "ragged", "ks1", "three_dims", "bf16", "bf16_channels",
        "bf16_hidden", "bf16_labels", "float16"])
def test_gate_takes_f32_self_spades(shape, dtype, ks, lab, nh, takes):
    """``fused_spade_supported`` on the card: every f32 self-SPADE with 3×3
    convs on a 4-D tensor (kernel 9f has no width limits); the bf16
    kernel's terms unchanged; other dtypes refused."""
    assert spade_kernel.fused_spade_supported(_X(shape, dtype), ks, lab, nh) is takes


def test_kept_operands_follow_the_weights(rng):
    """The route packs a SPADE's weights once and keeps them while none of
    the eight changes: an optimizer's in-place update (a new version) or a
    new tensor in one's place repacks, and the output follows the new
    weights."""
    x = tensor(rng.normal(size=(1, 8, 8, 16)))
    _, tsp = spade_weights(rng, 16, 3, 4)
    params = [torch.nn.Parameter(t.clone()) for t in tsp]
    first = spade_kernel.spade_f32_operands(params)
    assert spade_kernel.spade_f32_operands(params) is first
    run = _route(stage_kernel.f32_conv_reference)
    before = run(x, params)
    with torch.no_grad():
        params[4].mul_(1.5)  # mlp_gamma, in place
    second = spade_kernel.spade_f32_operands(params)
    assert second is not first and spade_kernel.spade_f32_operands(params) is second
    after = run(x, params)
    assert not torch.equal(after, before)
    with torch.no_grad():
        _close(after, spade_kernel.self_spade_reference(x, params))
    params[1] = torch.nn.Parameter(params[1].detach() + 0.25)  # a new x2map bias
    third = spade_kernel.spade_f32_operands(params)
    assert third is not second
    with torch.no_grad():
        _close(run(x, params), spade_kernel.self_spade_reference(x, params))
