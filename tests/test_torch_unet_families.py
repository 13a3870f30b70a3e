"""The U-Net families of the port (``models/unet.py``: UNet, UNet_ori and
AttUNet here, NestedUNet and ProgUNet in ``test_torch_nested_unets.py``)
and their blocks (``ops/blocks.py``: ConvBlockBNReLU, UpConv, AttentionBlock,
SELayer), with the resizes and pools they use, against the JAX package on
the CPU in f32.

Each port module gets its state from seeded numpy; its ``state_dict``
maps onto the JAX module's variables through the JAX package's
``convert_torch_state_dict`` (every leaf written, nothing unmatched or
skipped) and back through ``from_jax_variables(target=...)`` onto exactly
its own keys. Bars, relative L2: the eval forward ≤ 1e-5; the gradients of
one loss at the running statistics ≤ 1e-4, all of them as one vector and
each alone (or within 1e-4 of all gradients' norm: an encoder gradient of
ProgUNet is 1e-3 of the decoder's, a difference of larger terms); the
train-mode forward, the running statistics after it and the loss ≤ 1e-4;
a block's train-mode gradients ≤ 1e-4 each (or within 1e-6 of all its
gradients' norm: the conv biases ahead of a BatchNorm, 0 analytically).
A whole model's train-mode gradients are not compared: they are chaotic
in f32, a 1e-7 relative perturbation of the weights moving them by
0.1-4% in either package (UNet 0.7%, AttUNet 1.5-2.4%, ProgUNet
0.2-3.6%), so the ports' distance to JAX (0.3-3.6%) says nothing there;
the blocks' train-mode backward and the composition's eval-mode backward
together cover them. Models at full width (64…1024), 32², batch 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ssunet_gan_tpu.ops import blocks as jblocks
from ssunet_gan_tpu.ops import pool as jpool
from ssunet_gan_tpu.ops import resize as jresize
from ssunet_gan_tpu_torch.ops import blocks, pool, resize
from torch_family_helpers import (
    EVAL_TOL,
    TRAIN_TOL,
    _jax_args,
    assert_round_trip,
    check_eval,
    check_family,
    check_train,
    rel_l2,
    seed_state,
    to_jax,
)
from torch_port_helpers import jax_toggles

@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- resizes and pools -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size,out,ac", [((9, 9), (260, 260), False), ((64, 48), (224, 224), False),
                                         ((5, 7), (10, 14), False), ((6, 4), (12, 8), True),
                                         ((17, 3), (9, 5), True)])
def test_resize_bilinear_matches_jax(size, out, ac, dtype):
    """``resize_bilinear`` (and ``upsample_bilinear`` at ×2 when the size
    doubles) against the JAX package's separable matrix products: f32
    within 1e-6 relative L2 (two taps against a product over zeros), bf16
    within one bf16 rounding of each other (both round once from f32)."""
    x = _x((2, *size, 3))
    tdt = getattr(torch, dtype)
    got = resize.resize_bilinear(torch.from_numpy(x).to(tdt), *out, align_corners=ac)
    want = jresize.resize_bilinear(jnp.asarray(x).astype(dtype), *out, align_corners=ac)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        assert rel_l2(got, want) <= 1e-6
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    if out == (2 * size[0], 2 * size[1]):
        up = resize.upsample_bilinear(torch.from_numpy(x).to(tdt), 2, align_corners=ac)
        jup = jresize.upsample_bilinear(jnp.asarray(x).astype(dtype), 2, align_corners=ac)
        np.testing.assert_allclose(up.float().numpy(), np.asarray(jup.astype(jnp.float32)),
                                   rtol=2 ** -7 if dtype == "bfloat16" else 1e-6, atol=1e-6)


def test_upsample_default_path_is_unchanged():
    """``upsample_bilinear(x)`` (the decoders' ×2, ``align_corners=True``)
    is the lerp it always was: ``upsample_bilinear(x, 2, True)`` bit for
    bit, and the general resize within f32 rounding of it."""
    x = torch.from_numpy(_x((2, 7, 5, 4))).to(torch.bfloat16)
    a = resize.upsample_bilinear(x)
    assert torch.equal(a, resize.upsample_bilinear(x, 2, True))
    assert torch.equal(a, resize.resize_bilinear(x, 14, 10, align_corners=True))


def test_upsample_nearest_and_pools_match_jax():
    x = _x((2, 7, 9, 5))
    np.testing.assert_array_equal(resize.upsample_nearest(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jresize.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_allclose(pool.global_avg_pool(torch.from_numpy(x)).numpy(),
                               np.asarray(jpool.global_avg_pool(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)  # a mean of 63 in another order
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    np.testing.assert_array_equal(pool.max_pool_3x3_s2(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))


# ---- blocks -----------------------------------------------------------------


class _JAXGate(nn.Module):
    """The gate inside a module named ``att`` (the torch side's attribute)."""

    f_int: int

    @nn.compact
    def __call__(self, g, x, train=True):
        return jblocks.AttentionBlock(self.f_int, name="att")(g, x, train)


class _Gate(torch.nn.Module):
    def __init__(self, f_g, f_l, f_int):
        super().__init__()
        self.att = blocks.AttentionBlock(f_g, f_l, f_int)

    def forward(self, g, x):
        return self.att(g, x)


@pytest.mark.parametrize("kind", ["conv_block", "up_conv", "attention", "conv_block_parts"])
def test_blocks_match_jax(kind):
    """ConvBlockBNReLU (also on two split-concat parts), UpConv and
    AttentionBlock: eval forward and gradients, train forward, running
    statistics and gradients; their torch names are the reference's."""
    args = [_x((2, 8, 8, 6))]
    if kind == "conv_block":
        port, jm = blocks.ConvBlockBNReLU(6, 10), jblocks.ConvBlockBNReLU(10)
        names = {"conv.0.weight", "conv.1.running_var", "conv.3.bias", "conv.4.weight"}
    elif kind == "conv_block_parts":
        port, jm = blocks.ConvBlockBNReLU(10, 8), jblocks.ConvBlockBNReLU(8)
        args = [(args[0], _x((2, 8, 8, 4), 1))]
        names = {"conv.0.weight"}
    elif kind == "up_conv":
        port, jm = blocks.UpConv(6, 5), jblocks.UpConv(5)
        names = {"up.1.weight", "up.2.running_mean"}
    else:
        port, jm = _Gate(6, 4, 3), _JAXGate(3)
        args.append(_x((2, 8, 8, 4), 2))
        names = {"att.W_g.0.weight", "att.W_x.1.bias", "att.psi.0.bias", "att.psi.1.weight"}
    assert names <= set(port.state_dict())
    seed_state(port, 3)
    variables = to_jax(port, jm, *_jax_args(args))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, args, EVAL_TOL, 4)
    check_train(port, jm, variables, args, TRAIN_TOL, 4)


class _JAXSE(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return jblocks.SELayer(x.shape[-1], 4, name="se")(x)


class _SE(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.se = blocks.SELayer(c, 4)

    def forward(self, x):
        return self.se(x)


def test_selayer_matches_jax():
    """SELayer (its ``fc.0`` / ``fc.2`` without bias): forward and
    gradients."""
    x = _x((2, 6, 5, 16))
    port, jm = _SE(16), _JAXSE()
    assert {"se.fc.0.weight", "se.fc.2.weight"} == set(port.state_dict())
    seed_state(port, 5)
    variables = to_jax(port, jm, jnp.asarray(x))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, [x], EVAL_TOL, 6)
    check_train(port, jm, variables, [x], TRAIN_TOL, 6)


# ---- the models ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["UNet", "UNet_ori", "AttUNet"])
def test_family_matches_jax(arch):
    """``build_model(arch)`` at full width against the JAX package's model
    of the same registry name: names both ways, eval forward and gradients,
    train-mode forward, running statistics and loss."""
    check_family(arch, False)
