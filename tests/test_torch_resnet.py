"""The port's ResNet-101 trunk (``models/resnet.py``: Bottleneck101,
ResNet101Trunk and its 3×3 max pool) against the JAX package on the CPU
in f32 (split from ``test_torch_effnet.py`` so that each file stays near
30 s on one worker; AttentiveCNN's ResNet backend is held in
``test_torch_effnet_unet.py``).

Modules get their state from seeded numpy and carry it to the JAX
package through its ``convert_torch_state_dict`` (every leaf written,
nothing unmatched or skipped; the trunk's ``resnet_conv.<i>`` names are
the reference's ``nn.Sequential`` indices) and back through
``from_jax_variables``. Bars, relative L2: the trunk's eval forward ≤ 1e-4
(its depth adds rounding), its running statistics and loss after a
train-mode forward ≤ 1e-4 and that forward's output ≤ 2e-3 (measured
9.6e-4: chaotic in f32, see TRUNK_TRAIN_TOL); a Bottleneck101's eval
forward ≤ 1e-5, its eval and train-mode gradients ≤ 1e-4 each (or within
1e-4 / 1e-6 of all its gradients' norm). The whole trunk's train-mode
gradients are chaotic in f32 (see ``test_torch_unet_families.py``) and are
held through its blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ssunet_gan_tpu.models import resnet as jres
from ssunet_gan_tpu_torch.models import resnet as tres
from ssunet_gan_tpu_torch.ops import pool
from torch_family_helpers import (
    EVAL_TOL,
    TRAIN_TOL,
    assert_round_trip,
    check_eval,
    check_train,
    rel_l2,
    seed_state,
    to_jax,
)
from torch_port_helpers import jax_toggles

ENCODER_TOL = 1e-4
# the trunk's train-mode output: 100 BatchNorms on batch statistics carry
# rounding as chaos; a 1e-7 relative perturbation of its weights moves
# JAX's own output by 4.5-7.1e-4 (64² and 128², batch 2)
TRUNK_TRAIN_TOL = 2e-3


@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_max_pool_3x3_gradient_matches_jax():
    """The trunk's 3×3 / stride 2 / pad 1 max pool: forward bit for bit,
    gradient equal (no ties in normal data)."""
    x = _x((2, 9, 8, 4))
    w = _x((2, 5, 4, 4), 1)
    t = torch.from_numpy(x).requires_grad_()
    (pool.max_pool_3x3_s2(t) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(nn.max_pool(a, (3, 3), strides=(2, 2),
                                                  padding=((1, 1), (1, 1))) * w))(
        jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


class _JAXBottleneck(nn.Module):
    planes: int
    stride: int
    downsample: bool

    @nn.compact
    def __call__(self, x, train=True):
        return jres.Bottleneck101(self.planes, self.stride, self.downsample,
                                  name="layer1_0")(x, train)


class _Bottleneck(torch.nn.Module):
    def __init__(self, in_planes, planes, stride, downsample):
        super().__init__()
        self.layer1_0 = tres.Bottleneck101(in_planes, planes, stride, downsample)

    def forward(self, x):
        return self.layer1_0(x)


@pytest.mark.parametrize("stride,downsample", [(2, True), (1, True), (1, False)])
def test_bottleneck101_matches_jax(stride, downsample):
    """torchvision's Bottleneck (expansion 4; ``downsample.0/.1``): eval
    forward and gradients, train-mode forward, running statistics and
    gradients."""
    in_planes = 16 if downsample else 32
    x = _x((2, 9, 10, in_planes), 2)
    port, jm = _Bottleneck(in_planes, 8, stride, downsample), _JAXBottleneck(8, stride,
                                                                             downsample)
    if downsample:
        assert "layer1_0.downsample.1.running_var" in port.state_dict()
    seed_state(port, 3)
    variables = to_jax(port, jm, jnp.asarray(x))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, [x], EVAL_TOL, 4)
    check_train(port, jm, variables, [x], TRAIN_TOL, 4)


class _JAXTrunk(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return jres.ResNet101Trunk(name="resnet_conv")(x, train)


class _Trunk(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet_conv = tres.ResNet101Trunk()

    def forward(self, x):
        return self.resnet_conv(x)


def test_resnet101_trunk_matches_jax():
    """The trunk at 64² (→ 2×2×2048) under the name AttentiveCNN gives it:
    the reference's ``resnet_conv.0``, ``.1``, ``.4``–``.7`` keys (3, 4, 23
    and 3 blocks), eval forward, train-mode forward, running statistics
    and loss."""
    x = _x((2, 64, 64, 3), 5)
    port, jm = _Trunk(), _JAXTrunk()
    sd = port.state_dict()
    assert {"resnet_conv.0.weight", "resnet_conv.1.running_mean",
            "resnet_conv.6.22.conv3.weight", "resnet_conv.7.0.downsample.0.weight"} <= set(sd)
    assert [len(port.resnet_conv[i]) for i in (4, 5, 6, 7)] == [3, 4, 23, 3]
    seed_state(port, 6)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2, 2, 2048)
    assert rel_l2(got, want) <= ENCODER_TOL
    check_train(port, jm, variables, [x], TRAIN_TOL, 7, grads=False,
                forward_tol=TRUNK_TRAIN_TOL)
