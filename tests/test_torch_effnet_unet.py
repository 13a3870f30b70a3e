"""The port's ``effnet_unet`` (``models/effnet_unet.py``) and its encoder
AttentiveCNN on both backends (``models/efficientnet.py``: EfficientNet
b2 at 260², or the ResNet-101 trunk at 224²) against the JAX package on
the CPU in f32 (split from ``test_torch_effnet.py`` so that each file
stays near 30 s on one worker).

Modules get their state from seeded numpy and carry it to the JAX
package through its ``convert_torch_state_dict`` (every leaf written,
nothing unmatched or skipped) and back through ``from_jax_variables``.
Bars, relative L2: the encoders' and effnet_unet's eval forwards ≤ 1e-4
(their depth adds rounding), effnet_unet's eval gradients ≤ 1e-4 (all as
one vector, and each alone or within 1e-4 of all gradients' norm), its
train-mode forward, running statistics (the encoder's at momentum 0.01,
the decoder's at 0.1) and loss ≤ 1e-4. Its whole train-mode gradients
are chaotic in f32 (see ``test_torch_unet_families.py``); its blocks' are
held in ``test_torch_effnet.py`` and ``test_torch_resnet.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.models import efficientnet as jeff
from ssunet_gan_tpu.models.effnet_unet import EffNetUNet as JEffNetUNet
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models import efficientnet as teff
from torch_family_helpers import (
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


@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_attentive_cnn_efficientnet_backend_matches_jax():
    """AttentiveCNN (b2: the input resized to 260², features, ``conv_a``
    to 1024 channels) on 64² images, eval forward; a variant whose head
    width is not its F_CHANNELS entry raises, as the JAX assertion."""
    x = _x((2, 64, 64, 3), 12)
    port = teff.AttentiveCNN("efficientnet-b2")
    jm = jeff.AttentiveCNN("efficientnet-b2")
    seed_state(port, 13)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x)))
    assert got.shape == (2, 9, 9, 1024) and rel_l2(got, want) <= ENCODER_TOL
    with pytest.raises(ValueError, match="1280 feature channels"):
        teff.AttentiveCNN("efficientnet-b0")


def test_attentive_cnn_resnet_backend_matches_jax():
    """AttentiveCNN with ``eff_flag=False``: 64² images resized to 224²,
    the trunk, the 2048 → 1024 ``conv_a`` (the JAX package's repair of the
    reference's resnet branch), eval forward."""
    x = _x((1, 64, 64, 3), 8)
    port = teff.AttentiveCNN(eff_flag=False)
    jm = jeff.AttentiveCNN(eff_flag=False)
    seed_state(port, 9)
    variables = to_jax(port, jm, jnp.asarray(x))
    assert_round_trip(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x)))
    assert got.shape == (1, 7, 7, 1024) and rel_l2(got, want) <= ENCODER_TOL


def test_effnet_unet_matches_jax():
    """``build_model("effnet_unet")`` (AttentiveCNN b2 + the decoder + the
    resize back) on 64² against the JAX model: names both ways, the eval
    forward and gradients, the train-mode forward, running statistics
    (the encoder's at momentum 0.01, the decoder's at 0.1) and loss."""
    x = _x((2, 64, 64, 3), 14)
    port = build_model("effnet_unet", 3, 3, device="cpu")
    jm = JEffNetUNet(num_classes=3, input_channels=3)
    assert {"encoder.eff_conv._conv_stem.weight", "encoder.conv_a.weight", "dec_conv3.weight",
            "dec_bn0.running_var", "final.bias"} <= set(port.state_dict())
    seed_state(port, 15)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, [x], ENCODER_TOL, 16)
    check_train(port, jm, variables, [x], TRAIN_TOL, 16, grads=False)
