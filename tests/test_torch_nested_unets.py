"""The port's NestedUNet (UNet++, with and without deep supervision) and
ProgUNet (``models/unet.py``) against the JAX package on the CPU in f32,
by ``test_torch_unet_families.py``'s checks and bars (split from it so
that each file stays near 30 s on one worker): names both ways, the eval
forward ≤ 1e-5 relative L2, its gradients ≤ 1e-4, the train-mode
forward, running statistics and loss ≤ 1e-4; full width (64…1024), 32²,
batch 2, each of the four heads compared alone."""

import pytest

from torch_family_helpers import check_family
from torch_port_helpers import jax_toggles


@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        yield


@pytest.mark.parametrize("arch,ds", [("NestedUNet", False), ("NestedUNet", True),
                                     ("ProgUNet", False)],
                         ids=["NestedUNet", "NestedUNet_ds", "ProgUNet"])
def test_family_matches_jax(arch, ds):
    check_family(arch, ds)


@pytest.mark.parametrize("ds", [False, True], ids=["single", "deep_supervision"])
def test_progunet_heads_do_not_train_through_the_step(ds):
    """ProgUNet's four heads sit at four sizes: the JAX package's
    ``make_train_step`` raises on them (no NaN scrub of a list; with deep
    supervision the loss meets a ½-size head with the full-size target),
    and the port's raises likewise rather than score them otherwise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ssunet_gan_tpu.models import build_model as jax_build_model
    from ssunet_gan_tpu.ops.losses import bce_dice_loss
    from ssunet_gan_tpu.train.optim import build_optimizer as jax_build_optimizer
    from ssunet_gan_tpu.train.state import TrainState
    from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.train.optim import build_optimizer
    from ssunet_gan_tpu_torch.train.step import make_train_step

    x = np.zeros((2, 32, 32, 3), np.float32)
    y = np.zeros((2, 32, 32, 2), np.float32)
    cfg = {"optimizer": "Adam", "lr": 1e-3}
    jm = jax_build_model("ProgUNet", 2, 3, ds)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), True))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))
    tx = jax_build_optimizer(cfg)
    jstep = jax_make_train_step(jm, bce_dice_loss, tx, 2, ds)
    with pytest.raises(TypeError):
        jstep(TrainState.create(variables, tx), (jnp.asarray(x), jnp.asarray(y)),
              jnp.float32(1e-3))
    port = build_model("ProgUNet", 2, 3, ds, device="cpu")
    step = make_train_step(port, get_loss("BCEDiceLoss"),
                           build_optimizer(port.parameters(), cfg), 2, ds)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        step(torch.from_numpy(x), torch.from_numpy(y), 1e-3)
