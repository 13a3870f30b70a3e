"""The blocks no model of the JAX package uses (``ops/blocks.py``:
gaussian_activation, Modulecell, xResidualBlock, xBasicBlock,
SPADEResnetBlock on ``ops/spade.py`` SPADE and ``ops/spectral.py``
SNConv2d) against the JAX package on the CPU in f32.

Each block gets its state from seeded numpy and carries it to the JAX
package through its ``convert_torch_state_dict`` (every leaf written,
nothing unmatched or skipped: the reference's names ``features.0``,
``module.0/.2/.3``, ``norm_*.mlp_shared.0``, ``conv_*.weight_orig`` /
``weight_u`` / ``weight_v``) and back through ``from_jax_variables``.
Bars, relative L2: eval forwards ≤ 1e-5; eval gradients ≤ 1e-4 (each
alone, or within 1e-4 of all gradients' norm); the train-mode forward,
the running statistics and spectral u and v after it, the loss and every
parameter gradient ≤ 1e-4 (or within 1e-6 of all gradients' norm: the
conv biases ahead of a BatchNorm, 0 analytically). 16×16 maps, batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ssunet_gan_tpu.ops import blocks as jblocks
from ssunet_gan_tpu_torch.ops import blocks
from torch_family_helpers import (
    EVAL_TOL,
    TRAIN_TOL,
    assert_round_trip,
    check_eval,
    check_train,
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


def test_gaussian_activation_matches_jax():
    x = _x((3, 4, 5, 6))
    np.testing.assert_allclose(blocks.gaussian_activation(torch.from_numpy(x)).numpy(),
                               np.asarray(jblocks.gaussian_activation(jnp.asarray(x))),
                               rtol=1e-6)


class _JAXCell(nn.Module):
    """The Modulecell under the name ``md``, as xResidualBlock holds it (a
    bare one's ``module.*`` keys would lose their first part to the JAX
    converter's DataParallel-prefix strip)."""

    @nn.compact
    def __call__(self, x, train=True):
        return jblocks.Modulecell(8, 3, 9, name="md")(x, train)


class _Cell(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.md = blocks.Modulecell(6, 8, 3, 9)

    def forward(self, x):
        return self.md(x)


def _block(kind):
    if kind == "modulecell":
        return _Cell(), _JAXCell(), [_x((2, 16, 16, 6), 1)]
    if kind == "xresidual":
        return (blocks.xResidualBlock(8, 8, 3, 1), jblocks.xResidualBlock(8, 3, 1),
                [_x((2, 16, 16, 8), 2)])
    if kind == "xbasic":
        return blocks.xBasicBlock(8, 8, 1), jblocks.xBasicBlock(8, 1), [_x((2, 16, 16, 8), 3)]
    fin, fout, opt_type = {"spade_same": (8, 8, 1), "spade_shortcut": (8, 12, 1),
                           "spade_wide_middle": (8, 12, 2)}[kind]
    seg_nc = 5 if opt_type == 2 else None
    seg = _x((2, 16, 16, seg_nc or fin), 5)
    return (blocks.SPADEResnetBlock(fin, fout, opt_type, seg_nc=seg_nc),
            jblocks.SPADEResnetBlock(fin, fout, opt_type), [_x((2, 16, 16, fin), 4), seg])


KINDS = ["modulecell", "xresidual", "xbasic", "spade_same", "spade_shortcut",
         "spade_wide_middle"]


@pytest.mark.parametrize("kind", KINDS)
def test_block_matches_jax(kind):
    """Modulecell (the depthwise 9×9 mask conv, groups = channels),
    xResidualBlock, xBasicBlock (identity shortcut) and SPADEResnetBlock
    (fin = fout; the learned shortcut ``norm_s`` / ``conv_s``; opt_type 2's
    wider middle with a 5-channel segmap): names both ways, eval forward
    and gradients, train-mode forward, running statistics, spectral u and
    v, loss and gradients."""
    port, jm, args = _block(kind)
    names = {"modulecell": {"md.features.0.weight", "md.module.0.running_mean",
                            "md.module.2.weight", "md.module.3.bias"},
             "xresidual": {"md.module.2.bias", "conv2.weight", "bn1.running_var"},
             "xbasic": {"conv1.md.features.0.bias", "conv2.bn1.weight"},
             "spade_same": {"norm_0.mlp_shared.0.weight", "conv_0.weight_orig",
                            "conv_1.weight_u", "conv_1.weight_v"},
             "spade_shortcut": {"norm_s.x2map.weight", "conv_s.weight"},
             "spade_wide_middle": {"norm_1.mlp_gamma.weight"}}[kind]
    assert names <= set(port.state_dict())
    if kind == "modulecell":
        assert port.md.module[2].weight.shape == (8, 1, 9, 9)
    seed_state(port, 6)
    variables = to_jax(port, jm, *map(jnp.asarray, args))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, args, EVAL_TOL, 7)
    check_train(port, jm, variables, args, TRAIN_TOL, 7)


def test_xbasic_projection_shortcut_fails_as_in_jax():
    """The xResidualBlock shortcut (kernel 1 with padding 1, then the input
    added) changes the size, so an xBasicBlock with in_planes != planes
    fails in both packages, as in the reference."""
    x = _x((1, 8, 8, 4), 8)
    with pytest.raises(RuntimeError):
        blocks.xBasicBlock(4, 8, 1)(torch.from_numpy(x))
    with pytest.raises((TypeError, ValueError)):
        jblocks.xBasicBlock(8, 1).init(jax.random.PRNGKey(0), jnp.asarray(x), True)


@pytest.mark.parametrize("arch", ["UNet", "UNet_ori", "AttUNet", "NestedUNet", "ProgUNet",
                                  "effnet_unet"])
def test_load_model_dir_serves_the_family(tmp_path, arch):
    """``infer.api.load_model_dir`` builds each family from its card and
    loads its ``model.pth`` with nothing missing (NestedUNet with deep
    supervision); ``tile_forward`` takes the last head of a list, as the
    JAX package's scene forward does: ProgUNet's ⅛-size head."""
    from ssunet_gan_tpu_torch.infer.api import load_model_dir, tile_forward
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.train import checkpoint as ckpt

    ds = arch == "NestedUNet"
    model = build_model(arch, 3, 3, ds, seed=3, device="cpu")
    ckpt.save_model(str(tmp_path), model)
    card = {"arch": arch, "num_classes": 3, "input_channels": 3, "deep_supervision": ds}
    loaded = load_model_dir(str(tmp_path), card, device="cpu")
    assert type(loaded) is type(model) and not loaded.training
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    tiles = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    probs = tile_forward(loaded, tiles, device="cpu")
    side = 4 if arch == "ProgUNet" else 32
    assert probs.shape == (1, side, side, 3) and bool(torch.isfinite(probs).all())
