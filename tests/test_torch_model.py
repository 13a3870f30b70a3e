"""The port's flagship ``UNet_R_SS_v2`` against the JAX package's, on the
CPU: full reference widths at 32×32 in f32, weights carried from the JAX
variables by ``from_jax_variables``.

Forward tolerance rtol = atol = 5e-4 (the JAX package's own fused-vs-
composition flagship pin): eleven stages of f32 convs summed in different
orders.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.models import build_model as jax_build_model
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.config import load_experiment_config
from ssunet_gan_tpu_torch.infer.api import segmentation_inference, tile_forward
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models.ssunet import UNetRSSv2
from ssunet_gan_tpu_torch.ops import stage_kernel
from torch_port_helpers import jax_toggles, randomize_batch_stats

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "config_v1.json")


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=False):
        yield


@pytest.fixture(scope="module")
def flagship():
    """JAX flagship variables (random BN stats) and the port loaded from them."""
    with jax_toggles(fused_stage=False):
        model = jax_build_model("UNet_R_SS_v2", num_classes=3, input_channels=3)
        x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = randomize_batch_stats(
            jax.device_get(jit_init(model, jax.random.PRNGKey(0), x0, train=False)))
    port = build_model("UNet_R_SS_v2", 3, 3, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return model, variables, port


def test_forward_matches_jax(flagship, rng):
    model, variables, port = flagship
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, False))(variables, x))
    before = stage_kernel.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert stage_kernel.launches == before
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_state_dict_converts_back_to_the_jax_tree(flagship):
    """port state_dict → the JAX package's torch converter → the same tree."""
    _, variables, port = flagship
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    back, report = convert_torch_state_dict(port.state_dict(), template)
    assert report["unmatched"] == [] and report["skipped"] == []
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def test_build_model_from_config():
    cfg = load_experiment_config(CONFIG).opt_config
    with open(CONFIG) as f:
        raw = json.load(f)["opt_config"]
    assert cfg["deep_supervision"] is False and raw["deep_supervision"] == "False"
    model = build_model(cfg["arch"], cfg["num_classes"], cfg["input_channels"],
                        cfg["deep_supervision"], device="cpu")
    assert isinstance(model, UNetRSSv2) and not model.training
    assert model.filters == (64, 128, 256, 384, 512, 768)
    assert model.final.weight.shape == (cfg["num_classes"], 64, 1, 1)
    assert model.conv0_0.conv1.weight.shape == (64, cfg["input_channels"], 3, 3)
    # seeded: the same seed gives the same weights
    again = build_model(cfg["arch"], cfg["num_classes"], device="cpu")
    assert torch.equal(model.conv2_1.conv1.weight, again.conv2_1.conv1.weight)


def test_unported_arch_names_the_roadmap():
    with pytest.raises(KeyError, match="not ported yet.*'UNet'.*ROADMAP.md"):
        build_model("UNet", 3, device="cpu")
    with pytest.raises(KeyError, match="unknown.*ROADMAP.md"):
        build_model("UNet_X", 3, device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("UNet_R_SS_v2", 3)
    model = build_model("UNet_R_SS_v2", 3, filters=(8, 8, 8, 8, 8, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tile_forward(model, torch.zeros((1, 16, 16, 3), dtype=torch.uint8))
    scene = np.zeros((32, 32, 3), np.uint8)
    config = {"num_classes": 3, "patch_size": 32, "patch_overlap": 0.5}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        segmentation_inference(model, scene, scene[None], None, config, False)


def test_training_forward_matches_jax(flagship, rng):
    """Train mode: six fused train stages (their plain versions here) and
    the deep stages on batch statistics, against JAX ``model.apply(...,
    True, mutable=["batch_stats"])`` (the module composition): logits and
    every BN running statistic at rtol = atol = 1e-3 (f32; batch statistics
    over as few as 2 elements at the deepest level amplify the sums'
    ordering differences)."""
    model, variables, port = flagship
    port = copy.deepcopy(port).train()
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want, updates = jax.jit(lambda v, a: model.apply(v, a, True, mutable=["batch_stats"]))(
        variables, x)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    back, _ = convert_torch_state_dict(port.state_dict(), template)
    want_stats = dict(jax.tree_util.tree_flatten_with_path(updates["batch_stats"])[0])
    got_stats = dict(jax.tree_util.tree_flatten_with_path(back["batch_stats"])[0])
    assert got_stats.keys() == want_stats.keys()
    for path, leaf in want_stats.items():
        np.testing.assert_allclose(np.asarray(got_stats[path]), np.asarray(leaf), rtol=1e-3,
                                   atol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_stage_operands_follow_the_weights():
    """The fused stages keep their folded operands between forwards, and
    drop them when a weight or a BN statistic changes (f32, CPU; the
    outputs compared are the same computation, so equal to 1e-6)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, 32, 3), generator=gen)
    model = build_model("UNet_R_SS_v2", 3, filters=(8, 8, 16, 16, 16, 16), seed=0,
                        device="cpu")
    other = build_model("UNet_R_SS_v2", 3, filters=(8, 8, 16, 16, 16, 16), seed=1,
                        device="cpu")
    with torch.no_grad():
        first = model(x)
        kept = model.conv0_0._fused_operands
        assert torch.equal(model(x), first)
        assert model.conv0_0._fused_operands is kept
        model.load_state_dict(other.state_dict())
        np.testing.assert_allclose(model(x).numpy(), other(x).numpy(), rtol=1e-6, atol=1e-6)
        assert model.conv0_0._fused_operands is not kept
        model.conv0_1.bn2.running_var.mul_(4.0)
        other.conv0_1.bn2.running_var.mul_(4.0)
        np.testing.assert_allclose(model(x).numpy(), other(x).numpy(), rtol=1e-6, atol=1e-6)
