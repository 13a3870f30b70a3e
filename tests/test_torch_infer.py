"""The port's scene tiling, merge and whole-scene inference against the JAX
package's, on the CPU.

``grid_coords`` and both merge paths must be bit-equal (every merge value
is an exact small integer or multiple of 1/16 in f32). The inference
comparison runs a narrow ``filters=`` flagship in f32 on both sides; its
tile probabilities agree within 1e-5 and the merged masks must be equal,
the ground-truth masks of the labels too (cv2.resize in the JAX package,
its fixed point in integers in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.data.tiling import extract_patches as jax_extract_patches
from ssunet_gan_tpu.data.tiling import grid_coords as jax_grid_coords
from ssunet_gan_tpu.data.tiling import merge_patches_device as jax_merge
from ssunet_gan_tpu.infer.api import _chunked_forward as jax_chunked_forward
from ssunet_gan_tpu.infer.api import segmentation_inference as jax_segmentation_inference
from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.data.tiling import extract_patches, grid_coords, merge_patches_device
from ssunet_gan_tpu_torch.infer.api import (
    _chunked_forward,
    effective_patch_size,
    segmentation_inference,
)
from ssunet_gan_tpu_torch.models import build_model
from torch_port_helpers import jax_toggles, randomize_batch_stats

NARROW = (8, 16, 16, 24, 24, 32)


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=False):
        yield


@pytest.mark.parametrize(
    "h,w,p,overlap",
    [(2048, 2048, 1024, 0.5), (64, 80, 32, 0.5), (100, 70, 32, 0.25), (64, 64, 64, 0.0)],
)
def test_grid_coords_equal_jax(h, w, p, overlap):
    np.testing.assert_array_equal(grid_coords(h, w, p, overlap),
                                  jax_grid_coords(h, w, p, overlap))


@pytest.mark.parametrize("h,w,p,overlap", [(16, 16, 32, 0.5), (64, 64, 32, 1.0)])
def test_grid_coords_refuse_like_jax(h, w, p, overlap):
    with pytest.raises(ValueError):
        jax_grid_coords(h, w, p, overlap)
    with pytest.raises(ValueError):
        grid_coords(h, w, p, overlap)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("h,w,p,in_size", [(64, 64, 32, 16), (48, 80, 32, 16)])
@pytest.mark.parametrize("overlap", [0.5, None])
def test_merge_bit_equal_jax(dtype, h, w, p, in_size, overlap):
    """overlap=0.5 takes the overlap-add grid path on both sides, None the
    general per-patch path."""
    g = np.random.default_rng(3)
    coords = grid_coords(h, w, p, 0.5)
    if dtype == "uint8":
        probs = g.integers(0, 256, size=(len(coords), in_size, in_size, 3)).astype(np.uint8)
    else:
        probs = g.random((len(coords), in_size, in_size, 3)).astype(np.float32)
    want = jax_merge(probs, coords, h, w, p, 3, overlap=overlap)
    got = merge_patches_device(torch.from_numpy(probs), coords, h, w, p, 3,
                               overlap=overlap)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0, 255} and 0 < want.mean() < 255


def test_extract_patches_and_patch_size_clamp():
    scene = np.random.default_rng(0).integers(0, 256, (64, 80, 3)).astype(np.uint8)
    coords = grid_coords(64, 80, 32, 0.5)
    np.testing.assert_array_equal(extract_patches(scene, coords, 32),
                                  jax_extract_patches(scene, coords, 32))
    assert effective_patch_size(2048, 2048, 1024) == 1024
    assert effective_patch_size(40, 61, 1024) == 40
    assert effective_patch_size(61, 80, 1024) == 60


def test_segmentation_inference_matches_jax():
    jmodel = JUNetRSSv2(num_classes=3, filters=NARROW)
    variables = randomize_batch_stats(jax.device_get(
        jit_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    port = build_model("UNet_R_SS_v2", 3, filters=NARROW, device="cpu")
    port.load_state_dict(from_jax_variables(variables))

    scene = np.random.default_rng(5).integers(0, 256, (128, 128, 3)).astype(np.uint8)
    config = {"patch_size": 64, "input_w": 32, "input_h": 32, "patch_overlap": 0.5,
              "num_classes": 3, "deep_supervision": False}
    coords = grid_coords(128, 128, 64, 0.5)
    tiles = extract_patches(scene, coords, 64)[:, ::2, ::2]  # 36 tiles: 2 chunks, padded

    want, _ = jax_segmentation_inference(jmodel, variables, scene, tiles, tiles,
                                         config, False)
    got, _ = segmentation_inference(port, scene, tiles, tiles, config, False,
                                    device="cpu")
    assert len(got) == 3 and got[0].shape == (128, 128) and got[0].dtype == np.uint8
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)

    # the tile probabilities behind the masks, padded last chunk included
    probs = _chunked_forward(port, tiles, device="cpu").numpy()
    jprobs = np.asarray(jax_chunked_forward(jmodel, variables, tiles, False))
    assert probs.shape == jprobs.shape == (36, 32, 32, 3)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    assert 0.05 < probs.std()  # the masks are not a constant field


def test_gt_mask_branch_names_the_roadmap():
    """The ground-truth branch, which raised NotImplementedError naming
    ROADMAP.md until the labels' masks were ported, against the JAX
    package's: both mask lists bit for bit, each class present."""
    jmodel = JUNetRSSv2(num_classes=3, filters=NARROW)
    variables = randomize_batch_stats(jax.device_get(
        jit_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    port = build_model("UNet_R_SS_v2", 3, filters=NARROW, device="cpu")
    port.load_state_dict(from_jax_variables(variables))

    g = np.random.default_rng(3)
    scene = g.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    colours = np.array([(255, 255, 255), (255, 0, 0), (0, 0, 255), (40, 90, 10)], np.uint8)
    labels = np.ascontiguousarray(colours[g.integers(0, 4, (16, 16))].repeat(8, 0).repeat(8, 1))
    config = {"patch_size": 64, "input_w": 32, "input_h": 32, "patch_overlap": 0.5,
              "num_classes": 3, "deep_supervision": False}
    coords = grid_coords(128, 128, 64, 0.5)
    tiles = extract_patches(scene, coords, 64)[:, ::2, ::2]
    masks = extract_patches(labels, coords, 64)

    want = jax_segmentation_inference(jmodel, variables, scene, tiles, masks, config, True)
    got = segmentation_inference(port, scene, tiles, masks, config, True, device="cpu")
    for g_list, w_list in zip(got, want):
        assert len(g_list) == 3
        for g_, w_ in zip(g_list, w_list):
            assert g_.shape == (128, 128) and g_.dtype == np.uint8
            np.testing.assert_array_equal(g_, w_)
    for m in got[1]:  # each class in the ground truth, and not everywhere
        assert 0 < m.mean() < 255
    # the mask patches as a list (patch_gen's form) give the same masks
    again = segmentation_inference(port, scene, tiles, list(masks), config, True, device="cpu")
    for g_, w_ in zip(again[1], got[1]):
        np.testing.assert_array_equal(g_, w_)
