"""The port's whole-scene data path against the JAX package, on the CPU:
the tile server (``native``), the tiling helpers of the reference
(``patch_gen``, ``post_process_resized_mask``, ``mask_convert``,
``patch_merge``), scene files to tiles (``get_patched_input``),
``pipelined_scene_forward`` and ``ScenePatchDataset``; the ground-truth
branch of ``segmentation_inference`` is held in
``tests/test_torch_infer.py``.

The JAX package resizes with cv2 (``cv2.resize``, INTER_LINEAR) and its
tile server; the port with the same server and ``resize_linear``. Masks
and uint8 tiles must be equal bit for bit; f32 tile probabilities of the
narrow flagship agree within 1e-5, as in ``tests/test_torch_infer.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu import native as jax_native
from ssunet_gan_tpu.data import tiling as jax_tiling
from ssunet_gan_tpu.data.dataset import ScenePatchDataset as JScenePatchDataset
from ssunet_gan_tpu.data.transforms import Compose as JCompose
from ssunet_gan_tpu.data.transforms import Normalize as JNormalize
from ssunet_gan_tpu.infer import api as jax_api
from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch import native
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.data import tiling
from ssunet_gan_tpu_torch.data.dataset import ScenePatchDataset
from ssunet_gan_tpu_torch.data.png import write_image
from ssunet_gan_tpu_torch.data.transforms import Compose, Normalize, resize_linear
from ssunet_gan_tpu_torch.infer import api
from ssunet_gan_tpu_torch.models import build_model
from torch_port_helpers import jax_toggles, randomize_batch_stats

NARROW = (8, 16, 16, 24, 24, 32)
CONFIG = {"patch_size": 64, "input_w": 32, "input_h": 32, "patch_overlap": 0.5,
          "num_classes": 3, "deep_supervision": False}
COLOURS = np.array([(255, 255, 255), (255, 0, 0), (0, 0, 255), (40, 90, 10)], np.uint8)


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=False):
        yield


@pytest.fixture(scope="module")
def models():
    jmodel = JUNetRSSv2(num_classes=3, filters=NARROW)
    variables = randomize_batch_stats(jax.device_get(
        jit_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    port = build_model("UNet_R_SS_v2", 3, filters=NARROW, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, port


def _scene(h, w, seed=0):
    """A smooth field plus noise (BGR uint8) and its labels in the four
    colours (three classes and an unlabelled one) in 8-pixel blocks."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([xx * 2 + yy, (xx * yy) // 16, 200 - yy], -1) % 256
    img = np.clip(img + g.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    lab = COLOURS[g.integers(0, 4, (h // 8 + 1, w // 8 + 1))].repeat(8, 0).repeat(8, 1)
    return img, np.ascontiguousarray(lab[:h, :w])


def _write_scene(root, name, h, w, seed=0):
    img, lab = _scene(h, w, seed)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(str(root), f"{name}_image.png")
    write_image(path, img)
    write_image(os.path.join(str(root), f"{name}_labels.png"), lab)
    return path, img, lab


# ---------------------------------------------------------------------------
# the tile server
# ---------------------------------------------------------------------------


def test_tileserver_source_is_the_jax_packages():
    with open(native.SOURCE, "rb") as f, open(
            os.path.join(os.path.dirname(jax_native.__file__), "tileserver.cpp"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("p,oh,ow", [(128, 64, 64), (96, 64, 64), (97, 51, 64), (64, 128, 96),
                                     (33, 7, 19), (2, 1, 1)])
def test_tileserver_equals_jax_native(p, oh, ow):
    scene = np.random.default_rng(p + oh).integers(0, 256, (260, 310, 3), np.uint8)
    coords = tiling.grid_coords(260, 310, p, 0.4)
    np.testing.assert_array_equal(native.extract_resize_u8(scene, coords, p, oh, ow),
                                  jax_native.extract_resize_u8(scene, coords, p, oh, ow))
    np.testing.assert_array_equal(native.extract_u8(scene, coords, p),
                                  jax_native.extract_u8(scene, coords, p))


@pytest.mark.parametrize("p,o", [(128, 64), (64, 32), (96, 32), (100, 64), (60, 37)])
def test_tileserver_against_resize_linear(p, o):
    """Bit for bit at 2x and at the integer 3x; within one level otherwise
    (``resize_linear`` is cv2's fixed point, the server cv2's too, with
    another rounding of the vertical pass)."""
    scene = np.random.default_rng(p).integers(0, 256, (300, 257, 3), np.uint8)
    coords = tiling.grid_coords(300, 257, p, 0.5)
    got = native.extract_resize_u8(scene, coords, p, o, o)
    want = np.stack([resize_linear(t, o, o) for t in tiling.extract_patches(scene, coords, p)])
    if p % o == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int16) - want).max() <= 1
    np.testing.assert_array_equal(native.extract_u8(scene, coords, p),
                                  tiling.extract_patches(scene, coords, p))


def test_tileserver_writes_into_a_given_buffer_and_refuses_bad_input():
    scene = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    coords = tiling.grid_coords(64, 64, 32, 0.5)
    out = np.zeros((len(coords), 16, 16, 3), np.uint8)
    assert native.extract_resize_u8(scene, coords, 32, 16, 16, out=out) is out
    np.testing.assert_array_equal(out, native.extract_resize_u8(scene, coords, 32, 16, 16))
    for bad in ([[0, 40]], [[-1, 0]], [[33, 0]]):
        with pytest.raises(ValueError, match="outside"):
            native.extract_resize_u8(scene, np.array(bad), 32, 16, 16)
        with pytest.raises(ValueError, match="outside"):
            native.extract_u8(scene, np.array(bad), 32)
    with pytest.raises(ValueError, match="uint8"):
        native.extract_u8(scene.astype(np.float32), coords, 32)
    with pytest.raises(ValueError, match="out must be"):
        native.extract_resize_u8(scene, coords, 32, 16, 16, out=out[:, :8])


# ---------------------------------------------------------------------------
# the reference's tiling helpers
# ---------------------------------------------------------------------------


def test_patch_gen_and_post_process_equal_jax():
    img, lab = _scene(96, 80)
    got, want = tiling.patch_gen(img, lab, 32, 0.5), jax_tiling.patch_gen(img, lab, 32, 0.5)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 4 * 5 * 4
        for g_, w_ in zip(g_list, w_list):
            np.testing.assert_array_equal(g_, w_)
    x = np.random.default_rng(1).integers(0, 256, (40, 40)).astype(np.uint8)
    np.testing.assert_array_equal(tiling.post_process_resized_mask(x),
                                  jax_tiling.post_process_resized_mask(x))


@pytest.mark.parametrize("p,size", [(64, 32), (96, 32), (100, 37), (48, 64), (128, 64)])
def test_mask_convert_equals_jax(p, size):
    """cv2.resize of a 0/255 class mask against ``resize_linear``, every
    class and the unlabelled colour; the batched tensor version equals the
    per-patch loop."""
    _, lab = _scene(p, p, seed=p)
    patches = np.stack([lab, lab[::-1], lab[:, ::-1]])
    for c in range(4):
        want = np.stack([jax_tiling.mask_convert(m, c, size) for m in patches])
        got = np.stack([tiling.mask_convert(m, c, size) for m in patches])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tiling.mask_convert_tensor(torch.from_numpy(np.ascontiguousarray(patches)), c,
                                       size).numpy(), got)
    assert 0 < want.mean() < 255


def test_patch_merge_equals_jax():
    img, _ = _scene(96, 96)
    coords = tiling.grid_coords(96, 96, 64, 0.5)
    masks = list(np.random.default_rng(2).random((len(coords), 3, 32, 32)).astype(np.float32))
    got = tiling.patch_merge(img, masks, 64, {"num_classes": 3}, 0.5)
    want = jax_tiling.patch_merge(img, masks, 64, {"num_classes": 3}, 0.5)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


# ---------------------------------------------------------------------------
# scene files to tiles, the ground-truth branch, the pipelined forward
# ---------------------------------------------------------------------------


def test_get_patched_input_equals_jax(tmp_path):
    path, img, lab = _write_scene(tmp_path, "s0", 128, 128)
    for gt in (True, False):
        got = api.get_patched_input(path, CONFIG, gt, raw_uint8=True)
        want = jax_api.get_patched_input(path, CONFIG, gt, raw_uint8=True)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)
        assert got[1].dtype == np.uint8 and got[1].shape == (36, 32, 32, 3)
        y, x = tiling.grid_coords(128, 128, 64, 0.5)[5]
        np.testing.assert_array_equal(got[2][5], (lab if gt else img)[y:y + 64, x:x + 64])
    scene, tiles, masks = api.get_patched_input(path, CONFIG, True)
    _, jtiles, jmasks = jax_api.get_patched_input(path, CONFIG, True)
    np.testing.assert_array_equal(masks, jmasks)
    assert tiles.dtype == np.float32 and tiles.shape == jtiles.shape
    err = np.abs(tiles - jtiles).max()
    assert err <= 1e-6, err
    np.testing.assert_array_equal(scene, img)


def test_pipelined_scene_forward_matches(models):
    """Against the JAX package's pipelined forward (probabilities to 1e-5,
    merged masks bit for bit) and against the port's segmentation_inference
    on the tile server's tiles (masks bit for bit); quantized
    probabilities are floor(p·255) of the f32 ones."""
    jmodel, variables, port = models
    img, _ = _scene(128, 112, seed=4)
    probs, coords, p = api.pipelined_scene_forward(port, img, CONFIG, device="cpu")
    jprobs, jcoords, jp = jax_api.pipelined_scene_forward(jmodel, variables, img, CONFIG)
    np.testing.assert_array_equal(coords, jcoords)
    assert p == jp == 64 and probs.shape == (len(coords), 32, 32, 3) and len(coords) == 24
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-5)
    merged = tiling.merge_patches_device(probs, coords, 128, 112, p, 3, overlap=0.5).numpy()
    jmerged = jax_tiling.merge_patches_device(np.asarray(jprobs), coords, 128, 112, p, 3,
                                              overlap=0.5)
    np.testing.assert_array_equal(merged, jmerged)

    tiles, masks = api.patch_and_preprocess(img, img, CONFIG, raw_uint8=True)
    want, _ = api.segmentation_inference(port, img, tiles, masks, CONFIG, False, device="cpu")
    q, _, _ = api.pipelined_scene_forward(port, img, CONFIG, quantize_probs=True, device="cpu")
    assert q.dtype == torch.uint8
    torch.testing.assert_close(q, torch.floor(probs * 255.0).to(torch.uint8), rtol=0, atol=0)
    qmerged = tiling.merge_patches_device(q, coords, 128, 112, p, 3, overlap=0.5).numpy()
    for c in range(3):
        np.testing.assert_array_equal(merged[..., c], want[c])
        np.testing.assert_array_equal(qmerged[..., c], want[c])


class _Heads(torch.nn.Module):
    """Deep supervision's form: a list of heads, the last the output."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x)
        return (out * 0.5 - 3.0, out)


def test_list_output_takes_the_last_head_and_quantized_chunks(models):
    _, _, port = models
    tiles = np.random.default_rng(6).integers(0, 256, (35, 32, 32, 3)).astype(np.uint8)
    f32 = api._chunked_forward(port, tiles, device="cpu")
    heads = api._chunked_forward(_Heads(port), tiles, device="cpu")
    torch.testing.assert_close(heads, f32, rtol=0, atol=0)
    q = api._chunked_forward(port, tiles, device="cpu", quantize_probs=True)
    assert q.dtype == torch.uint8 and q.shape == f32.shape
    torch.testing.assert_close(q, torch.floor(f32 * 255.0).to(torch.uint8), rtol=0, atol=0)


def test_scene_patch_dataset_equals_jax(tmp_path):
    _write_scene(tmp_path, "a", 96, 80, seed=7)
    _write_scene(tmp_path, "b", 64, 64, seed=8)
    # a scene without labels reads its own pixels as the masks
    write_image(str(tmp_path / "c_image.png"), _scene(64, 72, seed=9)[0])
    args = (str(tmp_path / "*_image.png"), ".png", ".png", 3, 3, 32, 48, 0.5)
    ours = ScenePatchDataset(*args, transform=Compose([Normalize()]))
    theirs = JScenePatchDataset(*args, transform=JCompose([JNormalize()]))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        got, want = ours[i], theirs[i]
        for g_, w_ in zip(got[:4], want[:4]):
            assert g_.dtype == w_.dtype
            np.testing.assert_array_equal(g_, w_)
        assert got[4]["img_id"] == want[4]["img_id"]
        np.testing.assert_array_equal(got[4]["coords"], want[4]["coords"])
    raw = ScenePatchDataset(*args)[0][2]
    assert raw.dtype == np.float32 and raw.max() > 1
