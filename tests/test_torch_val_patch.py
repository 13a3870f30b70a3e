"""The port's whole-scene entry point against the JAX package, on the CPU:
``load_segmentation_models`` (model cards and ``model.pth`` written by the
port, the GAN generator's checkpoint, the card's mode keys, the
directories it refuses), the overlay writers, and
``python -m ssunet_gan_tpu_torch.cli.val_patch`` (``main``) against the JAX
package's ``cli.val_patch.main`` on the same files.

The model is ``SSUNet`` at 32² tiles (its full widths); scenes are at most
96 pixels a side, so the reference's 1024 patch is clamped to the scene.
Forwards agree to 1e-5 in f32 (probabilities), overlays byte for byte.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ssunet_gan_tpu.cli import val_patch as jax_val_patch
from ssunet_gan_tpu.infer import api as jax_api
from ssunet_gan_tpu.infer import overlays as jax_overlays
from ssunet_gan_tpu.ops import spade_kernel as jax_spade_kernel
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jax_stage_kernel_int8
from ssunet_gan_tpu_torch.cli import val_patch
from ssunet_gan_tpu_torch.config import dump_model_card
from ssunet_gan_tpu_torch.data.png import write_image
from ssunet_gan_tpu_torch.infer import api, overlays
from ssunet_gan_tpu_torch.infer.calibrate import save_calibration
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models.gan import Generator
from ssunet_gan_tpu_torch.ops import spade_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.train.checkpoint import save_model
from torch_port_helpers import jax_toggles

NAME = "scenes_SSUNet"
CARD = {"name": NAME, "arch": "SSUNet", "num_classes": 3, "input_channels": 3,
        "deep_supervision": False, "input_h": 32, "input_w": 32, "patch_size": 1024,
        "batch_size": 8, "loss": "BCEDiceLoss"}
COLOURS = np.array([(255, 255, 255), (255, 0, 0), (0, 0, 255), (40, 90, 10)], np.uint8)


def _clear_port_modes():
    spade_kernel.set_fused_spade(None)
    q8.set_int8_stage(False)
    q8.set_int8_calibration(None)
    q8.set_band_rows(None)


@pytest.fixture(autouse=True)
def _modes():
    """JAX modes set and restored (its loader sets them from the card); the
    port's SPADE, int8 and band modes cleared before and after."""
    _clear_port_modes()
    with jax_toggles(fused_stage=False):
        yield
    _clear_port_modes()


def _model(seed=0):
    """SSUNet with seeded BN statistics, so the masks vary."""
    model = build_model("SSUNet", 3, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model


def _experiment(root, card=None, state=None, model=None, gt="True"):
    """An experiment file under ``root`` whose model directory holds the
    card and ``model.pth`` (``state`` instead of the model's own)."""
    model_dir = os.path.join(str(root), "models", NAME)
    dump_model_card(dict(CARD, **(card or {})), model_dir)
    model = model if model is not None else _model()
    if state is None:
        save_model(model_dir, model)
    else:
        torch.save(state, os.path.join(model_dir, "model.pth"))
    path = os.path.join(str(root), "experiment.json")
    with open(path, "w") as f:
        json.dump({"file_path": {"model_path": os.path.join(str(root), "models"),
                                 "output_path": os.path.join(str(root), "out")},
                   "opt_config": dict(CARD),
                   "val_config": {"name": NAME, "full_image_path": os.path.join(str(root), "scenes"),
                                  "gt_mask_flag": gt, "patch_overlap": 0.5}}, f)
    return path, model_dir, model


def _jax_probs(jmodel, variables, tiles):
    return np.asarray(jax_api._chunked_forward(jmodel, variables, tiles, False))


def _tiles(n=4, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_load_segmentation_models_matches_jax(tmp_path, capsys):
    path, _, model = _experiment(tmp_path)
    port, config = api.load_segmentation_models(path, device="cpu")
    jmodel, variables, jconfig = jax_api.load_segmentation_models(path)
    assert config == jconfig
    assert config["patch_size"] == 1024 and config["patch_overlap"] == 0.5
    assert config["name"] == NAME and not port.training
    for k, v in model.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0)
    tiles = _tiles()
    probs = api._chunked_forward(port, tiles, device="cpu").numpy()
    np.testing.assert_allclose(probs, _jax_probs(jmodel, variables, tiles), rtol=0, atol=1e-5)
    assert 0.02 < probs.std()
    assert "arch: SSUNet" in capsys.readouterr().out


def test_gan_generator_checkpoint(tmp_path, capsys):
    """A ``net.``-prefixed ``model.pth`` loads as ``Generator``; the JAX
    package, from the bare checkpoint, forwards the same tiles."""
    model = _model(seed=4)
    state = {"net." + k: v for k, v in model.state_dict().items()}
    path, model_dir, _ = _experiment(tmp_path, state=state, model=model)
    port, _ = api.load_segmentation_models(path, device="cpu")
    assert isinstance(port, Generator) and "GAN generator" in capsys.readouterr().out
    save_model(model_dir, model)  # the JAX package reads the bare names
    jmodel, variables, _ = jax_api.load_segmentation_models(path)
    tiles = _tiles(seed=5)
    np.testing.assert_allclose(api._chunked_forward(port, tiles, device="cpu").numpy(),
                               _jax_probs(jmodel, variables, tiles), rtol=0, atol=1e-5)


def test_card_keys_set_the_modes(tmp_path, capsys):
    """``fused_spade``, ``int8`` (with ``int8_scales.json``) and
    ``band_rows`` become the port's modes as the JAX package's loader sets
    its own; ``seg_stack`` is read and ignored."""
    keys = {"fused_spade": True, "int8": True, "band_rows": 16, "seg_stack": True}
    path, model_dir, _ = _experiment(tmp_path, card=keys)
    scales = {"conv0_0:0": 2.5, "conv1_0:0": 4.0}
    save_calibration(model_dir, scales)
    api.load_segmentation_models(path, device="cpu")
    assert "seg_stack True ignored" in capsys.readouterr().out
    assert spade_kernel.fused_spade_mode() == "fast"
    assert q8.int8_stage_enabled() and q8.int8_calibration() == scales
    assert q8._BAND_ROWS == 16 and q8.band_rows(64) == 16 and q8.band_rows(24) == 8
    jax_api.load_segmentation_models(path)
    assert (jax_spade_kernel.fused_spade_mode(), jax_stage_kernel_int8.int8_stage_enabled(),
            jax_stage_kernel_int8.int8_calibration(), jax_stage_kernel._BAND_ROWS,
            jax_stage_kernel._SEG_STACK) == ("fast", True, scales, 16, True)
    _clear_port_modes()
    assert (spade_kernel.fused_spade_mode(), q8.int8_stage_enabled(), q8.int8_calibration(),
            q8._BAND_ROWS, q8.band_rows(64)) == ("off", False, None, None, 64)
    # a card that turns them off
    path, _, _ = _experiment(tmp_path / "off", card={"fused_spade": False, "int8": False,
                                                     "band_rows": None})
    q8.set_band_rows(32)
    api.load_segmentation_models(path, device="cpu")
    assert (spade_kernel.fused_spade_mode(), q8.int8_stage_enabled(),
            q8._BAND_ROWS) == ("off", False, None)


def test_refused_model_directories(tmp_path):
    path, model_dir, _ = _experiment(tmp_path)
    os.remove(os.path.join(model_dir, "model.pth"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        api.load_segmentation_models(path, device="cpu")
    os.makedirs(os.path.join(model_dir, "model.orbax"))
    with pytest.raises(NotImplementedError, match="tools/torch_from_orbax.py"):
        api.load_segmentation_models(path, device="cpu")


def test_overlay_writers_equal_jax(tmp_path):
    g = np.random.default_rng(0)
    img = np.clip(np.mgrid[:37, :53].sum(0)[..., None] * [3, 1, 2] + g.integers(-9, 10, (37, 53, 3)),
                  0, 255).astype(np.uint8)
    gt = np.where(g.random((37, 53)) < 0.4, 255, 0).astype(np.uint8)
    out = np.where(g.random((37, 53)) < 0.5, 255, 0).astype(np.uint8)
    for name in ("save_masking", "save_masking_RE", "save_masking_GT"):
        ours, theirs = str(tmp_path / f"{name}_p.jpg"), str(tmp_path / f"{name}_j.jpg")
        getattr(overlays, name)(img.copy(), gt, out, ours)
        getattr(jax_overlays, name)(img.copy(), gt, out, theirs)
        with open(ours, "rb") as f, open(theirs, "rb") as h:
            assert f.read() == h.read(), name
    meta = {"img_id": ["t0", "t1"]}
    imgs = np.stack([img, img[::-1]])
    for pkg, root in ((overlays, tmp_path / "p"), (jax_overlays, tmp_path / "j")):
        os.makedirs(root / "m" / "2")
        pkg.save_gt_re_mask(str(root), {"name": "m"}, meta, 2, 1, imgs, gt, out)
    files = sorted(os.listdir(tmp_path / "p" / "m" / "2"))
    assert files == sorted(os.listdir(tmp_path / "j" / "m" / "2")) and len(files) == 3
    for f in files:
        assert (tmp_path / "p" / "m" / "2" / f).read_bytes() == \
            (tmp_path / "j" / "m" / "2" / f).read_bytes()


def _scenes(root):
    g = np.random.default_rng(11)
    os.makedirs(root)
    for name, (h, w) in (("a", (96, 80)), ("b", (64, 72))):
        yy, xx = np.mgrid[:h, :w]
        img = np.clip(np.stack([xx * 3, yy * 2 + xx, 255 - yy], -1) + g.integers(-15, 16, (h, w, 3)),
                      0, 255).astype(np.uint8)
        lab = COLOURS[g.integers(0, 4, (h // 8 + 1, w // 8 + 1))].repeat(8, 0).repeat(8, 1)
        write_image(os.path.join(root, f"{name}_image.png"), img)
        write_image(os.path.join(root, f"{name}_labels.png"), np.ascontiguousarray(lab[:h, :w]))


def test_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on one experiment file: the same overlay files, byte for
    byte (the tile server's tiles, the forward's masks, the labels' masks
    through cv2.resize and resize_linear, the JPEG encoders)."""
    path, _, _ = _experiment(tmp_path)
    _scenes(str(tmp_path / "scenes"))
    val_patch.main(["--config", path, "--device", "cpu"])
    ours = tmp_path / "out" / NAME
    files = sorted(os.listdir(ours))
    assert files == sorted(f"{s}_image_{c}_{k}_masking.jpg" for s in "ab" for c in (1, 2)
                           for k in ("GT", "RE", "GT_RE"))
    blobs = {f: (ours / f).read_bytes() for f in files}
    for f in files:
        os.remove(ours / f)
    monkeypatch.setattr(sys, "argv", ["val_patch", "--config", path])
    jax_val_patch.main()
    assert sorted(os.listdir(ours)) == files
    for f in files:
        assert (ours / f).read_bytes() == blobs[f], f
    assert blobs[files[0]].startswith(b"\xff\xd8") and blobs[files[0]].endswith(b"\xff\xd9")


def test_cli_defaults_to_the_card(tmp_path):
    path, _, _ = _experiment(tmp_path, gt="False")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        val_patch.main(["--config", path])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_segmentation_models(path)
