"""The port's test-split and smoke-test entry points against the JAX
package, on the CPU: ``python -m ssunet_gan_tpu_torch.cli.val`` (``main``)
against the JAX package's ``cli.val.main`` on one model directory written
by the port (``SSUNet``'s card at 32² tiles, seeded weights and BatchNorm
statistics, saved bare and as a GAN generator's ``net.`` checkpoint), both
``--ss_unet_gan`` values, on a 32² test split; ``cli.smoke_test`` against
the JAX CLI; ``train.step.make_predict_fn`` against the JAX package's.

Tolerances: the CSV's file names equal and IoU / Dice within 1e-5 per
image (f32 forwards of two packages); the overlay file names equal and
each JPEG byte-equal wherever the two packages' masks agree (every file of
these runs); the smoke test's files byte for byte; the predict function's
logits within 1e-5 relative L2.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from ssunet_gan_tpu.cli import smoke_test as jax_smoke
from ssunet_gan_tpu.cli import val as jax_val
from ssunet_gan_tpu.train.step import make_predict_fn as jax_make_predict_fn
from ssunet_gan_tpu_torch.cli import smoke_test, val
from ssunet_gan_tpu_torch.config import dump_model_card
from ssunet_gan_tpu_torch.data.png import write_image
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models.gan import Generator
from ssunet_gan_tpu_torch.ops import spade_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.train.step import make_predict_fn
from torch_port_helpers import jax_toggles

NAME = "val_SSUNet"
CARD = {"name": NAME, "arch": "SSUNet", "num_classes": 3, "input_channels": 3,
        "deep_supervision": False, "input_h": 32, "input_w": 32, "batch_size": 4,
        "val_dataset": "tiny", "img_ext": ".png", "mask_ext": ".png", "num_workers": 1,
        "loss": "BCEDiceLoss"}
TEST_IDS = ("b02", "a00", "c01")  # listed out of order: the CSV sorts them
SCORE_TOL = 1e-5


def _clear_port_modes():
    spade_kernel.set_fused_spade(None)
    q8.set_int8_stage(False)
    q8.set_int8_calibration(None)
    q8.set_band_rows(None)


def _shape_init(model, key, *sample, train=True):
    """The JAX package's ``jit_init`` template as zeros of its shapes
    (``jax.eval_shape``: traced, not compiled); ``load_eval_model`` then
    fills every leaf from the checkpoint."""
    import jax

    shapes = jax.eval_shape(lambda k, *a: model.init(k, *a, train), key, *sample)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    monkeypatch.setattr(jax_val, "jit_init", _shape_init)
    _clear_port_modes()
    with jax_toggles(fused_stage=False):
        yield
    _clear_port_modes()


def _model():
    """SSUNet with seeded BN statistics, so the masks vary."""
    model = build_model("SSUNet", 3, seed=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """An experiment file, a model directory holding the card and a bare
    ``model.pth`` (a second one with the GAN generator's ``net.`` keys), a
    32² test split of three images with per-class masks, and a scene."""
    root = tmp_path_factory.mktemp("val")
    model = _model()
    for name, state in ((NAME, model.state_dict()),
                        (NAME + "_gan", {"net." + k: v for k, v in model.state_dict().items()})):
        model_dir = root / "models" / name
        dump_model_card(dict(CARD, name=name), str(model_dir))
        torch.save(state, model_dir / "model.pth")
    g = np.random.default_rng(5)
    for i, img_id in enumerate(TEST_IDS):
        yy, xx = np.mgrid[:32, :32]
        img = np.clip(np.stack([xx * 6, yy * 5 + i * 40, 255 - xx * 3], -1)
                      + g.integers(-30, 31, (32, 32, 3)), 0, 255).astype(np.uint8)
        d = root / "inputs" / "tiny"
        os.makedirs(d / "images" / "test", exist_ok=True)
        write_image(str(d / "images" / "test" / f"{img_id}.png"), img)
        for c in range(3):
            os.makedirs(d / "annotations" / "test" / str(c), exist_ok=True)
            mask = np.where(g.random((32, 32)) < 0.4, 255, 0).astype(np.uint8)
            write_image(str(d / "annotations" / "test" / str(c) / f"{img_id}.png"), mask)
    os.makedirs(root / "scenes")
    for name, (h, w) in (("a", (72, 64)), ("b", (64, 64))):
        scene = g.integers(0, 256, (h, w, 3)).astype(np.uint8)
        write_image(str(root / "scenes" / f"{name}_image.png"), scene)
    paths = {}
    for name in (NAME, NAME + "_gan"):
        path = root / f"{name}.json"
        with open(path, "w") as f:
            json.dump({"file_path": {"input_path": str(root / "inputs"),
                                     "model_path": str(root / "models"),
                                     "output_path": str(root / f"out_{name}")},
                       "opt_config": dict(CARD),
                       "val_config": {"name": name, "full_image_path": str(root / "scenes"),
                                      "gt_mask_flag": "False", "patch_overlap": 0.5}}, f)
        paths[name] = str(path)
    return root, paths, model


def _run(main_fn, argv, monkeypatch=None):
    if monkeypatch is None:
        return main_fn(argv)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    return main_fn()


def _outputs(out_dir, name):
    with open(os.path.join(out_dir, name + "_result.csv")) as f:
        text = f.read()
    files = {}
    for c in range(3):
        d = os.path.join(out_dir, name, str(c))
        files.update({f"{c}/{f}": open(os.path.join(d, f), "rb").read()
                      for f in sorted(os.listdir(d))})
    return text, files


@pytest.mark.parametrize("gan", [True, False], ids=["generator", "bare"])
def test_cli_val_matches_jax(experiment, monkeypatch, capsys, gan):
    """Both CLIs on one experiment file: the CSV's rows (sorted by file
    name, IoU / Dice within SCORE_TOL, pandas' text for the same floats),
    the overlays (file names equal, JPEGs byte-equal where the masks
    agree) and the printed means."""
    root, paths, _ = experiment
    name = NAME + "_gan" if gan else NAME
    out_dir = str(root / f"out_{name}")
    argv = ["--config", paths[name], "--ss_unet_gan", str(gan)]
    val.main(argv + ["--device", "cpu"])
    ours_text, ours_files = _outputs(out_dir, name)
    ours_out = capsys.readouterr().out
    _run(jax_val.main, argv, monkeypatch)
    theirs_text, theirs_files = _outputs(out_dir, name)
    theirs_out = capsys.readouterr().out

    ours_rows, theirs_rows = (list(csv.reader(t.splitlines())) for t in (ours_text, theirs_text))
    assert ours_rows[0] == theirs_rows[0] == ["filename", "iou", "dice"]
    assert [r[0] for r in ours_rows[1:]] == [r[0] for r in theirs_rows[1:]] == sorted(TEST_IDS)
    scores = np.array([[float(v) for v in r[1:]] for r in ours_rows[1:]])
    np.testing.assert_allclose(scores, [[float(v) for v in r[1:]] for r in theirs_rows[1:]],
                               rtol=0, atol=SCORE_TOL)
    assert 0 < scores[:, 0].min() and scores[:, 0].max() < 1  # the masks vary
    assert sorted(ours_files) == sorted(theirs_files) == sorted(
        f"{c}/{i}_{k}_masking.jpg" for c in (1, 2) for i in TEST_IDS for k in ("GT", "RE", "GT_RE"))
    assert ours_files == theirs_files
    for line in ("IoU: ", "dice: "):
        mine = [ln for ln in ours_out.splitlines() if ln.startswith(line)]
        assert mine == [ln for ln in theirs_out.splitlines() if ln.startswith(line)]
    # the port writes pandas' text for its own rows
    import pandas as pd

    df = pd.DataFrame([[r[0], float(r[1]), float(r[2])] for r in ours_rows[1:]][::-1],
                      columns=["filename", "iou", "dice"])
    assert df.sort_values("filename").to_csv(index=False) == ours_text


def test_csv_text_equals_pandas(tmp_path):
    import pandas as pd

    rows = [["z9", 0.1, 1e-05], ["a,b", 1.0, 0.30000000000000004], ["m", 2 / 3, 5e-324]]
    val.result_save_to_csv_filename(str(tmp_path / "ours.csv"), rows)
    df = pd.DataFrame(rows, columns=["filename", "iou", "dice"])
    df.sort_values("filename").to_csv(str(tmp_path / "pandas.csv"), index=False)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_load_eval_model(experiment, capsys):
    root, _, model = experiment
    folder = str(root / "models")
    gen, config = val.load_eval_model(folder, NAME + "_gan", True, "cpu")
    assert isinstance(gen, Generator) and not gen.training and config["name"] == NAME + "_gan"
    for k, v in model.state_dict().items():
        assert torch.equal(gen.state_dict()["net." + k], v)
    bare, _ = val.load_eval_model(folder, NAME, False, "cpu")
    assert not isinstance(bare, Generator)
    # a bare checkpoint read as a generator: strict=False, every tensor reported missing
    val.load_eval_model(folder, NAME, True, "cpu")
    assert "lacks" in capsys.readouterr().out
    os.makedirs(root / "models" / "orbax_only" / "model.orbax")
    dump_model_card(CARD, str(root / "models" / "orbax_only"))
    with pytest.raises(NotImplementedError, match="orbax"):
        val.load_eval_model(folder, "orbax_only", True, "cpu")


def test_cli_smoke_test_matches_jax(experiment, monkeypatch, capsys):
    """The first scene through both CLIs: the same overlay files, byte for
    byte."""
    root, paths, _ = experiment
    out = root / f"out_{NAME}" / NAME
    smoke_test.main(["--config", paths[NAME], "--device", "cpu"])
    assert "smoke test ok: a_image" in capsys.readouterr().out
    files = sorted(f for f in os.listdir(out) if f.startswith("a_image"))
    assert files == sorted(f"a_image_{c}_RE_masking.jpg" for c in (1, 2))
    blobs = {f: (out / f).read_bytes() for f in files}
    for f in files:
        os.remove(out / f)
    _run(jax_smoke.main, ["--config", paths[NAME]], monkeypatch)
    assert sorted(f for f in os.listdir(out) if f.startswith("a_image")) == files
    for f in files:
        assert (out / f).read_bytes() == blobs[f], f


def test_make_predict_fn_matches_jax(experiment):
    root, _, model = experiment
    _, variables, _ = jax_val.load_eval_model(str(root / "models"), NAME, False)
    jmodel = jax_val.build_model("SSUNet", 3, 3, False)
    x = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    predict = make_predict_fn(model)
    model.train()
    got = predict(x)
    assert not model.training and not got.requires_grad and got.device.type == "cpu"
    want = np.asarray(jax_make_predict_fn(jmodel)(variables, x))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_clis_default_to_the_card(experiment):
    _, paths, _ = experiment
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (val.main, smoke_test.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", paths[NAME]])
    assert val.parse_args(["--config", "x"]).device == "cuda"
    assert val.parse_args(["--config", "x"]).ss_unet_gan is True
    assert smoke_test.parse_args(["--config", "x"]).device == "cuda"
