"""``tools/torch_accuracy_bar.py`` (the port's accuracy bars) against the
JAX package's ``tools/accuracy_bar.py``, on the CPU.

- The city scenes: the JAX tool's ``_make_city_dataset`` (cv2) and the
  port's ``make_city_dataset`` (``data/png.py``) at n = 4, 64², easy and
  ``hard``: the same files, each decoding to the same array.
- The f32-unfused tile row and scene row on the same weights (a narrow
  flagship, filters 8..64, drawn from seeded numpy on the JAX model's
  shapes and carried to the port by ``from_jax_variables``) against the JAX
  package's own ``model.apply``, ``iou_score`` / ``dice_coef``,
  ``grid_coords``, ``_get_forward`` and ``merge_patches_device``, as the JAX
  tool's bodies run them: IoU and Dice within 1e-5.
- The bars and the exit code on planted rows; ``main`` end to end at a
  tiny size (narrow filters); the tool's flags; and that importing it loads
  no JAX, cv2 or JAX package module.
"""

import importlib.util
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.data.dataset import SegmentationDataset as JaxDataset
from ssunet_gan_tpu.data.tiling import grid_coords as jax_grid_coords
from ssunet_gan_tpu.data.tiling import merge_patches_device as jax_merge
from ssunet_gan_tpu.data.transforms import val_transform as jax_val_transform
from ssunet_gan_tpu.infer.api import INFER_BATCH, _get_forward
from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops.metrics import dice_coef as jax_dice
from ssunet_gan_tpu.ops.metrics import iou_score as jax_iou
from ssunet_gan_tpu_torch import models as port_models
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from torch_port_helpers import jax_toggles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = (8, 16, 32, 48, 64, 64)
SIZE = 64
SCORE_TOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tool = _load("torch_accuracy_bar")


@pytest.fixture(autouse=True)
def _modes():
    # two torch threads: beside the suite's other workers more threads
    # oversubscribe the cores (measured: main end to end 6 s alone, ~300 s so)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    stage_kernel.set_fused_stage(None)
    q8.set_int8_stage(False)
    q8.set_int8_calibration(None)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("hard", [False, True])
def test_city_scenes_equal_jax(tmp_path, hard):
    _load("accuracy_bar")._make_city_dataset(str(tmp_path / "jax"), "city", 4, SIZE, hard=hard)
    tool.make_city_dataset(str(tmp_path / "port"), "city", 4, SIZE, hard=hard)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    assert len(files) == 4 * (4 + 1 + 1)  # an image and three masks per scene
    for f in files:
        want = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "port" / f), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape and np.array_equal(got, want), f


def _seeded_variables(model, x, seed):
    """JAX variables of ``model`` on ``x`` drawn from seeded numpy on the
    shapes of ``jax.eval_shape`` (nothing compiled): kernels U(±1/√fan_in),
    biases 0.1·N, BN scales 1 + 0.2·N, means 0.3·N, variances U(0.5, 1.5)."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, False))

    def draw(path, s):
        leaf = str(path[-1].key)
        if leaf == "kernel":
            bound = 1 / np.sqrt(np.prod(s.shape[:-1]))
            v = g.uniform(-bound, bound, s.shape)
        elif leaf == "scale":
            v = 1 + 0.2 * g.normal(size=s.shape)
        elif leaf in ("bias", "mean"):
            v = (0.1 if leaf == "bias" else 0.3) * g.normal(size=s.shape)
        elif leaf == "var":
            v = g.random(s.shape) + 0.5
        else:
            raise AssertionError(f"no draw for {jax.tree_util.keystr(path)}")
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """The narrow flagship in both packages on one set of weights, and the
    city scenes (n = 8: two validation tiles) at 64²."""
    root = str(tmp_path_factory.mktemp("city"))
    tool.make_city_dataset(os.path.join(root, "inputs"), "city", 8, SIZE, hard=True)
    model = jax_ssunet.UNetRSSv2(num_classes=3, filters=FILTERS)
    variables = _seeded_variables(model, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), 11)
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables, target=port))
    return root, model, variables, port


def test_f32_unfused_tile_row_matches_jax(same_weights):
    root, model, variables, port = same_weights
    opt = tool.options(SIZE, 1)
    val_ds = tool.split_set(root, opt)
    assert len(val_ds) == 2
    got = tool.evaluate(port, val_ds, "f32-unfused", torch.float32, False, False, "cpu")

    split = os.path.join(root, "inputs", "city")
    jds = JaxDataset(img_ids=val_ds.img_ids, img_dir=os.path.join(split, "images", "validation"),
                     mask_dir=os.path.join(split, "annotations", "validation"), img_ext=".png",
                     mask_ext=".png", num_classes=3, transform=jax_val_transform(opt))
    with jax_toggles(fused_stage=False):  # the JAX tool's evaluate body, int8 off
        fwd = jax.jit(lambda vs, x: model.apply(vs, x, False))
        ious, dices = [], []
        for i in range(len(jds)):
            item = jds[i]
            logits = fwd(variables, jnp.asarray(item[1][None], jnp.float32)).astype(jnp.float32)
            y = jnp.asarray(item[2][None], jnp.float32)
            ious.append(float(jax_iou(logits[..., 1:], y[..., 1:])))
            dices.append(float(jax_dice(logits[..., 1:], y[..., 1:])))
    assert 0.01 < float(np.mean(ious)) < 0.99  # the masks are not constant
    assert abs(got[1] - float(np.mean(ious))) <= SCORE_TOL, (got, ious)
    assert abs(got[2] - float(np.mean(dices))) <= SCORE_TOL, (got, dices)


def test_f32_unfused_scene_row_matches_jax(same_weights):
    root, model, variables, port = same_weights
    val_ds = tool.split_set(root, tool.options(SIZE, 1))
    inputs = tool.scene_inputs(val_ds, SIZE)
    scene, gt, coords, patches = inputs
    assert scene.shape == (4 * SIZE, 4 * SIZE, 3) and len(coords) == 4 * 7 * 7
    np.testing.assert_array_equal(coords, jax_grid_coords(4 * SIZE, 4 * SIZE, SIZE, 0.5))
    got = tool.scene_iou(port, inputs, "scene f32-unfused", torch.float32, False, False, "cpu")

    with jax_toggles(fused_stage=False):  # the JAX tool's _scene_bars run(), f32-unfused
        fwd, dev_vars = _get_forward(model, variables, None, normalize=True, dtype=None,
                                     quantize_probs=True)
        pad = (-len(patches)) % INFER_BATCH
        pp = np.concatenate([patches, np.zeros_like(patches[:pad])]) if pad else patches
        probs = jnp.concatenate([fwd(dev_vars, jnp.asarray(pp[i:i + INFER_BATCH]))
                                 for i in range(0, len(pp), INFER_BATCH)])[:len(patches)]
        merged = np.asarray(jax_merge(probs, coords, scene.shape[0], scene.shape[1], SIZE, 3,
                                      overlap=0.5))
    ious = []
    for c in range(1, 3):
        p_, g_ = merged[..., c] > 0, gt[..., c] > 0
        ious.append(((p_ & g_).sum() + 1e-5) / ((p_ | g_).sum() + 1e-5))
    assert 0.01 < float(np.mean(ious)) < 0.99
    assert abs(got[1] - float(np.mean(ious))) <= SCORE_TOL, (got, ious)


def test_splits_and_a_subset_of_tile_rows(same_weights):
    """``split_set`` reads each split the scenes hold; ``tile_rows(rows=)``
    scores the rows asked for, then the calibrated one, each equal to its
    own ``evaluate``, and clears the calibration it installed."""
    root, _, _, port = same_weights
    opt = tool.options(SIZE, 1)
    assert [len(tool.split_set(root, opt, s)) for s in ("training", "validation", "test")] \
        == [8, 2, 2]
    val_ds = tool.split_set(root, opt)
    got = tool.tile_rows(port, val_ds, "cpu", rows=tool.TILE_ROWS[2:3])
    assert [r[0] for r in got] == [tool.TILE_ROWS[2][0], tool.CALIBRATED[0]]
    assert got[0] == tool.evaluate(port, val_ds, *tool.TILE_ROWS[2], device="cpu")
    assert q8.int8_calibration() is None and not q8.int8_stage_enabled()


@pytest.mark.parametrize("dyn, cal, scene, rc", [
    (0.004, 0.006, None, 0),  # the better int8 row decides
    (0.006, -0.0049, None, 0),
    (0.0051, -0.006, None, 1),
    (0.0, 0.0, 0.0049, 0),
    (0.0, 0.0, -0.0051, 1),
])
def test_bars_and_exit_code(capsys, dyn, cal, scene, rc):
    base = 0.7
    rows = [("f32", base, 0.8), ("bf16", base - 0.01, 0.8), ("bf16-fused", base + 0.02, 0.8),
            ("int8 dyn", base + dyn, 0.8), ("int8 cal", base + cal, 0.8)]
    got = tool.tile_bars(rows)
    if scene is not None:
        got = max(got, tool.scene_bars([("s f32", base), ("s bf16", base + 0.1),
                                        ("s int8", base + scene)]))
    assert got == rc
    out = capsys.readouterr().out
    assert out.count("| int8") == 2 and "bf16-fused IoU delta: 0.0200" in out


def test_main_end_to_end(tmp_path, monkeypatch, capsys):
    """``main`` at a tiny size on the CPU, a narrow flagship: it trains,
    reloads the best model.pth, prints five tile and three scene rows, and
    returns the code its rows give."""
    build = port_models.build_model
    monkeypatch.setattr(port_models, "build_model",
                        lambda arch, *a, **kw: build(arch, *a, **{"filters": FILTERS, **kw}))
    rows = {"tile": [], "scene": []}

    def kept(fn, kind):
        def run(*args, **kwargs):
            rows[kind].append(fn(*args, **kwargs))
            return rows[kind][-1]
        return run

    monkeypatch.setattr(tool, "evaluate", kept(tool.evaluate, "tile"))
    monkeypatch.setattr(tool, "scene_iou", kept(tool.scene_iou, "scene"))
    root = tmp_path / "acc"
    rc = tool.main(["--epochs", "1", "--n", "8", "--size", str(SIZE), "--scene",
                    "--device", "cpu", "--root", str(root)])
    out = capsys.readouterr().out
    assert len(rows["tile"]) == 5 and len(rows["scene"]) == 3
    assert [r[0] for r in rows["tile"]] == [r[0] for r in tool.TILE_ROWS] + [tool.CALIBRATED[0]]
    for label, *_ in rows["tile"] + rows["scene"]:
        assert f"| {label} |" in out
    assert (root / "models" / "accuracy_bar" / "model.pth").is_file()
    base, t = rows["tile"][0][1], rows["tile"]
    want = int(min(abs(t[3][1] - base), abs(t[4][1] - base)) > tool.INT8_BAR
               or abs(rows["scene"][2][1] - rows["scene"][0][1]) > tool.INT8_BAR)
    assert rc == want
    # the toggles are back at their defaults
    assert stage_kernel.fused_stage_enabled() and not q8.int8_stage_enabled()
    assert q8.int8_calibration() is None


def test_flags_and_device(monkeypatch):
    args = tool.parse_args([])
    assert (args.epochs, args.n, args.size, args.skip_train, args.hard, args.scene,
            args.device) == (12, 48, 256, False, False, False, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--root", "unused"])


def test_import_loads_no_jax_or_cv2():
    path = os.path.join(ROOT, "tools", "torch_accuracy_bar.py")
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', {path!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'ssunet_gan_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
