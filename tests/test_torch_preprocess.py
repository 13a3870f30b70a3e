"""The port's preprocessing and tools against the JAX package, on the CPU:
``data/preprocess.py`` and the two preprocess CLIs (cv2 and sklearn in the
JAX package, numpy here), ``utils.py``, ``srgan_utils.py``'s "pil"
endpoints and ``ImageTransforms`` (PIL in the JAX package) and
``profiling.py``.

Tolerances: the scene split, the file trees and list files are equal; at
``img_size == patch_size`` every written PNG decodes equal bit for bit;
below it images are within one level (``resize_linear`` is within one
level of OpenCV's INTER_LINEAR) and masks equal on ≥ 99.9% of pixels,
flipping only where the two resizes straddle the 125 threshold (125 against
126); ``adjust_brightness`` within one level (``hsv_to_rgb`` is within one
level of OpenCV 5's HSV → RGB); the numpy bicubic and ``ImageTransforms``
equal PIL bit for bit.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.model_selection import train_test_split as sk_split

from ssunet_gan_tpu import profiling as jprofiling
from ssunet_gan_tpu import srgan_utils as jsrgan
from ssunet_gan_tpu import utils as jutils
from ssunet_gan_tpu.cli import preprocess_SN7 as jcli_sn7
from ssunet_gan_tpu.cli import preprocess_satellite as jcli_sat
from ssunet_gan_tpu.data import preprocess as jpre
from ssunet_gan_tpu_torch import profiling, srgan_utils, utils
from ssunet_gan_tpu_torch.cli import preprocess_SN7 as cli_sn7
from ssunet_gan_tpu_torch.cli import preprocess_satellite as cli_sat
from ssunet_gan_tpu_torch.data import preprocess as pre
from ssunet_gan_tpu_torch.data.png import read_image
from ssunet_gan_tpu_torch.data.transforms import hsv_to_rgb, resize_bicubic_pil, resize_linear

LABEL_BGR = np.array([(255, 255, 255), (255, 0, 0), (0, 0, 255), (30, 200, 90)], np.uint8)
MASK_AGREEMENT = 0.999  # masks resized below the patch size


# ---- the scene split ------------------------------------------------------------------


def test_split_scenes_equals_jax_and_sklearn():
    for n in range(2, 41):
        paths = [f"s{i:02d}_image.png" for i in range(n)]
        ours = pre.split_scenes(paths)
        assert ours == jpre.split_scenes(paths), n
        assert sorted(sum(ours, [])) == sorted(paths + (ours[1] if ours[1] == ours[2] else []))
        for size in (0.2, 0.5):
            train, test = sk_split(paths, test_size=size, random_state=41)
            assert pre.train_test_split(paths, size) == (train, test), (n, size)
    with pytest.raises(ValueError):
        jpre.split_scenes(["one_image.png"])
    with pytest.raises(ValueError, match="train set will be empty"):
        pre.split_scenes(["one_image.png"])


# ---- scenes on disk --------------------------------------------------------------------


def _scene(g, h, w):
    """A textured BGR scene: gradients plus noise."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 2 + yy, yy * 3, 200 - xx], -1)
    return np.clip(base + g.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _blocks(g, h, w, values, block=8):
    cls = g.integers(0, len(values), (h // block + 1, w // block + 1))
    return np.ascontiguousarray(values[cls].repeat(block, 0).repeat(block, 1)[:h, :w])


def _colour_scenes(root, n=7, hw=(64, 72)):
    g = np.random.default_rng(3)
    d = os.path.join(root, "town")
    os.makedirs(d)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"t{i}_image.png"), _scene(g, *hw))
        cv2.imwrite(os.path.join(d, f"t{i}_labels.png"), _blocks(g, *hw, LABEL_BGR))


def _sn7_scenes(root, n=6, hw=(64, 64)):
    """RGBA scenes (written BGRA, as SpaceNet-7's PNGs carry alpha) with
    per-class grayscale labels holding 0, 255 and levels in between."""
    g = np.random.default_rng(4)
    levels = np.array([0, 255, 255, 90, 200, 125, 126], np.uint8)
    os.makedirs(os.path.join(root, "SN7", "image"))
    for c in range(2):
        os.makedirs(os.path.join(root, "SN7", "label", str(c)))
    for i in range(n):
        bgra = np.dstack([_scene(g, *hw), g.integers(0, 256, hw).astype(np.uint8)])
        cv2.imwrite(os.path.join(root, "SN7", "image", f"mosaic_img_{i:03d}.png"), bgra)
        for c in range(2):
            cv2.imwrite(os.path.join(root, "SN7", "label", str(c), f"mosaic_label_{i:03d}.png"),
                        _blocks(g, *hw, levels, block=4))


def _tree(base):
    out = []
    for root, _, files in os.walk(base):
        out += [os.path.relpath(os.path.join(root, f), base) for f in files]
    return sorted(out)


def _compare_trees(ours, theirs, exact):
    """The same files; list files byte for byte; PNGs decoded equal
    (``exact``) or images within one level and masks ≥ MASK_AGREEMENT."""
    files = _tree(ours)
    assert files == _tree(theirs) and len(files) > 10
    worst, agree = 0, []
    for f in files:
        a, b = os.path.join(ours, f), os.path.join(theirs, f)
        if f.endswith(".txt"):
            with open(a) as x, open(b) as y:
                assert x.read() == y.read(), f
            continue
        pa, pb = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
        assert pa.shape == pb.shape and pa.dtype == pb.dtype == np.uint8, f
        if exact:
            np.testing.assert_array_equal(pa, pb, err_msg=f)
        elif f.startswith("images"):
            worst = max(worst, int(np.abs(pa.astype(int) - pb).max()))
        else:
            agree.append((pa == pb).mean())
    if not exact:
        assert worst <= 1, worst
        assert min(agree) >= MASK_AGREEMENT, min(agree)
    return files


def _flips_only_at_threshold(masks, size):
    """Each mask resized by cv2 and by ``resize_linear`` binarizes the same
    wherever the two values do not straddle 125 (125 against 126)."""
    flips = 0
    for m in masks:
        a, b = cv2.resize(m, (size, size)), resize_linear(m, size, size)
        assert np.abs(a.astype(int) - b).max() <= 1
        diff = pre.binarize_mask(a) != pre.binarize_mask(b)
        assert np.all(np.minimum(a, b)[diff] == 125) and np.all(np.maximum(a, b)[diff] == 126)
        flips += int(diff.sum())
    return flips


@pytest.mark.parametrize("img_size", [32, 24], ids=["equal-size", "resized"])
def test_colour_label_pipeline_equals_jax(tmp_path, capsys, img_size):
    for side in ("port", "jax"):
        _colour_scenes(str(tmp_path / side))
    args = ["--input-root", str(tmp_path / "port"), "--image-name", "town", "--patch-size",
            "32", "--img-size", str(img_size)]
    out = cli_sat.main(args)
    printed = capsys.readouterr().out
    theirs = jpre.preprocess_color_label_scenes(str(tmp_path / "jax"), "town", img_size, 32, 3)
    assert printed.splitlines() == capsys.readouterr().out.splitlines()[:3] + [f"wrote {out}"]
    files = _compare_trees(out, theirs, exact=img_size == 32)
    assert sum(f.startswith("images/") for f in files) == 7 * len(
        pre.preprocess_grid_coords(64, 72, 32))
    if img_size < 32:
        labels = [read_image(str(tmp_path / "port" / "town" / f"t{i}_labels.png"))
                  for i in range(7)]
        masks = [pre.color_class_mask(lab[y:y + 32, x:x + 32], c) for lab in labels
                 for (y, x) in pre.preprocess_grid_coords(64, 72, 32) for c in range(3)]
        _flips_only_at_threshold(masks, img_size)


@pytest.mark.parametrize("img_size", [32, 20], ids=["equal-size", "resized"])
def test_sn7_pipeline_equals_jax(tmp_path, img_size):
    for side in ("port", "jax"):
        _sn7_scenes(str(tmp_path / side))
    out = cli_sn7.main(["--input-root", str(tmp_path / "port"), "--patch-size", "32",
                        "--img-size", str(img_size)])
    theirs = jpre.preprocess_grayscale_label_scenes(str(tmp_path / "jax"), "SN7", img_size, 32)
    assert os.path.basename(out) == f"SN7_{img_size}"
    _compare_trees(out, theirs, exact=img_size == 32)
    if img_size < 32:
        label = read_image(str(tmp_path / "port" / "SN7" / "label" / "0" / "mosaic_label_000.png"),
                           gray=True)
        m = pre.binarize_mask(label)
        _flips_only_at_threshold([m[y:y + 32, x:x + 32] for (y, x)
                                  in pre.preprocess_grid_coords(64, 64, 32, 0.5)], img_size)


def test_grid_binarize_and_colour_decode_equal_jax():
    g = np.random.default_rng(0)
    for args in ((600, 700, 256, 0.5), (1024, 1024, 512, 1.0), (64, 72, 32, 1.0)):
        assert pre.preprocess_grid_coords(*args) == jpre.preprocess_grid_coords(*args)
    m = g.integers(0, 256, (40, 40)).astype(np.uint8)
    np.testing.assert_array_equal(pre.binarize_mask(m), jpre.binarize_mask(m))
    lab = _blocks(g, 40, 40, LABEL_BGR, block=4)
    for c in range(4):
        np.testing.assert_array_equal(pre.color_class_mask(lab, c), jpre.color_class_mask(lab, c))


def test_read_image_equals_cv2_on_the_preprocess_inputs(tmp_path):
    """cv2.imread (colour: alpha dropped) and IMREAD_GRAYSCALE of RGBA, RGB,
    gray + alpha and gray PNGs: ``read_image`` equals both."""
    g = np.random.default_rng(6)
    arrays = {"bgra": g.integers(0, 256, (9, 13, 4)), "bgr": g.integers(0, 256, (9, 13, 3)),
              "gray": g.integers(0, 256, (9, 13))}
    for name, a in arrays.items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, a.astype(np.uint8))
        np.testing.assert_array_equal(read_image(path), cv2.imread(path), err_msg=name)
        np.testing.assert_array_equal(read_image(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=name)
    # gray + alpha through PIL (cv2 writes no LA PNG)
    path = str(tmp_path / "la.png")
    Image.fromarray(g.integers(0, 256, (9, 13, 2)).astype(np.uint8), "LA").save(path)
    np.testing.assert_array_equal(read_image(path), cv2.imread(path))
    np.testing.assert_array_equal(read_image(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("argv", [[], ["--input-root", "in", "--image-name", "x",
                                         "--img-size", "256", "--stride-frac", "0.25"]],
                         ids=["defaults", "given"])
def test_cli_arguments_equal_jax(monkeypatch, argv):
    """Each CLI hands its pipeline the arguments the JAX CLI hands its own."""
    for port_cli, jax_cli, fn in ((cli_sat, jcli_sat, "preprocess_color_label_scenes"),
                                  (cli_sn7, jcli_sn7, "preprocess_grayscale_label_scenes")):
        calls = []
        for mod in (port_cli, jax_cli):
            monkeypatch.setattr(mod, fn, lambda *a: calls.append(a) or "out")
        port_cli.main(argv)
        monkeypatch.setattr(sys, "argv", ["cli"] + argv)
        jax_cli.main()
        assert len(calls) == 2 and calls[0] == calls[1], calls


# ---- utils ------------------------------------------------------------------------------


def test_average_meter_and_str2bool_equal_jax():
    ours, theirs = utils.AverageMeter(), jutils.AverageMeter()
    for v, n in ((0.5, 1), (np.float32(0.25), 3), (torch.tensor(1.5), 2)):
        ours.update(v, n)
        theirs.update(float(v), n)
    assert (ours.val, ours.avg, ours.sum, ours.count) == \
        (theirs.val, theirs.avg, theirs.sum, theirs.count)
    for v in (True, False, "true", "TRUE", "1", "false", "0", "False"):
        assert utils.str2bool(v) == jutils.str2bool(v)
    for pkg in (utils, jutils):
        with pytest.raises(Exception, match="Boolean value expected"):
            pkg.str2bool("maybe")


@pytest.mark.parametrize("target_v", [90, 160])
def test_adjust_brightness_within_one_level_of_jax(target_v):
    """BGR in and out: within one level of the JAX package's cv2 version.
    The shifted HSV image is cv2's bit for bit (the port's output is
    ``hsv_to_rgb`` of cv2's own shifted HSV), so the one level is
    ``hsv_to_rgb``'s documented distance from OpenCV 5's HSV → RGB."""
    g = np.random.default_rng(target_v)
    img = np.clip(_scene(g, 48, 40).astype(int) + g.integers(-60, 61, (48, 40, 3)), 0,
                  255).astype(np.uint8)
    ours, theirs = utils.adjust_brightness(img, target_v), jutils.adjust_brightness(img, target_v)
    assert ours.shape == img.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - theirs).max() <= 1
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    v = hsv[..., 2]
    hsv[..., 2] = np.clip(np.round(v.astype(np.float64) + target_v - float(np.average(v))), 1,
                          255).astype(np.uint8)
    np.testing.assert_array_equal(ours, hsv_to_rgb(hsv)[..., ::-1])


# ---- srgan_utils -----------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((96, 96, 3), (24, 24)), ((100, 60, 3), (25, 15)),
                                        ((37, 53, 3), (9, 13)), ((33, 45), (11, 15)),
                                        ((20, 30, 3), (40, 60)), ((17, 17, 3), (17, 5))])
def test_resize_bicubic_pil_equals_pil(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic_pil(img, *size), want)


@pytest.mark.parametrize("split", ["train", "test"])
def test_image_transforms_equal_jax(split):
    """Both splits against the JAX class (PIL crop and bicubic) on HWC
    arrays and PIL images of the same pixels, one seed: the same crops,
    the LR and HR outputs equal."""
    g = np.random.default_rng(8)
    kinds = [("[0, 1]", "[-1, 1]"), ("imagenet-norm", "[0, 255]"), ("pil", "pil")]
    ours = [srgan_utils.ImageTransforms(split, 24, 4, lr, hr, seed=5) for lr, hr in kinds]
    theirs = [jsrgan.ImageTransforms(split, 24, 4, lr, hr, seed=5) for lr, hr in kinds]
    for shape in ((50, 61, 3), (43, 40, 3)):
        img = _scene(g, *shape[:2])
        for o, t, (lr_t, _) in zip(ours, theirs, kinds):
            (lo, ho), (lt, ht) = o(img), t(Image.fromarray(img))
            lt, ht = np.asarray(lt), np.asarray(ht)
            assert lo.shape == lt.shape and ho.shape == ht.shape
            if lr_t == "pil":
                assert lo.dtype == np.uint8
            np.testing.assert_allclose(lo, lt, rtol=0, atol=1e-6)
            np.testing.assert_allclose(ho, ht, rtol=0, atol=1e-6)
        if split == "test":
            assert ho.shape[:2] == (shape[0] // 4 * 4, shape[1] // 4 * 4)


def test_convert_image_pil_endpoints_round_trip():
    g = np.random.default_rng(9)
    img = g.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    for fmt in ("[0, 1]", "[-1, 1]"):
        mid = srgan_utils.convert_image(img, "pil", fmt)
        np.testing.assert_allclose(mid, jsrgan.convert_image(Image.fromarray(img), "pil", fmt),
                                   rtol=0, atol=1e-6)
        back = srgan_utils.convert_image(mid, fmt, "pil")
        assert np.abs(back.astype(int) - img).max() <= 1 and back.dtype == np.uint8
    gray = img[..., 0]
    assert srgan_utils.convert_image(gray, "pil", "[0, 1]").shape == (12, 10, 1)
    np.testing.assert_array_equal(
        srgan_utils.convert_image(srgan_utils.convert_image(gray, "pil", "[0, 1]"), "[0, 1]",
                                  "pil"), gray)


# ---- profiling --------------------------------------------------------------------------


def test_step_timer_counts():
    ours, theirs = profiling.StepTimer(), jprofiling.StepTimer()
    for n in (8, 8, 3):
        ours.update(n)
        theirs.update(n)
    assert (ours.steps, ours.items) == (theirs.steps, theirs.items) == (3, 19)
    assert ours.elapsed > 0 and ours.items_per_sec > 0 and ours.steps_per_sec > 0
    ours.reset()
    assert (ours.steps, ours.items) == (0, 0)


def test_trace_writes_a_chrome_trace_and_time_fn_times(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("port-span"):
            (x @ x).sum()
    path = tmp_path / "trace" / profiling.TRACE_FILE
    assert path.is_file() and b"port-span" in path.read_bytes()
    assert any(e.key == "port-span" for e in prof.key_averages())
    t = profiling.time_fn(lambda a: [a @ a, {"s": a.sum()}], x, iters=3, warmup=2)
    assert set(t) == {"compile_s", "mean_s", "per_sec"} and t["mean_s"] > 0
    assert t["per_sec"] == pytest.approx(1.0 / t["mean_s"])
