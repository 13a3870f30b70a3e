"""The port's supervised training entry point (on the CPU) against the JAX
package: the PNG codec against cv2, ``SegmentationDataset``, the cv2-free
train augmentations against the JAX package's cv2 classes, model cards
across both packages with and without PyYAML, checkpoints and resume,
``accum_steps``, ``remat``, ``run_experiment`` and
``python -m ssunet_gan_tpu_torch.cli.train``.

Tolerances: the PNG codec and the datasets bit for bit (integer decoding);
``Rotate`` within one level everywhere and its mask differing on at most
0.1% of the pixels (cv2's float warp rounds a coordinate at .5 either
way); ``HueSaturationValue`` and ``Resize`` within one level, ``Resize``'s
masks equal; ``train_transform`` within the sum of those bars after its
brightness/contrast step (below); ``accum_steps`` to the bars of
tests/test_torch_train.py; ``remat`` gradients to 1e-6 (the same f32
arithmetic, recomputed).
"""

import copy
import csv
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu import config as jconfig
from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.data import dataset as jdataset
from ssunet_gan_tpu.data import transforms as jtransforms
from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch import config as pconfig
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.data import dataset as pdataset
from ssunet_gan_tpu_torch.data import png
from ssunet_gan_tpu_torch.data import transforms as ptransforms
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import blocks, losses
from ssunet_gan_tpu_torch.ops import spade_kernel
from ssunet_gan_tpu_torch.train import checkpoint as ckpt
from ssunet_gan_tpu_torch.train import optim
from ssunet_gan_tpu_torch.train import supervised
from ssunet_gan_tpu_torch.train.step import make_train_step
from torch_port_helpers import jax_toggles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "config_v1.json")


@pytest.fixture(autouse=True)
def _modes():
    """JAX modes set and restored; the port's remat and SPADE modes, which
    ``run_experiment`` sets from the config, cleared after."""
    with jax_toggles(fused_stage=False):
        yield
    blocks.set_remat(False)
    spade_kernel.set_fused_spade(None)


# ---- PNG ---------------------------------------------------------------------


def _filters(path):
    """The scanline filter types of a PNG file's rows."""
    with open(path, "rb") as f:
        data = f.read()
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    w, h, _, ctype = png.struct.unpack(">IIBB", next(
        body for kind, body in png._chunks(data) if kind == b"IHDR")[:10])
    raw = np.frombuffer(png.zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


def _textured(rng, h, w, c):
    """Smooth gradients plus noise: libpng then picks every filter type."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3, yy * 2, xx + yy, xx * yy % 97][:c], -1)
    return (base + rng.integers(0, 24, (h, w, c))).astype(np.uint8)


def _mixed(rng, h, w, c):
    """Rows of noise, of smooth gradients with noise, of steep gradients
    and of one level: libpng picks each of the five filter types."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = _textured(rng, h, w, c).astype(np.int64)
    img[:h // 4] = rng.integers(0, 256, (h // 4, w, c))
    img[h // 2:h // 2 + 6] = (xx[:6, :, None] * 5 + yy[:6, :, None] * 40) % 256
    img[-6:] = 77
    return img.astype(np.uint8)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra"])
def test_png_reads_what_cv2_wrote(rng, tmp_path, kind):
    """``read_image`` (colour and gray reads) equals ``cv2.imread`` bit for
    bit on PNGs that ``cv2.imwrite`` wrote at its default settings, whose
    rows are all Sub (the row path), and at compression levels 0-9, whose
    rows use all five filters (None, Sub, Up, Average, Paeth: the
    anti-diagonal walk)."""
    c = {"gray": 1, "bgr": 3, "bgra": 4}[kind]
    img = _mixed(rng, 48, 56, c)
    img = img[..., 0] if c == 1 else img
    filters = set()
    for level in (None, 0, 1, 3, 6, 9):
        path = str(tmp_path / f"{kind}_{level}.png")
        assert cv2.imwrite(path, img, [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level])
        if level is None:
            assert _filters(path) == {1}
        else:
            filters |= _filters(path)
        for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
            want = cv2.imread(path, flag)
            got = png.read_image(path, gray=gray)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert filters == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra"])
def test_png_write_reads_back_in_cv2(rng, tmp_path, kind):
    c = {"gray": 1, "bgr": 3, "bgra": 4}[kind]
    img = _textured(rng, 24, 31, c)
    img = img[..., 0] if c == 1 else img
    for filter_type in (png.SUB, png.PAETH):  # Sub by default, as cv2.imwrite writes
        path = str(tmp_path / f"w{filter_type}.png")
        png.write_image(path, img, *([] if filter_type == png.SUB else [filter_type]))
        assert _filters(path) == {filter_type}
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(png.read_image(path, gray=c == 1),
                                      img if c == 1 else img[..., :3])


def test_other_extensions_need_pil(rng, tmp_path, monkeypatch):
    """A non-PNG file goes through PIL where it imports; without it the
    error names the extension and the decoder it lacks."""
    path = str(tmp_path / "x.bmp")
    img = _textured(rng, 8, 8, 3)
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(png.read_image(path), cv2.imread(path))  # BMP: lossless
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=r"'\.bmp'.*PIL"):
        png.read_image(path)
    with pytest.raises(FileNotFoundError):
        png.read_image(str(tmp_path / "missing.png"))


# ---- the dataset ---------------------------------------------------------------


def _write_tree(root, rng, name="tiny", splits=(("training", 4),), size=(32, 32),
                num_classes=3, writer=None):
    """A dataset of the reference's layout; masks hold 0, 255 and other
    levels (the ``/255`` binarization keeps 255 only)."""
    write = writer or cv2.imwrite
    ids = {}
    for split, n in splits:
        img_dir = os.path.join(root, name, "images", split)
        os.makedirs(img_dir, exist_ok=True)
        ids[split] = [f"im{i:02d}" for i in range(n)]
        for i in ids[split]:
            write(os.path.join(img_dir, i + ".png"), _textured(rng, *size, 3))
            for c in (range(num_classes) if num_classes > 1 else [None]):
                d = os.path.join(root, name, "annotations", split, *([str(c)] if c is not None
                                                                    else []))
                os.makedirs(d, exist_ok=True)
                m = rng.choice(np.array([0, 255, 255, 128, 254], np.uint8), size)
                write(os.path.join(d, i + ".png"), m)
    return ids


@pytest.mark.parametrize("num_classes,channels", [(3, 3), (1, 3), (3, 1)],
                         ids=["3-classes", "1-class", "gray-input"])
def test_segmentation_dataset_matches_jax(rng, tmp_path, num_classes, channels):
    root = str(tmp_path)
    ids = _write_tree(root, rng, num_classes=num_classes)["training"]
    assert pdataset.list_split_ids(root, "tiny", "training", ".png") == \
        jdataset.list_split_ids(root, "tiny", "training", ".png") == ids
    cfg = {"input_h": 32, "input_w": 32}
    kw = dict(img_ids=ids, img_dir=os.path.join(root, "tiny", "images", "training"),
              mask_dir=os.path.join(root, "tiny", "annotations", "training"),
              img_ext=".png", mask_ext=".png", num_classes=num_classes,
              input_channels=channels)
    for tf, jtf in ((None, None), (ptransforms.val_transform(cfg),
                                   jtransforms.val_transform(cfg))):
        ours = pdataset.SegmentationDataset(transform=tf, **kw)
        theirs = jdataset.SegmentationDataset(transform=jtf, **kw)
        assert len(ours) == len(theirs) == 4
        for i in range(4):
            for a, b in zip(ours[i][:3], theirs[i][:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert ours[i][3] == theirs[i][3]
    mask = pdataset.SegmentationDataset(**kw)[0][2]
    assert set(np.unique(mask)) <= ({0.0, 1.0} if num_classes > 1
                                    else {0.0, 128.0, 254.0, 255.0})
    # the preloaded images (image_to_afile) and the from_file path
    args = (kw["img_dir"], kw["mask_dir"], "tiny", ids, {"img_ext": ".png"})
    pre, jpre = pdataset.image_to_afile(*args), jdataset.image_to_afile(*args)
    assert pre.keys() == jpre.keys()
    for k in pre:
        np.testing.assert_array_equal(pre[k]["img"], jpre[k]["img"])
    if channels == 3:
        ours = pdataset.SegmentationDataset(from_file=pre, **kw)
        theirs = jdataset.SegmentationDataset(from_file=jpre, **kw)
        for a, b in zip(ours[1][:3], theirs[1][:3]):
            np.testing.assert_array_equal(a, b)


# ---- the transforms ------------------------------------------------------------


@pytest.mark.parametrize("size", [(32, 32), (48, 40)])
def test_rotate_matches_jax(size):
    """One seed and ``p = 1`` on both sides: the same angle; the image
    within one level, the mask differing on at most 0.1% of its pixels."""
    g = np.random.default_rng(3)
    mean = list(ptransforms.IMAGENET_MEAN)
    for seed in range(6):
        img = _textured(g, *size, 3)
        mask = (g.random(size + (3,)) > 0.5).astype(np.uint8)
        ours = ptransforms.Rotate([-10, 10], value=mean, mask_value=0, p=1)
        theirs = jtransforms.Rotate([-10, 10], value=mean, mask_value=0, p=1)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a, am = ours(img, mask, r1)
        b, bm = theirs(img, mask, r2)
        assert r1.random() == r2.random()  # the same draws
        assert a.dtype == b.dtype and a.shape == b.shape and am.shape == bm.shape
        assert np.abs(a.astype(int) - b).max() <= 1
        assert (am != bm).mean() <= 1e-3


def test_hue_saturation_value_and_resize_match_jax():
    g = np.random.default_rng(4)
    for seed in range(6):
        img = _textured(g, 24, 20, 3)
        a, _ = ptransforms.HueSaturationValue(10, 10, 10, p=1)(img, None,
                                                               np.random.default_rng(seed))
        b, _ = jtransforms.HueSaturationValue(10, 10, 10, p=1)(img, None,
                                                               np.random.default_rng(seed))
        assert a.dtype == b.dtype == np.uint8 and np.abs(a.astype(int) - b).max() <= 1
    gray = img[..., :1]
    assert ptransforms.HueSaturationValue(p=1)(gray, None, g)[0] is gray
    for (h, w), to in (((32, 32), (16, 24)), ((20, 18), (32, 32)), ((13, 17), (40, 40))):
        img = _textured(g, h, w, 3)
        mask = (g.random((h, w, 2)) > 0.5).astype(np.uint8)
        a, am = ptransforms.Resize(*to)(img, mask, g)
        b, bm = jtransforms.Resize(*to)(img, mask, g)
        assert a.shape == b.shape == to + (3,) and am.shape == bm.shape == to + (2,)
        assert np.abs(a.astype(int) - b).max() <= 1
        np.testing.assert_array_equal(am, bm)


# train_transform's bar in its output's units: Rotate, HSV and Resize each
# within one level; brightness/contrast multiplies by at most 1.1 and
# truncates (one level more); Normalize divides by 255·std (std ≥ 0.224)
TRAIN_TF_BAR = (3 * 1.1 + 1) / (255 * min(ptransforms.IMAGENET_STD))


def test_train_transform_matches_jax(rng):
    """``train_transform(cfg)`` with one seed against the JAX pipeline's,
    over 8 items (resized from 40×36): the same branches and parameters
    (the two generators stay in step), the image within the sum of the
    bars, the mask on all but 0.1% of its pixels."""
    cfg = {"input_h": 32, "input_w": 32, "rotate_min": -10, "rotate_max": 10}
    ours, theirs = ptransforms.train_transform(cfg), jtransforms.train_transform(cfg)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(8):
        img = _textured(rng, 40, 36, 3)
        mask = (rng.random((40, 36, 3)) > 0.5).astype(np.uint8)
        a = ours(image=img, mask=mask, rng=r1)
        b = theirs(image=img, mask=mask, rng=r2)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["image"].shape == b["image"].shape == (32, 32, 3)
        assert np.abs(a["image"] - b["image"]).max() <= TRAIN_TF_BAR
        assert (a["mask"] != b["mask"]).mean() <= 1e-3


# ---- model cards ---------------------------------------------------------------


def test_model_cards_read_across_packages(tmp_path, monkeypatch):
    """Each package's card is read by the other's reader; a card the port
    writes without PyYAML is read back by the JAX package's
    ``load_model_card``, every key and value equal."""
    opt = pconfig.load_experiment_config(CONFIG).opt_config
    opt.update({"note": "a: b, 'c'", "e": "1e-4", "none": None})
    assert opt["milestones"] == "20, 40, 60, 80, 100, 200, 250, 300"
    assert opt["resume"] is False and opt["lr"] == 1e-4
    port_dir, jax_dir, flat_dir = (str(tmp_path / d) for d in ("port", "jax", "flat"))
    pconfig.dump_model_card(opt, port_dir)
    jconfig.dump_model_card(opt, jax_dir)
    assert jconfig.load_model_card(port_dir) == opt
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent, as on the card machine
    assert pconfig.load_model_card(jax_dir) == opt
    pconfig.dump_model_card(opt, flat_dir)
    assert pconfig.load_model_card(flat_dir) == opt
    monkeypatch.delitem(sys.modules, "yaml")
    with open(os.path.join(flat_dir, "config.yml")) as f:
        text = f.read()
    assert 'milestones: "20, 40, 60' in text and 'resume: false' in text
    got = jconfig.load_model_card(flat_dir)
    assert got == opt and {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in opt.items()}
    cfg = pconfig.load_experiment_config(CONFIG)
    assert cfg.name == opt["name"] and cfg.model_dir() == os.path.join("../models", cfg.name)


# ---- checkpoints ---------------------------------------------------------------


def test_load_model_strips_module_prefixes_and_reports(tmp_path):
    """A ``DataParallel``-style ``model.pth`` (``module.`` prefixes) loads
    with ``strict=False`` semantics: matching tensors copied, the rest
    reported."""
    src = build_model("SSUNet", 3, filters=(8, 8, 16, 16, 16), seed=1, device="cpu")
    dst = build_model("SSUNet", 3, filters=(8, 8, 16, 16, 16), seed=2, device="cpu")
    sd = {"module." + k: v for k, v in src.state_dict().items()}
    sd["module.final.weight"] = torch.zeros(5, 8, 1, 1)  # a shape the model does not have
    sd["module.extra.bias"] = torch.zeros(3)
    del sd["module.conv0_0.bn1.running_var"]
    torch.save(sd, tmp_path / "model.pth")
    report = ckpt.load_model(str(tmp_path), dst)
    assert report["missing"] == ["conv0_0.bn1.running_var"]
    assert report["unmatched"] == ["final.weight", "extra.bias"]
    assert len(report["loaded"]) == len(src.state_dict()) - 2
    for k, v in dst.state_dict().items():
        if k in report["loaded"]:
            assert torch.equal(v, src.state_dict()[k]), k
    assert not torch.equal(dst.final.weight, src.final.weight)
    path = ckpt.save_model(str(tmp_path / "m"), src)
    again = build_model("SSUNet", 3, filters=(8, 8, 16, 16, 16), seed=3, device="cpu")
    assert ckpt.load_model(path, again)["missing"] == []
    for k, v in again.state_dict().items():
        assert torch.equal(v, src.state_dict()[k])


def test_train_state_round_trip(tmp_path):
    """Parameters, BatchNorm buffers and Adam's moments come back equal,
    with the epoch and ``best_iou``."""
    model = build_model("SSUNet", 3, filters=(8, 8, 16, 16, 16), seed=1, device="cpu")
    opt = optim.build_optimizer(model.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    step = make_train_step(model, losses.bce_dice_loss, opt, 3)
    g = torch.Generator().manual_seed(0)
    step(torch.randn((2, 32, 32, 3), generator=g),
         (torch.rand((2, 32, 32, 3), generator=g) > 0.5).float(), 1e-3)
    assert not ckpt.has_train_state(str(tmp_path))
    ckpt.save_train_state(str(tmp_path), model, opt, 4, {"best_iou": 0.25})
    assert ckpt.has_train_state(str(tmp_path))
    fresh = build_model("SSUNet", 3, filters=(8, 8, 16, 16, 16), seed=9, device="cpu")
    fresh_opt = optim.build_optimizer(fresh.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    meta = ckpt.restore_train_state(str(tmp_path), fresh, fresh_opt)
    assert meta == {"epoch": 4, "best_iou": 0.25}
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = opt.state_dict(), fresh_opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert want["state"].keys() == got["state"].keys()
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(got["state"][i][k])), (i, k)


# ---- accum_steps and remat -------------------------------------------------------

FILTERS = (8, 16, 32, 48, 64, 64)  # tests/test_torch_train.py's narrow flagship


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_accum_steps_matches_jax():
    """Two Adam steps with ``accum_steps=2`` (batch 4: microbatches of rows
    0, 2 and 1, 3) against JAX ``make_train_step(accum_steps=2)``, to
    tests/test_torch_train.py's bars: loss and Dice 1e-4, IoU one element
    of its union, parameters 2·lr, BN statistics 1e-4 after step 1 and 2·lr
    after step 2. Step 2's IoU, the mean over two microbatches, to four
    elements: Adam's first update of a gradient near 0 may take either
    sign (the 2·lr above), which moves step 2's logits and flips a few
    thresholded elements (measured 0.00066, 1.35/2048, with its loss
    1.1e-5 apart). A batch that 2 does not divide raises."""
    model = JUNetRSSv2(num_classes=3, input_channels=3, filters=FILTERS)
    g = np.random.default_rng(5)
    x = g.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = (g.random((4, 32, 32, 3)) > 0.5).astype(np.float32)
    variables = jax.device_get(jit_init(model, jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                                        train=True))
    lr = 1e-3
    config = {"optimizer": "Adam", "lr": lr, "weight_decay": 1e-7}
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    step = make_train_step(port, losses.bce_dice_loss,
                           optim.build_optimizer(port.parameters(), config), 3, clip=0.7,
                           accum_steps=2)
    tx = joptim.build_optimizer(config)
    state = TrainState.create(variables, tx)
    jstep = jax_make_train_step(model, jlosses.bce_dice_loss, tx, 3, clip=0.7, accum_steps=2)
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    for i in range(2):
        got = step(torch.from_numpy(x), torch.from_numpy(y), lr)
        state, want = jstep(state, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(lr))
        for k, atol in (("loss", 1e-4), ("iou", (1 + 3 * i) / 2048), ("dice", 1e-4)):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=atol, err_msg=k)
        back, _ = convert_torch_state_dict(port.state_dict(), template)
        ours, theirs = _leaves(back), _leaves(jax.device_get(state.variables()))
        assert ours.keys() == theirs.keys()
        for path, want_leaf in theirs.items():
            stats = "batch_stats" in str(path[0])
            np.testing.assert_allclose(np.asarray(ours[path]), np.asarray(want_leaf),
                                       rtol=1e-4 if stats else 0,
                                       atol=1e-4 if stats and i == 0 else 2 * lr,
                                       err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")
    with pytest.raises(ValueError, match="not divisible by accum_steps=2"):
        step(torch.from_numpy(x[:3]), torch.from_numpy(y[:3]), lr)


def test_remat_recomputes_without_fused_train_stages(monkeypatch):
    """Under remat the blocks run under ``torch.utils.checkpoint`` and no
    fused train stage runs: the loss, every gradient and the BN running
    statistics equal those of the same composition without remat (1e-6),
    and the fused stages are called only with remat off."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 32, 32, 3), generator=g)
    y = (torch.rand((2, 32, 32, 3), generator=g) > 0.5).float()
    base = build_model("UNet_R_SS_v2", 3, filters=FILTERS, seed=3, device="cpu").train()
    calls = {}
    fused = ssunet.fused_train_stage

    def counted(*args, **kwargs):
        calls["fused_train_stage"] = calls.get("fused_train_stage", 0) + 1
        return fused(*args, **kwargs)

    monkeypatch.setattr(ssunet, "fused_train_stage", counted)

    def run(remat, fused_train):
        model = copy.deepcopy(base)
        blocks.set_remat(remat)
        monkeypatch.setattr(ssunet, "fused_train_enabled", lambda: fused_train)
        loss = losses.bce_dice_loss(model(x), y)
        loss.backward()
        blocks.set_remat(False)
        return loss.detach(), [p.grad for p in model.parameters()], \
            [b.clone() for b in model.buffers()]

    run(False, True)
    assert calls == {"fused_train_stage": 6}
    calls.clear()
    with_remat = run(True, True)
    assert calls == {}
    without = run(False, False)
    torch.testing.assert_close(with_remat[0], without[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(with_remat[1] + with_remat[2], without[1] + without[2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---- run_experiment and the CLI ----------------------------------------------------

LOG_HEADER = ["epoch", "lr", "loss", "iou", "dice", "val_loss", "val_iou", "val_dice"]


def _experiment_config(root, **opt):
    """config_v1.json pointed at ``root``, with ``opt`` overrides."""
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["file_path"] = {k: os.path.join(root, d) for k, d in (
        ("input_path", "inputs"), ("model_path", "models"), ("output_path", "outputs"),
        ("checkpoint_path", "checkpoint"))}
    raw["opt_config"].update(opt)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _log_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


SMALL = dict(arch="SSUNet", input_h=32, input_w=32, batch_size=2, num_workers=2,
             mixed_precision="False", name="tiny_ssunet")


def test_run_experiment_and_resume(tmp_path):
    """``synthetic=4``, SSUNet at 32²: two epochs write the card, a
    ``log.csv`` of JAX's columns with 2 rows, ``model.pth``, the train state
    and epoch 1's ``torch.profiler`` trace; with ``resume`` the next run
    starts at the saved epoch + 1 from the saved weights."""
    cfg = pconfig.load_experiment_config(_experiment_config(str(tmp_path), epochs=2,
                                                            profile_epoch=1, **SMALL))
    model, best_iou, log = supervised.run_experiment(cfg, synthetic=4, use_tensorboard=False,
                                                     device="cpu")
    mdir = cfg.model_dir()
    header, rows = _log_rows(os.path.join(mdir, "log.csv"))
    assert header == LOG_HEADER and [r[0] for r in rows] == ["0", "1"]
    assert list(log) == LOG_HEADER and log["epoch"] == [0, 1]
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert best_iou > 0 and os.path.isfile(os.path.join(mdir, "model.pth"))
    assert pconfig.load_model_card(mdir)["arch"] == "SSUNet"
    with open(os.path.join(mdir, "train_meta.json")) as f:
        assert json.load(f) == {"epoch": 1, "best_iou": best_iou}
    trace_dir = os.path.join(cfg.file_path.checkpoint_path, "tiny_ssunet", "profile")
    assert any(f.endswith(".json") for f in os.listdir(trace_dir))
    saved = copy.deepcopy(model.state_dict())

    cfg.opt_config["resume"] = True
    restored = {}
    restore = supervised.ckpt.restore_train_state

    def watch(model_dir, m, opt):
        meta = restore(model_dir, m, opt)
        restored.update({k: v.clone() for k, v in m.state_dict().items()})
        return meta

    supervised.ckpt.restore_train_state = watch
    try:
        _, _, log2 = supervised.run_experiment(cfg, synthetic=4, epochs_override=3,
                                               use_tensorboard=False, device="cpu")
    finally:
        supervised.ckpt.restore_train_state = restore
    assert log2["epoch"] == [2]  # log.csv holds this run's epochs, as in JAX
    assert _log_rows(os.path.join(mdir, "log.csv"))[1][0][0] == "2"
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k
    with open(os.path.join(mdir, "train_meta.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_cli_trains_on_png_files(tmp_path):
    """``python -m ssunet_gan_tpu_torch.cli.train --config <file> --device
    cpu`` on a PNG tree (4 / 1 / 1 images, 3 classes) written by the port's
    codec: exits 0 and writes the log, the card and the checkpoints. The
    device defaults to the card."""
    root = str(tmp_path)
    g = np.random.default_rng(8)
    _write_tree(os.path.join(root, "inputs"), g, name="tiny",
                splits=(("training", 4), ("validation", 1), ("test", 1)), writer=png.write_image)
    path = _experiment_config(root, epochs=1, dataset="tiny", val_dataset="tiny", **SMALL)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "ssunet_gan_tpu_torch.cli.train", "--config",
                           path, "--device", "cpu"], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    mdir = os.path.join(root, "models", "tiny_ssunet")
    assert _log_rows(os.path.join(mdir, "log.csv"))[0] == LOG_HEADER
    for f in ("config.yml", "train_state.pth", "train_meta.json"):
        assert os.path.isfile(os.path.join(mdir, f)), f
    assert supervised.parse_args(["--config", path]).device == "cuda"
