"""The port's JPEG encoder (``data/jpeg.py``) against ``cv2.imencode(".jpg")``
at its defaults, byte for byte, and ``write_image`` against
``cv2.imwrite``."""

import os

import cv2
import numpy as np
import pytest

from ssunet_gan_tpu_torch.data import jpeg
from ssunet_gan_tpu_torch.data.png import read_image

SIZES = [(1, 1), (7, 13), (16, 16), (17, 33), (37, 53), (64, 48), (512, 384)]


def _image(kind, h, w, seed=0):
    g = np.random.default_rng(seed + h * 1000 + w)
    yy, xx = np.mgrid[:h, :w]
    if kind == "noise":
        return g.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "gradient":
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) * 255 // max(h + w - 2, 1)], -1).astype(np.uint8)
    if kind == "black":
        return np.zeros((h, w, 3), np.uint8)
    if kind == "white":
        return np.full((h, w, 3), 255, np.uint8)
    # overlay-like: a smooth scene with noise, half of it blended pink and a
    # block blended yellow, as infer/overlays.py writes them
    base = np.clip(np.stack([xx * 3 + yy, 128 + 0 * xx, yy * 2], -1) % 256
                   + g.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)
    pink = (g.random((h, w)) < 0.5)
    base[pink] = (0.5 * np.array([255, 0, 255]) + 0.5 * base[pink]).astype(np.uint8)
    yellow = (yy // 8 + xx // 8) % 3 == 0
    base[yellow] = (0.5 * np.array([0, 255, 255]) + 0.5 * base[yellow]).astype(np.uint8)
    return base


@pytest.mark.parametrize("kind", ["noise", "gradient", "black", "white", "overlay"])
@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_encode_jpeg_equals_cv2(kind, h, w):
    img = _image(kind, h, w)
    assert jpeg.encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


def test_encode_jpeg_long_zero_runs_and_large_dc_steps():
    """Runs of 16+ zeros (ZRL codes) and DC differences of every size:
    flat blocks of alternating extremes beside single bright pixels."""
    img = np.zeros((48, 80, 3), np.uint8)
    img[:, 16:32] = 255
    img[8::16, 40::16] = 255
    img[:, 64:] = _image("noise", 48, 16)
    assert jpeg.encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


def test_quant_tables_at_quality_95():
    y, c = jpeg.quant_tables()
    assert y[0] == 2 and c[0] == 2 and y.max() == 12 and c.max() == 10
    assert jpeg._ZIGZAG[:10].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)])
def test_encode_jpeg_refuses_other_images(bad):
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(bad)


def test_write_image_by_extension(tmp_path):
    img = _image("overlay", 37, 53)
    for ext in (".jpg", ".jpeg", ".JPG"):
        ours, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
        jpeg.write_image(ours, img)
        cv2.imwrite(theirs, img)
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()
    png = str(tmp_path / "a.png")
    jpeg.write_image(png, img)
    np.testing.assert_array_equal(read_image(png), img)
    np.testing.assert_array_equal(cv2.imread(png), img)
    with pytest.raises(ValueError, match="writes"):
        jpeg.write_image(str(tmp_path / "a.bmp"), img)
    assert not os.path.exists(tmp_path / "a.bmp")
