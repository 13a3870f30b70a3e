"""Image files without cv2: an 8-bit PNG codec on ``zlib`` and numpy.

The reference and the JAX package read images with ``cv2.imread`` (BGR
channel order, HWC uint8; or one gray plane). The card machine has neither
cv2 nor PIL, and the reference's data are PNGs (``configs/config_v1.json``
``img_ext``/``mask_ext``), so the port decodes PNG itself:
:func:`read_image` returns what ``cv2.imread`` returns for 8-bit
non-interlaced PNGs of colour type gray, gray + alpha, RGB or RGBA, with
all five scanline filters undone; :func:`write_image` writes what
``cv2.imwrite`` would be read back as, with one filter for every row: Sub,
as ``cv2.imwrite`` writes at its default settings (the reference's
preprocessing, ``data/preprocess.py`` of the JAX package, writes its tiles
so), or Paeth.

Two decoding paths, by the filters a file's rows use:

- None, Sub and Up only (``cv2.imwrite``'s defaults, and this writer's
  Sub): row by row, Sub as a running sum (mod 256).
- Average or Paeth anywhere (libpng's adaptive choice, which cv2 takes
  when a compression level is given, and most other writers): each byte
  depends non-linearly on its decoded left neighbour, so a row cannot be
  undone in one vector step. The decoder walks the image's anti-diagonals
  instead: a pixel depends only on its left, up and up-left neighbours,
  which lie on the two diagonals before its own. Stored skewed (diagonal
  by row), those neighbours are contiguous slices, so each step is a few
  vector operations over up to min(H, W) pixels.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples): gray, RGB, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# a gray read of a colour PNG: cv2 has libpng convert it with weights 0.299
# and 0.587, which libpng truncates to 15-bit fixed point (blue takes the
# rest) and applies with a truncating shift; gray pixels pass unchanged
_GRAY_R, _GRAY_G, _GRAY_SHIFT = 9797, 19234, 15
_GRAY_B = (1 << _GRAY_SHIFT) - _GRAY_R - _GRAY_G
# the scanline filter types the writer takes
SUB, PAETH = 1, 4


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``raw`` (h rows of a filter byte and
    w·bpp bytes); returns (h, w, bpp) uint8."""
    kinds = raw[:, 0].astype(np.int64)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown scanline filter {int(kinds.max())}")
    d = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if kinds.max(initial=0) <= 2:  # None, Sub and Up only: row by row
        x = np.zeros((h + 1, w, bpp), np.int32)  # a zero row above the image
        for r in range(h):
            row = d[r]
            if kinds[r] == 1:
                row = np.cumsum(row, 0)
            elif kinds[r] == 2:
                row = row + x[r]
            x[r + 1] = row & 255
        return x[1:].astype(np.uint8)
    # skewed: xs[s + 1, r + 1] holds pixel (r, s - r); the neighbours of
    # (r, i) on diagonal s are a = xs[s, r + 1] (left), b = xs[s, r] (up),
    # c = xs[s - 1, r] (up-left); slots outside the image stay 0, as PNG
    # takes them, and xs[-1] is the zero diagonal before the first
    n = h + w - 1
    rr, ii = np.indices((h, w))
    ds = np.zeros((n, h, bpp), np.int32)
    ds[rr + ii, rr] = d
    xs = np.zeros((n + 2, h + 1, bpp), np.int32)
    sub, up, avg, paeth = (kinds[:, None] == k for k in (1, 2, 3, 4))
    for s in range(n):
        r0, r1 = max(0, s - w + 1), min(h, s + 1)
        a, b, c = xs[s, r0 + 1:r1 + 1], xs[s, r0:r1], xs[s - 1, r0:r1]
        pred = np.where(paeth[r0:r1], _paeth(a, b, c),
                        np.where(avg[r0:r1], (a + b) >> 1,
                                 np.where(up[r0:r1], b, np.where(sub[r0:r1], a, 0))))
        xs[s + 1, r0 + 1:r1 + 1] = (ds[s, r0:r1] + pred) & 255
    return xs[rr + ii + 1, rr + 1].astype(np.uint8)


def png_size(path: str):
    """(width, height) of a PNG file, read from its IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC uint8 in the file's channel order (gray, gray +
    alpha, RGB or RGBA)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: the decoder takes 8-bit non-interlaced gray, gray + "
                         f"alpha, RGB and RGBA")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data of {raw.size} bytes for {w}x{h}x{bpp}")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)


def encode_png(img: np.ndarray, filter_type: int = SUB) -> bytes:
    """HW or HWC uint8 (1, 2, 3 or 4 channels, in the file's order) -> PNG
    bytes, every row with ``filter_type``: ``SUB`` (each byte less its left
    neighbour) or ``PAETH`` (less the Paeth predictor of its left, up and
    up-left neighbours)."""
    if img.dtype != np.uint8:
        raise TypeError(f"write 8-bit images only, got {img.dtype}")
    if filter_type not in (SUB, PAETH):
        raise ValueError(f"write filter Sub ({SUB}) or Paeth ({PAETH}), got {filter_type}")
    x = img[..., None] if img.ndim == 2 else img
    h, w, c = x.shape
    ctype = {1: 0, 3: 2, 2: 4, 4: 6}[c]
    p = np.pad(x.astype(np.int32), ((1, 0), (1, 0), (0, 0)))
    pred = p[1:, :-1] if filter_type == SUB else _paeth(p[1:, :-1], p[:-1, 1:], p[:-1, :-1])
    filtered = ((p[1:, 1:] - pred) & 255).astype(np.uint8)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), filtered.reshape(h, w * c)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB -> gray of uint8 values, as cv2's gray read of a colour
    PNG gets it."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = (r * _GRAY_R + g * _GRAY_G + b * _GRAY_B) >> _GRAY_SHIFT
    return np.where((r == g) & (r == b), r, y).astype(np.uint8)


def _read_other(path: str, gray: bool) -> np.ndarray:
    ext = os.path.splitext(path)[1]
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"cannot read {ext!r} files here: the port decodes PNG itself and "
                         f"needs PIL for other formats, which does not import") from None
    with Image.open(path) as im:
        if gray:
            return np.asarray(im.convert("L"))
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """What ``cv2.imread(path)`` returns, BGR HWC uint8, or with ``gray``
    what ``cv2.imread(path, IMREAD_GRAYSCALE)`` returns, HW uint8. Raises
    FileNotFoundError where there is no file (cv2 returns None)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if not path.lower().endswith(".png"):
        return _read_other(path, gray)
    with open(path, "rb") as f:
        x = decode_png(f.read())
    c = x.shape[2]
    rgb = x[..., :3] if c >= 3 else np.repeat(x[..., :1], 3, -1)
    if gray:
        return x[..., 0].copy() if c <= 2 else _to_gray(rgb)
    return np.ascontiguousarray(rgb[..., ::-1])


def write_image(path: str, img: np.ndarray, filter_type: int = SUB) -> None:
    """``cv2.imwrite(path, img)`` for a PNG path: ``img`` HW (gray) or HWC
    BGR / BGRA uint8; every row with ``filter_type`` (see
    :func:`encode_png`)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"write_image writes PNG only, got {path!r}")
    x = img[..., None] if img.ndim == 2 else img
    if x.shape[2] in (3, 4):
        x = np.concatenate([x[..., 2::-1], x[..., 3:]], -1)  # BGR(A) -> RGB(A)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(x), filter_type))
