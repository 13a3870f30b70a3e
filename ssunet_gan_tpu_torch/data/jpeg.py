"""Baseline JPEG encoding without cv2: what ``cv2.imwrite(path, img)``
writes for a ``.jpg`` path at its default settings.

The JAX package writes its colored overlays (``infer/overlays.py``) with
``cv2.imwrite``; the card machine has neither cv2 nor PIL. OpenCV hands a
3-channel BGR image to libjpeg(-turbo) at quality 95 with 4:2:0 chroma
subsampling, the standard Huffman tables and no restart markers, so the
file is: SOI, a JFIF APP0, two DQT (luma, chroma), a baseline SOF0 (Y 2×2,
Cb and Cr 1×1), four DHT (DC and AC of luma, then of chroma), one SOS
over the three components, the entropy-coded data, EOI.

:func:`encode_jpeg` follows libjpeg's integer paths step by step, so its
bytes equal OpenCV's; the public libjpeg-turbo file that defines each step
is named at the step:

- ``jcparam.c`` ``jpeg_quality_scaling``: quality 95 scales the standard
  tables by 10 %, each entry clamped to 1..255;
- ``jccolor.c`` ``rgb_ycc_convert``: 16-bit fixed point; Cb and Cr carry
  the offset 128 and ONE_HALF − 1;
- ``jcprepct.c`` / ``jcsample.c``: the bottom rows and right columns
  replicated to whole blocks (``expand_bottom_edge``,
  ``expand_right_edge``), chroma averaged over 2×2 with the bias 1, 2, 1,
  2, ... along a row (``h2v2_downsample``);
- ``jfdctint.c`` ``jpeg_fdct_islow``: the slow-but-accurate integer DCT
  on samples centred at 0, output scaled by 8;
- ``jcdctmgr.c``: quantization by 8·q, rounded half away from zero;
- ``jccoefct.c``: the blocks that fill a partial MCU at the right or bottom
  edge are zero with the DC of the block before them;
- ``jchuff.c`` / ``jstdhuff.c``: DC differences per component and AC run
  lengths (ZRL, EOB) coded with the standard tables, 0xFF bytes stuffed
  with 0x00, the last byte padded with 1 bits.

Everything runs as numpy array operations over all blocks and symbols at
once (a 5000² image is ~586k blocks); the DCT and the Huffman symbols
take their blocks in slices of fixed size, on a thread pool.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

QUALITY = 95  # cv2.imwrite's default
# jcparam.c: the JPEG standard's (Annex K) tables in natural order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA = np.full(64, 99, np.int64)
_STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# jstdhuff.c: code counts per length 1..16, then the symbols in code order
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
# the natural (row-major) index of each zigzag position: anti-diagonals,
# odd ones walked down, even ones up
_ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2
                                                     else n % 8)), np.int64)
_BLOCKS_PER_SLICE = 1 << 14  # DCT blocks per numpy step
_MCUS_PER_SLICE = 1 << 12  # MCUs per Huffman step (6 blocks each)


def quant_tables():
    """The luma and chroma quantization tables (natural order) at quality
    95: jcparam.c ``jpeg_quality_scaling`` gives the scale 200 − 2·95 =
    10 (%), ``jpeg_add_quant_table`` rounds and clamps to 1..255."""
    scale = 200 - 2 * QUALITY
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA, _STD_CHROMA))


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _ycc(img: np.ndarray):
    """jccolor.c ``rgb_ycc_convert`` of a BGR image: Y, Cb, Cr as int32,
    in bands of rows."""
    out = np.empty((3,) + img.shape[:2], np.int32)
    half, offset = 1 << 15, 128 << 16

    def work(i):
        b, g, r = (img[i:i + 256, :, c].astype(np.int32) for c in range(3))
        out[0, i:i + 256] = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
        out[1, i:i + 256] = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset
                             + half - 1) >> 16
        out[2, i:i + 256] = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset
                             + half - 1) >> 16

    _threads(work, range(0, img.shape[0], 256))
    return out


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows·8, cols·8) plane → (rows·cols, 8, 8) blocks, row-major."""
    return plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _fdct_islow(x: np.ndarray) -> np.ndarray:
    """jfdctint.c ``jpeg_fdct_islow`` on (N, 8, 8) int64 samples centred at
    0: the 2-D DCT scaled by 8, in natural order."""
    c13, p1 = 13, 2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    def one_pass(d, first):
        # d: (..., 8) along the transformed axis
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(d)
        shift = c13 - p1 if first else c13 + p1
        if first:
            out[..., 0] = (t10 + t11) << p1
            out[..., 4] = (t10 - t11) << p1
        else:
            out[..., 0] = descale(t10 + t11, p1)
            out[..., 4] = descale(t10 - t11, p1)
        z1 = (t12 + t13) * 4433
        out[..., 2] = descale(z1 + t13 * 6270, shift)
        out[..., 6] = descale(z1 - t12 * 15137, shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[..., 7] = descale(t4 + z1 + z3, shift)
        out[..., 5] = descale(t5 + z2 + z4, shift)
        out[..., 3] = descale(t6 + z2 + z3, shift)
        out[..., 1] = descale(t7 + z1 + z4, shift)
        return out

    rows = one_pass(x, True)
    return one_pass(rows.swapaxes(1, 2), False).swapaxes(1, 2)


def _threads(fn, items) -> list:
    """``[fn(i) for i in items]`` on a thread pool (numpy's array loops
    release the GIL), in order."""
    items = list(items)
    if len(items) <= 1:
        return [fn(i) for i in items]
    with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _quantized(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8-range samples → (N, 64) quantized coefficients in
    zigzag order (int32), in slices of blocks."""
    q = (qtable * 8)[_ZIGZAG]
    out = np.empty((len(blocks), 64), np.int32)

    def work(i):
        x = blocks[i:i + _BLOCKS_PER_SLICE].astype(np.int64) - 128
        c = _fdct_islow(x).reshape(-1, 64)[:, _ZIGZAG]
        out[i:i + _BLOCKS_PER_SLICE] = np.sign(c) * ((np.abs(c) + q // 2) // q)

    _threads(work, range(0, len(blocks), _BLOCKS_PER_SLICE))
    return out


def _huff_codes(table) -> np.ndarray:
    """jchuff.c ``jpeg_make_c_derived_tbl``: per symbol its code << 5 | its
    length."""
    bits, vals = table
    out = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = c << 5 | length
            c, k = c + 1, k + 1
        c <<= 1
    return out


# bits of |v| (0 for 0) for |v| < 2^15 (a DC difference at 8-bit samples
# takes at most 11)
_NBITS = np.concatenate([[0], np.floor(np.log2(np.arange(1, 1 << 15))).astype(np.int64) + 1])


def _coded(table: np.ndarray, sym: np.ndarray, v: np.ndarray, nb: np.ndarray):
    """(value, length) of each symbol's code followed by its ``nb`` extra
    bits: v itself, or v − 1 for v < 0."""
    code = table[sym]
    extra = (v - (v < 0)) & ((1 << nb) - 1)
    return (code >> 5) << nb | extra, (code & 31) + nb


def _events(coef: np.ndarray, chroma: np.ndarray, tables):
    """Huffman symbols of the blocks ``coef`` (N, 64: zigzag, the DC
    difference in column 0) in scan order, ``chroma`` whether each block
    takes the chroma tables: (values, lengths) with each symbol's extra
    bits, in stream order. Block b's events sit at 2b + 2j (its DC; j the
    count of non-zero AC coefficients before the block), two per non-zero
    AC coefficient (its ZRL codes, maybe none, and its symbol) and an EOB
    (empty where coefficient 63 is non-zero)."""
    (dc_l, ac_l), (dc_c, ac_c) = ((_huff_codes(d), _huff_codes(a)) for d, a in tables)
    dc_tab, ac_tab = np.concatenate([dc_l, dc_c]), np.concatenate([ac_l, ac_c])
    n = len(coef)
    side = 256 * chroma.astype(np.int64)

    ac = coef[:, 1:]
    nonzero = ac != 0
    blk, k = np.nonzero(nonzero)
    k = k + 1
    v = ac[nonzero].astype(np.int64)
    n_nz = nonzero.sum(1)
    first = np.cumsum(n_nz) - n_nz  # index of each block's first non-zero
    prev = np.empty_like(k)
    prev[1:] = k[:-1]
    prev[first[n_nz > 0]] = 0
    run = k - prev - 1
    nb = _NBITS[np.abs(v)]
    sym_val, sym_len = _coded(ac_tab, side[blk] + (run & 15) * 16 + nb, v, nb)
    zrl = run >> 4  # 0..3 ZRL codes before the symbol
    zrl_code = ac_tab[side[blk] + 0xF0]
    zc, zs = zrl_code >> 5, zrl_code & 31
    zrl_val = np.where(zrl > 0, zc, 0)
    for i in (1, 2):
        zrl_val = np.where(zrl > i, zrl_val << zs | zc, zrl_val)

    dc = coef[:, 0].astype(np.int64)
    nb = _NBITS[np.abs(dc)]
    dc_val, dc_len = _coded(dc_tab, side + nb, dc, nb)
    eob = ac_tab[side]
    eob = np.where(ac[:, -1] == 0, eob, 0)

    total = 2 * n + 2 * len(v)
    val = np.zeros(total, np.int64)
    ln = np.zeros(total, np.int64)
    at = 2 * np.arange(n) + 2 * first
    val[at], ln[at] = dc_val, dc_len
    at = 2 * blk + 2 * np.arange(len(v)) + 1
    val[at], ln[at] = zrl_val, zrl * zs
    val[at + 1], ln[at + 1] = sym_val, sym_len
    at = 2 * np.arange(n) + 2 * (first + n_nz) + 1
    val[at], ln[at] = eob >> 5, eob & 31
    return val, ln


def _pack(val: np.ndarray, ln: np.ndarray):
    """Concatenate the bit strings (each ≤ 33 bits) into big-endian 64-bit
    words from bit 0: (words, bit count)."""
    keep = ln > 0
    val, ln = val[keep].astype(np.uint64), ln[keep]
    end = np.cumsum(ln)
    nbits = int(end[-1]) if len(end) else 0
    words = np.zeros((nbits + 63) // 64 + 1, np.uint64)
    if nbits:
        start = end - ln
        wi, off = start >> 6, start & 63
        spill = off + ln - 64  # > 0: the string runs on into the next word
        head = np.where(spill > 0, val >> np.maximum(spill, 0).astype(np.uint64),
                        val << np.maximum(-spill, 0).astype(np.uint64))
        first = np.flatnonzero(np.diff(wi, prepend=-1))  # strings sorted by start
        words[wi[first]] = np.bitwise_or.reduceat(head, first)
        s = spill > 0
        words[wi[s] + 1] |= val[s] << (64 - spill[s]).astype(np.uint64)
    return words, nbits


def _join(parts) -> bytes:
    """The packed slices ``(words, bit count)`` one after the other; the
    last byte padded with 1 bits, a 0x00 stuffed after every 0xFF byte."""
    nbits = sum(n for _, n in parts)
    out = np.zeros(nbits // 64 + 2, np.uint64)
    pos = 0
    for words, n in parts:  # each slice shifted to its bit offset
        k, r = len(words), np.uint64(pos & 63)
        at = pos >> 6
        if r:
            out[at:at + k] |= words >> r
            out[at + 1:at + 1 + k] |= words[:len(out) - at - 1] << (np.uint64(64) - r)
        else:
            out[at:at + k] |= words
        pos += n
    data = out.astype(">u8").view(np.uint8)[:(nbits + 7) // 8].copy()
    if nbits % 8:
        data[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = np.flatnonzero(data == 255)
    return np.insert(data, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def encode_jpeg(img: np.ndarray) -> bytes:
    """HWC uint8 BGR image → baseline JPEG bytes, equal to
    ``cv2.imencode(".jpg", img)[1]`` (quality 95)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"encode_jpeg takes an HWC uint8 BGR image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    qy, qc = quant_tables()
    y, cb, cr = _ycc(img)
    mr, mc = -(-h // 16), -(-w // 16)  # MCUs: 16x16 pixels
    by, bx = -(-h // 8), -(-w // 8)  # luma blocks that hold image pixels

    # luma: edges replicated to whole blocks; the blocks that complete the
    # last MCU column and row are filled in below
    yp = np.pad(y, ((0, by * 8 - h), (0, bx * 8 - w)), mode="edge")
    grid = np.zeros((2 * mr, 2 * mc, 64), np.int32)
    grid[:by, :bx] = _quantized(_blocks(yp, by, bx), qy).reshape(by, bx, 64)
    if bx < 2 * mc:  # a dummy right column: the DC of its left neighbour
        grid[:by, bx, 0] = grid[:by, bx - 1, 0]
    if by < 2 * mr:  # a dummy bottom row: each MCU's DC of the block above-right
        grid[by, :, 0] = np.repeat(grid[by - 1, 1::2, 0], 2)
    luma = grid.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)

    chroma = []
    for plane in (cb, cr):
        p = np.pad(plane, ((0, (-h) % 2), (0, mc * 16 - w)), mode="edge")
        bias = np.tile(np.array([1, 2], np.int32), mc * 4)
        d = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        d = np.pad(d, ((0, mr * 8 - d.shape[0]), (0, 0)), mode="edge")
        chroma.append(_quantized(_blocks(d, mr, mc), qc).reshape(mr, mc, 1, 64))

    coef = np.concatenate([luma] + chroma, 2).reshape(-1, 64)
    side = np.tile(np.array([0, 0, 0, 0, 1, 1]), mr * mc)
    # DC differences per component (Y, Cb, Cr), in scan order
    dc = coef[:, 0].reshape(mr * mc, 6)
    for cols in ([0, 1, 2, 3], [4], [5]):
        seq = dc[:, cols].reshape(-1)
        dc[:, cols] = np.diff(seq, prepend=0).reshape(-1, len(cols))
    coef[:, 0] = dc.reshape(-1)
    tables = ((_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA))
    step = 6 * _MCUS_PER_SLICE
    data = _join(_threads(lambda i: _pack(*_events(coef[i:i + step], side[i:i + step], tables)),
                          range(0, len(coef), step)))

    def dqt(i, t):
        return _marker(0xDB, bytes([i]) + t[_ZIGZAG].astype(np.uint8).tobytes())

    def dht(cls_id, table):
        bits, vals = table
        return _marker(0xC4, bytes([cls_id]) + bytes(bits) + vals)

    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return b"".join([
        b"\xff\xd8",
        _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        dqt(0, qy), dqt(1, qc), _marker(0xC0, sof),
        dht(0x00, _DC_LUMA), dht(0x10, _AC_LUMA), dht(0x01, _DC_CHROMA), dht(0x11, _AC_CHROMA),
        _marker(0xDA, sos), data, b"\xff\xd9",
    ])


def write_image(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` by the extension: ``.png`` through
    :func:`data.png.write_image` (Sub rows), ``.jpg`` / ``.jpeg`` through
    :func:`encode_jpeg`; any other extension raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        from ssunet_gan_tpu_torch.data.png import write_image as write_png

        write_png(path, img)
        return
    if ext not in (".jpg", ".jpeg"):
        raise ValueError(f"write_image writes .png, .jpg and .jpeg, got {path!r}")
    data = encode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)
