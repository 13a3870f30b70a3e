"""The scene-tile server (``tileserver.cpp``), bound with ctypes.

Whole-scene inference cuts a scene into overlapping square patches and
resizes each to the model's tile (1024 → 512 at the reference's settings).
The server does both in one pass over the raster, on ``os.cpu_count()``
threads, in OpenCV's INTER_LINEAR fixed point (``cv2.resize``; at an exact
2× it is the 2×2 mean), so a tile equals ``data/transforms.py``
``resize_linear`` of ``data/tiling.py`` ``extract_patches`` bit for bit at
2× and within one level at other scales. ``tileserver.cpp`` is the JAX
package's source, byte for byte.

The library is built with ``g++`` at the first call into the port's
git-ignored ``_build/`` directory, named by a hash of the source, and
reused after. A build or load failure raises: there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tileserver.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
ABI_VERSION = 1
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile ``tileserver.cpp`` unless its library exists; returns the
    library's path. Raises RuntimeError when g++ fails."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libtileserver-{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # one per process; os.replace is atomic
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"the tile server needs g++ to build {SOURCE}: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"tile server build failed: g++ exited {out.returncode}\n{out.stdout}")
    os.replace(tmp, path)
    return path


def tileserver() -> ctypes.CDLL:
    """The bound library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            if lib.tile_server_abi_version() != ABI_VERSION:
                raise RuntimeError(f"tile server ABI {lib.tile_server_abi_version()}, expected "
                                   f"{ABI_VERSION}")
            u8p, i64p, i64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int64)
            lib.tile_extract_resize_u8.argtypes = [u8p, i64, i64, i64, i64p, i64, i64, i64, i64,
                                                   u8p, ctypes.c_int]
            lib.tile_extract_u8.argtypes = [u8p, i64, i64, i64, i64p, i64, i64, u8p, ctypes.c_int]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _checked(scene: np.ndarray, coords: np.ndarray, p_size: int):
    if scene.dtype != np.uint8 or scene.ndim != 3 or not scene.flags.c_contiguous:
        raise ValueError(f"the tile server takes a C-contiguous HWC uint8 scene, got "
                         f"{scene.dtype} {scene.shape}")
    cds = np.ascontiguousarray(coords, dtype=np.int64).reshape(-1, 2)
    h, w, _ = scene.shape
    if p_size < 1 or len(cds) and (cds.min() < 0 or (cds[:, 0] + p_size).max() > h
                                   or (cds[:, 1] + p_size).max() > w):
        raise ValueError(f"patch coords (size {p_size}) fall outside the {h}x{w} scene")
    return cds


def extract_resize_u8(scene: np.ndarray, coords: np.ndarray, p_size: int, out_h: int,
                      out_w: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The (N, out_h, out_w, C) uint8 tiles of the ``p_size``² patches at
    ``coords`` ((N, 2) (y, x) origins) of the HWC uint8 ``scene``, each
    resized as ``cv2.resize`` INTER_LINEAR; into ``out`` when given (a
    C-contiguous uint8 array of that shape, e.g. pinned host memory)."""
    cds = _checked(scene, coords, p_size)
    c = scene.shape[2]
    if out is None:
        out = np.empty((len(cds), out_h, out_w, c), np.uint8)
    if out.shape != (len(cds), out_h, out_w, c) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 {(len(cds), out_h, out_w, c)}, got "
                         f"{out.dtype} {out.shape}")
    tileserver().tile_extract_resize_u8(
        _ptr(scene, ctypes.c_uint8), *scene.shape, _ptr(cds, ctypes.c_int64), len(cds), p_size,
        out_h, out_w, _ptr(out, ctypes.c_uint8), os.cpu_count() or 1)
    return out


def extract_u8(scene: np.ndarray, coords: np.ndarray, p_size: int) -> np.ndarray:
    """The (N, p_size, p_size, C) uint8 patches at ``coords`` (the masks'
    crop, at full patch resolution)."""
    cds = _checked(scene, coords, p_size)
    out = np.empty((len(cds), p_size, p_size, scene.shape[2]), np.uint8)
    tileserver().tile_extract_u8(
        _ptr(scene, ctypes.c_uint8), *scene.shape, _ptr(cds, ctypes.c_int64), len(cds), p_size,
        _ptr(out, ctypes.c_uint8), os.cpu_count() or 1)
    return out
