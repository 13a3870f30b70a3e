"""Build and load the port's CUDA kernels.

A ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. The library
lands in ``_build/`` next to this file (git-ignored), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. Nothing
is compiled at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of ssunet_gan_tpu_torch are built from csrc/ at first use"
    )


def _lib_path(source: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library's path. nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept in a ``.log`` beside it."""
    lib = _lib_path(source)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"  # one per process; os.replace is atomic
    out = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(os.path.splitext(lib)[0] + ".log", "w") as f:
        f.write(out.stdout)
    if out.returncode != 0:
        raise RuntimeError(f"kernel build failed: {source}: nvcc exited "
                           f"{out.returncode}\n{out.stdout}")
    os.replace(tmp, lib)
    return lib


def build_log(source: str) -> str:
    """nvcc's output from the build of ``source`` ('' if none kept)."""
    log = os.path.splitext(_lib_path(source))[0] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    return ctypes.CDLL(build(source))
