"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and no source of the port (chip_smoke.py included) imports
them."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ssunet_gan_tpu_torch")
MODULES = (
    "ssunet_gan_tpu_torch", "ssunet_gan_tpu_torch.config",
    "ssunet_gan_tpu_torch.compat", "ssunet_gan_tpu_torch._build",
    "ssunet_gan_tpu_torch.models", "ssunet_gan_tpu_torch.ops.stage_kernel",
    "ssunet_gan_tpu_torch.data.tiling", "ssunet_gan_tpu_torch.infer.api",
    "ssunet_gan_tpu_torch.ops.stage_kernel_train", "ssunet_gan_tpu_torch.ops.losses",
    "ssunet_gan_tpu_torch.ops.metrics", "ssunet_gan_tpu_torch.data.dataset",
    "ssunet_gan_tpu_torch.data.loader", "ssunet_gan_tpu_torch.data.transforms",
    "ssunet_gan_tpu_torch.train.optim", "ssunet_gan_tpu_torch.train.step",
    "ssunet_gan_tpu_torch.train.supervised", "ssunet_gan_tpu_torch.ops.train_bwd",
    "ssunet_gan_tpu_torch.ops.stage_kernel_int8", "ssunet_gan_tpu_torch.infer.calibrate",
    "ssunet_gan_tpu_torch.ops.stage_kernel_bneck", "ssunet_gan_tpu_torch.ops.spade_kernel",
    "ssunet_gan_tpu_torch.ops.spade", "ssunet_gan_tpu_torch.ops.blocks",
    "ssunet_gan_tpu_torch.models.ssunet", "ssunet_gan_tpu_torch.data.png",
    "ssunet_gan_tpu_torch.utils", "ssunet_gan_tpu_torch.train.checkpoint",
    "ssunet_gan_tpu_torch.cli.train", "ssunet_gan_tpu_torch.native",
    "ssunet_gan_tpu_torch.data.jpeg", "ssunet_gan_tpu_torch.infer.overlays",
    "ssunet_gan_tpu_torch.models.gan", "ssunet_gan_tpu_torch.cli.val_patch",
    "ssunet_gan_tpu_torch.ops.spectral", "ssunet_gan_tpu_torch.models.vgg",
    "ssunet_gan_tpu_torch.train.gan_step", "ssunet_gan_tpu_torch.train.gan",
    "ssunet_gan_tpu_torch.cli.train_seg_gan", "ssunet_gan_tpu_torch.srgan_utils",
    "ssunet_gan_tpu_torch.parallel", "ssunet_gan_tpu_torch.ops.collectives",
)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ssunet_gan_tpu' or m.startswith('ssunet_gan_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "ssunet_gan_tpu"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")
