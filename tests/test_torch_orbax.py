"""``tools/torch_from_orbax.py``: the JAX package's ``model.orbax``
directories as the port's ``model.pth``, on the CPU.

A full-width ``UNet`` (the lightest registry arch) at 32²: ``jit_init``
variables with seeded BatchNorm statistics, saved by the JAX package's
``train/checkpoint.py`` ``save_model`` bare and as a GAN ``Generator``'s
(the arch under ``net``), each beside a model card; the converter writes
``model.pth`` beside each; the port's ``infer/api.py`` ``load_model_dir``
reads it (the generator through its ``net.`` retry) and its f32 forward
equals the JAX model's within the parity tests' eval bar (1e-5 relative
L2). The converter's own templates are ``jax.eval_shape`` zeros in place of
``jit_init`` (the same shapes and dtypes, no compile). ``model_file``'s
error names the converter.
"""

import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.config import dump_model_card as jax_dump_model_card
from ssunet_gan_tpu.models import build_model as jax_build_model
from ssunet_gan_tpu.models.gan import Generator as JaxGenerator
from ssunet_gan_tpu.train import checkpoint as jax_checkpoint
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.infer.api import load_model_dir
from ssunet_gan_tpu_torch.models.gan import Generator
from ssunet_gan_tpu_torch.train.checkpoint import model_file, warm_start_generator
from torch_port_helpers import randomize_batch_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
CARD = {"arch": "UNet", "num_classes": 3, "input_channels": 3, "deep_supervision": False,
        "input_h": HW, "input_w": HW}
EVAL_TOL = 1e-5


def _tool():
    path = os.path.join(ROOT, "tools", "torch_from_orbax.py")
    spec = importlib.util.spec_from_file_location("torch_from_orbax", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shape_init(model, key, *sample, train=True):
    shapes = jax.eval_shape(lambda k, *a: model.init(k, *a, train), key, *sample)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Two JAX model directories (bare, generator) of one set of weights,
    converted in one call of the tool's ``main``; (root, variables, printed)."""
    root = tmp_path_factory.mktemp("orbax")
    x0 = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = randomize_batch_stats(jax.device_get(
        jit_init(jax_build_model("UNet", 3, 3), jax.random.PRNGKey(1), x0, train=False)))
    wrapped = {k: {"net": v} for k, v in variables.items()}  # Generator's tree
    for name, tree in (("bare", variables), ("gan", wrapped)):
        jax_dump_model_card({**CARD, "name": name}, str(root / name))
        jax_checkpoint.save_model(str(root / name), tree)
    tool = _tool()
    mp = pytest.MonkeyPatch()
    mp.setattr(tool, "jit_init", _shape_init)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tool.main([str(root / "bare"), str(root / "gan")]) == 0
    finally:
        mp.undo()
    return root, variables, out.getvalue()


def test_bare_checkpoint_loads_and_matches_jax(converted):
    root, variables, printed = converted
    model = load_model_dir(str(root / "bare"), CARD, "cpu")
    n = len(model.state_dict())
    assert f"{root / 'bare' / 'model.pth'}: {n} tensors\n" in printed
    assert not isinstance(model, Generator) and not model.training
    x = np.random.default_rng(4).normal(size=(2, HW, HW, 3)).astype(np.float32)
    want = jax.jit(lambda vs, x: jax_build_model("UNet", 3, 3).apply(vs, x, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert _rel_l2(got.numpy(), want) <= EVAL_TOL


def test_generator_checkpoint_loads_through_the_net_retry(converted, capsys):
    root, variables, printed = converted
    assert "gan/model.pth" in printed and "GAN generator" in printed
    state = torch.load(root / "gan" / "model.pth", weights_only=True)
    assert state and all(k.startswith("net.") for k in state)
    model = load_model_dir(str(root / "gan"), CARD, "cpu")
    assert isinstance(model, Generator)
    assert "=> loaded as GAN generator checkpoint" in capsys.readouterr().out
    x = np.random.default_rng(5).normal(size=(1, HW, HW, 3)).astype(np.float32)
    wrapped = {k: {"net": v} for k, v in variables.items()}
    want = jax.jit(lambda vs, x: JaxGenerator.from_config(CARD).apply(vs, x, False))(
        wrapped, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert _rel_l2(got.numpy(), want) <= EVAL_TOL


def test_model_file_names_the_converter(tmp_path):
    os.makedirs(tmp_path / "model.orbax")
    for call in (lambda: model_file(str(tmp_path)),
                 lambda: warm_start_generator(None, str(tmp_path))):
        with pytest.raises(NotImplementedError, match="orbax") as err:
            call()
        assert "tools/torch_from_orbax.py" in str(err.value) and str(tmp_path) in str(err.value)
    os.rmdir(tmp_path / "model.orbax")
    with pytest.raises(FileNotFoundError):
        model_file(str(tmp_path))
