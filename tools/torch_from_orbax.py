#!/usr/bin/env python3
"""The JAX package's model checkpoints (``model.orbax``) as the PyTorch
port's ``model.pth``.

    JAX_PLATFORMS=cpu python3 tools/torch_from_orbax.py MODEL_DIR [MODEL_DIR ...]

Runs where the JAX package and orbax import (the card machine has
neither; the port reads ``model.pth`` only). For each model directory
(``config.yml`` + ``model.orbax``, as ``ssunet_gan_tpu.train.checkpoint``
writes them):

1. the model card, read by the JAX package's ``load_model_card``;
2. ``model.orbax`` restored as ``ssunet_gan_tpu/infer/api.py`` restores it:
   the bare arch's ``jit_init`` template at the card's ``input_h`` ×
   ``input_w``, and, where that fails, the GAN ``Generator``'s (its arch
   under ``net``);
3. the variables carried onto the port's model (``build_model`` or
   ``models.gan.Generator.from_config``, on the CPU) by
   ``ssunet_gan_tpu_torch.compat.from_jax_variables``, every tensor of the
   port's ``state_dict`` written;
4. ``model.pth`` written beside ``model.orbax`` by the port's
   ``train/checkpoint.py`` ``save_model``.

Prints, per directory, the file written, its tensor count and whether the
checkpoint was a generator's.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ssunet_gan_tpu.config import load_model_card  # noqa: E402
from ssunet_gan_tpu.models import build_model as jax_build_model  # noqa: E402
from ssunet_gan_tpu.models.gan import Generator as JaxGenerator  # noqa: E402
from ssunet_gan_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from ssunet_gan_tpu.utils import jit_init  # noqa: E402
from ssunet_gan_tpu_torch.compat import from_jax_variables  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model  # noqa: E402
from ssunet_gan_tpu_torch.models.gan import Generator  # noqa: E402
from ssunet_gan_tpu_torch.train.checkpoint import save_model  # noqa: E402


def restore(model_dir: str, config: dict):
    """``(variables, generator)``: the directory's ``model.orbax`` restored
    on the bare arch's template, else on the ``Generator``'s."""
    sample = jnp.zeros((1, config["input_h"], config["input_w"], config["input_channels"]),
                       jnp.float32)

    def load(model):
        template = jax.device_get(jit_init(model, jax.random.PRNGKey(0), sample, train=False))
        return jax.device_get(jax_checkpoint.load_model(model_dir, template))

    try:
        return load(jax_build_model(config["arch"], config["num_classes"],
                                    config["input_channels"],
                                    bool(config["deep_supervision"]))), False
    except Exception:  # a GAN generator's checkpoint: the arch under ``net``
        return load(JaxGenerator.from_config(config)), True


def convert(model_dir: str) -> dict:
    """Write ``<model_dir>/model.pth`` from its ``model.orbax``; returns
    ``{"path", "tensors", "generator"}``."""
    config = load_model_card(model_dir)
    variables, generator = restore(model_dir, config)
    if generator:
        model = Generator.from_config(config, device="cpu")
    else:
        model = build_model(config["arch"], config["num_classes"], config["input_channels"],
                            bool(config["deep_supervision"]), device="cpu")
    state = from_jax_variables(variables, target=model)
    model.load_state_dict(state)  # strict: every tensor of the port's model written
    return {"path": save_model(model_dir, model), "tensors": len(state),
            "generator": generator}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dirs", nargs="+", metavar="MODEL_DIR",
                    help="a directory holding config.yml and model.orbax")
    args = ap.parse_args(argv)
    for model_dir in args.model_dirs:
        out = convert(model_dir)
        print(f"{out['path']}: {out['tensors']} tensors"
              + (" (a GAN generator's checkpoint, under net.)" if out["generator"] else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
