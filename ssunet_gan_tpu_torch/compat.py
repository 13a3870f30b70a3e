"""Weight carry-over from the JAX package's variables to the port.

:func:`from_jax_variables` is the inverse of the JAX package's torch →
flax converter (ssunet_gan_tpu/compat/torch_loader.py:27-77, 179-204) for
the ss-UNets' leaves: HWIO ``kernel`` → OIHW ``weight``, BN ``scale``/
``bias`` → ``weight``/``bias``, ``mean``/``var`` → ``running_mean``/
``running_var``, ``shortcut_conv`` → ``shortcut.0``, ``shortcut_bn`` →
``shortcut.1`` (the Bottleneck's, parameters and statistics) and
``mlp_shared`` → ``mlp_shared.0``. It takes plain nested dicts of numpy arrays, so it needs
no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

# flax module path → torch module path (inverse of torch_loader's rules)
_INVERSE_RENAMES = (
    (r"(^|\.)shortcut_conv\.", r"\1shortcut.0."),
    (r"(^|\.)shortcut_bn\.", r"\1shortcut.1."),
    (r"(^|\.)mlp_shared\.", r"\1mlp_shared.0."),
)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(dict(v), prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _torch_name(path: Tuple[str, ...], leaf: str) -> str:
    name = ".".join(path) + "." + leaf
    for pat, repl in _INVERSE_RENAMES:
        name = re.sub(pat, repl, name)
    return name


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays → the port's
    ``state_dict`` (f32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(dict(variables.get("params", {}))):
        *mods, leaf = path
        a = np.asarray(value, np.float32)
        if leaf == "kernel":
            if a.ndim != 4:
                raise ValueError(f"unsupported {a.ndim}-D kernel at {'/'.join(path)}")
            name, a = _torch_name(tuple(mods), "weight"), a.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            name = _torch_name(tuple(mods), "weight")
        elif leaf == "bias":
            name = _torch_name(tuple(mods), "bias")
        else:
            raise ValueError(f"unsupported parameter leaf {'/'.join(path)}")
        sd[name] = torch.from_numpy(np.array(a, np.float32))
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _leaves(dict(variables.get("batch_stats", {}))):
        *mods, leaf = path
        if leaf not in stat_names:
            raise ValueError(f"unsupported batch_stats leaf {'/'.join(path)}")
        sd[_torch_name(tuple(mods), stat_names[leaf])] = torch.from_numpy(
            np.array(value, np.float32))
    return sd
