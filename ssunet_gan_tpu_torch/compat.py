"""Weight carry-over from the JAX package's variables to the port.

:func:`from_jax_variables` is the inverse of the JAX package's torch →
flax converter (ssunet_gan_tpu/compat/torch_loader.py:27-77, 179-204):

- HWIO ``kernel`` → OIHW ``weight``; a 2-D ``Dense`` kernel (in, out) →
  ``weight`` (out, in), the Discriminator's top-level ``fc1`` with its
  inputs permuted from the JAX package's NHWC flatten to torch's NCHW one
  (the inverse of torch_loader.py:235 ``discriminator_fc1_transform``);
- BN ``scale``/``bias`` → ``weight``/``bias``, ``mean``/``var`` →
  ``running_mean``/``running_var``; PReLU ``alpha`` → ``weight``;
- the ``spectral`` collection's ``u``/``v`` → the buffers ``weight_u`` /
  ``weight_v``, v from the JAX package's (kh, kw, I) order to torch's (I,
  kh, kw) order (torch_loader.py:186), and that module's kernel →
  ``weight_orig``;
- module names: ``shortcut_conv`` → ``shortcut.0``, ``shortcut_bn`` →
  ``shortcut.1``, ``mlp_shared`` → ``mlp_shared.0``; the SRGAN networks'
  ``block<i>`` → ``conv_blocks.<i>``, ``res<i>`` → ``residual_blocks.<i>``,
  ``subpix<i>`` → ``subpixel_convolutional_blocks.<i>``, and inside an
  ``SRConvBlock`` (``block<i>``, ``conv_block<i>``) ``conv`` →
  ``conv_block.0``, ``bn`` → ``conv_block.1``, ``prelu`` →
  ``conv_block.1`` or, after a BN, ``conv_block.2``. A GAN generator's
  ``net`` level stays the ``net.`` prefix.

It takes plain nested dicts of numpy arrays, so it needs no JAX.
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
# the SRGAN networks' indexed flax modules → the reference's nn.Sequential
_INDEXED = {"block": "conv_blocks", "res": "residual_blocks",
            "subpix": "subpixel_convolutional_blocks"}
_SR_CONV_BLOCK = re.compile(r"(block|conv_block)\d+$")


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(dict(v), prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _node(tree: Dict[str, Any], path: Tuple[str, ...]):
    for seg in path:
        tree = dict(tree).get(seg, {})
    return dict(tree)


def _torch_name(mods: Tuple[str, ...], leaf: str, params: Dict[str, Any]) -> str:
    segs = []
    for i, seg in enumerate(mods):
        m = re.fullmatch(r"(block|res|subpix)(\d+)", seg)
        if m:
            seg = f"{_INDEXED[m.group(1)]}.{m.group(2)}"
        elif i and _SR_CONV_BLOCK.fullmatch(mods[i - 1]) and seg in ("conv", "bn", "prelu"):
            after_bn = "bn" in _node(params, mods[:i])
            seg = "conv_block." + {"conv": "0", "bn": "1",
                                   "prelu": "2" if after_bn else "1"}[seg]
        segs.append(seg)
    name = ".".join(segs + [leaf])
    for pat, repl in _INVERSE_RENAMES:
        name = re.sub(pat, repl, name)
    return name


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats", "spectral"}`` tree of numpy arrays → the
    port's ``state_dict`` (f32 tensors)."""
    params = dict(variables.get("params", {}))
    spectral = dict(variables.get("spectral", {}))
    sn_modules = {tuple(path[:-1]) for path, _ in _leaves(spectral)}
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        mods = tuple(mods)
        a = np.asarray(value, np.float32)
        if leaf == "kernel" and a.ndim == 4:
            name = _torch_name(mods, "weight_orig" if mods in sn_modules else "weight", params)
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            name, a = _torch_name(mods, "weight", params), a.T
            if mods == ("fc1",):  # the Discriminator's: NHWC rows → torch's NCHW
                c = a.shape[1] // 36
                a = a.reshape(-1, 6, 6, c).transpose(0, 3, 1, 2).reshape(a.shape[0], -1)
        elif leaf in ("scale", "alpha"):
            name = _torch_name(mods, "weight", params)
        elif leaf == "bias":
            name = _torch_name(mods, "bias", params)
        else:
            raise ValueError(f"unsupported parameter leaf {'/'.join(path)} ({a.ndim}-D)")
        sd[name] = torch.from_numpy(np.array(a, np.float32))
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _leaves(dict(variables.get("batch_stats", {}))):
        *mods, leaf = path
        if leaf not in stat_names:
            raise ValueError(f"unsupported batch_stats leaf {'/'.join(path)}")
        sd[_torch_name(tuple(mods), stat_names[leaf], params)] = torch.from_numpy(
            np.array(value, np.float32))
    for path, value in _leaves(spectral):
        *mods, leaf = path
        mods = tuple(mods)
        a = np.asarray(value, np.float32)
        if leaf == "v":  # (kh, kw, I) → torch's (I, kh, kw)
            kh, kw, i, _ = np.shape(_node(params, mods)["kernel"])
            a = a.reshape(kh, kw, i).transpose(2, 0, 1).reshape(-1)
        elif leaf != "u":
            raise ValueError(f"unsupported spectral leaf {'/'.join(path)}")
        sd[_torch_name(mods, "weight_" + leaf, params)] = torch.from_numpy(np.array(a, np.float32))
    return sd
