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
  ``net`` level stays the ``net.`` prefix;
- the other families' names (torch_loader.py:29-77): ``_blocks_N`` →
  ``_blocks.N``; in ``resnet_conv`` ``conv1`` / ``bn1`` → ``0`` / ``1`` and
  ``layerL_i`` → ``<L+3>.<i>``; ``downsample_conv|bn`` → ``downsample.0|1``;
  ``wg_conv`` / ``wg_bn`` / ``wx_*`` / ``psi_*`` → ``W_g.0|1``, ``W_x.0|1``,
  ``psi.0|1``; the Modulecell's ``features_conv``, ``module_bn1``,
  ``module_dwconv``, ``module_bn2`` → ``features.0``, ``module.0|2|3``.

Some flax names stand for two torch names: a ``ConvBlockBNReLU``'s
``conv1 / bn1 / conv2 / bn2`` are ``conv.0/.1/.3/.4`` where a
``VGGBlock``'s keep their names; an ``UpConv``'s ``conv / bn`` are
``up.1/.2``; an ``SELayer``'s ``fc1 / fc2`` are ``fc.0/.2``; ``UNet_ori``'s
and ``AttUNet``'s ``conv<k>``, ``up<k>``, ``up_conv<k>``, ``att<k>`` and
``final`` are ``Conv<k>``, ``Up<k>``, ``Up_conv<k>``, ``Att<k>`` and
``Conv_1x1``. With ``target`` (the port model, or its ``state_dict``
names) each leaf takes the one candidate name the target has, and a leaf
with none, or with more than one, raises. Without it each takes its first
candidate: the names of the ss-UNets, the VGG-block U-Nets, the GAN's
networks and the encoders.

It takes plain nested dicts of numpy arrays, so it needs no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

# flax module name → its torch names, the first without a target
_ONE_NAME = {
    "shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1",
    "mlp_shared": "mlp_shared.0",
    "downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
    "wg_conv": "W_g.0", "wg_bn": "W_g.1", "wx_conv": "W_x.0", "wx_bn": "W_x.1",
    "psi_conv": "psi.0", "psi_bn": "psi.1",
    "features_conv": "features.0", "module_bn1": "module.0",
    "module_dwconv": "module.2", "module_bn2": "module.3",
}
_TWO_NAMES = {
    "conv1": ("conv1", "conv.0", "Conv1"), "bn1": ("bn1", "conv.1"),
    "conv2": ("conv2", "conv.3", "Conv2"), "bn2": ("bn2", "conv.4"),
    "conv": ("conv", "up.1"), "bn": ("bn", "up.2"),
    "fc1": ("fc1", "fc.0"), "fc2": ("fc2", "fc.2"),
    "final": ("final", "Conv_1x1"),
}
_CAPITALIZED = re.compile(r"(conv|up|up_conv|att)(\d)$")
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


def _candidates(mods: Tuple[str, ...], i: int, params: Dict[str, Any]) -> Tuple[str, ...]:
    """The torch names of flax module ``mods[i]`` in its context."""
    seg, parent = mods[i], mods[i - 1] if i else None
    m = re.fullmatch(r"(block|res|subpix)(\d+)", seg)
    if m:
        return (f"{_INDEXED[m.group(1)]}.{m.group(2)}",)
    if parent is not None and _SR_CONV_BLOCK.fullmatch(parent) and seg in ("conv", "bn",
                                                                            "prelu"):
        after_bn = "bn" in _node(params, mods[:i])
        return ("conv_block." + {"conv": "0", "bn": "1", "prelu": "2" if after_bn else "1"}[seg],)
    m = re.fullmatch(r"_blocks_(\d+)", seg)
    if m:
        return (f"_blocks.{m.group(1)}",)
    if parent == "resnet_conv":
        m = re.fullmatch(r"layer(\d)_(\d+)", seg)
        if m:
            return (f"{int(m.group(1)) + 3}.{m.group(2)}",)
        if seg in ("conv1", "bn1"):
            return ("0" if seg == "conv1" else "1",)
    if seg in _ONE_NAME:
        return (_ONE_NAME[seg],)
    names = _TWO_NAMES.get(seg, (seg,))
    m = _CAPITALIZED.fullmatch(seg)
    if m:
        names = names + (m.group(1).capitalize() + m.group(2),)
    return tuple(dict.fromkeys(names))


class _Namer:
    """flax module path + torch leaf → the torch name (see the module
    docstring); ``target`` names the keys to resolve against."""

    def __init__(self, params: Dict[str, Any], target=None):
        self.params = params
        self.keys = None
        if target is not None:
            self.keys = set(target.state_dict() if hasattr(target, "state_dict") else target)
            self.prefixes = {".".join(k.split(".")[:j]) for k in self.keys
                             for j in range(1, k.count(".") + 1)}

    def __call__(self, mods: Tuple[str, ...], leaf: str) -> str:
        if self.keys is None:
            return ".".join([_candidates(mods, i, self.params)[0] for i in range(len(mods))]
                            + [leaf])
        partial = [""]
        for i in range(len(mods)):
            partial = [f"{p}.{c}" if p else c for p in partial
                       for c in _candidates(mods, i, self.params)
                       if (f"{p}.{c}" if p else c) in self.prefixes]
        names = [f"{p}.{leaf}" if p else leaf for p in partial]
        names = [n for n in names if n in self.keys]
        if len(names) != 1:
            raise ValueError(f"{'/'.join(mods + (leaf,))}: {len(names)} torch names in the "
                             f"target ({names})")
        return names[0]


def from_jax_variables(variables: Dict[str, Any], target=None) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats", "spectral"}`` tree of numpy arrays → the
    port's ``state_dict`` (f32 tensors); ``target`` resolves the names that
    stand for two torch names (the module docstring)."""
    params = dict(variables.get("params", {}))
    spectral = dict(variables.get("spectral", {}))
    sn_modules = {tuple(path[:-1]) for path, _ in _leaves(spectral)}
    name_of = _Namer(params, target)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        mods = tuple(mods)
        a = np.asarray(value, np.float32)
        if leaf == "kernel" and a.ndim == 4:
            name = name_of(mods, "weight_orig" if mods in sn_modules else "weight")
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            name, a = name_of(mods, "weight"), a.T
            if name == "fc1.weight":  # the Discriminator's: NHWC rows → torch's NCHW
                c = a.shape[1] // 36
                a = a.reshape(-1, 6, 6, c).transpose(0, 3, 1, 2).reshape(a.shape[0], -1)
        elif leaf in ("scale", "alpha"):
            name = name_of(mods, "weight")
        elif leaf == "bias":
            name = name_of(mods, "bias")
        else:
            raise ValueError(f"unsupported parameter leaf {'/'.join(path)} ({a.ndim}-D)")
        sd[name] = torch.from_numpy(np.array(a, np.float32))
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _leaves(dict(variables.get("batch_stats", {}))):
        *mods, leaf = path
        if leaf not in stat_names:
            raise ValueError(f"unsupported batch_stats leaf {'/'.join(path)}")
        sd[name_of(tuple(mods), stat_names[leaf])] = torch.from_numpy(
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
        sd[name_of(mods, "weight_" + leaf)] = torch.from_numpy(np.array(a, np.float32))
    return sd
