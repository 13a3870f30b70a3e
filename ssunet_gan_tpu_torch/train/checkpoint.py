"""Checkpoints on ``torch.save``: the reference's ``model.pth`` and a
resume state (the JAX package's train/checkpoint.py, there on orbax).

- :func:`save_model` / :func:`load_model` / :func:`model_file`: the best
  model as the reference keeps it (train.py:458-459), a bare
  ``state_dict`` under the reference's module names in
  ``<model_dir>/model.pth``. Loading strips ``module.``
  prefixes (a ``DataParallel`` checkpoint), takes every tensor whose name
  and shape match and reports the rest, as ``load_state_dict(strict=False)``
  and the JAX package's ``_merge_strict_false`` do;
- :func:`save_train_state` / :func:`restore_train_state` /
  :func:`has_train_state`: the model with its BatchNorm buffers and the
  optimizer's state (and the encoder optimizer's of an ``effnet`` arch) in
  ``train_state.pth``, the epoch and ``best_iou`` in the JAX package's
  ``train_meta.json`` sidecar.

- :func:`warm_start_generator`: the GAN generator's ``net`` from a
  supervised ``model.pth`` (the JAX package's train/checkpoint.py:115;
  reference models_seg_gan.py:216-233), ``strict=False``.

The JAX package's orbax directories (``model.orbax``) are not read here:
``tools/torch_from_orbax.py``, run where the JAX package imports, writes
their ``model.pth``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

MODEL_FILE = "model.pth"
ORBAX_DIR = "model.orbax"  # the JAX package's checkpoint directory
STATE_FILE = "train_state.pth"
META_FILE = "train_meta.json"


def _save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_model(model_dir: str, model: torch.nn.Module) -> str:
    """Write ``model``'s ``state_dict`` (on the CPU) to
    ``<model_dir>/model.pth``; returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, MODEL_FILE)
    _save(_cpu_state(model), path)
    return path


def model_file(model_dir: str) -> str:
    """``<model_dir>/model.pth``; raises NotImplementedError where the
    directory holds only the JAX package's orbax checkpoint (naming the
    command that converts it), and FileNotFoundError where it holds
    neither."""
    path = os.path.join(model_dir, MODEL_FILE)
    if not os.path.isfile(path):
        if os.path.isdir(os.path.join(model_dir, ORBAX_DIR)):
            raise NotImplementedError(
                f"{model_dir} holds the JAX package's orbax checkpoint only; the port reads "
                f"{MODEL_FILE}: write it where the JAX package imports with "
                f"`JAX_PLATFORMS=cpu python3 tools/torch_from_orbax.py {model_dir}`")
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    return path


def load_model(path: str, model: torch.nn.Module) -> Dict[str, List[str]]:
    """Load ``path`` (a ``model.pth``, or the directory holding one) into
    ``model``: ``module.`` prefixes stripped, every tensor whose name and
    shape match the model's copied in. Returns the report
    ``{"loaded", "missing", "unmatched"}``: names loaded, names of the model
    the file lacks, and names of the file whose shape differs or that the
    model does not have."""
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    own = model.state_dict()
    report: Dict[str, List[str]] = {"loaded": [], "missing": [], "unmatched": []}
    take = {}
    for name, value in own.items():
        if name not in state:
            report["missing"].append(name)
        elif tuple(state[name].shape) != tuple(value.shape):
            report["unmatched"].append(name)
        else:
            take[name] = state[name]
            report["loaded"].append(name)
    report["unmatched"] += [k for k in state if k not in own]
    model.load_state_dict(take, strict=False)
    return report


def save_train_state(model_dir: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, epoch: int,
                     meta: Optional[Dict[str, Any]] = None,
                     cnn_optimizer: Optional[torch.optim.Optimizer] = None) -> str:
    """The full resume state: parameters, BatchNorm buffers and the
    optimizer's state (and ``cnn_optimizer``'s, where given), with
    ``{"epoch": epoch, **meta}`` in ``train_meta.json``."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, STATE_FILE)
    state = {"model": _cpu_state(model), "optimizer": optimizer.state_dict()}
    if cnn_optimizer is not None:
        state["cnn_optimizer"] = cnn_optimizer.state_dict()
    _save(state, path)
    with open(os.path.join(model_dir, META_FILE), "w") as f:
        json.dump({"epoch": int(epoch), **(meta or {})}, f)
    return path


def restore_train_state(model_dir: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        cnn_optimizer: Optional[torch.optim.Optimizer] = None
                        ) -> Dict[str, Any]:
    """Restore what :func:`save_train_state` wrote into ``model``,
    ``optimizer`` and ``cnn_optimizer`` (onto the model's device; a state
    saved without the encoder optimizer raises KeyError for it); returns
    the meta dict."""
    state = torch.load(os.path.join(model_dir, STATE_FILE), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])  # moves its tensors to the params' device
    if cnn_optimizer is not None:
        cnn_optimizer.load_state_dict(state["cnn_optimizer"])
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(model_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return meta


def has_train_state(model_dir: str) -> bool:
    return os.path.isfile(os.path.join(model_dir, STATE_FILE))


def warm_start_generator(generator: torch.nn.Module, path: str) -> Dict[str, List[str]]:
    """Load a supervised checkpoint into ``generator.net`` with
    :func:`load_model`'s strict=False semantics: ``path`` is a ``model.pth``
    (the port's or the reference's) or the model directory holding it.
    Tensors whose name or shape differ are reported in the returned
    ``{"loaded", "missing", "unmatched"}``, never fatal. A directory with
    only the JAX package's ``model.orbax`` raises NotImplementedError, one
    with neither FileNotFoundError."""
    if os.path.isdir(path):
        path = model_file(path)
    return load_model(path, generator.net)
