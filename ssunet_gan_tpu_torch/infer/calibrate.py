"""Post-training int8 calibration: static activation scales.

The int8 stages (:mod:`ops.stage_kernel_int8`) default to dynamic
per-tensor activation scales: an abs-max pass over every stage input and
numerics that depend on the batch. One recording pass over representative
tiles captures each stage input's abs-max; installed through
:func:`ops.stage_kernel_int8.set_int8_calibration` they make every quantize
one elementwise pass with batch-independent numbers, and let the encoder
stages emit s8 for their consumers.

Recording goes through the model's dispatch (``models/ssunet.py``): while a
record sink is active every stage runs the plain composition and writes its
inputs' abs-max into the sink. The keys (``"<stage>:<part>"``, and
``"<stage>:<part>:half"`` for the inputs of the bilinear upsamples) and the
file (``int8_scales.json`` beside the model card) are the JAX package's
(``infer/calibrate.py``), so a file written by either loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import (
    set_int8_calibration,
    set_record_sink,
)

SCALES_FILE = "int8_scales.json"


def record_activation_ranges(model, tiles: np.ndarray, batch_size: int = 16,
                             dtype: Optional[torch.dtype] = None,
                             device="cuda") -> Dict[str, float]:
    """One max-calibration pass: eval-forward ``tiles`` (N, H, W, C float32,
    already model-normalized) in batches of ``batch_size`` on ``device``,
    where the model must be; returns ``{"<stage>:<part>": abs_max}``, the
    largest over all batches. The last batch is filled by repeating tile 0
    (a repeat cannot raise a maximum). ``dtype`` casts the model input
    (None keeps float32)."""
    dev = resolve_device(device)
    n = len(tiles)
    if n == 0:
        raise ValueError("calibration needs at least one tile")
    pad = (-n) % batch_size
    if pad:
        tiles = np.concatenate([tiles, np.repeat(tiles[:1], pad, axis=0)])
    ranges: Dict[str, float] = {}
    for i in range(0, len(tiles), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(tiles[i:i + batch_size])).to(dev)
        if dtype is not None:
            x = x.to(dtype)
        sink: dict = {}
        set_record_sink(sink)
        try:
            with torch.no_grad():
                model(x)
        finally:
            set_record_sink(None)
        for k, v in sink.items():
            ranges[k] = max(ranges.get(k, 0.0), float(v))
    if not ranges:
        raise ValueError("the model recorded no stage inputs: is it an SS-family arch "
                         "in eval mode?")
    return ranges


def save_calibration(model_dir: str, scales: Dict[str, float]) -> str:
    """Write the scales beside the model card; returns the file's path."""
    path = os.path.join(model_dir, SCALES_FILE)
    with open(path, "wt") as f:
        json.dump({k: float(v) for k, v in scales.items()}, f, indent=1, sort_keys=True)
    return path


def load_calibration(model_dir: str) -> Optional[Dict[str, float]]:
    """The scales kept in ``model_dir``, or None where there is no file."""
    path = os.path.join(model_dir, SCALES_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "rt") as f:
        return {k: float(v) for k, v in json.load(f).items()}


def calibrate_int8(model, tiles: np.ndarray, model_dir: Optional[str] = None,
                   batch_size: int = 16, dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Dict[str, float]:
    """Record the ranges, install them as the active static scales and,
    with ``model_dir``, write them there. Returns the scales."""
    scales = record_activation_ranges(model, tiles, batch_size, dtype, device)
    set_int8_calibration(scales)
    if model_dir is not None:
        save_calibration(model_dir, scales)
    return scales
