"""The supervised epoch loop (the JAX package's train/supervised.py
``train_one_epoch`` :115, ``evaluate`` :143, ``_epoch_mean`` :56).

The host keeps at most two steps in flight before it waits for the card
(supervised.py:135-136), and reads the metrics once per epoch.
``run_experiment`` (log.csv, TensorBoard, checkpoints) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ssunet_gan_tpu_torch import resolve_device


def _epoch_mean(metric_list: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The per-epoch means of on-device metric dicts, synced once."""
    if not metric_list:
        return {"loss": 0.0, "iou": 0.0, "dice": 0.0}
    return {k: float(torch.stack([m[k].float() for m in metric_list]).mean().cpu())
            for k in metric_list[0]}


def _mark_step(events: List, device: torch.device) -> None:
    """Record the end of the step just queued and wait for the end of the
    one before it: at most two steps in flight."""
    if device.type != "cuda":
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    events.append(ev)
    if len(events) >= 2:
        events[-2].synchronize()


def train_one_epoch(epoch: int, config: Dict, loader, train_step, lr: float,
                    device="cuda"):
    """One pass over ``loader`` (batches of ``(ori, img, mask, meta)``,
    numpy NHWC) through ``train_step``; images in bf16 when
    ``config["mixed_precision"]``. Returns the epoch's mean metrics and
    ``images_per_sec``."""
    device = resolve_device(device)
    meters, events = [], []
    n_images = 0
    img_dtype = torch.bfloat16 if config.get("mixed_precision") else torch.float32
    t0 = time.time()
    for _, img, mask, _ in loader:
        x = torch.from_numpy(img).to(device).to(img_dtype)
        y = torch.from_numpy(mask).to(device)
        meters.append(train_step(x, y, lr))
        n_images += img.shape[0]
        _mark_step(events, device)
    log = _epoch_mean(meters)
    log["images_per_sec"] = n_images / max(time.time() - t0, 1e-9)
    return log


def evaluate(config: Dict, loader, eval_step, device="cuda") -> Dict[str, float]:
    """Mean metrics of ``eval_step`` over ``loader``, the images in the
    loader's dtype as the JAX package passes them (f32: on the card the
    BasicBlock stages then run the module composition, as the stage gate
    refuses f32). ``config`` is accepted for the JAX signature."""
    device = resolve_device(device)
    meters, events = [], []
    for _, img, mask, _ in loader:
        x = torch.from_numpy(img).to(device)
        meters.append(eval_step(x, torch.from_numpy(mask).to(device)))
        _mark_step(events, device)
    return _epoch_mean(meters)
