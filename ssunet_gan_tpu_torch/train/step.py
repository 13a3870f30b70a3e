"""The supervised train and eval steps (the JAX package's train/step.py
:36-201 and :288; reference train.py:79-120, 141-190).

Reference quirks kept as behaviour:

- ``output[isnan] = 0`` before the loss and the metrics (train.py:100);
- IoU and Dice on channels 1..C−1 only (train.py:101-102);
- the gradients are taken at the unclamped weights, then every parameter
  is clamped to ±clip, then the optimizer steps (train.py:111-116);
- deep supervision averages the loss over the heads and scores the last
  head on all channels (train.py:84-95).

``accum_steps`` > 1 (the JAX package's, train/step.py:133-165) splits the
batch into interleaved microbatches (rows j, k+j, 2k+j, …), each forward
and backward in training mode, so the BatchNorms' running statistics move
once per microbatch; the gradients are averaged, then come one clamp and
one optimizer step, and the metrics are the microbatches' means.

With ``mesh`` (the JAX package's ``_make_train_step_shard_map``,
train/step.py:204-280) the step is data-parallel: each rank runs forward
and backward on its slice of the global batch (``parallel.shard_batch``)
inside the mesh's train axis, where the BatchNorm statistics, the fused
train stage's sums and the metrics cross the ranks; then one all-reduce
averages the gradients, the metrics are averaged, and the clamp and the
optimizer step run alike on every rank. The fused train stages run there
as in one process, in every microbatch: the ranks' strided microbatches
``image[j::k]`` of their contiguous slices make up the global batch's
microbatch ``j``. Equal slices give the numbers one process gives on the
global batch.

The metrics stay on the device: the step never waits for the card.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ssunet_gan_tpu_torch.ops.metrics import dice_coef, foreground_slice, iou_score
from ssunet_gan_tpu_torch.parallel import (
    average_gradients,
    check_mesh,
    pmean_metrics,
    sharded_step,
)
from ssunet_gan_tpu_torch.train.optim import set_lr


def _scrub_nan(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _forward_loss(model, loss_fn, num_classes, deep_supervision, image, target):
    out = model(image)
    if deep_supervision and isinstance(out, (list, tuple)):
        outs = [_scrub_nan(o) for o in out]
        loss = sum(loss_fn(o, target) for o in outs) / len(outs)
        out_m, tar_m = outs[-1], target
    else:
        out = _scrub_nan(out)
        loss = loss_fn(out, target)
        out_m = foreground_slice(out, num_classes)
        tar_m = foreground_slice(target, num_classes)
    with torch.no_grad():
        metrics = {"loss": loss.detach(), "iou": iou_score(out_m, tar_m),
                   "dice": dice_coef(out_m, tar_m)}
    return loss, metrics


def make_train_step(model, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    num_classes: int, deep_supervision: bool = False,
                    clip: float = 0.0, accum_steps: int = 1, mesh=None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(image, target, lr) -> metrics`` over NHWC batches on the
    model's device: forward in training mode (BatchNorm running statistics
    move), loss, backward, clamp, optimizer step; in ``accum_steps``
    microbatches, each with its own forward and backward, before the one
    update. ``metrics`` holds device tensors (loss, iou, dice). Under
    ``mesh`` (a ``parallel.Mesh``) ``image`` and ``target`` are this rank's
    slice of the global batch, whose per-rank size divides by
    ``accum_steps``; a mesh with a model axis raises."""
    k = int(accum_steps)
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        check_mesh(mesh)
    params = [p for p in model.parameters() if p.requires_grad]

    def grads(image, target):
        if k == 1:
            loss, metrics = _forward_loss(model, loss_fn, num_classes, deep_supervision,
                                          image, target)
            loss.backward()
            return metrics
        if image.shape[0] % k:
            raise ValueError(f"batch {image.shape[0]} not divisible by accum_steps={k}")
        micro = []
        for j in range(k):
            loss, m = _forward_loss(model, loss_fn, num_classes, deep_supervision,
                                    image[j::k], target[j::k])
            (loss / k).backward()  # the sum of the k gradients / k: their mean
            micro.append(m)
        return {key: torch.stack([m[key] for m in micro]).mean() for key in micro[0]}

    def step(image: torch.Tensor, target: torch.Tensor, lr: float):
        model.train()
        set_lr(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        with sharded_step(mesh):
            metrics = grads(image, target)
        if mesh is not None:
            average_gradients(mesh, params)
            metrics = pmean_metrics(mesh, metrics)
        if clip and clip > 0:
            with torch.no_grad():
                for p in params:
                    p.clamp_(-clip, clip)
        optimizer.step()
        return metrics

    return step


def make_eval_step(model, loss_fn: Callable, num_classes: int,
                   deep_supervision: bool = False
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(image, target) -> metrics`` in eval mode (running BN
    statistics, no state change)."""

    def step(image: torch.Tensor, target: torch.Tensor):
        model.eval()
        with torch.no_grad():
            return _forward_loss(model, loss_fn, num_classes, deep_supervision,
                                 image, target)[1]

    return step
