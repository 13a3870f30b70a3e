"""Optimizers and per-epoch LR schedulers with torch semantics, as the JAX
package builds them (train/optim.py; reference train.py:295-320).

``weight_decay`` is torch's L2 term (``grad += wd·p`` before the moment
updates), which the JAX package's optax chain reproduces; Adam runs with
betas (0.9, 0.999) and eps 1e-8; SGD momentum is torch's ``buf = μ·buf +
grad`` with optional Nesterov. The train step sets the learning rate per
step (:func:`set_lr`), so a scheduler's move changes nothing else.

A model whose arch names ``effnet`` trains its encoder's EfficientNet on a
second Adam (train/optim.py:50-74; reference train.py:274-301):
:func:`encoder_param_labels` splits the parameters into "cnn"
(``encoder.eff_conv``) and "main" (everything else, ``encoder.conv_a``
included), :func:`build_cnn_optimizer` is that Adam with the experiment's
weight decay, and the step sets its rate to ``lr_cnn``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    config: Dict[str, Any]) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` or ``SGD`` from the experiment config
    (train.py:295-301); other names raise NotImplementedError, as in the
    reference."""
    wd = float(config.get("weight_decay", 0.0) or 0.0)
    lr = float(config.get("lr", 1e-3))
    name = config["optimizer"]
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    if name == "SGD":
        mom = float(config.get("momentum", 0.0) or 0.0)
        nesterov = bool(config.get("nesterov", False)) and mom > 0
        return torch.optim.SGD(params, lr=lr, momentum=mom, nesterov=nesterov,
                               weight_decay=wd)
    raise NotImplementedError(name)


def build_cnn_optimizer(params: Iterable[torch.nn.Parameter],
                        config: Dict[str, Any]) -> torch.optim.Optimizer:
    """The encoder's Adam: betas (0.9, 0.999), eps 1e-8, the experiment's
    weight decay as torch's L2 term (optax ``add_decayed_weights`` →
    ``scale_by_adam``); the rate is the step's ``lr_cnn``."""
    wd = float(config.get("weight_decay", 0.0) or 0.0)
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)


def encoder_param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: "cnn" or "main"}: "cnn" for the parameters under a
    module named ``eff_conv``, "main" for the rest."""
    return {name: "cnn" if "eff_conv" in name.split(".")[:-1] else "main"
            for name, _ in model.named_parameters()}


def split_encoder_params(model: torch.nn.Module):
    """(main parameters, cnn parameters) by :func:`encoder_param_labels`."""
    labels = encoder_param_labels(model)
    params = dict(model.named_parameters())
    return ([p for n, p in params.items() if labels[n] == "main"],
            [p for n, p in params.items() if labels[n] == "cnn"])


def adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The GAN trainer's bare Adam (train/optim.py:77; reference
    train_seg_gan.py:452, 468): betas (0.9, 0.999), eps 1e-8, no weight
    decay; the rate is the step's ``lr`` argument (:func:`set_lr`)."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class LRScheduler:
    """Per-epoch LR schedule: ``lr(epoch)`` is the rate of that epoch.
    ReduceLROnPlateau is stateful: call :meth:`step_plateau` with the
    monitored value after each epoch (train.py:430)."""

    def __init__(self, base_lr: float):
        self.base_lr = float(base_lr)

    def lr(self, epoch: int) -> float:
        return self.base_lr

    def step_plateau(self, value: float) -> None:
        return None


class ConstantLR(LRScheduler):
    pass


class CosineAnnealingLR(LRScheduler):
    """torch CosineAnnealingLR's closed form, stepped once per epoch."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.t_max = int(t_max)
        self.eta_min = float(eta_min)

    def lr(self, epoch: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)) / 2


class MultiStepLR(LRScheduler):
    """torch MultiStepLR: × gamma at each milestone epoch."""

    def __init__(self, base_lr: float, milestones, gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def lr(self, epoch: int) -> float:
        return self.base_lr * self.gamma ** sum(1 for m in self.milestones if m <= epoch)


class ReduceLROnPlateau(LRScheduler):
    """torch ReduceLROnPlateau (mode 'min', relative threshold)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        super().__init__(base_lr)
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.threshold = float(threshold)
        self.current = float(base_lr)
        self.best: Optional[float] = None
        self.num_bad = 0

    def lr(self, epoch: int) -> float:
        return self.current

    def step_plateau(self, value: float) -> None:
        value = float(value)
        if self.best is None or value < self.best * (1 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.current = max(self.current * self.factor, self.min_lr)
            self.num_bad = 0


def build_scheduler(config: Dict[str, Any]) -> LRScheduler:
    """The scheduler of train.py:303-320: only SGD schedules; Adam runs at
    a constant rate. Unknown SGD schedulers raise, as in the reference."""
    base_lr = float(config["lr"])
    if config["optimizer"] != "SGD":
        return ConstantLR(base_lr)
    name = config.get("scheduler", "ConstantLR")
    if name == "CosineAnnealingLR":
        return CosineAnnealingLR(base_lr, config["epochs"], float(config.get("min_lr", 0.0)))
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base_lr, factor=float(config.get("factor", 0.1)),
                                 patience=int(config.get("patience", 10)),
                                 min_lr=float(config.get("min_lr", 0.0)))
    if name == "MultiStepLR":
        milestones = [int(e) for e in str(config["milestones"]).split(",")]
        return MultiStepLR(base_lr, milestones, float(config.get("gamma", 0.1)))
    if name == "ConstantLR":
        return ConstantLR(base_lr)
    raise NotImplementedError(name)
