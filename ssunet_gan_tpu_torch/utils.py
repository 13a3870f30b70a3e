"""What the trainer needs of the JAX package's ``utils.py``: the parameter
count and the reference's seeding (train.py:35-39). The rest of that module
is still to port (ROADMAP.md)."""

from __future__ import annotations

import random

import numpy as np
import torch


def count_params(model: torch.nn.Module) -> int:
    """Total number of parameters (utils.py:54-55)."""
    return sum(p.numel() for p in model.parameters())


def seed_everything(torch_seed: int = 41, numpy_seed: int = 101) -> int:
    """Seed ``random`` and numpy's global state with ``numpy_seed`` and
    torch's with ``torch_seed`` (the reference's 41 and 101); returns
    ``torch_seed``, the model's weight seed (``build_model(seed=)``)."""
    np.random.seed(numpy_seed)
    random.seed(numpy_seed)
    torch.manual_seed(torch_seed)
    return torch_seed
