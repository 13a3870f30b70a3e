"""PyTorch/CUDA port of ssunet_gan_tpu for NVIDIA Hopper (H100).

It serves ``UNet_R_SS_v2`` (the flagship), ``UNet_R_SS`` and ``UNet_B_SS``:
the eval tile forward and whole-scene sliding-window inference with merged
masks, in bf16 or through calibrated int8 stages (``ops/stage_kernel_int8.py``,
``infer/calibrate.py``), and it trains the flagship and ``UNet_B_SS``
(``ops/stage_kernel_train.py``, ``ops/train_bwd.py``, ``train/``) and
fine-tunes a generator adversarially against the SRGAN discriminator
(``train/gan.py``, ``train/gan_step.py``, ``models/gan.py``). Each of the nine TPU kernels of the JAX
package has a hand-written CUDA counterpart under ``csrc/``: the fused
[BasicBlock + self-SPADE] eval stage (``ops/stage_kernel.py``), the
Bottleneck one (``ops/stage_kernel_bneck.py``), the int8 stage, the train
stage's kernels, the v3 backward's kernels and the self-SPADE stage
(``ops/spade_kernel.py``); everything else is plain PyTorch.

Tensors at the public functions are NHWC, as in the JAX package, and
parameters carry the reference's torch module names (OIHW weights), so a
reference ``model.pth`` loads with ``load_state_dict``.

The package imports ``torch`` and never ``jax`` or ``ssunet_gan_tpu``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; there the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and none is present (the CPU is never chosen silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
