"""Truncated VGG19 feature network (the JAX package's models/vgg.py;
reference models_seg_gan.py:303-352), NHWC: the feature map of the j-th
convolution (after its ReLU) before the i-th max-pool of VGG19, the SRGAN
"VGG loss" space. Present but unused in the reference's training.

The layers sit in ``truncated_vgg19``, an ``nn.Sequential`` with
torchvision's ``features`` indices (conv at index k, its ReLU at k + 1,
max-pools between), as the reference names them. The weights start
random: the repo has no pretrained VGG19 and fetches none;
:func:`load_torch_vgg19` takes a torchvision ``vgg19().features`` or a
reference ``TruncatedVGG19`` state_dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.pool import max_pool_2x2

# VGG19 "features": (torchvision index, out channels) per conv, "M" a
# max-pool (torchvision's cfg "E")
VGG19_PLAN: List = [
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), (16, 256), "M",
    (19, 512), (21, 512), (23, 512), (25, 512), "M",
    (28, 512), (30, 512), (32, 512), (34, 512), "M",
]


def truncation_point(i: int, j: int) -> int:
    """Plan entries to keep: through the j-th conv after the (i−1)-th
    max-pool (models_seg_gan.py:320-341)."""
    maxpool_counter = conv_counter = 0
    for idx, entry in enumerate(VGG19_PLAN):
        if entry == "M":
            maxpool_counter += 1
            conv_counter = 0
        else:
            conv_counter += 1
        if maxpool_counter == i - 1 and conv_counter == j:
            return idx + 1
    raise AssertionError(
        "One or both of i=%d and j=%d are not valid choices for the VGG19!" % (i, j))


class _MaxPool2x2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x)


class TruncatedVGG19(nn.Module):
    """VGG19 features truncated at conv (i, j), the SRGAN default (5, 4);
    RGB in (3 channels)."""

    def __init__(self, i: int = 5, j: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, in_ch = [], 3
        for entry in VGG19_PLAN[:truncation_point(i, j)]:
            if entry == "M":
                layers.append(_MaxPool2x2())
            else:
                _, ch = entry
                layers += [Conv2d(in_ch, ch, 3, 1, generator=generator), nn.ReLU()]
                in_ch = ch
        self.truncated_vgg19 = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.truncated_vgg19(x)


def load_torch_vgg19(state_dict: Dict[str, torch.Tensor],
                     model: TruncatedVGG19) -> Dict[str, List[str]]:
    """Load a torchvision ``vgg19().features`` (``features.<k>.…`` or bare
    ``<k>.…`` keys) or a reference ``TruncatedVGG19`` state_dict into
    ``model``: keys renamed to ``truncated_vgg19.<k>.…``, ``module.``
    stripped, every tensor whose name and shape match taken (the layers past
    the truncation are reported). Returns ``{"loaded", "missing",
    "unmatched"}`` as ``train.checkpoint.load_model`` does."""
    renamed = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        for prefix in ("truncated_vgg19.", "features."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        renamed["truncated_vgg19." + k] = v
    own = model.state_dict()
    report: Dict[str, List[str]] = {"loaded": [], "missing": [], "unmatched": []}
    take = {}
    for name, value in own.items():
        if name not in renamed:
            report["missing"].append(name)
        elif tuple(renamed[name].shape) != tuple(value.shape):
            report["unmatched"].append(name)
        else:
            take[name] = renamed[name]
            report["loaded"].append(name)
    report["unmatched"] += [k for k in renamed if k not in own]
    model.load_state_dict(take, strict=False)
    return report
