"""The EfficientNet encoder family over NHWC (the JAX package's
models/efficientnet.py; the reference's vendored EfficientNet-PyTorch
v0.5.1, efficientnet_pytorch/model.py and utils.py), and the AttentiveCNN
encoder built on it (reference archs.py:409-466).

- the block-string spec and its decoder, ``round_filters`` /
  ``round_repeats`` and the b0–l2 scaling table (utils.py:60-80, 162-252),
  kept here as the port's own copy;
- :class:`SamePadConv`: TF "same" padding, asymmetric where it must be,
  computed from the input's size on every call (utils.py:95-146);
- :class:`MBConvBlock`: expand 1×1 → depthwise k×k → squeeze-excitation →
  project 1×1, swish, the id skip (model.py:18-99);
- :class:`EfficientNet` with ``features_only`` (``extract_features``) or
  the ``_fc`` classifier head;
- :class:`AttentiveCNN`: the input resized to the variant's resolution,
  EfficientNet features, a 1×1 ``conv_a`` to 1024 channels; or, with
  ``eff_flag=False``, the ResNet-101 trunk (``models/resnet.py``) at 224².

BatchNorm momentum 0.01 and eps 1e-3. Module names are the reference's
(``_conv_stem``, ``_blocks.N._depthwise_conv``, …), so its checkpoints
load. Drop-connect and dropout run only when the caller passes an explicit
``torch.Generator`` to ``forward`` in training, as the JAX package's run
only with a ``dropout`` rng; the trainers pass none.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Tuple

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import Conv2d, Dense, conv2d_nhwc
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    id_skip: bool
    se_ratio: Optional[float]
    stride: int


# the official b0 architecture (utils.py:258-263)
BLOCK_STRINGS = [
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25",
    "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25",
    "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
]

# width, depth, resolution, dropout (utils.py:162-177)
SCALING_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}

BN_MOMENTUM = 0.01  # torch momentum = 1 − 0.99 (utils.py GlobalParams)
BN_EPS = 1e-3

# AttentiveCNN feature widths per variant (archs.py:430-437)
F_CHANNELS = {
    "efficientnet-b2": 1408,
    "efficientnet-b3": 1536,
    "efficientnet-b4": 1792,
    "efficientnet-b5": 2048,
}


def decode_block_string(s: str) -> BlockArgs:
    """Parse one block string (utils.py:184-206)."""
    options = {}
    for op in s.split("_"):
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            options[splits[0]] = splits[1]
    return BlockArgs(
        kernel_size=int(options["k"]),
        num_repeat=int(options["r"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        expand_ratio=int(options["e"]),
        id_skip="noskip" not in s,
        se_ratio=float(options["se"]) if "se" in options else None,
        stride=int(options["s"][0]),
    )


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Width scaling with 8-divisor snapping (utils.py:60-72)."""
    if not width:
        return filters
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    """Depth scaling (utils.py:75-80)."""
    if not depth:
        return repeats
    return int(math.ceil(depth * repeats))


def scaled_block_args(model_name: str) -> Tuple[List[BlockArgs], float, int]:
    """The variant's block args (one per stage), its dropout rate and its
    head width."""
    width, depth, _, dropout = SCALING_PARAMS[model_name]
    blocks: List[BlockArgs] = []
    for s in BLOCK_STRINGS:
        a = decode_block_string(s)
        blocks.append(dataclasses.replace(
            a,
            input_filters=round_filters(a.input_filters, width),
            output_filters=round_filters(a.output_filters, width),
            num_repeat=round_repeats(a.num_repeat, depth),
        ))
    return blocks, dropout, round_filters(1280, width)


def expanded_blocks(model_name: str) -> List[BlockArgs]:
    """One BlockArgs per MBConv block: each stage's first block, then its
    repeats at the output width with stride 1 (model.py:185-195)."""
    flat: List[BlockArgs] = []
    for a in scaled_block_args(model_name)[0]:
        flat.append(a)
        rest = dataclasses.replace(a, input_filters=a.output_filters, stride=1)
        flat.extend([rest] * (a.num_repeat - 1))
    return flat


def _same_pad(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF 'same' asymmetric padding for one spatial axis (utils.py:110-121)."""
    out = math.ceil(size / s)
    pad = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return pad // 2, pad - pad // 2


class SamePadConv(Conv2d):
    """A conv with TF "same" padding for the input's H and W (the extra
    row or column, if any, at the bottom or right)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias,
                         generator=generator, stride=stride, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        pad = (_same_pad(x.shape[1], k, s), _same_pad(x.shape[2], k, s))
        return conv2d_nhwc(x, self.weight, self.bias, pad, s, self.groups)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x·sigmoid(x) (the reference's MemoryEfficientSwish)."""
    return x * torch.sigmoid(x)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def _keep_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    """floor(keep + U[0, 1)): 1 with probability ``keep``, drawn from
    ``generator`` on its own device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.floor(keep + u).to(device)


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck (model.py:18-99)."""

    def __init__(self, args: BlockArgs, generator: Optional[torch.Generator] = None):
        super().__init__()
        a = self.args = args
        oup = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self._expand_conv = SamePadConv(a.input_filters, oup, 1, bias=False,
                                            generator=generator)
            self._bn0 = _bn(oup)
        self._depthwise_conv = SamePadConv(oup, oup, a.kernel_size, a.stride, groups=oup,
                                           bias=False, generator=generator)
        self._bn1 = _bn(oup)
        self.has_se = a.se_ratio is not None and 0 < a.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(a.input_filters * a.se_ratio))
            self._se_reduce = SamePadConv(oup, squeezed, 1, generator=generator)
            self._se_expand = SamePadConv(squeezed, oup, 1, generator=generator)
        self._project_conv = SamePadConv(oup, a.output_filters, 1, bias=False,
                                         generator=generator)
        self._bn2 = _bn(a.output_filters)

    def forward(self, x: torch.Tensor, drop_connect_rate: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.args
        inputs = x
        if a.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            se = x.mean((1, 2), keepdim=True)
            se = self._se_expand(swish(self._se_reduce(se)))
            x = torch.sigmoid(se) * x
        x = self._bn2(self._project_conv(x))
        if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
            if drop_connect_rate and self.training and generator is not None:
                keep = 1.0 - drop_connect_rate  # per-sample drop (utils.py:83-92)
                x = x / keep * _keep_mask((x.shape[0], 1, 1, 1), keep, generator,
                                          x.device).to(x.dtype)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """EfficientNet b0–l2 (model.py:132-247): stem, the MBConv blocks
    (``_blocks``, drop-connect rate ``drop_connect_rate · idx / n``), head
    conv; ``features_only`` returns the head's activation, else the mean
    over H and W through dropout and ``_fc``."""

    def __init__(self, model_name: str = "efficientnet-b0", num_classes: int = 1000,
                 features_only: bool = False, drop_connect_rate: float = 0.2,
                 in_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        width, _, _, self.dropout_rate = SCALING_PARAMS[model_name]
        self.features_only = features_only
        self.drop_connect_rate = drop_connect_rate
        blocks = expanded_blocks(model_name)
        head = scaled_block_args(model_name)[2]
        stem = round_filters(32, width)
        self._conv_stem = SamePadConv(in_channels, stem, 3, 2, bias=False, generator=generator)
        self._bn0 = _bn(stem)
        self._blocks = nn.ModuleList(MBConvBlock(a, generator) for a in blocks)
        self._conv_head = SamePadConv(blocks[-1].output_filters, head, 1, bias=False,
                                      generator=generator)
        self._bn1 = _bn(head)
        self.out_channels = head
        if not features_only:
            self._fc = Dense(head, num_classes, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = swish(self._bn0(self._conv_stem(x)))
        n = len(self._blocks)
        for idx, block in enumerate(self._blocks):
            rate = self.drop_connect_rate * idx / n if self.drop_connect_rate else None
            x = block(x, rate, generator)
        x = swish(self._bn1(self._conv_head(x)))
        if self.features_only:
            return x
        x = x.mean((1, 2))
        if self.training and generator is not None:
            keep = 1.0 - self.dropout_rate
            x = torch.where(_keep_mask(x.shape, keep, generator, x.device) > 0, x / keep,
                            torch.zeros_like(x))
        return self._fc(x)


class AttentiveCNN(nn.Module):
    """The latent encoder → ``eff_channel`` (1024) maps (archs.py:409-466).

    ``eff_flag=True``: the images resized (bilinear, ``align_corners=False``)
    to the variant's resolution, EfficientNet features (``eff_conv``), a
    bias-free 1×1 ``conv_a``. ``eff_flag=False``: resized to 224², the
    ResNet-101 trunk (``resnet_conv``), a 2048 → ``eff_channel`` 1×1
    ``conv_a`` (the JAX package's repair of the reference's resnet branch,
    which lacks ``conv_a``). A variant whose head width is not its
    ``F_CHANNELS`` entry (1408 when absent) raises, as the JAX package's
    assertion."""

    def __init__(self, eff_model_name: str = "efficientnet-b2", eff_channel: int = 1024,
                 eff_flag: bool = True, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eff_flag = eff_flag
        if not eff_flag:
            from ssunet_gan_tpu_torch.models.resnet import ResNet101Trunk

            self.size = 224
            self.resnet_conv = ResNet101Trunk(in_channels, generator)
            self.conv_a = Conv2d(2048, eff_channel, 1, bias=False, generator=generator)
            return
        self.size = SCALING_PARAMS[eff_model_name][2]
        self.eff_conv = EfficientNet(eff_model_name, features_only=True,
                                     in_channels=in_channels, generator=generator)
        f = F_CHANNELS.get(eff_model_name, 1408)
        if self.eff_conv.out_channels != f:
            raise ValueError(f"{eff_model_name} gives {self.eff_conv.out_channels} feature "
                             f"channels, AttentiveCNN expects {f}")
        self.conv_a = SamePadConv(f, eff_channel, 1, bias=False, generator=generator)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = resize_bilinear(images, self.size, self.size, align_corners=False)
        if not self.eff_flag:
            return self.conv_a(self.resnet_conv(x))
        return self.conv_a(self.eff_conv(x, generator))
