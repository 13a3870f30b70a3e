"""SPADE — spatially-adaptive (de)normalization (reference
normalization.py:67-122), as the JAX package's ``ops/spade.py`` keeps it.

Two reference quirks are the behaviour:

1. The param-free norm is bypassed: ``SPADE.forward`` sets
   ``normalized = x`` (normalization.py:110), so no norm module exists.
2. The segmap is first projected through ``x2map`` (norm_nc → label_nc)
   before the shared MLP; the SS-UNets condition every stage on itself.

``nhidden`` is ``int(max(nhidden, 4))`` with callers passing
``nb_filter/ss_scale`` as a float (archs.py:486).

The forward dispatches on :func:`ops.spade_kernel.fused_spade_mode` as the
JAX package's does (ops/spade.py:108-127): ``"pallas"`` sends a self-SPADE
(``segmap is x``) that the gate admits to the fused kernel, ``"fast"`` and
``"pallas"`` compute γ|β as one 1×1 conv over the im2col of actv, and
``"off"`` (the default) is the composition.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
from torch import nn

from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.spade_kernel import (
    fast_gamma_beta_modulate,
    fused_spade_mode,
    fused_spade_stage,
    fused_spade_supported,
)

_CONFIG_RE = re.compile(r"spade(\D+)(\d)x\d")
_KNOWN_NORMS = ("instance", "syncbatch", "batch")


def parse_spade_config(config_text: str):
    """Parse ``spade(norm)(ks)x(ks)`` (normalization.py:71-74)."""
    if not config_text.startswith("spade"):
        raise ValueError(f"SPADE config must start with 'spade': {config_text!r}")
    parsed = _CONFIG_RE.search(config_text)
    if parsed is None:
        raise ValueError(f"malformed SPADE config {config_text!r}")
    norm_type, ks = str(parsed.group(1)), int(parsed.group(2))
    if norm_type not in _KNOWN_NORMS:
        raise ValueError(
            "%s is not a recognized param-free norm type in SPADE" % norm_type
        )
    return norm_type, ks


class SPADE(nn.Module):
    """SPADE(config_text, norm_nc, label_nc, nhidden) over NHWC tensors;
    ``seg_nc`` is the segmap's channels (default ``norm_nc``)."""

    def __init__(self, config_text: str, norm_nc: int, label_nc: int,
                 nhidden: float = 64,
                 generator: Optional[torch.Generator] = None,
                 seg_nc: Optional[int] = None):
        super().__init__()
        _, ks = parse_spade_config(config_text)
        nh = int(max(nhidden, 4))
        pw = ks // 2
        self.ks, self.label_nc, self.nhidden = ks, label_nc, nh
        # the segmap's channels: norm_nc for a self-SPADE (the JAX package
        # takes them from the segmap, ops/spade.py:99)
        seg_nc = norm_nc if seg_nc is None else seg_nc
        self.x2map = Conv2d(seg_nc, label_nc, ks, pw, generator=generator)
        self.mlp_shared = nn.Sequential(
            Conv2d(label_nc, nh, ks, pw, generator=generator), nn.ReLU()
        )
        self.mlp_gamma = Conv2d(nh, norm_nc, ks, pw, generator=generator)
        self.mlp_beta = Conv2d(nh, norm_nc, ks, pw, generator=generator)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        normalized = x  # param-free norm bypassed (normalization.py:110)
        mode = fused_spade_mode()
        if (mode == "pallas" and segmap is x
                and fused_spade_supported(x, self.ks, self.label_nc, self.nhidden)):
            return fused_spade_stage(x, *self.stage_params())
        actv = self.mlp_shared(self.x2map(segmap))
        if mode in ("fast", "pallas") and self.ks == 3:
            return fast_gamma_beta_modulate(normalized, actv, self.mlp_gamma.weight,
                                            self.mlp_gamma.bias, self.mlp_beta.weight,
                                            self.mlp_beta.bias)
        gamma = self.mlp_gamma(actv)
        beta = self.mlp_beta(actv)
        return normalized * (1 + gamma) + beta

    def stage_params(self) -> Tuple[torch.Tensor, ...]:
        """(x2map w, b, mlp_shared w, b, mlp_gamma w, b, mlp_beta w, b),
        OIHW weights: the SPADE half of a fused stage's parameters."""
        shared = self.mlp_shared[0]
        return (self.x2map.weight, self.x2map.bias, shared.weight, shared.bias,
                self.mlp_gamma.weight, self.mlp_gamma.bias,
                self.mlp_beta.weight, self.mlp_beta.bias)
