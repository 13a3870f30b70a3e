"""The narrow UNet_R_SS's (``torch_port_helpers.NarrowUNetRSS``) int8 forwards
on the CPU against the JAX package's, both packages' lazy seams on, in bf16
with dynamic and calibrated scales (the narrow models, the forwards and the
bars: tests/torch_int8_seams_helpers.py)."""

import pytest

from torch_int8_seams_helpers import (  # noqa: F401 (_modes: the autouse fixture)
    _modes,
    check_narrow_int8_forward,
)


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("arch", ["UNet_R_SS"])
def test_narrow_int8_forward_reads_its_seams_as_jax(monkeypatch, arch, calibrated):
    """The bf16 int8 forward of a narrow flagship, UNet_R_SS and SSUNet with
    both packages' lazy seams on: the stages, s8 seams and deep blocks per
    forward equal the JAX package's (a deep producer's up seam
    materialized, a fused one's read; each encoder's pool read), and the
    logits are JAX's to ``FLAGSHIP_L2`` (dynamic) or ``BF16_CALIBRATED_L2``
    (calibrated)."""
    check_narrow_int8_forward(monkeypatch, arch, calibrated)
