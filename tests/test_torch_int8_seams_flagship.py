"""The narrow flagship's (UNet_R_SS_v2, filters 8..64) int8 forwards on the
CPU against the JAX package's, both packages' lazy seams on: in bf16 with
dynamic and calibrated scales, and calibrated in f32 (the narrow models,
the forwards and the bars: tests/torch_int8_seams_helpers.py; the seam
reads and stages: tests/test_torch_int8_seams_stage.py)."""

import pytest

from torch_int8_seams_helpers import (  # noqa: F401 (_modes: the autouse fixture)
    FLAGSHIP_L2,
    _int8_forwards,
    _modes,
    _narrow,
    check_narrow_int8_forward,
    rel_l2,
)


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("arch", ["UNet_R_SS_v2"])
def test_narrow_int8_forward_reads_its_seams_as_jax(monkeypatch, arch, calibrated):
    """The bf16 int8 forward of a narrow flagship, UNet_R_SS and SSUNet with
    both packages' lazy seams on: the stages, s8 seams and deep blocks per
    forward equal the JAX package's (a deep producer's up seam
    materialized, a fused one's read; each encoder's pool read), and the
    logits are JAX's to ``FLAGSHIP_L2`` (dynamic) or ``BF16_CALIBRATED_L2``
    (calibrated)."""
    check_narrow_int8_forward(monkeypatch, arch, calibrated)


def test_narrow_flagship_f32_calibrated_reads_its_pool_seams_as_jax(monkeypatch):
    """The flagship's calibrated int8 forward in f32: the encoders emit s8
    QTensors, whose pool seams both packages read (the JAX package makes no
    lazy f32 up seam), the counts equal, the logits JAX's to
    ``FLAGSHIP_L2`` (measured 1.8e-7)."""
    got, want, counts, jax_counts = _int8_forwards(_narrow("UNet_R_SS_v2"), monkeypatch, True,
                                                   "f32")
    assert counts == jax_counts and (counts["up"], counts["pool"]) == (0, 2)
    assert rel_l2(got, want) <= FLAGSHIP_L2, rel_l2(got, want)
