"""Fault 3.3 of the port's ROADMAP, settled against the JAX package: the
flagship generator of ``chip_smoke.py`` phase 15 (full width, seeded,
BatchNorm calibrated) on phase 15's validation batch at its full size
(8 × 512² × 3), before and after two train forwards, through the port's
f32 module composition, the fused stages' plain versions in bf16 and f32,
and the JAX package's f32 forward of the same weights
(``tools/torch_eval_finite.py``). Every port route turns non-finite at
the stage where JAX's does, and each stage's output is finite on both
sides or on neither. ``slow``: ~6 min and a few GiB on the CPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))


@pytest.mark.slow
def test_port_routes_turn_non_finite_where_jax_does():
    import torch
    import torch_eval_finite

    res = torch_eval_finite.run(512, 8, torch.device("cpu"))
    assert res["verdict"] and all(res["verdict"].values()), res["verdict"]
    for n in (0, 2):
        assert res["results"][f"c after {n}"]["first_stage"] is not None
