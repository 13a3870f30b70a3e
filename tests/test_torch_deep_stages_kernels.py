"""The deep stages of the fused eval kernels under the deep-stage opt-in
(``ops/stage_kernel.py`` ``set_pack_max_planes``) against the JAX package's
kernels in Pallas interpret mode, on the CPU: the port's plain versions of
kernel 1 at 384-768 planes and of kernel 8 at 512. (The gates, the N
blocks, kernel 7 at 384 and a narrow flagship:
``tests/test_torch_deep_stages.py``.)

Bars: as ``tests/test_torch_stage.py`` and ``tests/test_torch_bneck.py``
(f32, rtol = atol = 2e-4 against the JAX kernel and the composition)."""

import numpy as np
import pytest
import torch

from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck
from torch_port_helpers import jax_eval_stage, jax_toggles


@pytest.fixture(autouse=True)
def _modes():
    """JAX's fused stages on and both packages' limits at 768, restored
    after."""
    with jax_toggles(fused_stage=True, pack_max_planes=768):
        yield


DEEP_STAGES = {
    "conv3_0": (384, [(1, 8, 8, 256)]),
    "conv4_1": (512, [(1, 8, 8, 512), (1, 8, 8, 512)]),
    "conv5_0": (768, [(1, 8, 8, 512)]),
}


@pytest.mark.parametrize("name", list(DEEP_STAGES))
def test_deep_stage_matches_jax(rng, name):
    """The port's eval stage (its plain version on the CPU) at 384-768
    planes against JAX's ``fused_eval_stage`` with ``set_pack_max_planes(768)``
    (interpret mode) and against the JAX module composition."""
    from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage

    planes, shapes = DEEP_STAGES[name]
    st = jax_eval_stage(rng, planes, shapes)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    assert stage_kernel.stage_supported(parts, planes, 3, planes // 16)
    got = stage_kernel.fused_eval_stage(parts, st["tbp"], st["tsp"]).numpy()
    kernel = np.asarray(jax_fused_eval_stage(st["jparts"], st["jbp"], st["jsp"]))
    assert got.shape == kernel.shape == shapes[0][:3] + (planes,)
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, st["composition"], rtol=2e-4, atol=2e-4)


def test_deep_bneck_stage_matches_jax(rng):
    """The Bottleneck stage at 512 planes, two parts (UNet_B_SS conv3_1's
    widths halved), against JAX's ``fused_eval_stage_bneck`` and the
    composition (``tests/test_torch_bneck.py``'s bars)."""
    from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage_bneck as jax_fused_bneck

    st = jax_eval_stage(rng, 512, [(1, 8, 8, 256), (1, 8, 8, 512)], bottleneck=True)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    assert stage_kernel_bneck.bneck_supported(parts, 512, 3, 32)
    got = stage_kernel_bneck.fused_eval_stage_bneck(parts, st["tbp"], st["tsp"]).numpy()
    kernel = np.asarray(jax_fused_bneck(st["jparts"], st["jbp"], st["jsp"]))
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, st["composition"], rtol=2e-4, atol=2e-4)
