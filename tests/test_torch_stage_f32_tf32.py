"""The f32 route of kernel 1 (``csrc/fused_stage_f32.cu``) runs its products
as 3xTF32 on the tensor cores: each f32 operand split into big = tf32(x)
and small = tf32(x - big), each product big·big + big·small + small·big
in f32 sums. Here, on the CPU, that arithmetic in plain PyTorch
(``ops/stage_kernel.py`` ``split_tf32``, ``f32_conv_emulated``): the split
at its edges (infinities, NaN, the f32 limit, ties), the stage through it
launch by launch at the flagship's widths against the stage's f32 plain
version and the JAX package's f32 ``fused_eval_stage`` (Pallas interpret
mode), and with inf and NaN inputs against the plain version's output
classes.

Bars: relative L2 ≤ 1e-5 (and max error ≤ 1e-5 of max |·| against the
port's plain version): 3xTF32 products are f32 products to ~2^-22, summed
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage
from ssunet_gan_tpu_torch.ops import stage_kernel
from test_torch_stage import _stage
from test_torch_stage_f32 import _close
from torch_port_helpers import jax_toggles


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True):
        yield


def _jax_stage(st):
    return np.asarray(jax_fused_eval_stage(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))


@pytest.mark.parametrize(
    "planes,label,shapes,nh,ncls",
    [
        (64, 3, [(1, 8, 8, 3)], 4.0, 0),                   # conv0_0
        (128, 3, [(1, 8, 8, 64)], 8.0, 0),                 # conv1_0
        (256, 3, [(1, 8, 8, 256), (1, 8, 8, 256)], 16.0, 0),  # conv2_1
        (64, 3, [(1, 8, 8, 64), (1, 8, 8, 128)], 4.0, 3),  # conv0_1 with the head
    ],
    ids=["conv0_0", "conv1_0", "conv2_1", "conv0_1"],
)
def test_tf32_emulation_matches_the_stage_and_jax(rng, planes, label, shapes, nh, ncls):
    """The stage through the kernel's 3xTF32 arithmetic, launch by launch
    (``f32_conv_emulated``), at the flagship's widths on an 8×8 map: within
    1e-5 relative L2 (and 1e-5 of max |·|) of the stage's f32 plain
    version, and within 1e-5 relative L2 of the JAX package's f32 stage."""
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    pk = stage_kernel.pack_stage_f32(tuple(p.shape[-1] for p in parts), st["tbp"], st["tsp"],
                                     st["thead"])
    got = stage_kernel.f32_stage_launches(parts, pk, stage_kernel.f32_conv_emulated)
    _close(got, stage_kernel.fused_stage_reference(parts, st["tbp"], st["tsp"], st["thead"]))
    kernel = _jax_stage(st)
    l2 = np.linalg.norm(got.numpy().astype(np.float64) - kernel) / np.linalg.norm(kernel)
    assert l2 <= 1e-5, l2


def test_split_tf32_edges():
    """Infinities and NaN split as (x, 0); the largest finite values split
    without overflow; ties round away from zero; small is big's remainder
    rounded to TF32."""
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.4028235e38, -3.4028235e38,
                      1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 / 3.0, 0.0, 1e-40])
    big, small = stage_kernel.split_tf32(x)
    assert torch.isposinf(big[0]) and torch.isneginf(big[1]) and torch.isnan(big[2])
    assert not bool(small[:3].any())
    assert bool(torch.isfinite(big[3:]).all()) and bool(torch.isfinite(small[3:]).all())
    assert big[5].item() == 1.0 + 2.0 ** -10  # a tie, away from zero
    assert (big + small)[6].item() == x[6].item()
    assert abs((big + small)[7].item() - 1.0 / 3.0) <= 2.0 ** -22
    assert not bool((torch.cat([big, small]).view(torch.int32)[torch.isfinite(
        torch.cat([big, small]))] & 0x1FFF).any())


def test_tf32_emulation_keeps_non_finite_classes(rng):
    """+inf, -inf and NaN planted in a stage's input: through the kernel's
    arithmetic every output's class (finite, NaN, +inf, -inf) is the plain
    version's; the finite outputs agree as without them."""
    st = _stage(rng, 16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 0)
    x0 = st["xs"][0].copy()
    x0[0, 1, 2, 3], x0[0, 5, 12, 0], x0[0, 7, 0, 6] = np.inf, -np.inf, np.nan
    parts = (torch.from_numpy(x0), torch.from_numpy(st["xs"][1]))
    pk = stage_kernel.pack_stage_f32((8, 16), st["tbp"], st["tsp"], None)
    # the first launch alone, where the infinities stay infinite
    h1 = stage_kernel.f32_conv_emulated(parts, pk["conv1"])
    h1_plain = stage_kernel.f32_conv_reference(parts, pk["conv1"])
    got = stage_kernel.f32_stage_launches(parts, pk, stage_kernel.f32_conv_emulated)
    want = stage_kernel.f32_stage_launches(parts, pk)

    def classes(t):
        return torch.isnan(t) * 1 + torch.isposinf(t) * 2 + torch.isneginf(t) * 3

    for g, w in ((h1, h1_plain), (got, want)):
        assert torch.equal(classes(g), classes(w))
        fin = torch.isfinite(w)
        _close(g[fin], w[fin])
    assert bool(torch.isposinf(h1_plain).any()) and bool(torch.isnan(want).any())

