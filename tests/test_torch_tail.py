"""The SPADE tail of the port's fused stages at wide hidden widths, and its
packed operands, on the CPU.

The tail kernel (``csrc/stage_common.cuh`` ``spade_tail_kernel``) runs seg
and γ|β as tensor-core GEMMs over operands that ``ops/stage_kernel.py``
``pack_spade`` lays out: x2map as 8 label rows (labels padded) over
(tap, channel); mlp_gamma and mlp_beta as N rows interleaved per 8 output
channels over K = (tap, 8-channel group of hidden) pairs, two per k16 step;
the head as 8 class rows. Here those operands are walked in that K order
with plain torch ops (``torch_port_helpers.tail_from_packed``) and held
against ``spade_tail_reference`` on the same f32 inputs: only the summation
order differs, so the bar is atol 1e-5 of the output's largest magnitude
(at least 1).

The hidden limit of the kernel is 64 (SSUNet's widest SPADE); the plain
tails at hidden 32 and 64 are held against the JAX package's kernels in
Pallas interpret mode (the JAX package's own CPU route) at the JAX kernels'
own f32 tolerances: the eval stage rtol = atol = 2e-4
(tests/test_stage_kernel.py), the self-SPADE stage 3e-5
(tests/test_spade_kernel.py). Inputs and weights come from numpy with a
seed.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops.blocks import BasicBlock as JBasicBlock
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu.ops import spade_kernel as jax_spade_kernel
from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage
from ssunet_gan_tpu_torch.ops import spade_kernel, stage_kernel
from torch_port_helpers import (
    jax_toggles,
    oihw,
    randomize_batch_stats,
    spade_weights,
    tail_from_packed,
    tensor,
    vec,
)

CSRC = os.path.join(os.path.dirname(__file__), "..", "ssunet_gan_tpu_torch", "csrc")


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True):
        yield


def _spade(rng, c, lab, nh):
    """SPADE weights (HWIO, OIHW) with γ|β's scaled by sqrt(16 / hidden)
    past hidden 16: outputs of the magnitude the JAX kernel's own tests have
    at hidden 16, which its tolerance was set for (γ|β sums 9·hidden
    terms)."""
    hwio, _ = spade_weights(rng, c, lab, nh)
    f = np.float32(min(1.0, np.sqrt(16 / nh)))
    hwio = tuple(a * f if i in (4, 6) else a for i, a in enumerate(hwio))
    return hwio, tuple(oihw(a) if a.ndim == 4 else vec(a) for a in hwio)


@pytest.mark.parametrize(
    "c,lab,nh,ncls",
    [
        (32, 3, 4, 0),    # the flagship's level 0: one group, its pair padded
        (64, 3, 8, 3),    # one group, with the head
        (32, 3, 16, 0),   # two groups: one k16 step per tap
        (32, 2, 24, 0),   # three groups, the last pair padded
        (64, 3, 32, 3),   # SSUNet's widths
        (32, 8, 64, 8),   # the widest labels, hidden and classes the kernel takes
    ],
)
def test_tail_operands_in_k_order_rebuild_the_tail(c, lab, nh, ncls):
    rng = np.random.default_rng(11)
    n, h, w = 2, 6, 9
    y = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32))
    _, sp = _spade(rng, c, lab, nh)
    head = None
    if ncls:
        # fan-in scaled, so the logits are of order 1 like the other outputs
        head = (torch.from_numpy((rng.standard_normal((ncls, c, 1, 1)) / np.sqrt(c)).astype(
                    np.float32)),
                torch.from_numpy((0.1 * rng.standard_normal(ncls)).astype(np.float32)))
    pk = stage_kernel.pack_spade(sp, head, torch.float32)
    steps = stage_kernel.tail_gb_steps(nh)
    assert steps == (9 * -(-nh // 8) + 1) // 2
    assert pk["k1t"].shape == (8, 9, c) and pk["kgbt"].shape == (2 * c, 16 * steps)
    # the interleave: N rows 16i..16i+7 are γ of channels 8i..8i+7, then β's
    wg, wb = sp[4], sp[6]
    for i in range(c // 8):
        assert torch.equal(pk["kgbt"][16 * i:16 * i + 8, 4 * -(-nh // 8) * 8:][:, :min(nh, 8)],
                           wg[8 * i:8 * i + 8, :min(nh, 8), 1, 1])  # centre tap, group 0
        assert torch.equal(pk["kgbt"][16 * i + 8:16 * i + 16, :min(nh, 8)],
                           wb[8 * i:8 * i + 8, :min(nh, 8), 0, 0])  # tap 0, group 0
    got = tail_from_packed(y, pk)
    want = stage_kernel.spade_tail_reference(y, sp, head)[0]
    assert got.shape == want.shape == (n, h, w, ncls or c)
    torch.testing.assert_close(got, want, atol=1e-5 * max(1.0, want.abs().max().item()), rtol=0)


def test_tail_limits_are_the_kernels():
    """The one Python place of the tail's limits reads as the kernel's."""
    src = open(os.path.join(CSRC, "stage_common.cuh")).read()
    m = re.search(r"TAIL_MAX_LAB = (\d+), TAIL_MAX_NH = (\d+), TAIL_MAX_CLS = (\d+);", src)
    assert m is not None
    assert tuple(map(int, m.groups())) == (stage_kernel.TAIL_MAX_LAB,
                                           stage_kernel.TAIL_MAX_HIDDEN,
                                           stage_kernel.TAIL_MAX_CLS) == (8, 64, 8)


def _stage(rng, planes, shapes, nh, ncls):
    """A JAX BasicBlock + SPADE with the port's bundles from them."""
    block, spade = JBasicBlock(planes), JSPADE("spadebatch3x3", planes, 3, float(nh))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(
        jax.random.PRNGKey(0), jparts[0] if len(jparts) == 1 else jparts, True))())
    y0 = jnp.zeros(shapes[0][:3] + (planes,), jnp.float32)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), y0, y0))()
    jbp = JBasicBlock(planes, in_planes=sum(s[-1] for s in shapes)).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    head = None
    if ncls:
        head = (rng.normal(size=(1, 1, planes, ncls)).astype(np.float32) * 0.3,
                rng.normal(size=(ncls,)).astype(np.float32) * 0.1)
    k1, (s1, t1), k2, (s2, t2), ks = jbp
    tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), oihw(ks))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    assert tsp[2].shape[0] == nh
    thead = None if head is None else (oihw(head[0]), vec(head[1]))
    return xs, jparts, jbp, jsp, head, tbp, tsp, thead


@pytest.mark.parametrize("planes,nh,ncls", [(32, 32, 0), (64, 64, 0), (32, 64, 3),
                                            (64, 32, 3)])
def test_wide_hidden_stage_matches_jax(rng, planes, nh, ncls):
    """The eval stage with SSUNet's hidden widths, with and without the
    folded head: the port's gate takes it (the CPU terms of the JAX gate)
    and its plain version matches the JAX kernel."""
    shapes = [(2, 16, 16, planes // 2)]
    xs, jparts, jbp, jsp, head, tbp, tsp, thead = _stage(rng, planes, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in xs)
    assert stage_kernel.stage_supported(parts, planes, 3, nh, ncls)
    got = stage_kernel.fused_eval_stage(parts, tbp, tsp, thead).numpy()
    want = np.asarray(jax_fused_eval_stage(
        jparts, jbp, jsp, final_head=None if head is None else tuple(map(jnp.asarray, head))))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("c,nh", [(32, 32), (64, 64)])
def test_wide_hidden_spade_stage_matches_jax(rng, c, nh):
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    hwio, tsp = _spade(rng, c, 3, nh)
    assert spade_kernel.fused_spade_supported(tensor(x), 3, 3, nh)
    want = np.asarray(jax_spade_kernel.fused_spade_stage(jnp.asarray(x), *map(jnp.asarray, hwio)))
    got = spade_kernel.fused_spade_stage(tensor(x), *tsp).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
