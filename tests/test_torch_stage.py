"""The port's fused eval stage (plain path, on the CPU) against the JAX
package's ``fused_eval_stage`` in Pallas interpret mode and against the JAX
module composition (BasicBlock → SPADE [→ final 1×1 conv]).

Inputs and weights come from numpy with a seed and cross between the
frameworks as numpy. f32 tolerance rtol = atol = 2e-4 (the same as the JAX
kernel's own parity test): both sides fold BN into the weights but sum in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops.blocks import BasicBlock as JBasicBlock
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu.ops.stage_kernel import fused_eval_stage as jax_fused_eval_stage
from ssunet_gan_tpu_torch.ops import stage_kernel
from torch_port_helpers import (
    conv_from_packed,
    jax_toggles,
    oihw,
    randomize_batch_stats,
    tail_from_packed,
    vec,
)


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=True):
        yield


def _stage(rng, planes, label, shapes, nh, ncls):
    """JAX modules + variables, numpy inputs, and both param bundles."""
    block = JBasicBlock(planes)
    spade = JSPADE("spadebatch3x3", planes, label, nh)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    xin = jparts if len(jparts) > 1 else jparts[0]
    bvars = jax.jit(lambda: block.init(jax.random.PRNGKey(0), xin, True))()
    bvars = randomize_batch_stats(bvars)
    y0 = jnp.zeros(shapes[0][:3] + (planes,), jnp.float32)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), y0, y0))()
    in_planes = sum(s[-1] for s in shapes)
    jbp = JBasicBlock(planes, in_planes=in_planes).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    head = None
    if ncls:
        head = (rng.normal(size=(1, 1, planes, ncls)).astype(np.float32) * 0.3,
                rng.normal(size=(ncls,)).astype(np.float32) * 0.1)
    k1, (s1, t1), k2, (s2, t2), ks = jbp
    tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), oihw(ks))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    thead = None if head is None else (oihw(head[0]), vec(head[1]))
    return dict(block=block, spade=spade, bvars=bvars, svars=svars, xs=xs,
                jparts=jparts, jbp=jbp, jsp=jsp, head=head, tbp=tbp, tsp=tsp,
                thead=thead)


def _jax_composition(st):
    jparts = st["jparts"]
    y = st["block"].apply(st["bvars"], jparts if len(jparts) > 1 else jparts[0], False)
    out = np.asarray(st["spade"].apply(st["svars"], y, y))
    if st["head"] is not None:
        kf, bf = st["head"]
        out = out @ kf[0, 0] + bf
    return out


@pytest.mark.parametrize(
    "planes,label,shapes,nh,ncls",
    [
        (16, 3, [(2, 16, 8, 8)], 4.0, 0),                       # encoder, 1 part
        (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 0),       # decoder, 2 parts
        (32, 3, [(1, 24, 8, 16)], 2.0, 0),                      # multi-band height
        (8, 2, [(2, 8, 8, 3)], 4.0, 0),                         # 3-ch first block
        (16, 3, [(1, 8, 16, 8), (1, 8, 16, 16)], 4.0, 3),       # folded final head
    ],
)
def test_stage_matches_jax(rng, planes, label, shapes, nh, ncls):
    st = _stage(rng, planes, label, shapes, nh, ncls)
    parts = tuple(torch.from_numpy(x) for x in st["xs"])
    before = stage_kernel.launches
    got = stage_kernel.fused_eval_stage(parts, st["tbp"], st["tsp"], st["thead"]).numpy()
    assert stage_kernel.launches == before  # CPU tensors never launch
    kernel = np.asarray(jax_fused_eval_stage(
        st["jparts"], st["jbp"], st["jsp"],
        final_head=None if st["head"] is None else tuple(map(jnp.asarray, st["head"]))))
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _jax_composition(st), rtol=2e-4, atol=2e-4)


def test_stage_bf16_smoke(rng):
    """bf16 plain path against the f32 JAX composition; loose tolerance
    (rtol 0.1, atol 0.3, as the JAX kernel's bf16 smoke) for bf16
    rounding of every intermediate."""
    st = _stage(rng, 16, 3, [(1, 8, 8, 8)], 4.0, 0)
    parts = tuple(torch.from_numpy(x).bfloat16() for x in st["xs"])
    got = stage_kernel.fused_eval_stage(parts, st["tbp"], st["tsp"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_composition(st),
                               rtol=0.1, atol=0.3)


def test_cuda_wrapper_refuses_unsupported_device():
    """Neither CPU nor CUDA: the wrapper raises instead of choosing a path."""
    x = torch.zeros((1, 8, 8, 4), device="meta")
    with pytest.raises(ValueError):
        stage_kernel.fused_eval_stage((x,), None, None)


@pytest.mark.parametrize("chans,ncls", [((3,), 0), ((8, 40), 0), ((8, 40), 3)])
def test_pack_stage_layout_is_the_kernels_gemm(chans, ncls):
    """The CUDA path's operands from ``pack_stage`` (f32, so exact), used as
    the kernels use them — conv1/conv2 walked in the eval conv core's K
    order (``conv_from_packed``), the SPADE tail's convs tap by tap —
    reproduce the plain stage; f32 tolerance 1e-4 for the different
    summation order."""
    from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    gen = torch.Generator().manual_seed(0)
    planes, labels = 32, 3
    block = BasicBlock(sum(chans), planes, generator=gen).eval()
    for bn in (block.bn1, block.bn2):
        bn.running_var.copy_(torch.rand(planes, generator=gen) + 0.5)
        bn.running_mean.copy_(torch.randn(planes, generator=gen) * 0.3)
    spade = SPADE("spadebatch3x3", planes, labels, planes / 16, generator=gen)
    head = None
    if ncls:
        head = (torch.randn((ncls, planes, 1, 1), generator=gen) * 0.3,
                torch.randn((ncls,), generator=gen) * 0.1)
    parts = tuple(torch.randn((2, 6, 7, c), generator=gen) for c in chans)
    bp, sp = block.stage_params(), spade.stage_params()
    with torch.no_grad():
        pk = stage_kernel.pack_stage(chans, bp, sp, head, torch.float32)
        assert pk["channels"] == chans and pk["shortcut"]
        c1, c2 = pk["conv1"], pk["conv2"]
        assert c1["segs"] == tuple((c, 3) for c in chans)
        assert c2["segs"] == ((planes, 3),) + tuple((c, 1) for c in chans)
        h1 = torch.relu(conv_from_packed(parts, c1) + c1["bias"])
        y = torch.relu(conv_from_packed((h1,) + parts, c2) + c2["bias"])
        out = tail_from_packed(y, pk)  # the tail's operands in its kernel's K orders
        want = stage_kernel.fused_stage_reference(parts, bp, sp, head)
    assert out.shape == want.shape == (2, 6, 7, ncls or planes)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
