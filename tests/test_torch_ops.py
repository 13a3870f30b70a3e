"""The port's plain layers against the JAX package's, on the CPU, in f32
unless a test says otherwise. Inputs come from numpy with a seed.

Pool, unpool and the tile quantization are exact (bit-equal); convs,
BatchNorm and SPADE agree to 1e-5 (f32 sums in different orders); the
bilinear upsample agrees to 1e-6 in f32 and within one bf16 ulp in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.ops import pool as jpool
from ssunet_gan_tpu.ops import resize as jresize
from ssunet_gan_tpu.ops.conv import Conv2d as JConv2d
from ssunet_gan_tpu.ops.norm import BatchNorm as JBatchNorm
from ssunet_gan_tpu.ops.spade import SPADE as JSPADE
from ssunet_gan_tpu_torch.infer.api import tile_forward
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops.conv import conv2d_nhwc
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.ops.pool import (
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from ssunet_gan_tpu_torch.ops.resize import upsample_bilinear
from ssunet_gan_tpu_torch.ops.spade import SPADE
from torch_port_helpers import jax_toggles, oihw, vec


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=False):
        yield


@pytest.mark.parametrize("shape", [(2, 8, 6, 5), (1, 7, 9, 3)])
def test_pool_with_ties_bit_equal_jax(shape):
    """Small integers make ties common: codes must pick the first maximum
    in TL, TR, BL, BR order, as torch's flat indices do; odd sizes crop."""
    x = np.random.default_rng(0).integers(0, 3, size=shape).astype(np.float32)
    want_v, want_c = jpool.max_pool_2x2_with_indices(jnp.asarray(x))
    got_v, got_c = max_pool_2x2_with_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpool.max_pool_2x2(jnp.asarray(x))))
    want_u = jpool.max_unpool_2x2(want_v, want_c)
    np.testing.assert_array_equal(max_unpool_2x2(got_v, got_c).numpy(), np.asarray(want_u))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 8e-3)])
def test_upsample_matches_jax(dtype, tol):
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 4)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jresize.upsample_bilinear(jnp.asarray(x, jdt), 2, True), np.float32)
    got = upsample_bilinear(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_split_concat_conv_matches_jax():
    g = np.random.default_rng(2)
    a = g.normal(size=(1, 6, 5, 3)).astype(np.float32)
    b = g.normal(size=(1, 6, 5, 4)).astype(np.float32)
    conv = JConv2d(8, 3, padding=1)
    params = conv.init(jax.random.PRNGKey(0), (jnp.asarray(a), jnp.asarray(b)))
    want = conv.apply(params, (jnp.asarray(a), jnp.asarray(b)))
    p = params["params"]
    got = conv2d_nhwc((torch.from_numpy(a), torch.from_numpy(b)), oihw(p["kernel"]),
                      vec(p["bias"]), padding=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_batchnorm_eval_matches_jax():
    g = np.random.default_rng(3)
    x = g.normal(size=(2, 4, 4, 6)).astype(np.float32)
    stats = {"mean": g.normal(size=6).astype(np.float32),
             "var": (g.random(6) + 0.5).astype(np.float32)}
    params = {"scale": g.normal(size=6).astype(np.float32),
              "bias": g.normal(size=6).astype(np.float32)}
    want = JBatchNorm(6).apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    bn = BatchNorm(6).eval()  # a new module trains, as nn.BatchNorm2d does
    bn.load_state_dict({"weight": vec(params["scale"]), "bias": vec(params["bias"]),
                        "running_mean": vec(stats["mean"]), "running_var": vec(stats["var"])})
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_jax(dtype):
    """Batch statistics (two-pass, f32), the output in the input's dtype,
    and the running averages moved with momentum 0.1 and the unbiased
    variance — also through update_running, the fused stage's entry.
    f32 to 1e-5; bf16 outputs within one bf16 ulp (8e-3 relative)."""
    g = np.random.default_rng(6)
    x = (g.normal(size=(2, 5, 3, 4)) * 2 + 1).astype(np.float32)
    stats = {"mean": g.normal(size=4).astype(np.float32),
             "var": (g.random(4) + 0.5).astype(np.float32)}
    params = {"scale": g.normal(size=4).astype(np.float32),
              "bias": g.normal(size=4).astype(np.float32)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want, upd = JBatchNorm(4).apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x, jdt), True, mutable=["batch_stats"])
    sd = {"weight": vec(params["scale"]), "bias": vec(params["bias"]),
          "running_mean": vec(stats["mean"]), "running_var": vec(stats["var"])}
    bn = BatchNorm(4)
    bn.load_state_dict(sd)
    got = bn(torch.from_numpy(x).to(dtype))
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert got.dtype == dtype
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=1e-5, atol=1e-6)
    fused = BatchNorm(4)
    fused.load_state_dict(sd)
    xf = torch.from_numpy(x).to(dtype).float()
    fused.update_running(xf.mean((0, 1, 2)), xf.var((0, 1, 2)))
    np.testing.assert_allclose(fused.running_var.numpy(), bn.running_var.numpy(), rtol=1e-5)
    np.testing.assert_allclose(fused.running_mean.numpy(), bn.running_mean.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_spade_matches_jax():
    """Self-SPADE with the reference's bypassed norm and nhidden floor of 4."""
    x = np.random.default_rng(4).normal(size=(1, 6, 6, 8)).astype(np.float32)
    jspade = JSPADE("spadebatch3x3", 8, 3, 8 / 16)
    variables = jspade.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x))
    want = jspade.apply(variables, jnp.asarray(x), jnp.asarray(x))
    spade = SPADE("spadebatch3x3", 8, 3, 8 / 16)
    sd = {}
    for name, leaves in variables["params"].items():
        tname = "mlp_shared.0" if name == "mlp_shared" else name
        sd[f"{tname}.weight"] = oihw(leaves["kernel"])
        sd[f"{tname}.bias"] = vec(leaves["bias"])
    spade.load_state_dict(sd)
    assert spade.mlp_shared[0].weight.shape[0] == 4
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(spade(xt, xt).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_tile_forward_quantized_probs_are_the_merge_quantization():
    model = build_model("UNet_R_SS_v2", 3, filters=(8, 8, 8, 8, 8, 8), device="cpu")
    x = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    probs = tile_forward(model, x, device="cpu")
    q = tile_forward(model, x, quantize_probs=True, device="cpu")
    assert q.dtype == torch.uint8 and q.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(q.numpy(), np.floor(probs.numpy() * 255.0).astype(np.uint8))
