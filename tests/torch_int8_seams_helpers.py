"""What the int8 seam tests share (tests/test_torch_int8_seams_*.py): the
autouse fixture that sets both packages' modes, the narrow models and their
int8 forwards against the JAX package's, and the bars, stated where they
are defined. A test file imports ``_modes`` so that its fixture applies."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.infer import calibrate as jax_calibrate
from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops import acts as jax_acts
from ssunet_gan_tpu.ops import stage_kernel_int8 as jq8
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from torch_port_helpers import (
    R_FILTERS,
    S_FILTERS,
    NarrowSSUNet,
    NarrowUNetRSS,
    jax_toggles,
    randomize_batch_stats,
)


@pytest.fixture(autouse=True)
def _modes():
    """Both packages' fused stages and lazy seams on (the JAX package's
    defaults), int8 state cleared before and restored or cleared after."""
    def clear():
        q8.set_int8_stage(False)
        q8.set_int8_calibration(None)
        q8.set_record_sink(None)

    clear()
    with jax_toggles(fused_stage=True, lazy_upsample=True, lazy_pool=True):
        yield
    clear()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ---- narrow models ----------------------------------------------------------------

# The narrow models of tests/test_torch_int8.py and tests/test_torch_seams.py
# at 32x32 (levels 0-2 fuse in both packages), batch 1 (no batch is a
# multiple of 128 / W, so the JAX package's lane packing, which
# materializes pool seams, stays off).
FLAGSHIP_FILTERS = (8, 16, 32, 40, 48, 64)
MODELS = {"UNet_R_SS_v2": FLAGSHIP_FILTERS, "UNet_R_SS": R_FILTERS, "SSUNet": S_FILTERS}
# The s8 seams each bf16 int8 forward reads, (up, pool): conv1_1 / conv0_1 up
# and conv1_0 / conv2_0 pool; UNet_R_SS and SSUNet up conv1_3 / conv0_4 only,
# their conv2_2's producer (level 3) being deep at 32x32, as SSUNet's
# conv3_1's producer conv4_0 is at full width.
SEAMS = {"UNet_R_SS_v2": (2, 2), "UNet_R_SS": (2, 2), "SSUNet": (2, 2)}
# Relative L2 of the port's int8 logits from JAX's. Dynamic scales:
# tests/test_torch_int8.py's FLAGSHIP_L2 (measured 0 for all three in
# bf16). Calibrated, bf16: the stages that emit s8 round the bf16 tail
# output to a step; where the port's plain tail and the JAX interpret
# kernel's differ by one bf16 ulp (the f32 summation order of its convs),
# about half the values move one step, already at the seamless first
# stage. Measured 1.5e-2 / 6.7e-3 / 2.5e-3 with the seams read, and
# 1.4e-2 / 6.5e-3 with both packages' seams materialized (batch 2), so the
# gap is the tails', not the seams'; the bar sits above it, and the same
# calibrated forward in f32, where that gap vanishes, is held to
# FLAGSHIP_L2 below.
FLAGSHIP_L2 = 1e-3
BF16_CALIBRATED_L2 = 3e-2


@functools.lru_cache(maxsize=None)
def _narrow(arch):
    """A narrow JAX model (random BN statistics), the port loaded from its
    variables, and tiles."""
    with jax_toggles(fused_stage=False):
        if arch == "UNet_R_SS_v2":
            model = jax_ssunet.UNetRSSv2(num_classes=3, filters=FLAGSHIP_FILTERS)
        elif arch == "UNet_R_SS":
            model = NarrowUNetRSS(num_classes=3)
        else:
            model = NarrowSSUNet(num_classes=3)
        x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
        variables = randomize_batch_stats(
            jax.device_get(jit_init(model, jax.random.PRNGKey(0), x0, train=False)))
    port = build_model(arch, 3, 3, filters=MODELS[arch], device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    tiles = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    return arch, model, variables, port, tiles


def _int8_forwards(narrow, monkeypatch, calibrated, dtype):
    """Both packages' int8 forwards of one tile (the port's planes cap at
    the level-2 width, so the two gates split the model alike), with the
    stages, seams and deep blocks each package's dispatch ran: JAX's
    ``UpTensor`` / ``DownTensor`` / ``DownQTensor`` parts handed to
    ``fused_eval_stage_int8``, the port's ``up`` / ``down`` flags.
    Returns (logits, JAX logits, counts, JAX counts)."""
    arch, model, variables, port, tiles = narrow
    monkeypatch.setattr(stage_kernel, "max_planes", lambda train=False: 32)
    if calibrated:
        scales = jax_calibrate.record_activation_ranges(model, variables, tiles, batch_size=3)
        jq8.set_int8_calibration(scales)
        q8.set_int8_calibration(scales)
    jq8.set_int8_stage(True)
    q8.set_int8_stage(True)
    counts = {w: {"stages": 0, "up": 0, "pool": 0, "deep": 0} for w in ("jax", "port")}

    def jax_stage(parts, *a, fn=jax_ssunet.fused_eval_stage_int8, **kw):
        c = counts["jax"]
        c["stages"] += 1
        c["up"] += sum(isinstance(p, jax_acts.UpTensor) for p in parts)
        c["pool"] += sum(isinstance(p, (jax_acts.DownTensor, jax_acts.DownQTensor))
                         for p in parts)
        return fn(parts, *a, **kw)

    def port_stage(parts, *a, fn=ssunet.fused_eval_stage_int8, up=None, down=None, **kw):
        c = counts["port"]
        c["stages"] += 1
        c["up"] += sum(up or ())
        c["pool"] += sum(down or ())
        return fn(parts, *a, up=up, down=down, **kw)

    def deep(which, fn):
        def counted(*a, **kw):
            counts[which]["deep"] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(jax_ssunet, "fused_eval_stage_int8", jax_stage)
    monkeypatch.setattr(jax_ssunet, "xla_int8_block", deep("jax", jax_ssunet.xla_int8_block))
    monkeypatch.setattr(ssunet, "fused_eval_stage_int8", port_stage)
    monkeypatch.setattr(ssunet, "int8_block", deep("port", ssunet.int8_block))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x = tiles[:1]
    want = np.asarray(model.apply(variables, jnp.asarray(x).astype(jdt), False)
                      .astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape == (1, 32, 32, 3)
    return got.float().numpy(), want, counts["port"], counts["jax"]


def check_narrow_int8_forward(monkeypatch, arch, calibrated):
    """The bf16 int8 forward of a narrow ``arch``: stages, s8 seams and deep
    blocks as JAX's, logits JAX's to ``FLAGSHIP_L2`` (dynamic) or
    ``BF16_CALIBRATED_L2`` (calibrated)."""
    got, want, counts, jax_counts = _int8_forwards(_narrow(arch), monkeypatch, calibrated, "bf16")
    assert counts == jax_counts
    assert (counts["up"], counts["pool"]) == SEAMS[arch]
    assert counts["stages"] == 6
    bar = BF16_CALIBRATED_L2 if calibrated else FLAGSHIP_L2
    assert rel_l2(got, want) <= bar, rel_l2(got, want)

