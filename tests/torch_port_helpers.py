"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: explicit JAX mode toggles, JAX stage parameters in the port's
layout, and the train-stage comparison with the JAX package."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from ssunet_gan_tpu.models import ssunet as jax_ssunet
from ssunet_gan_tpu.ops import blocks as jax_blocks
from ssunet_gan_tpu.ops import spade_kernel as jax_spade_kernel
from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
from ssunet_gan_tpu.ops import stage_kernel_int8 as jax_stage_kernel_int8
from ssunet_gan_tpu.ops import stage_kernel_train as jax_stage_kernel_train
from ssunet_gan_tpu.ops import wminor as jax_wminor
from ssunet_gan_tpu.ops.conv import Conv2d as JConv2d
from ssunet_gan_tpu.train import gan_step as jax_gan_step
from ssunet_gan_tpu_torch.ops import pool as port_pool
from ssunet_gan_tpu_torch.ops import resize as port_resize
from ssunet_gan_tpu_torch.ops import stage_kernel as port_stage_kernel
from ssunet_gan_tpu_torch.ops import stage_kernel_train as port_stage_kernel_train

# Under pytest-xdist every worker is a process of its own, and torch's
# intra-op pool takes every core by default: six workers then run some 48
# threads on 8 cores, and a torch-bound test ran ~10-30x its time alone
# (the GAN trainer end to end: 9.8 s alone, 277 s in the six-worker suite).
# Each worker takes its share of the cores instead (xdist imports every test
# module in every worker, so this holds for the whole session).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


@contextlib.contextmanager
def jax_toggles(fused_stage: bool, fused_train: bool = False, train_bwd_v3: bool = False,
                int8_stage: bool = False, fused_spade=None, remat: bool = False,
                lazy_upsample: bool = False, lazy_pool: bool = False, joint_gan: bool = True,
                pack_max_planes: int = 256):
    """Set every global mode of the JAX package that the port's tests
    reach, and restore the previous values after (another test in the same
    worker may leave, e.g., the upsample-backward decomposition on). The
    lazy seams (``lazy_upsample``, ``lazy_pool``: the decoder's bilinear
    and the encoder's pool seams read in the stage kernels) are set to the
    same values in the JAX package and in the port, and both are restored
    after, so a comparison takes its seams the same way on both sides. The
    train stage's backward is v2 unless ``train_bwd_v3``; a test holds the
    port's backward of the same version against it. ``int8_stage`` turns the
    JAX package's int8 eval mode on; its calibration scales, record sink and
    forced band height start cleared and are restored after, whatever the
    test installed. ``fused_spade`` is the JAX package's SPADE mode (None or
    False: the composition, True: "fast", or "pallas"). ``remat`` is the
    JAX package's per-block rematerialization (``ops/blocks.py``
    ``set_remat``). The stacked seg dots (``set_seg_stack``, which the JAX
    package's ``load_segmentation_models`` sets from a model card) start at
    their default and are restored after, as are the SPADE, int8 and band
    modes that it sets. ``joint_gan`` is the JAX package's GAN step
    formulation (``train/gan_step.py`` ``set_joint_gan``; True, its default:
    the joint scalar, False: alternating). ``pack_max_planes`` is the
    deep-stage opt-in's limit (``ops/stage_kernel.py``
    ``set_pack_max_planes``), set to the same value in the JAX package and
    in the port (256, the default of both, unless asked) and restored in
    both after."""
    saved = (
        jax_stage_kernel._FUSED_STAGE,
        jax_wminor._LAZY_UPSAMPLE,
        jax_wminor._LAZY_POOL,
        jax_wminor._UP_BWD_DECOMP,
        jax_stage_kernel_int8._INT8_STAGE,
        jax_stage_kernel_train._FUSED_TRAIN,
        jax_stage_kernel_train._TRAIN_BWD_V3,
        jax_stage_kernel_int8._CALIB_SCALES,
        jax_stage_kernel_int8._RECORD_SINK,
        jax_stage_kernel._BAND_ROWS,
        jax_spade_kernel._FUSED,
        jax_blocks._REMAT,
        port_resize._LAZY_UPSAMPLE,
        port_pool._LAZY_POOL,
        jax_stage_kernel._SEG_STACK,
        jax_gan_step._JOINT_GAN,
        jax_stage_kernel._PACK_MAX_PLANES,
        port_stage_kernel._PACK_MAX_PLANES,
    )
    jax_stage_kernel.set_fused_stage(fused_stage)
    jax_wminor.set_lazy_upsample(lazy_upsample)
    jax_wminor.set_lazy_pool(lazy_pool)
    port_resize.set_lazy_upsample(lazy_upsample)
    port_pool.set_lazy_pool(lazy_pool)
    jax_wminor.set_up_bwd_decomp(False)
    jax_stage_kernel_int8.set_int8_stage(int8_stage)
    jax_stage_kernel_train.set_fused_train(fused_train)
    jax_stage_kernel_train.set_train_bwd_v3(train_bwd_v3)
    jax_stage_kernel_int8.set_int8_calibration(None)
    jax_stage_kernel_int8.set_record_sink(None)
    jax_stage_kernel.set_band_rows(None)
    jax_spade_kernel.set_fused_spade(fused_spade)
    jax_blocks.set_remat(remat)
    jax_stage_kernel.set_seg_stack(None)
    jax_gan_step.set_joint_gan(joint_gan)
    jax_stage_kernel.set_pack_max_planes(pack_max_planes)
    port_stage_kernel.set_pack_max_planes(pack_max_planes)
    try:
        yield
    finally:
        jax_stage_kernel.set_fused_stage(saved[0])
        jax_wminor.set_lazy_upsample(saved[1])
        jax_wminor.set_lazy_pool(saved[2])
        jax_wminor.set_up_bwd_decomp(saved[3])
        jax_stage_kernel_int8.set_int8_stage(saved[4])
        jax_stage_kernel_train.set_fused_train(saved[5])
        jax_stage_kernel_train.set_train_bwd_v3(saved[6])
        jax_stage_kernel_int8.set_int8_calibration(saved[7])
        jax_stage_kernel_int8.set_record_sink(saved[8])
        jax_stage_kernel.set_band_rows(saved[9])
        jax_spade_kernel.set_fused_spade(saved[10])
        jax_blocks.set_remat(saved[11])
        port_resize.set_lazy_upsample(saved[12])
        port_pool.set_lazy_pool(saved[13])
        jax_stage_kernel.set_seg_stack(saved[14])
        jax_gan_step.set_joint_gan(saved[15])
        jax_stage_kernel.set_pack_max_planes(saved[16])
        port_stage_kernel.set_pack_max_planes(saved[17])


def oihw(kernel_hwio) -> torch.Tensor:
    """A JAX HWIO kernel as a torch OIHW weight."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel_hwio, np.float32).transpose(3, 2, 0, 1)))


def vec(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def bneck_bundle(jbp):
    """A JAX Bottleneck bundle ``(k1, (s1, t1), k2, (s2, t2), k3, (s3, t3),
    ks, (ss, ts))`` in the port's layout: OIHW weights, f32 vectors; the
    identity shortcut's ``ks`` and affine stay None."""
    k1, a1, k2, a2, k3, a3, ks, asb = jbp
    pair = lambda a: (vec(a[0]), vec(a[1]))
    return (oihw(k1), pair(a1), oihw(k2), pair(a2), oihw(k3), pair(a3),
            None if ks is None else oihw(ks), None if asb is None else pair(asb))


def randomize_batch_stats(variables, seed: int = 7):
    """Random BN running statistics (numpy), so the eval affine matters."""
    g = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {
                k: (
                    (g.random(np.shape(v)) + 0.5).astype(np.float32) if k == "var"
                    else (g.normal(size=np.shape(v)) * 0.3).astype(np.float32)
                    if k == "mean" else walk(v)
                )
                for k, v in dict(node).items()
            }
        return np.asarray(node)

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


def wminor(x):
    """NHWC numpy → the JAX kernels' (N, H, C, W) view."""
    return jnp.swapaxes(jnp.asarray(x), 2, 3)


def nhwc_of_wminor(v):
    return np.swapaxes(np.asarray(v), 2, 3)


def tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def spade_weights(rng, planes, lab, nh):
    """SPADE weights: HWIO for JAX, OIHW for the port."""
    hwio = (normal(rng, (3, 3, planes, lab), 0.1), normal(rng, (lab,), 0.1),
            normal(rng, (3, 3, lab, nh), 0.3), normal(rng, (nh,), 0.1),
            normal(rng, (3, 3, nh, planes), 0.2), normal(rng, (planes,), 0.1),
            normal(rng, (3, 3, nh, planes), 0.2), normal(rng, (planes,), 0.1))
    return hwio, tuple(oihw(a) if a.ndim == 4 else vec(a) for a in hwio)


# The JAX package's UNetBSS and UNetRSS fix their widths; these subclasses
# repeat their bodies at narrow widths, through the package's own stage
# dispatch, for the model tests.
B_FILTERS = (8, 16, 32, 48, 64)
R_FILTERS = (8, 16, 32, 48, 64, 96)
S_FILTERS = (8, 16, 32, 48, 64)


class NarrowUNetBSS(jax_ssunet.UNetBSS):
    """The JAX ``UNetBSS`` body (models/ssunet.py:396-427) at ``B_FILTERS``."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        f, ss, C = B_FILTERS, 16, self.num_classes
        qpool, up, spade_stage = jax_ssunet._qpool, jax_ssunet._up, jax_ssunet._spade_stage

        def stage(xin, i, bname, sname):
            return spade_stage(xin, f[i], C, ss, bname, sname, train, block="bneck")[0]

        x0_0 = stage(x, 0, "conv0_0", "SPADE0_0")
        x1_0 = stage(qpool(x0_0, train), 1, "conv1_0", "SPADE1_0")
        x2_0 = stage(qpool(x1_0, train), 2, "conv2_0", "SPADE2_0")
        x3_0 = stage(qpool(x2_0, train), 3, "conv3_0", "SPADE3_0")
        x4_0 = stage(qpool(x3_0, train), 4, "conv4_0", "SPADE4_0")
        x3_1 = stage((x3_0, up(x4_0, True)), 3, "conv3_1", "SPADE3_1")
        x2_2 = stage((x2_0, up(x3_1, train)), 2, "conv2_2", "SPADE2_2")
        x1_3 = stage((x1_0, up(x2_2, train)), 1, "conv1_3", "SPADE1_3")
        return spade_stage(
            (x0_0, up(x1_3, train)), f[0], C, ss, "conv0_4", "SPADE0_4", train,
            final_conv=JConv2d(self.num_classes, 1, name="final", in_channels=f[0]),
            block="bneck")[1]


class NarrowUNetRSS(jax_ssunet.UNetRSS):
    """The JAX ``UNetRSS`` body (models/ssunet.py:438-471) at ``R_FILTERS``."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        f, ss, C = R_FILTERS, 16, self.num_classes
        qpool, up = jax_ssunet._qpool, jax_ssunet._up

        def stage(xin, feat, bname, sname, out_key=None, final_conv=None):
            return jax_ssunet._spade_stage(xin, feat, C, ss, bname, sname, train,
                                           final_conv=final_conv, out_calib_key=out_key)

        x0_0 = stage(x, f[0], "conv0_0", "SPADE0_0", "conv0_4:0")[0]
        x1_0 = stage(qpool(x0_0, train), f[1], "conv1_0", "SPADE1_0", "conv1_3:0")[0]
        x2_0 = stage(qpool(x1_0, train), f[2], "conv2_0", "SPADE2_0", "conv2_2:0")[0]
        x3_0 = stage(qpool(x2_0, train), f[3], "conv3_0", "SPADE3_0", "conv3_1:0")[0]
        x4_0 = stage(qpool(x3_0, train), f[4], "conv4_0", "SPADE4_0", "conv4_1:0")[0]
        x5_0 = stage(qpool(x4_0, train), f[5], "conv5_0", "SPADE5_0")[0]
        x4_1 = stage((x4_0, up(x5_0, train, "conv4_1:1")), f[4], "conv4_1", "SPADE4_1")[0]
        x3_1 = stage((x3_0, up(x4_1, train, "conv3_1:1")), f[3], "conv3_1", "SPADE3_1")[0]
        x2_2 = stage((x2_0, up(x3_1, train, "conv2_2:1")), f[2], "conv2_2", "SPADE2_2")[0]
        x1_3 = stage((x1_0, up(x2_2, train, "conv1_3:1")), f[1], "conv1_3", "SPADE1_3")[0]
        return stage((x0_0, up(x1_3, train, "conv0_4:1")), f[0], "conv0_4", "SPADE0_4",
                     final_conv=jax_ssunet._final_conv(self.num_classes, in_channels=f[0]))[1]


class NarrowSSUNet(jax_ssunet.SSUNet):
    """The JAX ``SSUNet`` body (models/ssunet.py:356-391) at ``S_FILTERS``."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        f, ss, C = S_FILTERS, 4, self.num_classes
        qpool, up = jax_ssunet._qpool, jax_ssunet._up

        def stage(xin, i, bname, sname, out_key=None):
            return jax_ssunet._spade_stage(xin, f[i], C, ss, bname, sname, train, block="vgg",
                                           out_calib_key=out_key)[0]

        x0_0 = stage(x, 0, "conv0_0", "SPADE0_0", "conv0_4:0")
        x1_0 = stage(qpool(x0_0, train), 1, "conv1_0", "SPADE1_0", "conv1_3:0")
        x2_0 = stage(qpool(x1_0, train), 2, "conv2_0", "SPADE2_0", "conv2_2:0")
        x3_0 = stage(qpool(x2_0, train), 3, "conv3_0", "SPADE3_0", "conv3_1:0")
        x4_0 = stage(qpool(x3_0, train), 4, "conv4_0", "SPADE4_0")
        x3_1 = stage((x3_0, up(x4_0, train, "conv3_1:1")), 3, "conv3_1", "SPADE3_1")
        x2_2 = stage((x2_0, up(x3_1, train, "conv2_2:1")), 2, "conv2_2", "SPADE2_2")
        x1_3 = stage((x1_0, up(x2_2, train, "conv1_3:1")), 1, "conv1_3", "SPADE1_3")
        return jax_ssunet._spade_stage(
            (x0_0, up(x1_3, train, "conv0_4:1")), f[0], C, ss, "conv0_4", "SPADE0_4", train,
            final_conv=JConv2d(self.num_classes, 1, name="final", in_channels=f[0]),
            block="vgg")[1]


# (planes, labels, part shapes, hidden, head classes) of the train-stage
# tests (tests/test_train_kernel.py:48-50, :147)
STAGES = [
    (16, 3, [(2, 16, 16, 8)], 4, 0),
    (16, 3, [(1, 16, 16, 8), (1, 16, 16, 16)], 4, 0),      # split-concat
    (32, 2, [(2, 24, 16, 16)], 8, 0),
    (16, 3, [(1, 16, 16, 8)], 4, 3),                       # folded head
]


def stage_bundle(rng, planes, shapes, lab, nh, ncls):
    """Random raw train parameters: JAX (HWIO) and port (OIHW) forms."""
    csum = sum(s[-1] for s in shapes)
    bp = (normal(rng, (3, 3, csum, planes), 0.2),
          ((rng.random(planes) + 0.5).astype(np.float32), normal(rng, (planes,), 0.2)),
          normal(rng, (3, 3, planes, planes), 0.1),
          ((rng.random(planes) + 0.5).astype(np.float32), normal(rng, (planes,), 0.2)),
          normal(rng, (1, 1, csum, planes), 0.3))
    sp, tsp = spade_weights(rng, planes, lab, nh)
    head = thead = None
    if ncls:
        head = (normal(rng, (1, 1, planes, ncls), 0.3), normal(rng, (ncls,), 0.1))
        thead = (oihw(head[0]), vec(head[1]))
    k1, (g1, b1), k2, (g2, b2), ks = bp
    tbp = (oihw(k1), (vec(g1), vec(b1)), oihw(k2), (vec(g2), vec(b2)), oihw(ks))
    return bp, sp, head, tbp, tsp, thead


def stage_matches_jax(rng, planes, lab, shapes, nh, ncls):
    """The port's ``fused_train_stage`` against the JAX package's, each with
    the backward its toggles select: forward and batch stats to rtol = atol
    = 2e-4, every gradient to max |Δ| ≤ 1e-3 · max |JAX| (the JAX package's
    own gradient bar)."""
    xs = [normal(rng, s) for s in shapes]
    bp, sp, head, tbp, tsp, thead = stage_bundle(rng, planes, shapes, lab, nh, ncls)
    n, h, w = shapes[0][:3]
    cot = normal(rng, (n, h, w, ncls or planes))

    def jax_loss(parts, bp, sp, head):
        out, stats = jax_stage_kernel_train.fused_train_stage(parts, bp, sp, head)
        out = out if head is not None else jax_wminor.to_nhwc(out)
        return jnp.sum(out * cot), (out, stats)

    jparts = tuple(jnp.asarray(x) for x in xs)
    jbp = jax.tree_util.tree_map(jnp.asarray, bp)
    jsp = tuple(jnp.asarray(a) for a in sp)
    jhead = None if head is None else tuple(jnp.asarray(a) for a in head)
    argnums = (0, 1, 2) if head is None else (0, 1, 2, 3)
    (_, (want_out, want_stats)), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(jparts, jbp, jsp, jhead)

    parts = tuple(tensor(x).requires_grad_() for x in xs)
    params = [t.requires_grad_() for t in
              (tbp[0], *tbp[1], tbp[2], *tbp[3], tbp[4], *tsp, *(thead or ()))]
    out, stats = port_stage_kernel_train.fused_train_stage(parts, tbp, tsp, thead)
    grads = torch.autograd.grad((out * tensor(cot)).sum(), [*parts, *params])

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    for got_pair, want_pair in zip(stats, want_stats):
        for g, wv in zip(got_pair, want_pair):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=2e-4, atol=2e-4)

    # JAX grads in the port's order and layout: parts, then the parameters
    jg_parts, (gk1, (gg1, gb1), gk2, (gg2, gb2), gks), jg_sp = jgrads[:3]
    want = list(jg_parts) + [gk1, gg1, gb1, gk2, gg2, gb2, gks] + list(jg_sp)
    if head is not None:
        want += list(jgrads[3])
    assert len(want) == len(grads)
    for i, (g, wv) in enumerate(zip(grads, want)):
        wv = np.asarray(wv, np.float64)
        if wv.ndim == 4 and g.dim() == 4 and i >= len(parts):
            wv = oihw(wv).numpy()
        rel = np.abs(g.double().numpy() - wv).max() / (np.abs(wv).max() + 1e-6)
        assert rel < 1e-3, (i, rel)


def jax_eval_stage(rng, planes, shapes, bottleneck: bool = False, label: int = 3) -> dict:
    """A JAX eval stage case (BasicBlock, or Bottleneck, + self-SPADE with
    hidden planes / 16, as the flagship's): numpy inputs, the JAX
    variables' parameter bundles (``jbp``, ``jsp``) and the port's
    (``tbp``, ``tsp``), and the JAX module composition's output."""
    from ssunet_gan_tpu.ops.spade import SPADE as JSPADE

    block_cls = jax_blocks.Bottleneck if bottleneck else jax_blocks.BasicBlock
    block = block_cls(planes)
    spade = JSPADE("spadebatch3x3", planes, label, planes / 16)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jparts = tuple(jnp.asarray(x) for x in xs)
    xin = jparts if len(jparts) > 1 else jparts[0]
    bvars = randomize_batch_stats(jax.jit(lambda: block.init(jax.random.PRNGKey(0), xin,
                                                             True))())
    y0 = jnp.zeros(shapes[0][:3] + (planes,), jnp.float32)
    svars = jax.jit(lambda: spade.init(jax.random.PRNGKey(1), y0, y0))()
    jbp = block_cls(planes, in_planes=sum(s[-1] for s in shapes)).apply(bvars, None, False)
    jsp = spade.apply(svars, None, None)
    if bottleneck:
        tbp = bneck_bundle(jbp)
    else:
        k1, (s1, t1), k2, (s2, t2), ks = jbp
        tbp = (oihw(k1), (vec(s1), vec(t1)), oihw(k2), (vec(s2), vec(t2)), oihw(ks))
    tsp = tuple(oihw(a) if np.ndim(a) == 4 else vec(a) for a in jsp)
    y = block.apply(bvars, xin, False)
    return dict(xs=xs, jparts=jparts, jbp=jbp, jsp=jsp, tbp=tbp, tsp=tsp,
                composition=np.asarray(spade.apply(svars, y, y)))


def tail_from_packed(y: torch.Tensor, pk: dict) -> torch.Tensor:
    """The SPADE tail (+ folded head) on ``y`` from ``pack_spade``'s operands
    walked in the tail kernel's K orders (csrc/stage_common.cuh), in f32
    and without roundings: seg's K is (tap, channel) against ``k1t``'s 8
    label rows; act's FMAs run over (tap, label); γ|β's K is (tap, 8-channel
    group of hidden) pairs padded to whole k16 steps, and its N rows
    interleave γ and β per 8 channels; the head's N is ``kft``'s 8 rows."""
    from ssunet_gan_tpu_torch.ops.spade_kernel import im2col_3x3
    from ssunet_gan_tpu_torch.ops.stage_kernel import tail_gb_steps, tail_widths

    n, h, w, c = y.shape
    lab, nh, ncls = tail_widths(pk)
    k1t = pk["k1t"].float()
    assert k1t.shape == (max(8, lab), 9, c)
    seg = im2col_3x3(y) @ k1t.reshape(-1, 9 * c).t()
    assert not seg[..., lab:].any()  # the padded label rows are zero
    seg = seg[..., :lab] + pk["b1s"]
    act = torch.relu(im2col_3x3(seg) @ pk["k2s"].reshape(9 * lab, nh) + pk["b2s"])
    groups, steps = -(-nh // 8), tail_gb_steps(nh)
    a = torch.nn.functional.pad(act, (0, 8 * groups - nh))
    a = im2col_3x3(a)  # k8 group q = tap · groups + group
    a = torch.nn.functional.pad(a, (0, 16 * steps - 72 * groups))
    kgbt = pk["kgbt"].float()
    assert kgbt.shape[1] == 16 * steps and kgbt.shape[0] % 16 == 0
    gb = (a @ kgbt.t()).reshape(n, h, w, -1, 2, 8)  # (8-channel group, γ|β, channel)
    gamma = gb[..., 0, :].reshape(n, h, w, -1)[..., :c] + pk["bgb"][:c]
    beta = gb[..., 1, :].reshape(n, h, w, -1)[..., :c] + pk["bgb"][c:]
    out = y * (1 + gamma) + beta
    if ncls:
        kft = pk["kft"].float()
        assert kft.shape == (max(8, ncls), c) and not kft[ncls:].any()
        out = out @ kft[:ncls].t() + pk["bf"]
    return out


def conv_from_packed(sources, conv: dict) -> torch.Tensor:
    """The eval conv core's sum (before its bias and epilogue) from the
    packed weight of ``pack_eval_conv``, walked in the kernel's K order
    (csrc/eval_conv.cuh), in f32: per N block, per K-segment, per chunk of
    ``eval_chunk`` channels, per k16 step and k8 half, the (tap, 8-channel
    group) pair's shifted input values (zero ring for a 3×3 segment)
    against that half's core matrices [N/8][8][8]. A pair past the chunk's
    last reads the centre tap's first group, as the kernel does, so a
    nonzero padding weight shows. Output channels past ``cout`` must be 0."""
    import torch.nn.functional as F

    from ssunet_gan_tpu_torch.ops.stage_kernel import eval_chunk

    w, nt, nblk = conv["w"].float(), conv["nt"], conv["nblk"]
    assert w.shape == (nblk * conv["steps"], nt // 8, 2, 8, 8)
    n, h, wd = sources[0].shape[:3]
    acc = torch.zeros((n, h, wd, nblk * nt))
    step = 0
    for b in range(nblk):  # N block b: output channels b·nt ..
        for x, (c, k) in zip(sources, conv["segs"]):
            assert x.shape[-1] == c
            cc, taps = eval_chunk(c), k * k
            ngrp, nch = cc // 8, -(-c // cc)
            xp = F.pad(x.float(), (0, nch * cc - c) + ((1, 1, 1, 1) if k == 3 else ()))
            for ch in range(nch):
                for s in range((taps * ngrp + 1) // 2):
                    for half in range(2):
                        q = 2 * s + half
                        tap, grp = divmod(q, ngrp) if q < taps * ngrp else (taps // 2, 0)
                        dy, dx = divmod(tap, 3) if k == 3 else (0, 0)
                        c0 = ch * cc + grp * 8
                        wt = w[step, :, half].reshape(nt, 8).t()
                        acc[..., b * nt:(b + 1) * nt] += xp[:, dy:dy + h, dx:dx + wd, c0:c0 + 8] @ wt
                    step += 1
        assert step == (b + 1) * conv["steps"]
    assert not acc[..., conv["cout"]:].any()  # the padded N rows are zero
    return acc[..., :conv["cout"]]


def s8_conv_from_packed(sources, conv: dict):
    """The s8 conv core's integer sums, one per K-segment, from the packed
    weight of ``pack_s8_conv``, walked in the kernel's K order
    (csrc/int8_conv.cuh), in f64 (exact): per N block, per K-segment, per
    chunk of ``eval_chunk(c, 16)`` channels, per k32 step and K half, the
    (tap, 16-channel group) pair's shifted s8 input values (zero ring for a
    3×3 segment) against that half's core matrices [N/8][8][16]. A half
    past the chunk's last pair re-reads the first half's values, as the
    kernel does, so a nonzero padding weight shows. Output channels past
    ``cout`` must be 0."""
    import torch.nn.functional as F

    from ssunet_gan_tpu_torch.ops.stage_kernel import eval_chunk

    nt, nblk, steps = conv["nt"], conv["nblk"], conv["steps"]
    w = conv["w"].double()
    assert conv["w"].dtype == torch.int8 and w.shape == (nblk * steps, nt // 8, 2, 8, 16)
    n, h, wd = sources[0].shape[:3]
    sums = [torch.zeros((n, h, wd, nblk * nt), dtype=torch.float64) for _ in sources]
    for b in range(nblk):
        step = b * steps
        for i, (x, (c, k)) in enumerate(zip(sources, conv["segs"])):
            assert x.shape[-1] == c and x.dtype == torch.int8
            cc, taps = eval_chunk(c, 16), k * k
            ngrp, nch = cc // 16, -(-c // cc)
            xp = F.pad(x.double(), (0, nch * cc - c) + ((1, 1, 1, 1) if k == 3 else ()))
            for ch in range(nch):
                for s in range((taps * ngrp + 1) // 2):
                    for half in range(2):
                        q = 2 * s + half
                        tap, grp = divmod(q if q < taps * ngrp else 2 * s, ngrp)
                        dy, dx = divmod(tap, 3) if k == 3 else (0, 0)
                        c0 = ch * cc + grp * 16
                        wt = w[step, :, half].reshape(nt, 16).t()
                        sums[i][..., b * nt:(b + 1) * nt] += (
                            xp[:, dy:dy + h, dx:dx + wd, c0:c0 + 16] @ wt)
                    step += 1
        assert step == (b + 1) * steps
    for sm in sums:
        assert not sm[..., conv["cout"]:].any()  # the padded N rows are zero
    return [sm[..., :conv["cout"]] for sm in sums]
