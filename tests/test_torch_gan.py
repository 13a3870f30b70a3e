"""The port's adversarial fine-tune against the JAX package: the GAN's
networks and blocks, the losses of ops/losses.py, Adam, one G/D step in
each formulation, the step with G's fused train stages, hazard a, the warm
start, the trainer and the CLI, and srgan_utils.

Inputs come from numpy with a seed and weights from the JAX package's
variables through ``compat.from_jax_variables``. Tolerances, f32: module
outputs, running statistics, u and v relative L2 ≤ 1e-5 (the same f32
arithmetic summed in other orders); gradients ≤ 1e-5 relative L2; losses
and metrics rtol 1e-5 (IoU counts thresholded elements: one element of its
union, as tests/test_torch_train.py); Adam's parameters rtol 1e-6 with atol
1e-9 (one update formula in another order). The GAN step: metrics rtol
1e-4; each clipped gradient relative L2 ≤ 1e-4 (measured ≤ 4e-5), with a
floor of 2e-6 of the largest gradient for the conv biases ahead of a
BatchNorm (0 analytically, f32 noise on both sides); the SGD-updated
parameters within two f32 roundings plus lr times that bar; both networks'
running statistics 1e-4 (tests/test_torch_train.py's bars).
"""

import copy
import functools
import json
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ssunet_gan_tpu import srgan_utils as jsrgan
from ssunet_gan_tpu.compat import convert_torch_state_dict, discriminator_fc1_transform
from ssunet_gan_tpu.models import gan as jgan
from ssunet_gan_tpu.models import vgg as jvgg
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.ops import resize as jresize
from ssunet_gan_tpu.ops.spectral import SNConv2d as JSNConv2d
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.gan_step import make_gan_train_step as jax_make_gan_train_step
from ssunet_gan_tpu.train.optim import LRScheduler as JLRScheduler
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu_torch import srgan_utils
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.config import dump_model_card, load_experiment_config
from ssunet_gan_tpu_torch.data.png import write_image
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models import gan as tgan
from ssunet_gan_tpu_torch.models import ssunet as tssunet
from ssunet_gan_tpu_torch.models import vgg as tvgg
from ssunet_gan_tpu_torch.ops import collectives, losses, norm
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from ssunet_gan_tpu_torch.ops.resize import adaptive_avg_pool, pixel_shuffle
from ssunet_gan_tpu_torch.ops.spectral import SNConv2d
from ssunet_gan_tpu_torch.train import checkpoint as ckpt
from ssunet_gan_tpu_torch.train import gan as tgan_train
from ssunet_gan_tpu_torch.train import gan_step
from ssunet_gan_tpu_torch.train.optim import ConstantLR, adam
from torch_dp_helpers import model_axis_mesh
from torch_port_helpers import S_FILTERS, NarrowSSUNet, jax_toggles


@pytest.fixture(autouse=True)
def _modes():
    """JAX's global modes set and restored; the port's GAN formulation
    reset to its default after each test."""
    with jax_toggles(fused_stage=False):
        yield
    gan_step.set_joint_gan(True)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _init(module, x, seed=0, *args):
    """The module's variables drawn from numpy with ``seed``, their shapes
    from ``jax.eval_shape`` (nothing compiled): kernels U(±1/√fan_in),
    biases 0.1·N, BN scales 1 + 0.2·N, running means 0.3·N and variances
    U(0.5, 1.5), PReLU slopes 0.25 + 0.05·N, spectral u and v normalized
    N."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args))
    g = np.random.default_rng(seed)

    def draw(path, leaf):
        col, name, shape = path[0].key, path[-1].key, leaf.shape
        n = lambda: g.normal(size=shape)
        if col == "spectral":
            v = n()
            v = v / np.linalg.norm(v)
        elif col == "batch_stats":
            v = 0.3 * n() if name == "mean" else g.random(shape) + 0.5
        elif name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            v = g.uniform(-bound, bound, shape)
        else:
            v = {"scale": 1 + 0.2 * n(), "bias": 0.1 * n(), "alpha": 0.25 + 0.05 * n()}[name]
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _back_to_jax(sd, template, fc1_channels=None):
    """The port's state_dict through the JAX package's torch converter."""
    special = ({"fc1.weight": discriminator_fc1_transform(fc1_channels)}
               if fc1_channels else None)
    back, report = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                            template, special_transforms=special)
    assert report["unmatched"] == [] and report["skipped"] == [], report
    return back


# ---- the networks and their blocks ------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("n_blocks", [2, 8])
def test_discriminator_matches_jax(rng, n_blocks, train):
    """D (2 classes, 8 channels, fc 16) on 32² maps: the logits, and in
    training the BatchNorms' running statistics after the call; its
    state_dict maps back onto the JAX variables by the JAX converter's
    rules (fc1 permuted NCHW → NHWC), leaf for leaf."""
    x = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
    jd = jgan.Discriminator(num_classes=2, kernel_size=3, n_channels=8, n_blocks=n_blocks,
                            fc_size=16)
    variables = _init(jd, x[:1], 0, True)
    port = tgan.Discriminator(2, 3, 8, n_blocks, 16)
    sd = from_jax_variables(variables)
    port.load_state_dict(sd)
    last = port.fc1.weight.shape[1] // 36
    back = _back_to_jax(sd, variables, last)
    assert _leaves(back).keys() == _leaves(variables).keys()
    for k, v in _leaves(variables).items():
        np.testing.assert_array_equal(_leaves(back)[k], v, err_msg=k)
    port.train(train)
    got = port(torch.from_numpy(x))
    if train:
        want, upd = jax.jit(lambda v, a: jd.apply(v, a, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        new_sd = from_jax_variables({"params": variables["params"], **upd})
        for k, v in port.state_dict().items():
            if "running" in k:
                assert rel_l2(v.numpy(), new_sd[k].numpy()) <= 1e-5, k
    else:
        want = jax.jit(lambda v, a: jd.apply(v, a, False))(variables, jnp.asarray(x))
    assert got.shape == (2, 1)
    assert rel_l2(got.detach().numpy(), want) <= 1e-5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sn_conv_matches_jax(rng, train):
    """SNConv2d (4 → 6 channels, k 3, padding 1): output, u and v (one
    power iteration in training, none in eval), and in training the
    gradient with respect to the kernel through sigma."""
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    cot = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    jm = JSNConv2d(6, 3, padding=1)
    variables = _init(jm, x[:1], 0, True)
    port = SNConv2d(4, 6, 3, padding=1)
    port.load_state_dict(from_jax_variables(variables))
    port.train(train)
    out = port(torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(params):
        y, upd = jm.apply({"params": params, "spectral": variables["spectral"]},
                          jnp.asarray(x), train, mutable=["spectral"])
        return jnp.sum(y * cot), (y, upd)

    grads, (want, upd) = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    assert rel_l2(out.detach().numpy(), want) <= 1e-5
    new_sd = from_jax_variables({"params": variables["params"], **upd})
    for name in ("weight_u", "weight_v"):
        assert rel_l2(getattr(port, name).numpy(), new_sd[name].numpy()) <= 1e-5, name
    if train:
        assert not torch.equal(port.weight_u, from_jax_variables(variables)["weight_u"])
    want_g = np.asarray(grads["kernel"]).transpose(3, 2, 0, 1)
    assert rel_l2(port.weight_orig.grad.numpy(), want_g) <= 1e-5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_srresnet_matches_jax(rng, train):
    """SRResNet (2 blocks, 8 channels, ×2): the output at twice the size,
    and its state_dict back onto the JAX variables leaf for leaf."""
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    jm = jgan.SRResNet(n_channels=8, n_blocks=2, scaling_factor=2)
    variables = _init(jm, x[:1], 0, True)
    port = tgan.SRResNet(n_channels=8, n_blocks=2, scaling_factor=2)
    sd = from_jax_variables(variables)
    port.load_state_dict(sd)
    back = _back_to_jax(sd, variables)
    for k, v in _leaves(variables).items():
        np.testing.assert_array_equal(_leaves(back)[k], v, err_msg=k)
    port.train(train)
    got = port(torch.from_numpy(x))
    apply = (lambda v, a: jm.apply(v, a, True, mutable=["batch_stats"])[0]) if train else (
        lambda v, a: jm.apply(v, a, False))
    want = jax.jit(apply)(variables, jnp.asarray(x))
    assert got.shape == (2, 16, 16, 3)
    assert rel_l2(got.detach().numpy(), want) <= 1e-5


@pytest.mark.parametrize("shape,out", [((2, 32, 32, 5), (6, 6)), ((1, 7, 9, 3), (3, 4)),
                                       ((2, 2, 2, 4), (6, 6)), ((1, 5, 3, 2), (6, 7))],
                         ids=["down", "down-uneven", "up", "up-uneven"])
def test_adaptive_avg_pool_matches_jax(rng, shape, out):
    x = rng.normal(size=shape).astype(np.float32)
    got = adaptive_avg_pool(torch.from_numpy(x), *out)
    want = jresize.adaptive_avg_pool(jnp.asarray(x), *out)
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch(rng, r):
    """The JAX function, and torch's ``nn.PixelShuffle`` on the NCHW view:
    equal element for element."""
    x = rng.normal(size=(2, 3, 4, 2 * r * r)).astype(np.float32)
    got = pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.pixel_shuffle(jnp.asarray(x), r)))
    ref = torch.nn.PixelShuffle(r)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)


@functools.lru_cache(maxsize=None)
def _vgg_features_state(seed=3):
    """A torchvision ``vgg19().features``-style state_dict (random, drawn
    once; not to be modified): every conv of the plan, including those past
    the truncation."""
    g = np.random.default_rng(seed)
    sd, in_ch = {}, 3
    for entry in tvgg.VGG19_PLAN:
        if entry == "M":
            continue
        idx, ch = entry
        sd[f"features.{idx}.weight"] = (g.normal(size=(ch, in_ch, 3, 3))
                                        * np.sqrt(2.0 / (9 * in_ch))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (0.1 * g.normal(size=(ch,))).astype(np.float32)
        in_ch = ch
    return sd


def test_truncated_vgg19_matches_jax(rng):
    """TruncatedVGG19 at 32²: the truncation point of every valid (i, j)
    equals JAX's; at (3, 2) (six convs) both packages load the same
    torchvision-style state_dict with their ``load_torch_vgg19`` and agree
    on the features."""
    valid = [(i, j) for i in range(1, 6) for j in range(1, 5)
             if not (i <= 2 and j > 2)]
    for i, j in valid:
        assert tvgg.truncation_point(i, j) == jvgg.truncation_point(i, j), (i, j)
    with pytest.raises(AssertionError):
        tvgg.truncation_point(1, 3)
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    sd = _vgg_features_state()
    jm = jvgg.TruncatedVGG19(3, 2)
    jvars, _ = jvgg.load_torch_vgg19(sd, _init(jm, x))
    port = tvgg.TruncatedVGG19(3, 2)
    report = tvgg.load_torch_vgg19({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    assert not report["missing"] and len(report["loaded"]) == 12
    got = port(torch.from_numpy(x))
    want = jax.jit(jm.apply)(jvars, jnp.asarray(x))
    assert got.shape == want.shape == (1, 8, 8, 256)
    assert rel_l2(got.detach().numpy(), want) <= 1e-5


@pytest.mark.parametrize("prefix", ["features.", "truncated_vgg19.", "module.features.", ""])
def test_load_torch_vgg19_renames(prefix):
    """torchvision's, the reference module's, a DataParallel copy's and bare
    keys all land on ``truncated_vgg19.<k>``; the convs past the truncation
    are reported, never loaded."""
    i, j = 2, 2
    port = tvgg.TruncatedVGG19(i, j)
    keep = tvgg.truncation_point(i, j)
    sd = {k.replace("features.", prefix, 1): torch.from_numpy(v)
          for k, v in _vgg_features_state().items()}
    report = tvgg.load_torch_vgg19(sd, port)
    assert sorted(report["loaded"]) == sorted(port.state_dict()) and not report["missing"]
    kept = {e[0] for e in tvgg.VGG19_PLAN[:keep] if e != "M"}
    assert len(report["unmatched"]) == 2 * (16 - len(kept))
    w = port.truncated_vgg19[5].weight
    assert torch.equal(w, sd[f"{prefix}5.weight"])


# ---- losses and Adam -------------------------------------------------------------


@pytest.mark.parametrize("per_image", [True, False])
def test_lovasz_hinge_matches_jax(rng, per_image):
    """The loss and its gradient w.r.t. the logits (ties included: logits
    rounded to 0.5)."""
    logits = np.round(rng.normal(size=(3, 6, 5, 1)) * 2) / 2
    labels = (rng.random((3, 6, 5, 1)) > 0.5).astype(np.float32)
    x = torch.from_numpy(logits.astype(np.float32)).requires_grad_()
    got = losses.lovasz_hinge(x, torch.from_numpy(labels), per_image)
    got.backward()
    f = lambda lg: jlosses.lovasz_hinge(lg, jnp.asarray(labels), per_image)
    want, gwant = jax.jit(jax.value_and_grad(f))(jnp.asarray(logits, jnp.float32))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert rel_l2(x.grad.numpy(), gwant) <= 1e-5
    if per_image:
        np.testing.assert_allclose(losses.get_loss("LovaszHingeLoss")(x, torch.from_numpy(labels))
                                   .item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("classes,per_image,ignore", [
    ("present", False, None), ("all", True, None), ([0, 2], False, None),
    ("present", True, 255)], ids=["present", "all-per-image", "list", "ignore"])
def test_lovasz_softmax_matches_jax(rng, classes, per_image, ignore):
    probs = rng.dirichlet(np.ones(4), size=(2, 5, 6)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 5, 6))  # class 3 absent
    if ignore is not None:
        labels[0, :2] = ignore
    x = torch.from_numpy(probs).requires_grad_()
    got = losses.lovasz_softmax(x, torch.from_numpy(labels), classes, per_image, ignore)
    got.backward()
    f = lambda p: jlosses.lovasz_softmax(p, jnp.asarray(labels), classes, per_image, ignore)
    want, gwant = jax.jit(jax.value_and_grad(f))(jnp.asarray(probs))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert rel_l2(x.grad.numpy(), gwant) <= 1e-5


@pytest.mark.parametrize("ignore", [None, 255])
def test_cross_entropies_and_masked_l1_match_jax(rng, ignore):
    logits = (rng.normal(size=(2, 4, 5, 3)) * 2).astype(np.float32)
    lab = rng.integers(0, 3, (2, 4, 5))
    blab = rng.integers(0, 2, (2, 4, 5)).astype(np.int64)
    if ignore is not None:
        lab[0, 0] = blab[1, 1] = ignore
    img = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    masks = [(rng.random((2, 4, 5, 2)) > 0.5).astype(np.float32) for _ in range(2)]
    t = torch.from_numpy
    pairs = [
        (losses.binary_xloss(t(logits[..., 0]), t(blab), ignore),
         jlosses.binary_xloss(jnp.asarray(logits[..., 0]), jnp.asarray(blab), ignore)),
        (losses.xloss(t(logits), t(lab), ignore), jlosses.xloss(jnp.asarray(logits),
                                                                jnp.asarray(lab), ignore)),
        (losses.masked_l1_loss(t(img), t(masks[0]), t(masks[1])),
         jlosses.masked_l1_loss(jnp.asarray(img), jnp.asarray(masks[0]), jnp.asarray(masks[1]))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("per_image,ignore", [(True, None), (False, None), (True, 2)])
def test_iou_matches_jax(rng, per_image, ignore):
    preds = rng.integers(0, 3, (3, 4, 4))
    labels = rng.integers(0, 3, (3, 4, 4))
    labels[2] = 0  # an image without foreground: EMPTY where the union is empty
    preds[2] = 0
    t = torch.from_numpy
    got = losses.iou_binary(t(preds.clip(0, 1)), t(labels.clip(0, 1)), 1.0, ignore, per_image)
    want = jlosses.iou_binary(jnp.asarray(preds.clip(0, 1)), jnp.asarray(labels.clip(0, 1)),
                              1.0, ignore, per_image)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got = losses.iou(t(preds), t(labels), 3, 1.0, ignore, per_image)
    want = jlosses.iou(jnp.asarray(preds), jnp.asarray(labels), 3, 1.0, ignore, per_image)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_adam_matches_optax(rng):
    """The GAN's bare Adam over five fixed gradients with the rate given per
    step, against the JAX package's ``adam`` scaled by the same rates."""
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) * s for s in (1.0, 0.1, 3.0, 0.0, 1e-3)]
    lrs = [1e-3, 2e-5, 1e-2, 1e-3, 5e-4]
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam([w])
    assert opt.defaults["weight_decay"] == 0 and opt.defaults["betas"] == (0.9, 0.999)
    tx = joptim.adam()
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g, lr in zip(grads, lrs):
        w.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: u * lr, upd))
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-9)


# ---- one GAN step against the JAX package ------------------------------------


class _NarrowGen(nn.Module):
    """The JAX generator around the narrow SSUNet, named ``net`` as
    models/gan.py's ``Generator``."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        return NarrowSSUNet(num_classes=2, name="net")(x, train)


@pytest.fixture(scope="module")
def gan_pair():
    """The narrow SSUNet generator (2 classes) and D (8 channels, 2 blocks,
    fc 1024, test_gan_parity.py's) as JAX variables, and a 32² batch."""
    g = np.random.default_rng(11)
    x = g.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = (g.random((2, 32, 32, 2)) > 0.5).astype(np.float32)
    with jax_toggles(fused_stage=False):
        gv = _init(_NarrowGen(), x[:1], 0, True)
        dv = _init(jgan.Discriminator(num_classes=2, kernel_size=3, n_channels=8, n_blocks=2,
                                      fc_size=1024), y[:1], 1, True)
    return gv, dv, x, y


def _port_gan(gv, dv):
    gen = tgan.Generator("SSUNet", 2, 3, device="cpu")
    gen.net = build_model("SSUNet", 2, 3, filters=S_FILTERS, device="cpu")
    gen.load_state_dict(from_jax_variables(gv))
    disc = tgan.Discriminator(2, 3, 8, 2, 1024)
    disc.load_state_dict(from_jax_variables(dv))
    return gen, disc


# the GAN step's gradient bar: relative L2 per leaf, with a floor for the
# conv biases ahead of a BatchNorm, whose gradient is 0 analytically and f32
# noise in both packages (≤ 1.1e-6 of the largest gradient measured)
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-6


def _sgd_keeping_grads():
    """SGD as an optax transformation (the step scales its updates by lr)
    whose state is the last gradient it was given: the JAX step's clipped
    gradients, read back from the new TrainState's ``opt_state``."""
    neg = lambda g: jax.tree_util.tree_map(jnp.negative, g)
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (neg(grads), grads))


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "alternating"])
def test_gan_step_matches_jax(gan_pair, joint):
    """One step of each formulation with SGD on both sides (Adam's first
    step, ≈ lr·sign(g), would amplify f32 noise) against JAX
    ``make_gan_train_step`` in the same formulation: the metrics, every G
    and D gradient after the clip (what SGD steps with), the updated
    parameters, and both networks' running statistics (D's after its three
    updates)."""
    gv, dv, x, y = gan_pair
    lr = 1e-3
    gen, disc = _port_gan(gv, dv)
    gan_step.set_joint_gan(joint)
    sgd = lambda m: torch.optim.SGD(m.parameters(), lr=lr)
    step = gan_step.make_gan_train_step(gen, disc, losses.bce_dice_loss, sgd(gen), sgd(disc), 2)
    got = step(torch.from_numpy(x), torch.from_numpy(y), lr)

    jgen = _NarrowGen()
    jdisc = jgan.Discriminator(num_classes=2, kernel_size=3, n_channels=8, n_blocks=2,
                               fc_size=1024)
    tx = _sgd_keeping_grads()
    with jax_toggles(fused_stage=False, joint_gan=joint):
        jstep = jax_make_gan_train_step(jgen, jdisc, jlosses.bce_dice_loss, tx, tx, 2)
        gs, ds, want = jstep(TrainState.create(gv, tx), TrainState.create(dv, tx),
                             (jnp.asarray(x), jnp.asarray(y)), jnp.float32(lr))
    assert got.keys() == want.keys()
    for k in got:
        atol = 1 / 2048 if k == "iou" else 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=atol,
                                   err_msg=k)
    for module, state, fc1 in ((gen, gs, None), (disc, ds, 8)):
        variables = jax.device_get(state.variables())
        back = _leaves(_back_to_jax(module.state_dict(), variables, fc1))
        grads = dict(module.state_dict(), **{n: p.grad for n, p in module.named_parameters()})
        got_g = _leaves(_back_to_jax(grads, variables, fc1)["params"])
        want_g = _leaves(jax.device_get(state.opt_state))
        scale = max(np.abs(g).max() for g in want_g.values())
        assert got_g.keys() == want_g.keys()
        for key, want_leaf in want_g.items():
            err = np.linalg.norm((got_g[key] - want_leaf).astype(np.float64))
            assert err <= GRAD_RTOL * np.linalg.norm(want_leaf) + GRAD_ATOL * scale, (
                key, err, np.linalg.norm(want_leaf))
        for key, want_leaf in _leaves(variables).items():
            if "batch_stats" in key:
                np.testing.assert_allclose(back[key], want_leaf, rtol=1e-4, atol=1e-4,
                                           err_msg=key)
            else:  # params: old − lr·g, two f32 roundings and lr times the gradient bar apart
                np.testing.assert_allclose(back[key], want_leaf, rtol=2.4e-7,
                                           atol=lr * gan_step.GRAD_CLIP * GRAD_RTOL, err_msg=key)


def _narrow_flagship_gan(seed=5):
    gen = tgan.Generator("UNet_R_SS_v2", 2, 3, device="cpu")
    gen.net = build_model("UNet_R_SS_v2", 2, 3, filters=(8, 16, 32, 48, 64, 64), seed=seed,
                          device="cpu")
    disc = tgan.Discriminator(2, 3, 8, 4, 32, generator=torch.Generator().manual_seed(seed))
    return gen, disc


def _gan_grads(gen, disc, x, y, fused):
    """One step's clipped gradients of both networks, D's and G's running
    statistics and its metrics, from copies of the networks."""
    gen, disc = copy.deepcopy(gen), copy.deepcopy(disc)
    tst.set_fused_train(None if fused else False)
    try:
        m = gan_step.gan_gradients(gen, disc, losses.bce_dice_loss, x, y, 2)
    finally:
        tst.set_fused_train(None)
    flat = lambda mod: torch.cat([p.grad.float().reshape(-1) for p in mod.parameters()])
    stats = lambda mod: torch.cat([b.float().reshape(-1) for k, b in mod.state_dict().items()
                                   if "running" in k])
    return flat(gen), flat(disc), stats(disc), stats(gen), m


def test_gan_step_with_fused_train_stages_matches_composition(monkeypatch):
    """G = a narrow flagship (filters 8-64; six fused train stages at 32²,
    eight at 64², each call counted). In f32 the step through the fused train stages (their
    plain versions on the CPU) equals the step through the module
    composition to the stage gradients' bar (max |Δ| ≤ 1e-3 · max |·|):
    G's and D's clipped gradients and both networks' running statistics
    (G's from the fused stages' sums). In bf16 (64², batch 4), both routes
    against the f32 composition: the two routes round at different places,
    and on this random narrow model each sits 0.36-0.39 from f32 in G's
    gradient and as far from the other, 2-4e-4 in D's running statistics (5
    seeds measured), 3.2-3.5e-4 in G's (2 seeds); so fused–f32 ≤ 1.25 ×
    composition–f32 and fused–composition ≤ 1.25 × composition–f32
    (relative L2) for those three, and for D's gradient, 0.16-0.35 from f32 at ±50%
    between seeds, chip_smoke.py's single-gradient bar, fused–composition ≤
    3 × composition–f32."""
    calls = {"n": 0}
    fused_stage = tssunet.fused_train_stage

    def counted(*args, **kwargs):
        calls["n"] += 1
        return fused_stage(*args, **kwargs)

    monkeypatch.setattr(tssunet, "fused_train_stage", counted)
    gen, disc = _narrow_flagship_gan()
    rng = np.random.default_rng(0)
    before = dict(tst.launches)
    for hw, batch in ((32, 2), (64, 4)):
        x = torch.from_numpy(rng.normal(size=(batch, hw, hw, 3)).astype(np.float32))
        y = torch.from_numpy((rng.random((batch, hw, hw, 2)) > 0.5).astype(np.float32))
        n0 = calls["n"]
        f32 = _gan_grads(gen, disc, x, y, False)
        assert calls["n"] == n0
        if hw == 32:
            f32_fused = _gan_grads(gen, disc, x, y, True)
            assert calls["n"] == n0 + 6
            for a, b in zip(f32_fused[:4], f32[:4]):
                assert (a - b).abs().max() <= 1e-3 * b.abs().max()
            continue
        kern = _gan_grads(gen, disc, x.bfloat16(), y, True)
        plain = _gan_grads(gen, disc, x.bfloat16(), y, False)
        assert calls["n"] == n0 + 8  # at 64² the CPU gate also takes level 3's 8×8 stages
        for i, (k, p, f) in enumerate(zip(kern[:4], plain[:4], f32[:4])):
            assert bool(torch.isfinite(k).all())
            e_k, e_p, e_kp = rel_l2(k, f), rel_l2(p, f), rel_l2(k, p)
            ok = e_kp <= 3 * e_p if i == 1 else e_k <= 1.25 * e_p and e_kp <= 1.25 * e_p
            assert ok, (i, e_k, e_p, e_kp)
    assert tst.launches == before  # CPU tensors: the kernels' plain versions


def test_joint_equals_alternating_under_another_momentum(rng, monkeypatch):
    """Hazard a: with ``ops/norm.py`` MOMENTUM patched to 0.3 the joint step
    (update 3 rebuilt from the retain factor 1 − MOMENTUM) equals the
    alternating one (three real updates): D's running statistics and both
    networks' parameters after one Adam step, to 1e-5 relative L2 per
    tensor. The JAX package's hardcoded 0.9 would rebuild update 3 away
    from the alternating statistics, which the test also shows."""
    monkeypatch.setattr(norm, "MOMENTUM", 0.3)
    gen, disc = _narrow_flagship_gan(seed=8)
    with torch.no_grad():  # running statistics away from (0, 1)
        for k, b in disc.state_dict().items():
            if "running" in k:
                b.copy_(torch.rand(b.shape) + 0.5)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 32, 32, 2)) > 0.5).astype(np.float32))
    running = [k for k in disc.state_dict() if "running" in k]

    def one_step(joint):
        g, d = copy.deepcopy(gen), copy.deepcopy(disc)
        gan_step.set_joint_gan(joint)
        step = gan_step.make_gan_train_step(g, d, losses.bce_dice_loss, adam(g.parameters()),
                                            adam(d.parameters()), 2)
        step(x, y, 1e-3)
        return g.state_dict(), d.state_dict()

    joint, alternating = one_step(True), one_step(False)
    for a, b in zip(joint, alternating):
        for k in b:
            assert rel_l2(a[k], b[k]) <= 1e-5, k
    # the JAX package's retain factor 0.9 while the BatchNorms move at 0.3:
    # the rebuilt update 3 leaves the alternating statistics
    monkeypatch.setattr(gan_step, "norm", types.SimpleNamespace(MOMENTUM=0.1,
                                                                BatchNorm=norm.BatchNorm))
    _, d_090 = one_step(True)
    assert max(rel_l2(d_090[k], alternating[1][k]) for k in running) > 1e-2


def test_spectral_discriminator_takes_the_alternating_path(rng):
    """A D that carries spectral state (an SNConv2d) runs three forwards per
    step (u and v iterate three times, as in the reference), a plain D two
    in the joint mode and three in the alternating one."""

    class SND(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = SNConv2d(2, 4, 3, padding=1)
            self.fc = tgan.Dense(4, 1)

        def forward(self, x):
            return self.fc(self.conv(x).mean((1, 2)))

    gen, disc = _narrow_flagship_gan()
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 32, 32, 2)) > 0.5).astype(np.float32))
    for d, joint, forwards in ((SND(), True, 3), (disc, True, 2), (disc, False, 3)):
        gan_step.set_joint_gan(joint)
        seen = []
        hook = d.register_forward_hook(lambda *a: seen.append(1))
        u0 = d.conv.weight_u.clone() if isinstance(d, SND) else None
        gan_step.gan_gradients(gen, d, losses.bce_dice_loss, x, y, 2)
        hook.remove()
        assert len(seen) == forwards
        assert gan_step.joint_gan_for(d) == (joint and not isinstance(d, SND))
        if u0 is not None:
            assert not torch.equal(u0, d.conv.weight_u)


def test_gan_step_refuses_a_mesh():
    """The data-parallel GAN step is ported (tests/test_torch_parallel_train.py);
    a mesh with a model axis is what it still refuses (ROADMAP.md), and a
    CUDA tensor reduced under a group that is not NCCL raises (a stand-in:
    this CPU build makes no CUDA tensor)."""
    gen, disc = _narrow_flagship_gan()
    mesh = model_axis_mesh()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gan_step.make_gan_train_step(gen, disc, losses.bce_dice_loss, adam(gen.parameters()),
                                     adam(disc.parameters()), 2, mesh=mesh)
    with mock.patch.object(collectives.dist, "get_backend", lambda group=None: "gloo"):
        with pytest.raises(ValueError, match="NCCL"):
            collectives.check_device(types.SimpleNamespace(is_cuda=True), object())


# ---- warm start, trainer, CLI ----------------------------------------------------


def test_warm_start_loads_a_supervised_checkpoint(tmp_path):
    """A port-written supervised ``model.pth`` loads into ``Generator.net``
    tensor for tensor; a tensor of another shape is reported and skipped;
    a GAN generator's own ``model.pth`` (keys under ``net.``) loads whole;
    a directory with only ``model.orbax`` raises, an empty one too, and the
    trainer's warm start without a checkpoint leaves the init."""
    sup = build_model("UNet_R_SS_v2", 2, 3, filters=(8, 16, 32, 48, 64, 64), seed=3,
                      device="cpu")
    ckpt.save_model(str(tmp_path / "sup"), sup)
    gen, _ = _narrow_flagship_gan(seed=4)
    report = ckpt.warm_start_generator(gen, str(tmp_path / "sup"))
    assert not report["missing"] and not report["unmatched"]
    for k, v in sup.state_dict().items():
        assert torch.equal(gen.state_dict()["net." + k], v), k

    state = torch.load(tmp_path / "sup" / "model.pth")
    state["final.weight"] = torch.zeros(5, 8, 1, 1)
    torch.save(state, tmp_path / "bad.pth")
    gen, _ = _narrow_flagship_gan(seed=4)
    before = gen.net.final.weight.clone()
    report = ckpt.warm_start_generator(gen, str(tmp_path / "bad.pth"))
    assert report["unmatched"] == ["final.weight"] and not report["missing"]
    assert torch.equal(gen.net.final.weight, before)
    assert torch.equal(gen.net.final.bias, sup.final.bias)

    ckpt.save_model(str(tmp_path / "gan"), gen)  # a GAN generator's own, under net.
    fresh, _ = _narrow_flagship_gan(seed=6)
    before = copy.deepcopy(fresh.state_dict())
    report = ckpt.warm_start_generator(fresh, str(tmp_path / "gan"))
    # as JAX's warm start: its keys match nothing of net, so nothing loads
    assert not report["loaded"] and len(report["unmatched"]) == len(gen.state_dict())
    assert all(torch.equal(v, before[k]) for k, v in fresh.state_dict().items())

    (tmp_path / "jax" / "model.orbax").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.warm_start_generator(gen, str(tmp_path / "jax"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.warm_start_generator(gen, str(tmp_path / "empty"))
    # the trainer's warm start: no checkpoint, the generator keeps its init
    cfg = load_experiment_config(_gan_config(tmp_path))
    assert tgan_train.warm_start(cfg, {"name": "missing"}, gen) is None


def _gan_config(tmp_path):
    raw = {
        "file_path": {"input_path": str(tmp_path / "inputs"),
                      "model_path": str(tmp_path / "models"),
                      "output_path": str(tmp_path / "outputs"),
                      "checkpoint_path": str(tmp_path / "checkpoint")},
        "opt_config": {"name": "gan", "generator_name": "sup", "resume": "False", "epochs": 2,
                       "batch_size": 4, "arch": "SSUNet", "deep_supervision": "False",
                       "input_channels": 3, "num_classes": 2, "input_h": 32, "input_w": 32,
                       "loss": "BCEDiceLoss", "optimizer": "Adam", "lr": 1e-4, "gan_lr": 2e-5,
                       "early_stopping": -1, "num_workers": 1, "mixed_precision": "False"},
        "val_config": {"name": "gan"},
    }
    path = tmp_path / "gan.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_run_gan_experiment_end_to_end(tmp_path, capsys):
    """The trainer on the CPU (SSUNet at 32², 8 synthetic scenes, batch 4,
    2 epochs, then a resume for a third): warm-started from the supervised
    model's card and ``model.pth``; ``log.csv`` with the JAX package's
    columns and one row per epoch (``lr`` holds ``config["lr"]``);
    ``model.pth`` and both state directories; the resume runs epoch 2
    only, from the saved optimizer state."""
    cfg = load_experiment_config(_gan_config(tmp_path))
    sup_cfg = dict(cfg.opt_config, name="sup")
    dump_model_card(sup_cfg, cfg.model_dir("sup"))
    sup = build_model("SSUNet", 2, 3, seed=9, device="cpu")
    ckpt.save_model(cfg.model_dir("sup"), sup)
    gen, disc, best_iou, log = tgan_train.run_gan_experiment(
        cfg, synthetic=8, use_tensorboard=False, device="cpu")
    out = capsys.readouterr().out
    assert "=> warm start from" in out and "missing []" in out
    assert log["epoch"] == [0, 1] and log["lr"] == [1e-4, 1e-4]
    mdir = cfg.model_dir()
    with open(os.path.join(mdir, "log.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "epoch,lr,loss,iou,dice,val_loss,val_iou,val_dice" and len(rows) == 3
    assert os.path.isfile(os.path.join(mdir, "model.pth")) and best_iou > 0
    saved = torch.load(os.path.join(mdir, "model.pth"))
    assert all(k.startswith("net.") for k in saved)
    for sub in ("generator_state", "discriminator_state"):
        assert ckpt.has_train_state(os.path.join(mdir, sub))
    d_state = torch.load(os.path.join(mdir, "discriminator_state", "train_state.pth"))
    assert {"model", "optimizer"} <= set(d_state) and d_state["optimizer"]["state"]
    assert all(torch.isfinite(v).all() for v in disc.state_dict().values())

    cfg.opt_config["resume"] = True
    _, _, _, log3 = tgan_train.run_gan_experiment(cfg, synthetic=8, epochs_override=3,
                                                  use_tensorboard=False, device="cpu")
    assert "resumed GAN from epoch 2" in capsys.readouterr().out
    assert log3["epoch"] == [2]
    with open(os.path.join(mdir, "generator_state", "train_meta.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_cli_parses_its_arguments():
    args = tgan_train.parse_args(["--config", "c.json"])
    assert (args.config, args.device) == ("c.json", "cuda")
    assert tgan_train.parse_args(["--config", "c.json", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        tgan_train.parse_args([])


# ---- srgan_utils -------------------------------------------------------------------


@pytest.mark.parametrize("source", ["[0, 1]", "[-1, 1]"])
def test_convert_image_matches_jax(rng, source):
    img = rng.random((2, 12, 10, 3)).astype(np.float32)
    if source == "[-1, 1]":
        img = 2 * img - 1
    for target in sorted(srgan_utils.TARGETS - {"pil"}):
        for x in (img, img[0]):
            np.testing.assert_allclose(srgan_utils.convert_image(x, source, target),
                                       jsrgan.convert_image(x, source, target), rtol=1e-6,
                                       atol=1e-6, err_msg=target)
    # "pil" is the array of the JAX package's PIL image, uint8 HWC RGB
    np.testing.assert_array_equal(srgan_utils.convert_image(img[0], source, "pil"),
                                  np.asarray(jsrgan.convert_image(img[0], source, "pil")))
    with pytest.raises(ValueError, match="target format"):
        srgan_utils.convert_image(img, source, "hsv")


def test_create_data_lists_and_adjust_learning_rate_match_jax(tmp_path):
    """The JSON lists from PNG headers against the JAX package's (PIL
    sizes), and the learning-rate shrink on both packages' schedulers."""
    sizes = {"train": [(20, 30), (8, 40), (16, 16)], "val": [(12, 20), (40, 15)]}
    for split, shapes in sizes.items():
        os.makedirs(tmp_path / split)
        for i, (h, w) in enumerate(shapes):
            write_image(str(tmp_path / split / f"{i}.png"), np.zeros((h, w, 3), np.uint8))
    folders = ([str(tmp_path / "train")], [str(tmp_path / "val")])
    srgan_utils.create_data_lists(*folders, 16, str(tmp_path / "port"))
    jsrgan.create_data_lists(*folders, 16, str(tmp_path / "jax"))
    for name in ("train_images.json", "val_test_images.json"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert json.load(f) == json.load(g)
    with open(tmp_path / "port" / "train_images.json") as f:
        assert [os.path.basename(p) for p in json.load(f)] == ["0.png", "2.png"]
    ours, theirs = ConstantLR(1e-3), JLRScheduler(1e-3)
    assert srgan_utils.adjust_learning_rate(ours, 0.5) == jsrgan.adjust_learning_rate(theirs, 0.5)
