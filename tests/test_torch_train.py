"""The port's training slice (on the CPU) against the JAX package: seam
gradients (pool, unpool, upsample), losses and metrics, LR schedules, the
synthetic data path, and one and two flagship train steps.

Inputs come from numpy with a seed and cross between the frameworks as
numpy. Tolerances: pool/unpool gradients exact (both route each window's
cotangent to the same recorded corner); upsample gradient 1e-6 (f32 sums
of two weights each); losses and metrics 1e-6 (f32 reductions in other
orders); the train steps as stated at their test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.data import dataset as jdataset
from ssunet_gan_tpu.data import loader as jloader
from ssunet_gan_tpu.data import transforms as jtransforms
from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.ops import metrics as jmetrics
from ssunet_gan_tpu.ops import resize as jresize
from ssunet_gan_tpu.ops.acts import WTensor
from ssunet_gan_tpu.ops.wminor import pool2x2, pool2x2_with_indices, to_nhwc, unpool2x2
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_eval_step as jax_make_eval_step
from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
from ssunet_gan_tpu_torch.data.loader import BatchLoader
from ssunet_gan_tpu_torch.data.transforms import train_transform, val_transform
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.ops import losses, metrics
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from ssunet_gan_tpu_torch.ops.pool import (
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
)
from ssunet_gan_tpu_torch.ops.resize import upsample_bilinear
from ssunet_gan_tpu_torch.train import optim
from ssunet_gan_tpu_torch.train.step import make_eval_step, make_train_step
from ssunet_gan_tpu_torch.train.supervised import evaluate, train_one_epoch
from torch_port_helpers import jax_toggles


@pytest.fixture(autouse=True)
def _jax_modes():
    with jax_toggles(fused_stage=False, fused_train=False):
        yield


def _tied(rng, shape):
    """Values on a coarse grid with zeros (ReLU-like), so most 2×2 windows
    hold a tie for their maximum."""
    return np.maximum(rng.integers(-1, 3, size=shape), 0).astype(np.float32)


def _wm(x):
    return WTensor(jnp.swapaxes(jnp.asarray(x), 2, 3))


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 7, 9, 2)])
def test_pool_gradients_with_ties_match_jax(rng, shape):
    """Each window's cotangent goes to its first-maximum corner alone, as
    JAX's custom VJPs (and torch's MaxPool2d) route it; odd rows and
    columns get none."""
    x = _tied(rng, shape)
    n, h, w, c = shape
    cot = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    assert (x[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)
            .max((2, 4), keepdims=True) == x[:, :h // 2 * 2, :w // 2 * 2]
            .reshape(n, h // 2, 2, w // 2, 2, c)).sum((2, 4)).max() > 1  # ties exist

    def jax_pool(v, with_idx):
        p = pool2x2_with_indices(WTensor(v))[0] if with_idx else pool2x2(WTensor(v))
        return jnp.sum(to_nhwc(p) * cot)

    xv = jnp.swapaxes(jnp.asarray(x), 2, 3)
    for with_idx, fn in ((True, lambda t: max_pool_2x2_with_indices(t)[0]),
                         (False, max_pool_2x2)):
        want = np.swapaxes(np.asarray(jax.grad(jax_pool)(xv, with_idx)), 2, 3)
        xt = torch.from_numpy(x).requires_grad_()
        (fn(xt) * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_unpool_gradient_matches_jax(rng):
    x = _tied(rng, (2, 8, 8, 3))
    vals = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    _, wcode = pool2x2_with_indices(_wm(x))
    want = jax.grad(lambda v: jnp.sum(to_nhwc(unpool2x2(v, wcode)) * cot))(jnp.asarray(vals))
    _, code = max_pool_2x2_with_indices(torch.from_numpy(x))
    vt = torch.from_numpy(vals).requires_grad_()
    (max_unpool_2x2(vt, code) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(want))


def test_upsample_gradient_matches_jax(rng):
    x = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 10, 8, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jresize.upsample_bilinear(v, 2, True) * cot))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (upsample_bilinear(xt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("poison", [None, "inf", "nan"])
def test_losses_and_metrics_match_jax(rng, poison):
    logits = (rng.normal(size=(2, 8, 8, 3)) * 3).astype(np.float32)
    target = (rng.random((2, 8, 8, 3)) > 0.6).astype(np.float32)
    if poison == "inf":  # the BCE is not finite: the loss falls back to 2·dice
        logits[0, 0, 0, 0] = -np.inf
        target[0, 0, 0, 0] = 1.0
    elif poison == "nan":
        logits[1, 2, 3, 1] = np.nan
    tl, tt = torch.from_numpy(logits), torch.from_numpy(target)
    jl, jt = jnp.asarray(logits), jnp.asarray(target)
    pairs = [
        (losses.stable_bce(tl, tt), jlosses.stable_bce(jl, jt)),
        (losses.soft_dice(tl, tt), jlosses.soft_dice(jl, jt)),
        (losses.bce_dice_loss(tl, tt), jlosses.bce_dice_loss(jl, jt)),
        (losses.get_loss("BCEWithLogitsLoss")(tl, tt), jlosses.bce_with_logits_loss(jl, jt)),
        (metrics.iou_score(metrics.foreground_slice(tl, 3), metrics.foreground_slice(tt, 3)),
         jmetrics.iou_score(jmetrics.foreground_slice(jl, 3), jmetrics.foreground_slice(jt, 3))),
        (metrics.dice_coef(tl, tt), jmetrics.dice_coef(jl, jt)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if poison == "inf":
        assert np.isfinite(losses.bce_dice_loss(tl, tt).item())
    # every name of the JAX registry (the Lovász hinge since the GAN slice);
    # other names raise as in the JAX package
    assert list(losses.LOSS_REGISTRY) == list(jlosses.LOSS_REGISTRY)
    with pytest.raises(KeyError, match="NoSuchLoss"):
        losses.get_loss("NoSuchLoss")


@pytest.mark.parametrize(
    "config",
    [
        {"optimizer": "Adam", "lr": 1e-4},
        {"optimizer": "SGD", "lr": 0.1, "scheduler": "CosineAnnealingLR", "epochs": 10,
         "min_lr": 1e-3},
        {"optimizer": "SGD", "lr": 0.1, "scheduler": "MultiStepLR",
         "milestones": "2, 4, 7", "gamma": 0.5},
        {"optimizer": "SGD", "lr": 0.1, "scheduler": "ReduceLROnPlateau", "patience": 1,
         "factor": 0.5, "min_lr": 0.02},
        {"optimizer": "SGD", "lr": 0.1, "scheduler": "ConstantLR"},
    ],
)
def test_schedulers_match_jax(config):
    got, want = optim.build_scheduler(config), joptim.build_scheduler(config)
    assert type(got).__name__ == type(want).__name__
    losses_seen = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9]
    for epoch, val in enumerate(losses_seen):
        assert got.lr(epoch) == want.lr(epoch), epoch
        got.step_plateau(val)
        want.step_plateau(val)


def test_synthetic_data_matches_jax():
    """Items bit-equal to the JAX package's; loader batches (no shuffle)
    equal; the train pipeline on the raw items with one seed on both sides
    takes the same branches (the generators stay in step) and agrees within
    tests/test_torch_cli_train.py's bar."""
    cfg = {"input_h": 32, "input_w": 32}
    ours = SyntheticDataset(5, 32, 32, 3, transform=val_transform(cfg), seed=2)
    theirs = jdataset.SyntheticDataset(5, 32, 32, 3, transform=jtransforms.val_transform(cfg),
                                       seed=2)
    for i in range(len(ours)):
        for a, b in zip(ours[i][:3], theirs[i][:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert ours[i][3] == theirs[i][3]
    got = list(BatchLoader(ours, 2, num_workers=2))
    want = list(jloader.BatchLoader(theirs, 2, num_workers=2))
    assert len(got) == len(want) == 3
    for gb, wb in zip(got, want):
        for a, b in zip(gb[:3], wb[:3]):
            np.testing.assert_array_equal(a, b)
        assert gb[3] == wb[3]
    assert len(BatchLoader(ours, 2, drop_last=True)) == 2
    from test_torch_cli_train import TRAIN_TF_BAR

    raw = SyntheticDataset(5, 32, 32, 3, seed=2)
    mine, jax_tf = train_transform(cfg), jtransforms.train_transform(cfg)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(raw)):
        img, mask = raw[i][0], raw[i][2].astype(np.uint8)
        a, b = mine(image=img, mask=mask, rng=r1), jax_tf(image=img, mask=mask, rng=r2)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert np.abs(a["image"] - b["image"]).max() <= TRAIN_TF_BAR
        assert (a["mask"] != b["mask"]).mean() <= 1e-3


FILTERS = (8, 16, 32, 48, 64, 64)  # conv5_0 has no shortcut: a plain train stage


@pytest.fixture(scope="module")
def train_pair():
    """A narrow flagship's JAX variables at init and the batch of both runs."""
    with jax_toggles(fused_stage=False, fused_train=False):
        model = JUNetRSSv2(num_classes=3, input_channels=3, filters=FILTERS)
        g = np.random.default_rng(5)
        x = g.normal(size=(2, 32, 32, 3)).astype(np.float32)
        y = (g.random((2, 32, 32, 3)) > 0.5).astype(np.float32)
        variables = jax.device_get(jit_init(model, jax.random.PRNGKey(0), jnp.asarray(x),
                                            train=True))
    return model, variables, x, y


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize(
    "config",
    [
        {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-7},
        {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4},
    ],
    ids=["adam", "sgd"],
)
def test_train_steps_match_jax(train_pair, config):
    """Two steps of the port's make_train_step (fused train stages on their
    plain versions, f32) against JAX make_train_step on the module
    composition. Loss, Dice and the BN running statistics agree to 1e-4
    (f32 sums in other orders through eleven stages). IoU counts
    thresholded elements, so a logit within f32 noise of 0 may fall either
    side: it agrees to one element of its union (≥ the ~2048 positive
    targets of the 4096), 1/2048. Parameters: under SGD to rtol 1e-3 with
    atol 1e-3·lr, the update an error of 1e-3 in a gradient of unit scale
    makes (a BN bias starts at 0, and its gradient, a sum that cancels,
    agrees only to that); under Adam to 2·lr, since Adam's first
    step is ≈ lr·sign(g) and a gradient near 0 may take either sign in two
    correct runs — which also moves the second step's batch statistics by
    up to that much."""
    model, variables, x, y = train_pair
    lr = config["lr"]
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    opt = optim.build_optimizer(port.parameters(), config)
    step = make_train_step(port, losses.bce_dice_loss, opt, 3, clip=0.7)

    tx = joptim.build_optimizer(config)
    state = TrainState.create(variables, tx)
    jstep = jax_make_train_step(model, jlosses.bce_dice_loss, tx, 3, clip=0.7)
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    before = dict(tst.launches)
    adam = config["optimizer"] == "Adam"
    for i in range(2):
        got = step(torch.from_numpy(x), torch.from_numpy(y), lr)
        state, want = jstep(state, (jnp.asarray(x), jnp.asarray(y)), jnp.float32(lr))
        for k, atol in (("loss", 1e-4), ("iou", 1 / 2048), ("dice", 1e-4)):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=atol, err_msg=k)
        back, report = convert_torch_state_dict(port.state_dict(), template)
        assert report["unmatched"] == [] and report["skipped"] == []
        ours, theirs = _leaves(back), _leaves(jax.device_get(state.variables()))
        assert ours.keys() == theirs.keys()
        for path, want_leaf in theirs.items():
            a, b = np.asarray(ours[path]), np.asarray(want_leaf)
            name = f"step {i + 1} {jax.tree_util.keystr(path)}"
            if "batch_stats" in str(path[0]):
                tol = 2 * lr if adam and i == 1 else 1e-4
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=tol, err_msg=name)
            elif adam:
                np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * lr, err_msg=name)
    assert tst.launches == before  # CPU tensors: the plain versions ran


def test_train_step_refuses_what_is_not_ported():
    port = build_model("UNet_R_SS_v2", 3, filters=(8, 8, 8, 8, 8, 8), device="cpu")
    opt = optim.build_optimizer(port.parameters(), {"optimizer": "Adam", "lr": 1e-3})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(port, losses.bce_dice_loss, opt, 3, mesh=object())


def test_eval_step_matches_jax(train_pair):
    """Eval mode (running BN statistics): loss and Dice to 1e-4, IoU to one
    element of its union, as the train steps."""
    model, variables, x, y = train_pair
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    got = make_eval_step(port, losses.bce_dice_loss, 3)(torch.from_numpy(x),
                                                        torch.from_numpy(y))
    state = TrainState.create(variables, joptim.build_optimizer({"optimizer": "Adam"}))
    want = jax_make_eval_step(model, jlosses.bce_dice_loss, 3)(
        state, (jnp.asarray(x), jnp.asarray(y)))
    for k, atol in (("loss", 1e-4), ("iou", 1 / 2048), ("dice", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=atol, err_msg=k)
    assert not port.training


def test_epoch_loop_means_its_steps():
    """train_one_epoch and evaluate report the means of the steps they ran
    (the same f32 computation on the CPU, so equal to 1e-6)."""
    cfg = {"input_h": 32, "input_w": 32, "mixed_precision": False}
    data = BatchLoader(SyntheticDataset(4, 32, 32, 3, transform=val_transform(cfg), seed=1),
                       2, num_workers=2)
    models = [build_model("UNet_R_SS_v2", 3, filters=(8, 8, 8, 8, 8, 8), seed=4,
                          device="cpu") for _ in range(2)]
    steps = [make_train_step(m, losses.bce_dice_loss,
                             optim.build_optimizer(m.parameters(), {"optimizer": "SGD",
                                                                    "lr": 0.1}), 3)
             for m in models]
    log = train_one_epoch(0, cfg, data, steps[0], 0.1, device="cpu")
    by_hand = [steps[1](torch.from_numpy(b[1]), torch.from_numpy(b[2]), 0.1) for b in data]
    for k in ("loss", "iou", "dice"):
        np.testing.assert_allclose(log[k], np.mean([m[k].item() for m in by_hand]),
                                   rtol=1e-6, atol=1e-6)
    assert log["images_per_sec"] > 0
    eval_step = make_eval_step(models[0], losses.bce_dice_loss, 3)
    got = evaluate(cfg, data, eval_step, device="cpu")
    want = [eval_step(torch.from_numpy(b[1]), torch.from_numpy(b[2])) for b in data]
    for k in ("loss", "iou", "dice"):
        np.testing.assert_allclose(got[k], np.mean([m[k].item() for m in want]),
                                   rtol=1e-6, atol=1e-6)
