"""The port's EfficientNet family (``models/efficientnet.py``: the spec,
SamePadConv, MBConvBlock, EfficientNet; AttentiveCNN and ``effnet_unet``
are held in ``test_torch_effnet_unet.py``) and the encoder's second
optimizer
(``train/optim.py``, ``train/step.py``, ``train/supervised.py``,
``train/checkpoint.py``) against the JAX package on the CPU in f32.

Modules get their state from seeded numpy and carry it to the JAX
package through its ``convert_torch_state_dict`` (every leaf written,
nothing unmatched or skipped) and back through ``from_jax_variables``.
Bars, relative L2: the EfficientNet encoders' eval forwards ≤ 1e-4 (their
depth adds rounding), the gradients of one loss at the running statistics
≤ 1e-4 (all as one vector, and each alone or within 1e-4 of all
gradients' norm), the train-mode forward, running statistics (momentum
0.01) and loss ≤ 1e-4; an MBConv block's train-mode gradients ≤ 1e-4
each (or within 1e-6 of all its gradients' norm). The encoders' whole
train-mode gradients are chaotic in f32 (see
``test_torch_unet_families.py``) and are held through their blocks. The
dual-optimizer steps: parameters within 1e-4 of the JAX step's, the frozen
encoder bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from ssunet_gan_tpu.models import efficientnet as jeff
from ssunet_gan_tpu.ops.conv import Conv2d as JConv2d
from ssunet_gan_tpu.ops.losses import bce_dice_loss
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_train_step as jax_make_train_step
from ssunet_gan_tpu_torch import config as pconfig
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model
from ssunet_gan_tpu_torch.models import efficientnet as teff
from ssunet_gan_tpu_torch.ops.conv import Conv2d
from ssunet_gan_tpu_torch.ops.losses import get_loss
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.train import checkpoint as ckpt
from ssunet_gan_tpu_torch.train import optim, supervised
from ssunet_gan_tpu_torch.train import step as step_mod
from ssunet_gan_tpu_torch.train.step import make_train_step
from torch_family_helpers import (
    TRAIN_TOL,
    assert_round_trip,
    check_eval,
    check_train,
    rel_l2,
    seed_state,
    to_jax,
)
from torch_port_helpers import jax_toggles

ENCODER_TOL = 1e-4
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "config_v1.json")


@pytest.fixture(autouse=True)
def _modes():
    with jax_toggles(fused_stage=False):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_spec_matches_jax():
    """Block strings, width and depth rounding and every variant's
    expanded blocks and head width equal the JAX package's."""
    for s in jeff.BLOCK_STRINGS + ["r2_k5_s22_e6_i24_o40_noskip"]:
        assert dataclasses.asdict(teff.decode_block_string(s)) == \
            dataclasses.asdict(jeff.decode_block_string(s))
    assert teff.SCALING_PARAMS == jeff.SCALING_PARAMS and teff.F_CHANNELS == jeff.F_CHANNELS
    for name in teff.SCALING_PARAMS:
        blocks, drop, head = teff.scaled_block_args(name)
        jblocks, jdrop, jhead = jeff.scaled_block_args(name)
        assert [dataclasses.asdict(b) for b in blocks] == \
            [dataclasses.asdict(b) for b in jblocks] and (drop, head) == (jdrop, jhead)
    for size in range(1, 40):
        for k, s in ((1, 1), (3, 1), (3, 2), (5, 2), (5, 1)):
            assert teff._same_pad(size, k, s) == jeff._same_pad(size, k, s)


class _JAXConv(nn.Module):
    k: int
    stride: int
    groups: int

    @nn.compact
    def __call__(self, x, train=True):
        return jeff.SamePadConv(8, self.k, self.stride, self.groups, name="conv")(x)


class _Conv(torch.nn.Module):
    def __init__(self, k, stride, groups):
        super().__init__()
        self.conv = teff.SamePadConv(8, 8, k, stride, groups)

    def forward(self, x):
        return self.conv(x)


@pytest.mark.parametrize("hw,k,stride,groups", [((65, 63), 3, 2, 1), ((65, 63), 5, 2, 8),
                                                ((9, 10), 3, 1, 8), ((8, 8), 1, 1, 1)])
def test_same_pad_conv_matches_jax(hw, k, stride, groups):
    """TF "same" padding, asymmetric at odd sizes, with groups (depthwise
    at 8 of 8): forward ≤ 1e-5 and gradients ≤ 1e-4."""
    x = _x((2, *hw, 8))
    port, jm = _Conv(k, stride, groups), _JAXConv(k, stride, groups)
    seed_state(port, 1)
    variables = to_jax(port, jm, jnp.asarray(x))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, [x], 1e-5, 2)


class _JAXBlock(nn.Module):
    args: jeff.BlockArgs

    @nn.compact
    def __call__(self, x, train=True):
        return jeff.MBConvBlock(self.args, name="block")(x, train)


class _Block(torch.nn.Module):
    def __init__(self, args):
        super().__init__()
        self.block = teff.MBConvBlock(args)

    def forward(self, x):
        return self.block(x)


BLOCK_CASES = {
    "expand1_se": "r1_k3_s11_e1_i16_o16_se0.25",  # the first stage's: no expand, id skip
    "expand6_stride2": "r1_k5_s22_e6_i16_o24_se0.25",
    "expand6_skip": "r1_k3_s11_e6_i24_o24_se0.25",
    "noskip_no_se": "r1_k3_s11_e6_i24_o24_noskip",
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_mbconv_block_matches_jax(case):
    """MBConvBlock (expand, depthwise with SE, projection, id skip) at
    17×16: eval forward and gradients, train-mode forward, running
    statistics (momentum 0.01, eps 1e-3) and gradients."""
    args = teff.decode_block_string(BLOCK_CASES[case])
    x = _x((2, 17, 16, args.input_filters), 3)
    port = _Block(args)
    jm = _JAXBlock(jeff.BlockArgs(**dataclasses.asdict(args)))
    assert port.block._bn1.momentum == 0.01 and port.block._bn1.eps == 1e-3
    seed_state(port, 4)
    variables = to_jax(port, jm, jnp.asarray(x))
    assert_round_trip(port, variables)
    check_eval(port, jm, variables, [x], 1e-5, 5)
    check_train(port, jm, variables, [x], TRAIN_TOL, 5)


def test_drop_connect_needs_a_generator():
    """Drop-connect runs only in training with an explicit generator, as
    the JAX package's only with a ``dropout`` rng: without one the train
    forward is the plain one; with one, some samples lose the block's
    branch."""
    args = teff.decode_block_string(BLOCK_CASES["expand6_skip"])
    block = teff.MBConvBlock(args).train()
    x = torch.from_numpy(_x((16, 5, 5, 24), 6))
    with torch.no_grad():
        plain = block(x, 0.5)
        again = block(x, 0.5, None)
        dropped = block(x, 0.5, torch.Generator().manual_seed(0))
        block.eval()
        frozen = block(x, 0.5, torch.Generator().manual_seed(0))
        block.train()
    assert torch.equal(plain, again)
    kept = [bool(torch.allclose(dropped[i], x[i] + (plain[i] - x[i]) * 2, atol=1e-5))
            for i in range(16)]
    lost = [bool(torch.equal(dropped[i], x[i])) for i in range(16)]
    assert all(k or d for k, d in zip(kept, lost)) and any(kept) and any(lost)
    assert not torch.equal(frozen, dropped)


@pytest.mark.parametrize("hw", [(64, 64), (65, 63)], ids=["64", "65x63"])
def test_efficientnet_b0_matches_jax(hw):
    """EfficientNet b0 with ``features_only`` (the encoder endpoint): eval
    forward at 64² and 65×63 (odd sizes: asymmetric "same" pads), and at
    64² its eval gradients and its train-mode forward, running statistics
    and loss."""
    x = _x((2, *hw, 3), 7)
    port = teff.EfficientNet("efficientnet-b0", features_only=True)
    jm = jeff.EfficientNet("efficientnet-b0", features_only=True)
    assert "_blocks.15._depthwise_conv.weight" in port.state_dict()
    assert not any(k.startswith("_fc") for k in port.state_dict())
    seed_state(port, 8)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    if hw != (64, 64):
        port.eval()
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(variables,
                                                                        jnp.asarray(x)))
        assert got.shape == want.shape == (2, 3, 2, 1280)
        assert rel_l2(got, want) <= ENCODER_TOL
        return
    check_eval(port, jm, variables, [x], ENCODER_TOL, 9)
    check_train(port, jm, variables, [x], TRAIN_TOL, 9, grads=False)


def test_efficientnet_classifier_head_matches_jax():
    """Without ``features_only``: the mean over H and W and the ``_fc``
    head (b0, 10 classes), eval forward."""
    x = _x((2, 32, 32, 3), 10)
    port = teff.EfficientNet("efficientnet-b0", num_classes=10)
    jm = jeff.EfficientNet("efficientnet-b0", num_classes=10)
    assert {"_fc.weight", "_fc.bias"} <= set(port.state_dict())
    seed_state(port, 11)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x)))
    assert got.shape == (2, 10) and rel_l2(got, want) <= ENCODER_TOL


# ---- the encoder's second optimizer -------------------------------------------


class FakeEff(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return JConv2d(8, 1, name="stem")(x)


class FakeEncoder(nn.Module):
    def setup(self):
        self.eff_conv = FakeEff()
        self.conv_a = JConv2d(8, 1)

    def __call__(self, x, train=True):
        return self.conv_a(self.eff_conv(x, train))


class FakeEffNet(nn.Module):
    """The JAX package's dual-optimizer test model (tests/test_effnet_trainer.py)."""

    num_classes: int = 2

    def setup(self):
        self.encoder = FakeEncoder()
        self.head = JConv2d(self.num_classes, 1, name="head")

    def __call__(self, x, train=True):
        return self.head(self.encoder(x, train))


class _PortEff(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Conv2d(3, 8, 1)


class _PortEncoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.eff_conv = _PortEff()
        self.conv_a = Conv2d(8, 8, 1)


class PortFakeEffNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _PortEncoder()
        self.head = Conv2d(8, 2, 1)

    def forward(self, x):
        return self.head(self.encoder.conv_a(self.encoder.eff_conv.stem(x)))


def test_encoder_param_labels():
    """``encoder.eff_conv`` is "cnn"; ``encoder.conv_a`` and the rest
    "main", as the JAX labels of the same model; effnet_unet splits the
    same way."""
    labels = optim.encoder_param_labels(PortFakeEffNet())
    assert labels == {"encoder.eff_conv.stem.weight": "cnn",
                      "encoder.eff_conv.stem.bias": "cnn",
                      "encoder.conv_a.weight": "main", "encoder.conv_a.bias": "main",
                      "head.weight": "main", "head.bias": "main"}
    model = build_model("effnet_unet", 3, device="cpu")
    main, cnn = optim.split_encoder_params(model)
    names = {id(p): n for n, p in model.named_parameters()}
    assert cnn and all(names[id(p)].startswith("encoder.eff_conv.") for p in cnn)
    assert "encoder.conv_a.weight" in {names[id(p)] for p in main}
    assert len(main) + len(cnn) == len(list(model.parameters()))


def test_dual_lr_freezes_then_trains_encoder():
    """lr_cnn = 0 leaves ``encoder.eff_conv`` bit-unchanged while the head
    moves; lr_cnn = 1e-3 moves it; both steps equal JAX's
    ``make_train_step(..., param_labels=...)`` over the same optax
    ``multi_transform`` (Adam, weight decay 1e-4 on both) within 1e-4
    relative L2 per parameter, the encoder's Adam state advanced through
    the frozen step as optax's."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    mask = (rng.random((2, 8, 8, 2)) > 0.5).astype(np.float32)
    cfg = {"optimizer": "Adam", "lr": 1e-2, "weight_decay": 1e-4}

    jm = FakeEffNet()
    port = PortFakeEffNet()
    seed_state(port, 1)
    variables = to_jax(port, jm, jnp.asarray(img[:1]))
    labels = joptim.encoder_param_labels(variables["params"])
    tx = optax.multi_transform({"main": joptim.build_optimizer(cfg),
                                "cnn": joptim.build_cnn_optimizer(cfg)}, labels)
    state = TrainState.create(variables, tx)
    jstep = jax_make_train_step(jm, bce_dice_loss, tx, num_classes=2, param_labels=labels)

    main, cnn = optim.split_encoder_params(port)
    opt, cnn_opt = optim.build_optimizer(main, cfg), optim.build_cnn_optimizer(cnn, cfg)
    step = make_train_step(port, get_loss("BCEDiceLoss"), opt, 2, cnn_optimizer=cnn_opt)
    x, y = torch.from_numpy(img), torch.from_numpy(mask)
    enc0 = port.encoder.eff_conv.stem.weight.detach().clone()
    head0 = port.head.weight.detach().clone()

    for lr_cnn in (0.0, 1e-3):
        state, _ = jstep(state, (jnp.asarray(img), jnp.asarray(mask)), jnp.float32(1e-2),
                         jnp.float32(lr_cnn))
        step(x, y, 1e-2, lr_cnn)
        want = from_jax_variables({"params": jax.device_get(state.params)}, target=port)
        for n, p in port.named_parameters():
            assert rel_l2(p.detach().numpy(), want[n].numpy()) <= 1e-4, (lr_cnn, n)
        if lr_cnn == 0.0:
            assert torch.equal(port.encoder.eff_conv.stem.weight, enc0)
            assert torch.equal(port.encoder.eff_conv.stem.bias.detach(),
                               want["encoder.eff_conv.stem.bias"])
            assert not torch.allclose(port.head.weight, head0)
            assert int(cnn_opt.state[cnn[0]]["step"]) == 1
    assert not torch.allclose(port.encoder.eff_conv.stem.weight, enc0)


def _experiment(root, **opt):
    import json

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["file_path"] = {k: os.path.join(root, d) for k, d in (
        ("input_path", "inputs"), ("model_path", "models"), ("output_path", "outputs"),
        ("checkpoint_path", "checkpoint"))}
    raw["opt_config"].update(opt)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return pconfig.load_experiment_config(path)


class _TinyEncoder(torch.nn.Module):
    def __init__(self, in_ch, generator):
        super().__init__()
        self.eff_conv = torch.nn.Sequential(Conv2d(in_ch, 8, 3, 1, generator=generator),
                                            BatchNorm(8, eps=1e-3, momentum=0.01))
        self.conv_a = Conv2d(8, 8, 1, bias=False, generator=generator)

    def forward(self, x):
        return self.conv_a(self.eff_conv(x))


class TinyEffNet(torch.nn.Module):
    """effnet_unet's layout in small (``encoder.eff_conv``, ``encoder.conv_a``,
    a head), for the trainer's wiring: EfficientNet-b2's ~1000 small ops per
    step slow to minutes on the CPU under the suite's six workers, so
    ``effnet_unet`` itself goes through ``run_experiment`` on the card
    (``chip_smoke.py`` phase 18)."""

    def __init__(self, num_classes, input_channels=3, deep_supervision=False, generator=None):
        super().__init__()
        self.encoder = _TinyEncoder(input_channels, generator)
        self.final = Conv2d(8, num_classes, 1, generator=generator)

    def forward(self, x):
        return self.final(torch.relu(self.encoder(x)))


def test_run_experiment_trains_effnet_unet_with_two_optimizers(tmp_path, monkeypatch):
    """``run_experiment`` on an arch whose name holds ``effnet`` (32²,
    synthetic): two Adams over disjoint parameters, ``lr_cnn`` 0 in epochs
    0 and 1 (``encoder.eff_conv`` bit-unchanged, its Adam state advancing)
    and 1e-3 in epoch 2 (it moves); the resume state carries both
    optimizers, and a resumed run restores them exactly."""
    from ssunet_gan_tpu_torch import models

    monkeypatch.setitem(models.ARCH_REGISTRY, "effnet_tiny", TinyEffNet)
    cfg = _experiment(str(tmp_path), arch="effnet_tiny", input_h=32, input_w=32,
                      batch_size=2, num_workers=1, mixed_precision="False", epochs=2,
                      name="tiny_effnet", clip=0)
    seen = {}

    real = step_mod.make_train_step

    def spy(model, loss_fn, optimizer, *a, **kw):
        seen.update(model=model, optimizer=optimizer, cnn=kw.get("cnn_optimizer"), rates=[],
                    init={n: p.detach().clone() for n, p in model.named_parameters()})
        inner = real(model, loss_fn, optimizer, *a, **kw)

        def step(x, y, *rates):
            seen["rates"].append(rates)
            return inner(x, y, *rates)
        return step

    monkeypatch.setattr(step_mod, "make_train_step", spy)  # run_experiment imports it
    model, _, log = supervised.run_experiment(cfg, synthetic=2, use_tensorboard=False,
                                              device="cpu")
    assert log["epoch"] == [0, 1] and seen["model"] is model
    assert {r[1] for r in seen["rates"]} == {0.0} and len(seen["rates"]) == 2
    for n, p in model.named_parameters():
        if n.startswith("encoder.eff_conv."):
            assert torch.equal(p.detach(), seen["init"][n]), n
    cnn = seen["cnn"]
    assert cnn is not None and {int(s["step"]) for s in cnn.state.values()} == {2}
    assert {id(p) for g in cnn.param_groups for p in g["params"]} == {
        id(p) for n, p in model.named_parameters() if n.startswith("encoder.eff_conv.")}
    saved = torch.load(os.path.join(cfg.model_dir(), ckpt.STATE_FILE), weights_only=True)
    assert set(saved) == {"model", "optimizer", "cnn_optimizer"}
    cnn_saved = {k: v.clone() for k, v in saved["cnn_optimizer"]["state"][0].items()}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("encoder.eff_conv.")}

    cfg.opt_config["resume"] = True
    restored = {}
    restore = ckpt.restore_train_state

    def watch(model_dir, m, opt, **kw):
        meta = restore(model_dir, m, opt, **kw)
        restored.update({k: v.clone() for k, v in kw["cnn_optimizer"].state[
            kw["cnn_optimizer"].param_groups[0]["params"][0]].items()})
        return meta

    monkeypatch.setattr(ckpt, "restore_train_state", watch)
    model2, _, log2 = supervised.run_experiment(cfg, synthetic=2, epochs_override=3,
                                                use_tensorboard=False, device="cpu")
    assert log2["epoch"] == [2] and seen["rates"] == [(1e-4, 1e-3)]
    for k, v in cnn_saved.items():
        assert torch.equal(restored[k], v), k
    moved = [n for n, p in model2.named_parameters()
             if n in frozen and not torch.equal(p.detach(), frozen[n])]
    assert moved


def test_run_experiment_trains_effnet_unet(tmp_path):
    """``effnet_unet`` itself through ``run_experiment`` for one epoch (32²,
    synthetic, one intra-op thread: its ~1000 small ops per step spin
    against the suite's other workers otherwise): finite log, both
    optimizers in the resume state, ``encoder.eff_conv`` unchanged at
    lr_cnn 0 while the decoder moved."""
    cfg = _experiment(str(tmp_path), arch="effnet_unet", input_h=32, input_w=32,
                      batch_size=2, num_workers=1, mixed_precision="False", epochs=1,
                      name="effnet", clip=0)
    start = build_model("effnet_unet", 3, 3, seed=41, device="cpu")  # seed_everything()'s
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, _, log = supervised.run_experiment(cfg, synthetic=2, use_tensorboard=False,
                                                  device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert log["epoch"] == [0] and all(np.isfinite(v[0]) for k, v in log.items()
                                       if k != "epoch")
    saved = torch.load(os.path.join(cfg.model_dir(), ckpt.STATE_FILE), weights_only=True)
    assert set(saved) == {"model", "optimizer", "cnn_optimizer"}
    before = dict(start.named_parameters())
    for n, p in model.named_parameters():
        if n.startswith("encoder.eff_conv."):
            assert torch.equal(p.detach(), before[n].detach()), n
    assert not torch.equal(model.dec_conv0.weight.detach(), before["dec_conv0.weight"].detach())
