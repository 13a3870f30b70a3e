"""The one gate of the port's BasicBlock stage kernels
(``ops/stage_kernel.py`` ``stage_supported``) and the dispatch around it, on
the CPU: the gate's table on the card's terms and on the CPU's (the JAX
gate's), the model's dispatch sending what the gate refuses to the module
composition (eval, train) or to the deep s8 block (int8, as JAX's
``models/ssunet.py:297-315``), the ``set_fused_stage`` / ``set_fused_train``
toggles, and ``evaluate`` in the loader's dtype against the JAX package's.
The port's global modes are cleared after every test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssunet_gan_tpu.models.ssunet import UNetRSSv2 as JUNetRSSv2
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.parallel import make_mesh
from ssunet_gan_tpu.train import optim as joptim
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu.train.step import make_eval_step as jax_make_eval_step
from ssunet_gan_tpu.train.supervised import evaluate as jax_evaluate
from ssunet_gan_tpu.utils import jit_init
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model, ssunet
from ssunet_gan_tpu_torch.ops import (
    losses,
    pool,
    resize,
    spade_kernel,
    stage_kernel,
    stage_kernel_bneck,
)
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
from ssunet_gan_tpu_torch.ops.spade import SPADE
from ssunet_gan_tpu_torch.train.step import make_eval_step
from ssunet_gan_tpu_torch.train.supervised import evaluate
from torch_port_helpers import jax_toggles


@pytest.fixture(autouse=True)
def port_modes():
    """Every global mode of the port at its default after the test."""
    yield
    stage_kernel.set_fused_stage(None)
    tst.set_fused_train(None)
    tst.set_train_bwd_v3(True)
    q8.set_int8_stage(False)
    q8.set_int8_calibration(None)
    q8.set_record_sink(None)
    spade_kernel.set_fused_spade(None)
    resize.set_lazy_upsample(None)
    pool.set_lazy_pool(None)


class OnCard:
    """What the gate reads of a tensor on the card (this machine has none):
    shape, dtype, device and contiguity."""

    def __init__(self, shape, dtype=torch.bfloat16, contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


# (parts, planes, labels, hidden, classes, what the gate says in eval, train, int8)
CARD_CASES = [
    ([OnCard((2, 16, 16, 64))], 128, 3, 8, 0, (True, True, True)),
    ([OnCard((2, 16, 16, 64)), OnCard((2, 16, 16, 64))], 64, 3, 4, 3, (True, True, True)),
    ([OnCard((2, 16, 16, 64), torch.float32)], 128, 3, 8, 0, (False,) * 3),   # f32
    ([OnCard((2, 16, 16, 64))], 48, 3, 3, 0, (False,) * 3),                   # planes % 32
    ([OnCard((2, 16, 16, 64))], 288, 3, 16, 0, (False,) * 3),                 # planes > 256
    ([OnCard((2, 16, 16, 64))], 128, 9, 8, 0, (False,) * 3),                  # labels > 8
    ([OnCard((2, 16, 16, 64))], 128, 3, 64, 0, (True, True, True)),          # hidden 64 (SSUNet)
    ([OnCard((2, 16, 16, 64))], 128, 3, 65, 0, (False,) * 3),                 # hidden > 64
    ([OnCard((2, 16, 16, 64))], 128, 3, 8, 9, (False,) * 3),                  # classes > 8
    ([OnCard((2, 16, 16, 8))] * 3, 64, 3, 4, 0, (False,) * 3),                # three parts
    ([OnCard((2, 16, 16, 8)), OnCard((2, 8, 16, 8))], 64, 3, 4, 0, (False,) * 3),  # N, H, W
    ([OnCard((2, 16, 16, 64), contiguous=False)], 128, 3, 8, 0, (False,) * 3),
    ([OnCard((2, 16, 16, 8)), OnCard((2, 16, 16, 8), torch.float16)], 64, 3, 4, 0,
     (False,) * 3),                                                             # dtypes
    ([OnCard((1, 5, 3, 64))], 64, 3, 4, 0, (True, True, True)),  # no H/W terms on the card
]


@pytest.mark.parametrize("parts,planes,lab,nh,ncls,want", CARD_CASES,
                         ids=[str(i) for i in range(len(CARD_CASES))])
def test_gate_on_the_card_is_the_kernels_limits(parts, planes, lab, nh, ncls, want):
    got = tuple(stage_kernel.stage_supported(parts, planes, lab, nh, ncls, train=train,
                                             int8=int8)
                for train, int8 in ((False, False), (True, False), (False, True)))
    assert got == want


class OnCard4D(OnCard):
    """An OnCard tensor the kernel 8 and 9 gates can ask for its rank."""

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("nh,want", [(4, True), (32, True), (64, True), (65, False)])
def test_tail_gates_on_the_card_read_the_tail_limit(nh, want):
    """Every gate of a kernel that ends in the SPADE tail takes hidden
    widths up to the tail's TAIL_MAX_HIDDEN on the card."""
    x = OnCard4D((2, 16, 16, 64))
    assert stage_kernel.TAIL_MAX_HIDDEN == 64
    assert stage_kernel.stage_supported([x], 64, 3, nh) == want
    assert stage_kernel_bneck.bneck_supported((x,), 64, 3, nh) == want
    assert spade_kernel.fused_spade_supported(x, 3, 3, nh) == want


# (part shapes, dtype, planes, labels, hidden, classes, eval, train)
CPU_CASES = [
    ([(2, 16, 16, 8)], torch.float32, 32, 3, 4, 0, True, True),
    ([(2, 16, 16, 8)], torch.bfloat16, 48, 20, 40, 12, True, True),  # no kernel limits
    ([(2, 12, 16, 8)], torch.float32, 32, 3, 4, 0, False, False),    # H % 8
    ([(2, 16, 4, 8)], torch.float32, 32, 3, 4, 0, False, False),     # W < 8, no packing
    ([(32, 8, 4, 8)], torch.float32, 32, 3, 4, 0, True, False),      # eval packs 32 images
    ([(2, 16, 16, 8)], torch.float32, 320, 3, 4, 0, False, False),   # planes > 256
    ([(2, 16, 16, 8)] * 3, torch.float32, 32, 3, 4, 0, False, False),
]


@pytest.mark.parametrize("shapes,dtype,planes,lab,nh,ncls,want_eval,want_train", CPU_CASES,
                         ids=[str(i) for i in range(len(CPU_CASES))])
def test_gate_on_the_cpu_is_the_jax_gate(shapes, dtype, planes, lab, nh, ncls, want_eval,
                                         want_train):
    parts = [torch.zeros(s, dtype=dtype) for s in shapes]
    assert stage_kernel.stage_supported(parts, planes, lab, nh, ncls) == want_eval
    assert stage_kernel.stage_supported(parts, planes, lab, nh, ncls, int8=True) == want_eval
    assert stage_kernel.stage_supported(parts, planes, lab, nh, ncls, train=True) == want_train


def _routes(monkeypatch):
    """Count the stage routes the model's dispatch takes."""
    seen = []
    for name in ("_composition", "fused_eval_stage", "fused_train_stage",
                 "fused_eval_stage_int8", "int8_block"):
        fn = getattr(ssunet, name)

        def counted(*a, _fn=fn, _name=name, **k):
            seen.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(ssunet, name, counted)
    return seen


def _stage(side):
    g = torch.Generator().manual_seed(3)
    block = BasicBlock(16, 32, generator=g)
    spade = SPADE("spadebatch3x3", 32, 3, 2.0, generator=g)
    x = torch.randn((2, side, side, 16), generator=g)
    return block, spade, x


@pytest.mark.parametrize("mode", ["eval", "train", "int8"])
@pytest.mark.parametrize("side,admitted", [(16, True), (12, False)])
def test_dispatch_runs_what_the_gate_refuses_off_the_kernel(monkeypatch, mode, side, admitted):
    """An admitted stage takes its kernel's wrapper; a refused one (H not a
    multiple of 8, which the JAX gate refuses on the CPU) the module
    composition, or in the int8 mode the deep s8 block, as in JAX."""
    block, spade, x = _stage(side)
    block.train(mode == "train")
    q8.set_int8_stage(mode == "int8")
    seen = _routes(monkeypatch)
    with torch.no_grad():
        out = ssunet.spade_stage((x,), block, spade, name="conv0_0")
    route = {"eval": ("fused_eval_stage", "_composition"),
             "train": ("fused_train_stage", "_composition"),
             "int8": ("fused_eval_stage_int8", "int8_block")}[mode][0 if admitted else 1]
    assert seen == [route]
    assert out.shape == (2, side, side, 32) and torch.isfinite(out).all()


@pytest.mark.parametrize("mode", ["eval", "train", "int8"])
def test_toggles_send_admitted_stages_off_the_kernel(monkeypatch, mode):
    """``set_fused_stage(False)`` (eval and int8) and ``set_fused_train(False)``
    (train): the routes JAX takes with its toggles off."""
    block, spade, x = _stage(16)
    block.train(mode == "train")
    q8.set_int8_stage(mode == "int8")
    stage_kernel.set_fused_stage(False)
    tst.set_fused_train(False)
    seen = _routes(monkeypatch)
    with torch.no_grad():
        ssunet.spade_stage((x,), block, spade, name="conv0_0")
    assert seen == ["int8_block" if mode == "int8" else "_composition"]
    # the toggles are per path: the other path's stays on
    seen.clear()
    if mode == "train":
        stage_kernel.set_fused_stage(None)
        block.eval()
        want = "fused_eval_stage"
    else:
        tst.set_fused_train(None)
        q8.set_int8_stage(False)
        block.train()
        want = "fused_train_stage"
    with torch.no_grad():
        ssunet.spade_stage((x,), block, spade, name="conv0_0")
    assert seen == [want]


def test_port_modes_start_at_their_defaults():
    assert stage_kernel.fused_stage_enabled() and tst.fused_train_enabled()
    assert tst._TRAIN_BWD_V3 and not q8.int8_stage_enabled()
    assert q8.int8_calibration() is None and q8.record_sink() is None
    # the seams read in the stage kernels: on by default, as in JAX
    assert resize._LAZY_UPSAMPLE is None and resize.lazy_upsample_enabled()
    assert pool._LAZY_POOL is None and pool.lazy_pool_enabled()


FILTERS = (8, 16, 32, 48, 64, 64)


@pytest.fixture(scope="module")
def narrow_flagship():
    with jax_toggles(fused_stage=False):
        model = JUNetRSSv2(num_classes=3, input_channels=3, filters=FILTERS)
        g = np.random.default_rng(11)
        x = g.normal(size=(2, 32, 32, 3)).astype(np.float32)
        variables = jax.device_get(jit_init(model, jax.random.PRNGKey(1), jnp.asarray(x),
                                            train=False))
    return model, variables


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composition"])
def test_evaluate_runs_in_the_loaders_dtype_as_jax(narrow_flagship, monkeypatch, fused):
    """``evaluate`` feeds the loader's f32 images as they are, whatever
    ``mixed_precision`` says, as the JAX package's ``evaluate`` does (with
    its fused stages off: the module composition); loss and Dice to 1e-4,
    IoU to one element of its union. With ``set_fused_stage(False)`` every
    stage of the port's forward is the composition too."""
    model, variables = narrow_flagship
    g = np.random.default_rng(13)
    batches = [(None, g.normal(size=(2, 32, 32, 3)).astype(np.float32),
                (g.random((2, 32, 32, 3)) > 0.5).astype(np.float32), None) for _ in range(2)]
    port = build_model("UNet_R_SS_v2", 3, 3, filters=FILTERS, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    stage_kernel.set_fused_stage(fused)
    seen = _routes(monkeypatch)
    got = evaluate({"mixed_precision": True}, batches,
                   make_eval_step(port, losses.bce_dice_loss, 3), device="cpu")
    # per forward: the flagship's six fused stages (levels 0-2, H >= 8 at
    # 32²) through the fused wrapper, the other five composed
    n_fused = sum(r == "fused_eval_stage" for r in seen)
    assert n_fused == (12 if fused else 0) and len(seen) == 22
    state = TrainState.create(variables, joptim.build_optimizer({"optimizer": "Adam"}))
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    with jax_toggles(fused_stage=False):
        want = jax_evaluate({"mixed_precision": True}, batches, mesh, state,
                            jax_make_eval_step(model, jlosses.bce_dice_loss, 3))
    for k, atol in (("loss", 1e-4), ("iou", 1 / 2048), ("dice", 1e-4)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)
