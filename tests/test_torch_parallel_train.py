"""The port's data-parallel training on 2 gloo ranks (``torch_dp_helpers``)
against one process on the global batch, and the GAN step against the JAX
package's ``shard_map`` step (``make_gan_train_step(mesh=make_mesh(n_data=
2))``) on 2 virtual devices:

- ``make_train_step(mesh=)`` on a narrow flagship at 32², one image per
  rank: the fused train stages (the default), the module composition with
  SyncBN (the fused train stages set off), and ``accum_steps=2`` (two
  images per rank, the fused train stages in both microbatches);
- ``make_gan_train_step(mesh=)`` in both formulations (a narrow flagship G
  through its fused train stages, at 64²: at 32² its levels 4-5 normalize
  over 8 and 2 values, and the one-process step itself moves 5e-4 in G's
  gradients when its two images swap places), with the clamp biting (applied after the
  gradients' average: clamping each rank's before it gives other
  gradients), and a narrow SSUNet G at 16² against the JAX package, the
  weights carried across as ``tests/test_torch_gan.py`` carries them;
- ``run_experiment(mesh=)`` for one synthetic epoch of a tiny SSUNet.

The ranks run once for the module, while this process computes the
references. Tolerances (f32, the same arithmetic
with the batch's sums split over the ranks): metrics 1e-5 relative (IoU
to one element of its union); each gradient relative L2 ≤ 1e-5, with a
floor of 2e-6 of the largest gradient (tests/test_torch_gan.py's: a
gradient that is 0 analytically is f32 noise on both sides); parameters
after one Adam step max |Δ| ≤ 1e-4; running statistics rtol 1e-6 with
atol 1e-7 (tests/test_parallel.py:69); ``log.csv``'s columns 1e-5. Against
the JAX package the losses within 2e-4 (tests/test_parallel.py:164) and
the parameters and running statistics by tests/test_torch_gan.py's bars.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_helpers as dp
from ssunet_gan_tpu import parallel as jparallel
from ssunet_gan_tpu.models import gan as jgan
from ssunet_gan_tpu.ops import losses as jlosses
from ssunet_gan_tpu.train.gan_step import make_gan_train_step as jax_make_gan_train_step
from ssunet_gan_tpu.train.state import TrainState
from ssunet_gan_tpu_torch.compat import from_jax_variables
from test_torch_gan import (
    GRAD_ATOL,
    GRAD_RTOL,
    _back_to_jax,
    _init,
    _leaves,
    _NarrowGen,
)
from torch_port_helpers import jax_toggles

RANKS = 2
SEED = 7
# (name, set_fused_train's mode, accum_steps, global batch)
SUPERVISED = [("fused", None, 1, 2), ("composition", False, 1, 2), ("accum", None, 2, 4)]
CLIP_BITES = 1e-4
GAN_CASES = [
    dict(name="joint", nets="flagship", seed=5, hw=64, n=2, joint=True, clip=0.8, opt="sgd",
         lr=1e-3),
    dict(name="alternating", nets="flagship", seed=5, hw=64, n=2, joint=False, clip=0.8,
         opt="sgd", lr=1e-3),
    dict(name="clamp bites", nets="flagship", seed=6, hw=64, n=2, joint=True, clip=CLIP_BITES,
         opt="sgd", lr=1e-3),
    dict(name="clamp first", nets="flagship", seed=6, hw=64, n=2, joint=True, clip=CLIP_BITES,
         clamp_first=True),
]
JAX_GAN = ("jax joint", "jax alternating")
# SGD: Adam's first steps (≈ lr·sign(g)) turn f32 noise in a near-0 gradient
# into a step of 2·lr, which then moves the second step's metrics
SMALL = dict(arch="SSUNet", input_h=32, input_w=32, batch_size=2, num_workers=2,
             mixed_precision="False", name="tiny_ssunet", epochs=1, optimizer="SGD", lr=0.01)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "config_v1.json")


def _experiment_config(root):
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["file_path"] = {k: os.path.join(root, d) for k, d in (
        ("input_path", "inputs"), ("model_path", "models"), ("output_path", "outputs"),
        ("checkpoint_path", "checkpoint"))}
    raw["opt_config"].update(SMALL)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def jax_gan():
    """A narrow SSUNet G (2 classes) and D (8 channels, 2 blocks, fc 1024) as
    JAX variables drawn from numpy, a 16² batch of 2, and the port's
    state_dicts of the same weights."""
    x, y = (t.numpy() for t in dp.gan_batch(SEED, 2, 16))
    with jax_toggles(fused_stage=False):
        gv = _init(_NarrowGen(), x[:1], 0, True)
        dv = _init(jgan.Discriminator(num_classes=2, kernel_size=3, n_channels=8, n_blocks=2,
                                      fc_size=1024), y[:1], 1, True)
    return gv, dv, x, y, (from_jax_variables(gv), from_jax_variables(dv))


def _jax_mesh_step(jax_gan, name):
    """The JAX package's ``make_gan_train_step(mesh=make_mesh(n_data=2))``
    (``shard_map`` over 2 virtual devices) on ``jax_gan``'s weights and
    batch, SGD at lr 1e-3: G's and D's states after, and the metrics."""
    gv, dv, x, y, _ = jax_gan
    jgen = _NarrowGen()
    jdisc = jgan.Discriminator(num_classes=2, kernel_size=3, n_channels=8, n_blocks=2,
                               fc_size=1024)
    tx = optax.sgd(1.0)  # the step scales its updates by lr
    with jax_toggles(fused_stage=False, joint_gan=name.endswith("joint")):
        jstep = jax_make_gan_train_step(jgen, jdisc, jlosses.bce_dice_loss, tx, tx, 2,
                                        mesh=jparallel.make_mesh(n_data=RANKS))
        return jstep(TrainState.create(gv, tx), TrainState.create(dv, tx),
                     (jnp.asarray(x), jnp.asarray(y)), jnp.float32(1e-3))


@pytest.fixture(scope="module")
def ranks(jax_gan, tmp_path_factory):
    """Every check's rank-side run, on 2 gloo ranks at once, and meanwhile
    in this process the references: one process on each global batch, the
    JAX package's mesh steps."""
    root = tmp_path_factory.mktemp("dp_train")
    nets = jax_gan[4]
    gan = GAN_CASES + [dict(name=name, nets=nets, seed=SEED, hw=16, n=2, joint=name.endswith(
        "joint"), clip=0.8, opt="sgd", lr=1e-3) for name in JAX_GAN]
    payload = {"supervised": (SEED, SUPERVISED), "gan": gan,
               "experiment": [_experiment_config(str(root / f"rank{r}")) for r in range(RANKS)]}
    running = dp.Ranks(dp._train_ranks, root, payload, world=RANKS)
    threads = torch.get_num_threads()
    # the cores the ranks leave (2 threads each): more would spin against them
    torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 1) - 2 * RANKS)))
    try:
        one = {"supervised": {name: dp.counted_supervised_step(None, SEED, n, fused, accum)
                              for name, fused, accum, n in SUPERVISED},
               "gan": {c["name"]: dp.gan_step_run(None, c) for c in GAN_CASES
                       if not c.get("clamp_first")},
               "jax": {name: _jax_mesh_step(jax_gan, name) for name in JAX_GAN},
               "experiment": dp.experiment_run(None, _experiment_config(str(root / "one")))}
    finally:
        torch.set_num_threads(threads)
        results = running.join()
    return {"results": results, "root": root, "gan": {c["name"]: c for c in gan}, "one": one}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _metrics_close(got, want, rtol=1e-5):
    assert got.keys() == want.keys()
    for k in want:
        atol = 1 / 2048 if k == "iou" else 0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _grads_close(got, want, rtol=1e-5):
    assert got.keys() == want.keys()
    scale = max(g.abs().max().item() for g in want.values())
    for k, w in want.items():
        err = (got[k].double() - w.double()).norm().item()
        assert err <= rtol * w.double().norm().item() + GRAD_ATOL * scale, (k, err, w.norm())


def _states_close(got, want):
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        elif "weight_u" in k or "weight_v" in k:
            torch.testing.assert_close(got[k], w)
        else:
            assert (got[k] - w).abs().max().item() <= 1e-4, k


def _ranks_agree(results, part, name):
    """Every rank ends the step with the same parameters and buffers."""
    first = results[0][part][name]["state"]
    for res in results[1:]:
        other = res[part][name]["state"]
        for a, b in zip(first if isinstance(first, list) else [first],
                        other if isinstance(other, list) else [other]):
            assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name,fused,accum,n", SUPERVISED, ids=[c[0] for c in SUPERVISED])
def test_supervised_dp_step_matches_one_process(ranks, name, fused, accum, n):
    """One Adam step of ``make_train_step(mesh=)`` on 2 ranks against the
    same step in one process on the global batch, both with the fused train
    stages in the same mode (on by default, in every microbatch; off: the
    module composition, SyncBN): loss, IoU, Dice, every gradient (the
    ranks' average), the parameters and the running statistics after; each
    rank ran as many fused stages as the one process."""
    results = ranks["results"]
    want = ranks["one"]["supervised"][name]
    assert (want["fused_stages"] > 0) == (fused is None)
    for res in results:
        got = res["supervised"][name]
        assert got["fused_stages"] == want["fused_stages"]
        _metrics_close(got["metrics"], want["metrics"])
        _grads_close(got["grads"], want["grads"])
        _states_close(got["state"], want["state"])
    _ranks_agree(results, "supervised", name)


@pytest.mark.parametrize("name", ["joint", "alternating"])
def test_gan_dp_step_matches_one_process(ranks, name):
    """One SGD step of ``make_gan_train_step(mesh=)`` in each formulation on
    2 ranks (G a narrow flagship through its fused train stages, D's
    BatchNorms SyncBN) against one process on the global batch: the six
    metrics, every clamped G and D gradient, both networks' parameters and
    running statistics after (D's after its three updates)."""
    want = ranks["one"]["gan"][name]
    for res in ranks["results"]:
        got = res["gan"][name]
        _metrics_close(got["metrics"], want["metrics"])
        _grads_close(got["grads"], want["grads"])
        for g_state, w_state in zip(got["state"], want["state"]):
            _states_close(g_state, w_state)
    _ranks_agree(ranks["results"], "gan", name)


def test_gan_dp_clamps_after_the_average(ranks):
    """With the clamp at 1e-4 (40% of the gradients at it) the DP step's
    gradients and its SGD step equal one process's, where the clamp comes
    after the ranks' average; clamping each rank's gradients before the
    average (the order the step must not take) gives gradients far from
    them."""
    want = ranks["one"]["gan"]["clamp bites"]
    clamped = torch.cat([g.reshape(-1) for g in want["grads"].values()])
    assert (clamped.abs() == CLIP_BITES).float().mean().item() > 0.3
    for res in ranks["results"]:
        got = res["gan"]["clamp bites"]
        _metrics_close(got["metrics"], want["metrics"])
        # the clamp is 1-Lipschitz: the clamped gradients elementwise within
        # 1e-3 of the clamp (the unclamped ones' f32 differences are ≤ 1e-7)
        assert got["grads"].keys() == want["grads"].keys()
        worst = max((got["grads"][k] - w).abs().max().item() for k, w in want["grads"].items())
        assert worst <= 1e-3 * CLIP_BITES, worst
        for g_state, w_state in zip(got["state"], want["state"]):
            _states_close(g_state, w_state)
        first = torch.cat([g.reshape(-1) for g in res["gan"]["clamp first"]["grads"].values()])
        assert rel_l2(first, clamped) > 0.05


@pytest.mark.parametrize("name", JAX_GAN)
def test_gan_dp_step_matches_jax_mesh_step(ranks, name):
    """The port's DP GAN step on 2 ranks against the JAX package's
    ``make_gan_train_step(mesh=make_mesh(n_data=2))`` (``shard_map`` over 2
    virtual devices) on the same weights and 16² batch, SGD on both sides:
    the losses and metrics within 2e-4, both networks' parameters after
    the step (old − lr·g) within lr times the GAN test's gradient bar, and
    their running statistics within 1e-4 (tests/test_torch_gan.py's bars;
    at 16² the deep levels normalize over 2-8 values, so the gradients
    themselves carry more f32 noise than at that test's 32²)."""
    gs, ds, want = ranks["one"]["jax"][name]
    for res in ranks["results"]:
        got = res["gan"][name]
        assert got["metrics"].keys() == want.keys()
        for k in want:
            assert abs(got["metrics"][k] - float(want[k])) < 2e-4, (k, got["metrics"][k],
                                                                    float(want[k]))
        for i, (state, fc1) in enumerate(((gs, None), (ds, 8))):
            variables = jax.device_get(state.variables())
            back = _leaves(_back_to_jax(got["state"][i], variables, fc1))
            for key, w in _leaves(variables).items():
                if "batch_stats" in key:
                    np.testing.assert_allclose(back[key], w, rtol=1e-4, atol=1e-4, err_msg=key)
                else:  # old − lr·g: two f32 roundings and lr times the gradient bar apart
                    np.testing.assert_allclose(back[key], w, rtol=2.4e-7,
                                               atol=1e-3 * 0.8 * GRAD_RTOL, err_msg=key)


def _log_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_run_experiment_on_two_ranks_matches_one_process(ranks):
    """``run_experiment(mesh=)`` for one epoch of 4 synthetic scenes (global
    batch 2, one image a rank; SGD) against one process: every column of
    ``log.csv`` within 1e-5; both ranks return the same log; rank 0 wrote
    the card, ``log.csv``, ``model.pth`` and the train state, and rank 1
    (its own paths in its config) wrote no file."""
    root = ranks["root"]
    want_log = ranks["one"]["experiment"]
    header, want = _log_rows(os.path.join(root, "one", "models", "tiny_ssunet", "log.csv"))
    got_header, got = _log_rows(os.path.join(root, "rank0", "models", "tiny_ssunet", "log.csv"))
    assert got_header == header and got.shape == want.shape == (1, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    logs = [res["experiment"] for res in ranks["results"]]
    assert logs[0] == logs[1] and logs[0].keys() == want_log.keys()
    written = {f for _, _, files in os.walk(root / "rank0" / "models") for f in files}
    assert {"config.yml", "log.csv", "model.pth", "train_state.pth",
            "train_meta.json"} <= written
    rank1 = [os.path.join(d, f) for d, _, files in os.walk(root / "rank1") for f in files]
    assert rank1 == [os.path.join(root, "rank1", "config.json")]
