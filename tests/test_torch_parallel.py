"""The port's data-parallel layer (``parallel/``, ``ops/collectives.py``) on
the CPU: the mesh of one process and its refusals, the collectives outside
and inside the train axis, and on 2 gloo ranks (``torch_dp_helpers``) the
sum and its gradient, ``replicate``, the gradient average, the metric
mean, the trainers' evaluation taking rank 0's reading, SyncBN in the plain ``BatchNorm`` against the JAX package's under
``shard_map`` on 2 virtual devices, the fused train stage (plain versions)
with the v3 and v2 backwards against the JAX package's on the whole batch,
and the sharded scene against the unsharded one.

The ranks run once for the module (one start-up) and each test reads its
part of their results. Inputs come from numpy with a seed. Tolerances:
the BatchNorm rtol 1e-6 with atol 1e-6 for the output and the input
gradient and 1e-7 for the running statistics (tests/test_parallel.py:69;
one f32 two-pass normalization, its sums split over the ranks); the fused stage
the bars of tests/test_torch_train_stage.py (forward and statistics rtol =
atol = 2e-4, each gradient max |Δ| ≤ 1e-3 · max |JAX|); the scene's
probabilities max |Δ| ≤ 1e-6 (the same per-tile forward at another batch)
and its masks equal wherever moving every probability by ±1e-5 leaves the
one-process mask as it is.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp_helpers as dp
from ssunet_gan_tpu import parallel as jparallel
from ssunet_gan_tpu.ops import collectives as jcol
from ssunet_gan_tpu.ops import stage_kernel_train as jst
from ssunet_gan_tpu.ops.norm import BatchNorm as JBatchNorm
from ssunet_gan_tpu_torch.data.tiling import grid_coords, merge_patches_device
from ssunet_gan_tpu_torch.ops import collectives
from ssunet_gan_tpu_torch.ops.norm import BatchNorm
from ssunet_gan_tpu_torch.parallel import make_mesh, shard_batch
from torch_port_helpers import STAGES, jax_toggles, normal, oihw, stage_bundle

RANKS = 2
STAGE = STAGES[0]  # planes 16, 3 labels, one part of 8 channels at 16², hidden 4


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(17)
    planes, lab, shapes, nh, ncls = STAGE
    xs = [normal(g, s) for s in shapes]
    bp, sp, _, tbp, tsp, _ = stage_bundle(g, planes, shapes, lab, nh, ncls)
    n, h, w = shapes[0][:3]
    scene = g.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    return {
        "x": normal(g, (3, 5)),
        "bn": (normal(g, (4, 6, 6, 5), 2.0) + 1.0, normal(g, (4, 6, 6, 5)),
               (g.random(5) + 0.5).astype(np.float32), normal(g, (5,), 0.3)),
        "stage": (xs, [t.numpy() if isinstance(t, torch.Tensor) else
                       tuple(u.numpy() for u in t) for t in tbp],
                  [t.numpy() for t in tsp], normal(g, (n, h, w, planes))),
        "jax_stage": (xs, bp, sp),
        "scene": scene,
    }


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """The checks of ``torch_dp_helpers._parallel_ranks`` on 2 gloo ranks."""
    send = {k: v for k, v in data.items() if k != "jax_stage"}
    return dp.run_ranks(dp._parallel_ranks, tmp_path_factory.mktemp("ranks"), send,
                        world=RANKS)


def test_mesh_of_one_process_and_its_refusals():
    """Without a process group the mesh is a world of one (``shard_batch``
    the identity, no axis); a model axis raises naming ROADMAP.md, a data
    axis larger than the group a ValueError; a CUDA tensor under a group
    whose backend is not NCCL raises."""
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.shape) == (1, 0, None, {"data": 1,
                                                                           "model": 1})
    x = torch.arange(6)
    assert torch.equal(shard_batch(mesh, x), x)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="2 on the data axis"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(types.SimpleNamespace(size=4, rank=0), x)
    with mock.patch.object(collectives.dist, "get_backend", lambda group=None: "gloo"):
        with pytest.raises(ValueError, match="NCCL"):
            collectives.check_device(types.SimpleNamespace(is_cuda=True), object())


def test_collectives_are_the_identity_outside_train_axis():
    x = torch.randn(3, requires_grad=True)
    assert collectives.psum_if(x) is x and collectives.pmean_if(x) is x
    assert collectives.axis_size() == 1 and collectives.current_axis() is None
    with collectives.train_axis(None, 1):  # a mesh of one without a process group
        assert collectives.psum_if(x) is x and collectives.axis_size() == 1


def test_psum_and_its_gradient_on_two_ranks(ranks, data):
    """psum over 2 ranks is the sum of their tensors (rank r holds x·(r+1)),
    pmean their mean; the backward all-reduces the cotangent, so each rank's
    gradient is Σ_r (r + 2) + Σ_r 1/2; outside the axis psum is the identity and
    the axis is restored after."""
    x = data["x"]
    for r, res in enumerate(ranks):
        c = res["collectives"]
        assert c["outside"] == (True, True, 1, True) and c["inside"] == (RANKS, True)
        assert c["restored"] and res["mesh"][:3] == (RANKS, r, {"data": 2, "model": 1})
        np.testing.assert_allclose(c["sum"].numpy(), 3 * x, rtol=1e-6)
        np.testing.assert_allclose(c["mean"].numpy(), 1.5 * x, rtol=1e-6)
        np.testing.assert_allclose(c["grad"].numpy(), np.full_like(x, 6.0), rtol=1e-6)


def test_replicate_average_and_metric_mean_on_two_ranks(ranks):
    """``replicate`` gives every rank rank 0's weights, ``average_gradients``
    the ranks' mean gradient (a None gradient stays None), ``pmean_metrics``
    the metrics' means in one all-reduce; ``shard_batch`` each rank's
    contiguous slice."""
    for r, res in enumerate(ranks):
        m = res["mean"]
        assert torch.equal(m["weight"], torch.zeros(2, 3))
        assert torch.equal(m["grad"], torch.full((2, 3), 1.5)) and m["bias_grad"] is None
        assert m["metrics"]["a"].item() == 0.5 and m["metrics"]["b"].item() == 2.0
        assert m["reduces"] == 1
        assert torch.equal(m["shard"], torch.arange(6)[3 * r:3 * r + 3])


def test_evaluate_takes_rank_zero_reading_on_two_ranks(ranks):
    """The trainers' ``evaluate(mesh=)``: the ranks' own readings differ
    (each rank's eval step reports its own numbers), and both return rank
    0's, so the plateau schedule, the best model and early stopping decide
    alike on every rank."""
    want = {"loss": 0.5, "iou": 0.25, "dice": float(np.float32(1 / 3))}
    for res in ranks:
        assert res["evaluate"] == want


def test_batchnorm_on_two_ranks_matches_jax_shard_map(ranks, data):
    """The port's training BatchNorm on 2 ranks (each its half of the batch,
    SyncBN through the train axis) against the JAX package's under
    ``shard_map`` on 2 virtual devices and against the port's one process
    on the whole batch: the output, the input gradient, the running
    statistics; the affine's gradients averaged over the ranks against one
    process's halved."""
    x, cot, weight, bias = data["bn"]
    jbn = JBatchNorm(x.shape[-1])
    variables = jax.device_get(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    mesh = jparallel.make_mesh(n_data=RANKS)

    def body(v, xs):
        with jcol.train_axis("data", RANKS):
            return jbn.apply(v, xs, True, mutable=["batch_stats"])

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data")),
                            out_specs=(P("data"), P()), check_vma=False)

    def loss(xx):
        y, upd = sharded(variables, xx)
        return jnp.sum(y * jnp.asarray(cot)), (y, upd)

    (_, (jy, jupd)), jgx = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))

    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(cot)).sum().backward()

    got = {k: torch.cat([res["bn"][k] for res in ranks]).numpy() for k in ("y", "gx")}
    for want in ({"y": np.asarray(jy), "gx": np.asarray(jgx)},
                 {"y": y.detach().numpy(), "gx": xt.grad.numpy()}):
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for res in ranks:
        for k, jk, port in (("mean", "mean", bn.running_mean), ("var", "var", bn.running_var)):
            np.testing.assert_allclose(res["bn"][k].numpy(), np.asarray(jupd["batch_stats"][jk]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(res["bn"][k].numpy(), port.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    for k, p in (("gw", bn.weight), ("gb", bn.bias)):  # rank sums of the local halves
        total = sum(res["bn"][k] for res in ranks)
        np.testing.assert_allclose(total.numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_stage(data):
    """The JAX package's fused train stage on the whole batch (Pallas
    interpret mode, its v2 backward): output, statistics, gradients."""
    xs, bp, sp = data["jax_stage"]
    cot = data["stage"][3]

    def jax_loss(parts, bp, sp):
        out, stats = jst.fused_train_stage(parts, bp, sp, None)
        out = jnp.swapaxes(out.v, 2, 3) if hasattr(out, "v") else out
        return jnp.sum(out * cot), (out, stats)

    with jax_toggles(fused_stage=True, fused_train=True, train_bwd_v3=False):
        jbp = jax.tree_util.tree_map(jnp.asarray, bp)
        (_, (out, stats)), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            tuple(jnp.asarray(x) for x in xs), jbp, tuple(jnp.asarray(a) for a in sp))
    return jax.device_get((out, stats, grads))


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_fused_train_stage_on_two_ranks_matches_jax(ranks, data, jax_stage, version):
    """``fused_train_stage`` (plain versions) with each backward on 2 ranks,
    one image each, SyncBN through its sums (between the convs, and in the
    backward's BN terms), against the JAX package's fused train stage on the
    whole batch (Pallas interpret mode, its v2 backward): the output and
    both batch-statistic pairs, each rank's part gradients, and the
    parameter gradients averaged over the ranks (times 2: the JAX loss sums
    over the whole batch)."""
    xs = data["jax_stage"][0]
    want_out, want_stats, jgrads = jax_stage
    got = [res["stage"][version] for res in ranks]
    out = torch.cat([g["out"] for g in got]).numpy()
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=2e-4, atol=2e-4)
    want_stats = [np.asarray(t) for pair in want_stats for t in pair]
    for g in got:
        for a, b in zip(g["stats"], want_stats):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4)

    jg_parts, (gk1, (gg1, gb1), gk2, (gg2, gb2), gks), jg_sp = jgrads
    g_parts = [torch.cat([g["g_parts"][i] for g in got]).numpy() for i in range(len(xs))]
    assert all(torch.equal(a, b) for a, b in zip(got[0]["g_params"], got[1]["g_params"]))
    g_params = [RANKS * t.numpy() for t in got[0]["g_params"]]
    want = list(jg_parts) + [gk1, gg1, gb1, gk2, gg2, gb2, gks] + list(jg_sp)
    for i, (a, wv) in enumerate(zip(g_parts + g_params, want)):
        wv = np.asarray(wv, np.float64)
        if wv.ndim == 4 and i >= len(xs):
            wv = oihw(wv).numpy()
        rel = np.abs(a - wv).max() / (np.abs(wv).max() + 1e-6)
        assert rel < 1e-3, (i, rel)


def test_sharded_scene_matches_the_unsharded(ranks, data):
    """``segmentation_inference`` and ``pipelined_scene_forward`` with the
    36 tiles of a 128² scene split over 2 ranks (chunks of 32, 16 tiles a
    rank, the last chunk padded; the probabilities gathered in tile order)
    against one process: every rank's probabilities within 1e-6 and its
    masks equal wherever the one-process masks stay the same with every
    probability moved by ±1e-5."""
    want = dp.scene_run(None, data["scene"])
    assert want["probs"].shape == (36, 32, 32, 3) and 0.05 < want["probs"].std()
    assert all(0 < m.mean() < 255 for m in want["masks"])  # no class's mask is constant
    coords = grid_coords(128, 128, 64, 0.5)
    # the pixels whose mask no move of every probability by 1e-5 changes
    nudged = [merge_patches_device(want["probs"] + d, coords, 128, 128, 64, 3, overlap=0.5)
              for d in (-1e-5, 1e-5)]
    sure = (nudged[0] == nudged[1]).permute(2, 0, 1).numpy()
    assert sure.mean() > 0.99
    for res in ranks:
        got = res["scene"]
        for k in ("probs", "pipelined"):
            assert got[k].shape == want[k].shape
            assert (got[k] - want[k]).abs().max().item() <= 1e-6, k
        np.testing.assert_array_equal(got["masks"][sure], want["masks"][sure])
