"""Ranks of a data-parallel run on the CPU for the port's tests: gloo
processes started with ``spawn`` (``torch.multiprocessing``'s context), a
``file://`` store in the test's temporary directory, each rank's result
sent back through ``torch.save``. A rank that raises writes its traceback
and the parent fails with it; a run past its time limit is killed, so a
deadlock fails its test instead of holding the suite.

This module imports torch and the port only: the ranks import it, and not
the test modules (which import JAX).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = 120.0  # seconds a multi-rank run may take before it is killed


def _entry(rank: int, world: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """``fn(rank, world, *args)`` running on ``world`` gloo ranks;
    :meth:`join` waits for them (at most ``timeout`` seconds from the
    start) and returns their results in rank order. ``fn`` is a
    module-level function of this module (the ranks import it by name)."""

    def __init__(self, fn, tmp_path, *args, world: int = 2, timeout: float = RANK_TIMEOUT):
        self.tmp = tempfile.mkdtemp(dir=str(tmp_path))  # a store and results of its own
        self.world, self.timeout = world, timeout
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(r, world, self.tmp, fn, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self):
        procs, tmp, world = self.procs, self.tmp, self.world
        try:
            for p in procs:
                p.join(max(self.deadline - time.monotonic(), 0.0))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
                p.join(10)
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if late:
            raise TimeoutError(f"{len(late)} of {world} ranks still running after "
                               f"{self.timeout} s" + "".join("\n" + e for e in errors))
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"exit codes {[p.exitcode for p in procs]}\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def run_ranks(fn, tmp_path, *args, world: int = 2, timeout: float = RANK_TIMEOUT):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results in
    rank order (:class:`Ranks`, joined)."""
    return Ranks(fn, tmp_path, *args, world=world, timeout=timeout).join()


def model_axis_mesh():
    """A mesh with a model axis of 2, built past ``Mesh``'s own refusal so
    that what receives it must refuse it."""
    from ssunet_gan_tpu_torch.parallel import Mesh

    mesh = object.__new__(Mesh)
    for k, v in (("group", None), ("shape", {"data": 1, "model": 2}), ("rank", 0),
                 ("device", torch.device("cpu"))):
        object.__setattr__(mesh, k, v)
    return mesh


# ---- the supervised step ------------------------------------------------------

FLAGSHIP_NARROW = (8, 8, 8, 8, 8, 8)


def flagship_batch(seed: int, n: int, hw: int = 32):
    """A seeded NHWC batch of ``n`` images and 3-class masks."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, hw, hw, 3)).astype(np.float32)
    y = (g.random((n, hw, hw, 3)) > 0.5).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def supervised_step(mesh, seed, n, accum=1, lr=1e-3, clip=0.7):
    """One Adam step of a narrow flagship (``FLAGSHIP_NARROW``, 32²) on the
    global batch ``flagship_batch(seed, n)`` (this rank's slice under
    ``mesh``): metrics, every gradient, the parameters and the running
    statistics after the step."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import losses
    from ssunet_gan_tpu_torch.parallel import shard_batch
    from ssunet_gan_tpu_torch.train import optim
    from ssunet_gan_tpu_torch.train.step import make_train_step

    model = build_model("UNet_R_SS_v2", 3, 3, filters=FLAGSHIP_NARROW, seed=seed, device="cpu")
    opt = optim.build_optimizer(model.parameters(), {"optimizer": "Adam", "lr": lr})
    step = make_train_step(model, losses.bce_dice_loss, opt, 3, clip=clip, accum_steps=accum,
                           mesh=mesh)
    x, y = flagship_batch(seed, n)
    if mesh is not None:
        x, y = shard_batch(mesh, (x, y))
    metrics = step(x, y, lr)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def counted_supervised_step(mesh, seed, n, fused=None, accum=1):
    """:func:`supervised_step` with the fused train stages in mode ``fused``
    (``ops.stage_kernel_train.set_fused_train``: None the default, on;
    False the module composition), and the fused train stages its forward
    ran."""
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    calls = {"n": 0}
    stage = ssunet.fused_train_stage

    def counted(*a, **k):
        calls["n"] += 1
        return stage(*a, **k)

    ssunet.fused_train_stage = counted
    mode = tst._FUSED_TRAIN
    tst.set_fused_train(fused)
    try:
        out = supervised_step(mesh, seed, n, accum)
    finally:
        ssunet.fused_train_stage = stage
        tst.set_fused_train(mode)
    out["fused_stages"] = calls["n"]
    return out


def _supervised_ranks(rank, world, seed, cases):
    from ssunet_gan_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    return {name: counted_supervised_step(mesh, seed, n, fused, accum)
            for name, fused, accum, n in cases}


# ---- the parallel layer: collectives, BatchNorm, the fused train stage, the scene --


def _t(a):
    return torch.from_numpy(a.copy())


def _slice(mesh, a):
    from ssunet_gan_tpu_torch.parallel import shard_batch

    return shard_batch(mesh, _t(a))


def collectives_checks(mesh, x):
    """psum / pmean and the sum's gradient on this rank (``x`` times rank +
    1), inside and outside the train axis; the train axis restored after."""
    from ssunet_gan_tpu_torch.ops import collectives as col

    xr = (_t(x) * (mesh.rank + 1)).requires_grad_()
    outside = (col.psum_if(xr) is xr, col.pmean_if(xr) is xr, col.axis_size(),
               col.current_axis() is None)
    with col.train_axis(mesh.group, mesh.size):
        inside = (col.axis_size(), col.current_axis() is mesh.group)
        s = col.psum_if(xr)
        m = col.pmean_if(xr)
        # rank r weighs the sum by r + 2: its cotangent reaches every rank
        ((s * (mesh.rank + 2)).sum() + m.sum()).backward()
    return {"outside": outside, "inside": inside, "restored": col.current_axis() is None,
            "sum": s.detach(), "mean": m.detach(), "grad": xr.grad}


def batchnorm_checks(mesh, x, cot, weight, bias):
    """The port's BatchNorm in training on this rank's slice of ``x`` inside
    the train axis: output, input gradient, the affine's gradients (this
    rank's) and the running statistics after."""
    from ssunet_gan_tpu_torch.ops import collectives as col
    from ssunet_gan_tpu_torch.ops.norm import BatchNorm

    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(_t(weight))
        bn.bias.copy_(_t(bias))
    xs = _slice(mesh, x).requires_grad_()
    with col.train_axis(mesh.group, mesh.size):
        y = bn(xs)
        (y * _slice(mesh, cot)).sum().backward()
    return {"y": y.detach(), "gx": xs.grad, "gw": bn.weight.grad, "gb": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def stage_checks(mesh, xs, tbp, tsp, cot, v3):
    """``fused_train_stage`` (plain versions) on this rank's slice inside the
    train axis with the v3 or v2 backward: output, batch statistics, the
    part gradients (this rank's) and the parameter gradients averaged over
    the ranks."""
    from ssunet_gan_tpu_torch.ops import collectives as col
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.parallel import average_gradients

    parts = tuple(_slice(mesh, x).requires_grad_() for x in xs)
    params = [torch.nn.Parameter(_t(a)) for a in (tbp[0], *tbp[1], tbp[2], *tbp[3], tbp[4],
                                                  *tsp)]
    bp = (params[0], tuple(params[1:3]), params[3], tuple(params[4:6]), params[6])
    tst.set_train_bwd_v3(v3)
    try:
        with col.train_axis(mesh.group, mesh.size):
            out, stats = tst.fused_train_stage(parts, bp, tuple(params[7:]))
            (out * _slice(mesh, cot)).sum().backward()
    finally:
        tst.set_train_bwd_v3(True)
    average_gradients(mesh, params)
    return {"out": out.detach(), "stats": [t.clone() for pair in stats for t in pair],
            "g_parts": [p.grad for p in parts], "g_params": [p.grad for p in params]}


SCENE_CONFIG = {"patch_size": 64, "input_w": 32, "input_h": 32, "patch_overlap": 0.5,
                "num_classes": 3, "deep_supervision": False}


def scene_model(seed: int = 3):
    """A narrow flagship in eval mode with seeded running statistics."""
    from ssunet_gan_tpu_torch.models import build_model

    model = build_model("UNet_R_SS_v2", 3, filters=(8, 16, 16, 24, 24, 32), seed=seed,
                        device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model.eval()


def scene_run(mesh, scene):
    """``segmentation_inference`` and ``pipelined_scene_forward`` of a
    128² scene (36 tiles of 32²: two chunks, the last padded), with or
    without ``mesh``: the tile probabilities of both routes and the masks."""
    from ssunet_gan_tpu_torch.data.tiling import extract_patches, grid_coords
    from ssunet_gan_tpu_torch.infer import api

    model = scene_model()
    coords = grid_coords(scene.shape[0], scene.shape[1], 64, 0.5)
    tiles = np.ascontiguousarray(extract_patches(scene, coords, 64)[:, ::2, ::2])
    a, b = api._norm_consts()
    with torch.no_grad():  # each class's logit spread and centred (median 0) over the tiles
        model.final.weight.mul_(30.0)
        logits = model(torch.from_numpy(tiles).float() * a + b)
        model.final.bias.sub_(logits.reshape(-1, 3).median(0).values)
    probs = api._chunked_forward(model, tiles, device="cpu", mesh=mesh)
    masks, _ = api.segmentation_inference(model, scene, tiles, tiles, SCENE_CONFIG, False,
                                          device="cpu", mesh=mesh)
    pipelined = api.pipelined_scene_forward(model, scene, SCENE_CONFIG, device="cpu",
                                            mesh=mesh)[0]
    return {"probs": probs, "masks": np.stack(masks), "pipelined": pipelined}


def evaluate_run(mesh):
    """``train.supervised.evaluate(mesh=)`` over two items whose eval step
    reads rank-dependent numbers (loss r + 1/2, IoU (r + 1) / 4, Dice
    r + 1/3)."""
    from ssunet_gan_tpu_torch.train.supervised import evaluate

    r = float(mesh.rank)
    item = (None, np.zeros((1, 2, 2, 3), np.float32), np.zeros((1, 2, 2, 1), np.float32), None)

    def eval_step(x, y):
        return {"loss": torch.tensor(r + 0.5), "iou": torch.tensor((r + 1) / 4),
                "dice": torch.tensor(r + 1 / 3)}

    return evaluate({}, [item, item], eval_step, "cpu", mesh)


def _parallel_ranks(rank, world, data):
    from ssunet_gan_tpu_torch.ops import collectives as col
    from ssunet_gan_tpu_torch.parallel import (
        average_gradients,
        make_mesh,
        pmean_metrics,
        replicate,
        shard_batch,
    )

    mesh = make_mesh()
    out = {"mesh": (mesh.size, mesh.rank, mesh.shape, str(mesh.device))}
    out["collectives"] = collectives_checks(mesh, data["x"])
    out["bn"] = batchnorm_checks(mesh, *data["bn"])
    out["stage"] = {v: stage_checks(mesh, *data["stage"], v3=(v == "v3"))
                    for v in ("v3", "v2")}
    # replicate, the gradient average and the metric mean
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    replicate(mesh, lin)
    lin.weight.grad = torch.full_like(lin.weight, float(rank + 1))
    average_gradients(mesh, lin.parameters())
    before = dict(col.calls)
    metrics = pmean_metrics(mesh, {"a": torch.tensor(float(rank)), "b": torch.tensor(2.0)})
    out["mean"] = {"weight": lin.weight.detach().clone(), "grad": lin.weight.grad,
                   "bias_grad": lin.bias.grad, "metrics": metrics,
                   "reduces": col.calls["all_reduce"] - before["all_reduce"],
                   "shard": shard_batch(mesh, torch.arange(6))}
    out["scene"] = scene_run(mesh, data["scene"])
    out["evaluate"] = evaluate_run(mesh)
    return out


# ---- the train paths: the supervised step, the GAN step, run_experiment ----------


def narrow_flagship_gan(seed: int = 5):
    """tests/test_torch_gan.py's G (a narrow flagship, 2 classes) and D (8
    channels, 4 blocks, fc 32)."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.models import gan as tgan

    gen = tgan.Generator("UNet_R_SS_v2", 2, 3, device="cpu")
    gen.net = build_model("UNet_R_SS_v2", 2, 3, filters=(8, 16, 32, 48, 64, 64), seed=seed,
                          device="cpu")
    disc = tgan.Discriminator(2, 3, 8, 4, 32, generator=torch.Generator().manual_seed(seed))
    return gen, disc


def gan_batch(seed: int, n: int, hw: int):
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, hw, hw, 3)).astype(np.float32)
    y = (g.random((n, hw, hw, 2)) > 0.5).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _grads_of(gen, disc):
    return {f"{i}.{k}": p.grad.clone() for i, m in enumerate((gen, disc))
            for k, p in m.named_parameters() if p.grad is not None}


def gan_step_run(mesh, case):
    """One GAN step of ``case`` (``nets``: "flagship" or the state_dicts of
    a G / D pair built as ``tests/test_torch_gan.py`` ``_port_gan``; the
    formulation, the clamp, SGD or Adam, the batch) on the global batch,
    this rank's slice under ``mesh``: metrics, the clamped gradients, the
    parameters and buffers after. With ``clamp_first`` the gradients are
    instead clamped on each rank before their average (what the step must
    not do), for the comparison."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.models import gan as tgan
    from ssunet_gan_tpu_torch.ops import losses
    from ssunet_gan_tpu_torch.parallel import average_gradients, shard_batch, sharded_step
    from ssunet_gan_tpu_torch.train import gan_step
    from ssunet_gan_tpu_torch.train.optim import adam

    if case["nets"] == "flagship":
        gen, disc = narrow_flagship_gan(case["seed"])
    else:
        g_sd, d_sd = case["nets"]
        gen = tgan.Generator("SSUNet", 2, 3, device="cpu")
        gen.net = build_model("SSUNet", 2, 3, filters=(8, 16, 32, 48, 64), device="cpu")
        gen.load_state_dict(g_sd)
        disc = tgan.Discriminator(2, 3, 8, 2, 1024)
        disc.load_state_dict(d_sd)
    x, y = gan_batch(case["seed"], case["n"], case["hw"])
    if mesh is not None:
        x, y = shard_batch(mesh, (x, y))
    gan_step.set_joint_gan(case["joint"])
    try:
        if case.get("clamp_first"):
            params = [p for m in (gen, disc) for p in m.parameters()]
            gen.train()
            disc.train()
            with sharded_step(mesh):
                gan_step._shard_gradients(gen, disc, losses.bce_dice_loss, x, y, 2,
                                          gan_step.ALPHA, gan_step.BETA,
                                          list(gen.parameters()), list(disc.parameters()))
            grads = [p.grad for p in params if p.grad is not None]
            torch._foreach_clamp_min_(grads, -case["clip"])
            torch._foreach_clamp_max_(grads, case["clip"])
            average_gradients(mesh, params)
            return {"grads": _grads_of(gen, disc)}
        lr = case["lr"]
        if case["opt"] == "adam":
            opts = (adam(gen.parameters()), adam(disc.parameters()))
        else:
            opts = tuple(torch.optim.SGD(m.parameters(), lr=lr) for m in (gen, disc))
        step = gan_step.make_gan_train_step(gen, disc, losses.bce_dice_loss, *opts, 2,
                                            grad_clip=case["clip"], mesh=mesh)
        metrics = step(x, y, lr)
    finally:
        gan_step.set_joint_gan(True)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": _grads_of(gen, disc),
            "state": [{k: v.clone() for k, v in m.state_dict().items()} for m in (gen, disc)]}


def experiment_run(mesh, config_path):
    """``run_experiment`` for one synthetic epoch (4 scenes) of the config at
    ``config_path``, the train split through ``val_transform`` (the
    augmentations draw from one unseeded generator, so two runs of the same
    step see other images); returns its log."""
    from ssunet_gan_tpu_torch.config import load_experiment_config
    from ssunet_gan_tpu_torch.train import supervised

    train_transform = supervised.train_transform
    supervised.train_transform = supervised.val_transform
    try:
        return supervised.run_experiment(load_experiment_config(config_path), synthetic=4,
                                         use_tensorboard=False, device="cpu", mesh=mesh)[2]
    finally:
        supervised.train_transform = train_transform


def _train_ranks(rank, world, payload):
    from ssunet_gan_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    out = {"supervised": _supervised_ranks(rank, world, *payload["supervised"]),
           "gan": {c["name"]: gan_step_run(mesh, c) for c in payload["gan"]},
           "experiment": experiment_run(mesh, payload["experiment"][rank])}
    return out
