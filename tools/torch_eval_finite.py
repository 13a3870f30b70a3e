"""Where the flagship generator's validation forward turns non-finite, route
by route, held against the JAX package's f32 forward of the same weights.

The generator is the one ``chip_smoke.py`` phase 15 fine-tunes: the
full-width flagship of ``configs/config_v1.json`` (``UNet_R_SS_v2``, seed
``chip_smoke.SEED``), its BatchNorm statistics calibrated on two seeded
noise tiles (``chip_smoke.calibrate_batchnorm``). Its validation batch is
phase 15's (``SyntheticDataset`` through ``val_transform``, seed
``STEP1_BATCHES + 1``, ``TRAIN_BATCH`` images at the config's size). Each
route evaluates it with the running statistics as calibrated and again
after two train forwards (batches of seeds 1 and 2, no update) made
through the same route:

  a       the port's f32 module composition (``chip_smoke.module_stage``);
  b-bf16  the port's fused stages' plain versions in bf16 (what the bf16
          kernels compute: ``fused_stage_reference``, and the train stage's
          plain version for the train forwards);
  b-f32   the same plain versions in f32 (what the f32 route computes);
  c       the JAX package's f32 forward (``convert_torch_state_dict`` of
          the port's weights, its fused stages off), its train forwards in
          JAX as well.

For each it prints the logits' non-finite share and largest finite value,
every stage's output (largest finite |value|, non-finite share), and the
first stage and op whose output is not finite. Then it decides against c:
a route that turns non-finite at another stage than c, or not at all where
c does, disagrees with the reference.

Run from the repository's root, on the CPU (~6 min on 8 cores, a few
GiB): ``JAX_PLATFORMS=cpu python3 tools/torch_eval_finite.py [--out
FILE]``. ``--size`` and ``--batch`` cut the input for a rehearsal only: at
a smaller size the forward may not overflow at all. With ``--device cuda``
(on the card, no JAX) it runs the port's routes there instead: a, the
kernels in bf16 (kernel 1 in eval, kernels 2 and 3 in the train forwards),
b-bf16 (the same stages' plain versions on the card) and the kernels in
f32 (kernel 1's f32 route in eval, kernels 2 and 3 in f32 in the train
forwards).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ssunet_gan_tpu_torch.config import load_experiment_config  # noqa: E402
from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset  # noqa: E402
from ssunet_gan_tpu_torch.data.transforms import val_transform  # noqa: E402
from ssunet_gan_tpu_torch.infer.api import _norm_consts  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model, ssunet  # noqa: E402

STAGES = ("0_0", "1_0", "2_0", "3_0", "4_0", "5_0", "4_1", "3_1", "2_1", "1_1", "0_1")


def _finite_stats(a: np.ndarray) -> dict:
    fin = np.isfinite(a)
    top = float(np.abs(a[fin]).max()) if fin.any() else float("nan")
    return {"not_finite": float(1.0 - fin.mean()), "max_finite": top}


class _Trace:
    """Stage outputs in execution order and the first op (a module's
    output) that is not finite."""

    def __init__(self):
        self.stages, self.first_op = {}, None

    def op(self, name: str, out) -> None:
        if self.first_op is None and not bool(np.isfinite(np.asarray(out, np.float32)).all()):
            self.first_op = name

    def stage(self, name: str, out) -> None:
        self.stages[name] = _finite_stats(np.asarray(out, np.float32))

    def first_stage(self):
        return next((k for k, v in self.stages.items() if v["not_finite"] > 0), None)


def _batch(opt, size, n, seed) -> np.ndarray:
    ds = SyntheticDataset(n, size, size, opt["num_classes"], opt["input_channels"],
                          transform=val_transform(opt), seed=seed)
    return np.stack([ds[i][1] for i in range(n)]).astype(np.float32)


def _port_model(opt, size, dev):
    model = build_model(opt["arch"], opt["num_classes"], opt["input_channels"],
                        opt["deep_supervision"], seed=chip_smoke.SEED, device=dev)
    a, b = _norm_consts()
    calib = np.random.default_rng(chip_smoke.SEED + 2).integers(
        0, 256, (2, size, size, opt["input_channels"]), dtype=np.uint8)
    calib = torch.from_numpy(calib).to(dev).float() * a.to(dev) + b.to(dev)
    chip_smoke.calibrate_batchnorm(model, calib)
    return model.eval()


def _port_forward(model, x, dtype, stage_fn, train: bool, trace=None, ctx=contextlib.nullcontext):
    """One forward of the port's model through ``stage_fn`` (every stage
    patched through it), traced per stage and per module (a module's
    output is read after its children's, as JAX's below)."""
    hooks = []
    if trace is not None:
        for name, m in model.named_modules():
            if name:
                hooks.append(m.register_forward_hook(
                    lambda m, i, o, name=name: trace.op(name, o.float().cpu().numpy())))

    def stage(parts, block, spade, final=None, name=None, **kw):
        out = stage_fn(parts, block, spade, final, name=name, **kw)
        if trace is not None:
            o = out.float().cpu().numpy()
            trace.op(f"{name} (stage output)", o)
            trace.stage(name[4:], o)
        return out

    model.train(train)
    try:
        with torch.no_grad(), chip_smoke.spade_stages_as(stage), ctx():
            dev = next(model.parameters()).device
            return model(torch.from_numpy(x).to(dev, dtype)).float().cpu().numpy()
    finally:
        model.eval()
        for h in hooks:
            h.remove()


def _jax_forward(model, variables, x, train: bool, trace=None):
    """The JAX model's f32 forward (eager, so each module's output can be
    read as it is made); returns (logits, variables after it)."""
    import jax.numpy as jnp
    from flax import linen as nn

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if trace is not None and context.method_name == "__call__" and hasattr(out, "shape"):
            path = "/".join(context.module.scope.path)
            trace.op(path, out)
            top = context.module.scope.path[0] if context.module.scope.path else ""
            if len(context.module.scope.path) == 1 and top.startswith("SPADE"):
                trace.stage(top[5:], out)
            if path == "final":
                trace.stage("0_1", out)
        return out

    with nn.intercept_methods(intercept):
        if train:
            out, upd = model.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
            variables = {**variables, **upd}
        else:
            out = model.apply(variables, jnp.asarray(x), False)
    return np.asarray(out, np.float32), variables


def _port_routes(dev):
    """(dtype, stage function, context) of each port route on ``dev``."""
    if dev.type == "cpu":
        return {"a": (torch.float32, chip_smoke.module_stage, contextlib.nullcontext),
                "b-bf16": (torch.bfloat16, ssunet.spade_stage, contextlib.nullcontext),
                "b-f32": (torch.float32, ssunet.spade_stage, contextlib.nullcontext)}

    @contextlib.contextmanager
    def plain():  # the fused stages' plain versions on the card, eval and train
        with chip_smoke.patched(ssunet, "fused_eval_stage", chip_smoke.plain_stage), \
                chip_smoke.plain_train_kernels():
            yield

    return {"a": (torch.float32, chip_smoke.module_stage, contextlib.nullcontext),
            "kernels-bf16": (torch.bfloat16, ssunet.spade_stage, contextlib.nullcontext),
            "b-bf16": (torch.bfloat16, ssunet.spade_stage, plain),
            "kernels-f32": (torch.float32, ssunet.spade_stage, contextlib.nullcontext)}


def run(size: int, batch: int, dev: torch.device) -> dict:
    cfg = load_experiment_config(os.path.join(HERE, "configs", "config_v1.json"))
    opt = cfg.opt_config
    t0 = time.perf_counter()
    port = _port_model(opt, size, dev)
    snapshot = copy.deepcopy(port.state_dict())
    xs = {s: _batch(opt, size, batch, s) for s in (1, 2, chip_smoke.STEP1_BATCHES + 1)}
    xv = xs[chip_smoke.STEP1_BATCHES + 1]
    results, stats = {}, {}
    for key, (dtype, fn, ctx) in _port_routes(dev).items():
        for n in (0, 2):
            port.load_state_dict(snapshot)
            for s in range(1, n + 1):
                _port_forward(port, xs[s], dtype, fn, True, ctx=ctx)
            trace = _Trace()
            logits = _port_forward(port, xv, dtype, fn, False, trace, ctx)
            results[(key, n)] = dict(_finite_stats(logits), first_stage=trace.first_stage(),
                                     first_op=trace.first_op, stages=trace.stages)
            stats[(key, n)] = {k: v.detach().cpu().clone() for k, v in port.state_dict().items()
                               if "running" in k}
            print(f"route {key}, {n} train forwards: {_line(results[(key, n)])} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    if dev.type == "cpu":
        port.load_state_dict(snapshot)
        _jax_route(opt, port, xs, xv, results, stats, t0)
    return {"size": size, "batch": batch, "device": str(dev),
            "seconds": time.perf_counter() - t0,
            "results": {f"{k} after {n}": v for (k, n), v in results.items()},
            "verdict": decide(results) if dev.type == "cpu" else None}


def _jax_route(opt, port, xs, xv, results, stats, t0) -> None:
    """Route c: the JAX package's f32 forward of the port's weights, its
    fused stages off, its train forwards in JAX as well."""
    import jax
    import jax.numpy as jnp

    from ssunet_gan_tpu.compat import convert_torch_state_dict
    from ssunet_gan_tpu.models import build_model as jax_build_model
    from ssunet_gan_tpu.ops import stage_kernel as jax_stage_kernel
    from ssunet_gan_tpu.ops import stage_kernel_train as jax_stage_kernel_train

    saved = (jax_stage_kernel._FUSED_STAGE, jax_stage_kernel_train._FUSED_TRAIN)
    jax_stage_kernel.set_fused_stage(False)
    jax_stage_kernel_train.set_fused_train(False)
    try:
        jmodel = jax_build_model(opt["arch"], num_classes=opt["num_classes"],
                                 input_channels=opt["input_channels"])
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, opt["input_channels"])), train=False))
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        jvars0, report = convert_torch_state_dict(
            {k: v.numpy() for k, v in port.state_dict().items()}, template)
        if report["unmatched"] or report["skipped"]:
            raise RuntimeError(f"the port's weights do not map onto the JAX model: {report}")
        for n in (0, 2):
            jvars = jvars0
            for s in range(1, n + 1):
                _, jvars = _jax_forward(jmodel, jvars, xs[s], True)
            trace = _Trace()
            logits = _jax_forward(jmodel, jvars, xv, False, trace)[0]
            results[("c", n)] = dict(_finite_stats(logits), first_stage=trace.first_stage(),
                                     first_op=trace.first_op, stages=trace.stages)
            if n:
                # the JAX train forwards' statistics against route a's
                back, _ = convert_torch_state_dict(
                    {k: v.numpy() for k, v in stats[("a", n)].items()}, template)
                pairs = [(np.asarray(u, np.float64), np.asarray(v, np.float64)) for u, v in zip(
                    jax.tree_util.tree_leaves(jvars["batch_stats"]),
                    jax.tree_util.tree_leaves(back["batch_stats"]))]
                num = sum(float(((u - v) ** 2).sum()) for u, v in pairs)
                den = sum(float((v ** 2).sum()) for _, v in pairs)
                results[("c", n)]["stats_rel_l2_vs_a"] = (num / max(den, 1e-300)) ** 0.5
            print(f"route c, {n} train forwards: {_line(results[('c', n)])} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    finally:
        jax_stage_kernel.set_fused_stage(saved[0])
        jax_stage_kernel_train.set_fused_train(saved[1])


def _line(r: dict) -> str:
    return (f"logits not finite {r['not_finite']:.4f}, max |finite| {r['max_finite']:.4g}; "
            f"first non-finite stage {r['first_stage']}, op {r['first_op']}")


def decide(results: dict) -> dict:
    """Each port route against c: the same first non-finite stage (or none
    on both sides), and each stage's output finite on both or on neither."""
    verdict = {}
    for key in ("a", "b-bf16", "b-f32"):
        for n in (0, 2):
            r, c = results[(key, n)], results[("c", n)]
            same_stage = r["first_stage"] == c["first_stage"]
            same_classes = all((r["stages"][s]["not_finite"] > 0) == (c["stages"][s]["not_finite"] > 0)
                               for s in STAGES if s in r["stages"] and s in c["stages"])
            verdict[f"{key} after {n}"] = bool(same_stage and same_classes)
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=None, help="input side (default: the config's)")
    ap.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    ap.add_argument("--device", default="cpu",
                    help="cpu (routes a, b-bf16, b-f32 and JAX's c) or cuda (the port's "
                         "routes on the card: a, kernels-bf16, b-bf16, kernels-f32; no JAX)")
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args()
    opt = load_experiment_config(os.path.join(HERE, "configs", "config_v1.json")).opt_config
    size = args.size or int(opt["input_h"])
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    res = run(size, args.batch, dev)
    for name, r in res["results"].items():
        print(f"{name}: " + ", ".join(f"{s} {v['max_finite']:.3g}/{v['not_finite']:.3f}"
                                      for s, v in r["stages"].items()))
    if res["verdict"] is not None:
        print("agrees with c (first non-finite stage and each stage's class): "
              + json.dumps(res["verdict"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
