"""Shared code of the other model families' tests (``test_torch_unet_families.py``,
``test_torch_effnet.py``, ``test_torch_xblocks.py``): a port module's state
drawn from seeded numpy, its ``state_dict`` carried onto the JAX module's
variables by the JAX package's ``convert_torch_state_dict`` (every leaf
written, nothing unmatched, nothing skipped but ``num_batches_tracked``)
and back by the port's ``from_jax_variables`` onto exactly its own keys,
and the forwards, the running statistics and one loss's gradients
compared."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssunet_gan_tpu.compat import convert_torch_state_dict
from ssunet_gan_tpu.models import build_model as jax_build_model
from ssunet_gan_tpu.models import efficientnet as jeff
from ssunet_gan_tpu.ops import conv as jconv
from ssunet_gan_tpu_torch.compat import from_jax_variables
from ssunet_gan_tpu_torch.models import build_model

EVAL_TOL = 1e-5  # relative L2 of eval forwards
TRAIN_TOL = 1e-4  # train forwards, running statistics, losses, gradients


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seed_state(module: torch.nn.Module, seed: int) -> None:
    """Every parameter and buffer of ``module`` drawn from numpy: conv and
    linear weights U(±1/√fan_in), biases 0.1·N, BatchNorm scales
    1 + 0.2·N, running means 0.3·N and variances U(0.5, 1.5), spectral u
    and v normalized N."""
    g = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            leaf, shape = name.rsplit(".", 1)[-1], tuple(t.shape)
            if leaf in ("weight", "weight_orig") and len(shape) >= 2:
                bound = 1 / np.sqrt(np.prod(shape[1:]))
                v = g.uniform(-bound, bound, shape)
            elif leaf == "weight":
                v = 1 + 0.2 * g.normal(size=shape)
            elif leaf == "bias":
                v = 0.1 * g.normal(size=shape)
            elif leaf == "running_mean":
                v = 0.3 * g.normal(size=shape)
            elif leaf == "running_var":
                v = g.random(shape) + 0.5
            elif leaf in ("weight_u", "weight_v"):
                v = g.normal(size=shape)
                v = v / np.linalg.norm(v)
            else:
                raise AssertionError(f"no draw for {name}")
            t.copy_(torch.from_numpy(np.asarray(v, np.float32)))


def to_jax(port: torch.nn.Module, jmodel, *args, train: bool = False):
    """The port's state_dict onto ``jmodel``'s variables (shapes from
    ``jax.eval_shape`` of ``init(*args, train)``, every leaf NaN first):
    the report clean and every leaf written. Returns the variables."""
    flag = () if isinstance(jmodel, (jconv.Conv2d, jeff.SamePadConv)) else (train,)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, *flag))
    template = jax.tree_util.tree_map(lambda s: np.full(s.shape, np.nan, np.float32),
                                      dict(shapes))
    sd = {k: v.detach().cpu().numpy() for k, v in port.state_dict().items()}
    variables, report = convert_torch_state_dict(sd, template)
    assert report["unmatched"] == [] and report["missing"] == [], report
    assert all(k.endswith("num_batches_tracked") for k in report["skipped"]), report
    unwritten = [jax.tree_util.keystr(p) for p, v in
                 jax.tree_util.tree_flatten_with_path(variables)[0] if np.isnan(v).any()]
    assert not unwritten, unwritten
    return variables


def assert_round_trip(port: torch.nn.Module, variables) -> None:
    """``from_jax_variables`` with the port as its target gives exactly the
    port's keys and tensors."""
    sd = from_jax_variables(variables, target=port)
    own = port.state_dict()
    assert sorted(sd) == sorted(own), set(sd) ^ set(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v.float().cpu()), k


def outputs(out):
    return [np.asarray(o) for o in out] if isinstance(out, (list, tuple)) else [np.asarray(out)]


def loss_weights(shapes, seed: int):
    g = np.random.default_rng(seed)
    return [g.normal(size=s).astype(np.float32) for s in shapes]


def torch_loss(out, weights):
    """Σ over heads of mean(o·w) + ½·mean(o²)."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum((o * torch.from_numpy(w)).mean() + 0.5 * o.square().mean()
               for o, w in zip(outs, weights))


def jax_loss(out, weights):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum(jnp.mean(o * w) + 0.5 * jnp.mean(jnp.square(o)) for o, w in zip(outs, weights))


def _call(jmodel, variables, args, train, mutable=()):
    """``jmodel.apply``: a conv takes no ``train`` argument."""
    if isinstance(jmodel, (jconv.Conv2d, jeff.SamePadConv)):
        return jmodel.apply(variables, *args), {}
    if mutable:
        return jmodel.apply(variables, *args, train, mutable=list(mutable))
    return jmodel.apply(variables, *args, train), {}


def _torch_args(args):
    return [tuple(torch.from_numpy(p) for p in a) if isinstance(a, tuple) else torch.from_numpy(a)
            for a in args]


def _jax_args(args):
    return [tuple(jnp.asarray(p) for p in a) if isinstance(a, tuple) else jnp.asarray(a)
            for a in args]


def _named_grads(jgrads, variables, port):
    """JAX gradients by the port's parameter names (a spectral-normed
    conv's kernel is ``weight_orig``)."""
    sd = from_jax_variables({"params": jgrads, "spectral": variables.get("spectral", {})},
                            target=port)
    return {n: sd[n] for n, _ in port.named_parameters()}


def _grad_check(port, want, tol, floor, what):
    """Each parameter gradient of ``port`` against ``want`` (by name):
    relative L2 ≤ ``tol``, or within ``floor`` of all gradients' norm.
    Returns the distance of all of them as one vector."""
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(want) == sorted(grads), (what, set(want) ^ set(grads))
    total = np.sqrt(sum(float(w.double().square().sum()) for w in want.values()))
    for n in grads:
        d = float((grads[n].double() - want[n].double()).norm())
        assert d <= tol * float(want[n].double().norm()) or d <= floor * total, (what, n, d)
    names = sorted(grads)
    return rel_l2(np.concatenate([grads[n].numpy().ravel() for n in names]),
                  np.concatenate([want[n].numpy().ravel() for n in names]))


def check_eval(port, jmodel, variables, args, tol, seed, grad_tol=1e-4, grad_floor=1e-4):
    """The eval forwards (``args``: arrays, or tuples of arrays for split-
    concat parts) within ``tol`` relative L2, and the gradients of one loss
    at the running statistics (every parameter within ``grad_tol``, or
    ``grad_floor`` of all gradients' norm: a gradient far smaller than the
    rest is a difference of larger terms). Returns the largest distance."""
    port.eval()
    port.zero_grad(set_to_none=True)
    got = port(*_torch_args(args))
    outs = got if isinstance(got, list) else [got]
    weights = loss_weights([tuple(o.shape) for o in outs], seed)
    torch_loss(got, weights).backward()

    def f(params):
        out = _call(jmodel, {**variables, "params": params}, _jax_args(args), False)[0]
        return jax_loss(out, weights), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    got, want = outputs([o.detach().numpy() for o in outs]), outputs(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    worst = max(rel_l2(g, w) for g, w in zip(got, want))
    assert worst <= tol, worst
    d = _grad_check(port, _named_grads(jgrads, variables, port), grad_tol,
                    grad_floor, "eval gradients")
    assert d <= grad_tol, d
    return max(worst, d)


def check_train(port, jmodel, variables, args, tol, seed, grads: bool = True,
                grad_floor: float = 1e-6, forward_tol=None):
    """The train-mode forward, the running statistics after it (and the
    spectral u, v) and the loss, each against the JAX package's within
    ``tol`` relative L2; with ``grads`` also every parameter gradient
    within ``tol`` (or ``grad_floor`` of all gradients' norm: the conv
    biases ahead of a BatchNorm, 0 analytically). A deep network's
    train-mode gradients are chaotic in f32 (a 1e-7 relative perturbation
    of a full-width U-Net's weights moves them by 0.1-4%, in either
    package), so the models' are held at their blocks (``grads`` here) and
    in eval mode (:func:`check_eval`). ``forward_tol`` (default ``tol``)
    bars the train-mode outputs alone. Returns the largest distance."""
    port.train()
    port.zero_grad(set_to_none=True)
    got = port(*_torch_args(args))
    outs = got if isinstance(got, list) else [got]
    weights = loss_weights([tuple(o.shape) for o in outs], seed)
    loss = torch_loss(got, weights)
    loss.backward()
    mutable = [c for c in ("batch_stats", "spectral") if c in variables]

    def f(params):
        out, upd = _call(jmodel, {**variables, "params": params}, _jax_args(args), True,
                         mutable)
        return jax_loss(out, weights), (out, upd)

    if grads:
        (jl, (jout, upd)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            variables["params"])
    else:
        jl, (jout, upd) = jax.jit(f)(variables["params"])
    fwd = max(rel_l2(g, w) for g, w in zip(outputs([o.detach().numpy() for o in outs]),
                                            outputs(jout)))
    assert fwd <= (tol if forward_tol is None else forward_tol), fwd
    dists = [rel_l2(float(loss.detach()), float(jl))]
    state = from_jax_variables({**variables, **upd}, target=port)
    for k, v in port.state_dict().items():
        if "running" in k or k.endswith(("weight_u", "weight_v")):
            dists.append(rel_l2(v.numpy(), state[k].numpy()))
    if grads:
        dists.append(_grad_check(port, _named_grads(jgrads, variables, port),
                                 tol, grad_floor, "train gradients"))
    worst = max(dists)
    assert worst <= tol, (worst, dists)
    return max(worst, fwd)


def check_family(arch: str, ds: bool) -> None:
    """``build_model(arch, 3, 3, ds)`` at full width on 32² batch 2 against
    the JAX package's model of the same registry name: names both ways,
    the eval forward and gradients, the train-mode forward, running
    statistics and loss (a list of heads compared head by head)."""
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    port = build_model(arch, 3, 3, ds, device="cpu")
    jm = jax_build_model(arch, 3, 3, ds)
    seed_state(port, 8)
    variables = to_jax(port, jm, jnp.asarray(x[:1]))
    assert_round_trip(port, variables)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert (len(out) if isinstance(out, list) else 1) == (4 if ds or arch == "ProgUNet" else 1)
    check_eval(port, jm, variables, [x], EVAL_TOL, 9)
    check_train(port, jm, variables, [x], TRAIN_TOL, 9, grads=False)
