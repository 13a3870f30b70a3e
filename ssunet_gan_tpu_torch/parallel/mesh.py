"""The data mesh over ``torch.distributed`` (the JAX package's
parallel/mesh.py).

The JAX package puts its devices on a ``data`` mesh axis and lets XLA (or,
for the fused train kernels, ``shard_map`` with explicit collectives) split
every batch over it. Here one process drives one device, and a
:class:`Mesh` names the process group the data axis spans: each rank takes
its contiguous slice of every global batch (:func:`shard_batch`), the
parameters start equal on every rank (:func:`replicate`), and the steps of
``train/`` reduce what crosses the batch through ``ops/collectives.py``.

A ``model`` axis (channels split over devices) is not ported: no JAX code
shards anything on it (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.ops import collectives
from ssunet_gan_tpu_torch.ops.collectives import check_device


@dataclass(frozen=True)
class Mesh:
    """A ``data`` axis over ``group``'s ranks; ``group`` is None for a world
    of one process without a process group."""

    group: Optional[Any]
    shape: Dict[str, int] = field(default_factory=lambda: {"data": 1, "model": 1})
    rank: int = 0
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        check_mesh(self)

    @property
    def size(self) -> int:
        return self.shape["data"]


def check_mesh(mesh: Mesh) -> Mesh:
    """``mesh``, after refusing a ``model`` axis of more than one device."""
    if mesh.shape.get("model", 1) != 1:
        raise NotImplementedError(
            f"a model axis of {mesh.shape['model']} (channels split over devices) is "
            "not ported; see ROADMAP.md")
    return mesh


def _group_device(group) -> torch.device:
    """The device a rank's tensors live on under ``group``'s backend: its
    current card under NCCL, the CPU under any other."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None) -> Mesh:
    """The ``("data", "model")`` mesh over ``group`` (the default process
    group when None). Without an initialized process group it is a world of
    one on the card where one is present, else the CPU, as the JAX
    ``make_mesh`` on the default backend's one device. ``n_data`` must be
    the group's size; ``n_model > 1`` raises."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        size, rank, dev = dist.get_world_size(group), dist.get_rank(group), _group_device(group)
    elif group is not None:
        raise ValueError("a group was given but no process group is initialized")
    else:
        size, rank = 1, 0
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if n_data is not None and n_data != size:
        raise ValueError(f"mesh of {n_data} on the data axis, but the group has {size} ranks")
    return Mesh(group, {"data": size, "model": n_model}, rank, dev)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's contiguous slice of dim 0 of every tensor or array in
    ``batch`` (a tensor, array, or tuple / list of them), as ``P("data")``.
    The batch must divide by the data axis (the trainers round it)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def replicate(mesh: Mesh, module_or_tensors):
    """Rank 0's parameters and buffers (of a module), or tensors, broadcast
    to every rank in place; returns its argument."""
    if mesh.group is None:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.state_dict().values())
    else:
        tensors = list(module_or_tensors)
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(check_device(t, mesh.group), src, group=mesh.group)
    return module_or_tensors


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda") -> Mesh:
    """``dist.init_process_group`` and the global data mesh (the JAX
    package's ``jax.distributed.initialize`` + ``make_mesh``).

    With no arguments it reads what ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` override them. On ``device="cuda"`` each process takes
    the card of its ``LOCAL_RANK`` under NCCL; on the CPU the group is gloo.
    """
    cuda = resolve_device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, **kwargs)
    return make_mesh()


def sharded_step(mesh: Optional[Mesh]):
    """The per-rank body of a data-parallel step (the JAX package's
    ``shard_map`` body): a context in which every reduction over the batch
    (SyncBN, the fused train stages' sums, the metrics) crosses the mesh's
    ranks. Without a mesh it does nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    return collectives.train_axis(mesh.group, mesh.size)


def average_gradients(mesh: Mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Every ``.grad`` replaced by its mean over the ranks (JAX's ``pmean``
    of the gradient tree): one all-reduce over a flat buffer per dtype."""
    if mesh.group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = collectives.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh.group)
        flat /= mesh.size
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def pmean_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over the ranks, in one all-reduce."""
    if mesh.group is None:
        return metrics
    keys = list(metrics)
    flat = collectives.all_reduce_(torch.stack([metrics[k].float() for k in keys]),
                                   mesh.group) / mesh.size
    return dict(zip(keys, flat.unbind()))
