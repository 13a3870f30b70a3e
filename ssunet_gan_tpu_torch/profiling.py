"""Tracing and timing helpers (the JAX package's profiling.py) on
``torch.profiler``:

- :func:`trace`: a context manager that records the host and, where a card
  is present, its kernels, and writes a Chrome trace (``trace.json``, for
  chrome://tracing or Perfetto) into ``log_dir``;
- :func:`annotate`: a named span inside a trace
  (``torch.profiler.record_function``);
- :func:`time_fn`: the wall time of a callable, its first call (kernel
  builds included) apart from the steady state, the device synchronized
  around each timed region (the counterpart of ``time_jitted``);
- :class:`StepTimer`: running steps/s and items/s for train loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed code; on exit write ``<log_dir>/trace.json``.
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named span inside a trace (shows up on the host timeline)."""
    return torch.profiler.record_function(name)


def _devices(out, found=None) -> set:
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dicts)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for o in out:
            _devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _devices(o, found)
    return found


def _wait(out) -> None:
    for dev in _devices(out):
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: the first call (kernels built and
    loaded there), ``warmup − 1`` more untimed, then ``iters`` calls, each
    timed region ending when the devices of ``fn``'s output tensors are
    idle. Returns {'compile_s', 'mean_s', 'per_sec'}."""
    t0 = time.perf_counter()
    _wait(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _wait(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _wait(out)
    mean_s = (time.perf_counter() - t0) / iters
    return {"compile_s": compile_s, "mean_s": mean_s, "per_sec": 1.0 / mean_s}


class StepTimer:
    """Running throughput meter for train loops (steps/sec, items/sec)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self.steps = 0
        self.items = 0

    def update(self, n_items: int = 0) -> None:
        self.steps += 1
        self.items += n_items

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def items_per_sec(self) -> float:
        return self.items / max(self.elapsed, 1e-9)
