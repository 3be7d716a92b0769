"""Profiling helpers: wall clock, ``torch.profiler`` traces and sustained
throughput (port of ``tpu_montecarlo/utils/profiling.py``).

``trace`` records the host and, where a card is present, the device
with ``torch.profiler`` and writes a Chrome trace (open it in Perfetto
or ``chrome://tracing``); the JAX package's uses ``jax.profiler``.
``measure_throughput`` synchronises by copying every output to the host:
PyTorch returns before the device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch

__all__ = ["timed", "trace", "measure_throughput"]


@contextlib.contextmanager
def timed(label: str = "block") -> Iterator[dict]:
    """Wall-clock a block; the dict gains 'seconds' on exit.

    >>> with timed("integrate") as t:
    ...     integrator.integrate(...)
    >>> t["seconds"]
    """
    rec = {"label": label}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block, CPU and (where a
    CUDA device is present) CUDA activities, and write it to
    ``log_dir`` as a Chrome trace, ``trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.perf_counter_ns()}.json"))


def _to_host(out) -> None:
    """Copies every tensor of ``out`` (a tensor, or a tuple, list or dict
    of them) to the host, which waits for the device's work on it."""
    if isinstance(out, torch.Tensor):
        out.cpu()
    elif isinstance(out, (tuple, list)):
        for o in out:
            _to_host(o)
    elif isinstance(out, dict):
        for o in out.values():
            _to_host(o)
    else:
        np.asarray(out)


def measure_throughput(
    fn: Callable[[int], object],
    work_per_call: int,
    repeats: int = 5,
    warmup: int = 1,
) -> float:
    """Sustained work-units/sec of ``fn(rep)``.

    ``fn`` returns its outputs (tensors, or tuples, lists or dicts of
    them, or anything ``np.asarray`` takes); each is copied to the host
    (``.cpu()``), which waits for the device to finish it."""
    for i in range(warmup):
        _to_host(fn(i))
    t0 = time.perf_counter()
    outs = [fn(warmup + rep) for rep in range(repeats)]
    for out in outs:
        _to_host(out)
    dt = time.perf_counter() - t0
    return work_per_call * repeats / dt
