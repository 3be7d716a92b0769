"""Workload planning: how many samples a request really draws.

Port of ``tpu_montecarlo/utils/dispatch.py``.  The plan keeps the
reference's equal-weight, rounded-up semantics: ``actual_samples >=
n_samples`` and every estimate divides by ``actual_samples``.  The kernel
grid (``ops/integrate_kernel.plan_grid``) is derived from the plan, so both
packages draw the same sample stream only when they plan with the same
``max_chunk_elems``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "DEFAULT_MAX_CHUNK_ELEMS",
    "DEFAULT_TARGET_THREADS",
    "IntegratePlan",
    "make_integrate_plan",
    "round_up",
]

# Reference defaults: target 65,536 threads, rounded to a multiple of 256.
DEFAULT_TARGET_THREADS = 65_536
_LANE_MULTIPLE = 256
# The JAX package asks its backend: 1 << 27 on the TPU, 1 << 22 elsewhere.
# The port has no backend to ask and takes the TPU value, so its default
# plans match the plans the TPU ran (tests pass the CPU value explicitly
# when they hold the port against the JAX package on the CPU).
DEFAULT_MAX_CHUNK_ELEMS = 1 << 27


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class IntegratePlan:
    """Static integration workload description (part of the cache key)."""

    total_threads: int  # lane width of one chunk
    loops_per_chunk: int  # sample rows per chunk
    n_chunks: int
    actual_samples: int  # total_threads * loops_per_chunk * n_chunks >= n

    @property
    def chunk_elems(self) -> int:
        return self.total_threads * self.loops_per_chunk


def make_integrate_plan(
    n_samples: int,
    target_threads: int | None = None,
    max_chunk_elems: int = DEFAULT_MAX_CHUNK_ELEMS,
) -> IntegratePlan:
    """Plan the chunked sample sweep (single device).

    ``target_threads`` is the reference API's lane-width knob, rounded up
    to a multiple of 256; the planner groups as many loops per chunk as fit
    in ``max_chunk_elems``."""
    if n_samples <= 0:
        raise ValueError("n_samples must be positive")
    total_threads = round_up(
        target_threads or DEFAULT_TARGET_THREADS, _LANE_MULTIPLE
    )
    loops = -(-n_samples // total_threads)
    loops_per_chunk = max(1, min(loops, max_chunk_elems // total_threads))
    n_chunks = -(-loops // loops_per_chunk)
    actual = total_threads * loops_per_chunk * n_chunks
    return IntegratePlan(total_threads, loops_per_chunk, n_chunks, actual)
