"""Multi-pass runs over more functions than one launch takes (port of the
JAX package's multi-pass path, ``tpu_montecarlo/api/integrate.py:
1001-1098``): a set of K functions splits, in order, into
``ceil(K / most)`` groups of ``ceil(K / groups)``, and each group is one
launch of the kernel the set would take, over the identical
counter-keyed stream (the same seed words, grid, pilot rule and tables).
The integrate kernels fuse 128 functions, the 1-D and nd MCMC kernels
127 and the tempered kernel 126; every pass of an MCMC set runs the same
chains, which :func:`check_same_chains` holds.

A group's library is built, and launched, as a single launch over that
group would build and launch it: a pass takes no other route."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np
import torch

__all__ = ["build_all", "cat_passes", "check_same_chains", "merge_results",
           "split_groups"]


def split_groups(fns: Sequence, most: int) -> List[tuple]:
    """``fns`` in order as ``ceil(K / most)`` groups of ``ceil(K /
    groups)`` (the last may be smaller): one group when K <= most."""
    n_groups = -(-len(fns) // most)
    size = -(-len(fns) // n_groups)
    return [tuple(fns[i:i + size]) for i in range(0, len(fns), size)]


def build_all(builds: Sequence[Callable]) -> list:
    """Runs each build (a group's library) and returns their results, in
    parallel threads where there are several: one nvcc per group, as
    many at once as the host has cores.  A build that fails raises
    here."""
    if len(builds) == 1:
        return [builds[0]()]
    workers = min(len(builds), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(b) for b in builds]
        return [f.result() for f in futures]


def cat_passes(outs: list, first_of: Sequence[int] = ()):
    """The passes' outputs as one: each a tensor with the functions on its
    last axis, or a tuple of such tensors (or None), concatenated element
    by element; the tuple elements at ``first_of`` (an MCMC set's
    acceptance, swap rate and draws) are the first pass's."""
    first = outs[0]
    if len(outs) == 1:
        return first
    if not isinstance(first, tuple):
        return torch.cat(outs, dim=-1)
    return tuple(
        first[i] if i in first_of or first[i] is None
        else torch.cat([o[i] for o in outs], dim=-1)
        for i in range(len(first)))


def check_same_chains(outs, ks: Sequence[int], swap: bool = False) -> None:
    """RuntimeError unless every pass of an MCMC set ran the first pass's
    chains: the same final states and, block by block, the same accept
    counts (and a tempered run's swap counts), bit for bit.  ``outs`` are
    the passes' :class:`~tpu_montecarlo_torch.ops.mcmc_kernel.McmcOutput`,
    ``ks`` their function counts."""
    first, k0 = outs[0], ks[0]
    cols = slice(k0, k0 + 1 + int(swap))
    for g, (out, k) in enumerate(zip(outs[1:], ks[1:]), start=1):
        same = torch.equal(out.x_final, first.x_final) and torch.equal(
            out.rows[..., 0, k:k + 1 + int(swap)], first.rows[..., 0, cols])
        if same and first.samples is not None:
            same = torch.equal(out.samples, first.samples)
        if not same:
            raise RuntimeError(
                f"pass {g} of a multi-pass MCMC run did not run the first "
                "pass's chains (final states, accept or swap counts, or "
                "draws differ)")


def merge_results(results):
    """One :class:`IntegrationResult` of an MCMC set's passes: the values,
    error bars, split-R-hat and ESS concatenated; the acceptance, a
    tempered run's swap rate, the draws and the chain state the first
    pass's (every pass runs the same chains)."""
    first = results[0]
    if len(results) == 1:
        return first

    def cat(get):
        parts = [get(r) for r in results]
        return None if parts[0] is None else np.concatenate(parts)

    diagnostics = first.diagnostics
    if diagnostics is not None:
        diagnostics = dict(diagnostics)
        for key in ("r_hat", "ess"):
            if key in diagnostics:
                diagnostics[key] = cat(lambda r, key=key: r.diagnostics[key])
    first.values = cat(lambda r: r.values)
    first.stderr = cat(lambda r: r.stderr)
    first.n_functions = len(first.values)
    first.diagnostics = diagnostics
    return first
