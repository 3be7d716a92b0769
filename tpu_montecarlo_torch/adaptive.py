"""VEGAS-style adaptive importance sampling: learn the proposal (port of
``tpu_montecarlo/adaptive.py``).

:func:`adapt_proposal` refines a piecewise grid proposal by the classic
VEGAS iteration (Lepage 1978): it starts uniform over the target's
support, each iteration samples it, measures where the weighted
integrand's square lands, and re-draws the grid so every bin carries
equal importance.  The result is an ordinary :class:`Distribution` (a
pdf/cdf table), so the production run takes the existing importance-
sampling path in kernel 1 (nd: kernel 2): adapt once at ~1e5 samples,
then integrate at 1e9 with the learned proposal.

Each iteration is torch operations on the chosen device (the JAX
package jits one XLA program, not a Pallas kernel): piecewise-uniform
draws from the edges (bin ``i = floor(u * N)``, linear within), the
weight ``f p / q`` with ``log p`` from the port's closed-form log
densities (a CUSTOM target's from its log table, as
``jnp.interp``), and a per-bin sum of the weighted square
(``index_add_``).  The uniforms are the port's counter stream,
``CounterRng(seed + 0x9E3779B9 * it, j)`` for iteration ``it`` and
dimension ``j``, so the CPU and the card draw the same points (the JAX
package's ``jax.random`` keys differ).  Only the O(grid_size) grid
rebuild runs on the host, in float64.

Multi-dimensional targets adapt a separable grid per dimension (the
classic VEGAS factorisation) from the same sweep and return one proposal
Distribution per dimension for the nd importance-sampling path.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch

from .api.base import resolve_device
from .distributions import Distribution
from .ops.integrate_kernel import CounterRng, uniform_halfopen01
from .ops.lower import to_torch
from .ops.mcmc_tables import KnotTable, log_table_value
from .ops.qmc import MASK32
from .sampling import DistKind, analytic_log_pdf, dist_spec_of
from .tracing import trace_function

__all__ = ["adapt_proposal"]


def _support_of(target: Distribution, tail: float = 1e-5):
    """Adaptation range: the table span for CUSTOM targets, a
    central-(1 - 2*tail) quantile interval for analytic families (the
    grid will shrink unused tails away on its own)."""
    spec = dist_spec_of(target)
    if spec.kind == DistKind.CUSTOM:
        lo, hi = target.params["support"]
        return float(lo), float(hi)
    return float(target.quantile(tail)), float(target.quantile(1.0 - tail))


def _rebuild_edges(edges: np.ndarray, d_sq: np.ndarray, alpha: float):
    """One VEGAS grid refinement: smooth the per-bin importance, damp it
    with the classic ``((r - 1) / ln r)^alpha`` compression, and re-draw
    the edges so every new bin carries equal damped importance."""
    n = len(edges) - 1
    d = np.asarray(d_sq, np.float64)
    # 3-point smoothing (Lepage's): stabilises empty/noisy bins.
    sm = np.empty_like(d)
    sm[0] = (2.0 * d[0] + d[1]) / 3.0
    sm[-1] = (d[-2] + 2.0 * d[-1]) / 3.0
    if n > 2:
        sm[1:-1] = (d[:-2] + d[1:-1] + d[2:]) / 3.0
    tot = sm.sum()
    if not tot > 0:
        return edges  # nothing measured (f == 0 everywhere): keep grid
    r = np.maximum(sm / tot, 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = ((r - 1.0) / np.log(r)) ** alpha
    m = np.where(np.abs(r - 1.0) < 1e-12, 1.0, m)
    # Floor: no bin may collapse to zero width — the learned proposal
    # must stay strictly positive wherever the target lives.
    m = np.maximum(m, 1e-4 * m.mean())
    # Equal-importance re-draw: the new edge k sits where the cumulative
    # damped importance (piecewise-linear in x within old bins) reaches
    # k/n of the total.
    cum = np.concatenate([[0.0], np.cumsum(m)])
    targets = np.arange(1, n, dtype=np.float64) * (cum[-1] / n)
    idx = np.searchsorted(cum, targets, side="right") - 1
    idx = np.clip(idx, 0, n - 1)
    frac = (targets - cum[idx]) / np.maximum(m[idx], 1e-300)
    new_inner = edges[idx] + frac * (edges[idx + 1] - edges[idx])
    out = np.concatenate([[edges[0]], new_inner, [edges[-1]]])
    # Monotonic guard against float round-off in dense regions.
    return np.maximum.accumulate(out)


def _proposal_from_edges(edges: np.ndarray) -> Distribution:
    """The learned proposal as a Distribution: the equal-mass-per-bin
    density ``1 / (n * width_i)``.

    Adjacent adapted bins can differ in density by orders of magnitude,
    and a piecewise-LINEAR pdf through single edge knots would smear
    those steps badly enough to decouple the table pdf from the density
    the inverse-CDF machinery actually samples (measured: mean IS
    weight 0.70 instead of 1).  So each interior edge gets a PAIR of
    knots a sliver apart carrying the left and right bin densities —
    the pdf is exactly constant inside every bin, the trapezoid CDF is
    exact up to the sliver mass (~1e-3 relative), and table IS weights
    come out consistent."""
    n = len(edges) - 1
    w = np.diff(edges).astype(np.float64)
    dens = 1.0 / (n * w)
    delta = 5e-4 * np.minimum(w[:-1], w[1:])  # interior-edge slivers
    xs = [np.float64(edges[0])]
    ps = [dens[0]]
    for j in range(1, n):
        xs.extend([edges[j] - delta[j - 1], edges[j] + delta[j - 1]])
        ps.extend([dens[j - 1], dens[j]])
    xs.append(np.float64(edges[-1]))
    ps.append(dens[-1])
    x_arr = np.asarray(xs, np.float64)
    # Float32 rounding downstream must keep the knots strictly
    # ascending: drop any pair collapsed by rounding (keep the first).
    x32 = x_arr.astype(np.float32)
    keep = np.concatenate([[True], np.diff(x32) > 0])
    return Distribution.from_pdf_table(
        x32[keep], np.asarray(ps, np.float64)[keep]
    )


def _log_density(target: Distribution, device) -> Callable:
    """``x -> log p(x)``, float32, on ``device``: the closed form
    (``sampling.analytic_log_pdf``), or a CUSTOM target's log table
    interpolated over its x grid, -100 off it (the JAX package's
    ``log_pdf`` with ``uniform=False``, ``jnp.interp``)."""
    spec = dist_spec_of(target)
    if spec.kind == DistKind.CUSTOM:
        table = KnotTable.of(*target.get_log_pdf_table(), device)
        return lambda x: log_table_value(x, table)
    p1, p2 = (torch.tensor(v, dtype=torch.float32, device=device)
              for v in spec.params)
    return lambda x: analytic_log_pdf(spec.kind, p1, p2, x)


def adapt_proposal(
    function: Union[Callable, str],
    target_distribution,
    n_iterations: int = 6,
    n_samples: int = 131_072,
    grid_size: int = 256,
    alpha: float = 1.5,
    seed: int = 42,
    support=None,
    return_history: bool = False,
    device="cuda",
):
    """Learn an importance-sampling proposal for ``E_p[f(X)]`` by VEGAS
    grid adaptation and return it as a :class:`Distribution` (a list of
    per-dimension Distributions for multi-dimensional targets) ready for
    :func:`integrate_importance_sampling`'s table path.

    ``function`` is the integrand whose weighted square drives the
    refinement (adapt on your most important / most peaked integrand;
    the returned proposal serves any function list).
    ``target_distribution`` is one Distribution or a sequence (one per
    argument of ``function``).  ``support`` optionally overrides the
    adaptation range — one (lo, hi) pair or a per-dimension list
    (default: the table span for CUSTOM targets, the central 99.998%
    quantile interval for analytic families).

    ``return_history=True`` additionally returns a dict with the
    per-iteration raw estimates and standard errors of ``E_p[f]`` —
    watch the stderr column fall as the grid locks on — and, in the
    port, ``"edges"``: each dimension's final grid edges (float64).

    ``device``: ``"cuda"`` (the default) runs each iteration on the card,
    ``"cpu"`` on the host; both draw the same points."""
    if isinstance(target_distribution, (list, tuple)):
        targets = list(target_distribution)
        if not targets or not all(
            isinstance(t, Distribution) for t in targets
        ):
            raise TypeError(
                "target_distribution sequence must be a non-empty list "
                "of Distribution objects"
            )
    elif isinstance(target_distribution, Distribution):
        targets = [target_distribution]
    else:
        raise TypeError(
            "target_distribution must be a Distribution or a sequence "
            f"of them, got {type(target_distribution)}"
        )
    d = len(targets)
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    if grid_size < 2:
        raise ValueError(f"grid_size must be >= 2, got {grid_size}")
    if n_samples < grid_size:
        raise ValueError(
            f"n_samples={n_samples} cannot resolve grid_size={grid_size}"
        )
    if not alpha > 0:
        raise ValueError(f"alpha must be positive, got {alpha}")

    traced = trace_function(function, d)

    if support is None:
        ranges = [_support_of(t) for t in targets]
    elif isinstance(support[0], (list, tuple, np.ndarray)):
        if len(support) != d:
            raise ValueError(
                f"support has {len(support)} pairs but the target has "
                f"{d} dimension(s)"
            )
        ranges = [(float(lo), float(hi)) for lo, hi in support]
    else:
        ranges = [(float(support[0]), float(support[1]))] * d
    for lo, hi in ranges:
        if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
            raise ValueError(
                f"adaptation support must be finite with lo < hi, got "
                f"({lo}, {hi})"
            )

    dev = resolve_device(device)
    f = to_torch(traced)
    log_ps = [_log_density(t, dev) for t in targets]
    n_bins = int(grid_size)
    n = int(n_samples)

    def one_iter(word: int, edges_t):
        """The per-bin sums of the weighted square, one (n_bins,) tensor
        per dimension, and the means of g and g^2."""
        xs, idxs = [], []
        log_q = 0.0
        for j in range(d):
            u = uniform_halfopen01(CounterRng(word, j, device=dev), (1, n))[0]
            s = u * float(n_bins)
            i = torch.clamp(s.to(torch.int32), 0, n_bins - 1).long()
            frac = s - i.to(torch.float32)
            e = edges_t[j]
            lo = e[i]
            w = e[i + 1] - lo
            xs.append(lo + frac * w)
            idxs.append(i)
            log_q = log_q - torch.log(float(n_bins) * w)
        log_p = 0.0
        for j in range(d):
            log_p = log_p + log_ps[j](xs[j])
        g = f(*xs).to(torch.float32) * torch.exp(log_p - log_q)
        g2 = g * g
        dsums = [torch.zeros(n_bins, dtype=torch.float32, device=dev)
                 .index_add_(0, idxs[j], g2) for j in range(d)]
        return dsums, g.mean(), g2.mean()

    edges = [
        np.linspace(lo, hi, n_bins + 1, dtype=np.float64)
        for lo, hi in ranges
    ]
    history = {"estimate": [], "stderr": []}
    for it in range(n_iterations):
        word = (int(seed) + 0x9E3779B9 * it) & MASK32
        dsums, mean_g, mean_g2 = one_iter(
            word, [torch.from_numpy(e.astype(np.float32)).to(dev)
                   for e in edges])
        mean_g = float(mean_g)
        var_g = max(float(mean_g2) - mean_g * mean_g, 0.0)
        history["estimate"].append(mean_g)
        history["stderr"].append(math.sqrt(var_g / n))
        for j in range(d):
            edges[j] = _rebuild_edges(
                edges[j], dsums[j].cpu().numpy().astype(np.float64), alpha
            )

    dists = [_proposal_from_edges(e) for e in edges]
    result = dists[0] if d == 1 else dists
    if return_history:
        history["edges"] = edges
        return result, history
    return result
