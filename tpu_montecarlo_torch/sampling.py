"""Family codes, packed distribution specs, the sampling transforms and
the closed-form log densities.

Port of the analytic rows and the CUSTOM spec of
``tpu_montecarlo/sampling.py``.  The
transforms are torch functions on float32 tensors; the CUDA kernels
apply the same formulas in the same order (``csrc/counter_rng.cuh``).
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Optional

import numpy as np
import torch

from .utils.roadmap import VARIANTS, not_ported

__all__ = [
    "LOG_PDF_FLOOR",
    "DistKind",
    "DistSpec",
    "INTEGRATE_KINDS",
    "PORTED_KINDS",
    "analytic_log_pdf",
    "dist_spec_of",
    "exponential_from_u01",
    "next_below_f32",
    "normal_from_u01",
]

#: Log density out of support (``tpu_montecarlo/tables.py:36``).
LOG_PDF_FLOOR = -100.0


class DistKind(IntEnum):
    """Sampling family codes, equal to the JAX package's."""

    UNIFORM = 0
    NORMAL = 1
    EXPONENTIAL = 2
    CUSTOM = 3
    LOGNORMAL = 4
    CAUCHY = 5
    LAPLACE = 6
    LOGISTIC = 7
    GUMBEL = 8
    WEIBULL = 9
    PARETO = 10


#: Families every kernel of the port samples in closed form.
PORTED_KINDS = (DistKind.UNIFORM, DistKind.NORMAL, DistKind.EXPONENTIAL)
#: Families the 1-D integrate kernel samples: the closed forms and CUSTOM
#: tables (the other kernels take CUSTOM with ROADMAP.md items 6.6, 7.1,
#: 8.2 and 9.2).
INTEGRATE_KINDS = PORTED_KINDS + (DistKind.CUSTOM,)


class DistSpec(NamedTuple):
    """Family code plus the (2,) float32 parameter pair the kernel reads:
    uniform (min, max), normal (mean, std), exponential (lambda, 0);
    CUSTOM (0, 0) and its tables (``tpu_montecarlo/sampling.py:59-85``).

    For CUSTOM, ``x_table`` is the uniform-u inverse-CDF table
    (``tables.compute_inverse_cdf_table``, 4096 knots), or the original
    x grid when ``exact_inverse`` is set: the density has zero-density
    spans, so the sampler must jump them at a knot (gap-respecting
    stratified tables), or, with ``heavy_tail`` as well, any uniform-u
    resampled inverse would bias the moments, so the sampler inverts the
    CDF knots exactly (``cdf_table``)."""

    kind: DistKind
    params: np.ndarray
    x_table: Optional[np.ndarray] = None
    cdf_table: Optional[np.ndarray] = None
    exact_inverse: bool = False
    heavy_tail: bool = False


def dist_spec_of(dist) -> DistSpec:
    """Pack a port ``Distribution`` the way the JAX package packs it
    (``_build_spec``, ``tpu_montecarlo/sampling.py:104-175``).  Cached on
    the Distribution: a CUSTOM spec builds tables."""
    cached = getattr(dist, "_cached_spec", None)
    if cached is not None:
        return cached
    spec = _build_spec(dist)
    dist._cached_spec = spec
    return spec


def _build_spec(dist) -> DistSpec:
    name = dist.dist_type.name
    p = dist.params
    if name == "UNIFORM":
        pair = (p["min"], p["max"])
    elif name == "NORMAL":
        pair = (p["mean"], p["std"])
    elif name == "EXPONENTIAL":
        pair = (p["lambda"], 0.0)
    elif name == "CUSTOM":
        return _custom_spec(dist)
    else:
        raise not_ported(f"sampling from a {name.lower()} distribution", VARIANTS)
    return DistSpec(DistKind[name], np.asarray(pair, np.float32))


def _custom_spec(dist) -> DistSpec:
    from .tables import (
        compute_inverse_cdf_table,
        find_zero_density_gaps,
        gapped_inverse_tables,
        inverse_table_distorts,
        needs_exact_inverse,
        sample_intervals_distort,
    )

    if dist._x_table is None or dist._cdf_table is None:
        raise ValueError("Custom distribution requires x/cdf tables")
    cdf = np.asarray(dist._cdf_table, np.float32)
    x_table = np.asarray(dist._x_table, np.float32)
    zeros = np.zeros(2, np.float32)
    _, pdf_vals = dist.get_or_compute_pdf_table()
    if needs_exact_inverse(cdf, pdf_vals):
        # Zero-density spans; heavy when even the gap-respecting tables'
        # outermost slabs bias the moments.
        gaps = find_zero_density_gaps(dist._x_table, cdf, pdf_vals)
        t, dt = gapped_inverse_tables(dist._x_table, cdf, gaps)
        heavy = sample_intervals_distort(
            dist._x_table, cdf, t[:-1], t[:-1] + dt[:-1]
        )
        return DistSpec(DistKind.CUSTOM, zeros, x_table, cdf,
                        exact_inverse=True, heavy_tail=heavy)
    inv = compute_inverse_cdf_table(dist._x_table, dist._cdf_table)
    if inverse_table_distorts(dist._x_table, dist._cdf_table, inv):
        return DistSpec(DistKind.CUSTOM, zeros, x_table, cdf,
                        exact_inverse=True, heavy_tail=True)
    return DistSpec(DistKind.CUSTOM, zeros, inv, cdf)


_SQRT2 = float(np.float32(np.sqrt(2.0)))
_U_LO = float(np.float32(1e-7))
_U_HI = float(np.float32(1.0 - 1e-7))


def normal_from_u01(u: torch.Tensor) -> torch.Tensor:
    """Standard normal by inverse CDF, ``sqrt(2) * erfinv(2u - 1)``, with
    ``u`` clamped to ``[1e-7, 1 - 1e-7]`` (tails cut at ~5.2 sigma)."""
    u = torch.clamp(u, _U_LO, _U_HI)
    return _SQRT2 * torch.special.erfinv(2.0 * u - 1.0)


def exponential_from_u01(u: torch.Tensor) -> torch.Tensor:
    """Standard exponential by inverse transform, ``-log(max(u, 1e-7))``,
    for ``u`` in (0, 1]; divide by lambda for Exp(lambda)."""
    return -torch.log(torch.clamp(u, min=_U_LO))


_SQRT_2PI = float(np.float32(2.50662827463))


def analytic_log_pdf(kind: DistKind, p1, p2, x: torch.Tensor) -> torch.Tensor:
    """Closed-form float32 log densities, with the JAX package's
    expressions in the same order (``tpu_montecarlo/sampling.py:542``):
    uniform on the half-open ``[p1, p2)``, the ``LOG_PDF_FLOOR`` out of
    support.  ``p1``, ``p2`` are float32 scalars (tensors or floats)."""
    if kind == DistKind.UNIFORM:
        inside = (p1 <= x) & (x < p2)
        return torch.where(inside, -torch.log(p2 - p1), LOG_PDF_FLOOR)
    if kind == DistKind.NORMAL:
        z = (x - p1) / p2
        return -0.5 * z * z - torch.log(p2 * _SQRT_2PI)
    if kind == DistKind.EXPONENTIAL:
        return torch.where(x >= 0.0, torch.log(p1) - p1 * x, LOG_PDF_FLOOR)
    raise not_ported(f"the log density of {DistKind(kind).name}", VARIANTS)


def next_below_f32(hi: torch.Tensor) -> torch.Tensor:
    """Largest float32 strictly below ``hi`` (finite ``hi``), by bit
    arithmetic: the uniform transform's clamp below its open bound."""
    h = hi.to(torch.float32)
    bits = h.view(torch.int32)
    dec = torch.where(
        h > 0,
        bits - 1,
        torch.where(h < 0, bits + 1, torch.full_like(bits, -2147483647)),
    )
    return dec.view(torch.float32)
