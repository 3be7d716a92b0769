"""Family codes, packed distribution specs, the sampling transforms and
the closed-form log densities.

Port of the analytic rows of ``tpu_montecarlo/sampling.py``.  The
transforms are torch functions on float32 tensors; the CUDA kernels
apply the same formulas in the same order (``csrc/counter_rng.cuh``).
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import numpy as np
import torch

from .utils.roadmap import VARIANTS, not_ported

__all__ = [
    "LOG_PDF_FLOOR",
    "DistKind",
    "DistSpec",
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


#: Families the port samples.
PORTED_KINDS = (DistKind.UNIFORM, DistKind.NORMAL, DistKind.EXPONENTIAL)


class DistSpec(NamedTuple):
    """Family code plus the (2,) float32 parameter pair the kernel reads:
    uniform (min, max), normal (mean, std), exponential (lambda, 0)."""

    kind: DistKind
    params: np.ndarray


def dist_spec_of(dist) -> DistSpec:
    """Pack a port ``Distribution`` the way the JAX package packs it."""
    name = dist.dist_type.name
    p = dist.params
    if name == "UNIFORM":
        pair = (p["min"], p["max"])
    elif name == "NORMAL":
        pair = (p["mean"], p["std"])
    elif name == "EXPONENTIAL":
        pair = (p["lambda"], 0.0)
    else:
        raise not_ported(f"sampling from a {name.lower()} distribution", VARIANTS)
    return DistSpec(DistKind[name], np.asarray(pair, np.float32))


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
