"""Family codes, packed distribution specs, the sampling transforms and
the closed-form log densities.

Port of the analytic rows, the extended families' registry
(``ANALYTIC_EXT``) and the CUSTOM spec of ``tpu_montecarlo/sampling.py``.
The transforms are torch functions on float32 tensors; the CUDA kernels
apply the same formulas in the same order (``csrc/counter_rng.cuh``).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ANALYTIC_EXT",
    "ANALYTIC_KINDS",
    "LOG_PDF_FLOOR",
    "AnalyticExt",
    "DistKind",
    "DistSpec",
    "analytic_log_pdf",
    "dist_spec_of",
    "ensure_param_batch_family",
    "exponential_from_u01",
    "fast_tan",
    "fma_f32",
    "log_pdf_grad",
    "next_below_f32",
    "normal_from_u01",
    "transform_from_u",
    "transform_grad_from_u",
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


class DistSpec(NamedTuple):
    """Family code plus the (2,) float32 parameter pair the kernel reads:
    uniform (min, max), normal (mean, std), exponential (lambda, 0), an
    extended family its registry row's ``param_names``; CUSTOM (0, 0) and
    its tables (``tpu_montecarlo/sampling.py:59-85``).

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


def ensure_param_batch_family(
    kind, role: str = "", feature: str = "param_batch"
) -> None:
    """Only closed-form families take runtime parameter rows: CUSTOM
    distributions sample and evaluate through tables built for one
    Distribution (``tpu_montecarlo/sampling.py:181-201``, word for word)."""
    if kind == DistKind.CUSTOM:
        subject = (
            f"the {role} distribution samples/evaluates"
            if role
            else "custom distributions sample/evaluate"
        )
        raise ValueError(
            f"{feature} applies to analytic families only "
            "(uniform/normal/exponential and the extended closed-form "
            f"families): {subject} through host-built per-distribution "
            "tables"
        )


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
        ext = ANALYTIC_EXT.get(getattr(DistKind, name, None))
        if ext is None:
            raise ValueError(f"Unknown distribution type: {dist.dist_type}")
        pair = tuple(p[n] for n in ext.param_names)
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
    support, and the extended families' registry rows.  ``p1``, ``p2``
    are float32 scalars (tensors or floats)."""
    if kind == DistKind.UNIFORM:
        inside = (p1 <= x) & (x < p2)
        return torch.where(inside, -torch.log(p2 - p1), LOG_PDF_FLOOR)
    if kind == DistKind.NORMAL:
        z = (x - p1) / p2
        return -0.5 * z * z - torch.log(p2 * _SQRT_2PI)
    if kind == DistKind.EXPONENTIAL:
        return torch.where(x >= 0.0, torch.log(p1) - p1 * x, LOG_PDF_FLOOR)
    ext = ANALYTIC_EXT.get(kind)
    if ext is None:
        raise ValueError(f"No analytic log-pdf for {DistKind(kind).name}")
    return ext.log_pdf(x, _f32(p1, x), _f32(p2, x))


def _share(a: torch.Tensor, m: torch.Tensor, b) -> torch.Tensor:
    """The share of the derivative of ``m``, ``max(a, b)`` or ``min(a,
    b)``, that ``jax.grad`` gives ``a``: 1 where m is a alone, 0 where it
    is b alone (or NaN), 0.5 at a tie."""
    return torch.where(a == m, 1.0, 0.0) / torch.where(m == b, 2.0, 1.0)


def _floor_share(val: torch.Tensor) -> torch.Tensor:
    """:func:`_share` of a log density floored at ``LOG_PDF_FLOOR``."""
    return _share(val, torch.clamp(val, min=LOG_PDF_FLOOR), LOG_PDF_FLOOR)


def log_pdf_grad(kind: DistKind, p1, p2, x: torch.Tensor) -> torch.Tensor:
    """d/dx of :func:`analytic_log_pdf`, float32: the expression that
    ``jax.grad`` of the JAX package's closed form traces, in its operation
    order (HMC's position gradient, ``mcmc_pallas.py:378-382``;
    ``csrc/log_pdf_grad.cuh`` has the kernel's copy).  Where the log
    density is the flat floor (off the support, or floored inside it) the
    gradient is 0; at a tie of a ``max`` or ``min`` it takes half the
    slope, as ``jax.grad`` does (Pareto at x_min, a floored value of
    exactly -100); ``|x - mu|`` at x = mu takes the slope of x >= mu."""
    x = x.to(torch.float32)
    p1, p2 = _f32(p1, x), _f32(p2, x)
    zero = torch.zeros_like(x)
    if kind == DistKind.UNIFORM:
        return zero
    if kind == DistKind.NORMAL:
        e = (x - p1) / p2
        return (-0.5 * e + -0.5 * e) / p2
    if kind == DistKind.EXPONENTIAL:
        return p1 * -torch.where(x >= 0.0, 1.0, zero)
    if kind == DistKind.LOGNORMAL:
        d = torch.clamp(x, min=_TINY)
        m = _share(x, d, _TINY)
        n = torch.log(d)
        p = (n - p1) / p2
        q = -0.5 * p
        val = q * p - n - torch.log(p2 * _SQRT_2PI)
        inside = x > 0
        bo = torch.where(inside, _floor_share(
            torch.where(inside, val, LOG_PDF_FLOOR)), zero)
        bv = (q * bo + -0.5 * (bo * p)) / p2
        return (-bo + bv) / d * m
    if kind == DistKind.CAUCHY:
        e = (x - p1) / p2
        f = torch.abs(e)
        h = torch.clamp(f, max=_CAUCHY_SPLIT)
        q = _share(f, h, _CAUCHY_SPLIT)
        far = f > _CAUCHY_SPLIT
        s = torch.clamp(f, min=_TINY)
        bb = _share(f, s, _TINY)
        bf = 1.0 + h * h
        log_term = torch.where(far, 2.0 * torch.log(s), torch.log(bf))
        bl = -(torch.log(_PI_F * p2) + log_term)
        by = -(1.0 * _floor_share(bl))
        bz = torch.where(far, by, zero)
        cc = torch.where(far, zero, by) / bf
        ck = 2.0 * bz / s * bb + (h * cc + cc * h) * q
        pos = e >= 0.0
        return (torch.where(pos, ck, zero) + -torch.where(pos, zero, ck)) / p2
    if kind == DistKind.LAPLACE:
        d = x - p1
        k = -torch.abs(d) / p2 - torch.log(2.0 * p2)
        y = -(1.0 * _floor_share(k) / p2)
        pos = d >= 0.0
        return torch.where(pos, y, zero) + -torch.where(pos, zero, y)
    if kind == DistKind.LOGISTIC:
        e = (x - p1) / p2
        g = -e
        h = torch.clamp(g, min=0.0)
        q = _share(g, h, 0.0)
        u = torch.exp(-torch.abs(g))
        v = 1.0 + u
        bb = -e - 2.0 * (h + torch.log(v)) - torch.log(p2)
        bn = 1.0 * _floor_share(bb)
        bp = 2.0 * -bn
        bs = -(bp / v * u)
        pos = g >= 0.0
        bx = torch.where(pos, bs, zero) + -torch.where(pos, zero, bs)
        return (-(bx + bp * q) + -bn) / p2
    if kind == DistKind.GUMBEL:
        e = (x - p1) / p2
        g = torch.exp(-e)
        k = -(e + g) - torch.log(p2)
        w = -(1.0 * _floor_share(k))
        return (w + -(w * g)) / p2
    if kind == DistKind.WEIBULL:
        d = torch.clamp(x, min=_TINY)
        m = _share(x, d, _TINY)
        n = d / p2
        o = torch.log(n)
        r = p1 - 1.0
        v = torch.exp(p1 * o)
        val = torch.log(p1 / p2) + r * o - v
        inside = x > 0
        bp = torch.where(inside, 1.0 * _floor_share(
            torch.where(inside, val, LOG_PDF_FLOOR)), zero)
        return (p1 * (-bp * v) + r * bp) / n / p2 * m
    if kind == DistKind.PARETO:
        d = torch.maximum(x, p1)
        m = _share(x, d, p1)
        r = p2 + 1.0
        val = torch.log(p2) + p2 * torch.log(p1) - r * torch.log(d)
        inside = x >= p1
        bn = torch.where(inside, 1.0 * _floor_share(
            torch.where(inside, val, LOG_PDF_FLOOR)), zero)
        return r * -bn / d * m
    raise ValueError(f"No analytic log-pdf gradient for {DistKind(kind).name}")


def transform_from_u(u: torch.Tensor, kind: DistKind, p1, p2) -> torch.Tensor:
    """Samples of an analytic family from the uniforms ``u``
    (``tpu_montecarlo/sampling.py:490``): the uniform's affine step
    clamped below its open bound, the normal's and exponential's inverse
    transforms, an extended family's registry inverse (which clamps ``u``
    to ``[1e-7, 1 - 1e-7]`` itself, so ``u`` may be [0, 1) or (0, 1])."""
    if kind == DistKind.UNIFORM:
        x = p1 + u * (p2 - p1)
        return torch.where(x >= p2, next_below_f32(torch.as_tensor(p2)), x)
    if kind == DistKind.NORMAL:
        return p1 + p2 * normal_from_u01(u)
    if kind == DistKind.EXPONENTIAL:
        return exponential_from_u01(u) / p1
    ext = ANALYTIC_EXT.get(kind)
    if ext is None:
        raise ValueError(f"No closed-form transform for {DistKind(kind).name}")
    return ext.inv_cdf(u, p1, p2)


def transform_grad_from_u(u: torch.Tensor, kind: DistKind, p1, p2):
    """``(x, dx/dp1, dx/dp2)`` at the uniforms ``u``: ``x`` is
    :func:`transform_from_u`'s, bit for bit, and the derivatives are the
    pathwise ones ``jax.grad`` takes through the JAX package's transform
    with ``u`` held fixed (``tpu_montecarlo/sampling.py:490`` and the
    registry inverses, ``:250-410``), in its float32 grouping: the
    uniform (1 - u, u) times the share of ``minimum(x, next_below(p2))``
    that reaches x (1 below the clamp, 0.5 at a tie, 0 on it: the
    clamp's bound is a stopped gradient); the normal (1, z); the
    exponential (-x / p1, 0); lognormal (x, x z); Cauchy, Laplace and
    logistic (1, the scaled term); Gumbel (1, -log(-log u)); Weibull and
    Pareto through their power's exponent.  ``clip_u`` does not depend
    on the parameters, so the clamped tails pass nothing extra."""
    x = transform_from_u(u, kind, p1, p2)
    one = torch.ones_like(x)
    if kind == DistKind.UNIFORM:
        pre = p1 + u * (p2 - p1)
        share = _share(pre, x, next_below_f32(torch.as_tensor(p2)))
        return x, share * (1.0 - u), share * u
    if kind == DistKind.NORMAL:
        return x, one, torch.broadcast_to(normal_from_u01(u), x.shape)
    if kind == DistKind.EXPONENTIAL:
        return x, -x / p1, torch.zeros_like(x)
    p1, p2 = _f32(p1, x), _f32(p2, x)
    uc = _clip_u(u)
    if kind == DistKind.LOGNORMAL:
        return x, x, x * normal_from_u01(u)
    if kind == DistKind.CAUCHY:
        return x, one, fast_tan(_PI_F * (uc - 0.5))
    if kind == DistKind.LAPLACE:
        t = uc - 0.5
        mag = -torch.log(1.0 - 2.0 * torch.abs(t))
        return x, one, torch.where(t >= 0, mag, -mag)
    if kind == DistKind.LOGISTIC:
        return x, one, torch.log(uc / (1.0 - uc))
    if kind == DistKind.GUMBEL:
        return x, one, -torch.log(-torch.log(uc))
    if kind == DistKind.WEIBULL:
        le = torch.log(-torch.log(uc))
        e = torch.exp(le / p1)
        return x, -((p2 * e) * (1.0 / (p1 * p1))) * le, e
    if kind == DistKind.PARETO:
        a = -torch.log(uc)
        e = torch.exp(a / p2)
        return x, e, -((p1 * e) * (1.0 / (p2 * p2))) * a
    raise ValueError(f"No closed-form transform for {DistKind(kind).name}")


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


# -- Cauchy's tangent -------------------------------------------------------
#
# The JAX package draws every Cauchy sample through its kernel-grade
# tangent (tpu_montecarlo/ops/fast_math.py:30-48, 148-153) on every
# backend, so that polynomial defines its Cauchy stream: a Cody-Waite
# reduction by pi and minimax sine and cosine polynomials, tan = sin / cos
# off one reduction.  This is its copy, coefficients and float32 operation
# order included (csrc/counter_rng.cuh has the kernels' copy), with the
# fused multiply-adds that XLA's CPU compiler makes of it under jit (the
# reduction's last step, every Horner step, the sine's r + (r s) p, the
# cosine's 1 + s p and the inverse's p1 + p2 tan), so that the samples are
# the interpret-mode JAX kernel's bit for bit.  A libm tangent would not do: near u = 1e-7 the
# argument sits 3e-7 off -pi/2, where the cosine polynomial's 5e-9
# absolute error is 2 % of the cosine, and so is a rounding there.

_PI_HI = float(np.float32(3.140625))
_PI_LO = float(np.float32(np.pi - 3.140625))
_INV_PI = float(np.float32(1.0 / np.pi))
_SIN_C = tuple(
    float(np.float32(c))
    for c in (2.6000516e-06, -1.9806616e-04, 8.333017e-03, -1.6666657e-01)
)
_COS_C = tuple(
    float(np.float32(c))
    for c in (-2.6077066e-07, 2.4761885e-05, -1.3888404e-03, 4.166664e-02,
              -5e-01)
)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float32 tensors or floats,
    broadcast): the product is exact in float64, the sum's rounding error
    is recovered exactly (TwoSum), and a float64 sum that lands on a
    float32 tie is broken by the sign of that error, so the one rounding
    is the fused multiply-add's."""
    p = torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(
        b, dtype=torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where((s == (r64 + up.to(torch.float64)) * 0.5) & (err > 0),
                    up, r)
    return torch.where(
        (s == (r64 + down.to(torch.float64)) * 0.5) & (err < 0), down, r)


def _reduce_pi(x: torch.Tensor) -> torch.Tensor:
    """r with x = k pi + r, |r| <= pi / 2 (k rounded half to even)."""
    k = torch.round(x * _INV_PI)
    return fma_f32(-k, _PI_LO, x - k * _PI_HI)


def _horner(coeffs, s: torch.Tensor) -> torch.Tensor:
    p = fma_f32(coeffs[0], s, coeffs[1])
    for c in coeffs[2:]:
        p = fma_f32(p, s, c)
    return p


def fast_tan(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``fast_tan``: tan(x) = sin_poly(r) / cos_poly(r)
    (the signs (-1)^k of the two cancel)."""
    r = _reduce_pi(x)
    s = r * r
    sin_r = fma_f32(r * s, _horner(_SIN_C, s), r)
    cos_r = fma_f32(s, _horner(_COS_C, s), 1.0)
    return sin_r / cos_r


# -- The extended analytic families -----------------------------------------
#
# Each family is one registry row, as in the JAX package
# (tpu_montecarlo/sampling.py:250-410): an inverse CDF that clamps u into
# [1e-7, 1 - 1e-7] (so the sampled tails stop at the 1e-7 quantiles) and a
# log density floored at LOG_PDF_FLOOR, in the JAX expressions and their
# float32 order: log(1 + .) where the JAX code avoids log1p, the Cauchy log
# density's 2 log|z| past |z| = 1e15, Weibull's power as exp(log(e) / k).

_PI_F = float(np.float32(np.pi))
_TINY = float(np.float32(1e-30))
_CAUCHY_SPLIT = float(np.float32(1e15))


class AnalyticExt(NamedTuple):
    """One extended family: its name, its two parameters' names in the
    order ``DistSpec.params`` packs them, ``inv_cdf(u, p1, p2)`` and
    ``log_pdf(x, p1, p2)`` (float32 tensors in and out)."""

    name: str
    param_names: Tuple[str, str]
    inv_cdf: Callable
    log_pdf: Callable


def _clip_u(u: torch.Tensor) -> torch.Tensor:
    return torch.clamp(u, _U_LO, _U_HI)


def _floored(val: torch.Tensor, inside=None) -> torch.Tensor:
    if inside is not None:
        val = torch.where(inside, val, LOG_PDF_FLOOR)
    return torch.clamp(val, min=LOG_PDF_FLOOR)


def _lognormal_inv(u, p1, p2):
    return torch.exp(p1 + p2 * normal_from_u01(u))


def _lognormal_logpdf(x, p1, p2):
    lx = torch.log(torch.clamp(x, min=_TINY))
    z = (lx - p1) / p2
    return _floored(-0.5 * z * z - lx - torch.log(p2 * _SQRT_2PI), x > 0)


def _cauchy_inv(u, p1, p2):
    return fma_f32(p2, fast_tan(_PI_F * (_clip_u(u) - 0.5)), p1)


def _cauchy_logpdf(x, p1, p2):
    az = torch.abs((x - p1) / p2)
    zc = torch.clamp(az, max=_CAUCHY_SPLIT)
    log_term = torch.where(
        az > _CAUCHY_SPLIT,
        2.0 * torch.log(torch.clamp(az, min=_TINY)),
        torch.log(1.0 + zc * zc),
    )
    return _floored(-(torch.log(_PI_F * p2) + log_term))


def _laplace_inv(u, p1, p2):
    t = _clip_u(u) - 0.5
    mag = -torch.log(1.0 - 2.0 * torch.abs(t))
    return p1 + p2 * torch.where(t >= 0, mag, -mag)


def _laplace_logpdf(x, p1, p2):
    return _floored(-torch.abs(x - p1) / p2 - torch.log(2.0 * p2))


def _logistic_inv(u, p1, p2):
    uc = _clip_u(u)
    return p1 + p2 * torch.log(uc / (1.0 - uc))


def _softplus(t):
    return torch.clamp(t, min=0.0) + torch.log(1.0 + torch.exp(-torch.abs(t)))


def _logistic_logpdf(x, p1, p2):
    z = (x - p1) / p2
    return _floored(-z - 2.0 * _softplus(-z) - torch.log(p2))


def _gumbel_inv(u, p1, p2):
    return p1 - p2 * torch.log(-torch.log(_clip_u(u)))


def _gumbel_logpdf(x, p1, p2):
    z = (x - p1) / p2
    return _floored(-(z + torch.exp(-z)) - torch.log(p2))


def _weibull_inv(u, p1, p2):
    e = -torch.log(_clip_u(u))
    return p2 * torch.exp(torch.log(e) / p1)


def _weibull_logpdf(x, p1, p2):
    lt = torch.log(torch.clamp(x, min=_TINY) / p2)
    val = torch.log(p1 / p2) + (p1 - 1.0) * lt - torch.exp(p1 * lt)
    return _floored(val, x > 0)


def _pareto_inv(u, p1, p2):
    return p1 * torch.exp(-torch.log(_clip_u(u)) / p2)


def _pareto_logpdf(x, p1, p2):
    safe = torch.maximum(x, p1)
    val = torch.log(p2) + p2 * torch.log(p1) - (p2 + 1.0) * torch.log(safe)
    return _floored(val, x >= p1)


ANALYTIC_EXT = {
    DistKind.LOGNORMAL: AnalyticExt(
        "lognormal", ("mu", "sigma"), _lognormal_inv, _lognormal_logpdf),
    DistKind.CAUCHY: AnalyticExt(
        "cauchy", ("loc", "scale"), _cauchy_inv, _cauchy_logpdf),
    DistKind.LAPLACE: AnalyticExt(
        "laplace", ("loc", "scale"), _laplace_inv, _laplace_logpdf),
    DistKind.LOGISTIC: AnalyticExt(
        "logistic", ("loc", "scale"), _logistic_inv, _logistic_logpdf),
    DistKind.GUMBEL: AnalyticExt(
        "gumbel", ("loc", "scale"), _gumbel_inv, _gumbel_logpdf),
    DistKind.WEIBULL: AnalyticExt(
        "weibull", ("shape", "scale"), _weibull_inv, _weibull_logpdf),
    DistKind.PARETO: AnalyticExt(
        "pareto", ("x_min", "alpha"), _pareto_inv, _pareto_logpdf),
}

#: Every family sampled by a closed-form transform, with no host tables.
ANALYTIC_KINDS: Tuple[DistKind, ...] = (
    DistKind.UNIFORM, DistKind.NORMAL, DistKind.EXPONENTIAL,
) + tuple(ANALYTIC_EXT)


def next_below_f32(hi: torch.Tensor) -> torch.Tensor:
    """Largest float32 strictly below ``hi`` (finite ``hi``), by bit
    arithmetic: the uniform transform's clamp below its open bound, a
    constant to autograd (the JAX package's ``stop_gradient``)."""
    h = hi.detach().to(torch.float32)
    bits = h.view(torch.int32)
    dec = torch.where(
        h > 0,
        bits - 1,
        torch.where(h < 0, bits + 1, torch.full_like(bits, -2147483647)),
    )
    return dec.view(torch.float32)
