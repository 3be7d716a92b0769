"""Host-side table numerics: support detection, CDF tables, inverse-CDF
and stratified tables, and the uniform-grid pdf tables of importance
weights (port of ``tpu_montecarlo/tables.py``, pure NumPy).

The port keeps its own copy rather than importing the JAX package's
module (importing it would start JAX).  Every function here gives the JAX
package's result bit for bit on the same inputs
(``tests/test_torch_tables.py``, ``tests/test_torch_mcmc_custom.py`` for
the MCMC log-table helpers ``downsample_log_table``,
``guard_proposal_log_floor`` and ``log_pdf_from_pdf``).  Behaviour
(grids, thresholds, normalisation, sanitisation) mirrors the reference
implementation (reference: python/wgpu_montecarlo/__init__.py:88-251).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = [
    "INV_CDF_TABLE_SIZE",
    "LOG_PDF_FLOOR",
    "MIN_TABLE_POINTS",
    "compute_cdf_table",
    "compute_inverse_cdf_table",
    "compute_pdf_table",
    "downsample_log_table",
    "downsample_pdf_table",
    "find_support",
    "find_zero_density_gaps",
    "gapped_inverse_tables",
    "gapped_stratified_tables",
    "guard_proposal_log_floor",
    "inverse_table_distorts",
    "is_uniform_grid",
    "log_pdf_from_pdf",
    "needs_exact_inverse",
    "resample_uniform_table",
    "sample_intervals_distort",
]

# Minimum number of CDF table points (reference: __init__.py:231).
MIN_TABLE_POINTS = 1000
# Log-PDF value used outside the support / where pdf <= 0
# (reference: __init__.py:574, distribution.rs:382-383).
LOG_PDF_FLOOR = -100.0
# Knot count of the uniform-u inverse-CDF table used by the device
# samplers.  Gathers over arbitrary sorted knots (binary search, the
# reference's 12-iteration device loop, distribution.rs:128-158) are
# pathological on TPU; resampling the exact piecewise-linear inverse onto a
# uniform u-grid on the host turns device sampling into index arithmetic +
# two small-table lookups.  4096 knots keep moment errors far below the
# reference's statistical test tolerances.
INV_CDF_TABLE_SIZE = 4096


def _try_pdf(pdf: Callable[[float], float], x: float) -> float:
    """Evaluate a user PDF defensively; exceptions count as 'no density'."""
    try:
        v = pdf(x)
    except (ValueError, TypeError, OverflowError, ZeroDivisionError):
        return 0.0
    try:
        v = float(v)
    except (ValueError, TypeError):
        return 0.0
    return v


def find_support(
    pdf: Callable[[float], float],
    threshold_ratio: float = 1e-5,
    max_hard_limit: float = 10000.0,
) -> Tuple[float, float]:
    """Auto-detect the effective support of a 1-D PDF.

    Three phases (reference: __init__.py:88-206):
      1. *Locate*: scan a fixed grid — dense [-4, 4] with step 0.5 plus
         exponentially spaced points ±2^4 .. ±2^10 — for the first point of
         positive, finite density.
      2. *Peak find*: hill-climb from that point with a step that halves down
         to 1e-6.
      3. *Expand*: walk outward from the peak with a doubling step until the
         density drops below ``peak * threshold_ratio`` (or the hard limit).

    Raises:
        ValueError: if the PDF is zero everywhere on the scan grid.
    """
    points = {i * 0.5 for i in range(-8, 9)}
    for e in range(4, 11):
        points.add(float(2**e))
        points.add(-float(2**e))
    scan_points = sorted(points)

    first_x = None
    first_val = 0.0
    for x in scan_points:
        val = _try_pdf(pdf, x)
        if val > 0 and math.isfinite(val):
            first_x = x
            first_val = val
            break

    if first_x is None:
        raise ValueError(
            "Support auto-detection found no positive density anywhere on "
            "its probe grid (a dense sweep of [-4, 4] in 0.5 steps plus "
            "powers of two out to ±1024). Distributions whose mass sits "
            "entirely between grid points (very narrow) or far from the "
            "origin cannot be located automatically — construct them with "
            "an explicit support instead:\n"
            "  Distribution.from_pdf(your_pdf, support=(x_min, x_max))"
        )

    # Phase 2: hill climb.  Non-finite probe values (an integrable pole
    # evaluating to inf, NaN at a domain edge) are skipped, like phase
    # 1's scan: adopting an inf peak would make the expansion threshold
    # inf and collapse the detected support to the pole's neighbourhood.
    peak_x, peak_val = first_x, first_val
    step = 1.0
    for _ in range(100):
        left = (
            _try_pdf(pdf, peak_x - step) if peak_x - step > -max_hard_limit else 0.0
        )
        right = (
            _try_pdf(pdf, peak_x + step) if peak_x + step < max_hard_limit else 0.0
        )
        if not math.isfinite(left):
            left = 0.0
        if not math.isfinite(right):
            right = 0.0
        if left > peak_val:
            peak_x, peak_val = peak_x - step, left
        elif right > peak_val:
            peak_x, peak_val = peak_x + step, right
        else:
            step /= 2.0
            if step < 1e-6:
                break

    threshold = peak_val * threshold_ratio

    # Phase 3: expand outward with doubling steps.  A PDF that *raises* at a
    # probe point stops the walk at the current bound — without taking the
    # step — whereas a PDF that returns zero/sub-threshold density takes one
    # final step before stopping (reference: __init__.py:182-204; the
    # distinction changes detected supports for PDFs that raise at their
    # domain edges).
    # NaN probes (numpy-style PDFs returning NaN outside their domain
    # instead of raising) count as zero density — both threshold
    # comparisons are False for NaN, so without this the doubling walk
    # would balloon to (and past) the hard limit.  +inf keeps walking:
    # it IS above-threshold density (an interior pole).
    x_min = peak_x
    step = 0.1
    while x_min > -max_hard_limit:
        try:
            val = float(pdf(x_min - step))
            if math.isnan(val) or val <= 0 or val < threshold:
                x_min -= step
                break
            x_min -= step
            step *= 2.0
        except (ValueError, TypeError, OverflowError, ZeroDivisionError):
            break

    x_max = peak_x
    step = 0.1
    while x_max < max_hard_limit:
        try:
            val = float(pdf(x_max + step))
            if math.isnan(val) or val <= 0 or val < threshold:
                x_max += step
                break
            x_max += step
            step *= 2.0
        except (ValueError, TypeError, OverflowError, ZeroDivisionError):
            break

    return x_min, x_max


def _eval_pdf_grid(pdf: Callable, x_grid: np.ndarray) -> np.ndarray:
    """Evaluate a scalar PDF on a grid; vectorised fast path with a scalar
    fallback for PDFs that only accept Python floats."""
    try:
        vals = pdf(x_grid)
        vals = np.asarray(vals, dtype=np.float64)
        if vals.shape != x_grid.shape:
            raise ValueError
        return vals
    except Exception:
        return np.array([_try_pdf(pdf, float(x)) for x in x_grid], dtype=np.float64)


def compute_cdf_table(
    pdf: Callable[[float], float],
    x_min: float,
    x_max: float,
    n_points: int = 2048,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a normalised CDF lookup table on a uniform grid.

    Trapezoid integration; NaN/Inf/negative PDF values are sanitised to zero;
    the table has at least MIN_TABLE_POINTS entries and its final value is
    exactly 1 (reference: __init__.py:209-251).

    Raises:
        ValueError: if the integral of the PDF over the support is zero.
    """
    n_points = max(int(n_points), MIN_TABLE_POINTS)

    x_grid = np.linspace(x_min, x_max, n_points)
    pdf_values = _eval_pdf_grid(pdf, x_grid)
    pdf_values = np.nan_to_num(pdf_values, nan=0.0, posinf=0.0, neginf=0.0)
    pdf_values = np.clip(pdf_values, 0.0, None)

    dx = (x_max - x_min) / (n_points - 1)
    cdf_values = np.zeros(n_points)
    cdf_values[1:] = np.cumsum((pdf_values[:-1] + pdf_values[1:]) / 2.0) * dx

    total = cdf_values[-1]
    if total <= 0:
        raise ValueError(
            "The PDF's integral is zero over this support — there is no "
            "probability mass to normalise. Check the PDF function and the "
            "support bounds."
        )
    cdf_values = cdf_values / total
    return x_grid, cdf_values


def compute_pdf_table(
    pdf: Callable[[float], float],
    x_table: np.ndarray,
) -> np.ndarray:
    """Evaluate a PDF on an existing x-grid, returning float32 values.

    NaN/Inf/negative values sanitise to zero, like compute_cdf_table: an
    inf knot (a pole landing exactly on the grid) would otherwise reach
    the device log-pdf tables, turn MH acceptance ratios into NaN, and
    poison the log-table downsampling allowance math."""
    vals = _eval_pdf_grid(pdf, np.asarray(x_table, dtype=np.float64))
    vals = np.nan_to_num(vals, nan=0.0, posinf=0.0, neginf=0.0)
    return np.clip(vals, 0.0, None).astype(np.float32)


def compute_inverse_cdf_table(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    m: int = INV_CDF_TABLE_SIZE,
) -> np.ndarray:
    """Resample the piecewise-linear inverse CDF onto a uniform u-grid.

    ``out[i] = inverse_cdf(i / (m - 1))`` computed exactly (float64
    interpolation over the CDF knots) on the host; the device then samples
    with ``x = lerp(out[floor(u*(m-1))], out[floor(u*(m-1))+1])`` — no
    searchsorted on device.
    """
    u_grid = np.linspace(0.0, 1.0, m)
    sl = _effective_support_slice(np.asarray(cdf_table))
    x64 = np.asarray(x_table, np.float64)[sl]
    c64 = np.asarray(cdf_table, np.float64)[sl]
    # Leading/trailing zero-density padding is trimmed above so u=0 / u=1
    # map to the true support edges, not across dead tails.  np.interp
    # tolerates the remaining (micro) flat runs.
    return np.interp(u_grid, c64, x64).astype(np.float32)


def _effective_support_slice(cdf: np.ndarray) -> slice:
    """Index range covering cdf in (0, 1) plus one knot on each side —
    leading/trailing zero-density padding (e.g. over-wide supports) is
    excluded so it neither biases the resampled inverse nor triggers the
    exact-inverse fallback."""
    n = len(cdf)
    pos = np.flatnonzero(cdf > 0.0)
    below = np.flatnonzero(cdf < 1.0)
    lo = max(int(pos[0]) - 1, 0) if len(pos) else 0
    hi = min(int(below[-1]) + 2, n) if len(below) else n
    if hi - lo < 2:
        return slice(0, n)
    return slice(lo, hi)


def needs_exact_inverse(
    cdf_table: np.ndarray, pdf_table: np.ndarray, min_run: int = 2
) -> bool:
    """True if the PDF is exactly zero over ``min_run``+ consecutive
    INTERIOR grid knots — a genuine zero-density span.  The exact inverse
    CDF is then discontinuous, and a uniform-u resampled inverse table
    would linearly interpolate ACROSS the jump, emitting samples inside the
    zero-density span (a bias the reference's knot-exact binary search
    cannot produce); such distributions must sample through exact
    searchsorted instead.

    Detection uses the PDF, not CDF flatness: float32 CDFs go flat from
    rounding underflow in thin-but-positive tails (e.g. Beta), where the
    fast resampled inverse is perfectly fine."""
    cdf = np.asarray(cdf_table)
    sl = _effective_support_slice(cdf)
    p = np.asarray(pdf_table)[sl]
    zero = p == 0.0
    run = 0
    for z in zero:
        run = run + 1 if z else 0
        if run >= min_run:
            return True
    return False


def inverse_table_distorts(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    inv_table: np.ndarray,
    rtol: float = 5e-3,
) -> bool:
    """True if sampling through the uniform-u resampled inverse table
    would measurably shift the distribution's first two moments relative
    to the knot-exact piecewise-linear CDF model.

    The resampled inverse spreads each 1/(m-1) slab of probability
    uniformly over the x-interval between consecutive inverse knots.
    For bounded or light-tailed tables the two models agree to float
    precision, but a heavy-tailed table (Student-t, Pareto-like user
    PDFs) puts its outermost slab across a huge x-range: measured on
    Student-t(5) over the 1e-7..1-1e-7 quantile span, the spread alone
    inflates E[X^2] from 1.667 to 1.95 — a 38-sigma bias at 4e5 samples.
    Such tables must sample through the exact searchsorted inverse (the
    reference's 12-iteration binary search, src/distribution.rs:128-158,
    is always knot-exact and cannot produce this bias).

    Both moments are compared in units of the distribution's own scale
    (sigma for the mean, variance for the second moment)."""
    inv = np.asarray(inv_table, np.float64)
    return sample_intervals_distort(
        x_table, cdf_table, inv[:-1], inv[1:], rtol
    )


def sample_intervals_distort(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    a: np.ndarray,
    b: np.ndarray,
    rtol: float = 5e-3,
) -> bool:
    """Moment-distortion check for ANY equal-mass interval sampler model:
    each of the ``len(a)`` slabs carries equal probability spread
    uniformly over [a_i, b_i] (b_i may equal a_i for gap-jump slabs whose
    dt was rewritten to end at a gap edge — a point mass there).  Compares
    against the knot-exact piecewise-linear CDF model in sigma units, the
    same criterion as :func:`inverse_table_distorts` — which is the
    ``a = inv[:-1], b = inv[1:]`` special case.  Used to vet the
    gap-respecting (t, dt) device tables: a mixture of separated
    heavy-tailed modes is BOTH gapped and heavy-tailed, and its outermost
    slabs bias moments exactly like the plain resampled inverse's."""
    x = np.asarray(x_table, np.float64)
    c = np.asarray(cdf_table, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def _moments(lo, hi, mass):
        m1 = float(np.sum(mass * (lo + hi) / 2.0))
        m2 = float(np.sum(mass * (lo * lo + lo * hi + hi * hi) / 3.0))
        return m1, m2

    m1_k, m2_k = _moments(x[:-1], x[1:], np.diff(c))
    m1_i, m2_i = _moments(a, b, 1.0 / len(a))
    var = max(m2_k - m1_k * m1_k, 1e-30)
    return (
        abs(m1_i - m1_k) > rtol * np.sqrt(var)
        or abs(m2_i - m2_k) > rtol * max(var, abs(m2_k))
    )


def is_uniform_grid(x_table: np.ndarray, rtol: float = 1e-3) -> bool:
    """True if the grid is uniform enough for arithmetic indexing
    (linspace-built grids always are; user from_pdf_table grids may not
    be).  The check bounds each knot's CUMULATIVE deviation from its ideal
    position ``x0 + j*step`` — per-diff checks admit systematically
    drifting grids whose total misplacement grows to whole cells.  The
    bound is rtol of a cell: an arithmetic-indexed lookup then reads at
    most rtol of a cell away from the true knot, while float32 grids
    (per-knot rounding ~eps32*|x|, a few 1e-4 of a step for 2048-knot
    unit-range grids, non-accumulating) still pass."""
    x = np.asarray(x_table, np.float64)
    if len(x) < 2:
        return False
    step = (x[-1] - x[0]) / (len(x) - 1)
    if step <= 0:
        return False
    ideal = x[0] + step * np.arange(len(x))
    return bool(np.max(np.abs(x - ideal)) <= rtol * step + 1e-12)


def resample_uniform_table(
    x_table: np.ndarray,
    values: np.ndarray,
    rtol: float = 1e-3,
    max_points: int = 65_536,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Resample a piecewise-linear table onto a uniform x-grid, error-bounded.

    User tables from ``from_pdf_table`` may have irregular knot spacing,
    which forces device lookups through searchsorted (pathological on TPU).
    This re-knots them onto a uniform grid, doubling the point count until
    the two linear interpolants differ by at most ``rtol * max|values|``
    everywhere (probed at the union of both knot sets).  Returns None when
    the bound cannot be met within ``max_points`` — callers then keep the
    original grid and the searchsorted path.
    """
    x = np.asarray(x_table, np.float64)
    v = np.asarray(values, np.float64)
    if len(x) < 2 or x[-1] <= x[0]:
        return None
    scale = float(np.max(np.abs(v)))
    if scale == 0.0 or not np.isfinite(scale):
        return None
    tol = rtol * scale
    # Cap the starting size at max_points so tables LONGER than the cap
    # still get one attempt at the largest uniform grid (a 70k-knot
    # slightly-irregular table may well fit a 65k uniform grid) instead
    # of skipping the loop entirely.
    n = max(1024, min(len(x), max_points))
    while n <= max_points:
        xu = np.linspace(x[0], x[-1], n)
        vu = np.interp(xu, x, v)
        probe = np.union1d(x, xu)
        err = np.max(
            np.abs(np.interp(probe, xu, vu) - np.interp(probe, x, v))
        )
        if err <= tol:
            return xu.astype(np.float32), vu.astype(np.float32)
        n *= 2
    return None


def downsample_log_table(
    lx: np.ndarray,
    lp: np.ndarray,
    bound: float = 0.01,
    max_nats: float = 2.0,
    floor_margin: float = -90.0,
    min_knots: int = 128,
    strict: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shrink a uniform-grid log-pdf table to the smallest knot count whose
    linear interpolant is statistically indistinguishable from the
    original — in-kernel lookups scan one lane-gather per 128-knot
    segment, so a 512-knot table costs 4 gathers where 2048 costs 16.

    Default (``strict=False``, safe for MH TARGET tables, where the
    algorithm samples the table-defined target exactly, so table
    distortion maps directly to target distortion): the error allowance is
    density-weighted — a log-space error of e nats at density p perturbs
    the target by |e|*p in absolute density, so the per-knot allowance is
    ``bound * p_max / p`` capped at ``max_nats`` — and coarse intervals
    touching a -100 floor knot are exempt (no grid represents a cliff
    mid-interval) provided they jointly carry at most ``bound`` of the
    total mass.  Net moment distortion: O(bound).

    ``strict=True`` (required for PROPOSAL tables): flat ``bound``-nat
    allowance at every knot away from the floor, no cliff exemption.  An
    independence sampler's q-table must match the sampling density
    everywhere the sampler emits — a state whose log q reads tens of nats
    low becomes an absorbing trap, and the occupancy inflation e^err is
    NOT bounded by the mis-modeled region's mass (observed: a smeared
    hard-gap edge biased a uniform-target mean by 0.09).  Tables with
    cliffs bordered by appreciable density therefore keep full resolution
    as proposals.

    Returns the original table when no smaller grid qualifies."""
    lx = np.asarray(lx)
    lp = np.asarray(lp)
    n = len(lx)
    lp_max = float(np.max(lp))
    if strict:
        allowed = np.full(lp.shape, bound)
    else:
        allowed = np.minimum(
            bound * np.exp(np.minimum(lp_max - lp, 50.0)), max_nats
        )
    p = np.exp(np.minimum(lp - lp_max, 0.0))  # relative density
    total_mass = float(np.sum(p))
    floor_fine = lp <= floor_margin
    m = min_knots
    while m < n:
        cx = np.linspace(lx[0], lx[-1], m)
        cl = np.interp(cx, lx, lp)
        back = np.interp(lx, cx, cl)
        if strict:
            # every knot the sampler can emit must meet the bound — no
            # exemption for coarse values that dipped below the floor
            # (that is exactly the absorbing-trap shape).
            mask = ~floor_fine
            ok_mass = True
        else:
            # Fine knots inside (or adjacent to) a coarse interval that
            # contains a floor knot: cliff neighbourhoods, exempt from
            # the nat bound but capped in mass.
            iv = np.clip(
                ((lx - lx[0]) / (cx[1] - cx[0])).astype(np.int64), 0, m - 2
            )
            floor_iv = np.zeros(m - 1, bool)
            np.logical_or.at(floor_iv, iv, floor_fine)
            pad = np.zeros(m - 1, bool)
            pad[:-1] |= floor_iv[1:]
            pad[1:] |= floor_iv[:-1]
            cliff = (floor_iv | pad)[iv]
            excluded_mass = float(np.sum(p[cliff & ~floor_fine]))
            ok_mass = excluded_mass <= bound * max(total_mass, 1e-30)
            mask = ~cliff
        if ok_mass and not np.any(np.abs(back - lp)[mask] > allowed[mask]):
            return cx.astype(np.float32), cl.astype(np.float32)
        m *= 2
    return lx, lp


def downsample_pdf_table(
    x: np.ndarray,
    v: np.ndarray,
    rtol: float = 1e-3,
    min_knots: int = 256,
    relative: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shrink a uniform-grid pdf table to the smallest knot count whose
    linear interpolant stays within the error bound at every original
    knot — same lane-gather-per-segment economics as
    ``downsample_log_table``.

    ``relative=False`` (IS TARGET weight tables): absolute bound
    ``rtol * max|v|`` — the numerator p enters the weight linearly, so an
    absolute density error perturbs the estimate by O(rtol).

    ``relative=True`` (IS PROPOSAL weight tables): per-knot bound
    ``rtol * v`` wherever v > 0 — the denominator q must match the
    sampling density in RELATIVE terms (samples land at density q, and a
    q-table reading r times too low inflates every weight there by 1/r
    regardless of how little mass the region holds).  Knots with v == 0
    are exempt: the sampler never emits there."""
    x = np.asarray(x)
    v = np.asarray(v)
    n = len(x)
    scale = float(np.max(np.abs(v)))
    if scale == 0.0 or not np.isfinite(scale):
        return x, v
    allowed = rtol * np.maximum(v, 0.0) if relative else rtol * scale
    mask = v > 0 if relative else np.ones(n, bool)
    m = min_knots
    while m < n:
        cx = np.linspace(x[0], x[-1], m)
        cv = np.interp(cx, x, v)
        back = np.interp(x, cx, cv)
        if not np.any((np.abs(back - v) > allowed) & mask):
            return cx.astype(np.float32), cv.astype(np.float32)
        m *= 2
    return x, v


def guard_proposal_log_floor(
    lp: np.ndarray, floor_margin: float = -90.0
) -> np.ndarray:
    """Make an MH PROPOSAL log table safe against edge absorption: every
    -100 floor knot that borders a non-floor knot is raised to its highest
    non-floor neighbour.

    The sampler emits inside the boundary trapezoid (density falls
    linearly to zero toward a support edge or gap edge), but interpolating
    the log table toward the -100 floor knot reads tens of nats BELOW the
    sampler's true density there — states in that band become absorbing
    (log alpha to leave ~ log q(state), acceptance collapses as chains
    accumulate; measured: E[X^2] under a uniform target drifted from 0.343
    to 0.280 over 5000 steps with a gapped proposal).  Raising the edge
    knot makes the table OVERestimate q across the boundary interval,
    which only under-occupies a band holding O(knot) mass.  Floors deeper
    than one knot (true gap/tail interiors, never emitted) keep -100."""
    lp = np.asarray(lp, np.float32).copy()
    floor = lp <= floor_margin
    neg_inf = np.float32(-np.inf)
    left = np.concatenate([[neg_inf], lp[:-1]])
    left_floor = np.concatenate([[True], floor[:-1]])
    right = np.concatenate([lp[1:], [neg_inf]])
    right_floor = np.concatenate([floor[1:], [True]])
    cand = np.maximum(
        np.where(left_floor, neg_inf, left),
        np.where(right_floor, neg_inf, right),
    )
    lift = floor & np.isfinite(cand)
    lp[lift] = cand[lift]
    return lp


def find_zero_density_gaps(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    pdf_table: np.ndarray,
    min_run: int = 2,
) -> list:
    """Interior zero-density spans as ``[(c, x_left, x_right)]``.

    A run of ``min_run``+ consecutive interior knots with pdf == 0 means
    the density is exactly zero on [x_left, x_right] (the pdf is piecewise
    linear between knots) and the CDF is flat at value ``c`` there — the
    exact inverse CDF jumps from x_left to x_right at u = c.  Same
    detection as ``needs_exact_inverse``."""
    cdf = np.asarray(cdf_table, np.float64)
    x = np.asarray(x_table, np.float64)
    sl = _effective_support_slice(cdf)
    p = np.asarray(pdf_table, np.float64)[sl]
    xs = x[sl]
    cs = cdf[sl]
    gaps = []
    run_start = None
    zero = p == 0.0
    # interior only: a leading/trailing zero run is support padding
    for i in range(1, len(p) - 1):
        if zero[i]:
            if run_start is None:
                run_start = i
        else:
            if run_start is not None and i - run_start >= min_run:
                gaps.append(
                    (float(cs[run_start]), float(xs[run_start]),
                     float(xs[i - 1]))
                )
            run_start = None
    if run_start is not None and (len(p) - 1) - run_start >= min_run:
        gaps.append(
            (float(cs[run_start]), float(xs[run_start]), float(xs[-2]))
        )
    return gaps


def _gapped_tables_for_grid(
    u: np.ndarray, x64: np.ndarray, c64: np.ndarray, gaps: list
) -> Tuple[np.ndarray, np.ndarray]:
    """(t, dt) tables over a (rows, L) u-knot grid whose piecewise map
    ``x(u) = t[row, j] + frac * dt[row, j]`` (j = knot below u, frac the
    within-interval fraction) NEVER lands inside a zero-density gap.

    The device kernels evaluate exactly that map from two independent
    tables, so dt need not equal diff(t): each gap's jump is snapped to the
    nearest u-knot (mass distortion <= half a knot interval, ~1e-4 for the
    4096-knot grids), t at/above the snapped knot takes the right branch,
    and the interval just below the jump gets dt = x_left - t so it ends at
    the gap's left edge instead of crossing it.  Intervals are within-row
    (row = table segment or stratum); the last column's dt is never read."""
    u = np.asarray(u, np.float64)
    flat = u.reshape(-1)
    t = np.interp(flat, c64, x64).reshape(u.shape)
    # Gaps whose flat-CDF values snap to the SAME u-knot merge into one
    # combined jump (left edge of the first, right edge of the last):
    # applied separately, the later gap's dt rewrite would overwrite the
    # earlier's and the jump interval would interpolate ACROSS the first
    # gap's interior.  The sliver between such gaps carries less mass
    # than one knot interval, so snapping it away stays within the
    # documented half-knot distortion bound.  (Gaps arrive in ascending
    # CDF order from find_zero_density_gaps.)
    merged = []
    for c, xl, xr in gaps:
        thresh = float(flat[int(np.argmin(np.abs(flat - c)))])
        if merged and merged[-1][0] == thresh:
            _, (mc, mxl, mxr) = merged[-1]
            merged[-1] = (thresh, (mc, mxl, max(mxr, xr)))
        else:
            merged.append((thresh, (c, xl, xr)))
    for thresh, (c, xl, xr) in merged:
        right = u >= thresh
        # u < c implies exact-inverse <= xl and u > c implies >= xr; the
        # clamps only rewrite knots between c and the snapped jump knot.
        t = np.where(right, np.maximum(t, xr), np.minimum(t, xl))
    dt = np.zeros_like(t)
    dt[:, :-1] = t[:, 1:] - t[:, :-1]
    for thresh, (c, xl, xr) in merged:
        jump = (u[:, :-1] < thresh) & (u[:, 1:] >= thresh)
        dt[:, :-1] = np.where(jump, xl - t[:, :-1], dt[:, :-1])
    return t, dt


def gapped_inverse_tables(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    gaps: list,
    m: int = INV_CDF_TABLE_SIZE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gap-respecting uniform-u inverse tables for the i.i.d. device lookup
    (segment lane-gather over (m//128, 128) tiles): flat (t, dt) of length
    m, float32.  The interval structure is the full m-knot sequence (the
    lookup interpolates across tile boundaries)."""
    sl = _effective_support_slice(np.asarray(cdf_table))
    x64 = np.asarray(x_table, np.float64)[sl]
    c64 = np.asarray(cdf_table, np.float64)[sl]
    u = np.linspace(0.0, 1.0, m).reshape(1, m)
    t, dt = _gapped_tables_for_grid(u, x64, c64, gaps)
    return (
        t.reshape(m).astype(np.float32),
        dt.reshape(m).astype(np.float32),
    )


def gapped_stratified_tables(
    x_table: np.ndarray,
    cdf_table: np.ndarray,
    gaps: list,
    segments: int = INV_CDF_TABLE_SIZE // 128,
    lanes: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gap-respecting per-stratum inverse tables for the stratified
    integrate sampler: (ts, dts), both (segments, lanes) float32.  Stratum
    s covers u in [s/S, (s+1)/S] with ``lanes`` knots; the within-stratum
    draw never reaches the last knot, so a jump snapped to a stratum
    boundary splits cleanly across the two strata's rows."""
    sl = _effective_support_slice(np.asarray(cdf_table))
    x64 = np.asarray(x_table, np.float64)[sl]
    c64 = np.asarray(cdf_table, np.float64)[sl]
    j = np.arange(lanes, dtype=np.float64) / (lanes - 1)
    s = np.arange(segments, dtype=np.float64).reshape(segments, 1)
    u = (s + j) / segments
    t, dt = _gapped_tables_for_grid(u, x64, c64, gaps)
    return t.astype(np.float32), dt.astype(np.float32)


def log_pdf_from_pdf(
    pdf_table: np.ndarray,
    min_log_value: float = LOG_PDF_FLOOR,
) -> np.ndarray:
    """Convert PDF values to log-space with a finite floor.

    pdf > 0  -> log(max(pdf, 1e-16))
    pdf <= 0 -> ``min_log_value``
    (reference: __init__.py:572-596)
    """
    pdf_table = np.asarray(pdf_table)
    return np.where(
        pdf_table > 0,
        np.log(np.maximum(pdf_table, 1e-16)),
        min_log_value,
    ).astype(np.float32)
