"""Probability distributions (port of ``tpu_montecarlo/distributions.py``).

``Distribution`` is a host-side value object recording a family and its
parameters, with the JAX package's factory names, parameter dicts, host
``pdf`` and ``quantile``.  The port samples uniform, normal, exponential
and the extended families (``lognormal``, ``cauchy``, ``laplace``,
``logistic``, ``gumbel``, ``weibull``, ``pareto``) in closed form, and
CUSTOM distributions (``from_pdf``, ``from_pdf_table``, ``beta``,
``gamma``, ``student_t``, ``chi2``, ``mixture``) from host-built tables
(``tables.py``), with the JAX package's tables bit for bit.
``RandomWalk`` is the random-walk MCMC proposal.
"""

from __future__ import annotations

import math
import statistics
from enum import Enum, auto
from typing import Callable, Optional, Tuple, Union

import numpy as np

from . import tables as _tables
from .sampling import ANALYTIC_EXT, DistKind

__all__ = ["HMC", "Distribution", "DistributionType", "RandomWalk"]


class DistributionType(Enum):
    """Sampling families, with the JAX package's names and order."""

    UNIFORM = auto()
    NORMAL = auto()
    EXPONENTIAL = auto()
    CUSTOM = auto()
    LOGNORMAL = auto()
    CAUCHY = auto()
    LAPLACE = auto()
    LOGISTIC = auto()
    GUMBEL = auto()
    WEIBULL = auto()
    PARETO = auto()


class Distribution:
    """Configuration for a 1-D probability distribution.

    CUSTOM distributions carry ``x_table`` / ``cdf_table`` (and a pdf
    table once computed); the first integration caches the packed spec
    and derived tables on the instance, so treat it as immutable once
    used.

    Examples:
        >>> dist = Distribution.uniform(min=0.0, max=1.0)
        >>> dist = Distribution.normal(mean=0.0, std=1.0)
        >>> dist = Distribution.exponential(lambda_param=2.0)
        >>> dist = Distribution.beta(alpha=2.0, beta_param=5.0)
    """

    def __init__(
        self,
        dist_type: DistributionType,
        params: dict,
        pdf_func: Callable[[float], float],
        x_table: Optional[np.ndarray] = None,
        cdf_table: Optional[np.ndarray] = None,
        pdf_table: Optional[np.ndarray] = None,
    ):
        self.dist_type = dist_type
        self.params = params
        self._pdf_func = pdf_func
        self._x_table = x_table
        self._cdf_table = cdf_table
        self._pdf_table = pdf_table

    def pdf(self, x: float) -> float:
        """Evaluate the PDF at a point."""
        return self._pdf_func(x)

    def __repr__(self):
        return f"Distribution({self.dist_type.name}, params={self.params})"

    @staticmethod
    def uniform(min: float = 0.0, max: float = 1.0) -> "Distribution":
        """Uniform U(min, max), half-open: pdf = 1/(max-min) on [min, max)."""
        width = max - min

        def pdf(x: float) -> float:
            return 1.0 / width if (min <= x) and (x < max) else 0.0

        return Distribution(
            DistributionType.UNIFORM,
            {"min": min, "max": max, "support": (min, max)},
            pdf,
        )

    @staticmethod
    def normal(mean: float = 0.0, std: float = 1.0) -> "Distribution":
        """Normal N(mean, std), sampled by inverting the CDF with the tails
        cut at ~5.2 sigma.  Recorded support is mean ± 7 std."""
        sqrt_2pi = np.sqrt(2 * np.pi)

        def pdf(x: float) -> float:
            z = (x - mean) / std
            return np.exp(-0.5 * z * z) / (std * sqrt_2pi)

        return Distribution(
            DistributionType.NORMAL,
            {
                "mean": mean,
                "std": std,
                "support": (mean - 7 * std, mean + 7 * std),
            },
            pdf,
        )

    @staticmethod
    def exponential(lambda_param: float = 1.0) -> "Distribution":
        """Exponential Exp(lambda), sampled by the inverse transform.
        Recorded support is (0, 10/lambda)."""

        def pdf(x: float) -> float:
            return lambda_param * math.exp(-lambda_param * x) if x >= 0 else 0.0

        return Distribution(
            DistributionType.EXPONENTIAL,
            {"lambda": lambda_param, "support": (0.0, 10.0 / lambda_param)},
            pdf,
        )

    # -- The extended closed-form families (tpu_montecarlo/distributions.py
    # :146-313): each samples by one inverse-CDF registry row
    # (sampling.ANALYTIC_EXT) with the tails cut at the 1e-7 quantiles, and
    # records a support wide enough for the table fall-backs.

    @staticmethod
    def lognormal(mu: float = 0.0, sigma: float = 1.0) -> "Distribution":
        """Log-normal: ``ln X ~ N(mu, sigma)``.  E[X] = exp(mu + sigma^2/2)."""
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}")
        sqrt_2pi = np.sqrt(2 * np.pi)

        def pdf(x: float) -> float:
            return (
                math.exp(-0.5 * ((math.log(x) - mu) / sigma) ** 2)
                / (x * sigma * sqrt_2pi)
                if x > 0
                else 0.0
            )

        return Distribution(
            DistributionType.LOGNORMAL,
            {"mu": mu, "sigma": sigma,
             "support": (0.0, math.exp(mu + 7 * sigma))},
            pdf,
        )

    @staticmethod
    def cauchy(loc: float = 0.0, scale: float = 1.0) -> "Distribution":
        """Cauchy (Lorentz) with location/scale.  No finite moments; the
        sampler truncates at the 1e-7 quantiles (|x - loc| up to ~3.2e6
        scale)."""
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")
        inv_pi = 1.0 / math.pi

        def pdf(x: float) -> float:
            return inv_pi / (scale * (1.0 + ((x - loc) / scale) ** 2))

        return Distribution(
            DistributionType.CAUCHY,
            {"loc": loc, "scale": scale,
             "support": (loc - 3.2e6 * scale, loc + 3.2e6 * scale)},
            pdf,
        )

    @staticmethod
    def laplace(loc: float = 0.0, scale: float = 1.0) -> "Distribution":
        """Laplace (double exponential) with location and diversity b."""
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")

        def pdf(x: float) -> float:
            return math.exp(-abs(x - loc) / scale) / (2.0 * scale)

        return Distribution(
            DistributionType.LAPLACE,
            {"loc": loc, "scale": scale,
             "support": (loc - 17.0 * scale, loc + 17.0 * scale)},
            pdf,
        )

    @staticmethod
    def logistic(loc: float = 0.0, scale: float = 1.0) -> "Distribution":
        """Logistic with location/scale; Var[X] = (pi * scale)^2 / 3."""
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")

        def pdf(x: float) -> float:
            t = math.exp(-abs((x - loc) / scale))
            return t / (scale * (1.0 + t) ** 2)

        return Distribution(
            DistributionType.LOGISTIC,
            {"loc": loc, "scale": scale,
             "support": (loc - 17.0 * scale, loc + 17.0 * scale)},
            pdf,
        )

    @staticmethod
    def gumbel(loc: float = 0.0, scale: float = 1.0) -> "Distribution":
        """Gumbel (max extreme-value): E[X] = loc + gamma * scale."""
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")

        def pdf(x: float) -> float:
            z = (x - loc) / scale
            return (
                math.exp(-(z + math.exp(-z))) / scale if z > -30.0 else 0.0
            )

        return Distribution(
            DistributionType.GUMBEL,
            {"loc": loc, "scale": scale,
             "support": (loc - 3.0 * scale, loc + 17.0 * scale)},
            pdf,
        )

    @staticmethod
    def weibull(shape: float, scale: float = 1.0) -> "Distribution":
        """Weibull with shape k and scale lambda:
        E[X] = scale * Gamma(1 + 1/shape)."""
        if not shape > 0:
            raise ValueError(f"shape must be positive, got {shape}")
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")

        def pdf(x: float) -> float:
            return (
                (shape / scale)
                * (x / scale) ** (shape - 1.0)
                * math.exp(-((x / scale) ** shape))
                if x > 0
                else 0.0
            )

        return Distribution(
            DistributionType.WEIBULL,
            {"shape": shape, "scale": scale,
             "support": (0.0, scale * 16.2 ** (1.0 / shape))},
            pdf,
        )

    @staticmethod
    def pareto(x_min: float = 1.0, alpha: float = 1.0) -> "Distribution":
        """Pareto (type I) with minimum x_min and tail index alpha."""
        if not x_min > 0:
            raise ValueError(f"x_min must be positive, got {x_min}")
        if not alpha > 0:
            raise ValueError(f"alpha must be positive, got {alpha}")

        def pdf(x: float) -> float:
            return (
                alpha * x_min**alpha / x ** (alpha + 1.0)
                if x >= x_min
                else 0.0
            )

        return Distribution(
            DistributionType.PARETO,
            {"x_min": x_min, "alpha": alpha,
             "support": (x_min, x_min * math.exp(16.2 / alpha))},
            pdf,
        )

    @staticmethod
    def beta(
        alpha: float, beta_param: float, table_size: int = 2048
    ) -> "Distribution":
        """Beta(alpha, beta) on [0, 1]; table-sampled via ``from_pdf``."""
        try:
            from scipy.special import beta as beta_fn
        except ImportError as e:
            raise ImportError(
                "Distribution.beta needs scipy for the normalising "
                "constant (scipy.special.beta); install scipy to use it"
            ) from e

        B = float(beta_fn(alpha, beta_param))

        def pdf(x: float) -> float:
            if 0 < x < 1:
                return (x ** (alpha - 1)) * ((1 - x) ** (beta_param - 1)) / B
            return 0.0

        return Distribution.from_pdf(pdf, support=(0.0, 1.0), table_size=table_size)

    @staticmethod
    def gamma(
        shape: float, rate: float = 1.0, table_size: int = 2048
    ) -> "Distribution":
        """Gamma(shape k, rate lambda); table-sampled via ``from_pdf``
        like ``beta`` (the reference's only non-closed-form family,
        python/wgpu_montecarlo/__init__.py:383-414).  The table spans the
        central 1 - 2e-7 quantile interval (scipy ``ppf``), so the tail
        truncation matches the analytic families' 1e-7 u-clamp."""
        if not shape > 0:
            raise ValueError(f"shape must be positive, got {shape}")
        if not rate > 0:
            raise ValueError(f"rate must be positive, got {rate}")
        try:
            from scipy.stats import gamma as gamma_dist
        except ImportError as e:
            raise ImportError(
                "Distribution.gamma needs scipy (scipy.stats.gamma) for "
                "the normalising constant and quantile bounds"
            ) from e

        return _from_scipy_frozen(
            gamma_dist(a=shape, scale=1.0 / rate), table_size
        )

    @staticmethod
    def student_t(
        df: float, loc: float = 0.0, scale: float = 1.0,
        table_size: int = 2048,
    ) -> "Distribution":
        """Student-t with ``df`` degrees of freedom (location/scale
        family); table-sampled via ``from_pdf``.  Heavy tails make the
        generic support auto-detection (pdf-ratio threshold,
        python/wgpu_montecarlo/__init__.py:88-206) truncate real mass
        for small df, so the bounds come from the exact quantile
        function at the 1e-7 / 1-1e-7 levels instead."""
        if not df > 0:
            raise ValueError(f"df must be positive, got {df}")
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")
        try:
            from scipy.stats import t as t_dist
        except ImportError as e:
            raise ImportError(
                "Distribution.student_t needs scipy (scipy.stats.t) for "
                "the normalising constant and quantile bounds"
            ) from e

        return _from_scipy_frozen(
            t_dist(df=df, loc=loc, scale=scale), table_size
        )

    @staticmethod
    def chi2(df: float, table_size: int = 2048) -> "Distribution":
        """Chi-squared with ``df`` degrees of freedom — Gamma(df/2,
        rate=1/2); table-sampled via ``from_pdf``."""
        return Distribution.gamma(
            shape=df / 2.0, rate=0.5, table_size=table_size
        )

    @staticmethod
    def mixture(
        components, weights=None, table_size: int = 4096
    ) -> "Distribution":
        """Finite mixture ``sum_i w_i p_i(x)`` of Distributions, as one
        CUSTOM table on PER-COMPONENT QUANTILE-SPACED knots: each
        component contributes a weight-proportional share of the knot
        budget, placed at its own quantile levels (linear core +
        geometric tail levels, the `_from_scipy_frozen` recipe), and the
        union is deduped in float32.  A uniform-x grid over the union
        span cannot resolve separated or scale-mismatched modes — two
        unit-scale modes 1000 apart get ~4 knots each, and a Cauchy
        component's 1e-7-quantile span (±3.2e6 scale) starves a normal
        component entirely (measured P(|X|<1) = 0.005 vs true 0.25);
        per-component quantile knots land every mode's mass on its own
        dense grid regardless of the union span.

        The table machinery composes: widely separated modes leave
        zero-density runs between them, which the gap-respecting
        exact-inverse sampler jumps at a knot (no samples in the dead
        zone); heavy tails trip the tail-moment guard on the actual
        device-table model and route knot-exact.  The reference's only
        route to a multimodal density is a hand-written pdf through
        ``from_pdf``
        (python/wgpu_montecarlo/__init__.py:416-460)."""
        comps = list(components)
        if len(comps) < 2:
            raise ValueError(
                f"mixture needs at least 2 components, got {len(comps)}"
            )
        if not all(isinstance(c, Distribution) for c in comps):
            raise TypeError("mixture components must be Distributions")
        if weights is None:
            w = np.full(len(comps), 1.0 / len(comps))
        else:
            w = np.asarray(weights, np.float64)
            if w.shape != (len(comps),):
                raise ValueError(
                    f"weights must be one per component: got shape "
                    f"{w.shape} for {len(comps)} components"
                )
            if np.any(w <= 0):
                raise ValueError("mixture weights must be positive")
            w = w / w.sum()
        eps = 1e-6
        knot_sets = []
        for wi, c in zip(w, comps):
            n_i = max(int(round(table_size * wi)), 64)
            u = _quantile_levels(n_i, eps)
            knot_sets.append(
                np.array([c.quantile(float(q)) for q in u], np.float64)
            )
        x = _dedupe_knots_f32(np.concatenate(knot_sets))
        if len(x) < 2:
            raise ValueError(
                "mixture components collapse to fewer than 2 distinct "
                "float32 knots — components are degenerate or their "
                "supports exceed the float32 range"
            )
        x = _subdivide_wide_cells(x)
        pdf = np.zeros(len(x))
        for wi, c in zip(w, comps):
            pdf += wi * np.array(
                [max(c.pdf(float(v)), 0.0) for v in x], np.float64
            )
        pdf = np.nan_to_num(pdf, nan=0.0, posinf=0.0, neginf=0.0)
        return Distribution.from_pdf_table(x, pdf)

    @staticmethod
    def from_pdf(
        pdf_func: Callable[[float], float],
        support: Optional[tuple] = None,
        table_size: int = 2048,
    ) -> "Distribution":
        """Custom distribution from a scalar PDF function.

        If ``support`` is omitted it is auto-detected
        (locate -> peak-find -> expand); a normalised CDF lookup table with
        at least 1000 points is built by trapezoid integration.

        Raises:
            TypeError: if ``pdf_func`` is not callable.
            ValueError: if the PDF is zero on the scan grid, or integrates
                to zero on the support.
        """
        if not callable(pdf_func):
            raise TypeError("pdf_func must be callable")

        if support is not None:
            x_min, x_max = support
        else:
            x_min, x_max = _tables.find_support(pdf_func)

        x_table, cdf_table = _tables.compute_cdf_table(
            pdf_func, x_min, x_max, table_size
        )
        actual_size = len(x_table)

        return Distribution(
            dist_type=DistributionType.CUSTOM,
            params={"table_size": actual_size, "support": (x_min, x_max)},
            pdf_func=pdf_func,
            x_table=x_table.astype(np.float32),
            cdf_table=cdf_table.astype(np.float32),
        )

    @staticmethod
    def from_pdf_table(
        x_table: Union[np.ndarray, list],
        pdf_table: Union[np.ndarray, list],
        cdf_table: Optional[Union[np.ndarray, list]] = None,
    ) -> "Distribution":
        """Custom distribution from pre-computed PDF values on a grid.

        ``x_table`` must be 1-D, strictly ascending, with at least 2 points;
        ``pdf_table`` must match its length and be non-negative.  If
        ``cdf_table`` is omitted it is computed by trapezoid integration and
        normalised.
        """
        x_arr = np.asarray(x_table, dtype=np.float32)
        pdf_arr = np.asarray(pdf_table, dtype=np.float32)

        if x_arr.ndim != 1 or pdf_arr.ndim != 1:
            raise ValueError("x_table and pdf_table must be 1D arrays")
        if len(x_arr) != len(pdf_arr):
            raise ValueError("x_table and pdf_table must have the same length")
        if len(x_arr) < 2:
            raise ValueError("Tables must have at least 2 points")
        if not np.all(np.diff(x_arr) > 0):
            raise ValueError("x_table must be sorted in ascending order")
        if np.any(pdf_arr < 0):
            raise ValueError("pdf_table must contain non-negative values")
        if not np.all(np.isfinite(x_arr)) or not np.all(np.isfinite(pdf_arr)):
            # An inf pdf knot would reach the device log-pdf tables and
            # turn MH acceptance ratios into NaN.
            raise ValueError("x_table and pdf_table must be finite")

        table_size = len(x_arr)
        x_min, x_max = float(x_arr[0]), float(x_arr[-1])

        if cdf_table is not None:
            cdf64 = np.asarray(cdf_table, dtype=np.float64)
            if cdf64.ndim != 1 or len(cdf64) != table_size:
                raise ValueError("cdf_table must have same length as x_table")
            # Beyond-reference validation (the reference shipped any user
            # CDF to its device binary search): a non-monotone CDF feeds
            # the inverse-table interpolation garbage, and one that does
            # not reach ~1 puts a silent probability atom at x_max (every
            # u above cdf[-1] clamps there).
            if np.any(np.diff(cdf64) < 0):
                raise ValueError("cdf_table must be non-decreasing")
            if not cdf64[-1] > 0:
                raise ValueError(
                    "cdf_table's final value must be positive — the "
                    "PDF's integral is zero over this table"
                )
            # Normalize unconditionally: a final value even slightly under
            # 1 leaves the residual mass as a silent atom at x_max (every
            # u above cdf[-1] clamps there), and the pdf table is rescaled
            # by the same factor so pdf and cdf stay mutually consistent
            # (table-based IS weights / log-pdf tables see one scale).
            scale = cdf64[-1]
            cdf64 = cdf64 / scale
            pdf_arr = (pdf_arr.astype(np.float64) / scale).astype(np.float32)
            cdf_arr = cdf64.astype(np.float32)
        else:
            x64 = x_arr.astype(np.float64)
            p64 = pdf_arr.astype(np.float64)
            cdf64 = np.zeros(table_size)
            cdf64[1:] = np.cumsum(
                0.5 * (p64[1:] + p64[:-1]) * np.diff(x64)
            )
            if not cdf64[-1] > 0:
                raise ValueError(
                    "The PDF's integral is zero over this table — there "
                    "is no probability mass to sample"
                )
            # Rescale the pdf by the same normalization factor as the
            # cdf (one-scale invariant, as in the user-supplied-cdf
            # branch above): table-based IS weights and log-pdf tables
            # must see a true density, not the unnormalized input.
            scale = cdf64[-1]
            cdf64 = cdf64 / scale
            pdf_arr = (pdf_arr.astype(np.float64) / scale).astype(np.float32)
            cdf_arr = cdf64.astype(np.float32)

        pdf_copy = pdf_arr.copy()

        def pdf_func(x: float) -> float:
            if x < x_min or x > x_max:
                return 0.0
            idx = int(np.searchsorted(x_arr, x))
            if idx == 0:
                return float(pdf_copy[0])
            if idx >= table_size:
                return float(pdf_copy[-1])
            t = (x - x_arr[idx - 1]) / (x_arr[idx] - x_arr[idx - 1])
            return float((1 - t) * pdf_copy[idx - 1] + t * pdf_copy[idx])

        return Distribution(
            dist_type=DistributionType.CUSTOM,
            params={"table_size": table_size, "support": (x_min, x_max)},
            pdf_func=pdf_func,
            x_table=x_arr,
            cdf_table=cdf_arr,
            pdf_table=pdf_arr,
        )

    @staticmethod
    def from_reference(dist) -> "Distribution":
        """The port's equivalent of a ``tpu_montecarlo`` ``Distribution``.

        Duck-typed: reads ``dist.dist_type.name`` and the ``params`` dict
        (and, for CUSTOM, the tables and the pdf callable) and imports
        nothing of the JAX package, so tests can integrate the same
        distribution, on the same tables, with both packages."""
        name = dist.dist_type.name
        p = dist.params
        if name == "UNIFORM":
            return Distribution.uniform(p["min"], p["max"])
        if name == "NORMAL":
            return Distribution.normal(p["mean"], p["std"])
        if name == "EXPONENTIAL":
            return Distribution.exponential(p["lambda"])
        ext = ANALYTIC_EXT.get(getattr(DistKind, name, None))
        if ext is not None:
            return getattr(Distribution, ext.name)(
                *(p[n] for n in ext.param_names))
        if name == "CUSTOM":

            def copy(table):
                return None if table is None else np.array(table, copy=True)

            return Distribution(
                DistributionType.CUSTOM, dict(p), dist._pdf_func,
                x_table=copy(dist._x_table), cdf_table=copy(dist._cdf_table),
                pdf_table=copy(dist._pdf_table),
            )
        raise ValueError(f"Unknown distribution type: {name}")

    def get_or_compute_pdf_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (x_table, pdf_table), lazily evaluating the PDF on the
        distribution's grid (default grid: support, fallback (-5, 5), size
        2048) the first time."""
        if self._pdf_table is not None and self._x_table is not None:
            return self._x_table, self._pdf_table

        if self._x_table is None:
            support = self.params.get("support", (-5.0, 5.0))
            table_size = self.params.get("table_size", 2048)
            x_min, x_max = support
            self._x_table = np.linspace(
                x_min, x_max, table_size, dtype=np.float32
            )

        self._pdf_table = _tables.compute_pdf_table(self._pdf_func, self._x_table)
        return self._x_table, self._pdf_table

    def get_log_pdf_table(
        self, min_log_value: float = _tables.LOG_PDF_FLOOR
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (x_table, log_pdf_table) for MCMC
        (``tpu_montecarlo/distributions.py:630-660``).

        Zero/negative PDF values map to ``min_log_value``.  For UNIFORM the
        final table entry is forced to log(1/width): the half-open pdf makes
        x = max read as zero, which would poison acceptance ratios at the
        boundary (reference: __init__.py:598-606).  Cached per
        ``min_log_value``.
        """
        cache = getattr(self, "_log_pdf_cache", None)
        if cache is None:
            cache = self._log_pdf_cache = {}
        if min_log_value in cache:
            return cache[min_log_value]
        x_table, pdf_table = self.get_or_compute_pdf_table()
        log_pdf_table = _tables.log_pdf_from_pdf(
            pdf_table, min_log_value
        ).astype(np.float32)

        if self.dist_type == DistributionType.UNIFORM:
            width = self.params.get("max", 1.0) - self.params.get("min", 0.0)
            if width > 0:
                log_pdf_table[-1] = np.log(1.0 / width)

        cache[min_log_value] = (x_table, log_pdf_table)
        return x_table, log_pdf_table

    def quantile(self, q: float) -> float:
        """Exact host-side quantile (inverse CDF) at ``q`` in (0, 1), in
        the JAX package's closed forms (``distributions.py:663-712``) for
        every analytic family; CUSTOM distributions interpolate their CDF
        table."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        p = self.params
        t = self.dist_type
        if t == DistributionType.UNIFORM:
            return p["min"] + q * (p["max"] - p["min"])
        if t == DistributionType.NORMAL:
            return statistics.NormalDist(p["mean"], p["std"]).inv_cdf(q)
        if t == DistributionType.EXPONENTIAL:
            return -math.log1p(-q) / p["lambda"]
        if t == DistributionType.LOGNORMAL:
            return math.exp(
                statistics.NormalDist(p["mu"], p["sigma"]).inv_cdf(q))
        if t == DistributionType.CAUCHY:
            return p["loc"] + p["scale"] * math.tan(math.pi * (q - 0.5))
        if t == DistributionType.LAPLACE:
            half = q - 0.5
            mag = -math.log1p(-2.0 * abs(half))
            return p["loc"] + p["scale"] * math.copysign(mag, half)
        if t == DistributionType.LOGISTIC:
            return p["loc"] + p["scale"] * math.log(q / (1.0 - q))
        if t == DistributionType.GUMBEL:
            return p["loc"] - p["scale"] * math.log(-math.log(q))
        if t == DistributionType.WEIBULL:
            return p["scale"] * (-math.log1p(-q)) ** (1.0 / p["shape"])
        if t == DistributionType.PARETO:
            return p["x_min"] * (1.0 - q) ** (-1.0 / p["alpha"])
        if t == DistributionType.CUSTOM:
            if self._x_table is None or self._cdf_table is None:
                raise ValueError("Custom distribution requires x/cdf tables")
            cdf = np.asarray(self._cdf_table, np.float64)
            xs = np.asarray(self._x_table, np.float64)
            return float(np.interp(q, cdf, xs))
        raise ValueError(f"Unknown distribution type: {t}")


def _from_scipy_frozen(frozen, table_size: int) -> "Distribution":
    """Build a CUSTOM Distribution from a frozen scipy distribution on
    QUANTILE-SPACED knots: ``x_j = ppf(u_j)`` for uniform u levels over
    [1e-7, 1-1e-7], with the CDF at each knot given EXACTLY by ``u_j``.

    Equal-mass knots beat the uniform-x grid the generic ``from_pdf``
    route builds (reference machinery, __init__.py:209-251) wherever the
    support is quantile-wide: Student-t(2)'s 1e-7 quantile span is
    ±1581, so 2048 uniform-x knots are 1.5 wide and overstate
    P(|X| > 5) by 37%; on equal-mass knots the same budget lands it
    within MC noise AND keeps the fast resampled-inverse sampler (the
    inverse of an equal-mass table IS the knot vector).

    Tail moments need more than equal mass — a Student-t(5) table's
    outermost 4.9e-4-mass cell spans x in [6.9, 38.5] and smears
    E[X^2] from 1.667 to 2.2 — so half the knot budget goes to
    GEOMETRIC tail levels (log-spaced quantiles => roughly log-spaced
    tail knots, bounding each cell's x-ratio); heavy-tail tables then
    trip :func:`tables.inverse_table_distorts` and sample knot-exact."""
    u = _quantile_levels(int(table_size), 1e-7)
    x = np.asarray(frozen.ppf(u), np.float64)
    # Dedupe in FLOAT32, where from_pdf_table re-validates strict ascent:
    # float64-distinct extreme knots collide (or overflow to inf) after
    # the cast — e.g. student_t(df=3, loc=1e8) — and would raise a
    # confusing 'x_table must be sorted' error.  Non-finite knots (ppf
    # overflow for tiny df) are dropped first; from_pdf_table then
    # renormalises the CDF so the trimmed tail mass stays consistent.
    with np.errstate(over="ignore"):
        x32 = x.astype(np.float32)
    finite = np.isfinite(x32)
    x32, u = x32[finite], u[finite]
    keep = (
        np.concatenate(([True], np.diff(x32) > 0))
        if len(x32)
        else np.zeros(0, bool)
    )
    x32, u = x32[keep], u[keep]
    if len(x32) < 2:
        raise ValueError(
            "distribution parameters leave fewer than 2 distinct "
            "float32 quantile knots (location/scale out of float32 "
            "range, or a quantile span too extreme to represent); "
            "bring the parameters into float32 range"
        )
    pdf = np.maximum(
        np.asarray(frozen.pdf(x32.astype(np.float64)), np.float64), 0.0
    )
    pdf = np.nan_to_num(pdf, nan=0.0, posinf=0.0, neginf=0.0)
    return Distribution.from_pdf_table(x32, pdf, cdf_table=u)


def _quantile_levels(n: int, eps: float) -> np.ndarray:
    """Quantile levels for an n-knot equal-mass table: a linear core over
    [eps, 1-eps] plus geometric tail levels on both sides (log-spaced
    quantiles => roughly log-spaced tail knots, bounding each tail
    cell's x-ratio)."""
    core = np.linspace(eps, 1.0 - eps, max(n // 2, 2))
    tail = np.geomspace(eps, 0.5, max(n // 4, 2))
    return np.unique(np.concatenate([core, tail, 1.0 - tail]))


def _subdivide_wide_cells(
    x: np.ndarray, factor: float = 8.0
) -> np.ndarray:
    """Insert geometric knot ladders into cells much wider than both
    neighbours — the dead zones between separated mixture modes.

    A component's outermost quantile knot still carries eps-level
    density; a single trapezoid cell bridging it to the next mode reads
    ``p_edge * gap_width`` of phantom mass (measured 0.25% of total for
    N(±500, 1), deflating every true cell by the same factor on
    normalisation).  Ladders doubling outward from both edges shrink
    that to ``~p_edge * neighbour_width``: the first ladder knot sits
    one neighbour-cell away, where a light-tailed pdf has already
    decayed to nothing, while a genuinely dense wide cell (a heavy tail
    bridging a light mode) simply gains resolution."""
    x = np.asarray(x, np.float64)
    if len(x) < 3:
        return x.astype(np.float32)
    w = np.diff(x)
    prev_w = np.concatenate([[w[0]], w[:-1]])
    next_w = np.concatenate([w[1:], [w[-1]]])
    wide = np.flatnonzero(w > factor * np.minimum(prev_w, next_w))
    if len(wide) == 0:
        return x.astype(np.float32)
    extra = []
    for i in wide:
        a, b = x[i], x[i + 1]
        mid = 0.5 * (a + b)
        for edge, step_0, sign in (
            (a, prev_w[i], 1.0),
            (b, next_w[i], -1.0),
        ):
            step = max(step_0, (b - a) * 1e-9)
            pos = edge + sign * step
            while (pos - mid) * sign < 0:
                extra.append(pos)
                step *= 2.0
                pos = edge + sign * step
    return _dedupe_knots_f32(np.concatenate([x, np.asarray(extra)]))


def _dedupe_knots_f32(x: np.ndarray) -> np.ndarray:
    """Sort, drop non-finite, and dedupe knots in float32 — the dtype
    ``from_pdf_table`` validates strict ascent in."""
    with np.errstate(over="ignore"):
        x32 = np.sort(np.asarray(x, np.float64)).astype(np.float32)
    x32 = x32[np.isfinite(x32)]
    if len(x32) == 0:
        return x32
    keep = np.concatenate(([True], np.diff(x32) > 0))
    return x32[keep]


class RandomWalk:
    """Symmetric Gaussian random-walk Metropolis proposal for
    ``integrate_mcmc`` (port of ``tpu_montecarlo/distributions.py:828``).

    Passed where ``integrate_mcmc`` takes a proposal ``Distribution``, it
    switches the sampler to random-walk MH: each step proposes ``x' = x +
    step_size * z`` with ``z ~ N(0, 1)``, and the acceptance is ``log u <
    log p(x') - log p(x)``.  ``adapt=True`` tunes the step per chain
    during burn-in by Robbins-Monro on the log step (``gamma_i =
    i^-0.6``) toward ``target_accept``, then freezes it for sampling.
    Chains start uniformly over ``init_range`` (default: the target's
    central 98% interval).  Multi-dimensional MCMC takes the same object:
    the step becomes a d-vector (``step_size=[s_1, ..., s_d]`` for
    per-dimension scales), ``init_range`` broadcasts or takes one (lo, hi)
    pair per dimension, and ``adapt=True`` tunes one per-chain scale of
    the whole step vector.  A joint log-density target needs an explicit
    ``init_range``.
    """

    __slots__ = ("step_size", "adapt", "target_accept", "init_range")

    def __init__(
        self,
        step_size=1.0,
        adapt: bool = False,
        target_accept: float = 0.44,
        init_range=None,
    ):
        if isinstance(step_size, (list, tuple, np.ndarray)):
            step_size = tuple(float(s) for s in step_size)
            if not step_size or not all(s > 0 for s in step_size):
                raise ValueError(
                    "per-dimension step_size must be a non-empty "
                    f"sequence of positive floats, got {step_size}"
                )
        else:
            step_size = float(step_size)
            if not step_size > 0:
                raise ValueError(
                    f"step_size must be positive, got {step_size}"
                )
        if not 0.0 < target_accept < 1.0:
            raise ValueError(
                f"target_accept must be in (0, 1), got {target_accept}"
            )
        if init_range is not None:
            init_range = self._check_ranges(init_range)
        self.step_size = step_size
        self.adapt = bool(adapt)
        self.target_accept = float(target_accept)
        self.init_range = init_range

    @staticmethod
    def _check_ranges(init_range):
        """One (lo, hi) pair, or a sequence of per-dimension pairs."""
        first = init_range[0]
        if isinstance(first, (list, tuple, np.ndarray)):
            pairs = []
            for r in init_range:
                lo, hi = float(r[0]), float(r[1])
                if not lo < hi:
                    raise ValueError(
                        f"init_range pairs must satisfy lo < hi, got {r}"
                    )
                pairs.append((lo, hi))
            if not pairs:
                raise ValueError("init_range sequence must be non-empty")
            return tuple(pairs)
        lo, hi = float(init_range[0]), float(init_range[1])
        if not lo < hi:
            raise ValueError(
                f"init_range must satisfy lo < hi, got {init_range}"
            )
        return (lo, hi)

    def __repr__(self) -> str:
        return (
            f"RandomWalk(step_size={self.step_size}, adapt={self.adapt}, "
            f"target_accept={self.target_accept}, "
            f"init_range={self.init_range})"
        )

    @staticmethod
    def from_reference(rw) -> "RandomWalk":
        """The port's equivalent of a ``tpu_montecarlo`` ``RandomWalk``.

        Duck-typed like ``Distribution.from_reference``; an ``HMC``
        proposal becomes the port's :class:`HMC`."""
        if type(rw).__name__ == "HMC":
            return HMC(
                step_size=rw.step_size,
                n_leapfrog=rw.n_leapfrog,
                adapt=rw.adapt,
                target_accept=rw.target_accept,
                init_range=rw.init_range,
            )
        return RandomWalk(
            step_size=rw.step_size,
            adapt=rw.adapt,
            target_accept=rw.target_accept,
            init_range=rw.init_range,
        )

    def _steps_of(self, d: int):
        """Per-dimension step list, broadcasting a scalar step."""
        if isinstance(self.step_size, tuple):
            if len(self.step_size) != d:
                raise ValueError(
                    f"step_size has {len(self.step_size)} entries but "
                    f"this MCMC run has {d} dimension(s)"
                )
            return list(self.step_size)
        return [self.step_size] * d

    def _ranges_of(self, targets, d: int):
        """Per-dimension (lo, hi) init pairs: explicit (broadcast or
        per-dimension), else each target's central 98% interval."""
        if self.init_range is not None:
            r = self.init_range
            if isinstance(r[0], tuple):
                if len(r) != d:
                    raise ValueError(
                        f"init_range has {len(r)} pairs but this MCMC "
                        f"run has {d} dimension(s)"
                    )
                return list(r)
            return [r] * d
        if targets is None:
            raise ValueError(
                "a joint log-density target carries no per-dimension "
                "quantiles; pass RandomWalk(init_range=...) (one (lo, "
                "hi) pair or a per-dimension list) to place the chains"
            )
        return [(t.quantile(0.01), t.quantile(0.99)) for t in targets]

    def pack_params(self, target: Distribution) -> np.ndarray:
        """(4,) float32 row the 1-D MCMC kernel reads: (step_size,
        init_lo, init_hi, target_accept).  The init range defaults to the
        target's central 98% interval; an empty range widens by a step."""
        return self.pack_params_nd([target], 1)[0]

    def pack_params_nd(self, targets, d: int) -> np.ndarray:
        """(d, 4) float32 rows (step_j, init_lo_j, init_hi_j,
        target_accept) for the nd MCMC kernel (``distributions.py:971`` of
        the JAX package).  ``targets`` is the per-dimension Distribution
        list, or None for a joint log-density target, which then needs an
        explicit ``init_range``."""
        rows = []
        for s, (lo, hi) in zip(self._steps_of(d), self._ranges_of(targets, d)):
            if not hi > lo:
                lo, hi = lo - s, hi + s
            rows.append([s, lo, hi, self.target_accept])
        return np.asarray(rows, np.float32)


class HMC(RandomWalk):
    """Hamiltonian Monte Carlo proposal for ``integrate_mcmc`` (port of
    ``tpu_montecarlo/distributions.py:986``).

    Each MCMC step draws a per-chain momentum ``p ~ N(0, 1)``, runs
    ``n_leapfrog`` leapfrog steps of size ``step_size`` through ``H(x, p)
    = -log pi(x) + p^2 / 2`` (the position gradient is d log pi / dx: the
    closed form's for an analytic target, the log table's slope for a
    CUSTOM one) and accepts the end with the exact Metropolis correction
    ``log u < [log pi(x') - p'^2 / 2] - [log pi(x) - p^2 / 2]``; a
    diverged trajectory rejects.  ``adapt=True`` tunes a per-chain log
    step toward ``target_accept`` (default 0.8) during burn-in, as
    :class:`RandomWalk` does, and freezes it for sampling.  ``init_range``
    places the chains as for :class:`RandomWalk`.  On a Gaussian of scale
    sigma a trajectory of length ``step_size * n_leapfrog`` near pi *
    sigma is resonant (each step lands near -x); pick another length.
    Over d dimensions ``step_size`` takes one step per dimension (a
    diagonal mass matrix), as :class:`RandomWalk`'s does, and the gradient
    of a joint log density is its reverse-mode gradient
    (``ops/grad.py``); under ``temperatures=[...]`` rung t's force is
    ``beta_t`` times the gradient."""

    __slots__ = ("n_leapfrog",)

    def __init__(
        self,
        step_size=0.5,
        n_leapfrog: int = 8,
        adapt: bool = False,
        target_accept: float = 0.8,
        init_range=None,
    ):
        super().__init__(
            step_size=step_size,
            adapt=adapt,
            target_accept=target_accept,
            init_range=init_range,
        )
        n_leapfrog = int(n_leapfrog)
        if n_leapfrog < 1:
            raise ValueError(
                f"n_leapfrog must be a positive integer, got {n_leapfrog}"
            )
        self.n_leapfrog = n_leapfrog

    def __repr__(self) -> str:
        return (
            f"HMC(step_size={self.step_size}, "
            f"n_leapfrog={self.n_leapfrog}, adapt={self.adapt}, "
            f"target_accept={self.target_accept}, "
            f"init_range={self.init_range})"
        )
