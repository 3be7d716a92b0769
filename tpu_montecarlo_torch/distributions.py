"""Probability distributions (port of ``tpu_montecarlo/distributions.py``).

``Distribution`` is a host-side value object recording a family and its
parameters, with the JAX package's factory names, parameter dicts, host
``pdf`` and ``quantile``.  The port samples uniform, normal and
exponential; the other factories raise ``NotImplementedError`` naming
their ROADMAP item.  ``RandomWalk`` is the random-walk MCMC proposal.
"""

from __future__ import annotations

import math
import statistics
from enum import Enum, auto
from typing import Callable

import numpy as np

from .utils.roadmap import MCMC_HMC, VARIANTS, not_ported

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

    Examples:
        >>> dist = Distribution.uniform(min=0.0, max=1.0)
        >>> dist = Distribution.normal(mean=0.0, std=1.0)
        >>> dist = Distribution.exponential(lambda_param=2.0)
    """

    def __init__(
        self,
        dist_type: DistributionType,
        params: dict,
        pdf_func: Callable[[float], float],
    ):
        self.dist_type = dist_type
        self.params = params
        self._pdf_func = pdf_func

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

    @staticmethod
    def from_reference(dist) -> "Distribution":
        """The port's equivalent of a ``tpu_montecarlo`` ``Distribution``.

        Duck-typed: reads ``dist.dist_type.name`` and the ``params`` dict
        and imports nothing of the JAX package, so tests can integrate the
        same distribution with both packages."""
        name = dist.dist_type.name
        p = dist.params
        if name == "UNIFORM":
            return Distribution.uniform(p["min"], p["max"])
        if name == "NORMAL":
            return Distribution.normal(p["mean"], p["std"])
        if name == "EXPONENTIAL":
            return Distribution.exponential(p["lambda"])
        raise not_ported(f"the {name.lower()} distribution", VARIANTS)

    def quantile(self, q: float) -> float:
        """Exact host-side quantile (inverse CDF) at ``q`` in (0, 1), in
        the JAX package's closed forms (``distributions.py:663``)."""
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
        raise not_ported(f"the quantile of {t.name.lower()}", VARIANTS)


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
        proposal raises, since HMC is not ported yet."""
        if type(rw).__name__ == "HMC":
            raise not_ported("HMC proposals", MCMC_HMC)
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
    """Hamiltonian Monte Carlo proposal: not ported yet; constructing one
    raises ``NotImplementedError`` naming its ROADMAP item."""

    __slots__ = ()

    def __init__(self, *args, **kwargs):
        raise not_ported("HMC proposals", MCMC_HMC)


def _not_ported_factory(name: str):
    def factory(*args, **kwargs):
        raise not_ported(f"Distribution.{name}", VARIANTS)

    factory.__name__ = name
    factory.__doc__ = f"Not ported yet: raises NotImplementedError ({VARIANTS})."
    return staticmethod(factory)


for _name in (
    "lognormal", "cauchy", "laplace", "logistic", "gumbel", "weibull",
    "pareto", "beta", "gamma", "student_t", "mixture", "from_pdf",
    "from_pdf_table",
):
    setattr(Distribution, _name, _not_ported_factory(_name))
del _name
