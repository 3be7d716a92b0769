"""Probability distributions (port of ``tpu_montecarlo/distributions.py``).

``Distribution`` is a host-side value object recording a family and its
parameters, with the JAX package's factory names, parameter dicts and
host ``pdf``.  The port samples uniform, normal and exponential; the other
factories raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from enum import Enum, auto
from typing import Callable

import numpy as np

from .utils.roadmap import VARIANTS, not_ported

__all__ = ["Distribution", "DistributionType"]


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
