"""tpu_montecarlo_torch — the PyTorch and CUDA port of tpu_montecarlo for
one NVIDIA H100.

This slice ports the fused 1-D plain Monte Carlo ``integrate`` path: the
integrand front end, the counter-based sample stream, the uniform, normal
and exponential families, and a hand-written CUDA kernel that fuses up to
128 integrands over one shared stream.  It imports torch and numpy, never
jax.

Example:
    >>> from tpu_montecarlo_torch import Distribution, integrate
    >>> r = integrate([lambda x: x, lambda x: x**2],
    ...               Distribution.normal(0.0, 1.0), n_samples=10_000_000)
    >>> r.values  # ~[0, 1]
"""

from .api import IntegrationResult, MonteCarloIntegrator, integrate
from .distributions import Distribution, DistributionType
from .tracing import TraceError, is_traceable, trace_function

__version__ = "0.1.0"

__all__ = [
    "Distribution",
    "DistributionType",
    "IntegrationResult",
    "MonteCarloIntegrator",
    "TraceError",
    "integrate",
    "is_traceable",
    "trace_function",
]
