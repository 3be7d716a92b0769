"""tpu_montecarlo_torch — the PyTorch and CUDA port of tpu_montecarlo for
one NVIDIA H100.

The port so far covers the fused 1-D ``integrate`` path (the integrand
front end, the counter-based sample stream and the radical inverse, the
uniform, normal and exponential families, the seven extended families
(lognormal, Cauchy, Laplace, logistic, Gumbel, Weibull, Pareto) and
CUSTOM tables, plain MC, antithetic and QMC
with error bars, and a hand-written CUDA kernel that fuses up to 128
integrands over one shared stream); importance sampling,
``integrate_importance_sampling``, with closed-form weights folded into
the integrands of that kernel; multi-dimensional
``integrate`` over d >= 2 independent dimensions of those families, in
plain MC, antithetic or Sobol QMC, with error bars (pilot-shifted squares,
or randomized QMC), in a second kernel; 1-D Metropolis-Hastings,
``integrate_mcmc``, with independence, random-walk and adaptive
random-walk proposals, HMC, error bars and chain state to resume from
(``return_state``, ``initial_state``), in a third; the same over d
dimensions, under a product of Distributions or a joint log density, in
a fourth; and parallel tempering of those chains over a ladder of
temperatures, ``integrate_mcmc(..., temperatures=[1.0, ...])``, in a
fifth.  It imports torch and numpy, never jax.

Example:
    >>> from tpu_montecarlo_torch import (
    ...     Distribution, RandomWalk, integrate,
    ...     integrate_importance_sampling, integrate_mcmc)
    >>> r = integrate([lambda x: x, lambda x: x**2],
    ...               Distribution.normal(0.0, 1.0), n_samples=10_000_000)
    >>> r.values  # ~[0, 1]
    >>> t = integrate_importance_sampling(
    ...     [lambda x: x > 4.0], Distribution.normal(0.0, 1.0),
    ...     Distribution.normal(4.0, 1.5), n_samples=100_000_000,
    ...     return_stderr=True, return_diagnostics=True)
    >>> t.values, t.stderr, t.diagnostics["ess"]  # ~[3.167e-5], rare event
    >>> u = Distribution.uniform(0.0, 1.0)
    >>> q = integrate([lambda x, y: x * y], [u, u], n_samples=10_000_000,
    ...               method="qmc", return_stderr=True)
    >>> q.values, q.stderr  # ~[0.25], rQMC error bar
    >>> m = integrate_mcmc([lambda x: x * x], Distribution.normal(0.0, 1.0),
    ...                    RandomWalk(adapt=True), n_chains=4096)
    >>> m.values, m.acceptance_rate  # ~[1], ~0.44
    >>> n2 = Distribution.normal(0.0, 2.0)
    >>> j = integrate_mcmc([lambda x, y: x * y],
    ...                    lambda x, y: -(x * x - 1.6 * x * y + y * y) / 0.72,
    ...                    [n2, n2], n_chains=4096, return_stderr=True)
    >>> j.values  # ~[0.8], E[xy] of a bivariate normal with rho = 0.8
"""

from .api import (
    IntegrationResult,
    McmcState,
    MonteCarloIntegrator,
    integrate,
    integrate_importance_sampling,
    integrate_mcmc,
    pack_param_batch,
    pack_param_batch_nd,
    pack_random_walk_batch,
    pack_random_walk_batch_nd,
)
from .distributions import HMC, Distribution, DistributionType, RandomWalk
from .tracing import TraceError, is_traceable, trace_function

__version__ = "0.1.0"

__all__ = [
    "Distribution",
    "DistributionType",
    "HMC",
    "IntegrationResult",
    "McmcState",
    "MonteCarloIntegrator",
    "RandomWalk",
    "TraceError",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "is_traceable",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
    "trace_function",
]
