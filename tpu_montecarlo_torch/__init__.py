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
fifth.  ``expectation_fn`` (1-D and nd) differentiates an estimate in
the family parameters, pathwise, in gradient builds of the two integrate
kernels (``torch.autograd``); ``adapt_proposal`` learns an importance-
sampling proposal by VEGAS grid refinement for the table route of those
kernels; ``timed``, ``trace`` and ``measure_throughput`` time and trace
a run (``utils/profiling.py``).  It imports torch and numpy, never jax.

Example:
    >>> from tpu_montecarlo_torch import (
    ...     Distribution, RandomWalk, adapt_proposal, expectation_fn,
    ...     integrate, integrate_importance_sampling, integrate_mcmc)
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
    >>> import torch
    >>> est = expectation_fn([lambda x: x * x], Distribution.normal(0, 1))
    >>> p = torch.tensor([1.0, 2.0], requires_grad=True)
    >>> est(p)[0].backward()
    >>> p.grad  # ~[2, 4]: d/dm and d/ds of m^2 + s^2
    >>> q = adapt_proposal(lambda x: x > 4.0, Distribution.normal(0, 1),
    ...                    support=(-8.0, 8.0))
    >>> integrate_importance_sampling([lambda x: x > 4.0],
    ...     Distribution.normal(0, 1), q, n_samples=100_000_000).values
"""

from .adaptive import adapt_proposal
from .api import (
    IntegrationResult,
    McmcState,
    MonteCarloIntegrator,
    expectation_fn,
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
from .utils.profiling import measure_throughput, timed, trace

# Compatibility aliases for code written against the reference API (the
# JAX package's __init__.py:36-42): the transpiler's error type, and the
# tracer in the transpiler's role.
TranspilerError = TraceError
transpile_function = trace_function

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
    "TranspilerError",
    "adapt_proposal",
    "expectation_fn",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "is_traceable",
    "measure_throughput",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
    "timed",
    "trace",
    "trace_function",
    "transpile_function",
]
