"""Public API: MonteCarloIntegrator, IntegrationResult, McmcState,
expectation_fn, integrate, integrate_importance_sampling,
integrate_mcmc, and the ``pack_*`` functions of param-batched
handles."""

from .batching import (
    pack_param_batch,
    pack_param_batch_nd,
    pack_random_walk_batch,
    pack_random_walk_batch_nd,
)
from .functions import (
    expectation_fn,
    integrate,
    integrate_importance_sampling,
    integrate_mcmc,
)
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult, McmcState

__all__ = [
    "IntegrationResult",
    "McmcState",
    "MonteCarloIntegrator",
    "expectation_fn",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
]
