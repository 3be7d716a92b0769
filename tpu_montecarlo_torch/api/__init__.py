"""Public API: MonteCarloIntegrator, IntegrationResult, McmcState,
integrate, integrate_importance_sampling, integrate_mcmc, and the
``pack_*`` functions of param-batched handles."""

from .batching import (
    pack_param_batch,
    pack_param_batch_nd,
    pack_random_walk_batch,
    pack_random_walk_batch_nd,
)
from .functions import integrate, integrate_importance_sampling, integrate_mcmc
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult, McmcState

__all__ = [
    "IntegrationResult",
    "McmcState",
    "MonteCarloIntegrator",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
]
