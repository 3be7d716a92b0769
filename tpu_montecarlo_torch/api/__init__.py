"""Public API: MonteCarloIntegrator, IntegrationResult, McmcState,
integrate, integrate_importance_sampling, integrate_mcmc."""

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
]
