"""Public API: MonteCarloIntegrator, IntegrationResult, integrate,
integrate_importance_sampling, integrate_mcmc."""

from .functions import integrate, integrate_importance_sampling, integrate_mcmc
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult

__all__ = [
    "IntegrationResult",
    "MonteCarloIntegrator",
    "integrate",
    "integrate_importance_sampling",
    "integrate_mcmc",
]
