"""Public API: MonteCarloIntegrator, IntegrationResult, integrate."""

from .functions import integrate
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult

__all__ = ["IntegrationResult", "MonteCarloIntegrator", "integrate"]
