"""Module-level convenience functions, with the reference defaults."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

from ..distributions import Distribution, RandomWalk
from .integrator import MonteCarloIntegrator
from .results import IntegrationResult


def integrate(
    functions: List[Union[Callable, str]],
    distribution: Distribution,
    n_samples: int = 1_000_000,
    seed: int = 42,
    target_threads: Optional[int] = None,
    device="cuda",
    mesh=None,
    method: str = "mc",
    return_stderr: bool = False,
    qmc_rotations: int = 8,
    control_variates=None,
) -> IntegrationResult:
    """One-shot Monte Carlo integration (fresh integrator; built programs
    are still cached process-wide)."""
    integrator = MonteCarloIntegrator(
        target_threads=target_threads, device=device, mesh=mesh
    )
    return integrator.integrate(
        functions, distribution, n_samples, seed, method=method,
        return_stderr=return_stderr, qmc_rotations=qmc_rotations,
        control_variates=control_variates,
    )


def expectation_fn(
    functions: List[Union[Callable, str]],
    distribution: Distribution,
    n_samples: int = 1_000_000,
    method: str = "mc",
    target_threads: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> Callable:
    """Module-level shorthand for
    :meth:`MonteCarloIntegrator.expectation_fn` (fresh integrator; built
    programs are still cached process-wide)."""
    integrator = MonteCarloIntegrator(
        target_threads=target_threads, device=device, mesh=mesh
    )
    return integrator.expectation_fn(
        functions, distribution, n_samples, method=method
    )


def integrate_importance_sampling(
    functions: List[Union[Callable, str]],
    target_distribution: Distribution,
    proposal_distribution: Distribution,
    n_samples: int = 1_000_000,
    seed: int = 42,
    target_threads: Optional[int] = None,
    device="cuda",
    mesh=None,
    method: str = "mc",
    return_stderr: bool = False,
    qmc_rotations: int = 8,
    return_diagnostics: bool = False,
) -> IntegrationResult:
    """One-shot importance-sampling integration (fresh integrator; built
    programs are still cached process-wide)."""
    integrator = MonteCarloIntegrator(
        target_threads=target_threads, device=device, mesh=mesh
    )
    return integrator.integrate_importance_sampling(
        functions, target_distribution, proposal_distribution, n_samples,
        seed, method=method, return_stderr=return_stderr,
        qmc_rotations=qmc_rotations, return_diagnostics=return_diagnostics,
    )


def integrate_mcmc(
    functions: List[Union[Callable, str]],
    target_distribution: Distribution,
    proposal_distribution: Union[Distribution, RandomWalk],
    n_steps: int = 10_000,
    n_chains: int = 1024,
    n_burnin: int = 1_000,
    seed: int = 42,
    target_threads: Optional[int] = None,
    device="cuda",
    mesh=None,
    initial_state=None,
    return_state: bool = False,
    return_stderr: bool = False,
    return_diagnostics: bool = False,
    return_samples: Optional[int] = None,
    temperatures: Optional[List[float]] = None,
) -> IntegrationResult:
    """One-shot MCMC integration (fresh integrator; built programs are
    still cached process-wide)."""
    integrator = MonteCarloIntegrator(
        target_threads=target_threads, device=device, mesh=mesh
    )
    return integrator.integrate_mcmc(
        functions,
        target_distribution,
        proposal_distribution,
        n_steps,
        n_chains,
        n_burnin,
        seed,
        initial_state=initial_state,
        return_state=return_state,
        return_stderr=return_stderr,
        return_diagnostics=return_diagnostics,
        return_samples=return_samples,
        temperatures=temperatures,
    )
