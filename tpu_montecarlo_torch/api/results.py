"""Result type of the public API (port of ``tpu_montecarlo/api/results.py``;
numpy only)."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["IntegrationResult"]


class IntegrationResult:
    """Estimates from a Monte Carlo run.

    Attributes:
        values: float64 array of expected values, one per function.
        n_samples: total requested sample count.
        n_functions: number of integrands.
        acceptance_rate: MCMC only; None for plain integration.
        chain_state: MCMC only; None for plain integration.
        stderr: float64 array of standard errors when requested, else None.
        diagnostics: dict when requested, else None.
        samples: MCMC only; None for plain integration.
    """

    def __init__(
        self,
        values,
        n_samples: int,
        n_functions: int,
        acceptance_rate: Optional[float] = None,
        chain_state=None,
        stderr=None,
        diagnostics: Optional[dict] = None,
        samples=None,
    ):
        self.values = np.array(values, dtype=np.float64)
        self.n_samples = n_samples
        self.n_functions = n_functions
        self.acceptance_rate = acceptance_rate
        self.chain_state = chain_state
        self.stderr = (
            None if stderr is None else np.array(stderr, dtype=np.float64)
        )
        self.diagnostics = diagnostics
        self.samples = None if samples is None else np.asarray(samples)

    def __repr__(self):
        return (
            f"IntegrationResult(values={self.values}, "
            f"n_samples={self.n_samples})"
        )

    def __getitem__(self, idx):
        return self.values[idx]

    def __len__(self):
        return self.n_functions
