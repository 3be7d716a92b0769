"""Result type of the public API, and the importance-sampling weight
diagnostics (port of ``tpu_montecarlo/api/results.py``; numpy only)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..tracing import Node, TracedFunction

__all__ = ["IntegrationResult", "McmcState"]


class McmcState:
    """Checkpointable MCMC chain state (port of
    ``tpu_montecarlo/api/results.py:11-36``): per-chain position and
    cached target log density.  Returned by ``integrate_mcmc(...,
    return_state=True)`` and taken back by ``initial_state=`` to extend
    the chains in a later call.  Multi-dimensional runs carry ``x`` as a
    (d, n_chains) matrix, 1-D runs a flat vector."""

    def __init__(self, x: np.ndarray, log_p: np.ndarray, segment: int = 0):
        self.x = np.asarray(x, np.float32)
        self.log_p = np.asarray(log_p, np.float32)
        # Resume-segment counter, folded into the seed word so a resumed
        # run draws fresh streams under the same seed.
        self.segment = int(segment)

    @property
    def n_chains(self) -> int:
        return int(self.x.shape[-1])

    @property
    def ndim_state(self) -> int:
        """State dimensionality: 1 for scalar chains, d for nd chains."""
        return 1 if self.x.ndim == 1 else int(self.x.shape[0])

    @staticmethod
    def from_reference(state) -> "McmcState":
        """The port's copy of a ``tpu_montecarlo`` ``McmcState`` (duck
        typed: x, log_p and segment, as numpy arrays)."""
        return McmcState(np.asarray(state.x), np.asarray(state.log_p),
                         segment=state.segment)

    def __repr__(self):
        return (
            f"McmcState(n_chains={self.n_chains}, "
            f"d={self.ndim_state}, segment={self.segment})"
        )


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


def _unit_integrand(n_args: int = 1) -> TracedFunction:
    """The constant-1 integrand of ``n_args`` arguments, traced
    (``results.py:107-122``): ``x * 0 + 1`` of its first argument, so it
    takes every sample.  Weighted by an importance weight it evaluates to
    the weight p(x)/q(x) itself, and its mean and error bar give the
    weight's moments."""
    x = Node("arg", value=0)
    ir = Node("add", (Node("mul", (x, Node("const", value=0.0))),
                      Node("const", value=1.0)))
    return TracedFunction("unit_integrand", n_args, ir,
                          ("unit_integrand", n_args))


def _weight_diagnostics(mean_w: float, se_w: float, n_samples: int) -> dict:
    """Importance-sampling proposal diagnostics from the weight's mean and
    standard error (``results.py:125-139``): Kish effective sample size
    (sum w)^2 / sum w^2, the weight's coefficient of variation (ess = n /
    (1 + cv^2)), and the mean weight itself (about 1 when both densities
    are normalized)."""
    var_w = se_w * se_w * n_samples
    denom = var_w + mean_w * mean_w
    return {
        "ess": float(n_samples * mean_w * mean_w / denom)
        if denom > 0
        else 0.0,
        "mean_weight": float(mean_w),
        "weight_cv": float(np.sqrt(var_w) / mean_w)
        if mean_w > 0
        else float("inf"),
    }
