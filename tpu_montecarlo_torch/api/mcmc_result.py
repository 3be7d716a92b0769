"""The result of one run of the 1-D, nd or tempered MCMC kernel, as the
JAX package's ``integrate_mcmc`` returns it (``tpu_montecarlo/api/
mcmc.py:222-260``, ``api/mcmc_nd.py:536-560``, ``api/tempering.py:
160-185``)."""

from __future__ import annotations

import numpy as np

from ..ops.mcmc_kernel import mcmc_diagnostics, mcmc_finish
from .results import IntegrationResult, McmcState


def mcmc_result(out, grid, cfg, k: int, n_chains: int, swap_rate=None,
                one_dim: bool = False) -> IntegrationResult:
    """The result of one run of any of the three MCMC kernels: values,
    acceptance and error bars as numpy and float; diagnostics (split-R-hat
    and ESS as float64 arrays, and a tempered run's swap rate); the draws
    as float32 numpy, (m, chains) from the 1-D kernel, else transposed to
    (m, chains, d), or to (m, chains) when ``one_dim`` (a tempered run
    over one Distribution)."""
    values, acceptance, stderr = mcmc_finish(out, grid, cfg, k)
    diagnostics = None if swap_rate is None else {
        "swap_rate": float(swap_rate)}
    diag = mcmc_diagnostics(out, grid, cfg, k)
    if diag is not None:
        diagnostics = diagnostics or {}
        diagnostics["r_hat"] = diag[0].cpu().numpy().astype(np.float64)
        diagnostics["ess"] = diag[1].cpu().numpy().astype(np.float64)
    samples = None
    if out.samples is not None:
        samples = out.samples.cpu().numpy()
        if samples.ndim == 3:
            samples = samples.transpose(0, 2, 1)
            if one_dim:
                samples = samples[:, :, 0]
    return IntegrationResult(
        values=values.cpu().numpy(),
        n_samples=n_chains * cfg.n_steps,
        n_functions=k,
        acceptance_rate=float(acceptance),
        stderr=None if stderr is None else stderr.cpu().numpy(),
        diagnostics=diagnostics,
        samples=samples,
    )


def with_chain_state(result: IntegrationResult, out, segment: int,
                     return_state: bool) -> IntegrationResult:
    """``result`` with its :class:`McmcState` (the run's final states and
    log densities at ``segment``) when the caller asked for it."""
    if return_state:
        result.chain_state = McmcState(out.x_final.cpu().numpy(),
                                       out.logp_final.cpu().numpy(),
                                       segment=segment)
    return result
