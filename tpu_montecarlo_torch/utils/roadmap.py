"""Where each part of the JAX package that the port does not have yet
stands in ``ROADMAP.md``, so every ``NotImplementedError`` names it."""

from __future__ import annotations

__all__ = [
    "FRONT_END",
    "MCMC_DIAGNOSTICS",
    "MCMC_FAMILIES",
    "MCMC_HMC",
    "MCMC_SAMPLES",
    "MCMC_SERVING",
    "MCMC_STATE",
    "MCMC_WIDE",
    "MESH",
    "ND",
    "ND_MCMC",
    "TEMPERING",
    "VARIANTS",
    "not_ported",
]

VARIANTS = "ROADMAP.md, queue 1 item 2 (integrate variants)"
FRONT_END = "ROADMAP.md, queue 1 item 3 (integrand front end)"
MCMC_HMC = "ROADMAP.md, queue 1 item 6.1 (HMC)"
MCMC_STATE = "ROADMAP.md, queue 1 item 6.2 (MCMC state and resume)"
MCMC_DIAGNOSTICS = "ROADMAP.md, queue 1 item 6.3 (MCMC diagnostics)"
MCMC_SAMPLES = "ROADMAP.md, queue 1 item 6.4 (MCMC samples)"
MCMC_SERVING = "ROADMAP.md, queue 1 item 6.5 (compile_mcmc and batches)"
MCMC_FAMILIES = (
    "ROADMAP.md, queue 1 item 6.6 (MCMC over CUSTOM tables and the "
    "extended families)"
)
MCMC_WIDE = "ROADMAP.md, queue 1 item 6.7 (MCMC over more than 127 functions)"
ND = "ROADMAP.md, queue 1 item 7 (nd integrate)"
ND_MCMC = "ROADMAP.md, queue 1 item 8 (nd MCMC)"
TEMPERING = "ROADMAP.md, queue 1 item 9 (parallel tempering)"
MESH = "ROADMAP.md, queue 1 item 12 (multi-device)"


def not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to tpu_montecarlo_torch yet; see {item}"
    )
