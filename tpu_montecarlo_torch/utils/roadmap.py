"""Where each part of the JAX package that the port does not have yet
stands in ``ROADMAP.md``, so every ``NotImplementedError`` names it."""

from __future__ import annotations

__all__ = [
    "API_SURFACE",
    "FRONT_END",
    "MCMC_TABLES_XLA",
    "MESH",
    "ND_CV",
    "ND_MCMC_TABLES_XLA",
    "PT_TABLES_XLA",
    "TEMPERING",
    "not_ported",
]

FRONT_END = "ROADMAP.md, queue 1 item 3 (integrand front end)"
MCMC_TABLES_XLA = (
    "ROADMAP.md, queue 1 item 6.8 (MCMC over the CUSTOM tables the JAX "
    "package runs on its XLA sweep)"
)
ND_CV = "ROADMAP.md, queue 1 item 7.5 (nd expectation_fn)"
ND_MCMC_TABLES_XLA = (
    "ROADMAP.md, queue 1 item 8.9 (nd MCMC over the CUSTOM dimensions the "
    "JAX package runs on its XLA sweep)"
)
TEMPERING = "ROADMAP.md, queue 1 item 9 (parallel tempering)"
PT_TABLES_XLA = (
    "ROADMAP.md, queue 1 item 9.8 (tempering over the CUSTOM dimensions the "
    "JAX package runs on its XLA sweep)"
)
API_SURFACE = "ROADMAP.md, queue 1 item 10 (remaining API surface)"
MESH = "ROADMAP.md, queue 1 item 12 (multi-device)"


def not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to tpu_montecarlo_torch yet; see {item}"
    )
