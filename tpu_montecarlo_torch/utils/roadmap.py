"""Where each part of the JAX package that the port does not have yet
stands in ``ROADMAP.md``, so every ``NotImplementedError`` names it."""

from __future__ import annotations

__all__ = [
    "API_SURFACE",
    "FRONT_END",
    "MCMC_TABLES_XLA",
    "MCMC_WIDE",
    "MESH",
    "ND_CV",
    "ND_MCMC_TABLES_XLA",
    "ND_MCMC_WIDE",
    "ND_WIDE",
    "PT_TABLES_XLA",
    "PT_WIDE",
    "TEMPERING",
    "VARIANTS",
    "not_ported",
]

VARIANTS = "ROADMAP.md, queue 1 item 2 (integrate variants)"
FRONT_END = "ROADMAP.md, queue 1 item 3 (integrand front end)"
MCMC_WIDE = "ROADMAP.md, queue 1 item 6.7 (MCMC over more than 127 functions)"
MCMC_TABLES_XLA = (
    "ROADMAP.md, queue 1 item 6.8 (MCMC over the CUSTOM tables the JAX "
    "package runs on its XLA sweep)"
)
ND_CV = (
    "ROADMAP.md, queue 1 item 7.5 (nd control variates and expectation_fn)"
)
ND_WIDE = "ROADMAP.md, queue 1 item 7.6 (nd integrate over more than 128 functions)"
ND_MCMC_WIDE = (
    "ROADMAP.md, queue 1 item 8.8 (nd MCMC over more than 127 functions)"
)
ND_MCMC_TABLES_XLA = (
    "ROADMAP.md, queue 1 item 8.9 (nd MCMC over the CUSTOM dimensions the "
    "JAX package runs on its XLA sweep)"
)
TEMPERING = "ROADMAP.md, queue 1 item 9 (parallel tempering)"
PT_WIDE = (
    "ROADMAP.md, queue 1 item 9.7 (tempering over more than 126 functions)"
)
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
