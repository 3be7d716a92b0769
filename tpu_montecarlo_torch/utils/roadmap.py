"""Where each part of the JAX package that the port does not have yet
stands in ``ROADMAP.md``, so every ``NotImplementedError`` names it."""

from __future__ import annotations

__all__ = [
    "API_SURFACE",
    "FRONT_END",
    "MESH",
    "not_ported",
]

FRONT_END = "ROADMAP.md, queue 1 item 3 (integrand front end)"
API_SURFACE = "ROADMAP.md, queue 1 item 10 (remaining API surface)"
MESH = "ROADMAP.md, queue 1 item 12 (multi-device)"


def not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to tpu_montecarlo_torch yet; see {item}"
    )
