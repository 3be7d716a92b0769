"""The MonteCarloIntegrator class (port of
``tpu_montecarlo/api/integrator.py``)."""

from __future__ import annotations

from typing import Optional

from ..utils.roadmap import MESH, not_ported
from .base import _BaseMixin, resolve_device
from .cache import GLOBAL_CACHE
from .importance import _ImportanceMixin
from .integrate import _IntegrateMixin
from .mcmc import _McmcMixin
from .mcmc_nd import _McmcNdMixin
from .tempering import _PtMixin


class MonteCarloIntegrator(
    _BaseMixin, _IntegrateMixin, _ImportanceMixin, _McmcMixin, _McmcNdMixin,
    _PtMixin,
):
    """Monte Carlo integrator for expected values on an NVIDIA GPU.

    Fuses K integrands into one kernel pass over shared samples
    (E[f_1(X)] ... E[f_K(X)] in one sweep), sampling on the device, over
    one distribution or a list of d independent ones (d-ary integrands),
    under a target density by importance sampling from a proposal, and
    runs Metropolis-Hastings chains for ``integrate_mcmc``, over one
    dimension or d (a product or joint log-density target), tempered over
    a ladder of temperatures on request.

    Args:
        target_threads: lane-width knob kept from the reference API
            (default 65,536); it shapes the plan and so the sample count,
            and overrides ``n_chains`` in ``integrate_mcmc``.
        device: ``"cuda"`` (default) runs the CUDA kernels and raises when
            no GPU is there; ``"cpu"`` runs the plain PyTorch versions.
        mesh: multi-device runs are not ported yet; must be None.
    """

    def __init__(
        self,
        target_threads: Optional[int] = None,
        device="cuda",
        mesh=None,
    ):
        if mesh is not None:
            raise not_ported("mesh (multi-device) runs", MESH)
        self._target_threads = target_threads
        self._device = resolve_device(device)
        self._cache = GLOBAL_CACHE
