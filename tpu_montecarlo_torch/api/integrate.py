"""Plain Monte Carlo integration (port of the plain-MC path of
``tpu_montecarlo/api/integrate.py``)."""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np
import torch

from ..distributions import Distribution
from ..ops.integrate_kernel import (
    MAX_FUNCTIONS,
    IntegrateProgram,
    integrate_cuda,
    plan_grid,
)
from ..sampling import dist_spec_of
from ..utils.dispatch import make_integrate_plan
from ..utils.roadmap import ND, VARIANTS, not_ported
from .cache import fns_key
from .results import IntegrationResult


class _IntegrateMixin:
    def integrate(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        seed: int = 42,
        method: str = "mc",
        return_stderr: bool = False,
        qmc_rotations: int = 8,
        control_variates=None,
    ) -> IntegrationResult:
        """Compute E[f_i(X)] for all functions on shared samples.

        One fused pass draws ``actual_samples >= n_samples`` samples (the
        plan's rounding) and evaluates every function on each; means
        divide by ``actual_samples`` in float32 and come back float64.
        Plain MC only: ``method="qmc"``/``"antithetic"``,
        ``return_stderr``, control variates and more than 128 functions
        are not ported yet and raise ``NotImplementedError``."""
        del qmc_rotations  # used only by qmc error bars, not ported yet
        if control_variates is not None:
            raise not_ported("control variates", VARIANTS)
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list of "
                    "Distribution objects (one per integrand argument)"
                )
            if len(dists) > 1:
                raise not_ported("multi-dimensional integration", ND)
            distribution = dists[0]
        if method not in ("mc", "qmc", "antithetic"):
            raise ValueError(
                f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
            )
        if method != "mc":
            raise not_ported(f"method={method!r}", VARIANTS)
        if return_stderr:
            raise not_ported("return_stderr", VARIANTS)
        traced = self._trace_user_functions(functions)
        if len(traced) > MAX_FUNCTIONS:
            raise not_ported(
                f"more than {MAX_FUNCTIONS} fused functions (multi-pass)",
                VARIANTS,
            )
        values = self._run_integrate(traced, distribution, n_samples, seed)
        return IntegrationResult(
            values=values, n_samples=n_samples, n_functions=len(functions)
        )

    def _run_integrate(self, traced, distribution, n_samples, seed):
        spec = dist_spec_of(distribution)
        # np.uint32 rejects seeds outside [0, 2**32), as the JAX package does.
        seed_word = int(np.uint32(seed))
        plan = make_integrate_plan(n_samples, self._target_threads)
        grid = plan_grid(plan.actual_samples)
        program = self._cache.get_or_build(
            ("integrate", fns_key(traced)), lambda: IntegrateProgram(traced)
        )
        params = torch.tensor(spec.params, device=self._device)
        sums = integrate_cuda(program, spec.kind, params, seed_word, grid)
        means = sums / float(np.float32(grid.actual_samples))
        return means.cpu().numpy()
