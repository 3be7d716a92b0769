"""Monte Carlo integration, 1-D and multi-dimensional (port of the
1-D and nd paths of ``tpu_montecarlo/api/integrate.py``)."""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np
import torch

from ..distributions import Distribution
from ..ops.integrate_kernel import (
    MAX_FUNCTIONS,
    METHODS,
    IntegrateConfig,
    IntegrateProgram,
    finish_stderr,
    integrate_cuda,
    pilot_values,
    plan_grid,
)
from ..ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    integrate_nd_cuda,
    pilot_row,
)
from ..sampling import DistKind, dist_spec_of
from ..utils.dispatch import make_integrate_plan
from ..utils.roadmap import (
    API_SURFACE,
    ND_CV,
    ND_SERVING,
    ND_WIDE,
    VARIANTS,
    not_ported,
)
from .cache import fns_key
from .device import nd_tables, sampling_tables
from .results import IntegrationResult

def _as_dims(distribution):
    """The per-dimension Distributions of a sequence, or None for one
    Distribution."""
    if not isinstance(distribution, (list, tuple)):
        return None
    dists = list(distribution)
    if not dists or not all(isinstance(dd, Distribution) for dd in dists):
        raise TypeError(
            "a distribution sequence must be a non-empty list of "
            "Distribution objects (one per integrand argument)"
        )
    return dists


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

        ``distribution`` may be a list of d >= 2 per-dimension
        Distributions (uniform, normal, exponential, an extended
        family: lognormal, Cauchy, Laplace, logistic, Gumbel, Weibull,
        Pareto, or CUSTOM: the first CUSTOM dimension stratified by row
        of each tile under ``"mc"`` and ``"antithetic"``, the others and
        every one under ``"qmc"`` through their full inverse-CDF tables)
        for d-ary functions,
        E[f_i(X_1, ..., X_d)] over independent dimensions.  Then
        ``method`` may be ``"mc"``, ``"antithetic"`` (each uniform vector
        also mirrored, ``1 - u``, through every dimension) or ``"qmc"``
        (a Sobol net of up to 32 dimensions under a seed-derived
        rotation), and ``return_stderr`` gives error bars: from
        pilot-shifted squares (of pair means under ``"antithetic"``), or
        under ``"qmc"`` from ``qmc_rotations`` independent rotations of
        ``ceil(n_samples / qmc_rotations)`` points each (randomized QMC:
        the mean of the rotations, and their spread over
        sqrt(rotations)).

        One Distribution (uniform, normal, exponential, an extended
        family, or CUSTOM:
        ``from_pdf``, ``from_pdf_table``, ``beta``, ``gamma``,
        ``student_t``, ``chi2``, ``mixture``) takes the same methods and
        error bars: ``"antithetic"`` maps each uniform at ``u`` and ``1 -
        u``, ``"qmc"`` draws the seed-rotated radical inverse of the global
        sample index, and under ``"qmc"`` error bars come from
        ``qmc_rotations`` rotations as above, one kernel launch each.  A
        CUSTOM distribution samples its inverse-CDF tables, stratified by
        row of each tile (gap-respecting where its density has
        zero-density spans), or, when heavy-tailed, inverts its CDF knots
        exactly.

        Control variates and more than 128 functions are not ported yet
        and raise ``NotImplementedError``."""
        dists = _as_dims(distribution)
        if dists is not None and len(dists) > 1:
            if control_variates is not None:
                raise not_ported("control variates in nd integrate", ND_CV)
            return self._integrate_nd(
                functions, dists, n_samples, seed, method, return_stderr,
                qmc_rotations,
            )
        if control_variates is not None:
            raise not_ported("control variates", VARIANTS)
        if dists is not None:
            distribution = dists[0]
        if method not in METHODS:
            raise ValueError(
                f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
            )
        traced = self._trace_user_functions(functions)
        program = self._integrate_program(traced)
        values, stderr = self._run_1d(
            program, distribution, n_samples, seed, method, return_stderr,
            qmc_rotations,
        )
        return IntegrationResult(
            values=values, n_samples=n_samples, n_functions=len(functions),
            stderr=stderr,
        )

    # -- 1-D (kernel 1, ops/integrate_kernel.py) ----------------------------

    def _integrate_program(self, traced, weight=None) -> IntegrateProgram:
        """The cached program of a traced set, weighted by ``weight=(p,
        q)`` for importance sampling (each a traced density, a weight
        table or the sampler's density, keyed by content)."""
        if len(traced) > MAX_FUNCTIONS:
            raise not_ported(
                f"more than {MAX_FUNCTIONS} fused functions (multi-pass)",
                VARIANTS,
            )
        key = ("integrate", fns_key(traced))
        if weight is not None:
            key += (("is_weight", fns_key(weight)),)
        return self._cache.get_or_build(
            key, lambda: IntegrateProgram(traced, weight)
        )

    def _run_1d(
        self, program, distribution, n_samples, seed, method, return_stderr,
        qmc_rotations,
    ):
        """(values, stderr or None) of one 1-D run of ``program`` on the
        kernel, float64 arrays: means over the plan's ``actual_samples``;
        error bars from pilot-shifted squares, or under ``qmc`` from
        ``qmc_rotations`` rotations (randomized QMC, the JAX package's
        api/integrate.py:152-174), one launch each."""
        spec = dist_spec_of(distribution)
        params = torch.tensor(spec.params, device=self._device)
        tables = None
        if spec.kind == DistKind.CUSTOM:
            tables = sampling_tables(distribution, spec, self._device,
                                     with_pdf=program.sampler)
        if return_stderr and method == "qmc":
            if qmc_rotations < 2:
                raise ValueError(
                    "qmc_rotations must be >= 2 to estimate an rQMC "
                    f"error bar (got {qmc_rotations})"
                )
            r = qmc_rotations
            cfg = IntegrateConfig("qmc")
            grid = self._grid(-(-n_samples // r), "qmc")
            # Distinct seed words give independent rotations; the
            # golden-ratio stride keeps consecutive user seeds apart.
            seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(
                r, dtype=np.uint32
            )
            vals = np.stack(
                [
                    self._means(program, spec.kind, params, int(s), grid, cfg,
                                tables)
                    for s in seeds
                ]
            ).astype(np.float64)
            return vals.mean(axis=0), vals.std(axis=0, ddof=1) / np.sqrt(r)
        cfg = IntegrateConfig(method, return_stderr)
        # np.uint32 rejects seeds outside [0, 2**32), as the JAX package does.
        seed_word = int(np.uint32(seed))
        grid = self._grid(n_samples, method)
        if not return_stderr:
            return self._means(program, spec.kind, params, seed_word, grid,
                               cfg, tables), None
        pilot = pilot_values(program.torch_values, spec.kind, params, tables)
        sums, sqs = integrate_cuda(
            program, spec.kind, params, seed_word, grid, cfg, pilot, tables
        )
        mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
        return mean.cpu().numpy(), se.cpu().numpy()

    def _grid(self, n_samples, method):
        plan = make_integrate_plan(n_samples, self._target_threads)
        return plan_grid(plan.actual_samples, method)

    @staticmethod
    def _means(program, kind, params, seed_word, grid, cfg,
               tables=None) -> np.ndarray:
        sums = integrate_cuda(program, kind, params, seed_word, grid, cfg,
                              tables=tables)
        return (sums / float(np.float32(grid.actual_samples))).cpu().numpy()

    # -- multi-dimensional (kernel 2, ops/integrate_nd_kernel.py) -----------

    def _integrate_nd(
        self, functions, dists, n_samples, seed, method, return_stderr,
        qmc_rotations,
    ) -> IntegrationResult:
        kinds = tuple(dist_spec_of(dd).kind for dd in dists)
        NdConfig(kinds, method)  # the method and Sobol dimension errors first
        traced = self._trace_user_functions(functions, n_args=len(kinds))
        program = self._nd_program(traced, kinds)
        values, stderr = self._run_nd(program, dists, n_samples, seed, method,
                                      return_stderr, qmc_rotations)
        return IntegrationResult(values=values, stderr=stderr,
                                 n_samples=n_samples,
                                 n_functions=len(functions))

    def _nd_program(self, traced, kinds, weight=None) -> IntegrateNdProgram:
        """The cached nd program of a traced set over ``kinds``, weighted
        by ``weight`` (one (p, q) pair per dimension) for importance
        sampling."""
        if len(traced) > MAX_FUNCTIONS:
            raise not_ported(
                f"more than {MAX_FUNCTIONS} fused functions in nd integrate",
                ND_WIDE,
            )
        key = ("integrate_nd", fns_key(traced), kinds)
        if weight is not None:
            key += (("is_weight_nd", tuple(fns_key(pair) for pair in weight)),)
        return self._cache.get_or_build(
            key, lambda: IntegrateNdProgram(traced, kinds, weight))

    def _run_nd(
        self, program, dists, n_samples, seed, method, return_stderr,
        qmc_rotations,
    ):
        """(values, stderr or None) of one nd run of ``program`` over the
        Distributions ``dists`` on the kernel, float64 arrays: means over
        the plan's ``actual_samples``; error bars from pilot-shifted
        squares, or under ``qmc`` from ``qmc_rotations`` rotations
        (randomized QMC, the JAX package's ``_integrate_nd``,
        api/integrate.py:694), one launch each."""
        cfg = NdConfig(program.kinds, method,
                       with_stderr=return_stderr and method != "qmc")
        if return_stderr and method == "qmc" and qmc_rotations < 2:
            raise ValueError(
                "qmc_rotations must be >= 2 to estimate an rQMC "
                f"error bar (got {qmc_rotations})"
            )
        params = torch.tensor(
            np.stack([dist_spec_of(dd).params for dd in dists]),
            device=self._device,
        )
        tables = nd_tables(dists, cfg, self._device, program.sampler_dims)
        if return_stderr and method == "qmc":
            r = qmc_rotations
            grid = self._grid(-(-n_samples // r), method)
            seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(
                r, dtype=np.uint32
            )
            vals = np.stack(
                [
                    self._nd_means(program, cfg, params, int(s), grid, tables)
                    for s in seeds
                ]
            ).astype(np.float64)
            return vals.mean(axis=0), vals.std(axis=0, ddof=1) / np.sqrt(r)
        grid = self._grid(n_samples, method)
        seed_word = int(np.uint32(seed))
        if not cfg.with_stderr:
            return self._nd_means(program, cfg, params, seed_word, grid,
                                  tables), None
        pilot = pilot_row(program.torch_fns, cfg.kinds, params, tables,
                          program.torch_weight)
        sums, sqs = integrate_nd_cuda(
            program, cfg, params, seed_word, grid, pilot, tables
        )
        mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
        return mean.cpu().numpy(), se.cpu().numpy()

    @staticmethod
    def _nd_means(program, cfg, params, seed_word, grid,
                  tables=None) -> np.ndarray:
        sums = integrate_nd_cuda(program, cfg, params, seed_word, grid,
                                 tables=tables)
        return (sums / float(np.float32(grid.actual_samples))).cpu().numpy()

    # -- surfaces of the JAX package not ported yet -------------------------

    def compile_integrate(self, functions, distribution, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError`` naming the
        ROADMAP item (nd or 1-D)."""
        if _as_dims(distribution) is not None:
            raise not_ported("compile_integrate, seed_batch and param_batch "
                             "for nd integrate", ND_SERVING)
        raise not_ported("compile_integrate, seed_batch and param_batch",
                         VARIANTS)

    def expectation_fn(self, functions, distribution, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError`` naming the
        ROADMAP item (nd or 1-D)."""
        if _as_dims(distribution) is not None:
            raise not_ported("expectation_fn for nd integrate", ND_CV)
        raise not_ported("expectation_fn", API_SURFACE)
