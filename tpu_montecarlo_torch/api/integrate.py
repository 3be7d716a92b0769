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
    integrate_batch,
    integrate_cuda,
    library_route,
    pilot_values,
    plan_grid,
)
from ..ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    integrate_nd_batch,
    integrate_nd_cuda,
    nd_routes,
    pilot_row,
)
from ..sampling import DistKind, dist_spec_of, ensure_param_batch_family
from ..utils.dispatch import make_integrate_plan
from ..utils.roadmap import (
    API_SURFACE,
    ND_CV,
    ND_WIDE,
    VARIANTS,
    not_ported,
)
from .batching import _check_nd_params, _checked_batch_prog, stage_seeds
from .cache import fns_key
from .device import nd_tables, sampling_tables
from .results import IntegrationResult

def _rotation_seeds(seed, r: int) -> np.ndarray:
    """The seed words of ``r`` rQMC rotations: distinct words give
    independent rotations, and the golden-ratio stride keeps consecutive
    user seeds apart (``tpu_montecarlo/api/integrate.py:160-174``)."""
    return np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(
        r, dtype=np.uint32)


def _check_rotations(qmc_rotations: int) -> None:
    if qmc_rotations < 2:
        raise ValueError(
            "qmc_rotations must be >= 2 to estimate an rQMC "
            f"error bar (got {qmc_rotations})"
        )


def _finished(sums: torch.Tensor, pilot, grid, antithetic: bool):
    """A handle's result from a launch's (..., K) sums, or (..., 2, K)
    sums and squares with error bars: the means, float32 on the sums'
    device, or (means, standard errors)."""
    if pilot is None:
        return sums / float(np.float32(grid.actual_samples))
    return finish_stderr(sums[..., 0, :], sums[..., 1, :], pilot, grid,
                         antithetic)


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
        values, stderr = self._run(
            self._integrate_handle, program, distribution, n_samples, seed,
            method, return_stderr, qmc_rotations,
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

    def _run(self, handle, program, dists, n_samples, seed, method,
             return_stderr, qmc_rotations):
        """(values, stderr or None) of one run of ``program`` over
        ``dists`` (a Distribution, or nd's list), float64 arrays, through
        the serving handle ``handle`` builds (``_integrate_handle`` or
        ``_nd_handle``): means over the plan's ``actual_samples``; error
        bars from pilot-shifted squares, or under ``qmc`` from
        ``qmc_rotations`` rotations in one seed-batched launch
        (randomized QMC, the JAX package's api/integrate.py:152-174)."""
        if return_stderr and method == "qmc":
            _check_rotations(qmc_rotations)
            r = qmc_rotations
            prog = handle(program, dists, -(-n_samples // r), r, "qmc", False,
                          False)
            vals = prog(_rotation_seeds(seed, r)).cpu().numpy()
            vals = vals.astype(np.float64)
            return vals.mean(axis=0), vals.std(axis=0, ddof=1) / np.sqrt(r)
        out = handle(program, dists, n_samples, 1, method, False,
                     return_stderr)(seed)
        if return_stderr:
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        return out.cpu().numpy(), None

    def _grid(self, n_samples, method):
        plan = make_integrate_plan(n_samples, self._target_threads)
        return plan_grid(plan.actual_samples, method)

    # -- multi-dimensional (kernel 2, ops/integrate_nd_kernel.py) -----------

    def _integrate_nd(
        self, functions, dists, n_samples, seed, method, return_stderr,
        qmc_rotations,
    ) -> IntegrationResult:
        kinds = tuple(dist_spec_of(dd).kind for dd in dists)
        NdConfig(kinds, method)  # the method and Sobol dimension errors first
        traced = self._trace_user_functions(functions, n_args=len(kinds))
        program = self._nd_program(traced, kinds)
        values, stderr = self._run(self._nd_handle, program, dists, n_samples,
                                   seed, method, return_stderr, qmc_rotations)
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

    # -- serving handles ----------------------------------------------------

    def compile_integrate(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        seed_batch: int = 1,
        method: str = "mc",
        param_batch: bool = False,
        return_stderr: bool = False,
    ) -> Callable:
        """Ahead-of-time handle for serving (the JAX package's
        ``compile_integrate``): tracing, the program, the tables, the
        error-bar pilot and the kernel's library are made once, here; a
        call stages its seeds (and params) and launches, without waiting
        for the device.  The handle returns float32 tensors on the
        integrator's device.

        ``prog(seed) -> (K,)``; with ``seed_batch=R``, ``prog(seeds) ->
        (R, K)``: R jobs in one launch of the kernel, each element equal
        bit for bit to ``prog(seeds[r])`` of an unbatched handle.  A CUDA
        tensor of seeds (int32 or int64 words) is used as it is.

        ``param_batch=True``: ``prog(seeds, params) -> (R, K)`` (also at R
        = 1) with ``params`` the (R, 2) rows of :func:`pack_param_batch`
        for the family of ``distribution``; row r equals an unbatched call
        under its Distribution, bit for bit.  Closed-form families only.

        ``return_stderr=True``: pairs ``(values, stderrs)`` of those
        shapes, from pilot-shifted squares in the same launch (a param
        batch's pilots per row), under ``method="qmc"`` too, as the JAX
        package's handle gives them (``integrate``'s rQMC error bars
        come from rotations instead: a seed batch of rotation seeds
        serves those).

        ``distribution`` may be a sequence of d >= 2 Distributions: the
        handle then serves nd integrate in the nd kernel, and
        ``param_batch`` takes (R, d, 2) rows (:func:`pack_param_batch_nd`,
        closed-form dimensions only).  CUSTOM tables (1-D or as
        dimensions) take seed batches."""
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        dists = _as_dims(distribution)
        if dists is not None and len(dists) > 1:
            kinds = tuple(dist_spec_of(dd).kind for dd in dists)
            NdConfig(kinds, method)
            traced = self._trace_user_functions(functions, n_args=len(kinds))
            if param_batch:
                for kind in kinds:
                    ensure_param_batch_family(kind)
            return self._nd_handle(self._nd_program(traced, kinds), dists,
                                   n_samples, seed_batch, method, param_batch,
                                   return_stderr)
        if dists is not None:
            distribution = dists[0]
        if method not in METHODS:
            raise ValueError(
                f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
            )
        traced = self._trace_user_functions(functions)
        if param_batch:
            ensure_param_batch_family(dist_spec_of(distribution).kind)
        return self._integrate_handle(self._integrate_program(traced),
                                      distribution, n_samples, seed_batch,
                                      method, param_batch, return_stderr)

    def _integrate_handle(self, program, distribution, n_samples, seed_batch,
                          method, param_batch, return_stderr) -> Callable:
        """The handle of a 1-D program (an integrand set, or an importance
        set) over ``distribution``, with everything but the launch made
        here."""
        spec = dist_spec_of(distribution)
        kind = spec.kind
        cfg = IntegrateConfig(method, return_stderr)
        grid = self._grid(n_samples, method)
        dev = self._device
        params = torch.tensor(spec.params, device=dev)
        tables = None
        if kind == DistKind.CUSTOM:
            tables = sampling_tables(distribution, spec, dev,
                                     with_pdf=program.sampler)
        pilot = None
        if return_stderr and not param_batch:
            pilot = pilot_values(program.torch_values, kind, params, tables)
        if dev.type == "cuda":
            program.library(cfg, library_route(kind, tables))

        def finished(sums, pilot):
            return _finished(sums, pilot, grid, cfg.antithetic)

        if param_batch:
            def dispatch(seeds, rows):
                (rows,) = rows
                pilots = None
                if return_stderr:
                    pilots = pilot_values(program.torch_values, kind, rows)
                return finished(integrate_batch(program, kind, rows, seeds,
                                                grid, cfg, pilots, tables),
                                pilots)

            return _checked_batch_prog(dispatch, seed_batch, 1, (kind,), dev)
        if seed_batch != 1:
            def prog(seeds):
                seeds = stage_seeds(seeds, seed_batch, dev)
                return finished(integrate_batch(program, kind, params, seeds,
                                                grid, cfg, pilot, tables),
                                pilot)

            return prog

        def prog(seed):
            # np.uint32 rejects seeds outside [0, 2**32), as the JAX
            # package does.
            word = int(np.uint32(seed))
            return finished(integrate_cuda(program, kind, params, word, grid,
                                           cfg, pilot, tables), pilot)

        return prog

    def _nd_handle(self, program, dists, n_samples, seed_batch, method,
                   param_batch, return_stderr) -> Callable:
        """The handle of an nd program (an integrand set, or an nd
        importance set) over the Distributions ``dists``, with everything
        but the launch made here."""
        cfg = NdConfig(program.kinds, method, with_stderr=return_stderr)
        grid = self._grid(n_samples, method)
        dev = self._device
        params = torch.tensor(
            np.stack([dist_spec_of(dd).params for dd in dists]), device=dev)
        tables = nd_tables(dists, cfg, dev, program.sampler_dims)
        pilot = None
        if return_stderr and not param_batch:
            pilot = pilot_row(program.torch_fns, cfg.kinds, params, tables,
                              program.torch_weight)
        if dev.type == "cuda":
            program.library(nd_routes(cfg, tables))

        def finished(sums, pilot):
            return _finished(sums, pilot, grid, cfg.antithetic)

        if param_batch:
            def prog(seeds, params):
                seeds, rows = _check_nd_params(seeds, params, seed_batch,
                                               cfg.d, cfg.kinds, dev)
                pilots = None
                if return_stderr:
                    pilots = pilot_row(program.torch_fns, cfg.kinds, rows,
                                       tables, program.torch_weight)
                return finished(integrate_nd_batch(program, cfg, rows, seeds,
                                                   grid, pilots, tables),
                                pilots)

            return prog
        if seed_batch != 1:
            def prog(seeds):
                seeds = stage_seeds(seeds, seed_batch, dev)
                return finished(integrate_nd_batch(program, cfg, params, seeds,
                                                   grid, pilot, tables), pilot)

            return prog

        def prog(seed):
            word = int(np.uint32(seed))
            return finished(integrate_nd_cuda(program, cfg, params, word, grid,
                                              pilot, tables), pilot)

        return prog

    # -- surfaces of the JAX package not ported yet -------------------------

    def expectation_fn(self, functions, distribution, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError`` naming the
        ROADMAP item (nd or 1-D)."""
        if _as_dims(distribution) is not None:
            raise not_ported("expectation_fn for nd integrate", ND_CV)
        raise not_ported("expectation_fn", API_SURFACE)
