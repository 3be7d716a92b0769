"""Monte Carlo integration, 1-D and multi-dimensional (port of the
1-D and nd paths of ``tpu_montecarlo/api/integrate.py``), with its
multi-pass path over more than 128 functions (``api/passes.py``),
control variates and differentiable expectations
(``expectation_fn``, ``api/expectation.py``)."""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np
import torch

from ..distributions import Distribution
from ..ops.integrate_kernel import (
    LANES,
    MAX_FUNCTIONS,
    MAX_GRAD_FUNCTIONS,
    METHODS,
    WIDE_K,
    IntegrateConfig,
    IntegrateProgram,
    finish_stderr,
    integrate_batch,
    integrate_cuda,
    integrate_grad_cuda,
    library_route,
    pilot_values,
    plan_grid,
)
from ..ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    integrate_nd_batch,
    integrate_nd_cuda,
    integrate_nd_grad_cuda,
    max_grad_functions,
    nd_routes,
    pilot_row,
)
from ..ops.lower import to_torch
from ..sampling import DistKind, dist_spec_of, ensure_param_batch_family
from ..tracing import product, shifted
from ..utils.dispatch import make_integrate_plan
from .batching import _check_nd_params, _checked_batch_prog, stage_seeds
from .cache import fns_key
from .device import nd_tables, sampling_tables
from .expectation import estimator
from .passes import build_all, cat_passes, split_groups
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


def cv_composed(traced_f, traced_g, dists, return_stderr: bool):
    """``(composed, a, b)`` of a control-variate run: the set the run
    integrates in ``_integrate_with_cv``'s order (f, g, the f*g products,
    the g*g upper triangle, f*f under error bars), pilot-shifted by ``a``
    and ``b``, each function's float32 mean over an (8, 128) block of the
    distributions' medians on the host's plain lowering."""
    meds = [torch.full((8, LANES), float(dd.quantile(0.5)),
                       dtype=torch.float32) for dd in dists]

    def pilot(t):
        return float(to_torch(t)(*meds).mean())

    a = np.array([pilot(t) for t in traced_f])
    b = np.array([pilot(t) for t in traced_g])
    sf = [shifted(t, ai) for t, ai in zip(traced_f, a)]
    sg = [shifted(t, bj) for t, bj in zip(traced_g, b)]
    k, n_cv = len(sf), len(sg)
    composed = list(traced_f) + list(traced_g)
    composed += [product(sf[i], sg[j]) for i in range(k) for j in range(n_cv)]
    composed += [product(sg[j], sg[l]) for j in range(n_cv)
                 for l in range(j, n_cv)]
    if return_stderr:
        composed += [product(sf[i], sf[i]) for i in range(k)]
    return tuple(composed), a, b


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

        More than 128 functions run as passes of at most 128 over the
        identical stream (``api/passes.py``), one launch each.

        ``control_variates=[(g, E[g]), ...]`` (``"mc"`` only, 1-D or nd):
        each estimate is corrected by controls of known mean,
        ``theta_i = mean(f_i) - c_i^T (mean(g) - E[g])`` with the
        regression coefficients ``c_i = Cov(g)^-1 Cov(g, f_i)``, from one
        run of the composed set (:meth:`_integrate_with_cv`); the error
        bars are the regression's residual ones."""
        if control_variates is not None:
            return self._integrate_with_cv(
                functions, distribution, n_samples, seed, method,
                return_stderr, control_variates,
            )
        dists = _as_dims(distribution)
        if dists is not None and len(dists) > 1:
            return self._integrate_nd(
                functions, dists, n_samples, seed, method, return_stderr,
                qmc_rotations,
            )
        if dists is not None:
            distribution = dists[0]
        if method not in METHODS:
            raise ValueError(
                f"method must be 'mc', 'qmc' or 'antithetic', got {method!r}"
            )
        traced = self._trace_user_functions(functions)
        values, stderr = self._run(
            self._integrate_handle, self._integrate_groups(traced),
            distribution, n_samples, seed, method, return_stderr,
            qmc_rotations,
        )
        return IntegrationResult(
            values=values, n_samples=n_samples, n_functions=len(functions),
            stderr=stderr,
        )

    # -- 1-D (kernel 1, ops/integrate_kernel.py) ----------------------------

    def _integrate_program(self, traced, weight=None) -> IntegrateProgram:
        """The cached program of a traced set of at most 128 functions,
        weighted by ``weight=(p, q)`` for importance sampling (each a
        traced density, a weight table or the sampler's density, keyed by
        content)."""
        key = ("integrate", fns_key(traced))
        if weight is not None:
            key += (("is_weight", fns_key(weight)),)
        return self._cache.get_or_build(
            key, lambda: IntegrateProgram(traced, weight)
        )

    def _integrate_groups(self, traced, weight=None) -> tuple:
        """The cached programs of a traced set's groups of at most 128
        functions (``api/passes.py``), each under the set's ``weight``:
        one program when the set has at most 128."""
        return tuple(self._integrate_program(group, weight)
                     for group in split_groups(traced, MAX_FUNCTIONS))

    def _run(self, handle, programs, dists, n_samples, seed, method,
             return_stderr, qmc_rotations):
        """(values, stderr or None) of one run of the groups ``programs``
        over ``dists`` (a Distribution, or nd's list), float64 arrays,
        through the serving handle ``handle`` builds
        (``_integrate_handle`` or ``_nd_handle``): means over the plan's
        ``actual_samples``; error
        bars from pilot-shifted squares, or under ``qmc`` from
        ``qmc_rotations`` rotations in one seed-batched launch
        (randomized QMC, the JAX package's api/integrate.py:152-174)."""
        if return_stderr and method == "qmc":
            _check_rotations(qmc_rotations)
            r = qmc_rotations
            prog = handle(programs, dists, -(-n_samples // r), r, "qmc",
                          False, False)
            vals = prog(_rotation_seeds(seed, r)).cpu().numpy()
            vals = vals.astype(np.float64)
            return vals.mean(axis=0), vals.std(axis=0, ddof=1) / np.sqrt(r)
        out = handle(programs, dists, n_samples, 1, method, False,
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
        values, stderr = self._run(self._nd_handle,
                                   self._nd_groups(traced, kinds), dists,
                                   n_samples, seed, method, return_stderr,
                                   qmc_rotations)
        return IntegrationResult(values=values, stderr=stderr,
                                 n_samples=n_samples,
                                 n_functions=len(functions))

    def _nd_program(self, traced, kinds, weight=None) -> IntegrateNdProgram:
        """The cached nd program of a traced set of at most 128 functions
        over ``kinds``, weighted by ``weight`` (one (p, q) pair per
        dimension) for importance sampling."""
        key = ("integrate_nd", fns_key(traced), kinds)
        if weight is not None:
            key += (("is_weight_nd", tuple(fns_key(pair) for pair in weight)),)
        return self._cache.get_or_build(
            key, lambda: IntegrateNdProgram(traced, kinds, weight))

    def _nd_groups(self, traced, kinds, weight=None) -> tuple:
        """The cached nd programs of a traced set's groups of at most 128
        functions (``api/passes.py``)."""
        return tuple(self._nd_program(group, kinds, weight)
                     for group in split_groups(traced, MAX_FUNCTIONS))

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
        dimensions) take seed batches.

        More than 128 functions: a call launches each group of at most
        128 once over the same stream and concatenates the results on
        the function axis (``api/passes.py``), param batches too (the JAX
        package sends those to XLA)."""
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
            return self._nd_handle(self._nd_groups(traced, kinds), dists,
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
        return self._integrate_handle(self._integrate_groups(traced),
                                      distribution, n_samples, seed_batch,
                                      method, param_batch, return_stderr)

    def _integrate_handle(self, programs, distribution, n_samples, seed_batch,
                          method, param_batch, return_stderr) -> Callable:
        """The handle of a 1-D set (integrands, or an importance set) over
        ``distribution``, given as its groups ``programs``
        (``_integrate_groups``), with everything but the launches made
        here.  A call launches each group once over the same stream and
        concatenates their results on the function axis."""
        spec = dist_spec_of(distribution)
        kind = spec.kind
        cfg = IntegrateConfig(method, return_stderr)
        grid = self._grid(n_samples, method)
        dev = self._device
        params = torch.tensor(spec.params, device=dev)
        tables = None
        if kind == DistKind.CUSTOM:
            # Every group carries the set's weight: one set of tables.
            tables = sampling_tables(distribution, spec, dev,
                                     with_pdf=programs[0].sampler)
        pilots = [None] * len(programs)
        if return_stderr and not param_batch:
            pilots = [pilot_values(p.torch_values, kind, params, tables)
                      for p in programs]
        if dev.type == "cuda":
            route = library_route(kind, tables)
            build_all([lambda p=p: p.library(cfg, route) for p in programs])

        def passes(launch, pilots):
            return cat_passes([
                _finished(launch(p, pilot), pilot, grid, cfg.antithetic)
                for p, pilot in zip(programs, pilots)])

        if param_batch:
            def dispatch(seeds, rows):
                (rows,) = rows
                row_pilots = [None] * len(programs)
                if return_stderr:
                    row_pilots = [pilot_values(p.torch_values, kind, rows)
                                  for p in programs]
                return passes(
                    lambda p, pilot: integrate_batch(
                        p, kind, rows, seeds, grid, cfg, pilot, tables),
                    row_pilots)

            return _checked_batch_prog(dispatch, seed_batch, 1, (kind,), dev)
        if seed_batch != 1:
            def prog(seeds):
                seeds = stage_seeds(seeds, seed_batch, dev)
                return passes(
                    lambda p, pilot: integrate_batch(
                        p, kind, params, seeds, grid, cfg, pilot, tables),
                    pilots)

            return prog

        def prog(seed):
            # np.uint32 rejects seeds outside [0, 2**32), as the JAX
            # package does.
            word = int(np.uint32(seed))
            return passes(
                lambda p, pilot: integrate_cuda(p, kind, params, word, grid,
                                                cfg, pilot, tables),
                pilots)

        return prog

    def _nd_handle(self, programs, dists, n_samples, seed_batch, method,
                   param_batch, return_stderr) -> Callable:
        """The handle of an nd set (integrands, or an nd importance set)
        over the Distributions ``dists``, given as its groups ``programs``
        (``_nd_groups``), with everything but the launches made here; a
        call launches each group once and concatenates their results."""
        cfg = NdConfig(programs[0].kinds, method, with_stderr=return_stderr)
        grid = self._grid(n_samples, method)
        dev = self._device
        params = torch.tensor(
            np.stack([dist_spec_of(dd).params for dd in dists]), device=dev)
        tables = nd_tables(dists, cfg, dev, programs[0].sampler_dims)

        def pilots_of(rows):
            return [pilot_row(p.torch_fns, cfg.kinds, rows, tables,
                              p.torch_weight) for p in programs]

        pilots = [None] * len(programs)
        if return_stderr and not param_batch:
            pilots = pilots_of(params)
        if dev.type == "cuda":
            routes = nd_routes(cfg, tables)
            build_all([lambda p=p: p.library(routes) for p in programs])

        def passes(launch, pilots):
            return cat_passes([
                _finished(launch(p, pilot), pilot, grid, cfg.antithetic)
                for p, pilot in zip(programs, pilots)])

        if param_batch:
            def prog(seeds, params):
                seeds, rows = _check_nd_params(seeds, params, seed_batch,
                                               cfg.d, cfg.kinds, dev)
                return passes(
                    lambda p, pilot: integrate_nd_batch(
                        p, cfg, rows, seeds, grid, pilot, tables),
                    pilots_of(rows) if return_stderr
                    else [None] * len(programs))

            return prog
        if seed_batch != 1:
            def prog(seeds):
                seeds = stage_seeds(seeds, seed_batch, dev)
                return passes(
                    lambda p, pilot: integrate_nd_batch(
                        p, cfg, params, seeds, grid, pilot, tables),
                    pilots)

            return prog

        def prog(seed):
            word = int(np.uint32(seed))
            return passes(
                lambda p, pilot: integrate_nd_cuda(p, cfg, params, word, grid,
                                                   pilot, tables),
                pilots)

        return prog

    # -- control variates (the JAX package's api/integrate.py:535-662) ------

    def _integrate_with_cv(self, functions, distribution, n_samples, seed,
                           method, return_stderr,
                           control_variates) -> IntegrationResult:
        """Control-variate integration: ``theta_i = mean(f_i) - c_i^T
        (mean(g) - E[g])`` with the regression-optimal ``c_i = Cov(g)^-1
        Cov(g, f_i)``, for user controls ``g_j`` of KNOWN means.

        Every moment the correction needs is itself an integrand: the
        pilot-shifted products ``(f_i - a_i)(g_j - b_j)``, ``(g_j -
        b_j)(g_l - b_l)`` and, for error bars, ``(f_i - a_i)^2``,
        composed as IR over the traced functions (``tracing.shifted``,
        ``tracing.product``), fuse with the f and g into ONE set on shared
        samples: the 1-D or nd handle, in passes of at most 128 where the
        set is wider.  The pilots ``a, b`` are the functions' float32
        values at the distributions' medians, fixed shifts that keep
        ``E[XY] - E[X]E[Y]`` away from float32 cancellation.  The
        coefficients are the same-run plug-in (O(1/n) bias; Glasserman,
        "Monte Carlo Methods in Financial Engineering" 4.1), solved by
        least squares, which leaves a degenerate control's coefficient at
        0; the error bars are the per-function regression residual,
        ``sqrt((Var f - cov^T Cov(g)^-1 cov) / n)``, over the grid's
        actual sample count."""
        if method != "mc":
            raise ValueError(
                "control_variates supports method='mc' only "
                "(coefficients and residual variances are iid-sample "
                f"estimates); got method={method!r}"
            )
        pairs = list(control_variates)
        if not pairs:
            raise ValueError(
                "control_variates must be a non-empty list of "
                "(function, known_mean) pairs"
            )
        g_fns, g_means = [], []
        for p in pairs:
            if not (isinstance(p, (list, tuple)) and len(p) == 2):
                raise TypeError(
                    "each control variate is a (function, known_mean) "
                    f"pair, got {p!r}"
                )
            g_fns.append(p[0])
            g_means.append(float(p[1]))
        if isinstance(distribution, (list, tuple)):
            dists = list(distribution)
            if not dists or not all(
                isinstance(dd, Distribution) for dd in dists
            ):
                raise TypeError(
                    "a distribution sequence must be a non-empty list "
                    "of Distribution objects"
                )
        else:
            dists = [distribution]
        d = len(dists)
        k = len(functions)
        n_cv = len(g_fns)
        traced_f = self._trace_user_functions(functions, n_args=d)
        traced_g = self._trace_user_functions(g_fns, n_args=d)

        composed, a, b = cv_composed(traced_f, traced_g, dists,
                                     return_stderr)
        if d > 1:
            kinds = tuple(dist_spec_of(dd).kind for dd in dists)
            NdConfig(kinds, "mc")
            handle = self._nd_handle(self._nd_groups(composed, kinds), dists,
                                     n_samples, 1, "mc", False, False)
        else:
            handle = self._integrate_handle(
                self._integrate_groups(composed), dists[0], n_samples, 1,
                "mc", False, False)
        # The plan the kernel ran: its grid's sample count.
        n_act = self._grid(n_samples, "mc").actual_samples
        out = handle(seed).cpu().numpy().astype(np.float64)

        m_f = out[:k]
        m_g = out[k:k + n_cv]
        pos = k + n_cv
        fg = out[pos:pos + k * n_cv].reshape(k, n_cv)
        pos += k * n_cv
        # Cov(f_i, g_j) = E[(f-a)(g-b)] - (m_f - a)(m_g - b).
        cov_fg = fg - np.outer(m_f - a, m_g - b)
        gram = np.zeros((n_cv, n_cv))
        for j in range(n_cv):
            for l in range(j, n_cv):
                v = out[pos] - (m_g[j] - b[j]) * (m_g[l] - b[l])
                gram[j, l] = gram[l, j] = v
                pos += 1
        # lstsq tolerates degenerate controls (a constant g has zero
        # variance AND zero covariance, so its coefficient is free: the
        # minimum-norm solution sets it to 0).
        coef = np.linalg.lstsq(gram, cov_fg.T, rcond=None)[0]  # (C, K)
        theta = m_f - coef.T.dot(m_g - np.array(g_means))
        stderr = None
        if return_stderr:
            ff = out[pos:pos + k]
            var_f = np.maximum(ff - (m_f - a) ** 2, 0.0)
            explained = np.sum(cov_fg * coef.T, axis=1)
            resid = np.maximum(var_f - explained, 0.0)
            stderr = np.sqrt(resid / float(n_act))
        return IntegrationResult(
            values=theta, n_samples=n_samples, n_functions=k, stderr=stderr,
        )

    # -- differentiable expectations (the JAX package's
    # api/integrate.py:301-405) -----------------------------------------------

    def expectation_fn(
        self,
        functions: List[Union[Callable, str]],
        distribution: Distribution,
        n_samples: int = 1_000_000,
        method: str = "mc",
    ) -> Callable:
        """Differentiable expectation estimator: ``est(params, seed=42) ->
        (K,)``, float32 on the integrator's device, computes E[f_i(X_params)]
        with ``integrate``'s sampling (its value equals ``integrate(fns,
        <family>(*params), n_samples, seed, method)``'s bit for bit).

        ``params`` packs as :func:`pack_param_batch` rows do: a (2,) tensor
        (uniform (min, max), normal (mean, std), exponential (lambda,
        ignored), an extended family its two parameters), or for a list
        of d >= 2 Distributions a (d, 2) tensor of per-dimension rows;
        ``distribution`` gives the families.  Analytic families only:
        CUSTOM tables are built for one Distribution.

        Gradients are pathwise (reparameterisation): with
        ``params.requires_grad`` the estimate is a ``torch.autograd``
        node whose backward pass gives (1/n) sum f'(x) dx/dparams, from
        one launch of the kernel's gradient build per group of functions
        (``api/expectation.py``); an indicator integrand gets zero
        pathwise gradient.  Unlike the JAX package under
        ``backend="pallas"``, nothing here warns: the port's kernels do
        differentiate.  Second-order gradients and ``torch.func.vmap``
        of ``est`` are not ported yet."""
        dists = _as_dims(distribution)
        if dists is not None and len(dists) > 1:
            return self._nd_expectation_fn(functions, dists, n_samples,
                                           method)
        if dists is not None:
            distribution = dists[0]
        spec = dist_spec_of(distribution)
        ensure_param_batch_family(spec.kind, feature="expectation_fn")
        kind = spec.kind
        cfg = IntegrateConfig(method)  # the method's error first
        traced = self._trace_user_functions(functions)
        grid = self._grid(n_samples, method)
        n = float(np.float32(grid.actual_samples))
        route = library_route(kind)
        programs = self._integrate_groups(traced)
        grad_runs = []
        for group in programs:
            wide = len(group.fns) >= WIDE_K
            for sub in split_groups(group.fns, MAX_GRAD_FUNCTIONS):
                gcfg = IntegrateConfig(method, grad=True,
                                       wide_loop=wide and len(sub) < WIDE_K)
                grad_runs.append((self._integrate_program(sub), gcfg))

        def value(row, word):
            row = row.to(device=self._device, dtype=torch.float32)
            return cat_passes([integrate_cuda(p, kind, row, word, grid, cfg)
                               for p in programs]) / n

        def grad(row, word):
            row = row.to(device=self._device, dtype=torch.float32)
            outs = [integrate_grad_cuda(p, kind, row, word, grid, c)
                    for p, c in grad_runs]
            return (torch.cat([s for s, _ in outs]) / n,
                    torch.cat([g for _, g in outs]) / n)

        builds = []
        if self._device.type == "cuda":
            builds = [*(lambda p=p: p.library(cfg, route) for p in programs),
                      *(lambda p=p, c=c: p.library(c, route)
                        for p, c in grad_runs)]
        return estimator(
            (2,), "expected a (2,) params array (pack as pack_param_batch "
            "does)", value, grad, builds)

    def _nd_expectation_fn(self, functions, dists, n_samples, method):
        """``expectation_fn`` over d >= 2 dimensions: ``est(params)`` of a
        (d, 2) tensor, on the nd kernel's value and gradient builds."""
        kinds = tuple(dist_spec_of(dd).kind for dd in dists)
        for kind in kinds:
            ensure_param_batch_family(kind, feature="expectation_fn")
        d = len(kinds)
        cfg = NdConfig(kinds, method)
        gcfg = NdConfig(kinds, method, grad=True)
        traced = self._trace_user_functions(functions, n_args=d)
        grid = self._grid(n_samples, method)
        n = float(np.float32(grid.actual_samples))
        programs = self._nd_groups(traced, kinds)
        grad_programs = [self._nd_program(sub, kinds)
                         for group in programs
                         for sub in split_groups(group.fns,
                                                 max_grad_functions(d))]

        def value(row, word):
            row = row.to(device=self._device, dtype=torch.float32)
            return cat_passes([integrate_nd_cuda(p, cfg, row, word, grid)
                               for p in programs]) / n

        def grad(row, word):
            row = row.to(device=self._device, dtype=torch.float32)
            outs = [integrate_nd_grad_cuda(p, gcfg, row, word, grid)
                    for p in grad_programs]
            return (torch.cat([s for s, _ in outs]) / n,
                    torch.cat([g for _, g in outs]) / n)

        builds = []
        if self._device.type == "cuda":
            builds = [*(p.library for p in programs),
                      *(lambda p=p: p.library(None, True)
                        for p in grad_programs)]
        return estimator(
            (d, 2), f"expected a ({d}, 2) params array (one pack_param_batch "
            "row per dimension)", value, grad, builds)
