"""Importance sampling over one dimension and over d (port of
``tpu_montecarlo/api/importance.py``).

Each integrand is weighted by ``p(x) / q(x)`` inside the 1-D integrate
kernel, on samples of the proposal (``IntegrateProgram(fns, weight=(p,
q))``, ``ops/lower.py``): the weight is made once per sample, as the JAX
kernel's ``is_weight`` makes it.  The densities come from the JAX
package's traceability probe (``_pdf_mode``):

* both trace: closed-form densities (the JAX package folds them into
  each integrand, its ``_weighted_fns`` closure, a few ulp apart);
* otherwise its non-traced route (``importance.py:255-430``): a density
  that does not trace becomes a pdf table on a uniform grid (resampled
  within a bound where the table's grid is irregular, then downsampled),
  read in the kernel; an irregular-grid CUSTOM proposal that no uniform
  grid represents but whose table is self-normalised takes q from its
  own sampler (``"sampler"``); where neither holds, the closure
  fallback's table lookups, over the irregular grid by a knot search.

A density that uses a construct the port's front end does not have yet
raises its ``NotImplementedError`` (ROADMAP.md item 3): the reference
computes it in closed form, so it does not take the table route here.

Sequences of d >= 2 targets and proposals run in the nd integrate kernel
(``IntegrateNdProgram(fns, kinds, weight)``), weighted by the product
prod_j p_j(x_j) / q_j(x_j) in dimension order, as the JAX package's
kernel route (``_try_is_nd_kernel``) weighs them; each factor traced, a
uniform-grid table, an irregular-grid one, or, for a non-gapped CUSTOM
proposal dimension, the sampler's own density.  The JAX package folds
what its kernel route refuses into the integrands on its XLA sweep; the
port keeps it in the kernel (``_is_weight_dim``).

``compile_importance_sampling`` makes the same weighted programs into a
serving handle, over one Distribution or over sequences, with seed
batches on the kernels' batch axis.
"""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np

from ..distributions import Distribution
from ..ops.integrate_kernel import SAMPLER, KnotWeightTable, UniformWeightTable
from ..sampling import DistKind, dist_spec_of
from ..tracing import TraceError, trace_function
from .device import _device_mode_tables, _uniform_table_mode
from .results import IntegrationResult, _unit_integrand, _weight_diagnostics


class _ImportanceMixin:
    def integrate_importance_sampling(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Distribution,
        n_samples: int = 1_000_000,
        seed: int = 42,
        method: str = "mc",
        return_stderr: bool = False,
        qmc_rotations: int = 8,
        return_diagnostics: bool = False,
    ) -> IntegrationResult:
        """Compute E_p[f(X)] sampling from q with weights p(x)/q(x).

        All K functions share samples and see identical weights:
        ``f(x) * where(q > 0, p(x) / q(x), 0)``.  The proposal is a
        Distribution of any family: closed-form (uniform, normal,
        exponential, the extended families) or CUSTOM.  A density that traces is evaluated in closed
        form; one that does not is read from its pdf table (the module
        docstring lists the routes).

        ``method`` is ``"mc"``, ``"antithetic"`` or ``"qmc"``, as for
        :meth:`integrate`.  ``return_stderr=True``: ``result.stderr``
        estimates the standard error of each weighted estimator
        f_i(X) p(X)/q(X), from pilot-shifted squares, or under ``"qmc"``
        from ``qmc_rotations`` independent rotations (randomized QMC).

        ``return_diagnostics=True``: ``result.diagnostics`` reports the
        proposal's quality from the weight's moments: ``"ess"`` (Kish
        effective sample size (sum w)^2 / sum w^2), ``"mean_weight"``
        (about 1 when both densities are normalized) and ``"weight_cv"``
        (the weight's coefficient of variation; ess = n / (1 + cv^2)).
        They come from one more integrand, the constant 1 weighted (the
        weight itself), and its error bar, in the same launch.
        ``method="mc"`` only."""
        t_seq = isinstance(target_distribution, (list, tuple))
        q_seq = isinstance(proposal_distribution, (list, tuple))
        if t_seq or q_seq:
            targets, proposals = _is_dims(target_distribution,
                                          proposal_distribution)
            if len(targets) > 1:
                return self._integrate_is_nd(
                    functions, targets, proposals, n_samples, seed, method,
                    return_stderr, qmc_rotations, return_diagnostics)
            target_distribution = targets[0]
            proposal_distribution = proposals[0]
        if return_diagnostics and method != "mc":
            raise ValueError(
                "return_diagnostics estimates the per-sample weight "
                "variance, an iid quantity; use method='mc' (got "
                f"method={method!r})"
            )
        traced = self._trace_user_functions(functions)
        weight = self._is_weight(target_distribution, proposal_distribution)
        if return_diagnostics:
            # The weight's mean and spread: the weighted constant 1 and
            # its error bar.
            traced += (_unit_integrand(),)
        values, stderr = self._run(
            self._integrate_handle, self._integrate_groups(traced, weight),
            proposal_distribution, n_samples, seed, method,
            return_stderr or return_diagnostics, qmc_rotations,
        )
        return _is_result(values, stderr, n_samples, len(functions),
                          return_stderr, return_diagnostics)

    def _integrate_is_nd(
        self, functions, targets, proposals, n_samples, seed, method,
        return_stderr, qmc_rotations, return_diagnostics,
    ) -> IntegrationResult:
        """d-dimensional importance sampling (the JAX package's
        ``_integrate_is_nd``): each dimension drawn from its proposal,
        every integrand times the product weight prod_j p_j(x_j) /
        q_j(x_j) in the nd kernel, in every method; the diagnostics'
        weight column is the weighted constant 1 of d arguments."""
        d = len(targets)
        traced = self._trace_user_functions(functions, n_args=d)
        if return_diagnostics:
            if method != "mc":
                raise ValueError(
                    "return_diagnostics estimates the per-sample weight "
                    "variance, an iid quantity; use method='mc' (got "
                    f"method={method!r})"
                )
            traced = traced + (_unit_integrand(d),)
        weight = tuple(self._is_weight_dim(t, q)
                       for t, q in zip(targets, proposals))
        kinds = tuple(dist_spec_of(q).kind for q in proposals)
        values, stderr = self._run(
            self._nd_handle, self._nd_groups(traced, kinds, weight),
            proposals, n_samples, seed, method,
            return_stderr or return_diagnostics, qmc_rotations,
        )
        return _is_result(values, stderr, n_samples, len(functions),
                          return_stderr, return_diagnostics)

    def _is_weight_dim(self, target: Distribution, proposal: Distribution):
        """One dimension's (p, q) of an nd importance set, as the JAX
        package's kernel route (``_try_is_nd_kernel``,
        ``importance.py:585-729``) takes them: p traced or a downsampled
        uniform-grid table; q the proposal's sampler density where it is a
        non-gapped CUSTOM table, else traced.  Where that route gives up
        (a table p with no uniform grid, a gapped or heavy-tailed CUSTOM
        proposal, a q that does not trace), the port stays in its kernel
        with the densities its folded route reads: traced, a uniform-grid
        table, or the table on its own grid by a knot search."""
        spec = dist_spec_of(proposal)
        if spec.kind == DistKind.CUSTOM and not spec.exact_inverse:
            q = SAMPLER
        else:
            q = self._density(proposal, "proposal")
        return self._density(target, "target"), q

    def _density(self, dist: Distribution, role: str):
        """A density of an nd weight: traced; else its table on a uniform
        grid (downsampled, as the 1-D kernel route reads it); else the
        table on its own grid."""
        mode = self._pdf_mode(dist)
        if mode[0] == "traced":
            return mode[1]
        uniform = _uniform_table_mode(dist, mode, role)
        if uniform is None:
            return _knot_table(dist, mode)
        return _kernel_mode(dist, uniform, role)

    def compile_importance_sampling(
        self,
        functions: List[Union[Callable, str]],
        target_distribution: Distribution,
        proposal_distribution: Distribution,
        n_samples: int = 1_000_000,
        seed_batch: int = 1,
        method: str = "mc",
        return_stderr: bool = False,
    ) -> Callable:
        """Ahead-of-time importance-sampling handle (the JAX package's
        ``compile_importance_sampling``): ``prog(seed) -> (K,)``; with
        ``seed_batch=R``, ``prog(seeds) -> (R, K)`` in one launch, each
        element equal bit for bit to its unbatched call; with
        ``return_stderr=True``, ``(values, stderrs)`` pairs.  The weight's
        densities are traced, or made into tables, once, here, as
        :meth:`integrate_importance_sampling` routes them; sequences of d
        >= 2 targets and proposals give an nd handle in the nd kernel."""
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        t_seq = isinstance(target_distribution, (list, tuple))
        q_seq = isinstance(proposal_distribution, (list, tuple))
        if t_seq or q_seq:
            targets, proposals = _is_dims(target_distribution,
                                          proposal_distribution)
            if len(targets) > 1:
                traced = self._trace_user_functions(functions,
                                                    n_args=len(targets))
                weight = tuple(self._is_weight_dim(t, q)
                               for t, q in zip(targets, proposals))
                kinds = tuple(dist_spec_of(q).kind for q in proposals)
                return self._nd_handle(
                    self._nd_groups(traced, kinds, weight), proposals,
                    n_samples, seed_batch, method, False, return_stderr)
            target_distribution = targets[0]
            proposal_distribution = proposals[0]
        traced = self._trace_user_functions(functions)
        weight = self._is_weight(target_distribution, proposal_distribution)
        return self._integrate_handle(
            self._integrate_groups(traced, weight), proposal_distribution,
            n_samples, seed_batch, method, False, return_stderr)

    @staticmethod
    def _pdf_mode(dist: Distribution):
        """``("traced", fn)`` when the PDF traces, else ``("table", x,
        pdf)``: the JAX package's traceability probe
        (``importance.py:432-441``), which catches ``TraceError`` and
        ``TypeError`` only.  The front end's ``NotImplementedError`` (a
        construct the port does not trace yet, which the reference
        does) propagates."""
        try:
            return ("traced", trace_function(dist._pdf_func))
        except (TraceError, TypeError):
            pass
        x_table, pdf_table = dist.get_or_compute_pdf_table()
        return ("table", x_table, pdf_table)

    def _is_weight(self, target: Distribution, proposal: Distribution):
        """The program weight ``(p, q)`` of an importance-sampling run,
        routed as the JAX package's ``_get_is_program``
        (``importance.py:236-430``): two traced densities; else each
        density traced, a downsampled uniform-grid table, or q the
        proposal's sampler; else the closure fallback's knot-searched
        tables."""
        p_mode = self._pdf_mode(target)
        q_mode = self._pdf_mode(proposal)
        if p_mode[0] == "traced" and q_mode[0] == "traced":
            return (p_mode[1], q_mode[1])
        spec = dist_spec_of(proposal)
        p_k = _uniform_table_mode(target, p_mode)
        q_k = _uniform_table_mode(proposal, q_mode, "proposal")
        if (q_k is None and spec.kind == DistKind.CUSTOM
                and not spec.exact_inverse):
            # Only a self-normalised table keeps the reference's
            # face-value weights under the sampler's own density.
            x_t = np.asarray(q_mode[1], np.float64)
            v_t = np.asarray(q_mode[2], np.float64)
            if abs(_trapezoid(v_t, x_t) - 1.0) <= 1e-3:
                q_k = ("sampler",)
        if p_k is None or q_k is None:
            return tuple(m[1] if m[0] == "traced" else _knot_table(d, m)
                         for d, m in ((target, p_mode), (proposal, q_mode)))
        return (_kernel_mode(target, p_k, "target"),
                _kernel_mode(proposal, q_k, "proposal"))


def _is_dims(target_distribution, proposal_distribution):
    """(targets, proposals) of an importance run over sequences, after
    the JAX package's checks (``importance.py:118-140``)."""
    if not (isinstance(target_distribution, (list, tuple))
            and isinstance(proposal_distribution, (list, tuple))):
        raise TypeError(
            "multi-dimensional importance sampling needs BOTH "
            "target and proposal as sequences of Distributions"
        )
    targets = list(target_distribution)
    proposals = list(proposal_distribution)
    if (
        not targets
        or len(targets) != len(proposals)
        or not all(
            isinstance(dd, Distribution)
            for dd in targets + proposals
        )
    ):
        raise TypeError(
            "target/proposal sequences must be equal-length "
            "non-empty lists of Distribution objects"
        )
    return targets, proposals


def _is_result(values, stderr, n_samples, n_functions, return_stderr,
               return_diagnostics) -> IntegrationResult:
    """An importance run's result; with diagnostics, the last column is
    the weight's (its mean and error bar give them) and is dropped."""
    if not return_diagnostics:
        return IntegrationResult(values=values, n_samples=n_samples,
                                 n_functions=n_functions, stderr=stderr)
    v = np.asarray(values, np.float64)
    s = np.asarray(stderr, np.float64)
    return IntegrationResult(
        values=v[:-1], n_samples=n_samples, n_functions=n_functions,
        stderr=s[:-1] if return_stderr else None,
        diagnostics=_weight_diagnostics(v[-1], s[-1], n_samples),
    )


# numpy < 2.0 names it trapz.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _kernel_mode(dist: Distribution, mode, role: str):
    """One density of a kernel-weighted program: traced, the sampler's,
    or a :class:`UniformWeightTable` of the downsampled table, cached per
    Distribution and role."""
    if mode[0] == "traced":
        return mode[1]
    if mode[0] == "sampler":
        return SAMPLER
    attr = f"_weight_table_{role}"
    table = getattr(dist, attr, None)
    if table is None:
        table = UniformWeightTable(*_device_mode_tables(dist, mode, role))
        setattr(dist, attr, table)
    return table


def _knot_table(dist: Distribution, mode) -> KnotWeightTable:
    """A table density of the closure fallback, at full resolution on its
    own grid, cached per Distribution."""
    table = getattr(dist, "_weight_knot_table", None)
    if table is None:
        table = KnotWeightTable(mode[1], mode[2])
        dist._weight_knot_table = table
    return table
