"""Importance sampling over one dimension with closed-form weights (port
of the traced-PDF route of ``tpu_montecarlo/api/importance.py``).

Both densities are traced into the integrand IR; each integrand is then
weighted by ``p(x) / q(x)`` inside the 1-D integrate kernel, on samples of
the proposal (``IntegrateProgram(fns, weight=(p, q))``, ``ops/lower.py``).
A density that does not trace would take the JAX package's table
fallback, which needs CUSTOM tables; it raises ``NotImplementedError``
naming that item, as do nd sequences and ``compile_importance_sampling``.
"""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np

from ..distributions import Distribution
from ..tracing import TraceError, trace_function
from ..utils.roadmap import ND_IS, SERVING, TABLES, not_ported
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

        All K functions share samples and see identical weights (the
        weight is folded into each integrand): ``where(q > 0, f(x) * p(x)
        / q(x), 0)``.  The proposal is a uniform, normal or exponential
        Distribution; both densities must trace (closed form).

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
            if not (t_seq and q_seq):
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
            if len(targets) > 1:
                raise not_ported("nd importance sampling (product weights)",
                                 ND_IS)
            target_distribution = targets[0]
            proposal_distribution = proposals[0]
        if return_diagnostics and method != "mc":
            raise ValueError(
                "return_diagnostics estimates the per-sample weight "
                "variance, an iid quantity; use method='mc' (got "
                f"method={method!r})"
            )
        traced = self._trace_user_functions(functions)
        weight = (self._pdf_mode(target_distribution),
                  self._pdf_mode(proposal_distribution))
        if return_diagnostics:
            # The weight's mean and spread: the weighted constant 1 and
            # its error bar.
            traced += (_unit_integrand(),)
        program = self._integrate_program(traced, weight)
        values, stderr = self._run_1d(
            program, proposal_distribution, n_samples, seed, method,
            return_stderr or return_diagnostics, qmc_rotations,
        )
        if not return_diagnostics:
            return IntegrationResult(
                values=values, n_samples=n_samples,
                n_functions=len(functions), stderr=stderr,
            )
        v = np.asarray(values, np.float64)
        s = np.asarray(stderr, np.float64)
        return IntegrationResult(
            values=v[:-1], n_samples=n_samples, n_functions=len(functions),
            stderr=s[:-1] if return_stderr else None,
            diagnostics=_weight_diagnostics(v[-1], s[-1], n_samples),
        )

    def compile_importance_sampling(self, functions, target_distribution,
                                    proposal_distribution, *args, **kwargs):
        """Not ported yet: raises ``NotImplementedError`` naming the
        ROADMAP item."""
        raise not_ported("compile_importance_sampling and its seed_batch",
                         SERVING)

    @staticmethod
    def _pdf_mode(dist: Distribution):
        """The traced density of ``dist``: the JAX package's
        traceability probe (importance.py:432-441), whose other outcome,
        a PDF table, is not ported."""
        try:
            return trace_function(dist._pdf_func)
        except (TraceError, TypeError, NotImplementedError):
            pass
        raise not_ported(
            "importance weights from a PDF that does not trace (the PDF "
            "table fallback)", TABLES,
        )
