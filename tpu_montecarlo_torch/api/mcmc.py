"""MCMC (port of the Pallas paths of ``tpu_montecarlo/api/mcmc.py``):
``integrate_mcmc`` with independence, random-walk and adaptive
random-walk proposals, with error bars on request, and the
``compile_mcmc`` serving handle with seed and param batches, over one
dimension (``ops/mcmc_kernel.py``, HMC too) or d (``api/mcmc_nd.py``),
with chain state to resume from over either, and tempered over a ladder
of temperatures (``api/tempering.py``), under the closed-form families
and CUSTOM tables (``api/device.py`` stages them).

The JAX package routes workloads its Pallas kernel cannot take to an XLA
sweep; the port has no such twin and runs every workload it takes in its
kernel (``ops/mcmc_kernel.py``), in passes of at most 127 functions
where the set is wider (``api/passes.py``; the JAX package sends 128 and
more to XLA).  What it does not take yet raises ``NotImplementedError``
naming its ROADMAP item."""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..distributions import RandomWalk
from ..ops.mcmc_kernel import (
    MAX_FUNCTIONS,
    ChainStart,
    McmcConfig,
    McmcProgram,
    Mode,
    mcmc_batch,
    mcmc_batch_finish,
    mcmc_cuda,
    mcmc_finish,
    plan_chains,
    plan_mcmc_grid,
)
from ..ops.mcmc_tables import DimTables
from ..sampling import dist_spec_of, ensure_param_batch_family
from .batching import (
    _check_random_walk_args,
    _checked_batch_prog,
    stage_seeds,
)
from .cache import fns_key
from .device import mcmc_dim_tables
from .mcmc_nd import hmc_leapfrog, is_nd_call
from .mcmc_result import mcmc_result, with_chain_state
from .passes import (
    build_all,
    cat_passes,
    check_same_chains,
    merge_results,
    split_groups,
)
from .results import IntegrationResult


class _McmcMixin:
    def integrate_mcmc(
        self,
        functions: List[Union[Callable, str]],
        target_distribution,
        proposal_distribution,
        n_steps: int = 10_000,
        n_chains: int = 1024,
        n_burnin: int = 1_000,
        seed: int = 42,
        initial_state=None,
        return_state: bool = False,
        return_stderr: bool = False,
        return_diagnostics: bool = False,
        return_samples: Optional[int] = None,
        temperatures: Optional[List[float]] = None,
    ) -> IntegrationResult:
        """Compute E_p[f(X)] with parallel Metropolis-Hastings chains, one
        chain per CUDA thread.

        ``proposal_distribution`` is a ``Distribution`` (independence
        sampler: acceptance ``log u < log p(x') + log q(x) - log p(x) -
        log q(x')``) or a :class:`RandomWalk` (``x' = x + step * N(0, 1)``,
        acceptance ``log u < log p(x') - log p(x)``; ``adapt=True`` tunes
        the step per chain during burn-in) or an :class:`HMC` (each step
        an L-step leapfrog trajectory from a fresh momentum, over one
        dimension).  Burn-in advances the chains
        without counting; each sampling step adds f(x) to the chain's sums.
        The values are the average over all ``chains_actual`` chains (at
        least 1024: the JAX kernel's grid), ``n_samples`` is ``n_chains *
        n_steps`` and ``acceptance_rate`` the sampling-phase acceptance.

        ``return_stderr=True``: ``result.stderr`` is the standard error
        from the between-chain variance of the per-chain means.

        ``return_diagnostics=True`` (``n_steps >= 4``):
        ``result.diagnostics`` holds split-R-hat (``"r_hat"``) and the
        effective sample size (``"ess"``) per function, float64 arrays:
        each chain's sampling phase splits into two halves, and the
        between- and within-sequence variances of the 2 x chains
        sequences are compared; R-hat well above 1 flags chains that have
        not mixed.

        ``return_samples=m`` (``1 <= m <= n_steps``): ``result.samples``
        holds the chain states after sampling steps ``j * (n_steps // m)``,
        ``j < m``, float32, (m, chains) over one dimension and (m, chains,
        d) over d; chains is the kernel's count (at least 1024).  Neither
        output changes the values or the error bars.

        Multi-dimensional MCMC: ``target_distribution`` may be a sequence
        of d Distributions (a product target) or a joint log density, a
        callable of d arguments (up to an additive constant; d = 1 too),
        and ``proposal_distribution`` a sequence of d Distributions (an
        independence proposal per dimension) or a :class:`RandomWalk`
        (d from the target; a joint target needs its ``init_range``).
        The functions then take d arguments.

        Parallel tempering: ``temperatures=[1.0, T_2, ..., T_R]`` (strictly
        increasing, at least two rungs) runs a ladder of R replicas of
        every chain against ``p(x)^(1/T)`` with even/odd adjacent
        exchanges; only the cold rung enters the estimates and the
        acceptance rate, and ``result.diagnostics["swap_rate"]`` is the
        accepted share of the attempted exchanges.  Takes the proposals
        and targets above, with error bars.

        CUSTOM tables (``from_pdf``, ``beta``, ``mixture``, ...) run in
        the kernels as the JAX package's kernels run them: a target's
        downsampled log table; a proposal's downsampled inverse table
        with the sampler's own density (or, for a density with
        zero-density gaps, gap-respecting tables and a guarded log
        table).

        ``return_state=True``: ``result.chain_state`` is an
        :class:`McmcState` (each chain's final x, (d, chains) over d, and
        log density), which ``initial_state=`` takes back to extend the
        chains in a later call with the same chain count; the resumed
        segment draws fresh streams.  Stateful runs take no error bars,
        diagnostics, draws, adaptive steps or temperatures.

        More than 127 functions (126 tempered) run as passes of at most
        127 (126), each a launch over the same chains from the same seed
        (``api/passes.py``): the values, error bars and diagnostics of
        every pass, the acceptance, swap rate, draws and chain state of
        the first; the call fails if a pass ran other chains.

        Not ported yet, raising ``NotImplementedError`` naming its
        ROADMAP item: the CUSTOM tables the JAX package sends to its XLA
        sweep (heavy-tailed proposals, tables with no uniform grid).
        """
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        if n_chains <= 0:
            raise ValueError("n_chains must be positive")
        if n_burnin < 0:
            raise ValueError("n_burnin must be non-negative")
        if return_stderr and (return_state or initial_state is not None):
            raise ValueError(
                "return_stderr applies to stateless MCMC runs only "
                "(resumed segments' between-chain variance reflects the "
                "segment, not the combined run)"
            )
        if return_diagnostics and (
            return_state or initial_state is not None
        ):
            raise ValueError(
                "return_diagnostics applies to stateless MCMC runs only"
            )
        if return_samples is not None:
            if return_state or initial_state is not None:
                raise ValueError(
                    "return_samples applies to stateless MCMC runs only"
                )
            if not 1 <= int(return_samples) <= n_steps:
                raise ValueError(
                    f"return_samples must be in [1, n_steps={n_steps}], "
                    f"got {return_samples}"
                )
        if temperatures is not None:
            return self._integrate_mcmc_pt(
                functions, target_distribution, proposal_distribution,
                temperatures, n_steps, n_chains, n_burnin, seed,
                initial_state, return_state, return_stderr,
                return_diagnostics, return_samples,
            )
        if isinstance(proposal_distribution, RandomWalk):
            _check_random_walk_args(
                proposal_distribution, n_burnin,
                return_state or initial_state is not None,
            )
        if is_nd_call(target_distribution, proposal_distribution):
            return self._integrate_mcmc_nd(
                functions, target_distribution, proposal_distribution,
                n_steps, n_chains, n_burnin, seed, initial_state,
                return_state, return_stderr, return_diagnostics,
                return_samples,
            )
        traced = self._trace_user_functions(functions)
        stateful = return_state or initial_state is not None
        setups = [
            self._mcmc_kernel_program(
                group, target_distribution, proposal_distribution, n_steps,
                n_burnin, return_stderr, return_diagnostics,
                int(return_samples or 0), stateful,
                initial_state is not None)
            for group in split_groups(traced, MAX_FUNCTIONS)]
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        segment, start = self._resume_point(initial_state, grid, None)
        if self._device.type == "cuda":
            build_all([lambda p=p, c=c: p.library(c)
                       for p, c, _, _ in setups])
        outs = [mcmc_cuda(program, cfg, params, seed, grid, tables, segment,
                          start)
                for program, cfg, params, tables in setups]
        ks = [len(program.fns) for program, _, _, _ in setups]
        check_same_chains(outs, ks)
        result = merge_results([
            mcmc_result(out, grid, cfg, k, n_chains)
            for out, (_, cfg, _, _), k in zip(outs, setups, ks)])
        return with_chain_state(result, outs[0], segment, return_state)

    def _resume_point(self, initial_state, grid, d):
        """``(segment, start)`` of a stateful run on ``grid``'s chains (d
        dimensions, None over one): segment 0 and no start for a fresh
        run; for a resumed one the next segment and the state on the
        integrator's device, after the JAX package's chain-count checks
        (``tpu_montecarlo/api/mcmc.py:297-302``, ``api/mcmc_nd.py:
        500-508``)."""
        if initial_state is None:
            return 0, None
        chains = grid.chains_actual
        x = np.asarray(initial_state.x, np.float32)
        if d is None and initial_state.n_chains != chains:
            raise ValueError(
                f"initial_state has {initial_state.n_chains} chains but "
                f"this run plans {chains}; pass the state back with "
                "the same n_chains/target_threads (and the backend that "
                "produced it)"
            )
        if d is not None and (x.ndim != 2 or x.shape != (d, chains)):
            raise ValueError(
                f"initial_state carries x of shape {x.shape} "
                f"but this nd run plans ({d}, {chains}); "
                "pass the state back with the same dimensions "
                "and n_chains/target_threads"
            )
        start = ChainStart(
            torch.tensor(x, device=self._device),
            torch.tensor(np.asarray(initial_state.log_p, np.float32),
                         device=self._device))
        return initial_state.segment + 1, start

    def compile_mcmc(
        self,
        functions: List[Union[Callable, str]],
        target_distribution,
        proposal_distribution,
        n_steps: int = 10_000,
        n_chains: int = 1024,
        n_burnin: int = 1_000,
        seed_batch: int = 1,
        param_batch: bool = False,
        return_stderr: bool = False,
        temperatures: Optional[List[float]] = None,
        return_samples: Optional[int] = None,
    ) -> Callable:
        """Ahead-of-time MCMC handle for serving (the JAX package's
        ``compile_mcmc``): the trace, the program, the parameter rows, the
        tables and the kernel's library are made once, here; a call stages
        its seeds (and params) and launches.  The handle returns float32
        tensors on the integrator's device.

        ``prog(seed) -> (values (K,), acceptance ())``; with
        ``seed_batch=R``, ``prog(seeds) -> ((R, K), (R,))``: R jobs in one
        launch, each equal bit for bit to the unbatched call with its
        seed.  ``return_stderr=True`` adds the error bars, (K,) or (R,
        K), third; ``return_samples=m`` adds, last, the thinned draws,
        (m, chains) or (R, m, chains).

        ``param_batch=True``: ``prog(seeds, target_params,
        proposal_params)`` with (R, 2) rows of :func:`pack_param_batch`
        for each, or, under a :class:`RandomWalk` (or HMC) proposal, the
        (R, 4) walk rows of :func:`pack_random_walk_batch` in the
        proposal slot; results keep the batch axis at R = 1.  Closed-form
        families only.

        nd targets or proposals (``api/mcmc_nd.py``): the same handles,
        the draws (m, chains, d) or (R, m, chains, d), and under
        ``param_batch`` (R, d, 2) rows of :func:`pack_param_batch_nd` for
        a product target and the proposal, or (R, d, 4) walk rows of
        :func:`pack_random_walk_batch_nd` (no draws).  ``temperatures``
        (``api/tempering.py``): ``prog(seed) -> (values (K,), acceptance
        (), swap_rate ())``, ``prog(seeds) -> ((R, K), (R,), (R,))``, with
        the error bars appended; no param batches or draws.  Each batch
        is one launch of its kernel."""
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        if n_chains <= 0:
            raise ValueError("n_chains must be positive")
        if n_burnin < 0:
            raise ValueError("n_burnin must be non-negative")
        m_samp = 0
        if return_samples is not None:
            m_samp = int(return_samples)
            if not 1 <= m_samp <= n_steps:
                raise ValueError(
                    f"return_samples must be in [1, n_steps={n_steps}], "
                    f"got {return_samples}"
                )
            if temperatures is not None:
                raise ValueError(
                    "compile_mcmc(return_samples=...) supports untempered "
                    "handles only (tempered cold-rung draws ride "
                    "integrate_mcmc)"
                )
        if temperatures is not None:
            return self._compile_mcmc_pt(
                functions, target_distribution, proposal_distribution,
                temperatures, n_steps, n_chains, n_burnin, seed_batch,
                param_batch, return_stderr,
            )
        if is_nd_call(target_distribution, proposal_distribution):
            if m_samp and param_batch:
                raise ValueError(
                    "compile_mcmc(return_samples=...) does not compose "
                    "with nd param_batch"
                )
            return self._compile_mcmc_nd(
                functions, target_distribution, proposal_distribution,
                n_steps, n_chains, n_burnin, seed_batch, param_batch,
                return_stderr, return_samples=m_samp,
            )
        random_walk = isinstance(proposal_distribution, RandomWalk)
        if random_walk:
            _check_random_walk_args(proposal_distribution, n_burnin, False)
            if param_batch:
                ensure_param_batch_family(
                    dist_spec_of(target_distribution).kind, "target")
        elif param_batch:
            for role, d in (("target", target_distribution),
                            ("proposal", proposal_distribution)):
                ensure_param_batch_family(dist_spec_of(d).kind, role)
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        traced = self._trace_user_functions(functions)
        setups = [
            self._mcmc_kernel_program(
                group, target_distribution, proposal_distribution, n_steps,
                n_burnin, return_stderr, samples=m_samp)
            for group in split_groups(traced, MAX_FUNCTIONS)]
        params, tables = setups[0][2], setups[0][3]
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        dev = self._device
        if dev.type == "cuda":
            build_all([lambda p=p, c=c: p.library(c)
                       for p, c, _, _ in setups])

        def result(launch, finish):
            # One launch of each group; values and error bars of every
            # pass, acceptance and draws of the first.
            parts = []
            for program, cfg, _, _ in setups:
                run = launch(program, cfg)
                parts.append((*finish(run, grid, cfg, len(program.fns)),
                              run.samples))
            values, acceptance, stderr, samples = cat_passes(
                parts, first_of=(1, 3))
            out = (values, acceptance)
            if return_stderr:
                out += (stderr,)
            return out + ((samples,) if m_samp else ())

        def batched(seeds, rows):
            return result(
                lambda p, c: mcmc_batch(p, c, rows, seeds, grid, tables),
                mcmc_batch_finish)

        if param_batch:
            targ_kind = dist_spec_of(target_distribution).kind
            if random_walk:
                prop_kind = "rw_adapt" if proposal_distribution.adapt else "rw"
            else:
                prop_kind = dist_spec_of(proposal_distribution).kind

            def dispatch(seeds, rows):
                prop, targ = rows
                if prop.shape[1] == 2:
                    prop = torch.cat([prop, torch.zeros_like(prop)], dim=1)
                return batched(seeds, torch.cat([prop, targ], dim=1))

            inner = _checked_batch_prog(dispatch, seed_batch, 2,
                                        (prop_kind, targ_kind), dev)

            def prog(seeds, target_params, proposal_params):
                return inner(seeds, proposal_params, target_params)

            return prog
        if seed_batch != 1:
            def prog(seeds):
                return batched(stage_seeds(seeds, seed_batch, dev), params)

            return prog

        def prog(seed):
            return result(
                lambda p, c: mcmc_cuda(p, c, params, seed, grid, tables),
                mcmc_finish)

        return prog

    def _mcmc_kernel_program(self, traced, target, proposal, n_steps,
                             n_burnin, with_stderr, with_diagnostics=False,
                             samples=0, with_state=False,
                             use_init_state=False):
        """``(program, cfg, params, tables)`` of one 1-D run: the cached
        :class:`McmcProgram`, its config (mode, families and a CUSTOM
        proposal's route, as the JAX kernel gate routes them, the outputs,
        HMC's leapfrog steps and the chain state), the (6,) float32
        parameter row and the CUSTOM tables (None without one) on the
        integrator's device."""
        targ = dist_spec_of(target)
        leapfrog = hmc_leapfrog(proposal)
        if isinstance(proposal, RandomWalk):
            mode = Mode.ADAPTIVE if proposal.adapt else Mode.RANDOM_WALK
            prop_kind = targ.kind
            prop_row = list(proposal.pack_params(target))
            proposal = None
        else:
            mode = Mode.INDEPENDENCE
            prop = dist_spec_of(proposal)
            prop_kind = prop.kind
            prop_row = [*prop.params, 0.0, 0.0]
        tables = mcmc_dim_tables(proposal, target, self._device,
                                 stateful=with_state)
        dim = tables or DimTables()
        cfg = McmcConfig(mode, prop_kind, targ.kind, n_steps, n_burnin,
                         with_stderr, prop_gapped=dim.q is not None,
                         knots=dim.knots,
                         with_diagnostics=with_diagnostics, samples=samples,
                         hmc_leapfrog=leapfrog, with_state=with_state,
                         use_init_state=use_init_state)
        program = self._cache.get_or_build(
            ("mcmc", fns_key(traced)), lambda: McmcProgram(traced)
        )
        params = torch.tensor(
            [*prop_row, *targ.params], dtype=torch.float32,
            device=self._device,
        )
        return program, cfg, params, tables

