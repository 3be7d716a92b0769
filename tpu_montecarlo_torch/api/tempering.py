"""Parallel tempering (port of ``tpu_montecarlo/api/tempering.py:72-187``,
``:427-494`` and ``:496-614``): ladder validation, the tempered run and
the tempered ``compile_mcmc`` handle with seed batches on the tempered
kernel (``ops/mcmc_pt_kernel.py``).

The JAX package sends tempered work its kernel cannot take, and all of it
off the TPU unless ``backend="pallas"``, to an XLA sweep keyed on
``jax.random``; the port has no such twin, so it agrees chain for chain
only with the JAX package's ``backend="pallas"`` runs, and it has no VMEM
gate (``pt_vmem_fits``): every ladder it takes runs in its kernel, tempered
HMC included, and more than 126 functions in passes of at most 126 over
the same ladders (``api/passes.py``).  What it does not take yet raises
``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

import numpy as np
import torch

from ..distributions import RandomWalk
from ..ops.mcmc_kernel import plan_chains, plan_mcmc_grid
from ..ops.mcmc_pt_kernel import (
    MAX_PT_FUNCTIONS,
    McmcPtConfig,
    McmcPtProgram,
    mcmc_pt_batch,
    mcmc_pt_cuda,
    pack_ladder,
    pt_batch_finish,
    pt_finish,
)
from ..sampling import dist_spec_of
from .batching import _check_random_walk_args, stage_seeds
from .cache import fns_key
from .mcmc_nd import _table_routes, dim_tables, hmc_leapfrog
from .mcmc_result import mcmc_result
from .passes import (
    build_all,
    cat_passes,
    check_same_chains,
    merge_results,
    split_groups,
)
from .results import IntegrationResult


class _PtMixin:
    def _integrate_mcmc_pt(
        self, functions, target, proposal, temperatures, n_steps,
        n_chains, n_burnin, seed, initial_state, return_state,
        return_stderr, return_diagnostics, return_samples,
    ) -> IntegrationResult:
        """Parallel tempering (replica exchange): T replicas of every
        chain run against ``pi^(1/T_t)`` and adjacent rungs exchange
        states, so the cold (T = 1) chains, the only ones that enter the
        estimates, mix across modes that trap a local sampler.  The
        result carries ``diagnostics={"swap_rate": ...}``, the accepted
        share of the attempted exchanges."""
        temps = [float(t) for t in temperatures]
        if len(temps) < 2:
            raise ValueError(
                "temperatures needs >= 2 rungs (the first is the "
                f"target itself), got {temps}"
            )
        if temps[0] != 1.0:
            raise ValueError(
                f"temperatures must start at 1.0 (the true target), "
                f"got {temps}"
            )
        if any(
            not np.isfinite(t) or t2 <= t1
            for t, (t1, t2) in zip(temps[1:], zip(temps, temps[1:]))
        ):
            raise ValueError(
                f"temperatures must be finite and strictly increasing, "
                f"got {temps}"
            )
        if return_state or initial_state is not None:
            raise ValueError(
                "temperatures applies to stateless MCMC runs only "
                "(the ladder state is not checkpointed)"
            )
        if return_samples and not 1 <= int(return_samples) <= n_steps:
            raise ValueError(
                f"return_samples must be in [1, n_steps={n_steps}], "
                f"got {return_samples}"
            )
        if return_diagnostics and n_steps < 4:
            raise ValueError("return_diagnostics needs n_steps >= 4")
        if isinstance(proposal, RandomWalk):
            _check_random_walk_args(proposal, n_burnin, False)
        betas = tuple(1.0 / t for t in temps)
        parsed = self._parse_nd_mcmc_args(target, proposal)
        setups = [
            self._pt_kernel_program(
                group, proposal, parsed, betas, n_steps, n_burnin,
                return_stderr, return_diagnostics, int(return_samples or 0))
            for group in self._pt_groups(functions, parsed[3])]
        tables = dim_tables(parsed[0], parsed[1], parsed[3], self._device)
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        if self._device.type == "cuda":
            build_all([program.library for program, _, _, _ in setups])
        outs = [mcmc_pt_cuda(program, cfg, params, ladder, seed, grid, tables)
                for program, cfg, params, ladder in setups]
        ks = [len(program.fns) for program, _, _, _ in setups]
        check_same_chains(outs, ks, swap=True)
        swap_rate = pt_finish(outs[0], grid, setups[0][1], ks[0])[2]
        # The draws of a 1-D Distribution target are (m, chains), as the
        # JAX package surfaces them; (m, chains, d) otherwise.
        return merge_results([
            mcmc_result(out, grid, cfg, k, n_chains, swap_rate=swap_rate,
                        one_dim=parsed[3] == 1 and parsed[2] is None)
            for out, (_, cfg, _, _), k in zip(outs, setups, ks)])

    def _compile_mcmc_pt(
        self, functions, target, proposal, temperatures, n_steps, n_chains,
        n_burnin, seed_batch, param_batch, return_stderr,
    ):
        """The tempered serving handle (``tpu_montecarlo/api/tempering.py:
        427-494``): ``prog(seed) -> ((K,) values, () acceptance, ()
        swap_rate)``, with ``seed_batch=R`` ``prog(seeds) -> ((R, K), (R,),
        (R,))``, the error bars appended under ``return_stderr``.  The R
        jobs run under one ladder in one launch of the tempered kernel
        (plus one pilot launch under error bars), each equal bit for bit
        to the unbatched call with its seed.  The trace, program, rows,
        ladder, tables and library are made here, once."""
        if param_batch:
            raise ValueError(
                "param_batch is not supported with temperatures (the "
                "ladder is compile-time; batch seeds instead)"
            )
        temps = [float(t) for t in temperatures]
        if (
            len(temps) < 2
            or temps[0] != 1.0
            or any(
                not np.isfinite(t) or t2 <= t1
                for t, (t1, t2) in zip(temps[1:], zip(temps, temps[1:]))
            )
        ):
            raise ValueError(
                "temperatures must be finite, strictly increasing and "
                f"start at 1.0, got {temps}"
            )
        if isinstance(proposal, RandomWalk):
            _check_random_walk_args(proposal, n_burnin, False)
        betas = tuple(1.0 / t for t in temps)
        parsed = self._parse_nd_mcmc_args(target, proposal)
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        setups = [
            self._pt_kernel_program(group, proposal, parsed, betas, n_steps,
                                    n_burnin, return_stderr)
            for group in self._pt_groups(functions, parsed[3])]
        params, ladder = setups[0][2], setups[0][3]
        tables = dim_tables(parsed[0], parsed[1], parsed[3], self._device)
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        dev = self._device
        if dev.type == "cuda":
            build_all([program.library for program, _, _, _ in setups])

        def result(launch, finish):
            # One launch of each group; values and error bars of every
            # pass, acceptance and swap rate of the first.
            parts = [finish(launch(program, cfg), grid, cfg,
                            len(program.fns))
                     for program, cfg, _, _ in setups]
            values, acceptance, swap_rate, stderr = cat_passes(
                parts, first_of=(1, 2))
            out = (values, acceptance, swap_rate)
            return out + (stderr,) if return_stderr else out

        if seed_batch != 1:
            def prog(seeds):
                seeds = stage_seeds(seeds, seed_batch, dev)
                return result(
                    lambda p, c: mcmc_pt_batch(p, c, params, ladder, seeds,
                                               grid, tables),
                    pt_batch_finish)

            return prog

        def prog(seed):
            return result(
                lambda p, c: mcmc_pt_cuda(p, c, params, ladder, seed, grid,
                                          tables),
                pt_finish)

        return prog

    def _pt_groups(self, functions, d: int):
        """The traced set's groups of at most 126 functions
        (``api/passes.py``)."""
        traced = self._trace_user_functions(functions, n_args=d)
        return split_groups(traced, MAX_PT_FUNCTIONS)

    def _pt_kernel_program(
        self, functions, proposal, parsed, betas, n_steps, n_burnin,
        return_stderr, with_diagnostics=False, samples=0,
    ):
        """``(program, cfg, params, ladder)`` of one tempered run: the
        cached :class:`McmcPtProgram` (per integrands, target, mode, rungs
        and families), its config, the (d, 6) float32 parameter rows and
        the (2T - 1,) float32 ladder of ``betas`` on the integrator's
        device (``api/mcmc_nd.py``'s ``dim_tables`` stages the CUSTOM
        dimensions' tables).  CUSTOM dimensions take the nd kernel's
        routes (``_table_routes``): the JAX package sends gapped and
        heavy-tailed proposal dimensions to its XLA sweep, and the port
        runs them in its kernel, gapped ones on their gap-respecting
        tables and faithful q-tables, the others as that sweep reads
        them.  ``parsed`` is
        :meth:`_parse_nd_mcmc_args`'s result for ``proposal``."""
        proposals, targets, target_fn, d = parsed
        traced = self._trace_user_functions(functions, n_args=d)
        prop_specs = (None if proposals is None
                      else [dist_spec_of(p) for p in proposals])
        targ_specs = (None if targets is None
                      else [dist_spec_of(t) for t in targets])
        gapped, knots = _table_routes(
            dim_tables(proposals, targets, d, self._device), proposals, d)
        mode, params = self._nd_mcmc_params(proposal, parsed, prop_specs,
                                            targ_specs)
        cfg = McmcPtConfig(
            mode, d,
            () if prop_specs is None else tuple(s.kind for s in prop_specs),
            None if targ_specs is None else tuple(s.kind for s in targ_specs),
            n_steps, n_burnin, return_stderr, gapped,
            with_diagnostics=with_diagnostics, samples=samples,
            hmc_leapfrog=hmc_leapfrog(proposal), knots=knots,
            n_temps=len(betas),
        )
        target_key = None if target_fn is None else target_fn.key
        program = self._cache.get_or_build(
            ("mcmc_pt", fns_key(traced), target_key, cfg.compiled,
             cfg.knots, cfg.outputs, cfg.state),
            lambda: McmcPtProgram(traced, cfg, target_fn),
        )
        ladder = torch.tensor(pack_ladder(betas), device=self._device)
        return program, cfg, params, ladder
