"""Multi-dimensional MCMC (port of ``tpu_montecarlo/api/mcmc_nd.py:74-562``,
``:710-819`` and ``api/batching.py:17-52``): argument parsing (a product
of per-dimension Distributions or a joint log density of d arguments,
under per-dimension independence proposals or a :class:`RandomWalk`),
the run and the nd ``compile_mcmc`` handle with seed and param batches,
on the nd kernel (``ops/mcmc_nd_kernel.py``).

The JAX package sends nd work its kernel cannot take, and all of it off
the TPU unless ``backend="pallas"``, to an XLA sweep keyed on
``jax.random``; the port has no such twin and runs every workload it
takes in its kernel, chain state too (the JAX package runs nd state on
that sweep only), and HMC, over a product target or a joint log density
(whose gradient ``ops/grad.py`` builds), stateful HMC included, and
more than 127 functions in passes of at most 127 over the same chains
(``api/passes.py``).  What it does not take yet raises
``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

import inspect

import numpy as np
import torch

from ..distributions import HMC, Distribution, RandomWalk
from ..ops.mcmc_kernel import (
    MAX_FUNCTIONS,
    Mode,
    mcmc_batch_finish,
    mcmc_finish,
    plan_chains,
    plan_mcmc_grid,
)
from ..ops.mcmc_nd_kernel import (
    McmcNdConfig,
    McmcNdProgram,
    mcmc_nd_batch,
    mcmc_nd_cuda,
)
from ..ops.mcmc_tables import DimTables
from ..sampling import DistKind, dist_spec_of, ensure_param_batch_family
from ..utils.roadmap import FRONT_END, not_ported
from .batching import (
    _check_nd_mcmc_params,
    _check_random_walk_args,
    stage_seeds,
)
from .cache import fns_key
from .device import mcmc_dim_tables
from .mcmc_result import mcmc_result, with_chain_state
from .passes import (
    build_all,
    cat_passes,
    check_same_chains,
    merge_results,
    split_groups,
)
from .results import IntegrationResult

def hmc_leapfrog(proposal) -> int:
    """The leapfrog steps of an :class:`HMC` proposal, 0 for any other."""
    return proposal.n_leapfrog if isinstance(proposal, HMC) else 0


def is_nd_call(target, proposal) -> bool:
    """``tpu_montecarlo/api/mcmc.py:217-224``: a proposal sequence, a
    target sequence or a joint log-density target takes the nd path (a
    1-D joint log density is its d = 1 case)."""
    return (
        isinstance(proposal, (list, tuple))
        or isinstance(target, (list, tuple))
        or (
            not isinstance(target, Distribution)
            and (callable(target) or isinstance(target, str))
        )
    )


def _target_arity(target) -> int:
    """Dimension count of a joint log-density target where no
    per-dimension proposal list fixes d (RandomWalk proposals): the
    callable's positional parameters."""
    if isinstance(target, str):
        raise not_ported("WGSL source strings", FRONT_END)
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        raise TypeError(
            "cannot determine the dimension count of this joint "
            "log-density; pass a plain function of d positional "
            "arguments (or per-dimension proposal Distributions)"
        )
    kinds = [p.kind for p in sig.parameters.values()]
    if any(
        k in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        for k in kinds
    ):
        raise TypeError(
            "a joint log-density taking *args/**kwargs has no fixed "
            "dimension count; declare d positional arguments"
        )
    return sum(
        1
        for k in kinds
        if k
        in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        )
    )


def _table_routes(tables, proposals, d):
    """The CUSTOM dimensions' compiled-in routes, read off their staged
    ``tables`` (:func:`dim_tables`; ``api/device.py``
    :func:`mcmc_dim_tables` decides them): ``(gapped, knots)``, per
    proposal dimension whether its logq comes from its log table (``()``
    for a walk), and per dimension its :attr:`DimTables.knots`."""
    dims = [t or DimTables() for t in (tables or [None] * d)]
    gapped = () if proposals is None else tuple(t.q is not None for t in dims)
    return gapped, tuple(t.knots for t in dims)


def dim_tables(proposals, targets, d, device, stateful=False):
    """Per dimension, the tables of its CUSTOM proposal and target on
    ``device`` (``api/device.py``; a ``stateful`` run's), or None where
    no dimension is CUSTOM."""
    tables = [mcmc_dim_tables(None if proposals is None else proposals[j],
                              None if targets is None else targets[j], device,
                              stateful)
              for j in range(d)]
    return None if all(t is None for t in tables) else tables


class _McmcNdMixin:
    def _parse_nd_mcmc_args(self, target, proposal):
        """Validate and normalise the nd argument surface: returns
        ``(proposals, targets, target_fn, d)`` with exactly one of
        ``targets`` (per-dimension product) and ``target_fn`` (the traced
        joint log density) set.  A :class:`RandomWalk` proposal returns
        ``proposals=None``; ``d`` then comes from the target: the
        sequence's length, or the joint log density's arity."""
        if isinstance(proposal, RandomWalk):
            proposals = None
            d = None  # fixed by the target below
        elif isinstance(proposal, Distribution):
            proposals = [proposal]
        elif isinstance(proposal, (list, tuple)):
            proposals = list(proposal)
        else:
            raise TypeError(
                "proposal must be a Distribution, a sequence of "
                f"Distributions, or a RandomWalk, got {type(proposal)}"
            )
        if proposals is not None:
            if not proposals or not all(
                isinstance(p, Distribution) for p in proposals
            ):
                raise TypeError(
                    "proposal sequence must be a non-empty list of "
                    "Distribution objects"
                )
            d = len(proposals)

        target_fn = None
        targets = None
        if isinstance(target, (list, tuple)):
            targets = list(target)
            if d is None:
                d = len(targets)
            if len(targets) != d or not all(
                isinstance(t, Distribution) for t in targets
            ):
                raise TypeError(
                    "target sequence must be a non-empty list of "
                    f"Distribution objects matching the {d} "
                    "proposal dimension(s)"
                )
            if not targets:
                raise TypeError(
                    "target sequence must be a non-empty list of "
                    "Distribution objects"
                )
        elif isinstance(target, Distribution):
            if d not in (None, 1):
                raise TypeError(
                    "multi-dimensional MCMC needs the target as a "
                    f"sequence of {d} Distributions or a {d}-ary "
                    "log-density function"
                )
            d = 1
            targets = [target]
        elif callable(target) or isinstance(target, str):
            if d is None:
                d = _target_arity(target)
            target_fn = self._trace_user_functions([target], n_args=d)[0]
        else:
            raise TypeError(
                f"Unsupported target type for MCMC: {type(target)}"
            )
        return proposals, targets, target_fn, d

    def _integrate_mcmc_nd(
        self, functions, target, proposal, n_steps, n_chains, n_burnin,
        seed, initial_state, return_state, return_stderr,
        return_diagnostics, return_samples,
    ) -> IntegrationResult:
        """Multi-dimensional MH: per-dimension independence proposals or
        a random walk, under a product of per-dimension Distributions or
        a joint log density of d arguments."""
        if return_diagnostics and n_steps < 4:
            raise ValueError("return_diagnostics needs n_steps >= 4")
        proposals, targets, target_fn, d = self._parse_nd_mcmc_args(
            target, proposal
        )
        if d == 1 and target_fn is None:
            # 1-D in disguise: the scalar path.
            return self.integrate_mcmc(
                functions, targets[0],
                proposal if proposals is None else proposals[0],
                n_steps=n_steps, n_chains=n_chains, n_burnin=n_burnin,
                seed=seed, initial_state=initial_state,
                return_state=return_state, return_stderr=return_stderr,
                return_diagnostics=return_diagnostics,
                return_samples=return_samples,
            )
        stateful = return_state or initial_state is not None
        traced = self._trace_user_functions(functions, n_args=d)
        setups = [
            self._nd_mcmc_kernel_program(
                group, proposal, (proposals, targets, target_fn, d), n_steps,
                n_burnin, return_stderr, return_diagnostics,
                int(return_samples or 0), stateful, initial_state is not None)
            for group in split_groups(traced, MAX_FUNCTIONS)]
        tables = dim_tables(proposals, targets, d, self._device, stateful)
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        segment, start = self._resume_point(initial_state, grid, d)
        if self._device.type == "cuda":
            build_all([program.library for program, _, _ in setups])
        outs = [mcmc_nd_cuda(program, cfg, params, seed, grid, tables,
                             segment, start)
                for program, cfg, params in setups]
        ks = [len(program.fns) for program, _, _ in setups]
        check_same_chains(outs, ks)
        result = merge_results([
            mcmc_result(out, grid, cfg, k, n_chains)
            for out, (_, cfg, _), k in zip(outs, setups, ks)])
        return with_chain_state(result, outs[0], segment, return_state)

    def _compile_mcmc_nd(
        self, functions, target, proposal, n_steps, n_chains, n_burnin,
        seed_batch, param_batch, return_stderr, return_samples=0,
    ):
        """The nd serving handle (``tpu_montecarlo/api/mcmc_nd.py:
        710-819``): ``prog(seed) -> ((K,), acceptance[, (K,) stderr][, (m,
        chains, d) draws])``, with ``seed_batch=R`` ``prog(seeds)`` and a
        leading R axis; ``param_batch=True`` (a product target):
        ``prog(seeds, target_params, proposal_params)`` with (R, d, 2)
        rows (:func:`pack_param_batch_nd`), or (R, d, 4) walk rows
        (:func:`pack_random_walk_batch_nd`) in the proposal slot.  The R
        jobs run in one launch of the nd kernel (plus one pilot launch
        under error bars), each equal bit for bit to the unbatched call
        with its seed and rows.  A 1-D product is the 1-D handle."""
        parsed = self._parse_nd_mcmc_args(target, proposal)
        proposals, targets, target_fn, d = parsed
        if d == 1 and target_fn is None:
            return self.compile_mcmc(
                functions, targets[0],
                proposal if proposals is None else proposals[0],
                n_steps=n_steps, n_chains=n_chains, n_burnin=n_burnin,
                seed_batch=seed_batch, param_batch=param_batch,
                return_stderr=return_stderr,
                return_samples=return_samples or None,
            )
        if param_batch and target_fn is not None:
            raise ValueError(
                "param_batch needs a product-of-Distributions target "
                "(a joint log-density function carries no runtime "
                "parameters)"
            )
        random_walk = proposals is None
        if random_walk:
            _check_random_walk_args(proposal, n_burnin, False)
        prop_kinds = (() if random_walk
                      else tuple(dist_spec_of(p).kind for p in proposals))
        targ_kinds = (None if target_fn is not None
                      else tuple(dist_spec_of(t).kind for t in targets))
        if param_batch:
            for kind in prop_kinds:
                ensure_param_batch_family(kind, "proposal")
            for kind in targ_kinds:
                ensure_param_batch_family(kind, "target")
        if seed_batch < 1:
            raise ValueError("seed_batch must be >= 1")
        traced = self._trace_user_functions(functions, n_args=d)
        setups = [
            self._nd_mcmc_kernel_program(group, proposal, parsed, n_steps,
                                         n_burnin, return_stderr,
                                         samples=return_samples)
            for group in split_groups(traced, MAX_FUNCTIONS)]
        params = setups[0][2]
        tables = dim_tables(proposals, targets, d, self._device)
        grid = plan_mcmc_grid(plan_chains(n_chains, self._target_threads))
        dev = self._device
        if dev.type == "cuda":
            build_all([program.library for program, _, _ in setups])

        def result(launch, finish):
            # One launch of each group; values and error bars of every
            # pass, acceptance and draws of the first.
            parts = []
            for program, cfg, _ in setups:
                run = launch(program, cfg)
                parts.append((*finish(run, grid, cfg, len(program.fns)),
                              run.samples))
            values, acceptance, stderr, samples = cat_passes(
                parts, first_of=(1, 3))
            out = (values, acceptance)
            if return_stderr:
                out += (stderr,)
            # The kernel's (..., m, d, chains) draws as integrate_mcmc
            # surfaces them, (..., m, chains, d).
            return out + ((samples.transpose(-1, -2),) if return_samples
                          else ())

        def batched(seeds, rows):
            return result(
                lambda p, c: mcmc_nd_batch(p, c, rows, seeds, grid, tables),
                mcmc_batch_finish)

        if param_batch:
            def prog(seeds, target_params, proposal_params):
                seeds_t, prop, targ = _check_nd_mcmc_params(
                    seeds, target_params, proposal_params, seed_batch, d,
                    targ_kinds, prop_kinds, random_walk=random_walk,
                    rw_adapt=random_walk and proposal.adapt, device=dev)
                if not random_walk:
                    prop = torch.cat([prop, torch.zeros_like(prop)], dim=-1)
                return batched(seeds_t, torch.cat([prop, targ], dim=-1))

            return prog
        if seed_batch != 1:
            def prog(seeds):
                return batched(stage_seeds(seeds, seed_batch, dev), params)

            return prog

        def prog(seed):
            return result(
                lambda p, c: mcmc_nd_cuda(p, c, params, seed, grid, tables),
                mcmc_finish)

        return prog

    def _nd_mcmc_kernel_program(
        self, functions, proposal, parsed, n_steps, n_burnin, return_stderr,
        with_diagnostics=False, samples=0, with_state=False,
        use_init_state=False,
    ):
        """``(program, cfg, params)`` of one nd run: the cached
        :class:`McmcNdProgram` (per integrands, target, mode, families,
        CUSTOM routes, outputs and chain state), its config and the (d, 6)
        float32 parameter
        rows on the integrator's device (:func:`dim_tables` stages the
        CUSTOM dimensions' tables).  ``parsed`` is
        :meth:`_parse_nd_mcmc_args`'s result for ``proposal``."""
        proposals, targets, target_fn, d = parsed
        prop_specs = (None if proposals is None
                      else [dist_spec_of(p) for p in proposals])
        targ_specs = (None if targets is None
                      else [dist_spec_of(t) for t in targets])
        gapped, knots = _table_routes(
            dim_tables(proposals, targets, d, self._device, with_state),
            proposals, d)
        traced = self._trace_user_functions(functions, n_args=d)
        mode, params = self._nd_mcmc_params(proposal, parsed, prop_specs,
                                            targ_specs)
        cfg = McmcNdConfig(
            mode, d,
            () if prop_specs is None else tuple(s.kind for s in prop_specs),
            None if targ_specs is None else tuple(s.kind for s in targ_specs),
            n_steps, n_burnin, return_stderr, gapped,
            with_diagnostics=with_diagnostics, samples=samples,
            with_state=with_state, use_init_state=use_init_state,
            hmc_leapfrog=hmc_leapfrog(proposal), knots=knots,
        )
        target_key = None if target_fn is None else target_fn.key
        program = self._cache.get_or_build(
            ("mcmc_nd", fns_key(traced), target_key, cfg.compiled,
             cfg.knots, cfg.outputs, cfg.state),
            lambda: McmcNdProgram(traced, cfg, target_fn),
        )
        return program, cfg, params

    def _nd_mcmc_params(self, proposal, parsed, prop_specs, targ_specs):
        """``(mode, params)``: the proposal mode and the (d, 6) float32
        rows the nd and tempered kernels read, on the integrator's device
        (the walk's or the proposal's four floats, then the target's
        two, zeros for a joint target)."""
        proposals, targets, _, d = parsed
        if proposals is None:
            mode = Mode.ADAPTIVE if proposal.adapt else Mode.RANDOM_WALK
            prop_rows = proposal.pack_params_nd(targets, d)
        else:
            mode = Mode.INDEPENDENCE
            prop_rows = np.asarray(
                [[*s.params, 0.0, 0.0] for s in prop_specs], np.float32
            )
        targ_rows = (
            np.zeros((d, 2), np.float32) if targ_specs is None
            else np.stack([s.params for s in targ_specs])
        )
        params = torch.tensor(
            np.concatenate([prop_rows, targ_rows], axis=1),
            dtype=torch.float32, device=self._device,
        )
        return mode, params
