"""Table staging for CUSTOM distributions and importance weights (port of
the table half of ``tpu_montecarlo/api/device.py``).

Per-Distribution caches of the host tables the kernels read and of their
device copies: for the 1-D integrate kernel the stratified or
gap-respecting inverse tables, the CDF knots of the knot-exact route and
the uniform-grid pdf tables of importance weights; for the nd integrate
kernel each CUSTOM dimension's route tables and full inverse
(:func:`nd_custom_dim`); for the three MCMC
kernels the downsampled flat inverse of a proposal (or its flat
gap-respecting tables), the guarded and downsampled log table of a gapped
proposal and the downsampled log table of a target
(:func:`mcmc_dim_tables`).  The downsampling is kept: it defines the
tables the JAX kernel samples, so the chains are the same.  Where the JAX
package's kernel gates send a table to its XLA sweep, the MCMC kernels
read what that sweep reads: the CDF knots of a knot-exact proposal, a
flat inverse at full length, and the full log-pdf table on its own grid,
uniform or irregular (:func:`mcmc_proposal_route`,
:func:`mcmc_target_route`).  The JAX
package's VMEM gates and byte accounting are not carried over: the card
reads the tables from global memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.integrate_kernel import (
    STRATA,
    KnotTables,
    StrataTables,
    prep_inv_table_stratified,
)
from ..ops.integrate_nd_kernel import CustomDim, FlatTables, NdConfig
from ..ops.mcmc_tables import (
    DimTables,
    InverseTable,
    KnotTable,
    flat_inverse,
    log_table,
    prep_inv_table,
)
from ..sampling import DistKind, dist_spec_of
from ..tables import (
    downsample_log_table,
    downsample_pdf_table,
    find_zero_density_gaps,
    gapped_inverse_tables,
    gapped_stratified_tables,
    guard_proposal_log_floor,
    is_uniform_grid,
    log_pdf_from_pdf,
    resample_uniform_table,
)

__all__ = [
    "mcmc_dim_tables",
    "nd_custom_dim",
    "nd_tables",
    "mcmc_proposal_route",
    "mcmc_target_route",
    "sampling_tables",
]


def _device_gapped_tables(distribution, spec, stratified: bool = True):
    """Gap-respecting (value, slope) tables of an ``exact_inverse`` CUSTOM
    distribution, float32 numpy, cached per Distribution
    (``tpu_montecarlo/api/device.py:93-133``): ``stratified``, (STRATA,
    128) tables at the integrate kernel's 256 // 8 strata; else the flat
    m-knot tables of an MCMC proposal.  Each gap's jump sits at a knot, so
    no draw lands inside a gap."""
    cache = distribution.__dict__.setdefault("_device_gapped_cache", {})
    if stratified not in cache:
        _, pdf_vals = distribution.get_or_compute_pdf_table()
        gaps = find_zero_density_gaps(spec.x_table, spec.cdf_table, pdf_vals)
        if stratified:
            cache[stratified] = gapped_stratified_tables(
                spec.x_table, spec.cdf_table, gaps, segments=STRATA
            )
        else:
            cache[stratified] = gapped_inverse_tables(
                spec.x_table, spec.cdf_table, gaps
            )
    return cache[stratified]


def _mcmc_prop_inverse(distribution, spec):
    """The downsampled inverse-CDF table of a non-gapped CUSTOM proposal
    under sampler-mode logq, float32 numpy, cached per Distribution
    (``tpu_montecarlo/api/device.py:47-90``): the smallest power-of-two
    u-grid of at least 256 knots whose resampled inverse stays within
    2e-4 of the support's span in Wasserstein-1 distance of the full
    table's sampler, else the full table.  Sampler mode takes the draw's
    own density, so the chain keeps its target at any resolution."""
    cached = getattr(distribution, "_mcmc_inv_table", None)
    if cached is None:
        x = np.asarray(spec.x_table, np.float64)
        m = x.shape[0]
        u_full = np.linspace(0.0, 1.0, m)
        span = float(x[-1] - x[0])
        tol = 2e-4 * span if span > 0 else 0.0
        best = x
        size = 256
        while size < m:
            u_c = np.linspace(0.0, 1.0, size)
            x_c = np.interp(u_full, u_c, np.interp(u_c, u_full, x))
            if np.trapezoid(np.abs(x_c - x), u_full) <= tol:
                best = np.interp(u_c, u_full, x)
                break
            size *= 2
        cached = np.asarray(best, np.float32)
        distribution._mcmc_inv_table = cached
    return cached


def _uniform_log_tables(distribution):
    """(x, log pdf) tables on a uniform grid for the MCMC kernels' lookups
    (``tpu_montecarlo/api/device.py:158-184``): a uniform grid passes
    through; an irregular one resamples the pdf within the error bound
    (:func:`_uniform_table_mode`) and takes the logs after.  None when the
    bound cannot be met (the JAX package then runs its XLA sweep).  Cached
    per Distribution."""
    lx, lp = distribution.get_log_pdf_table()
    if is_uniform_grid(lx):
        return lx, lp
    cached = getattr(distribution, "_uniform_log_tables", False)
    if cached is False:
        mode = _uniform_table_mode(
            distribution,
            ("table",) + tuple(distribution.get_or_compute_pdf_table()),
        )
        cached = None if mode is None else (mode[1], log_pdf_from_pdf(mode[2]))
        distribution._uniform_log_tables = cached
    return cached


def _proposal_kernel_log_tables(distribution):
    """The uniform-grid log tables fit to serve as a gapped MCMC
    proposal's q-table, or None (``tpu_montecarlo/api/device.py:187-229``):
    resample an irregular grid, hold the guarded resample within 0.01 nats
    of the guarded original at the union of both knot sets (away from the
    floor), guard the floor edges (``guard_proposal_log_floor``), then
    downsample strictly.  Cached per Distribution."""
    cached = getattr(distribution, "_prop_kernel_log_tables", False)
    if cached is not False:
        return cached
    lx, lp = distribution.get_log_pdf_table()
    result = None
    uniform = _uniform_log_tables(distribution)
    if uniform is not None:
        ulx, ulp = uniform
        ok = True
        if ulx is not lx:
            gorig = guard_proposal_log_floor(lp)
            gulp = guard_proposal_log_floor(ulp)
            probe = np.union1d(np.asarray(lx), np.asarray(ulx))
            a = np.interp(probe, lx, gorig)
            b = np.interp(probe, ulx, gulp)
            mask = a > -90.0
            ok = not np.any(np.abs(b - a)[mask] > 0.01)
            ulp = gulp
        else:
            ulp = guard_proposal_log_floor(ulp)
        if ok:
            result = downsample_log_table(ulx, ulp, strict=True)
    distribution._prop_kernel_log_tables = result
    return result


def _device_uniform_log_tables(distribution, role: str = "target"):
    """The MCMC kernels' log table of ``role``, float32 numpy, cached per
    Distribution and role (``tpu_montecarlo/api/device.py:232-256``): a
    target's uniform log table downsampled within the density-weighted
    bound (``downsample_log_table``), a gapped proposal's through
    :func:`_proposal_kernel_log_tables`."""
    attr = ("_device_log_tables_u" if role == "target"
            else "_device_log_tables_uq")
    cached = getattr(distribution, attr, None)
    if cached is None:
        if role == "target":
            lx, lp = downsample_log_table(*_uniform_log_tables(distribution))
        else:
            lx, lp = _proposal_kernel_log_tables(distribution)
        cached = (np.asarray(lx, np.float32), np.asarray(lp, np.float32))
        setattr(distribution, attr, cached)
    return cached


def mcmc_proposal_route(distribution, stateful: bool = False):
    """How the MCMC kernels draw from a CUSTOM proposal.  Where the JAX
    package's kernel gate ``_mcmc_pallas_ok``
    (``tpu_montecarlo/api/mcmc.py:454-500``) keeps the workload:
    ``"sampler"`` (a lane-multiple inverse table, sampler-mode logq;
    stateless runs), ``"table"`` (that inverse at full size and a faithful
    q-table; ``stateful`` runs) or ``"gapped"`` (gap-respecting tables and
    a faithful q-table).  Where it sends it to its XLA sweep, what that
    sweep computes (``sampling.transform_from_u``): ``"knots"`` for an
    ``exact_inverse`` spec (heavy-tailed, or gapped with no faithful
    q-table), the knot-exact inverse, and ``"full"`` for another (an
    inverse of another length, or a stateful run's with no faithful
    q-table), the flat inverse at full length; both take logq from the
    full log-pdf table (:func:`_full_log_table`)."""
    spec = dist_spec_of(distribution)
    if spec.exact_inverse:
        if (not spec.heavy_tail
                and _proposal_kernel_log_tables(distribution) is not None):
            return "gapped"
        return "knots"
    if spec.x_table.shape[0] % 128 != 0:
        return "full"
    if not stateful:
        return "sampler"
    if _proposal_kernel_log_tables(distribution) is None:
        return "full"
    return "table"


def mcmc_target_route(distribution) -> str:
    """How the MCMC kernels read a CUSTOM target's log density:
    ``"grid"``, its downsampled uniform-grid log table, where the JAX
    package's gate finds one; else ``"knots"``, its full irregular log-pdf
    table, as the JAX package's XLA sweep reads it."""
    return "grid" if _uniform_log_tables(distribution) is not None else "knots"


def _full_log_table(distribution, device):
    """A distribution's full ``get_log_pdf_table()`` as the XLA sweep
    reads it (``sampling.log_pdf_from_table``): a padded uniform-grid
    table where its grid is uniform, else a :class:`KnotTable` over its
    irregular grid."""
    lx, lp = distribution.get_log_pdf_table()
    if is_uniform_grid(lx):
        return log_table(lx, lp, device)
    return KnotTable.of(lx, lp, device)


def _is_custom(distribution) -> bool:
    return (distribution is not None
            and dist_spec_of(distribution).kind == DistKind.CUSTOM)


def mcmc_dim_tables(proposal, target, device, stateful: bool = False):
    """One dimension's :class:`DimTables` on ``device`` for a proposal
    (a Distribution, or None for a walk) and a target (a Distribution, or
    None for a joint log density), or None when neither is CUSTOM, on
    the routes :func:`mcmc_proposal_route` and :func:`mcmc_target_route`
    give them.  A ``stateful`` run's non-gapped proposal takes its full
    inverse table and its faithful log table, as the JAX package stages
    them for any stateful run (``tpu_montecarlo/api/mcmc.py:630-642``,
    ``:730-735``): a resumed chain's start has no draw to read logq from.
    Device copies are cached per Distribution, role and device."""
    key = str(torch.device(device))

    def staged(dist, role, make):
        cache = dist.__dict__.setdefault("_mcmc_device_tables", {})
        if (role, key) not in cache:
            cache[role, key] = make()
        return cache[role, key]

    inv = q = targ = None
    if _is_custom(proposal):
        spec = dist_spec_of(proposal)
        route = mcmc_proposal_route(proposal, stateful)
        if route == "gapped":
            inv = staged(proposal, "inv", lambda: InverseTable.of(
                *_device_gapped_tables(proposal, spec, stratified=False),
                device))
        elif route == "knots":
            inv = staged(proposal, "inv_knots", lambda: KnotTable.of(
                spec.cdf_table, spec.x_table, device))
        elif route == "sampler":
            inv = staged(proposal, "inv", lambda: InverseTable.of(
                *prep_inv_table(_mcmc_prop_inverse(proposal, spec)), device))
        else:  # "table", "full": the inverse at full length
            inv = staged(proposal, "inv_full", lambda: InverseTable.of(
                *flat_inverse(spec.x_table), device))
        if route in ("gapped", "table"):
            q = staged(proposal, "q", lambda: log_table(
                *_device_uniform_log_tables(proposal, "proposal"), device))
        elif route in ("knots", "full"):
            q = staged(proposal, "q_full",
                       lambda: _full_log_table(proposal, device))
    if _is_custom(target):
        if mcmc_target_route(target) == "grid":
            targ = staged(target, "targ", lambda: log_table(
                *_device_uniform_log_tables(target), device))
        else:
            targ = staged(target, "targ_full",
                          lambda: _full_log_table(target, device))
    if inv is None and targ is None:
        return None
    return DimTables(inv, q, targ)


def sampling_tables(distribution, spec, device, with_pdf: bool = False):
    """The device tables of a CUSTOM distribution's route (their
    ``route``, which picks the kernel's library), cached per Distribution and device:
    :class:`KnotTables` for a heavy-tailed spec, else :class:`StrataTables`
    (the resampled inverse, or the gap-respecting tables of an
    ``exact_inverse`` spec; with the sampler's density ``qs`` under
    ``with_pdf``, non-gapped specs only)."""
    cache = distribution.__dict__.setdefault("_device_tables", {})
    key = (str(torch.device(device)), with_pdf)
    if key in cache:
        return cache[key]
    if with_pdf and spec.exact_inverse:
        raise ValueError(
            "sampler-mode IS weights need a non-gapped CUSTOM proposal"
        )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    if spec.heavy_tail:
        tables = KnotTables(dev(spec.x_table), dev(spec.cdf_table))
    elif spec.exact_inverse:
        tables = StrataTables(*map(dev, _device_gapped_tables(distribution,
                                                              spec)))
    else:
        tables = StrataTables(*map(dev, prep_inv_table_stratified(
            spec.x_table, with_pdf=with_pdf)))
    cache[key] = tables
    return tables


def nd_custom_dim(distribution, spec, device, stratified: bool,
                  sampler: bool = False) -> CustomDim:
    """A CUSTOM dimension's tables for the nd integrate kernel, cached per
    Distribution, device, route and sampler mode: on the stratified
    dimension (``stratified``) the 1-D kernel's row-stratified tables
    (with the sampler's density ``qs`` under ``sampler``) or, for an
    ``exact_inverse`` spec, its gap-respecting strata; elsewhere the flat
    full inverse of the spec's table (``prep_inv_table``'s knots and
    forward differences, any knot count) or, gapped, the flat gapped
    tables; a heavy-tailed spec the knot-exact inverse on either.  The
    full inverse rides along for the pilot (``CustomDim.full``)."""
    cache = distribution.__dict__.setdefault("_nd_device_tables", {})
    key = (str(torch.device(device)), stratified, sampler)
    if key in cache:
        return cache[key]
    if sampler and spec.exact_inverse:
        raise ValueError(
            "sampler-mode IS weights need a non-gapped CUSTOM proposal"
        )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    if spec.heavy_tail:
        full = KnotTables(dev(spec.x_table), dev(spec.cdf_table))
        tables = CustomDim(full, full)
    else:
        if spec.exact_inverse:
            full = FlatTables(*map(dev, _device_gapped_tables(
                distribution, spec, stratified=False)))
        else:
            t = np.asarray(spec.x_table, np.float32)
            full = FlatTables(dev(t), dev(np.concatenate(
                [t[1:] - t[:-1], np.zeros(1, np.float32)])))
        draw = full
        if stratified and spec.exact_inverse:
            draw = StrataTables(*map(dev, _device_gapped_tables(distribution,
                                                                spec)))
        elif stratified:
            draw = StrataTables(*map(dev, prep_inv_table_stratified(
                spec.x_table, with_pdf=sampler)))
        tables = CustomDim(draw, full)
    cache[key] = tables
    return tables


def nd_tables(dists, cfg: NdConfig, device, sampler_dims=()):
    """Each CUSTOM dimension's :class:`CustomDim` on ``device`` as ``cfg``
    draws it (stratified on ``cfg.strat_dim``, with the sampler's density
    on ``sampler_dims``), None elsewhere; None when no dimension is
    CUSTOM."""
    if DistKind.CUSTOM not in cfg.kinds:
        return None
    return [
        nd_custom_dim(dd, dist_spec_of(dd), device, j == cfg.strat_dim,
                      j in sampler_dims)
        if kind == DistKind.CUSTOM else None
        for j, (dd, kind) in enumerate(zip(dists, cfg.kinds))
    ]


def _uniform_table_mode(distribution, mode, role: str = "target"):
    """A table pdf-mode ``("table", x, pdf)`` on a uniform x grid
    (``tpu_montecarlo/api/device.py:279-322``): uniform grids pass
    through; irregular ones are resampled within the error bound, cached
    per Distribution; ``role="proposal"`` also holds the resample to
    1e-3 of the original at every positive knot.  None when no uniform
    grid meets the bound.  Traced modes pass through."""
    if mode is None or mode[0] != "table":
        return mode
    if is_uniform_grid(mode[1]):
        return mode
    resampled = getattr(distribution, "_uniform_pdf_tables", False)
    if resampled is False:
        resampled = resample_uniform_table(mode[1], mode[2])
        distribution._uniform_pdf_tables = resampled
    if role == "target":
        cached = resampled
    else:
        cached = getattr(distribution, "_uniform_pdf_tables_q", False)
        if cached is False:
            cached = resampled
            if cached is not None:
                x0 = np.asarray(mode[1], np.float64)
                v0 = np.asarray(mode[2], np.float64)
                back = np.interp(x0, cached[0], cached[1])
                pos = v0 > 0
                if np.any(np.abs(back - v0)[pos] > 1e-3 * v0[pos]):
                    cached = None
            distribution._uniform_pdf_tables_q = cached
    if cached is None:
        return None
    return ("table", cached[0], cached[1])


def _device_mode_tables(distribution, mode, role: str = "target"):
    """The (x grid, pdf values) of a uniform table mode as the kernel
    reads it, downsampled within the error bound
    (``tables.downsample_pdf_table``; proposal tables relative to each
    value), float32 numpy, cached per Distribution and role
    (``tpu_montecarlo/api/device.py:325-345``)."""
    attr = "_device_pdf_tables_u" if role == "target" else "_device_pdf_tables_uq"
    cached = getattr(distribution, attr, None)
    if cached is None:
        xt, pt = downsample_pdf_table(mode[1], mode[2],
                                      relative=role != "target")
        cached = (np.asarray(xt, np.float32), np.asarray(pt, np.float32))
        setattr(distribution, attr, cached)
    return cached
