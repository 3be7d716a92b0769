"""Table staging for CUSTOM distributions and importance weights (port of
the table half of ``tpu_montecarlo/api/device.py``).

Per-Distribution caches of the host tables the 1-D integrate kernel reads
(the stratified or gap-respecting inverse tables, the CDF knots of the
knot-exact route, the uniform-grid pdf tables of importance weights) and
of their device copies.  The JAX package's VMEM gates and byte accounting
are not carried over: the card reads the tables from global memory.
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
from ..tables import (
    downsample_pdf_table,
    find_zero_density_gaps,
    gapped_stratified_tables,
    is_uniform_grid,
    resample_uniform_table,
)

__all__ = ["sampling_tables"]


def _device_gapped_tables(distribution, spec):
    """Gap-respecting (STRATA, 128) stratified (value, slope) tables of an
    ``exact_inverse`` CUSTOM distribution, float32 numpy, cached per
    Distribution (``tpu_montecarlo/api/device.py:93-133``, stratified, at
    the kernel's 256 // 8 strata): each gap's jump sits at a knot, so no
    draw lands inside a gap."""
    cached = getattr(distribution, "_device_gapped", None)
    if cached is None:
        _, pdf_vals = distribution.get_or_compute_pdf_table()
        gaps = find_zero_density_gaps(spec.x_table, spec.cdf_table, pdf_vals)
        cached = gapped_stratified_tables(
            spec.x_table, spec.cdf_table, gaps, segments=STRATA
        )
        distribution._device_gapped = cached
    return cached


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
