"""CUSTOM tables in the three MCMC kernels: their host layout, the plain
PyTorch lookups and the launch's table descriptors.

Port of the table half of ``tpu_montecarlo/ops/mcmc_pallas.py``
(``_sample_chain_block``'s CUSTOM branch, ``:243-261``, and ``_log_pdf``,
``:270-285``) as the 1-D, nd and tempered MCMC kernels read them, per
dimension:

* a CUSTOM proposal draws from its flat inverse-CDF table of m knots (the
  JAX package's ``prep_inv_table``: the knots and their forward
  differences; a gapped proposal's second table is the slope table of
  ``tables.gapped_inverse_tables``): ``pos = u * (m - 1)`` from a [0, 1)
  uniform, ``i0 = clip(int(pos), 0, m - 2)``, ``x = t[i0] + (pos - i0) *
  dt[i0]``;
* a non-gapped proposal's log density is the sampler's own,
  ``-log(max(dt[i0], 1e-30)) - float32(log(m - 1))`` (sampler mode); a
  gapped one's comes from its guarded log table at x;
* a CUSTOM target's log density comes from its uniform-grid log table,
  ``pad_uniform_table``'s lookup with the -100 floor off the grid.

The tables the JAX package reads only on its XLA sweep
(``sampling.transform_from_u`` and ``log_pdf_from_table``) are
:class:`KnotTable` s: a knot-exact proposal draws ``knot_interp(u,
cdf_knots, x_knots)`` (``jnp.interp(u, cdf_table, x_table)``), and an
irregular-grid log table (a proposal's or a target's full
``get_log_pdf_table()``) is ``knot_interp`` over its grid with the -100
floor off it, its slope (HMC) the knot interval's.  A flat inverse of any
length (:func:`flat_inverse`) draws as above.  :func:`inverse_draw`,
:func:`log_table_value` and :func:`log_table_slope` take either kind.

The JAX kernel's segment-scan lane gathers are not carried over: the card
loads ``table[i]`` directly (``csrc/counter_rng.cuh``'s ``TableRef`` and
lookups, ``csrc/log_pdf_grad.cuh``'s slopes), with the same float32
operations as the plain versions here.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..tables import LOG_PDF_FLOOR
from .integrate_kernel import (
    LANES,
    _true_div,
    knot_interp,
    pad_uniform_table,
    uniform_table_value,
)

__all__ = [
    "DimTables",
    "InverseTable",
    "KnotTable",
    "LogTable",
    "check_dim_tables",
    "flat_inverse",
    "inverse_draw",
    "kernel_tables",
    "log_table",
    "log_table_slope",
    "log_table_value",
    "prep_inv_table",
    "sampler_logq",
]


def prep_inv_table(x_table) -> Tuple[np.ndarray, np.ndarray]:
    """A flat inverse-CDF table and its forward differences (0 last),
    float32 numpy: the JAX package's ``prep_inv_table``
    (``integrate_pallas.py:683-695``), kept flat (the JAX function tiles
    both to (m / 128, 128))."""
    if np.shape(x_table)[0] % LANES != 0:
        raise ValueError(
            f"inverse-CDF table size must be a multiple of {LANES}"
        )
    return flat_inverse(x_table)


def flat_inverse(x_table) -> Tuple[np.ndarray, np.ndarray]:
    """The flat inverse of :func:`prep_inv_table` at any length (the
    ``"full"`` route: the JAX package's XLA sweep indexes its uniform-u
    inverse at full length, whatever its length)."""
    t = np.asarray(x_table, np.float32)
    dt = np.concatenate([t[1:] - t[:-1], np.zeros(1, np.float32)])
    return t, dt


class InverseTable(NamedTuple):
    """A CUSTOM proposal's flat inverse on the device: the m knots ``t``,
    the forward differences or gap slopes ``dt``, and ``log_m1``,
    ``float32(log(m - 1))`` (the sampler-mode density's constant, taken
    in float64 and rounded, as the JAX kernel's)."""

    t: torch.Tensor
    dt: torch.Tensor
    log_m1: float

    @staticmethod
    def of(t, dt, device) -> "InverseTable":
        t = np.asarray(t, np.float32)
        return InverseTable(
            torch.from_numpy(np.ascontiguousarray(t)).to(device),
            torch.from_numpy(np.ascontiguousarray(dt, np.float32)).to(device),
            float(np.float32(np.log(float(t.shape[0] - 1)))),
        )


class LogTable(NamedTuple):
    """A uniform-grid log-density table on the device, padded to a
    multiple of 128 with the -100 floor: values, forward differences and
    the float32 grid ``(x0, step, x_max)`` (``pad_uniform_table``)."""

    vals: torch.Tensor
    dx: torch.Tensor
    grid: Tuple[float, float, float]


def log_table(lx, lp, device) -> LogTable:
    """The :class:`LogTable` of the uniform-grid log table (lx, lp)."""
    vals, dx, grid = pad_uniform_table(lx, lp, LOG_PDF_FLOOR)
    return LogTable(torch.from_numpy(vals).to(device),
                    torch.from_numpy(dx).to(device),
                    tuple(float(g) for g in grid))


class KnotTable(NamedTuple):
    """m sorted ``keys`` and their ``vals`` on the device, read by
    ``knot_interp``: a knot-exact inverse (the CDF knots and the x
    knots) or an irregular-grid log table (the x grid and the log
    densities, -100 off [keys[0], keys[-1]]); ``lo`` and ``hi`` are
    keys[0] and keys[-1], kept on the host."""

    keys: torch.Tensor
    vals: torch.Tensor
    lo: float
    hi: float

    @staticmethod
    def of(keys, vals, device) -> "KnotTable":
        keys = np.ascontiguousarray(keys, np.float32)
        vals = np.ascontiguousarray(vals, np.float32)
        return KnotTable(torch.from_numpy(keys).to(device),
                         torch.from_numpy(vals).to(device),
                         float(keys[0]), float(keys[-1]))


@dataclass(frozen=True)
class DimTables:
    """One dimension's tables: ``inv`` for a CUSTOM proposal (with ``q``,
    its log table, when its logq comes from one), ``targ`` for a CUSTOM
    target.  An analytic family has none.  A :class:`KnotTable` stands
    where the route reads knots: a knot-exact draw, an irregular grid."""

    inv: Optional[Union[InverseTable, KnotTable]] = None
    q: Optional[Union[LogTable, KnotTable]] = None
    targ: Optional[Union[LogTable, KnotTable]] = None

    @property
    def knots(self) -> Tuple[bool, bool, bool]:
        """Which of (inv, q, targ) are knot tables."""
        return tuple(isinstance(t, KnotTable)
                     for t in (self.inv, self.q, self.targ))


def inverse_draw(u: torch.Tensor, inv):
    """(x, slope) of the flat inverse at the [0, 1) uniforms ``u``, in the
    JAX kernel's float32 order; of a knot-exact one, ``knot_interp(u,
    cdf, x)`` and a zero slope (its logq comes from a log table)."""
    if isinstance(inv, KnotTable):
        x = knot_interp(u, inv.keys, inv.vals)
        return x, torch.zeros_like(x)
    m = inv.t.shape[0]
    pos = u * float(m - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, m - 2).long()
    frac = pos - i0.to(torch.float32)
    dx = inv.dt[i0]
    return inv.t[i0] + frac * dx, dx


def sampler_logq(slope: torch.Tensor, inv: InverseTable) -> torch.Tensor:
    """The sampler's own log density at its draw of ``slope``:
    ``-log(max(slope, 1e-30)) - float32(log(m - 1))``."""
    return -torch.log(torch.clamp(slope, min=1e-30)) - inv.log_m1


def _inside(x: torch.Tensor, tab: KnotTable) -> torch.Tensor:
    return (x >= tab.lo) & (x <= tab.hi)


def log_table_value(x: torch.Tensor, tab) -> torch.Tensor:
    """A log table at ``x``: the interpolated value on its grid (uniform,
    or by ``knot_interp`` over a :class:`KnotTable`'s), -100 off it."""
    if isinstance(tab, KnotTable):
        return torch.where(_inside(x, tab),
                           knot_interp(x, tab.keys, tab.vals), LOG_PDF_FLOOR)
    return uniform_table_value(x, tab.vals, tab.dx, tab.grid, LOG_PDF_FLOOR)


def log_table_slope(x: torch.Tensor, tab) -> torch.Tensor:
    """A log table's slope at ``x``, HMC's gradient on a CUSTOM target
    (``uniform_table_slope``, ``integrate_pallas.py:757-775``):
    ``dx[i0] / step`` at the index :func:`log_table_value` reads, 0 off
    the grid; over a :class:`KnotTable`, ``(vals[i + 1] - vals[i]) /
    (keys[i + 1] - keys[i])`` on the knot interval the lookup reads (0
    over a flat pair), 0 off it (``jax.grad`` of ``jnp.interp``)."""
    if isinstance(tab, KnotTable):
        keys, vals = tab.keys, tab.vals
        i = torch.searchsorted(keys, x.contiguous(), right=True) - 1
        i = torch.clamp(i, 0, keys.shape[0] - 2)
        dk = keys[i + 1] - keys[i]
        pos = dk > 0
        slope = torch.where(
            pos, (vals[i + 1] - vals[i]) / torch.where(pos, dk, 1.0), 0.0)
        return torch.where(_inside(x, tab), slope, 0.0)
    x0, step, x_max = (float(g) for g in tab.grid)
    pos = _true_div(x - x0, step)
    i0 = torch.clamp(pos.to(torch.int32), 0, tab.vals.shape[0] - 2).long()
    inside = (x >= x0) & (x <= x_max)
    return torch.where(inside, _true_div(tab.dx[i0], step), 0.0)


class _TableRef(ctypes.Structure):
    """One table as ``tmc::TableRef`` in ``csrc/counter_rng.cuh``."""

    _fields_ = [
        ("v", ctypes.c_void_p),   # knots, padded log values, or knot keys
        ("d", ctypes.c_void_p),   # differences or slopes, or knot values
        ("x0", ctypes.c_float),   # a grid's first x, a knot table's key
        ("step", ctypes.c_float),
        ("x_max", ctypes.c_float),  # a grid's last x, a knot table's key
        ("log_m1", ctypes.c_float),
        ("n", ctypes.c_int),      # knots, padded length, or knot count
    ]


def _ref(table) -> _TableRef:
    ref = _TableRef()
    if isinstance(table, InverseTable):
        ref.v, ref.d = table.t.data_ptr(), table.dt.data_ptr()
        ref.log_m1, ref.n = table.log_m1, table.t.shape[0]
    elif isinstance(table, LogTable):
        ref.v, ref.d = table.vals.data_ptr(), table.dx.data_ptr()
        ref.x0, ref.step, ref.x_max = table.grid
        ref.n = table.vals.shape[0]
    elif isinstance(table, KnotTable):
        ref.v, ref.d = table.keys.data_ptr(), table.vals.data_ptr()
        ref.x0, ref.x_max = table.lo, table.hi
        ref.n = table.keys.shape[0]
    return ref


@functools.lru_cache(maxsize=None)
def _tables_struct(d: int):
    """``tmc::McmcTables<d>``: d table references per role."""
    return type(f"McmcTables{d}", (ctypes.Structure,), {
        "_fields_": [(name, _TableRef * d) for name in ("inv", "q", "targ")]})


def kernel_tables(tables: Optional[Sequence[Optional[DimTables]]], d: int):
    """The launch's ``tmc::McmcTables<d>``: per dimension, the proposal's
    inverse, a gapped proposal's log table and the target's log table
    (null where a dimension has none); passed by host pointer and copied
    into the launch by value.  None when no dimension has a table."""
    if tables is None or all(t is None for t in tables):
        return None
    out = _tables_struct(d)()
    for j, dim in enumerate(tables):
        if dim is None:
            continue
        out.inv[j], out.q[j], out.targ[j] = (
            _ref(dim.inv), _ref(dim.q), _ref(dim.targ))
    return out


def check_dim_tables(tables, kinds_and_roles, what: str,
                     device: torch.device, knots=()) -> None:
    """Raises ValueError unless ``tables`` holds exactly the tables that
    ``kinds_and_roles`` (per dimension: (proposal is CUSTOM, its logq
    comes from its log table, target is CUSTOM)) need, each a
    :class:`KnotTable` where ``knots`` (per dimension, ``DimTables.knots``;
    ``()`` for none) says so, on ``device``."""
    need = [p or t for p, _, t in kinds_and_roles]
    if tables is not None and all(t is None for t in tables):
        tables = None
    if not any(need):
        if tables is not None:
            raise ValueError(
                f"{what} without CUSTOM dimensions takes no tables")
        return
    if tables is None or len(tables) != len(need):
        raise ValueError(f"{what} over CUSTOM dimensions takes one DimTables "
                         "entry per dimension")
    for j, ((prop, gapped, targ), dim) in enumerate(zip(kinds_and_roles,
                                                          tables)):
        dim = dim or DimTables()
        if ((dim.inv is not None) != prop or (dim.q is not None) != gapped
                or (dim.targ is not None) != targ):
            raise ValueError(
                f"{what}: dimension {j}'s tables do not match its families "
                "(an inverse for a CUSTOM proposal, a log table for a "
                "gapped one and for a CUSTOM target)")
        if dim.knots != (tuple(knots[j]) if knots else (False,) * 3):
            raise ValueError(
                f"{what}: dimension {j}'s tables are not the knot tables "
                "its route compiles in")
        for tab in (dim.inv, dim.q, dim.targ):
            if tab is not None and tab[0].device != device:
                raise ValueError(
                    f"{what}: dimension {j}'s tables lie on {tab[0].device}, "
                    f"the run on {device}")
