"""Multi-dimensional fused integrate: grid plan, per-dimension draws
(counter RNG or Sobol), the error-bar pilot, the plain PyTorch version and
the CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/integrate_nd_pallas.py`` (kernel 2) in its
``mc``, ``antithetic`` and ``qmc`` modes, with and without error bars, for
d >= 2 dimensions of the uniform, normal and exponential families, the
seven extended families (``sampling.ANALYTIC_EXT``) and CUSTOM tables, in
any mix, and over importance-sampling sets
(``IntegrateNdProgram(fns, kinds, weight)``: each integrand times the
product weight prod_j p_j(x_j) / q_j(x_j)).  For the same (seed, plan)
the plain version and the kernel draw exactly the samples the JAX kernel
draws in interpret mode, where that kernel keeps 256-row blocks
(``pick_nd_rows``; the port always does).

CUSTOM dimensions (``_strat_dim``, integrate_nd_pallas.py:78-90): the
first one draws through the 1-D kernel's row-stratified tables under
``mc`` and ``antithetic`` (one stratum per 8 rows of a tile; its mirror
stays in the row's stratum); every other one, and every one under
``qmc``, through its flat full inverse, ``x = t[i0] + frac * dt[i0]`` at
``pos = w * (m - 1)``.  A gap-respecting table takes the 1-D kernel's
gap-respecting strata or the MCMC kernels' flat gapped tables, and a
heavy-tailed one the knot-exact inverse: the JAX package sends both to
its XLA sweep.

Sample layout: the plan becomes ``programs x loops`` tiles of
``BLOCK_ROWS x LANES`` positions.  Tile (pid, blk) seeds the counter RNG
with (seed, pid) and draws dimension ``j`` as one full block with counter
``blk`` and tag ``j`` (no half-block split for the normal family).  Under
``antithetic`` each position's uniforms give two points, ``u`` and its
mirror, so a tile holds twice its positions in samples.  Under ``qmc``
position ``pos`` of tile ``t`` is Sobol point ``t * 2**15 + pos`` of the
dimension, rotated by ``derive_shift(seed, j + 1)``; past 2**32 points
the tile index splits into a segment (``t >> 17``), which re-mixes the
rotation, and a block within it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..sampling import (
    DistKind,
    normal_from_u01,
    transform_from_u,
    transform_grad_from_u,
)
from ..tracing import TracedFunction
from .integrate_kernel import (
    BLOCK_ELEMS,
    BLOCK_ROWS,
    LANES,
    MAX_CUDA_BLOCKS,
    MAX_FUNCTIONS,
    POS_BITS,
    SAMPLER,
    STRATA,
    CounterRng,
    Grid,
    KnotTables,
    KnotWeightTable,
    StrataTables,
    UniformWeightTable,
    _custom_draw,
    _WeightTab,
    _weight_tab,
    check_batch,
    finish_stderr,
    kernel_weight,
    knot_interp,
    qmc_seg_bits,
    uniform_halfopen01,
    uniform_open01,
)
from .lower import cuda_source, to_torch, to_torch_grad
from .reduce import fixed_sum
from .qmc import (
    MASK32,
    SOBOL_MAX_DIMS,
    derive_segment_shift,
    derive_shift,
    sobol_base_bits,
    sobol_direction_numbers,
    sobol_offset_bits,
    sobol_u01_split,
)

__all__ = [
    "CustomDim",
    "FlatTables",
    "IntegrateNdProgram",
    "NdConfig",
    "finish_stderr",
    "integrate_nd_batch",
    "integrate_nd_batch_rows",
    "integrate_nd_cuda",
    "integrate_nd_grad_cuda",
    "integrate_nd_grad_reference",
    "integrate_nd_reference",
    "max_grad_functions",
    "integrate_nd_rows",
    "nd_draws",
    "nd_routes",
    "nd_samples",
    "nd_uniforms",
    "pilot_row",
    "qmc_seg_bits",
]

METHODS = ("mc", "qmc", "antithetic")
# Tiles the plain version draws at once (per dimension 2M samples).
_TILES_PER_CHUNK = 64
# The pilot's quantile grid: 8 x 128 points per dimension, offset by the
# golden ratio's fraction per dimension (integrate_nd_pallas.py:822-829).
_PILOT_POINTS = 8 * LANES
_PILOT_OFFSET = float(np.float32(0.3819660113))
_U_LO = float(np.float32(1e-7))
_U_HI = float(np.float32(1.0 - 1e-7))


@dataclass(frozen=True)
class NdConfig:
    """What one nd run computes: the per-dimension families, the method,
    and whether the kernel also sums pilot-shifted squares (in every mode,
    as the JAX kernel does; ``integrate``'s own ``qmc`` error bars come
    from rotations), or under ``grad`` each function's pathwise
    derivatives in every dimension's two parameters (the gradient build,
    a library of its own; analytic dimensions).  Its
    ``strat_dim`` is the CUSTOM dimension that draws through stratified
    tables, if any."""

    kinds: Tuple[DistKind, ...]
    method: str = "mc"
    with_stderr: bool = False
    grad: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kinds", tuple(DistKind(k) for k in self.kinds))
        if self.method not in METHODS:
            raise ValueError(
                "method must be 'mc', 'qmc' or 'antithetic', got "
                f"{self.method!r}"
            )
        if len(self.kinds) < 2:
            raise ValueError("nd integrate takes d >= 2 dimensions")
        if self.method == "qmc" and self.d > SOBOL_MAX_DIMS:
            raise ValueError(
                f"method='qmc' supports up to {SOBOL_MAX_DIMS} dimensions, "
                f"got {self.d}"
            )
        if self.grad and (self.with_stderr or DistKind.CUSTOM in self.kinds):
            raise ValueError("the gradient build takes analytic dimensions "
                             "and no error bars")

    @property
    def d(self) -> int:
        return len(self.kinds)

    @property
    def antithetic(self) -> bool:
        return self.method == "antithetic"

    @property
    def strat_dim(self) -> int:
        """The first CUSTOM dimension under ``mc`` and ``antithetic``
        (the JAX kernel's ``_strat_dim``), else -1: one stratified
        dimension keeps proportional allocation unbiased, two on one row
        index would pair their strata; QMC points map through the full
        inverse."""
        if self.method == "qmc" or DistKind.CUSTOM not in self.kinds:
            return -1
        return self.kinds.index(DistKind.CUSTOM)


# -- CUSTOM dimensions' tables ------------------------------------------------

#: Route codes of a CUSTOM dimension in the nd kernel (``TMC_ROUTES``,
#: ``tmc::NdRoute``): 0 is a closed-form family.
ROUTES = {"strata": 1, "flat": 2, "knots": 3}


@dataclass(frozen=True)
class FlatTables:
    """The ``"flat"`` route's float32 tables on the device: the m knots
    ``t`` of a full inverse CDF on a uniform u-grid and ``dt``, their
    forward differences (a gapped table's slopes, which never cross a
    zero-density gap)."""

    t: torch.Tensor
    dt: torch.Tensor
    route = "flat"

    @property
    def inv_du(self) -> float:
        """``float32(1 / (m - 1))``, the sampler density's numerator (in
        float64, rounded once, as the JAX kernel's)."""
        return float(np.float32(1.0 / (self.t.shape[0] - 1)))


DrawTables = Union[StrataTables, FlatTables, KnotTables]


@dataclass(frozen=True)
class CustomDim:
    """One CUSTOM dimension's tables: ``draw``, the tables its route
    draws through (:class:`StrataTables` on the stratified dimension,
    with ``qs`` under a sampler-mode q; :class:`FlatTables`; or
    :class:`KnotTables` for a heavy-tailed table), and ``full``, its full
    inverse (the pilot's grid goes through it, and a sampler-mode q at
    the pilot is its slope's)."""

    draw: DrawTables
    full: Union[FlatTables, KnotTables]

    @property
    def route(self) -> str:
        return self.draw.route


def nd_routes(cfg: NdConfig, tables) -> Tuple[int, ...]:
    """Per dimension, the route code of the library that draws ``cfg``
    over ``tables`` (0 for a closed-form family); raises unless the
    tables are the ones ``cfg`` draws through: one :class:`CustomDim`
    per CUSTOM dimension and None elsewhere, stratified tables on the
    stratified dimension only (or the knot route there)."""
    tables = [None] * cfg.d if tables is None else list(tables)
    if len(tables) != cfg.d:
        raise ValueError(f"tables must have one entry per dimension ({cfg.d})")
    routes = []
    for j, (kind, tab) in enumerate(zip(cfg.kinds, tables)):
        if (kind == DistKind.CUSTOM) != isinstance(tab, CustomDim):
            raise ValueError(
                f"dimension {j}: CUSTOM dimensions, and only they, take a "
                "CustomDim of tables")
        if tab is None:
            routes.append(0)
            continue
        want = ("strata", "knots") if j == cfg.strat_dim else ("flat", "knots")
        if tab.route not in want:
            raise ValueError(
                f"dimension {j} draws on the {' or '.join(want)} route under "
                f"{cfg.method!r}, not {tab.route!r}")
        routes.append(ROUTES[tab.route])
    return tuple(routes)


def _flat_draw(tab: FlatTables, w: torch.Tensor, with_q: bool):
    """The flat inverse at the [0, 1) uniforms ``w``, in the JAX kernel's
    float32 order: ``pos = w * (m - 1)``, ``i0 = clip(int(pos), 0, m -
    2)``, ``x = t[i0] + (pos - i0) * dt[i0]``; with ``with_q`` an (x, q)
    pair, q the sampler's density ``(1 / (m - 1)) / dt[i0]`` (0 where
    dt[i0] is 0)."""
    m = tab.t.shape[0]
    pos = w * float(m - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, m - 2).long()
    frac = pos - i0.to(torch.float32)
    slope = tab.dt[i0]
    x = tab.t[i0] + frac * slope
    if not with_q:
        return x
    return x, _flat_sampler_q(slope, tab.inv_du)


def _flat_sampler_q(slope: torch.Tensor, inv_du: float) -> torch.Tensor:
    """``where(dt > 0, inv_du / max(dt, 1e-38), 0)``, one true division."""
    num = torch.full_like(slope, inv_du)
    q = num / torch.clamp(slope, min=1e-38)
    return torch.where(slope > 0, q, torch.zeros_like(q))


def _custom_dim_draw(tab: CustomDim, w: torch.Tensor, with_q: bool):
    """A CUSTOM dimension's samples at ``w`` ((..., 256, 128) uniforms)
    on its route: x, or an (x, q) pair with ``with_q``."""
    draw = tab.draw
    if isinstance(draw, FlatTables):
        return _flat_draw(draw, w, with_q)
    if isinstance(draw, StrataTables) and with_q != (draw.qs is not None):
        raise ValueError("strata tables carry qs exactly under a "
                         "sampler-mode q")
    if isinstance(draw, KnotTables) and with_q:
        raise ValueError("the knot route has no sampler density")
    return _custom_draw(draw, w, BLOCK_ROWS)


def _positions(device) -> torch.Tensor:
    """(BLOCK_ROWS, LANES) positions ``row * 128 + lane`` within a tile."""
    return torch.arange(BLOCK_ELEMS, dtype=torch.int64, device=device).reshape(
        BLOCK_ROWS, LANES
    )


def nd_uniforms(
    method: str, seed: int, grid: Grid, tiles: torch.Tensor, j: int,
    open01: bool,
) -> torch.Tensor:
    """(len(tiles), 256, 128) float32 uniforms of dimension ``j`` for the
    given tile indices: [0, 1), or (0, 1] with ``open01``."""
    dev = tiles.device
    if method != "qmc":
        rng = CounterRng(seed, tiles // grid.loops, device=dev)
        draw = uniform_open01 if open01 else uniform_halfopen01
        return draw(rng, (BLOCK_ROWS, LANES), tiles % grid.loops, j)
    v32 = sobol_direction_numbers(j)
    shift = derive_shift(seed, j + 1).to(dev)
    b = tiles
    seg_bits = qmc_seg_bits(grid)
    if seg_bits is not None:
        shift = derive_segment_shift(shift, b >> seg_bits)
        b = b & ((1 << seg_bits) - 1)
    else:
        shift = shift.expand(b.shape)
    base = sobol_base_bits(b, v32, POS_BITS)
    offset = sobol_offset_bits(_positions(dev), v32, POS_BITS)
    return sobol_u01_split(
        base[:, None, None], offset[None], shift[:, None, None], open01=open01
    )


def _draw_dim(kind: DistKind, p1, p2, get_u) -> torch.Tensor:
    """One block of dimension samples from ``get_u(open01)``'s uniforms
    (integrate_nd_pallas.py:183-204, ``csrc/counter_rng.cuh``
    ``tmc::transform``): the exponential from (0, 1] uniforms, the others
    from [0, 1) ones."""
    return transform_from_u(get_u(kind == DistKind.EXPONENTIAL), kind, p1, p2)


def _draw_dim_grad(kind: DistKind, p1, p2, get_u):
    """:func:`_draw_dim`'s block (bit for bit) with its derivatives,
    ``(x, dx/dp1, dx/dp2)``."""
    return transform_grad_from_u(get_u(kind == DistKind.EXPONENTIAL), kind,
                                 p1, p2)


def _draw_dim_pair_grad(kind: DistKind, p1, p2, get_u):
    """:func:`_draw_dim_pair`'s pair (bit for bit), each with its
    derivatives: the normal mirror's are (1, -z)."""
    if kind == DistKind.NORMAL:
        z = normal_from_u01(get_u(False))
        a, b = p1 + p2 * z, p1 - p2 * z
        one = torch.ones_like(a)
        return (a, one, z), (b, one, -z)
    u = get_u(kind == DistKind.EXPONENTIAL)
    return (transform_grad_from_u(u, kind, p1, p2),
            transform_grad_from_u(1.0 - u, kind, p1, p2))


def _draw_dim_pair(kind: DistKind, p1, p2, get_u):
    """Antithetic pair of one dimension from one uniform set: the
    transform at ``u`` and at its mirror ``1 - u`` (the normal pair
    reflects z about the mean, an extended family evaluates its inverse at
    ``1 - u`` afresh; integrate_nd_pallas.py:143-180)."""
    if kind == DistKind.NORMAL:
        z = normal_from_u01(get_u(False))
        return p1 + p2 * z, p1 - p2 * z
    u = get_u(kind == DistKind.EXPONENTIAL)
    return transform_from_u(u, kind, p1, p2), transform_from_u(1.0 - u, kind,
                                                               p1, p2)


def nd_draws(
    cfg: NdConfig, params: torch.Tensor, seed: int, grid: Grid,
    tiles: torch.Tensor, tables=None, sampler_dims: Sequence[int] = (),
):
    """The given tiles' points, as a list of (xs, qs) pairs: one, or
    under ``antithetic`` two (the points and their mirrors).  ``xs`` holds
    the d sample blocks, each (len(tiles), 256, 128) float32; ``qs[j]``
    the sampler's density of a CUSTOM dimension in ``sampler_dims``
    (else None).  ``tables[j]`` is the :class:`CustomDim` of each CUSTOM
    dimension."""
    tables = [None] * cfg.d if tables is None else list(tables)
    sets = [([], []) for _ in range(2 if cfg.antithetic else 1)]
    for j, kind in enumerate(cfg.kinds):
        get_u = lambda open01, j=j: nd_uniforms(  # noqa: E731
            cfg.method, seed, grid, tiles, j, open01
        )
        if kind == DistKind.CUSTOM:
            w = get_u(False)
            with_q = j in sampler_dims
            draws = [_custom_dim_draw(tables[j], w, with_q)]
            if cfg.antithetic:
                draws.append(_custom_dim_draw(tables[j], 1.0 - w, with_q))
            for (xs, qs), got in zip(sets, draws):
                x, q = got if with_q else (got, None)
                xs.append(x)
                qs.append(q)
            continue
        p1, p2 = params[j, 0], params[j, 1]
        draws = (_draw_dim_pair(kind, p1, p2, get_u) if cfg.antithetic
                 else (_draw_dim(kind, p1, p2, get_u),))
        for (xs, qs), x in zip(sets, draws):
            xs.append(x)
            qs.append(None)
    return sets


def nd_draws_grad(
    cfg: NdConfig, params: torch.Tensor, seed: int, grid: Grid,
    tiles: torch.Tensor,
):
    """The given tiles' points with their derivatives, for the gradient
    build's plain version: a list of one (under ``antithetic`` two) ``(xs,
    ds)`` pairs, ``xs`` :func:`nd_draws`'s d blocks bit for bit and
    ``ds[j]`` the pair ``(dx_j/dp1, dx_j/dp2)`` of dimension j's
    parameters.  Analytic dimensions only."""
    sets = [([], []) for _ in range(2 if cfg.antithetic else 1)]
    for j, kind in enumerate(cfg.kinds):
        get_u = lambda open01, j=j: nd_uniforms(  # noqa: E731
            cfg.method, seed, grid, tiles, j, open01
        )
        p1, p2 = params[j, 0], params[j, 1]
        draws = (_draw_dim_pair_grad(kind, p1, p2, get_u) if cfg.antithetic
                 else (_draw_dim_grad(kind, p1, p2, get_u),))
        for (xs, ds), (x, d1, d2) in zip(sets, draws):
            xs.append(x)
            ds.append((d1, d2))
    return sets


def nd_samples(
    cfg: NdConfig, params: torch.Tensor, seed: int, grid: Grid,
    tiles: torch.Tensor, tables=None,
):
    """The d sample blocks, each (len(tiles), 256, 128) float32, of the
    given tiles; under ``antithetic`` a pair of such d-lists (the points
    and their mirrors)."""
    sets = [xs for xs, _ in nd_draws(cfg, params, seed, grid, tiles, tables)]
    return tuple(sets) if cfg.antithetic else sets[0]


def _pilot_grid(j: int, kind: DistKind, p1, p2, u: torch.Tensor, tables,
                with_q: bool = False):
    """Dimension j's pilot points at the quantile grid ``u``; with
    ``with_q`` (a sampler-mode CUSTOM dimension) an (x, q) pair, q the
    full inverse's sampler density at x."""
    if kind == DistKind.UNIFORM:
        return p1 + u * (p2 - p1)
    if kind == DistKind.NORMAL:
        return p1 + p2 * normal_from_u01(u)
    if kind == DistKind.EXPONENTIAL:
        return -torch.log(u) / p1
    if kind != DistKind.CUSTOM:
        return transform_from_u(u, kind, p1, p2)
    full = tables[j].full
    if isinstance(full, KnotTables):
        return knot_interp(u, full.cdf, full.x)
    return _flat_draw(full, u, with_q)


def pilot_row(
    torch_fns: Sequence[Callable], kinds: Sequence[DistKind],
    params: torch.Tensor, tables=None, weight=None,
) -> torch.Tensor:
    """(K,) float32 pilots: each integrand's mean over per-dimension
    quantile grids (``_pilot_row_of``, integrate_nd_pallas.py:816-858).
    As written there: the uniform grid is not clamped below its bound and
    the exponential one is ``-log(u) / p1``; a CUSTOM grid goes through
    its full inverse.  An importance set's values carry the product
    weight, ``weight`` being its ``torch_weight``, with a sampler-mode q
    from the full inverse's slope at each point (the JAX package's
    ``_pilot_weight_nd`` interpolates a table density on its own grid and
    searches the raw inverse for the slope: the same function but for
    rounding).  (R, d, 2) ``params`` rows give (R, K) pilots in one
    batched pass; the means add in ``fixed_sum``'s order, so row r is the
    pilot of ``params[r]`` alone, bit for bit.  Any pilot keeps the error
    bar exact; a near one keeps float32 cancellation small."""
    if params.dim() == 3 and params.device.type == "cpu":
        # The plain path: the CPU's elementwise kernels may round a
        # transcendental by a vector lane or a scalar tail, by where an
        # element falls in the tensor.
        return torch.stack([pilot_row(torch_fns, kinds, row, tables, weight)
                            for row in params.unbind()])
    dev = params.device
    base = (
        torch.arange(_PILOT_POINTS, dtype=torch.float32, device=dev) + 0.5
    ) / float(_PILOT_POINTS)
    sampler_dims = () if weight is None else weight.sampler_dims
    xs, qs = [], []
    for j, kind in enumerate(kinds):
        offset = float(np.float32(j) * np.float32(_PILOT_OFFSET))
        u = torch.remainder(base + offset, 1.0)
        u = torch.clamp(u, _U_LO, _U_HI)
        got = _pilot_grid(j, kind, params[..., j, 0:1], params[..., j, 1:2],
                          u, tables, j in sampler_dims)
        x, q = got if j in sampler_dims else (got, None)
        xs.append(x)
        qs.append(q)
    w = None if weight is None else weight(xs, qs)
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    vals = torch.stack([
        torch.broadcast_to(f(*xs) if w is None else f(*xs) * w, shape)
        for f in torch_fns], dim=-2)
    return fixed_sum(vals, -1) / float(_PILOT_POINTS)


def _check_args(cfg: NdConfig, params: torch.Tensor, pilot, k: int,
                tables=None) -> None:
    if params.dtype != torch.float32 or params.shape != (cfg.d, 2):
        raise ValueError(
            f"params must be a ({cfg.d}, 2) float32 tensor, got "
            f"{tuple(params.shape)} {params.dtype}"
        )
    if cfg.with_stderr:
        if pilot is None or pilot.shape != (k,) or pilot.dtype != torch.float32:
            raise ValueError(f"error bars need a ({k},) float32 pilot")
        if pilot.device != params.device:
            raise ValueError("pilot and params must be on one device")
    nd_routes(cfg, tables)
    for tab in tables or ():
        for t in () if tab is None else (tab.draw, tab.full):
            for v in vars(t).values():
                if isinstance(v, torch.Tensor) and (
                        v.dtype != torch.float32 or v.device != params.device):
                    raise ValueError(
                        "tables must be float32 on the params' device")


def integrate_nd_reference(
    torch_fns: Sequence[Callable],
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
    tables=None,
    weight=None,
) -> torch.Tensor:
    """Plain PyTorch version, on ``params``' device: (K,) float32 sums
    over the grid's samples, or with ``cfg.with_stderr`` a (2, K) stack of
    the sums and the squares of (value - pilot), of pair means under
    ``antithetic``.  ``tables[j]`` is each CUSTOM dimension's
    :class:`CustomDim`; ``weight``, an importance set's
    :class:`IntegrateNdProgram` ``torch_weight``, multiplies each value.
    Same draws and float32 operations as the kernel; tiles go
    ``_TILES_PER_CHUNK`` at a time."""
    k = len(torch_fns)
    _check_args(cfg, params, pilot, k, tables)
    sampler_dims = () if weight is None else weight.sampler_dims
    dev = params.device
    sums = torch.zeros(k, dtype=torch.float32, device=dev)
    sqs = torch.zeros(k, dtype=torch.float32, device=dev)
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        sets = nd_draws(cfg, params, seed, grid, tiles, tables, sampler_dims)
        ws = [None if weight is None else weight(xs, qs) for xs, qs in sets]
        tile_sums, tile_sqs = [], []
        for j, f in enumerate(torch_fns):
            vals = [f(*xs) if w is None else f(*xs) * w
                    for (xs, _), w in zip(sets, ws)]
            tile_sums.append(sum(v.sum(dim=(1, 2)) for v in vals))
            if not cfg.with_stderr:
                continue
            # Antithetic squares are of the pair's mean: pairs are the unit.
            dd = (0.5 * (vals[0] + vals[1]) if cfg.antithetic
                  else vals[0]) - pilot[j]
            tile_sqs.append((dd * dd).sum(dim=(1, 2)))
        sums += torch.stack(tile_sums, dim=1).sum(dim=0)
        if cfg.with_stderr:
            sqs += torch.stack(tile_sqs, dim=1).sum(dim=0)
    return torch.stack([sums, sqs]) if cfg.with_stderr else sums


def integrate_nd_grad_reference(
    torch_grads: Sequence[Callable],
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the nd gradient build, on ``params``'
    device: ``(sums, grads)``, the (K,) float32 sums of the values
    (:func:`integrate_nd_reference`'s, bit for bit) and the (K, d, 2) sums
    of the pathwise terms ``df_k/dx_j * dx_j/dp`` of each dimension's two
    parameters.  ``torch_grads`` is the program's ``torch_grads``."""
    k = len(torch_grads)
    _check_grad(cfg, params)
    dev = params.device
    sums = torch.zeros(k, dtype=torch.float32, device=dev)
    grads = torch.zeros((k, cfg.d, 2), dtype=torch.float32, device=dev)
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        sets = nd_draws_grad(cfg, params, seed, grid, tiles)
        tile_sums, tile_grads = [], []
        for vg in torch_grads:
            outs = [vg(*xs) for xs, _ in sets]
            tile_sums.append(sum(v.sum(dim=(1, 2)) for v, _ in outs))
            tile_grads.append(torch.stack([
                torch.stack([sum((g[j] * ds[j][c]).sum(dim=(1, 2))
                                 for (_, g), (_, ds) in zip(outs, sets))
                             for c in (0, 1)], dim=-1)
                for j in range(cfg.d)], dim=-2))
        sums += torch.stack(tile_sums, dim=1).sum(dim=0)
        grads += torch.stack(tile_grads, dim=1).sum(dim=0)
    return sums, grads


def _check_grad(cfg: NdConfig, params: torch.Tensor) -> None:
    if not cfg.grad:
        raise ValueError("a gradient run takes a gradient configuration")
    _check_args(cfg, params, None, 0)


def max_grad_functions(d: int) -> int:
    """Most functions a gradient build's group takes over d dimensions:
    K (2d + 1) sums in registers, at most the 1-D build's 96."""
    return max(1, 96 // (2 * d + 1))


class _NdWeight:
    """An importance set's product weight over d dimensions, each a (p,
    q) pair: p a traced density, a :class:`UniformWeightTable` or a
    :class:`KnotWeightTable`; q one of those or :data:`SAMPLER` (a CUSTOM
    dimension's own sampling density, read with its draw).  Called on a
    point's d sample blocks and the draws' sampler densities, it gives
    the JAX nd kernel's ``weight`` (integrate_nd_pallas.py:498-520):
    prod_j where(q_j > 0, p_j / q_j, 0) in dimension order."""

    def __init__(self, weight):
        self.pairs = tuple(tuple(pair) for pair in weight)
        self.sampler_dims = tuple(j for j, (_, q) in enumerate(self.pairs)
                                  if q is SAMPLER)
        tables = (TracedFunction, UniformWeightTable, KnotWeightTable)
        for p, q in self.pairs:
            if not isinstance(p, tables) or not (
                    isinstance(q, tables) or q is SAMPLER):
                raise ValueError(f"unknown importance weight modes {weight}")
        self._of = [tuple(to_torch(m) if isinstance(m, TracedFunction) else m
                          for m in pair) for pair in self.pairs]

    def __call__(self, xs, qs) -> torch.Tensor:
        w = None
        for j, ((p_of, q_of), x) in enumerate(zip(self._of, xs)):
            p = p_of(x).to(torch.float32)
            q = qs[j] if j in self.sampler_dims else q_of(x).to(torch.float32)
            r = kernel_weight(p, q)
            w = r if w is None else w * r
        return w


class IntegrateNdProgram:
    """One fused d-ary integrand set over one tuple of per-dimension
    families, lowered both ways: ``torch_fns`` for the plain version, and
    one CUDA library per tuple of CUSTOM routes, built at first use.  The
    families are compiled into the library (``TMC_KINDS``), as the JAX
    kernel is traced per family tuple: each dimension's transform is then
    straight-line code; so are the routes (``TMC_ROUTES``).

    ``weight``, one (p, q) pair per dimension, makes it an
    importance-sampling set (:class:`_NdWeight`): every integrand is
    multiplied by the product weight, in the kernel (``ops/lower.py``)
    and in ``torch_weight``."""

    def __init__(self, fns: Sequence[TracedFunction], kinds: Sequence[DistKind],
                 weight=None):
        kinds = tuple(DistKind(k) for k in kinds)
        if not 1 <= len(fns) <= MAX_FUNCTIONS:
            raise ValueError(
                f"the kernel fuses 1 to {MAX_FUNCTIONS} functions, "
                f"got {len(fns)}"
            )
        if any(f.n_args != len(kinds) for f in fns):
            raise ValueError(
                f"every integrand must take {len(kinds)} arguments, one per "
                "dimension"
            )
        NdConfig(kinds)  # validates the families
        self.fns = tuple(fns)
        self.kinds = kinds
        self.torch_fns: List[Callable] = [to_torch(f) for f in fns]
        self.torch_weight = None
        if weight is not None:
            if len(weight) != len(kinds):
                raise ValueError("an nd importance weight takes one (p, q) "
                                 "pair per dimension")
            self.torch_weight = _NdWeight(weight)
            for j in self.torch_weight.sampler_dims:
                if kinds[j] != DistKind.CUSTOM:
                    raise ValueError(
                        "sampler-mode nd IS weights need CUSTOM dims")
        self._libs = {}
        self._dirs = {}
        self._grads = None

    @property
    def torch_grads(self) -> List[Callable]:
        """Each function's value and partial derivatives at a point's
        blocks, ``(value, [d/dx_j])`` (``lower.to_torch_grad``), for the
        gradient build's plain version; made at first use."""
        if self._grads is None:
            self._grads = [to_torch_grad(f) for f in self.fns]
        return self._grads

    @property
    def weight(self):
        return None if self.torch_weight is None else self.torch_weight.pairs

    @property
    def sampler_dims(self) -> Tuple[int, ...]:
        """The dimensions whose q is their sampler's own density."""
        return () if self.torch_weight is None else self.torch_weight.sampler_dims

    def library(self, routes: Optional[Sequence[int]] = None,
                grad: bool = False):
        """The library drawing each CUSTOM dimension on ``routes[j]``
        (:func:`nd_routes`; None where no dimension is CUSTOM); with
        ``grad`` the gradient build (analytic dimensions, unweighted)."""
        routes = tuple(routes) if routes is not None and any(routes) else None
        if (routes is not None) != (DistKind.CUSTOM in self.kinds):
            raise ValueError("CUSTOM dimensions, and only they, take routes")
        if grad and (routes is not None or self.weight is not None):
            raise ValueError("the gradient build takes analytic dimensions "
                             "and unweighted sets only")
        key = (routes, grad)
        if key not in self._libs:
            from .build import load_kernel_library

            kinds = ", ".join(str(int(k)) for k in self.kinds)
            defines = f"#define TMC_KINDS {kinds}\n"
            if grad:
                defines += "#define TMC_GRAD 1\n"
            if routes is not None:
                defines += ("#define TMC_ROUTES "
                            + ", ".join(str(r) for r in routes) + "\n")
            weight = None
            if self.weight is not None:
                weight = tuple(tuple(m if isinstance(m, TracedFunction)
                                     else m.mode for m in pair)
                               for pair in self.weight)
            lib = load_kernel_library(
                "integrate_nd.cu",
                cuda_source(self.fns, weight=weight, grad=grad) + defines,
            )
            lib.tmc_integrate_nd.argtypes = [
                ctypes.c_int,       # method: 0 mc, 1 antithetic, 2 qmc
                ctypes.c_int,       # with_stderr
                ctypes.c_uint32,    # seed word (without a seed vector)
                ctypes.c_void_p,    # seed words (R,) on the device, or null
                ctypes.c_int,       # reps R
                ctypes.c_void_p,    # params (d, 2) or (R, d, 2) float32
                ctypes.c_int,       # params stride: 0 shared, 2d a block each
                ctypes.c_void_p,    # Sobol direction numbers (d, 32) or null
                ctypes.c_void_p,    # pilots (K,) or (R, K) float32, or null
                ctypes.c_int,       # pilots stride: 0 shared, K a row each
                ctypes.c_int,       # loops per program
                ctypes.c_longlong,  # tiles = programs * loops
                ctypes.c_int,       # Sobol segment bits, or -1
                ctypes.c_int,       # CUDA grid size
                ctypes.c_void_p,    # partials (R, grid, n_out) float32
                ctypes.c_void_p,    # sums (R, n_out) float32
                ctypes.c_void_p,    # host NdTables, or null
                ctypes.c_void_p,    # cudaStream_t
            ]
            lib.tmc_integrate_nd.restype = ctypes.c_int
            self._libs[key] = lib
        return self._libs[key]

    def direction_numbers(self, device) -> torch.Tensor:
        """(d, 32) Sobol direction numbers on ``device`` (uint32 words in
        int32 storage), uploaded once per device."""
        key = str(device)
        if key not in self._dirs:
            table = np.stack(
                [sobol_direction_numbers(j) for j in range(len(self.kinds))]
            )
            self._dirs[key] = torch.from_numpy(table.view(np.int32)).to(device)
        return self._dirs[key]

    def kernel_tables(self, tables, device):
        """The launch's ``NdTables`` (``csrc/integrate_nd.cu``): each
        CUSTOM dimension's route tables and each weight table's device
        pointers; None where the library reads no table."""
        if tables is None and self.weight is None:
            return None
        out = _nd_tables_struct(len(self.kinds))()
        for j, tab in enumerate(tables or [None] * len(self.kinds)):
            dim = out.dim[j]
            if tab is not None:
                draw = tab.draw
                if isinstance(draw, StrataTables):
                    dim.t, dim.dt = draw.ts.data_ptr(), draw.dts.data_ptr()
                    dim.qs = 0 if draw.qs is None else draw.qs.data_ptr()
                elif isinstance(draw, FlatTables):
                    dim.t, dim.dt = draw.t.data_ptr(), draw.dt.data_ptr()
                    dim.m, dim.inv_du = draw.t.shape[0], draw.inv_du
                else:
                    dim.t, dim.dt = draw.x.data_ptr(), draw.cdf.data_ptr()
                    dim.m = draw.x.shape[0]
            if self.weight is not None:
                dim.p = _weight_tab(self.weight[j][0], device)
                dim.q = _weight_tab(self.weight[j][1], device)
        return out


class _NdDim(ctypes.Structure):
    """One dimension's tables, as ``tmc::NdDim`` in
    ``csrc/integrate_draw.cuh``."""

    _fields_ = [
        ("t", ctypes.c_void_p),     # strata: knots; flat: m knots; knots: x
        ("dt", ctypes.c_void_p),    # strata, flat: slopes; knots: CDF knots
        ("qs", ctypes.c_void_p),    # strata: sampler density, or null
        ("inv_du", ctypes.c_float),  # flat: float32(1 / (m - 1))
        ("m", ctypes.c_int),        # flat, knots: knot count
        ("p", _WeightTab),
        ("q", _WeightTab),
    ]


@functools.lru_cache(maxsize=None)
def _nd_tables_struct(d: int):
    """``NdTables`` of ``csrc/integrate_nd.cu``: d dimensions' tables."""
    return type(f"NdTables{d}", (ctypes.Structure,),
                {"_fields_": [("dim", _NdDim * d)]})


_METHOD_CODES = {"mc": 0, "antithetic": 1, "qmc": 2}


def integrate_nd_cuda(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
    tables=None,
) -> torch.Tensor:
    """The program's sums over the grid's samples, as
    :func:`integrate_nd_reference` returns them, on ``params``' device;
    ``tables[j]`` is each CUSTOM dimension's :class:`CustomDim`.

    A CUDA ``params`` launches the kernel (``integrate_nd_cuda.launches``
    counts the launches); a CPU ``params`` runs the plain version.  Any
    other device raises.  The launch is asynchronous on the current
    stream."""
    _check_program(program, cfg, params, pilot, tables)
    if params.device.type == "cpu":
        return integrate_nd_reference(
            program.torch_fns, cfg, params, seed, grid, pilot, tables,
            program.torch_weight,
        )
    out = _launch_nd(program, cfg, params, int(seed), None, grid, pilot,
                     tables)[1][0]
    return out.reshape(2, -1) if cfg.with_stderr else out


def integrate_nd_grad_cuda(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nd gradient build's ``(sums, grads)``, as
    :func:`integrate_nd_grad_reference` returns them, on ``params``'
    device: a CUDA ``params`` launches the kernel's gradient build
    (counted in ``integrate_nd_cuda.launches`` and
    ``integrate_nd_cuda.grad_launches``), a CPU one runs the plain
    version.  Its value sums are the value build's, bit for bit."""
    _check_grad(cfg, params)
    if cfg.kinds != program.kinds or program.weight is not None:
        raise ValueError("the gradient build takes the program's analytic "
                         "dimensions, unweighted")
    if params.device.type == "cpu":
        return integrate_nd_grad_reference(program.torch_grads, cfg, params,
                                           seed, grid)
    k = len(program.fns)
    out = _launch_nd(program, cfg, params, int(seed), None, grid, None,
                     None)[1][0]
    return out[:k], out[k:].reshape(k, cfg.d, 2)


def _check_program(program, cfg, params, pilot, tables=None) -> None:
    if cfg.kinds != program.kinds:
        raise ValueError(
            f"the program was built for {program.kinds}, not {cfg.kinds}"
        )
    _check_args(cfg, params, pilot, len(program.fns), tables)
    for j in program.sampler_dims:
        if not isinstance(tables[j].draw, (StrataTables, FlatTables)):
            raise ValueError(f"dimension {j}'s sampler-mode q needs strata "
                             "or flat tables")


def integrate_nd_rows(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
    tables=None,
) -> torch.Tensor:
    """Launches the kernel on CUDA ``params`` and returns its per-block
    rows, (blocks, K) float32 sums or with ``cfg.with_stderr`` (blocks, 2K)
    sums then squares, unsummed (the launch's second pass sums them for
    ``integrate_nd_cuda``).  Counts
    the launch in ``integrate_nd_cuda.launches``."""
    _check_program(program, cfg, params, pilot, tables)
    return _launch_nd(program, cfg, params, int(seed), None, grid, pilot,
                      tables)[0][0]


def integrate_nd_batch_rows(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
    tables=None,
) -> torch.Tensor:
    """One launch of R jobs on CUDA ``params``: rep r under the seed word
    ``seeds[r]`` ((R,) int32 words on the device) with ``params`` (d, 2)
    for every rep or its block of (R, d, 2), and under error bars its
    pilot ((K,), or (R, K) beside blocks).  Returns (R, blocks, K or 2K)
    rows; each rep's are the rows of the unbatched launch with its seed
    and block, bit for bit.  Counts the launch in
    ``integrate_nd_cuda.launches`` and ``integrate_nd_cuda.batch_launches``."""
    return _batch_launch_nd(program, cfg, params, seeds, grid, pilot,
                            tables)[0]


def _batch_launch_nd(program, cfg, params, seeds, grid, pilot, tables):
    """``_launch_nd`` of a batch after its checks."""
    k = len(program.fns)
    check_batch(params, seeds, pilot, (cfg.d, 2), k, cfg.with_stderr)
    _check_program(
        program, cfg, params[0] if params.dim() == 3 else params,
        pilot[0] if pilot is not None and pilot.dim() == 2 else pilot, tables)
    return _launch_nd(program, cfg, params, 0, seeds, grid, pilot, tables)


def integrate_nd_batch(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
    tables=None,
) -> torch.Tensor:
    """R jobs' sums, (R, K), or with ``cfg.with_stderr`` (R, 2, K): element
    r is :func:`integrate_nd_cuda`'s result with the seed word ``seeds[r]``
    and rep r's params and pilot (arguments as
    :func:`integrate_nd_batch_rows`), bit for bit.  A CUDA ``params`` runs
    one launch, whose second pass sums each rep's rows in the one order
    ``integrate_nd_cuda``'s launch sums its own (``csrc/rows_sum.cuh``); a
    CPU one runs the plain version rep by rep."""
    k = len(program.fns)
    r, rowed = check_batch(params, seeds, pilot, (cfg.d, 2), k,
                           cfg.with_stderr)
    if params.device.type == "cpu":
        words = [int(w) & MASK32 for w in seeds.tolist()]
        outs = [
            integrate_nd_cuda(program, cfg, params[i] if rowed else params,
                              words[i], grid,
                              pilot[i] if rowed and pilot is not None
                              else pilot, tables)
            for i in range(r)
        ]
        return torch.stack(outs)
    sums = _batch_launch_nd(program, cfg, params, seeds, grid, pilot,
                            tables)[1]
    return sums.reshape(r, 2, k) if cfg.with_stderr else sums


def _launch_nd(program, cfg, params, seed, seeds, grid, pilot, tables):
    """One launch of the kernel and its second pass: R = len(seeds) reps,
    or one rep under the seed word ``seed`` where ``seeds`` is None.
    Returns the (R, blocks, K or 2K) rows and their (R, K or 2K) sums over
    the blocks, in ``csrc/rows_sum.cuh``'s order."""
    if params.device.type != "cuda":
        raise ValueError(f"no nd integrate kernel for device {params.device}")
    for tab in tables or ():
        if isinstance(tab, CustomDim) and isinstance(
                tab.draw, StrataTables) and tab.draw.ts.shape[0] != STRATA:
            raise ValueError(f"the kernel takes {STRATA} strata")
    routes = nd_routes(cfg, tables)
    k = len(program.fns)
    params = params.contiguous()
    dev = params.device
    reps = 1 if seeds is None else len(seeds)
    seg_bits = -1
    dirs = 0
    if cfg.method == "qmc":
        seg = qmc_seg_bits(grid)
        seg_bits = -1 if seg is None else seg
        dirs = program.direction_numbers(dev).data_ptr()
    pilots = pilot.contiguous().data_ptr() if cfg.with_stderr else 0
    kt = program.kernel_tables(tables, dev)
    lib = program.library(routes, cfg.grad)
    n_out = (2 * k if cfg.with_stderr
             else k * (1 + 2 * cfg.d) if cfg.grad else k)
    rows = min(grid.n_tiles, MAX_CUDA_BLOCKS)
    partials = torch.empty((reps, rows, n_out), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((reps, n_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tmc_integrate_nd(
            _METHOD_CODES[cfg.method], int(cfg.with_stderr),
            int(seed) & MASK32,
            None if seeds is None else seeds.contiguous().data_ptr(), reps,
            params.data_ptr(), 2 * cfg.d if params.dim() == 3 else 0, dirs,
            pilots, k if cfg.with_stderr and pilot.dim() == 2 else 0,
            grid.loops, grid.n_tiles, seg_bits, rows,
            partials.data_ptr(), sums.data_ptr(),
            None if kt is None else ctypes.addressof(kt), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"nd integrate kernel launch failed: {lib.tmc_error_string(err)!r}"
        )
    integrate_nd_cuda.launches += 1
    integrate_nd_cuda.batch_launches += int(seeds is not None)
    integrate_nd_cuda.grad_launches += int(cfg.grad)
    return partials, sums


integrate_nd_cuda.launches = 0
integrate_nd_cuda.batch_launches = 0
integrate_nd_cuda.grad_launches = 0
