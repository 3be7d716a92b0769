"""Fused 1-D Monte Carlo integrate: grid plan, counter RNG and radical
inverse, the error-bar pilot, the plain PyTorch version and the CUDA
kernel's wrapper.

Port of ``tpu_montecarlo/ops/integrate_pallas.py`` (kernel 1) in its
``mc``, ``antithetic`` and ``qmc`` modes, with and without error bars,
for the uniform, normal and exponential families, the seven extended
families (``sampling.ANALYTIC_EXT``) and CUSTOM tables, and over an
importance-sampling set (``IntegrateProgram(fns, weight=(p,
q))``: each integrand times the weight ``p / q``, ``ops/lower.py``).  The TPU
kernel draws from the TPU's hardware PRNG; off the TPU it runs with
``CounterRng``, a pure integer hash.  The port implements that
``CounterRng`` bit for bit, so for the same (seed, plan) the plain
version and the kernel here draw exactly the samples the JAX kernel
draws in interpret mode at 256-row blocks.

Sample layout: the plan becomes ``programs x loops`` tiles of
``BLOCK_ROWS x LANES`` positions.  Under ``mc`` tile (pid, blk) seeds the
RNG with (seed, pid) and draws with block counter ``blk``; the normal
family draws two half blocks with tags 0 and 1, the others one block with
tag 0 (an extended family from [0, 1) uniforms through its inverse CDF).
``antithetic`` draws the same uniforms and maps each at ``u`` and at its
mirror ``1 - u`` (the normal pair reflects z about the mean; an extended
family evaluates its inverse at ``1 - u`` afresh), so a tile holds twice
its positions in samples.  Under ``qmc`` position ``pos``
of tile ``t`` is point ``g = t * 2**15 + pos`` of the radical inverse,
rotated by ``derive_shift(seed, 1)`` (the normal family's two half
blocks are the tile's two contiguous halves of ``g``); past 2**32 points
the tile index splits into a segment (``t >> 17``), which re-mixes the
rotation, and a block within it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..sampling import (
    ANALYTIC_EXT,
    DistKind,
    exponential_from_u01,
    normal_from_u01,
    transform_from_u,
    transform_grad_from_u,
)
from ..tracing import TracedFunction
from .lower import cuda_source, to_torch, to_torch_grad, to_torch_set
from .qmc import (
    MASK32,
    QMC_MAX_SAMPLES,
    derive_segment_shift,
    derive_shift,
    pcg_mix,
    qmc_u01_halfopen,
    qmc_u01_open,
)
from .reduce import fixed_sum

__all__ = [
    "BLOCK_ROWS",
    "CounterRng",
    "Grid",
    "IntegrateConfig",
    "IntegrateProgram",
    "KnotTables",
    "KnotWeightTable",
    "LANES",
    "MAX_CUDA_BLOCKS",
    "MAX_GRAD_FUNCTIONS",
    "SAMPLER",
    "STRATA",
    "StrataTables",
    "UniformWeightTable",
    "finish_stderr",
    "check_batch",
    "integrate_batch",
    "integrate_batch_rows",
    "integrate_cuda",
    "integrate_grad_cuda",
    "integrate_grad_reference",
    "integrate_reference",
    "integrate_rows",
    "knot_interp",
    "library_route",
    "pad_uniform_table",
    "pilot_values",
    "plan_grid",
    "prep_inv_table_stratified",
    "qmc_seg_bits",
    "sample_block",
    "sample_subblocks",
    "sample_subblocks_antithetic",
    "sample_subblocks_qmc",
    "uniform_halfopen01",
    "uniform_open01",
    "uniform_table_value",
]

# Stream geometry, equal to the JAX kernel's.  The JAX package shrinks
# its block for high K, error bars or IS weights to fit VMEM
# (pick_block_rows); the port keeps 256 rows, so it draws the JAX
# package's stream wherever that picks 256.
BLOCK_ROWS = 256
LANES = 128
BLOCK_ELEMS = BLOCK_ROWS * LANES
MAX_LOOPS_PER_PROGRAM = 512
# The JAX kernel rounds loops up to a multiple of its unroll, which
# changes how many samples a plan draws; the port rounds the same way.
# Antithetic tiles carry their mirrors, so that unroll halves
# (integrate_pallas.py:932-938).
UNROLL_BLOCKS = 8
ANTITHETIC_UNROLL = UNROLL_BLOCKS // 2
POS_BITS = BLOCK_ELEMS.bit_length() - 1  # 15: a position within a tile
# Tile-index bits of one 2^32-point QMC segment (integrate_pallas.py
# :957-966).
SEG_BITS = (QMC_MAX_SAMPLES // BLOCK_ELEMS).bit_length() - 1
# Most rows of partial sums the kernel writes: the grid-stride loop maps
# tiles to at most this many CUDA blocks (a constant, so the summation
# order, and with it the result, is the same on every card).
MAX_CUDA_BLOCKS = 8192
MAX_FUNCTIONS = 128
# A gradient build keeps 3K sums in registers (values and two pathwise
# sums a function): at most this many functions a group, wider sets in
# passes over one stream (api/passes.py).
MAX_GRAD_FUNCTIONS = 32
# The first integrand count whose sample loop counts positions at run
# time (csrc/integrate.cu TMC_WIDE_K).
WIDE_K = 17
METHODS = ("mc", "qmc", "antithetic")
# Tiles the plain version draws at once: 2M samples, 16 MB per int64
# word tensor.
_TILES_PER_CHUNK = 64
# The 1-D pilot's grid: the midpoints (i + 0.5) / 1024 of the sampling
# distribution's quantiles, no offset (integrate_pallas.py:1265-1300).
_PILOT_POINTS = 8 * LANES

_INV_2POW24 = float(np.float32(1.0 / (1 << 24)))


@dataclass(frozen=True)
class Grid:
    """The kernel grid for one plan: ``programs x loops`` tiles."""

    programs: int
    loops: int
    actual_samples: int

    @property
    def n_tiles(self) -> int:
        return self.programs * self.loops


def plan_grid(n_samples: int, method: str = "mc") -> Grid:
    """Grid drawing ``actual_samples >= n_samples`` samples: the JAX
    package's ``plan_pallas_grid`` plus its unroll rounding
    (integrate_pallas.py:81-92 and :925-941).  Antithetic plans tiles for
    half the samples, rounds loops to an unroll of 4 and counts both
    members of each pair."""
    anti = method == "antithetic"
    grid_samples = -(-n_samples // 2) if anti else n_samples
    total_blocks = -(-grid_samples // BLOCK_ELEMS)
    loops = min(total_blocks, MAX_LOOPS_PER_PROGRAM)
    programs = -(-total_blocks // loops)
    unroll = min(ANTITHETIC_UNROLL if anti else UNROLL_BLOCKS, loops)
    loops = -(-loops // unroll) * unroll
    actual = programs * loops * BLOCK_ELEMS * (2 if anti else 1)
    return Grid(programs, loops, actual)


def qmc_seg_bits(grid: Grid) -> Optional[int]:
    """Tile-index bits of one QMC segment when the plan reaches 2**32
    points, else None (one segment)."""
    if grid.n_tiles >= 1 << 31:
        raise ValueError("QMC block counter exceeds int32; reduce n_samples")
    return SEG_BITS if grid.actual_samples >= QMC_MAX_SAMPLES else None


@dataclass(frozen=True)
class IntegrateConfig:
    """What one 1-D run computes: the method, and whether the kernel also
    sums pilot-shifted squares (under ``qmc`` too, as the JAX kernel does;
    ``integrate``'s own ``qmc`` error bars come from rotations).  Each
    configuration is a library of
    its own (``IntegrateProgram.library``), and so is each CUSTOM route
    and each extended family: the route of the tables a run draws
    through compiles the CUSTOM family in, an extended family's library
    that family alone, and nothing else does.

    ``grad`` makes it the gradient build (``expectation_fn``): beside
    each function's sum, its pathwise derivatives' sums in the family's
    two parameters, no error bars.  ``wide_loop`` makes a gradient build
    take the run-time position loop of sets of ``WIDE_K`` functions or
    more, which the value build of the set its group came from takes,
    so that its sums are that build's bit for bit."""

    method: str = "mc"
    with_stderr: bool = False
    grad: bool = False
    wide_loop: bool = False

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(
                "method must be 'mc', 'qmc' or 'antithetic', got "
                f"{self.method!r}"
            )
        if self.grad and self.with_stderr:
            raise ValueError("the gradient build takes no error bars")
        if self.wide_loop and not self.grad:
            raise ValueError("wide_loop is a gradient build's")

    @property
    def antithetic(self) -> bool:
        return self.method == "antithetic"

    @property
    def defines(self) -> str:
        """The kernel source's mode lines (none for plain ``mc``)."""
        code = _METHOD_CODES[self.method]
        lines = []
        if code:
            lines.append(f"#define TMC_METHOD {code}")
        if self.with_stderr:
            lines.append("#define TMC_STDERR 1")
        if self.grad:
            lines.append("#define TMC_GRAD 1")
        if self.wide_loop:
            lines.append("#define TMC_WIDE_K 1")
        return "".join(line + "\n" for line in lines)

    @property
    def n_out(self) -> int:
        """Floats a row of K functions takes, over K: values, squares or
        the pathwise sums."""
        return 3 if self.grad else (2 if self.with_stderr else 1)


_METHOD_CODES = {"mc": 0, "antithetic": 1, "qmc": 2}
_CUSTOM_CODES = {"strata": 1, "knots": 2}
MC = IntegrateConfig()


def _word(v, device) -> torch.Tensor:
    """A uint32 word (Python int, or int64 tensor) as an int64 tensor in
    [0, 2**32): negative ints wrap as int32 -> uint32 casts wrap."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK32
    return torch.tensor(int(v) & MASK32, dtype=torch.int64, device=device)


class CounterRng:
    """Counter-based PCG-hash stream, bit-equal to the JAX package's
    ``CounterRng`` (integrate_pallas.py:107-133).

    ``CounterRng(seed, pid)`` seeds from the words in order.  Words may be
    int64 tensors, which gives a batch of streams: ``bits`` then returns
    the batch shape followed by ``shape``."""

    def __init__(self, *words, device=None):
        s = _word(0x9E3779B9, device)
        for w in words:
            s = pcg_mix(s ^ _word(w, s.device))
        self.state = s

    def bits(self, shape, counter, tag: int) -> torch.Tensor:
        """uint32 bits (as int64) for position ``row * lanes + lane``."""
        rows, lanes = shape
        dev = self.state.device
        pos = torch.arange(rows * lanes, dtype=torch.int64, device=dev)
        base = pcg_mix(
            self.state
            + _word(counter, dev) * 15485863
            + (tag & MASK32) * 7199369
        )
        out = pcg_mix(base[..., None] + pos * 2654435761)
        return out.reshape(*base.shape, rows, lanes)


def uniform_open01(rng: CounterRng, shape, counter=0, tag: int = 0):
    """(0, 1] float32 uniforms from the top 24 bits."""
    m = rng.bits(shape, counter, tag) >> 8
    return (m + 1).to(torch.float32) * _INV_2POW24


def uniform_halfopen01(rng: CounterRng, shape, counter=0, tag: int = 0):
    """[0, 1) float32 uniforms from the top 24 bits."""
    m = rng.bits(shape, counter, tag) >> 8
    return m.to(torch.float32) * _INV_2POW24


# -- CUSTOM tables and table weights ----------------------------------------

#: Strata of a CUSTOM tile: ``prep_inv_table_stratified``'s min(4096 //
#: 128, 256 // 8) for a 4096-knot inverse table, and the gapped tables'
#: ``rows // 8`` segments.  The kernel compiles this count in.
STRATA = BLOCK_ROWS // 8


def _true_div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` rounded once, on any device: a one-element divisor is
    expanded first, since PyTorch may multiply by a scalar divisor's
    reciprocal instead."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a / b.expand(a.shape)


def prep_inv_table_stratified(x_table, rows: int = BLOCK_ROWS, segments=None,
                              with_pdf: bool = False):
    """Row-stratified inverse-CDF tables, float32 numpy, the JAX package's
    ``prep_inv_table_stratified`` (``integrate_pallas.py:367-438``) step
    for step in float32: u-space splits into S equal-mass strata (S the
    largest power of two <= min(m // 128, rows // 8), 32 for a 4096-knot
    table at 256 rows), each resampled at 128 knots ``u = (s + j / 127) /
    S`` of the m-knot uniform-u inverse table.  Returns (ts, dts), both
    (S, 128): the knots and their forward differences (0 in the last
    column); with ``with_pdf`` also ``qs``, this sampler's own density
    ``1 / (S * 127 * dts)`` (0 where dts is 0).  The JAX function tiles
    them to (rows, 128), one row per block row; the port keeps the (S,
    128) tables and finds a row's stratum as ``row // (rows // S)``."""
    t = np.asarray(x_table, np.float32)
    m = t.shape[0]
    if m < 2:
        raise ValueError("inverse-CDF table needs at least 2 knots")
    if segments is None:
        cap = max(1, min(m // LANES, rows // 8))
        segments = 1 << (cap.bit_length() - 1)
    if rows % segments != 0 or (rows // segments) < 8:
        raise ValueError(
            f"segments ({segments}) must divide {rows} block rows in "
            "groups of 8+"
        )
    f32 = np.float32
    j = np.arange(LANES, dtype=f32) / f32(LANES - 1)
    s = np.arange(segments, dtype=f32).reshape(segments, 1)
    u = (s + j) / f32(segments)
    pos = u * f32(m - 1)
    i0 = np.clip(pos.astype(np.int32), 0, m - 2)
    frac = pos - i0.astype(f32)
    t0 = t[i0]
    ts = t0 + frac * (t[i0 + 1] - t0)
    dts = np.concatenate(
        [ts[:, 1:] - ts[:, :-1], np.zeros((segments, 1), f32)], axis=1
    )
    if not with_pdf:
        return ts, dts
    inv_c = f32(1.0 / (segments * (LANES - 1)))
    with np.errstate(divide="ignore"):
        qs = np.where(dts > 0, inv_c / np.maximum(dts, f32(1e-38)), f32(0.0))
    return ts, dts, qs.astype(f32)


def pad_uniform_table(xs, values, fill: float = 0.0):
    """A uniform-grid value table for in-kernel lookup, float32 numpy, as
    the JAX package's ``pad_uniform_table`` (``integrate_pallas.py
    :697-714``) builds it: the values padded to a multiple of 128 with
    ``fill`` (past x_max, which the lookup's inside gate excludes), their
    forward differences (0 last), and ``(x0, step, x_max)`` with ``step =
    (x_max - x0) / (n - 1)`` in float32.  The JAX function reshapes the
    padded tables to (n / 128, 128) VMEM tiles; the port keeps them
    flat."""
    xs = np.asarray(xs, np.float32)
    values = np.asarray(values, np.float32)
    n = values.shape[0]
    x0, x_max = xs[0], xs[n - 1]
    step = (x_max - x0) / np.float32(n - 1)
    pad = (-n) % LANES
    vals = np.concatenate([values, np.full(pad, fill, np.float32)])
    dx = np.concatenate([vals[1:] - vals[:-1], np.zeros(1, np.float32)])
    return vals, dx, (x0, step, x_max)


def uniform_table_value(x: torch.Tensor, vals: torch.Tensor,
                        dx: torch.Tensor, grid, outside: float = 0.0):
    """Interpolated lookup of ``x`` in a :func:`pad_uniform_table` table
    (``uniform_table_value``, ``integrate_pallas.py:717-760``): ``pos =
    (x - x0) / step`` (a true division), ``i0 = clip(int(pos), 0, n - 2)``,
    ``vals[i0] + clip(pos - i0, 0, 1) * dx[i0]``, and ``outside`` off
    [x0, x_max]."""
    x0, step, x_max = (float(g) for g in grid)
    pos = _true_div(x - x0, step)
    i0 = torch.clamp(pos.to(torch.int32), 0, vals.shape[0] - 2).long()
    frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
    val = vals[i0] + frac * dx[i0]
    inside = (x >= x0) & (x <= x_max)
    return torch.where(inside, val, outside)


def knot_interp(u: torch.Tensor, keys: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of ``vals`` over sorted ``keys`` at
    ``u``, by a search over the knots (the reference's device binary
    search, ``src/distribution.rs:128-158``): ``i`` the last knot with
    ``keys[i] <= u``, clamped to [0, m - 2]; ``t = (u - keys[i]) /
    (keys[i + 1] - keys[i])`` (0 over a flat pair), clamped to [0, 1];
    ``vals[i] + t * (vals[i + 1] - vals[i])``; ``vals[m - 1]`` from the
    last key on, as ``np.interp`` (the last keys of a float32 CDF may tie
    at 1).  With ``keys`` the CDF knots and ``vals`` the x knots it is the
    knot-exact inverse CDF, which never lands inside a zero-density
    span."""
    m = keys.shape[0]
    i = torch.searchsorted(keys, u.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, m - 2)
    k0, k1 = keys[i], keys[i + 1]
    v0, v1 = vals[i], vals[i + 1]
    d = k1 - k0
    flat = d > 0
    t = torch.where(flat, (u - k0) / torch.where(flat, d, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return torch.where(u >= keys[m - 1], vals[m - 1], v0 + t * (v1 - v0))


@dataclass(frozen=True)
class StrataTables:
    """The ``"strata"`` route's (STRATA, 128) float32 tables on the
    device: knots ``ts``, slopes ``dts`` and, for a ``"sampler"`` weight,
    the sampler's density ``qs``."""

    ts: torch.Tensor
    dts: torch.Tensor
    qs: Optional[torch.Tensor] = None
    route = "strata"


@dataclass(frozen=True)
class KnotTables:
    """The ``"knots"`` route's float32 tables on the device: the x and
    CDF knots of the knot-exact inverse."""

    x: torch.Tensor
    cdf: torch.Tensor
    route = "knots"


Tables = Union[StrataTables, KnotTables]


def _fields(tables: Tables) -> list:
    """A tables object's tensors (None where absent), in field order."""
    return [getattr(tables, f.name) for f in dataclasses.fields(tables)]


def _custom_draw(tables: Tables, w: torch.Tensor, rows: int):
    """CUSTOM samples at the uniforms ``w`` of (..., rows, 128) positions;
    with a ``qs`` table an (x, q) pair, q the sampler's density at x."""
    if isinstance(tables, KnotTables):
        return knot_interp(w, tables.cdf, tables.x)
    strata = tables.ts.shape[0]
    pos = w * float(LANES - 1)
    j = pos.to(torch.int32)
    frac = pos - j.to(torch.float32)
    stratum = torch.arange(rows, device=w.device) // (rows // strata)
    idx = stratum[:, None] * LANES + j.long()
    x = tables.ts.reshape(-1)[idx] + frac * tables.dts.reshape(-1)[idx]
    if tables.qs is None:
        return x
    return x, tables.qs.reshape(-1)[idx]


def _sha1(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a)).hexdigest()


class _WeightTable:
    """A weight density's two host tables, ``arrays``, with their copies
    per device."""

    def tensors(self, device):
        on = self.__dict__.setdefault("_on", {})
        if device not in on:
            on[device] = tuple(torch.from_numpy(a).to(device)
                               for a in self.arrays)
        return on[device]


class UniformWeightTable(_WeightTable):
    """An importance weight's density as a uniform-grid pdf table (mode
    ``"table"``): :func:`pad_uniform_table` of (x grid, values), looked up
    by :func:`uniform_table_value`, 0 outside the grid.  ``key`` is its
    content hash, as the JAX package's ``mode_key``
    (``api/importance.py:348-361``)."""

    mode = "table"

    def __init__(self, xs, values):
        xs = np.asarray(xs, np.float32)
        values = np.asarray(values, np.float32)
        self.key = ("pdf_table", _sha1(xs), _sha1(values))
        self.vals, self.dx, self.grid = pad_uniform_table(xs, values)
        self.arrays = (self.vals, self.dx)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return uniform_table_value(x, *self.tensors(x.device), self.grid)


class KnotWeightTable(_WeightTable):
    """An importance weight's density on an irregular x grid (mode
    ``"knots"``), where no uniform grid meets the resampling bound: the
    JAX package's closure fallback interpolates it with ``jnp.interp``
    (``api/importance.py:444-467``); the port looks it up in the kernel
    by :func:`knot_interp`, 0 outside the grid."""

    mode = "knots"

    def __init__(self, xs, values):
        self.xs = np.asarray(xs, np.float32)
        self.vals = np.asarray(values, np.float32)
        self.key = ("pdf_knots", _sha1(self.xs), _sha1(self.vals))
        self.grid = (self.xs[0], np.float32(0.0), self.xs[-1])
        self.arrays = (self.xs, self.vals)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xs, vals = self.tensors(x.device)
        inside = (x >= float(self.xs[0])) & (x <= float(self.xs[-1]))
        return torch.where(inside, knot_interp(x, xs, vals), 0.0)


class _SamplerDensity:
    """The ``"sampler"`` weight mode: q is the CUSTOM proposal's own
    sampling density, read with the draw (``qs`` of
    ``prep_inv_table_stratified(with_pdf=True)``)."""

    mode = "sampler"
    key = ("sampler",)

    def __repr__(self):
        return "SAMPLER"


SAMPLER = _SamplerDensity()


def kernel_weight(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's ``is_weight`` (``integrate_pallas.py:1009-1029``):
    ``where(q > 0, p / safe_q, 0)``."""
    ok = q > 0
    return torch.where(ok, p / torch.where(ok, q, 1.0), 0.0)


def _transform(u, kind, p1, p2, grad: bool):
    """The family's samples at ``u``, or with ``grad`` the triple ``(x,
    dx/dp1, dx/dp2)`` (:func:`transform_grad_from_u`), x the same."""
    if grad:
        return transform_grad_from_u(u, kind, p1, p2)
    return transform_from_u(u, kind, p1, p2)


def _normal_pair(z, p1, p2, grad: bool):
    """The antithetic normal pair ``p1 + p2 z``, ``p1 - p2 z``, each with
    its derivatives (1, +-z) under ``grad``."""
    a, b = p1 + p2 * z, p1 - p2 * z
    if not grad:
        return [a, b]
    one = torch.ones_like(a)
    return [(a, one, z), (b, one, -z)]


def sample_block(
    kind: DistKind, p1, p2, rng: CounterRng, shape, counter, tag: int = 0,
    grad: bool = False,
) -> torch.Tensor:
    """One block of samples of the family from the (counter, tag) stream
    (``csrc/counter_rng.cuh`` ``tmc::transform``): the exponential from
    (0, 1] uniforms, the others from [0, 1) ones; with ``grad`` each
    sample's ``(x, dx/dp1, dx/dp2)``."""
    draw = uniform_open01 if kind == DistKind.EXPONENTIAL else uniform_halfopen01
    return _transform(draw(rng, shape, counter, tag), kind, p1, p2, grad)


def sample_subblocks(
    kind: DistKind, p1, p2, rng: CounterRng, counter, rows: int = BLOCK_ROWS,
    tables: Optional[Tables] = None, grad: bool = False,
) -> List[torch.Tensor]:
    """One tile of samples as a list of equal-shape sub-blocks, as the JAX
    kernel's ``_sample_subblocks`` (integrate_pallas.py:550-602) returns
    them: the normal family as two half blocks (tags 0 and 1); CUSTOM
    one block through ``tables`` from tag-0 [0, 1) uniforms, an (x, q)
    pair with a ``qs`` table.  With ``grad`` (analytic families) each
    sub-block is ``(x, dx/dp1, dx/dp2)``."""
    if kind == DistKind.NORMAL:
        half = (rows // 2, LANES)
        return [
            sample_block(kind, p1, p2, rng, half, counter, tag, grad)
            for tag in (0, 1)
        ]
    if kind == DistKind.CUSTOM:
        w = uniform_halfopen01(rng, (rows, LANES), counter, 0)
        return [_custom_draw(tables, w, rows)]
    return [sample_block(kind, p1, p2, rng, (rows, LANES), counter, 0, grad)]


def sample_subblocks_antithetic(
    kind: DistKind, p1, p2, rng: CounterRng, counter, rows: int = BLOCK_ROWS,
    tables: Optional[Tables] = None, grad: bool = False,
) -> List[torch.Tensor]:
    """One antithetic tile in the JAX kernel's sub-block order
    (``_sample_subblocks_antithetic``, integrate_pallas.py:605-676): the
    same uniforms as :func:`sample_subblocks`, each at ``u`` and at
    ``1 - u``, so sub-block ``2i + 1`` mirrors sub-block ``2i`` element
    for element; the normal family ``[+z1, -z1, +z2, -z2]``; CUSTOM
    mirrors ``w`` and ``1 - w`` within each row's stratum.  With ``grad``
    each sub-block is ``(x, dx/dp1, dx/dp2)``."""
    shape = (rows, LANES)
    if kind == DistKind.NORMAL:
        half = (rows // 2, LANES)
        out = []
        for tag in (0, 1):
            z = normal_from_u01(uniform_halfopen01(rng, half, counter, tag))
            out += _normal_pair(z, p1, p2, grad)
        return out
    if kind == DistKind.CUSTOM:
        w = uniform_halfopen01(rng, shape, counter, 0)
        return [_custom_draw(tables, w, rows),
                _custom_draw(tables, 1.0 - w, rows)]
    draw = uniform_open01 if kind == DistKind.EXPONENTIAL else uniform_halfopen01
    u = draw(rng, shape, counter, 0)
    return [_transform(u, kind, p1, p2, grad),
            _transform(1.0 - u, kind, p1, p2, grad)]


def _positions(rows: int, device) -> torch.Tensor:
    """(rows, LANES) positions ``row * 128 + lane`` within a tile."""
    return torch.arange(rows * LANES, dtype=torch.int64, device=device).reshape(
        rows, LANES
    )


def sample_subblocks_qmc(
    kind: DistKind, p1, p2, block_num: torch.Tensor, shift: torch.Tensor,
    rows: int = BLOCK_ROWS, tables: Optional[Tables] = None,
    grad: bool = False,
) -> List[torch.Tensor]:
    """QMC tiles in the JAX kernel's sub-block order
    (``_sample_subblocks_qmc``, integrate_pallas.py:481-547), each
    sub-block ``(len(block_num), ..., 128)``: point ``g = b * 2**15 +
    pos`` of block ``b`` under its rotation ``shift`` (one per block,
    int64 words); the normal family as the block's two contiguous
    halves, the exponential from (0, 1] uniforms, CUSTOM through
    ``tables`` and the extended families through their inverses from
    [0, 1) ones; with ``grad`` each sub-block ``(x, dx/dp1, dx/dp2)``."""
    dev = block_num.device
    base = (block_num.to(torch.int64) * (rows * LANES))[:, None, None]
    shift = shift.to(torch.int64)[:, None, None]
    if kind == DistKind.NORMAL:
        half = rows // 2
        pos = _positions(half, dev)
        return [
            _transform(qmc_u01_halfopen(base + off + pos, shift), kind, p1,
                       p2, grad)
            for off in (0, half * LANES)
        ]
    g = base + _positions(rows, dev)
    if kind == DistKind.CUSTOM:
        return [_custom_draw(tables, qmc_u01_halfopen(g, shift), rows)]
    u01 = qmc_u01_open if kind == DistKind.EXPONENTIAL else qmc_u01_halfopen
    return [_transform(u01(g, shift), kind, p1, p2, grad)]


def tile_subblocks(
    cfg: IntegrateConfig, kind: DistKind, p1, p2, seed: int, grid: Grid,
    tiles: torch.Tensor, tables: Optional[Tables] = None,
) -> List[torch.Tensor]:
    """The given tiles' sub-blocks under ``cfg.method``, each
    ``(len(tiles), ..., 128)`` (an (x, q) pair under a ``"sampler"``
    weight; ``(x, dx/dp1, dx/dp2)`` under ``cfg.grad``)."""
    if cfg.method == "qmc":
        b = tiles
        shift = derive_shift(seed, 1).to(tiles.device)
        seg_bits = qmc_seg_bits(grid)
        if seg_bits is not None:
            shift = derive_segment_shift(shift, b >> seg_bits)
            b = b & ((1 << seg_bits) - 1)
        else:
            shift = shift.expand(b.shape)
        return sample_subblocks_qmc(kind, p1, p2, b, shift, tables=tables,
                                    grad=cfg.grad)
    rng = CounterRng(seed, tiles // grid.loops, device=tiles.device)
    draw = sample_subblocks_antithetic if cfg.antithetic else sample_subblocks
    return draw(kind, p1, p2, rng, tiles % grid.loops, tables=tables,
                grad=cfg.grad)


def pilot_values(
    values: Callable[[torch.Tensor], List[torch.Tensor]], kind: DistKind,
    params: torch.Tensor, tables: Optional[Tables] = None,
) -> torch.Tensor:
    """(K,) float32 pilots, or (R, K) for (R, 2) ``params`` rows (one
    batched pass): each integrand's mean over the 1,024 quantile
    midpoints ``(i + 0.5) / 1024`` of the sampling distribution
    (``_pilot_vals``, integrate_pallas.py:1265-1300): the uniform grid
    unclamped, the exponential's ``max(u, 1e-7)``; an importance set's
    values carry their weights.  A CUSTOM ``"strata"`` pilot is the
    tile's knots (``ts`` at each row's stratum, an equal-mass quantile
    grid, with ``qs`` under a ``"sampler"`` weight), a ``"knots"`` one
    the knot-exact inverse at the midpoints.  The means add in
    :func:`fixed_sum`'s order, so row r of a batch is the pilot of
    ``params[r]`` alone, bit for bit.  Any pilot keeps the error bar
    exact; a near one keeps float32 cancellation small."""
    if params.dim() == 2:
        if kind == DistKind.CUSTOM:
            raise ValueError("CUSTOM tables take one params row")
        _check_args(kind, params[0])
        if params.device.type == "cpu":
            # The plain path: the CPU's elementwise kernels may round a
            # transcendental by a vector lane or a scalar tail, by where
            # an element falls in the tensor.
            return torch.stack([pilot_values(values, kind, row)
                                for row in params.unbind()])
    else:
        _check_args(kind, params, tables=tables)
    dev = params.device
    u = (
        torch.arange(_PILOT_POINTS, dtype=torch.float32, device=dev) + 0.5
    ) / float(_PILOT_POINTS)
    p1, p2 = params[..., 0:1], params[..., 1:2]
    if params.dim() == 1:
        p1, p2 = p1[0], p2[0]
    q = None
    if kind == DistKind.UNIFORM:
        x = p1 + u * (p2 - p1)
    elif kind == DistKind.NORMAL:
        x = p1 + p2 * normal_from_u01(u)
    elif kind == DistKind.EXPONENTIAL:
        x = exponential_from_u01(u) / p1
    elif kind != DistKind.CUSTOM:
        x = transform_from_u(u, kind, p1, p2)
    elif isinstance(tables, KnotTables):
        x = knot_interp(u, tables.cdf, tables.x)
    else:
        rep = BLOCK_ROWS // tables.ts.shape[0]
        x = tables.ts.repeat_interleave(rep, dim=0)
        if tables.qs is not None:
            q = tables.qs.repeat_interleave(rep, dim=0)
    vals = values(x) if q is None else values(x, q)
    lead = params.shape[:-1]  # (R,) for rows, else ()
    vals = torch.stack([torch.broadcast_to(v, x.shape).reshape(*lead, -1)
                        for v in vals], dim=-2)
    return fixed_sum(vals, -1) / float(vals.shape[-1])


def finish_stderr(
    sums: torch.Tensor, sqs: torch.Tensor, pilot: torch.Tensor, grid: Grid,
    antithetic: bool,
):
    """(means, standard errors), float32, from the kernel's sums and
    pilot-shifted squares (``_finish_stderr``, integrate_pallas.py
    :1318-1334; the nd kernel's is the same, integrate_nd_pallas.py
    :877-887).  Antithetic squares are of pair means, so pairs are the
    unit."""
    n = float(np.float32(grid.actual_samples))
    units = grid.actual_samples // 2 if antithetic else grid.actual_samples
    n_units = float(np.float32(units))
    mean = sums / n
    dlt = mean - pilot
    var = torch.clamp(sqs / n_units - dlt * dlt, min=0.0)
    return mean, torch.sqrt(var / n_units)


class _WeightTab(ctypes.Structure):
    """One weight density's table, as ``tmc::WeightTab`` in
    ``csrc/integrate_draw.cuh``."""

    _fields_ = [
        ("keys", ctypes.c_void_p),  # knots: x grid
        ("vals", ctypes.c_void_p),  # table: padded values; knots: pdf
        ("dx", ctypes.c_void_p),    # table: forward differences
        ("x0", ctypes.c_float),
        ("step", ctypes.c_float),
        ("x_max", ctypes.c_float),
        ("n", ctypes.c_int),        # table: padded length; knots: m
    ]


class _KernelTables(ctypes.Structure):
    """The kernel's table arguments, as ``tmc::Tables`` in
    ``csrc/integrate_draw.cuh``: passed by host pointer, copied into the
    launch by value."""

    _fields_ = [
        ("ts", ctypes.c_void_p),    # strata: (STRATA, 128) knots
        ("dts", ctypes.c_void_p),   # strata: slopes
        ("qs", ctypes.c_void_p),    # strata: sampler density, or null
        ("xk", ctypes.c_void_p),    # knots: x knots
        ("ck", ctypes.c_void_p),    # knots: CDF knots
        ("m", ctypes.c_int),        # knots: knot count
        ("p", _WeightTab),
        ("q", _WeightTab),
    ]


def _weight_tab(mode, device) -> _WeightTab:
    tab = _WeightTab()
    if not isinstance(mode, _WeightTable):
        return tab
    a, b = mode.tensors(device)
    tab.x0, tab.step, tab.x_max = (float(g) for g in mode.grid)
    if isinstance(mode, UniformWeightTable):
        tab.vals, tab.dx, tab.n = a.data_ptr(), b.data_ptr(), a.shape[0]
    else:
        tab.keys, tab.vals, tab.n = a.data_ptr(), b.data_ptr(), a.shape[0]
    return tab


class IntegrateProgram:
    """One fused integrand set, lowered both ways: ``torch_values`` (the
    set's values at a block) for the plain version, and one CUDA library
    per :class:`IntegrateConfig`, built at first use.

    ``weight=(p, q)`` makes it an importance-sampling set: each density
    is a traced function, a :class:`UniformWeightTable`, a
    :class:`KnotWeightTable` or (q only) :data:`SAMPLER`, and each
    integrand is weighted as the JAX kernel's ``is_weight``: ``f(x) *
    kernel_weight(p, q)`` (``ops/lower.py``); ``torch_values`` then takes
    the draw's sampler density as a second argument under
    :data:`SAMPLER`."""

    def __init__(self, fns: Sequence[TracedFunction], weight=None):
        if not 1 <= len(fns) <= MAX_FUNCTIONS:
            raise ValueError(
                f"the kernel fuses 1 to {MAX_FUNCTIONS} functions, "
                f"got {len(fns)}"
            )
        self.fns = tuple(fns)
        self.weight = None if weight is None else tuple(weight)
        if self.weight is not None:
            p, q = self.weight
            tables = (TracedFunction, UniformWeightTable, KnotWeightTable)
            if not isinstance(p, tables) or not (
                    isinstance(q, tables) or q is SAMPLER):
                raise ValueError(f"unknown importance weight modes {weight}")
            self.torch_values = self._weighted_values()
        else:
            self.torch_values = to_torch_set(self.fns)
        self._libs = {}
        self._grads = None

    @property
    def torch_grads(self) -> List[Callable]:
        """Each function's value and derivative at a block of samples,
        ``(value, [d/dx])`` (``lower.to_torch_grad``), for the gradient
        build's plain version; made at first use."""
        if self._grads is None:
            self._grads = [to_torch_grad(f) for f in self.fns]
        return self._grads

    @property
    def sampler(self) -> bool:
        """Whether q is the CUSTOM proposal's own sampling density."""
        return self.weight is not None and self.weight[1] is SAMPLER

    def _weighted_values(self):
        raw = to_torch_set(self.fns)
        p_mode, q_mode = self.weight
        p_of = to_torch(p_mode) if isinstance(p_mode, TracedFunction) else p_mode
        q_of = (None if q_mode is SAMPLER else
                to_torch(q_mode) if isinstance(q_mode, TracedFunction)
                else q_mode)

        def values(x: torch.Tensor, q: Optional[torch.Tensor] = None):
            if (q is None) == (q_of is None):
                raise ValueError(
                    "the draw's sampler density is passed exactly when q "
                    "is the sampler's")
            w = kernel_weight(p_of(x).to(torch.float32),
                              (q if q_of is None else q_of(x)).to(torch.float32))
            return [v * w for v in raw(x)]

        return values

    def _lowered_weight(self):
        if self.weight is None:
            return None
        return tuple(w if isinstance(w, TracedFunction) else w.mode
                     for w in self.weight)

    def library(self, cfg: IntegrateConfig = MC, route=None):
        """The library of ``cfg`` drawing on the CUSTOM ``route`` (the
        tables' ``route``), on one extended family (``route`` its
        DistKind, see :func:`library_route`), or on the uniform, normal
        and exponential families (None)."""
        if (cfg, route) not in self._libs:
            from .build import load_kernel_library

            if cfg.grad and (self.weight is not None
                             or isinstance(route, str)):
                raise ValueError("the gradient build takes analytic "
                                 "families and unweighted sets only")
            if route is None:
                draws = ""
            elif isinstance(route, str):
                draws = f"#define TMC_CUSTOM {_CUSTOM_CODES[route]}\n"
            elif DistKind(route) in ANALYTIC_EXT:
                draws = f"#define TMC_FAMILY {int(route)}\n"
            else:
                raise ValueError(f"{route!r} is not a CUSTOM route or an "
                                 "extended family")
            lib = load_kernel_library(
                "integrate.cu",
                cuda_source(self.fns, weight=self._lowered_weight(),
                            grad=cfg.grad)
                + cfg.defines + draws,
            )
            lib.tmc_integrate.argtypes = [
                ctypes.c_int,       # kind
                ctypes.c_uint32,    # seed word (without a seed vector)
                ctypes.c_void_p,    # seed words (R,) on the device, or null
                ctypes.c_int,       # reps R
                ctypes.c_void_p,    # params (2,) or (R, 2) float32
                ctypes.c_int,       # params stride: 0 shared, 2 a row each
                ctypes.c_void_p,    # pilots (K,) or (R, K) float32, or null
                ctypes.c_int,       # pilots stride: 0 shared, K a row each
                ctypes.c_int,       # loops per program
                ctypes.c_longlong,  # tiles = programs * loops
                ctypes.c_int,       # QMC segment bits, or -1
                ctypes.c_int,       # CUDA grid size
                ctypes.c_void_p,    # partials (R, grid, K, 2K or 3K) float32
                ctypes.c_void_p,    # sums (R, K, 2K or 3K) float32
                ctypes.c_void_p,    # host tmc::Tables, or null
                ctypes.c_void_p,    # cudaStream_t
            ]
            lib.tmc_integrate.restype = ctypes.c_int
            self._libs[cfg, route] = lib
        return self._libs[cfg, route]

    def kernel_tables(self, tables: Optional[Tables], device):
        """The launch's ``tmc::Tables``: the sampling tables' and weight
        tables' device pointers (``None`` when there are none)."""
        if tables is None and self.weight is None:
            return None
        kt = _KernelTables()
        if isinstance(tables, StrataTables):
            kt.ts, kt.dts = tables.ts.data_ptr(), tables.dts.data_ptr()
            kt.qs = 0 if tables.qs is None else tables.qs.data_ptr()
        elif isinstance(tables, KnotTables):
            kt.xk, kt.ck = tables.x.data_ptr(), tables.cdf.data_ptr()
            kt.m = tables.x.shape[0]
        if self.weight is not None:
            kt.p = _weight_tab(self.weight[0], device)
            kt.q = _weight_tab(self.weight[1], device)
        return kt


def library_route(kind, tables: Optional[Tables] = None):
    """The ``route`` of :meth:`IntegrateProgram.library` that draws
    ``kind``: the CUSTOM tables' route, the extended family itself, or
    None for the uniform, normal and exponential families."""
    kind = DistKind(kind)
    if kind == DistKind.CUSTOM:
        return tables.route
    return kind if kind in ANALYTIC_EXT else None


def _check_args(kind, params: torch.Tensor, tables: Optional[Tables] = None,
                program: Optional[IntegrateProgram] = None) -> None:
    DistKind(kind)
    if params.dtype != torch.float32 or params.shape != (2,):
        raise ValueError(
            f"params must be a (2,) float32 tensor, got {tuple(params.shape)} "
            f"{params.dtype}"
        )
    if (kind == DistKind.CUSTOM) != (tables is not None):
        raise ValueError("CUSTOM runs, and only they, take sampling tables")
    sampler = isinstance(tables, StrataTables) and tables.qs is not None
    if program is not None and program.sampler != sampler:
        raise ValueError(
            "a sampler-mode weight needs strata tables with qs, and qs "
            "only a sampler-mode weight")
    if tables is None:
        return
    for t in _fields(tables):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != params.device:
            raise ValueError("tables must be float32 on the params' device")
    if isinstance(tables, StrataTables):
        shapes = {t.shape for t in _fields(tables) if t is not None}
        if len(shapes) != 1 or next(iter(shapes))[1] != LANES:
            raise ValueError("strata tables must be (S, 128), all one shape")
    elif tables.x.shape != tables.cdf.shape or tables.x.dim() != 1 or (
            tables.x.shape[0] < 2):
        raise ValueError("knot tables must be two 1-D tables of >= 2 knots")


def _check_pilot(cfg: IntegrateConfig, params: torch.Tensor, pilot, k: int):
    if not cfg.with_stderr:
        if pilot is not None:
            raise ValueError("a pilot is only for error bars")
        return
    if pilot is None or pilot.shape != (k,) or pilot.dtype != torch.float32:
        raise ValueError(f"error bars need a ({k},) float32 pilot")
    if pilot.device != params.device:
        raise ValueError("pilot and params must be on one device")


def integrate_reference(
    values: Callable[[torch.Tensor], List[torch.Tensor]],
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """Plain PyTorch version, on ``params``' device: (K,) float32 sums
    over the grid's samples, or with ``cfg.with_stderr`` a (2, K) stack of
    the sums and the squares of (value - pilot), of pair means under
    ``antithetic``.  ``values`` is a set's values callable
    (``IntegrateProgram.torch_values``); a CUSTOM run draws through
    ``tables`` on their route.  Same draws, transforms and
    per-tile order as the kernel; tiles go ``_TILES_PER_CHUNK`` at a time,
    so a large plan never holds all its samples."""
    _check_args(kind, params, tables)
    dev = params.device
    p1, p2 = params[0], params[1]
    sums, sqs = 0.0, 0.0
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        subs = [values(*x) if isinstance(x, tuple) else values(x) for x in
                tile_subblocks(cfg, kind, p1, p2, seed, grid, tiles, tables)]
        k = len(subs[0])
        if t0 == 0:
            _check_pilot(cfg, params, pilot, k)
        tile_sums = [sum(v[j].sum(dim=(1, 2)) for v in subs) for j in range(k)]
        sums = sums + torch.stack(tile_sums, dim=1).sum(dim=0)
        if not cfg.with_stderr:
            continue
        if cfg.antithetic:
            # Sub-blocks 2i and 2i + 1 are mirrors: pairs are the unit.
            dev_of = [
                [0.5 * (a[j] + b[j]) - pilot[j] for j in range(k)]
                for a, b in zip(subs[0::2], subs[1::2])
            ]
        else:
            dev_of = [[v[j] - pilot[j] for j in range(k)] for v in subs]
        tile_sqs = [sum((d[j] * d[j]).sum(dim=(1, 2)) for d in dev_of)
                    for j in range(k)]
        sqs = sqs + torch.stack(tile_sqs, dim=1).sum(dim=0)
    return torch.stack([sums, sqs]) if cfg.with_stderr else sums


def _check_grad(program: IntegrateProgram, kind, params: torch.Tensor,
                cfg: IntegrateConfig) -> None:
    if not cfg.grad:
        raise ValueError("a gradient run takes a gradient configuration")
    if program.weight is not None or DistKind(kind) == DistKind.CUSTOM:
        raise ValueError("the gradient build takes analytic families and "
                         "unweighted sets only")
    _check_args(kind, params)


def integrate_grad_reference(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the gradient build, on ``params``' device:
    ``(sums, grads)``, the (K,) float32 sums of the values
    (:func:`integrate_reference`'s, bit for bit: the same draws and
    operations in the same order) and the (K, 2) sums of the pathwise
    terms ``f_k'(x) * dx/dp`` of the family's two parameters, over the
    grid's samples under ``cfg.method``."""
    _check_grad(program, kind, params, cfg)
    dev = params.device
    p1, p2 = params[0], params[1]
    k = len(program.fns)
    sums, grads = 0.0, 0.0
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        subs = tile_subblocks(cfg, kind, p1, p2, seed, grid, tiles)
        outs = [[vg(x) for vg in program.torch_grads] for x, _, _ in subs]
        tile_sums = [sum(o[j][0].sum(dim=(1, 2)) for o in outs)
                     for j in range(k)]
        sums = sums + torch.stack(tile_sums, dim=1).sum(dim=0)
        tile_grads = [
            torch.stack([sum((o[j][1][0] * sub[c]).sum(dim=(1, 2))
                             for o, sub in zip(outs, subs))
                         for c in (1, 2)], dim=1)
            for j in range(k)]
        grads = grads + torch.stack(tile_grads, dim=1).sum(dim=0)
    return sums, grads


def integrate_grad_cuda(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient build's ``(sums, grads)``, as
    :func:`integrate_grad_reference` returns them, on ``params``' device:
    a CUDA ``params`` launches the kernel's gradient build (counted in
    ``integrate_cuda.launches`` and ``integrate_cuda.grad_launches``), a
    CPU one runs the plain version.  Its value sums are the value
    build's, bit for bit."""
    _check_grad(program, kind, params, cfg)
    if params.device.type == "cpu":
        return integrate_grad_reference(program, kind, params, seed, grid, cfg)
    k = len(program.fns)
    out = _launch(program, kind, params, int(seed), None, grid, cfg, None,
                  None)[1][0]
    return out[:k], out[k:].reshape(k, 2)


def integrate_cuda(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """The program's sums over the grid's samples, as
    :func:`integrate_reference` returns them, on ``params``' device.

    A CUDA ``params`` launches the kernel (``integrate_cuda.launches``
    counts the launches); a CPU ``params`` runs the plain version.  Any
    other device raises.  The launch is asynchronous on the current
    stream."""
    _check_args(kind, params, tables, program)
    _check_pilot(cfg, params, pilot, len(program.fns))
    if params.device.type == "cpu":
        return integrate_reference(
            program.torch_values, kind, params, seed, grid, cfg, pilot, tables
        )
    out = _launch(program, kind, params, int(seed), None, grid, cfg, pilot,
                  tables)[1][0]
    return out.reshape(2, -1) if cfg.with_stderr else out


def integrate_rows(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """Launches the kernel on CUDA ``params`` and returns its per-block
    rows, (blocks, K) float32 sums or with ``cfg.with_stderr`` (blocks,
    2K) sums then squares, or under ``cfg.grad`` (blocks, 3K) sums then
    the (k, parameter) pathwise sums, unsummed (the launch's second pass
    sums them for ``integrate_cuda``).
    Counts the launch in ``integrate_cuda.launches``."""
    _check_args(kind, params, tables, program)
    _check_pilot(cfg, params, pilot, len(program.fns))
    return _launch(program, kind, params, int(seed), None, grid, cfg, pilot,
                   tables)[0][0]


def check_batch(params: torch.Tensor, seeds: torch.Tensor, pilot,
                row_shape: Tuple[int, ...], k: int,
                with_stderr: bool) -> Tuple[int, bool]:
    """``(R, whether each rep has its params row)`` of a batch after its
    checks: ``seeds`` (R,) int32 words on the params' device; ``params``
    one row of ``row_shape`` for every rep or R of them; ``pilot`` (K,)
    or, beside rows, (R, K)."""
    if (seeds.dim() != 1 or seeds.dtype != torch.int32
            or seeds.device != params.device or not 1 <= len(seeds) <= 65535):
        raise ValueError("seeds must be a (R,) int32 tensor of 1 to 65,535 "
                         "words on the params' device")
    r = len(seeds)
    rowed = params.dim() == len(row_shape) + 1
    if tuple(params.shape) not in (tuple(row_shape), (r, *row_shape)):
        raise ValueError(f"params must be one {tuple(row_shape)} row or R = "
                         f"{r} of them, got {tuple(params.shape)}")
    if with_stderr:
        want = (r, k) if rowed else (k,)
        if pilot is None or tuple(pilot.shape) != want:
            raise ValueError(f"error bars need a {want} pilot")
    return r, rowed


def integrate_batch_rows(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """One launch of R jobs on CUDA ``params``: rep r under the seed word
    ``seeds[r]`` ((R,) int32 words on the device) with ``params`` (2,) for
    every rep or its row of (R, 2), and under error bars its pilot
    ((K,), or (R, K) beside rows).  Returns (R, blocks, K or 2K) rows;
    each rep's are the rows of the unbatched launch with its seed and
    row, bit for bit.  Counts the launch in ``integrate_cuda.launches``
    and ``integrate_cuda.batch_launches``."""
    return _batch_launch(program, kind, params, seeds, grid, cfg, pilot,
                         tables)[0]


def _batch_launch(program, kind, params, seeds, grid, cfg, pilot, tables):
    """:func:`_launch` of a batch after its checks."""
    k = len(program.fns)
    check_batch(params, seeds, pilot, (2,), k, cfg.with_stderr)
    row0 = params[0] if params.dim() == 2 else params
    _check_args(kind, row0, tables, program)
    _check_pilot(cfg, row0,
                 pilot[0] if pilot is not None and pilot.dim() == 2 else pilot,
                 k)
    return _launch(program, kind, params, 0, seeds, grid, cfg, pilot, tables)


def integrate_batch(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
    tables: Optional[Tables] = None,
) -> torch.Tensor:
    """R jobs' sums, (R, K), or with ``cfg.with_stderr`` (R, 2, K): element
    r is :func:`integrate_cuda`'s result with the seed word ``seeds[r]``
    and rep r's params and pilot (arguments as
    :func:`integrate_batch_rows`), bit for bit.  A CUDA ``params`` runs
    one launch, whose second pass sums each rep's rows in the one order
    ``integrate_cuda``'s launch sums its own (``csrc/rows_sum.cuh``); a
    CPU one runs the plain version rep by rep."""
    k = len(program.fns)
    r, rowed = check_batch(params, seeds, pilot, (2,), k, cfg.with_stderr)
    if params.device.type == "cpu":
        words = [int(w) & MASK32 for w in seeds.tolist()]
        outs = [
            integrate_cuda(program, kind, params[i] if rowed else params,
                           words[i], grid, cfg,
                           pilot[i] if rowed and pilot is not None else pilot,
                           tables)
            for i in range(r)
        ]
        return torch.stack(outs)
    sums = _batch_launch(program, kind, params, seeds, grid, cfg, pilot,
                         tables)[1]
    return sums.reshape(r, 2, k) if cfg.with_stderr else sums


def _launch(program, kind, params, seed, seeds, grid, cfg, pilot, tables):
    """One launch of the kernel and its second pass: R = len(seeds) reps,
    or one rep under the seed word ``seed`` where ``seeds`` is None.
    Returns the (R, blocks, n_out K) rows and their (R, n_out K) sums over
    the blocks, in ``csrc/rows_sum.cuh``'s order."""
    k = len(program.fns)
    if params.device.type != "cuda":
        raise ValueError(f"no integrate kernel for device {params.device}")
    if isinstance(tables, StrataTables) and tables.ts.shape[0] != STRATA:
        raise ValueError(f"the kernel takes {STRATA} strata")
    seg_bits = -1
    if cfg.method == "qmc":
        seg = qmc_seg_bits(grid)
        seg_bits = -1 if seg is None else seg
    params = params.contiguous()
    dev = params.device
    reps = 1 if seeds is None else len(seeds)
    pilots = pilot.contiguous().data_ptr() if cfg.with_stderr else 0
    if tables is not None:
        tables = type(tables)(*(None if t is None else t.contiguous()
                                for t in _fields(tables)))
    kt = program.kernel_tables(tables, dev)
    lib = program.library(cfg, library_route(kind, tables))
    rows = min(grid.n_tiles, MAX_CUDA_BLOCKS)
    n_out = cfg.n_out * k
    partials = torch.empty((reps, rows, n_out), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((reps, n_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tmc_integrate(
            int(kind), int(seed) & MASK32,
            None if seeds is None else seeds.contiguous().data_ptr(), reps,
            params.data_ptr(), 2 if params.dim() == 2 else 0, pilots,
            k if cfg.with_stderr and pilot.dim() == 2 else 0,
            grid.loops, grid.n_tiles, seg_bits, rows,
            partials.data_ptr(), sums.data_ptr(),
            None if kt is None else ctypes.addressof(kt), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"integrate kernel launch failed: {lib.tmc_error_string(err)!r}"
        )
    integrate_cuda.launches += 1
    integrate_cuda.batch_launches += int(seeds is not None)
    integrate_cuda.grad_launches += int(cfg.grad)
    return partials, sums


integrate_cuda.launches = 0
integrate_cuda.batch_launches = 0
integrate_cuda.grad_launches = 0
