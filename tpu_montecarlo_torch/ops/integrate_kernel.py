"""Fused 1-D Monte Carlo integrate: grid plan, counter RNG and radical
inverse, the error-bar pilot, the plain PyTorch version and the CUDA
kernel's wrapper.

Port of ``tpu_montecarlo/ops/integrate_pallas.py`` (kernel 1) in its
``mc``, ``antithetic`` and ``qmc`` modes, with and without error bars,
for the uniform, normal and exponential families, and over an
importance-sampling set (``IntegrateProgram(fns, weight=(p, q))``: each
integrand weighted by two traced densities, ``ops/lower.py``).  The TPU
kernel draws from the TPU's hardware PRNG; off the TPU it runs with
``CounterRng``, a pure integer hash.  The port implements that
``CounterRng`` bit for bit, so for the same (seed, plan) the plain
version and the kernel here draw exactly the samples the JAX kernel
draws in interpret mode at 256-row blocks.

Sample layout: the plan becomes ``programs x loops`` tiles of
``BLOCK_ROWS x LANES`` positions.  Under ``mc`` tile (pid, blk) seeds the
RNG with (seed, pid) and draws with block counter ``blk``; the normal
family draws two half blocks with tags 0 and 1, the others one block with
tag 0.  ``antithetic`` draws the same uniforms and maps each at ``u`` and
at its mirror ``1 - u`` (the normal pair reflects z about the mean), so a
tile holds twice its positions in samples.  Under ``qmc`` position ``pos``
of tile ``t`` is point ``g = t * 2**15 + pos`` of the radical inverse,
rotated by ``derive_shift(seed, 1)`` (the normal family's two half
blocks are the tile's two contiguous halves of ``g``); past 2**32 points
the tile index splits into a segment (``t >> 17``), which re-mixes the
rotation, and a block within it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..sampling import (
    PORTED_KINDS,
    DistKind,
    exponential_from_u01,
    next_below_f32,
    normal_from_u01,
)
from ..tracing import TracedFunction
from ..utils.roadmap import VARIANTS, not_ported
from .lower import cuda_source, to_torch_set
from .qmc import (
    MASK32,
    QMC_MAX_SAMPLES,
    derive_segment_shift,
    derive_shift,
    pcg_mix,
    qmc_u01_halfopen,
    qmc_u01_open,
)

__all__ = [
    "BLOCK_ROWS",
    "CounterRng",
    "Grid",
    "IntegrateConfig",
    "IntegrateProgram",
    "LANES",
    "MAX_CUDA_BLOCKS",
    "finish_stderr",
    "integrate_cuda",
    "integrate_reference",
    "integrate_rows",
    "pilot_values",
    "plan_grid",
    "qmc_seg_bits",
    "sample_block",
    "sample_subblocks",
    "sample_subblocks_antithetic",
    "sample_subblocks_qmc",
    "uniform_halfopen01",
    "uniform_open01",
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
    sums pilot-shifted squares (``mc`` and ``antithetic`` only: ``qmc``
    error bars come from rotations).  Each configuration is a library of
    its own (``IntegrateProgram.library``)."""

    method: str = "mc"
    with_stderr: bool = False

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(
                "method must be 'mc', 'qmc' or 'antithetic', got "
                f"{self.method!r}"
            )
        if self.method == "qmc" and self.with_stderr:
            raise ValueError(
                "qmc error bars come from rotations (qmc_rotations), not "
                "from in-kernel squares"
            )

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
        return "".join(line + "\n" for line in lines)


_METHOD_CODES = {"mc": 0, "antithetic": 1, "qmc": 2}
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


def _clamp_below(x: torch.Tensor, hi) -> torch.Tensor:
    """The uniform transform's clamp below its open bound ``hi``."""
    return torch.where(x >= hi, next_below_f32(torch.as_tensor(hi)), x)


def sample_block(
    kind: DistKind, p1, p2, rng: CounterRng, shape, counter, tag: int = 0
) -> torch.Tensor:
    """One block of samples of the family from the (counter, tag) stream
    (``csrc/counter_rng.cuh`` ``tmc::transform``): uniform and normal from
    [0, 1) uniforms, exponential from (0, 1] ones."""
    if kind == DistKind.UNIFORM:
        u = uniform_halfopen01(rng, shape, counter, tag)
        # f32 rounding may land on the open bound: clamp below it.
        return _clamp_below(p1 + u * (p2 - p1), p2)
    if kind == DistKind.NORMAL:
        u = uniform_halfopen01(rng, shape, counter, tag)
        return p1 + p2 * normal_from_u01(u)
    if kind == DistKind.EXPONENTIAL:
        u = uniform_open01(rng, shape, counter, tag)
        return exponential_from_u01(u) / p1
    raise not_ported(f"sampling {DistKind(kind).name} in the kernel", VARIANTS)


def sample_subblocks(
    kind: DistKind, p1, p2, rng: CounterRng, counter, rows: int = BLOCK_ROWS
) -> List[torch.Tensor]:
    """One tile of samples as a list of equal-shape sub-blocks, as the JAX
    kernel's ``_sample_subblocks`` (integrate_pallas.py:550-602) returns
    them: the normal family as two half blocks (tags 0 and 1)."""
    if kind == DistKind.NORMAL:
        half = (rows // 2, LANES)
        return [
            sample_block(kind, p1, p2, rng, half, counter, tag)
            for tag in (0, 1)
        ]
    return [sample_block(kind, p1, p2, rng, (rows, LANES), counter)]


def sample_subblocks_antithetic(
    kind: DistKind, p1, p2, rng: CounterRng, counter, rows: int = BLOCK_ROWS
) -> List[torch.Tensor]:
    """One antithetic tile in the JAX kernel's sub-block order
    (``_sample_subblocks_antithetic``, integrate_pallas.py:605-676): the
    same uniforms as :func:`sample_subblocks`, each at ``u`` and at
    ``1 - u``, so sub-block ``2i + 1`` mirrors sub-block ``2i`` element
    for element; the normal family ``[+z1, -z1, +z2, -z2]``."""
    shape = (rows, LANES)
    if kind == DistKind.UNIFORM:
        u = uniform_halfopen01(rng, shape, counter, 0)
        return [
            _clamp_below(p1 + u * (p2 - p1), p2),
            _clamp_below(p1 + (1.0 - u) * (p2 - p1), p2),
        ]
    if kind == DistKind.NORMAL:
        half = (rows // 2, LANES)
        out = []
        for tag in (0, 1):
            z = normal_from_u01(uniform_halfopen01(rng, half, counter, tag))
            out += [p1 + p2 * z, p1 - p2 * z]
        return out
    if kind == DistKind.EXPONENTIAL:
        u = uniform_open01(rng, shape, counter, 0)
        return [
            exponential_from_u01(u) / p1,
            exponential_from_u01(1.0 - u) / p1,
        ]
    raise not_ported(f"sampling {DistKind(kind).name} in the kernel", VARIANTS)


def _positions(rows: int, device) -> torch.Tensor:
    """(rows, LANES) positions ``row * 128 + lane`` within a tile."""
    return torch.arange(rows * LANES, dtype=torch.int64, device=device).reshape(
        rows, LANES
    )


def sample_subblocks_qmc(
    kind: DistKind, p1, p2, block_num: torch.Tensor, shift: torch.Tensor,
    rows: int = BLOCK_ROWS,
) -> List[torch.Tensor]:
    """QMC tiles in the JAX kernel's sub-block order
    (``_sample_subblocks_qmc``, integrate_pallas.py:481-547), each
    sub-block ``(len(block_num), ..., 128)``: point ``g = b * 2**15 +
    pos`` of block ``b`` under its rotation ``shift`` (one per block,
    int64 words); the normal family as the block's two contiguous
    halves, the exponential from (0, 1] uniforms."""
    dev = block_num.device
    base = (block_num.to(torch.int64) * (rows * LANES))[:, None, None]
    shift = shift.to(torch.int64)[:, None, None]
    if kind == DistKind.NORMAL:
        half = rows // 2
        pos = _positions(half, dev)
        return [
            p1 + p2 * normal_from_u01(qmc_u01_halfopen(base + off + pos, shift))
            for off in (0, half * LANES)
        ]
    g = base + _positions(rows, dev)
    if kind == DistKind.UNIFORM:
        u = qmc_u01_halfopen(g, shift)
        return [_clamp_below(p1 + u * (p2 - p1), p2)]
    if kind == DistKind.EXPONENTIAL:
        return [exponential_from_u01(qmc_u01_open(g, shift)) / p1]
    raise not_ported(f"sampling {DistKind(kind).name} in the kernel", VARIANTS)


def tile_subblocks(
    cfg: IntegrateConfig, kind: DistKind, p1, p2, seed: int, grid: Grid,
    tiles: torch.Tensor,
) -> List[torch.Tensor]:
    """The given tiles' sub-blocks under ``cfg.method``, each
    ``(len(tiles), ..., 128)``."""
    if cfg.method == "qmc":
        b = tiles
        shift = derive_shift(seed, 1).to(tiles.device)
        seg_bits = qmc_seg_bits(grid)
        if seg_bits is not None:
            shift = derive_segment_shift(shift, b >> seg_bits)
            b = b & ((1 << seg_bits) - 1)
        else:
            shift = shift.expand(b.shape)
        return sample_subblocks_qmc(kind, p1, p2, b, shift)
    rng = CounterRng(seed, tiles // grid.loops, device=tiles.device)
    draw = sample_subblocks_antithetic if cfg.antithetic else sample_subblocks
    return draw(kind, p1, p2, rng, tiles % grid.loops)


def pilot_values(
    values: Callable[[torch.Tensor], List[torch.Tensor]], kind: DistKind,
    params: torch.Tensor,
) -> torch.Tensor:
    """(K,) float32 pilots: each integrand's mean over the 1,024 quantile
    midpoints ``(i + 0.5) / 1024`` of the sampling distribution
    (``_pilot_vals``, integrate_pallas.py:1265-1300): the uniform grid
    unclamped, the exponential's ``max(u, 1e-7)``; an importance set's
    values carry their weights.  Any pilot keeps the error bar exact; a
    near one keeps float32 cancellation small."""
    _check_args(kind, params)
    dev = params.device
    u = (
        torch.arange(_PILOT_POINTS, dtype=torch.float32, device=dev) + 0.5
    ) / float(_PILOT_POINTS)
    p1, p2 = params[0], params[1]
    if kind == DistKind.UNIFORM:
        x = p1 + u * (p2 - p1)
    elif kind == DistKind.NORMAL:
        x = p1 + p2 * normal_from_u01(u)
    else:
        x = exponential_from_u01(u) / p1
    return torch.stack([v.mean() for v in values(x)])


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


class IntegrateProgram:
    """One fused integrand set, lowered both ways: ``torch_values`` (the
    set's values at a block) for the plain version, and one CUDA library per :class:`IntegrateConfig`, built at
    first use.  ``weight=(p, q)``, two traced densities, makes it an
    importance-sampling set: each integrand weighted by ``p(x) / q(x)``
    (``ops/lower.py``)."""

    def __init__(self, fns: Sequence[TracedFunction], weight=None):
        if not 1 <= len(fns) <= MAX_FUNCTIONS:
            raise ValueError(
                f"the kernel fuses 1 to {MAX_FUNCTIONS} functions, "
                f"got {len(fns)}"
            )
        self.fns = tuple(fns)
        self.weight = None if weight is None else tuple(weight)
        self.torch_values = to_torch_set(self.fns, self.weight)
        self._libs = {}

    def library(self, cfg: IntegrateConfig = MC):
        if cfg not in self._libs:
            from .build import load_kernel_library

            lib = load_kernel_library(
                "integrate.cu",
                cuda_source(self.fns, weight=self.weight) + cfg.defines,
            )
            lib.tmc_integrate.argtypes = [
                ctypes.c_int,       # kind
                ctypes.c_uint32,    # seed word
                ctypes.c_void_p,    # params (2,) float32 on the device
                ctypes.c_void_p,    # pilots (K,) float32, or null
                ctypes.c_int,       # loops per program
                ctypes.c_longlong,  # tiles = programs * loops
                ctypes.c_int,       # QMC segment bits, or -1
                ctypes.c_int,       # CUDA grid size
                ctypes.c_void_p,    # partials (grid, K or 2K) float32
                ctypes.c_void_p,    # cudaStream_t
            ]
            lib.tmc_integrate.restype = ctypes.c_int
            self._libs[cfg] = lib
        return self._libs[cfg]


def _check_args(kind, params: torch.Tensor) -> None:
    if kind not in PORTED_KINDS:
        raise not_ported(f"integrating under {DistKind(kind).name}", VARIANTS)
    if params.dtype != torch.float32 or params.shape != (2,):
        raise ValueError(
            f"params must be a (2,) float32 tensor, got {tuple(params.shape)} "
            f"{params.dtype}"
        )


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
) -> torch.Tensor:
    """Plain PyTorch version, on ``params``' device: (K,) float32 sums
    over the grid's samples, or with ``cfg.with_stderr`` a (2, K) stack of
    the sums and the squares of (value - pilot), of pair means under
    ``antithetic``.  ``values`` is a set's values callable
    (``IntegrateProgram.torch_values``).  Same draws, transforms and per-tile order as the kernel;
    tiles go ``_TILES_PER_CHUNK`` at a time, so a large plan never holds
    all its samples."""
    _check_args(kind, params)
    dev = params.device
    p1, p2 = params[0], params[1]
    sums, sqs = 0.0, 0.0
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        subs = [values(x) for x in
                tile_subblocks(cfg, kind, p1, p2, seed, grid, tiles)]
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


def integrate_cuda(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The program's sums over the grid's samples, as
    :func:`integrate_reference` returns them, on ``params``' device.

    A CUDA ``params`` launches the kernel (``integrate_cuda.launches``
    counts the launches); a CPU ``params`` runs the plain version.  Any
    other device raises.  The launch is asynchronous on the current
    stream."""
    _check_args(kind, params)
    _check_pilot(cfg, params, pilot, len(program.fns))
    if params.device.type == "cpu":
        return integrate_reference(
            program.torch_values, kind, params, seed, grid, cfg, pilot
        )
    out = integrate_rows(program, kind, params, seed, grid, cfg, pilot).sum(dim=0)
    return out.reshape(2, -1) if cfg.with_stderr else out


def integrate_rows(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    cfg: IntegrateConfig = MC,
    pilot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launches the kernel on CUDA ``params`` and returns its per-block
    rows, (blocks, K) float32 sums or with ``cfg.with_stderr`` (blocks,
    2K) sums then squares, unsummed (``integrate_cuda`` sums them).
    Counts the launch in ``integrate_cuda.launches``."""
    _check_args(kind, params)
    k = len(program.fns)
    _check_pilot(cfg, params, pilot, k)
    if params.device.type != "cuda":
        raise ValueError(f"no integrate kernel for device {params.device}")
    seg_bits = -1
    if cfg.method == "qmc":
        seg = qmc_seg_bits(grid)
        seg_bits = -1 if seg is None else seg
    params = params.contiguous()
    dev = params.device
    pilots = pilot.contiguous().data_ptr() if cfg.with_stderr else 0
    lib = program.library(cfg)
    rows = min(grid.n_tiles, MAX_CUDA_BLOCKS)
    n_out = 2 * k if cfg.with_stderr else k
    partials = torch.empty((rows, n_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tmc_integrate(
            int(kind), int(seed) & MASK32, params.data_ptr(), pilots,
            grid.loops, grid.n_tiles, seg_bits, rows, partials.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"integrate kernel launch failed: {lib.tmc_error_string(err)!r}"
        )
    integrate_cuda.launches += 1
    return partials


integrate_cuda.launches = 0
