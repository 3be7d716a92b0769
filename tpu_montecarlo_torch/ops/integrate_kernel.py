"""Fused 1-D Monte Carlo integrate: grid plan, counter RNG, the plain
PyTorch version and the CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/integrate_pallas.py`` in its plain-MC mode
for the uniform, normal and exponential families.  The TPU kernel draws
from the TPU's hardware PRNG; off the TPU it runs with ``CounterRng``, a
pure integer hash.  The port implements that ``CounterRng`` bit for bit,
so for the same (seed, plan) the plain version and the kernel here draw
exactly the samples the JAX kernel draws in interpret mode.

Sample layout: the plan becomes ``programs x loops`` tiles of
``BLOCK_ROWS x LANES`` samples.  Tile (pid, blk) seeds the RNG with
(seed, pid) and draws with block counter ``blk``; the normal family draws
two half blocks with tags 0 and 1, the others one block with tag 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, Sequence

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
from .lower import cuda_source, to_torch
from .qmc import MASK32, pcg_mix

__all__ = [
    "BLOCK_ROWS",
    "CounterRng",
    "Grid",
    "IntegrateProgram",
    "LANES",
    "MAX_CUDA_BLOCKS",
    "integrate_cuda",
    "integrate_reference",
    "plan_grid",
    "sample_block",
    "sample_subblocks",
    "uniform_halfopen01",
    "uniform_open01",
]

# Stream geometry, equal to the JAX kernel's.  The JAX package shrinks
# its block for high K to fit VMEM (pick_block_rows); the port keeps 256
# rows, so it draws the JAX package's stream wherever that picks 256.
BLOCK_ROWS = 256
LANES = 128
BLOCK_ELEMS = BLOCK_ROWS * LANES
MAX_LOOPS_PER_PROGRAM = 512
# The JAX kernel rounds loops up to a multiple of its unroll, which
# changes how many samples a plan draws; the port rounds the same way.
UNROLL_BLOCKS = 8
# Most rows of partial sums the kernel writes: the grid-stride loop maps
# tiles to at most this many CUDA blocks (a constant, so the summation
# order, and with it the result, is the same on every card).
MAX_CUDA_BLOCKS = 8192
MAX_FUNCTIONS = 128
# Tiles the plain version draws at once: 2M samples, 16 MB per int64
# word tensor.
_TILES_PER_CHUNK = 64

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


def plan_grid(n_samples: int) -> Grid:
    """Grid drawing ``actual_samples >= n_samples`` samples: the JAX
    package's ``plan_pallas_grid`` plus its unroll rounding
    (integrate_pallas.py:81-92 and :937-941)."""
    total_blocks = -(-n_samples // BLOCK_ELEMS)
    loops = min(total_blocks, MAX_LOOPS_PER_PROGRAM)
    programs = -(-total_blocks // loops)
    unroll = min(UNROLL_BLOCKS, loops)
    loops = -(-loops // unroll) * unroll
    return Grid(programs, loops, programs * loops * BLOCK_ELEMS)


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


def sample_block(
    kind: DistKind, p1, p2, rng: CounterRng, shape, counter, tag: int = 0
) -> torch.Tensor:
    """One block of samples of the family from the (counter, tag) stream
    (``csrc/counter_rng.cuh`` ``tmc::transform``): uniform and normal from
    [0, 1) uniforms, exponential from (0, 1] ones."""
    if kind == DistKind.UNIFORM:
        u = uniform_halfopen01(rng, shape, counter, tag)
        x = p1 + u * (p2 - p1)
        # f32 rounding may land on the open bound: clamp below it.
        return torch.where(x >= p2, next_below_f32(torch.as_tensor(p2)), x)
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


class IntegrateProgram:
    """One fused integrand set, lowered both ways: ``torch_fns`` for the
    plain version, and the CUDA library, built at first use."""

    def __init__(self, fns: Sequence[TracedFunction]):
        if not 1 <= len(fns) <= MAX_FUNCTIONS:
            raise ValueError(
                f"the kernel fuses 1 to {MAX_FUNCTIONS} functions, "
                f"got {len(fns)}"
            )
        self.fns = tuple(fns)
        self.torch_fns: List[Callable] = [to_torch(f) for f in fns]
        self._lib = None

    def library(self):
        if self._lib is None:
            from .build import load_kernel_library

            lib = load_kernel_library("integrate.cu", cuda_source(self.fns))
            lib.tmc_integrate.argtypes = [
                ctypes.c_int,       # kind
                ctypes.c_uint32,    # seed word
                ctypes.c_void_p,    # params (2,) float32 on the device
                ctypes.c_int,       # loops per program
                ctypes.c_longlong,  # tiles = programs * loops
                ctypes.c_int,       # CUDA grid size
                ctypes.c_void_p,    # partials (grid, K) float32
                ctypes.c_void_p,    # cudaStream_t
            ]
            lib.tmc_integrate.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def _check_args(kind, params: torch.Tensor) -> None:
    if kind not in PORTED_KINDS:
        raise not_ported(f"integrating under {DistKind(kind).name}", VARIANTS)
    if params.dtype != torch.float32 or params.shape != (2,):
        raise ValueError(
            f"params must be a (2,) float32 tensor, got {tuple(params.shape)} "
            f"{params.dtype}"
        )


def integrate_reference(
    torch_fns: Sequence[Callable],
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
) -> torch.Tensor:
    """Plain PyTorch version: (K,) float32 sums over the grid's samples,
    on ``params``' device.  Same stream, transforms and per-tile order as
    the kernel; tiles go ``_TILES_PER_CHUNK`` at a time, so a large plan
    never holds all its samples."""
    _check_args(kind, params)
    dev = params.device
    p1, p2 = params[0], params[1]
    tile_sums = []
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        rng = CounterRng(seed, tiles // grid.loops, device=dev)
        subs = sample_subblocks(kind, p1, p2, rng, tiles % grid.loops)
        tile_sums.append(
            torch.stack(
                [
                    sum(f(x).sum(dim=(1, 2)) for x in subs)
                    for f in torch_fns
                ],
                dim=1,
            )
        )
    return torch.cat(tile_sums).sum(dim=0)


def integrate_cuda(
    program: IntegrateProgram,
    kind: DistKind,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
) -> torch.Tensor:
    """(K,) float32 sums of the program's integrands over the grid's
    samples, on ``params``' device.

    A CUDA ``params`` launches the kernel (``integrate_cuda.launches``
    counts the launches); a CPU ``params`` runs the plain version.  Any
    other device raises.  The launch is asynchronous on the current
    stream."""
    _check_args(kind, params)
    if params.device.type == "cpu":
        return integrate_reference(program.torch_fns, kind, params, seed, grid)
    if params.device.type != "cuda":
        raise ValueError(f"no integrate kernel for device {params.device}")
    params = params.contiguous()
    lib = program.library()
    k = len(program.fns)
    rows = min(grid.n_tiles, MAX_CUDA_BLOCKS)
    partials = torch.empty((rows, k), dtype=torch.float32, device=params.device)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        err = lib.tmc_integrate(
            int(kind), int(seed) & MASK32, params.data_ptr(), grid.loops,
            grid.n_tiles, rows, partials.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"integrate kernel launch failed: {lib.tmc_error_string(err)!r}"
        )
    integrate_cuda.launches += 1
    return partials.sum(dim=0)


integrate_cuda.launches = 0
