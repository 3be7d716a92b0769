"""Multi-dimensional fused integrate: grid plan, per-dimension draws
(counter RNG or Sobol), the error-bar pilot, the plain PyTorch version and
the CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/integrate_nd_pallas.py`` (kernel 2) in its
``mc``, ``antithetic`` and ``qmc`` modes, with and without error bars, for
d >= 2 dimensions of the uniform, normal and exponential families and the
seven extended families (``sampling.ANALYTIC_EXT``), in any mix.  For
the same (seed, plan) the plain version and the kernel draw exactly the
samples the JAX kernel draws in interpret mode, where that kernel keeps
256-row blocks (``pick_nd_rows``; the port always does).

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
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sampling import (
    ANALYTIC_KINDS,
    DistKind,
    normal_from_u01,
    transform_from_u,
)
from ..tracing import TracedFunction
from ..utils.roadmap import ND_CUSTOM, not_ported
from .integrate_kernel import (
    BLOCK_ELEMS,
    BLOCK_ROWS,
    LANES,
    MAX_CUDA_BLOCKS,
    MAX_FUNCTIONS,
    POS_BITS,
    CounterRng,
    Grid,
    finish_stderr,
    qmc_seg_bits,
    uniform_halfopen01,
    uniform_open01,
)
from .lower import cuda_source, to_torch
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
    "IntegrateNdProgram",
    "NdConfig",
    "finish_stderr",
    "integrate_nd_cuda",
    "integrate_nd_reference",
    "integrate_nd_rows",
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
    and whether the kernel also sums pilot-shifted squares (``mc`` and
    ``antithetic`` only: ``qmc`` error bars come from rotations)."""

    kinds: Tuple[DistKind, ...]
    method: str = "mc"
    with_stderr: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kinds", tuple(DistKind(k) for k in self.kinds))
        if self.method not in METHODS:
            raise ValueError(
                "method must be 'mc', 'qmc' or 'antithetic', got "
                f"{self.method!r}"
            )
        if len(self.kinds) < 2:
            raise ValueError("nd integrate takes d >= 2 dimensions")
        for kind in self.kinds:
            if kind not in ANALYTIC_KINDS:
                raise not_ported(
                    f"{kind.name.lower()} dimensions in nd integrate",
                    ND_CUSTOM,
                )
        if self.method == "qmc" and self.d > SOBOL_MAX_DIMS:
            raise ValueError(
                f"method='qmc' supports up to {SOBOL_MAX_DIMS} dimensions, "
                f"got {self.d}"
            )
        if self.method == "qmc" and self.with_stderr:
            raise ValueError(
                "qmc error bars come from rotations (qmc_rotations), not "
                "from in-kernel squares"
            )

    @property
    def d(self) -> int:
        return len(self.kinds)

    @property
    def antithetic(self) -> bool:
        return self.method == "antithetic"


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


def nd_samples(
    cfg: NdConfig, params: torch.Tensor, seed: int, grid: Grid,
    tiles: torch.Tensor,
):
    """The d sample blocks, each (len(tiles), 256, 128) float32, of the
    given tiles; under ``antithetic`` a pair of such d-lists (the points
    and their mirrors)."""
    xs, mirrors = [], []
    for j, kind in enumerate(cfg.kinds):
        get_u = lambda open01, j=j: nd_uniforms(  # noqa: E731
            cfg.method, seed, grid, tiles, j, open01
        )
        p1, p2 = params[j, 0], params[j, 1]
        if cfg.antithetic:
            a, b = _draw_dim_pair(kind, p1, p2, get_u)
            xs.append(a)
            mirrors.append(b)
        else:
            xs.append(_draw_dim(kind, p1, p2, get_u))
    return (xs, mirrors) if cfg.antithetic else xs


def pilot_row(
    torch_fns: Sequence[Callable], kinds: Sequence[DistKind],
    params: torch.Tensor,
) -> torch.Tensor:
    """(K,) float32 pilots: each integrand's mean over per-dimension
    quantile grids (``_pilot_row_of``, integrate_nd_pallas.py:816-858).
    As written there: the uniform grid is not clamped below its bound and
    the exponential one is ``-log(u) / p1``.  Any pilot keeps the error
    bar exact; a near one keeps float32 cancellation small."""
    dev = params.device
    base = (
        torch.arange(_PILOT_POINTS, dtype=torch.float32, device=dev) + 0.5
    ) / float(_PILOT_POINTS)
    xs = []
    for j, kind in enumerate(kinds):
        offset = float(np.float32(j) * np.float32(_PILOT_OFFSET))
        u = torch.remainder(base + offset, 1.0)
        u = torch.clamp(u, _U_LO, _U_HI)
        p1, p2 = params[j, 0], params[j, 1]
        if kind == DistKind.UNIFORM:
            xs.append(p1 + u * (p2 - p1))
        elif kind == DistKind.NORMAL:
            xs.append(p1 + p2 * normal_from_u01(u))
        elif kind == DistKind.EXPONENTIAL:
            xs.append(-torch.log(u) / p1)
        else:
            xs.append(transform_from_u(u, kind, p1, p2))
    return torch.stack([f(*xs).mean() for f in torch_fns])


def _check_args(cfg: NdConfig, params: torch.Tensor, pilot, k: int) -> None:
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


def integrate_nd_reference(
    torch_fns: Sequence[Callable],
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version, on ``params``' device: (K,) float32 sums
    over the grid's samples, or with ``cfg.with_stderr`` a (2, K) stack of
    the sums and the squares of (value - pilot), of pair means under
    ``antithetic``.  Same draws and float32 operations as the kernel;
    tiles go ``_TILES_PER_CHUNK`` at a time."""
    k = len(torch_fns)
    _check_args(cfg, params, pilot, k)
    dev = params.device
    sums = torch.zeros(k, dtype=torch.float32, device=dev)
    sqs = torch.zeros(k, dtype=torch.float32, device=dev)
    for t0 in range(0, grid.n_tiles, _TILES_PER_CHUNK):
        tiles = torch.arange(
            t0, min(t0 + _TILES_PER_CHUNK, grid.n_tiles),
            dtype=torch.int64, device=dev,
        )
        drawn = nd_samples(cfg, params, seed, grid, tiles)
        tile_sums, tile_sqs = [], []
        for j, f in enumerate(torch_fns):
            if cfg.antithetic:
                v1, v2 = f(*drawn[0]), f(*drawn[1])
                tile_sums.append(v1.sum(dim=(1, 2)) + v2.sum(dim=(1, 2)))
                dd = 0.5 * (v1 + v2) - pilot[j] if cfg.with_stderr else None
            else:
                v = f(*drawn)
                tile_sums.append(v.sum(dim=(1, 2)))
                dd = v - pilot[j] if cfg.with_stderr else None
            if dd is not None:
                tile_sqs.append((dd * dd).sum(dim=(1, 2)))
        sums += torch.stack(tile_sums, dim=1).sum(dim=0)
        if cfg.with_stderr:
            sqs += torch.stack(tile_sqs, dim=1).sum(dim=0)
    return torch.stack([sums, sqs]) if cfg.with_stderr else sums


class IntegrateNdProgram:
    """One fused d-ary integrand set over one tuple of per-dimension
    families, lowered both ways: ``torch_fns`` for the plain version, and
    the CUDA library, built at first use.  The families are compiled
    into the library (``TMC_KINDS``), as the JAX kernel is traced per
    family tuple: each dimension's transform is then straight-line code."""

    def __init__(self, fns: Sequence[TracedFunction], kinds: Sequence[DistKind]):
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
        self._lib = None
        self._dirs = {}

    def library(self):
        if self._lib is None:
            from .build import load_kernel_library

            kinds = ", ".join(str(int(k)) for k in self.kinds)
            lib = load_kernel_library(
                "integrate_nd.cu",
                cuda_source(self.fns) + f"#define TMC_KINDS {kinds}\n",
            )
            lib.tmc_integrate_nd.argtypes = [
                ctypes.c_int,       # method: 0 mc, 1 antithetic, 2 qmc
                ctypes.c_int,       # with_stderr
                ctypes.c_uint32,    # seed word
                ctypes.c_void_p,    # params (d, 2) float32
                ctypes.c_void_p,    # Sobol direction numbers (d, 32) or null
                ctypes.c_void_p,    # pilots (K,) float32 or null
                ctypes.c_int,       # loops per program
                ctypes.c_longlong,  # tiles = programs * loops
                ctypes.c_int,       # Sobol segment bits, or -1
                ctypes.c_int,       # CUDA grid size
                ctypes.c_void_p,    # partials (grid, K or 2K) float32
                ctypes.c_void_p,    # cudaStream_t
            ]
            lib.tmc_integrate_nd.restype = ctypes.c_int
            self._lib = lib
        return self._lib

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


_METHOD_CODES = {"mc": 0, "antithetic": 1, "qmc": 2}


def integrate_nd_cuda(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The program's sums over the grid's samples, as
    :func:`integrate_nd_reference` returns them, on ``params``' device.

    A CUDA ``params`` launches the kernel (``integrate_nd_cuda.launches``
    counts the launches); a CPU ``params`` runs the plain version.  Any
    other device raises.  The launch is asynchronous on the current
    stream."""
    if params.device.type == "cpu":
        _check_program(program, cfg, params, pilot)
        return integrate_nd_reference(
            program.torch_fns, cfg, params, seed, grid, pilot
        )
    out = integrate_nd_rows(program, cfg, params, seed, grid, pilot).sum(dim=0)
    return out.reshape(2, -1) if cfg.with_stderr else out


def _check_program(program, cfg, params, pilot) -> None:
    if cfg.kinds != program.kinds:
        raise ValueError(
            f"the program was built for {program.kinds}, not {cfg.kinds}"
        )
    _check_args(cfg, params, pilot, len(program.fns))


def integrate_nd_rows(
    program: IntegrateNdProgram,
    cfg: NdConfig,
    params: torch.Tensor,
    seed: int,
    grid: Grid,
    pilot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launches the kernel on CUDA ``params`` and returns its per-block
    rows, (blocks, K) float32 sums or with ``cfg.with_stderr`` (blocks, 2K)
    sums then squares, unsummed (``integrate_nd_cuda`` sums them).  Counts
    the launch in ``integrate_nd_cuda.launches``."""
    _check_program(program, cfg, params, pilot)
    if params.device.type != "cuda":
        raise ValueError(f"no nd integrate kernel for device {params.device}")
    k = len(program.fns)
    params = params.contiguous()
    dev = params.device
    seg_bits = -1
    dirs = 0
    if cfg.method == "qmc":
        seg = qmc_seg_bits(grid)
        seg_bits = -1 if seg is None else seg
        dirs = program.direction_numbers(dev).data_ptr()
    pilots = pilot.contiguous().data_ptr() if cfg.with_stderr else 0
    lib = program.library()
    n_out = 2 * k if cfg.with_stderr else k
    rows = min(grid.n_tiles, MAX_CUDA_BLOCKS)
    partials = torch.empty((rows, n_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tmc_integrate_nd(
            _METHOD_CODES[cfg.method], int(cfg.with_stderr),
            int(seed) & MASK32, params.data_ptr(), dirs, pilots, grid.loops,
            grid.n_tiles, seg_bits, rows, partials.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"nd integrate kernel launch failed: {lib.tmc_error_string(err)!r}"
        )
    integrate_nd_cuda.launches += 1
    return partials


integrate_nd_cuda.launches = 0
