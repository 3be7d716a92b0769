"""1-D Metropolis-Hastings: chain plan, the plain PyTorch version and the
CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/mcmc_pallas.py`` (``build_mcmc_fn_pallas``)
in its independence, random-walk and adaptive random-walk modes, with HMC
(``hmc_leapfrog``: the walk's step becomes an L-step leapfrog trajectory)
and chain state in and out (``with_state``, ``use_init_state``), with and
without error bars, for the uniform, normal and exponential families, the
seven extended families (``sampling.ANALYTIC_EXT``) and CUSTOM tables: a
table target, and a table proposal in sampler mode (its
logq the draw's own density) or gapped (its logq from its log table), as
``ops/mcmc_tables.py`` reads them.
Both versions here run, chain for chain, the chains that the JAX kernel
runs under ``CounterRng`` (its interpreter stream): the same seeding per
(seed ^ 0x5BD1E995 ^ segment * 0x9E3779B1, program; segment 0 but for a
resumed run), the same counters per step (0 for the
initial state, 3i+1 for the proposal, 3i+2 for the accept test) and the
same float32 operation order.  Only last-bit differences of ``log``,
``exp`` and ``erfinv`` between libraries can flip an accept decision.

Chains are laid out as the JAX kernel lays them out: chain ``c`` is
position ``c % chains_per_program`` (``row * 128 + lane``) of program
``c // chains_per_program``.  Both versions return per-block rows of
``CHAIN_THREADS`` chains: (sums, accept count), (SS, 0) and (centroid, 0)
of the chain means, and with diagnostics four more rows of the blocks'
half-chain sequences (``ops/mcmc_diagnostics.py``); :func:`mcmc_finish`
turns them into estimates, the acceptance rate, the error bars (Chan's
parallel-variance formula, exact for any partition of the chains) and
split-R-hat and ESS.  With thinned draws they also return the post-step
states at sampling steps ``j * (n_steps // m)``.  On the card a chain runs on
``Layout.lanes`` threads, each making ``Layout.group`` of its candidates
ahead of the decisions (``csrc/mcmc_pipeline.cuh``); the layout changes
no number the kernel computes.

The JAX package sends MCMC workloads its kernel cannot take to an XLA
sweep keyed on ``jax.random``; the port has no such twin and runs every
workload it takes in this kernel.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sampling import (
    DistKind,
    analytic_log_pdf,
    log_pdf_grad,
    normal_from_u01,
)
from ..tracing import TracedFunction
from .integrate_kernel import (
    LANES,
    MASK32,
    CounterRng,
    check_batch,
    sample_block,
    uniform_halfopen01,
    uniform_open01,
)
from .lower import cuda_source, to_torch
from .reduce import fixed_sum
from .mcmc_diagnostics import (
    DIAG_ROWS,
    PhaseOutputs,
    check_outputs,
    diag_combine,
)
from .mcmc_tables import (
    DimTables,
    check_dim_tables,
    inverse_draw,
    kernel_tables,
    log_table_slope,
    log_table_value,
    sampler_logq,
)

__all__ = [
    "CHAIN_THREADS",
    "MAX_FUNCTIONS",
    "Layout",
    "McmcConfig",
    "McmcGrid",
    "McmcOutput",
    "McmcProgram",
    "ChainStart",
    "Mode",
    "block_rows",
    "default_layout",
    "mcmc_batch",
    "mcmc_batch_finish",
    "mcmc_cuda",
    "mcmc_diagnostics",
    "mcmc_finish",
    "mcmc_reference",
    "plan_chains",
    "plan_mcmc_grid",
    "seed_word",
    "segment_word",
]

#: Chains per CUDA block, and so per row of the output: fixed in
#: csrc/mcmc.cu and csrc/mcmc_nd.cu, whose blocks run them on
#: 32 * ``Layout.lanes`` threads.
CHAIN_THREADS = 32
#: One lane of the JAX kernel's output row holds the accept count.
MAX_FUNCTIONS = LANES - 1
_SEED_MIX = 0x5BD1E995
#: Folded into the seed word per resumed segment (``mcmc_pallas.py:137-140``).
SEGMENT_MIX = 0x9E3779B1
_LOG_STEP_MIN = -13.815511
_LOG_STEP_MAX = 13.815511


class Mode(IntEnum):
    """Proposal modes, with the codes ``csrc/mcmc.cu`` compiles in."""

    INDEPENDENCE = 0
    RANDOM_WALK = 1
    ADAPTIVE = 2


class Layout(NamedTuple):
    """How the 1-D and nd MCMC kernels run a chain's steps on the card
    (``csrc/mcmc_pipeline.cuh``): ``lanes`` consecutive threads of a warp
    share one chain, and each makes ``group`` of its x-free candidates
    ahead of every round of ``lanes * group`` decisions.  A walk's
    candidate depends on the chain's state, so a walk takes one lane."""

    lanes: int
    group: int


#: The layouts the kernels compile in by default, chosen by sweeps on an
#: H100 (``tools/mcmc_layout_sweep.py``; ``PERF.md``).  Every lane of an
#: independence chain evaluates the integrands at the chain's state, so
#: more integrands want fewer lanes: up to k integrands a chain takes the
#: layout beside k here, and WIDE_LAYOUT above the last k (one lane, and
#: a small group for registers: 127 sums fill them).
LAYOUTS_BY_FUNCTIONS = ((8, Layout(lanes=8, group=4)),
                        (32, Layout(lanes=4, group=4)))
WIDE_LAYOUT = Layout(lanes=1, group=2)
#: A walk's step waits on the one before: one lane, 8 steps' draws ahead.
WALK_LAYOUT = Layout(lanes=1, group=8)
#: HMC's step is L gradient evaluations on the carried chain: one lane,
#: and 4 steps' draws ahead, the fastest of groups 1, 2, 4 and 8 at c11 and
#: c11c on an H100 (``chip_smoke.py`` phases 48-49; ``PERF.md``).
HMC_LAYOUT = Layout(lanes=1, group=4)


def default_layout(mode: Mode, k: int, hmc: bool = False) -> Layout:
    """The layout a kernel of ``k`` integrands compiles in for ``mode``
    (``hmc``: a walk mode's HMC)."""
    if hmc:
        return HMC_LAYOUT
    if mode != Mode.INDEPENDENCE:
        return WALK_LAYOUT
    return next((layout for most, layout in LAYOUTS_BY_FUNCTIONS
                 if k <= most), WIDE_LAYOUT)


def check_layout(mode: Mode, layout: Layout) -> Layout:
    """``layout`` as a :class:`Layout`, or ValueError when the kernels
    cannot run it."""
    layout = Layout(*layout)
    if not (1 <= layout.lanes <= 32 and 32 % layout.lanes == 0
            and layout.group >= 1):
        raise ValueError(
            f"a layout takes lanes that divide a warp of 32 and a group of "
            f"at least 1, got {tuple(layout)}"
        )
    if mode != Mode.INDEPENDENCE and layout.lanes != 1:
        raise ValueError("a random walk runs one lane per chain")
    return layout


def layout_source(layout: Layout) -> str:
    """The layout's lines in the generated kernel source."""
    return (f"#define TMC_LANES {layout.lanes}\n"
            f"#define TMC_GROUP {layout.group}\n")


def plan_chains(
    n_chains: int, target_threads: Optional[int], n_dev: int = 1
) -> int:
    """Total chain count (``tpu_montecarlo/ops/mcmc_xla.py:85``):
    ``target_threads`` overrides ``n_chains`` when given (the reference
    engine's quirk), rounded up to a multiple of lcm(256, n_dev)."""
    chains = target_threads if target_threads is not None else n_chains
    m = math.lcm(256, max(int(n_dev), 1))
    return -(-max(int(chains), 1) // m) * m


@dataclass(frozen=True)
class McmcGrid:
    """The JAX kernel's grid: ``programs`` blocks of ``rows x 128``
    chains; every one of the ``chains_actual`` chains enters the average."""

    programs: int
    rows: int
    chains_actual: int

    @property
    def chains_per_program(self) -> int:
        return self.rows * LANES


def plan_mcmc_grid(total_chains: int) -> McmcGrid:
    """``tpu_montecarlo/ops/mcmc_pallas.py:71``: 8 to 64 rows of 128
    chains per program, so at least 1024 chains run."""
    rows = max(8, min(64, -(-total_chains // LANES)))
    rows = (rows + 7) // 8 * 8
    block = rows * LANES
    programs = -(-total_chains // block)
    return McmcGrid(programs, rows, programs * block)


def segment_word(word: int, segment: int) -> int:
    """A seed word with a resumed segment folded in, ``word ^ (segment *
    0x9E3779B1)`` in 32-bit arithmetic (the JAX kernel's int32 product):
    segment 0 leaves the word, so a fresh stateful run draws the stateless
    run's streams."""
    return word ^ ((int(segment) * SEGMENT_MIX) & 0xFFFFFFFF)


def seed_word(seed: int, segment: int = 0) -> int:
    """The kernels' seed word: the seed as uint32 (``np.uint32`` rejects
    seeds outside [0, 2**32), as the JAX package does) xor 0x5BD1E995,
    with the resumed ``segment`` folded in (:func:`segment_word`)."""
    return segment_word(int(np.uint32(seed)) ^ _SEED_MIX, segment)


def check_state(cfg) -> None:
    """The JAX kernel builders' checks of a stateful config
    (``mcmc_pallas.py:525-563``), shared by the 1-D and nd configs."""
    if cfg.use_init_state and not cfg.with_state:
        raise ValueError(
            "use_init_state requires with_state=True (the stateless "
            "program has no state inputs)"
        )
    if cfg.with_state:
        for on, name in ((cfg.with_stderr, "with_stderr"),
                         (cfg.with_diagnostics, "with_diagnostics"),
                         (cfg.samples, "with_samples")):
            if on:
                raise ValueError(
                    f"{name} applies to stateless MCMC programs only")
    if cfg.use_init_state and cfg.mode == Mode.ADAPTIVE:
        raise ValueError("rw_adapt is stateless-only (steps not resumable)")


_KNOT_DEFINES = ("TMC_PROP_KNOTS", "TMC_Q_KNOTS", "TMC_TARG_KNOTS")


def check_knots(knots, roles) -> None:
    """Raises ValueError unless each dimension's ``knots`` (knot-exact
    draw, irregular q-table, irregular target table) sits on its roles
    ((proposal is CUSTOM, its logq comes from its log table, target is
    CUSTOM)): the first two on a CUSTOM proposal whose logq comes from a
    log table, the last on a CUSTOM target."""
    for (draw, q, targ), (prop, gapped, custom_targ) in zip(knots, roles):
        if ((draw or q) and not (prop and gapped)) or (
                targ and not custom_targ):
            raise ValueError(
                "knot tables go with a CUSTOM proposal whose logq comes "
                "from its log table (prop_gapped) and with a CUSTOM target")


def knots_source(knots) -> str:
    """The generated source's lines for the dimensions' ``knots``
    (TMC_PROP_KNOTS, TMC_Q_KNOTS, TMC_TARG_KNOTS, one entry per
    dimension); none for a library that reads no knot table."""
    if not any(any(k) for k in knots):
        return ""
    return "".join(
        f"#define {name} {', '.join(str(int(k[i])) for k in knots)}\n"
        for i, name in enumerate(_KNOT_DEFINES))


def state_source(state) -> str:
    """The generated source's lines for a config's ``state`` (leapfrog
    steps, state out, state in); none for a library without them."""
    leapfrog, with_state, use_init_state = state
    return ((f"#define TMC_HMC {int(leapfrog)}\n" if leapfrog else "")
            + ("#define TMC_STATE 1\n" if with_state else "")
            + ("#define TMC_INIT_STATE 1\n" if use_init_state else ""))


@dataclass(frozen=True)
class McmcConfig:
    """What a run does.  ``proposal_kind`` is ignored by the walks;
    ``prop_gapped`` marks a CUSTOM proposal whose logq comes from its log
    table (a gapped one, drawn from gap-respecting tables, one on the
    knots or full route, and any one of a stateful run; else sampler
    mode); ``with_diagnostics`` adds
    split-R-hat and ESS (n_steps >= 4), and ``samples`` (0 for none) the
    thinned draws.  ``hmc_leapfrog`` (L > 0, a walk mode) makes each step
    an L-step leapfrog trajectory; ``with_state`` returns each chain's
    final log density beside its state, and ``use_init_state`` starts the
    chains from a given state (x0, logp0) instead of counter 0's draws.
    ``knots`` (:attr:`DimTables.knots`) marks the tables read by knot
    search: a CUSTOM proposal's knot-exact draw (the ``"knots"`` route),
    its log table on an irregular grid (the ``"knots"`` and ``"full"``
    routes), a CUSTOM target's irregular log table."""

    mode: Mode
    proposal_kind: DistKind
    target_kind: DistKind
    n_steps: int
    n_burnin: int
    with_stderr: bool = False
    prop_gapped: bool = False
    with_diagnostics: bool = False
    samples: int = 0
    hmc_leapfrog: int = 0
    with_state: bool = False
    use_init_state: bool = False
    knots: Tuple[bool, bool, bool] = (False, False, False)

    def __post_init__(self):
        object.__setattr__(self, "knots", tuple(bool(k) for k in self.knots))
        check_knots([self.knots], [self.roles])
        check_outputs(self.n_steps, self.with_diagnostics, self.samples)
        if self.hmc_leapfrog < 0 or (
                self.hmc_leapfrog and self.mode == Mode.INDEPENDENCE):
            raise ValueError("hmc_leapfrog requires a walk mode")
        check_state(self)
        if (self.with_state and self.roles[0] and not self.prop_gapped):
            raise ValueError(
                "a stateful run takes a CUSTOM proposal's logq from its log "
                "table (prop_gapped=True): its start has no draw")

    @property
    def state(self):
        """What the library compiles in for HMC and the chain state:
        (leapfrog steps, state out, state in)."""
        return (int(self.hmc_leapfrog), bool(self.with_state),
                bool(self.use_init_state))

    @property
    def outputs(self):
        """What the library compiles in besides the mode and families:
        (diagnostics, draws)."""
        return bool(self.with_diagnostics), bool(self.samples)

    @property
    def stat_mode(self) -> bool:
        """Whether the sums are pilot-shifted and the values come from the
        blocks' centroids: error bars or diagnostics (the JAX kernels'
        ``stat_mode``)."""
        return bool(self.with_stderr or self.with_diagnostics)

    @property
    def compiled(self):
        """What the CUDA library compiles in: the mode, the proposal's
        family (None for a walk), the target's, and whether a CUSTOM
        proposal is gapped."""
        mode = Mode(self.mode)
        prop = (DistKind(self.proposal_kind) if mode == Mode.INDEPENDENCE
                else None)
        gapped = bool(self.prop_gapped) and prop == DistKind.CUSTOM
        return mode, prop, DistKind(self.target_kind), gapped

    @property
    def roles(self):
        """(proposal is CUSTOM, proposal is gapped, target is CUSTOM)."""
        _, prop, targ, gapped = self.compiled
        return prop == DistKind.CUSTOM, gapped, targ == DistKind.CUSTOM


class McmcOutput(NamedTuple):
    """``rows``: (chains / CHAIN_THREADS, R, K + 1) float32 block rows, R
    = 3, or 7 with diagnostics; ``x_final``: (chains,) float32 final chain
    states, (d, chains) from the nd kernel (``ops/mcmc_nd_kernel.py``);
    ``samples``: the thinned draws, (m, chains) float32, (m, d, chains)
    from the nd and tempered kernels, or None; ``logp_final``: a stateful
    run's (chains,) float32 final target log densities, else None."""

    rows: torch.Tensor
    x_final: torch.Tensor
    samples: Optional[torch.Tensor] = None
    logp_final: Optional[torch.Tensor] = None


class ChainStart(NamedTuple):
    """A resumed run's start: each chain's state ``x`` ((chains,) float32,
    (d, chains) over d dimensions) and its target log density ``log_p``
    ((chains,) float32), on the run's device."""

    x: torch.Tensor
    log_p: torch.Tensor


def outputs_source(outputs) -> str:
    """The generated source's lines for the (diagnostics, draws) a library
    compiles in; none for a library without them."""
    diag, draws = outputs
    return (("#define TMC_DIAG 1\n" if diag else "")
            + ("#define TMC_SAMPLES 1\n" if draws else ""))


def row_count(cfg) -> int:
    """Rows per block of a run of ``cfg``."""
    return 3 + (DIAG_ROWS if cfg.with_diagnostics else 0)


class McmcProgram:
    """One integrand set, lowered both ways: ``torch_fns`` for the plain
    version, and the CUDA libraries, one per compiled-in mode and family
    pair (``McmcConfig.compiled``), each built at its first use.
    ``layout`` fixes the kernels' :class:`Layout` for every mode it fits;
    by default each mode takes :func:`default_layout`'s."""

    def __init__(self, fns: Sequence[TracedFunction],
                 layout: Optional[Layout] = None):
        if not 1 <= len(fns) <= MAX_FUNCTIONS:
            raise ValueError(
                f"the MCMC kernel takes 1 to {MAX_FUNCTIONS} functions, "
                f"got {len(fns)}"
            )
        self.fns = tuple(fns)
        self.torch_fns: List[Callable] = [to_torch(f) for f in fns]
        self.layout = None if layout is None else Layout(*layout)
        self._libs = {}

    def layout_for(self, cfg: McmcConfig) -> Layout:
        """The layout the library of ``cfg``'s mode runs."""
        if self.layout is None:
            return default_layout(cfg.mode, len(self.fns),
                                  bool(cfg.hmc_leapfrog))
        return check_layout(cfg.mode, self.layout)

    def source(self, cfg: McmcConfig) -> str:
        """The generated source the kernel includes: the integrands, the
        compiled-in mode and families (with a CUSTOM proposal's route),
        and the layout."""
        mode, prop, targ, gapped = cfg.compiled
        parts = [
            cuda_source(self.fns),
            f"#define TMC_MODE {int(mode)}\n",
            f"#define TMC_TARG_KIND {int(targ)}\n",
            layout_source(self.layout_for(cfg)),
        ]
        if prop is not None:
            parts.append(f"#define TMC_PROP_KIND {int(prop)}\n")
        if prop == DistKind.CUSTOM:
            parts.append(f"#define TMC_PROP_GAPPED {int(gapped)}\n")
        parts.append(knots_source([cfg.knots]))
        parts.append(outputs_source(cfg.outputs))
        parts.append(state_source(cfg.state))
        return "".join(parts)

    def library(self, cfg: McmcConfig):
        key = (cfg.compiled, cfg.knots, cfg.outputs, cfg.state,
               self.layout_for(cfg))
        if key not in self._libs:
            from .build import load_kernel_library

            lib = load_kernel_library("mcmc.cu", self.source(cfg))
            p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            # seed word, seeds (R,) or null, reps, params, params stride,
            # host tables, chains per program, programs, pilots, stream
            lib.tmc_mcmc_pilots.argtypes = [u, p, i, p, i, p, i, i, p, p]
            lib.tmc_mcmc_pilots.restype = i
            # seed word, seeds (R,) or null, reps, params, params stride,
            # host tables, burn-in, steps, chains per program, chains,
            # pilots, rows, x_final, samples, m, stride, x0, logp0,
            # logp_final, stream
            lib.tmc_mcmc.argtypes = [u, p, i, p, i, p, i, i, i, i, p, p, p,
                                     p, i, i, p, p, p, p]
            lib.tmc_mcmc.restype = i
            self._libs[key] = lib
        return self._libs[key]


def _check_args(cfg: McmcConfig, params: torch.Tensor, k: int,
                tables: Optional[DimTables] = None) -> None:
    if cfg.prop_gapped and cfg.compiled[1] != DistKind.CUSTOM:
        raise ValueError("only a CUSTOM proposal is gapped")
    check_dim_tables([tables], [cfg.roles], "MCMC", params.device,
                     [cfg.knots])
    if params.dtype != torch.float32 or params.shape != (6,):
        raise ValueError(
            f"params must be a (6,) float32 tensor, got {tuple(params.shape)} "
            f"{params.dtype}"
        )
    if not 1 <= k <= MAX_FUNCTIONS:
        raise ValueError(f"1 to {MAX_FUNCTIONS} functions, got {k}")
    if cfg.n_steps < 1 or cfg.n_burnin < 0:
        raise ValueError("n_steps must be positive and n_burnin non-negative")


def check_start(cfg, start: Optional[ChainStart], x_shape,
                device: torch.device) -> None:
    """Raises ValueError unless ``start`` is given exactly when ``cfg``
    resumes (``use_init_state``), with float32 ``x`` of ``x_shape`` and
    ``log_p`` of one entry per chain, on ``device``."""
    if (start is not None) != bool(cfg.use_init_state):
        raise ValueError("a start state goes with use_init_state=True, "
                         "and only with it")
    if start is None:
        return
    x, log_p = start
    if (x.dtype != torch.float32 or log_p.dtype != torch.float32
            or tuple(x.shape) != tuple(x_shape)
            or tuple(log_p.shape) != (x_shape[-1],)):
        raise ValueError(
            f"the start state must be float32 x of shape {tuple(x_shape)} and "
            f"log_p of ({x_shape[-1]},), got {tuple(x.shape)} {x.dtype} and "
            f"{tuple(log_p.shape)} {log_p.dtype}")
    if x.device != device or log_p.device != device:
        raise ValueError(f"the start state lies on {x.device}, the run on "
                         f"{device}")


def block_rows(
    acc: torch.Tensor, n_acc: torch.Tensor, pilots: torch.Tensor, n_steps: int
) -> torch.Tensor:
    """The kernel's output rows from per-chain sums ``acc`` (C, K), accept
    counts ``n_acc`` (C,) and each chain's pilots (C, K)."""
    c, k = acc.shape
    nb = CHAIN_THREADS
    inv_steps = float(np.float32(1.0) / np.float32(n_steps))
    blocks = acc.reshape(c // nb, nb, k)
    cm = blocks * inv_steps
    mbs = cm.sum(dim=1) / float(nb)
    ss = torch.clamp(
        (cm * cm).sum(dim=1) - float(nb) * mbs * mbs, min=0.0
    )
    mb = mbs + pilots.reshape(c // nb, nb, k)[:, 0, :]
    accepted = n_acc.reshape(c // nb, nb).sum(dim=1, keepdim=True)
    zero = torch.zeros_like(accepted)
    return torch.stack(
        [
            torch.cat([blocks.sum(dim=1), accepted], dim=1),
            torch.cat([ss, zero], dim=1),
            torch.cat([mb, zero], dim=1),
        ],
        dim=1,
    )


def mcmc_reference(
    torch_fns: Sequence[Callable],
    cfg: McmcConfig,
    params: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[DimTables] = None,
    segment: int = 0,
    start: Optional[ChainStart] = None,
) -> McmcOutput:
    """Plain PyTorch version of the kernel, on ``params``' device:
    vectorised over all chains, a Python loop over the steps, with the
    kernel's counters and float32 operation order.  ``tables`` holds the
    CUSTOM tables of a table proposal or target; ``segment`` is folded
    into the seed word, and a resumed run (``cfg.use_init_state``) starts
    from ``start``."""
    _check_args(cfg, params, len(torch_fns), tables)
    dev = params.device
    check_start(cfg, start, (grid.chains_actual,), dev)
    q1, q2, q3, q4, t1, t2 = params.unbind()
    shape = (grid.rows, LANES)
    pids = torch.arange(grid.programs, dtype=torch.int64, device=dev)
    rng = CounterRng(seed_word(seed, segment), pids, device=dev)
    indep = cfg.mode == Mode.INDEPENDENCE
    _, _, _, gapped = cfg.compiled

    def propose(counter):
        """(x, logq), each (programs, rows, 128)."""
        if cfg.proposal_kind == DistKind.CUSTOM:
            u = uniform_halfopen01(rng, shape, counter, 0)
            x, slope = inverse_draw(u, tables.inv)
            if gapped:
                return x, log_table_value(x, tables.q)
            return x, sampler_logq(slope, tables.inv)
        x = sample_block(cfg.proposal_kind, q1, q2, rng, shape, counter)
        return x, analytic_log_pdf(cfg.proposal_kind, q1, q2, x)

    def lp_q(v):
        """The proposal's log density at a chain's start (table logq)."""
        if gapped:
            return log_table_value(v, tables.q)
        return analytic_log_pdf(cfg.proposal_kind, q1, q2, v)

    def lp_t(v):
        if cfg.target_kind == DistKind.CUSTOM:
            return log_table_value(v, tables.targ)
        return analytic_log_pdf(cfg.target_kind, t1, t2, v)

    def grad_t(v):
        if cfg.target_kind == DistKind.CUSTOM:
            return log_table_slope(v, tables.targ)
        return log_pdf_grad(cfg.target_kind, t1, t2, v)

    def values(v):
        return [f(v).to(torch.float32) for f in torch_fns]

    if start is not None:
        x = start.x.reshape(grid.programs, *shape)
        logp = start.log_p.reshape(grid.programs, *shape)
        if indep:
            logq = lp_q(x)
    else:
        if indep:
            x, logq = propose(0)
        else:
            x = q2 + uniform_halfopen01(rng, shape, 0, 0) * (q3 - q2)
        logp = lp_t(x)
    k = len(torch_fns)
    if cfg.stat_mode:
        n_block = float(grid.chains_per_program)
        pilots = [v.sum(dim=(1, 2), keepdim=True) / n_block for v in values(x)]
    else:
        pilots = [torch.zeros((grid.programs, 1, 1), device=dev)] * k
    outs = PhaseOutputs(cfg.n_steps, cfg.with_diagnostics, cfg.samples, k, x)

    step = q1
    if cfg.hmc_leapfrog:
        g = grad_t(x)
    if cfg.mode == Mode.ADAPTIVE:
        log_step = torch.log(q1) + torch.zeros_like(x)
    accs = [torch.zeros_like(x) for _ in range(k)]
    n_acc = torch.zeros_like(x)
    for i in range(cfg.n_burnin + cfg.n_steps):
        burn = i < cfg.n_burnin
        if cfg.mode == Mode.ADAPTIVE and (burn or i == cfg.n_burnin):
            step = torch.exp(log_step)
        if indep:
            xp, logq_prop = propose(3 * i + 1)
            logp_prop = lp_t(xp)
            log_alpha = logp_prop + logq - logp - logq_prop
        elif cfg.hmc_leapfrog:
            u = uniform_halfopen01(rng, shape, 3 * i + 1, 0)
            (xp,), logp_prop, (g_prop,), log_alpha = hmc_move(
                [x], logp, [g], [normal_from_u01(u)], [step],
                cfg.hmc_leapfrog, lambda v: (lp_t(v[0]), [grad_t(v[0])]))
        else:
            u = uniform_halfopen01(rng, shape, 3 * i + 1, 0)
            xp = x + step * normal_from_u01(u)
            logp_prop = lp_t(xp)
            log_alpha = logp_prop - logp
        u2 = uniform_open01(rng, shape, 3 * i + 2, 0)
        accept = torch.log(u2) < log_alpha
        x = torch.where(accept, xp, x)
        logp = torch.where(accept, logp_prop, logp)
        if indep:
            logq = torch.where(accept, logq_prop, logq)
        elif cfg.hmc_leapfrog:
            g = torch.where(accept, g_prop, g)
        if burn:
            if cfg.mode == Mode.ADAPTIVE:
                alpha_p = torch.exp(torch.clamp(log_alpha, max=0.0))
                i_f = torch.full((), float(i + 1), device=dev)
                gamma = torch.exp(-0.6 * torch.log(i_f))
                log_step = torch.clamp(
                    log_step + gamma * (alpha_p - q4),
                    _LOG_STEP_MIN, _LOG_STEP_MAX,
                )
            continue
        vals = [v - p for v, p in zip(values(x), pilots)]
        accs = [a + v for a, v in zip(accs, vals)]
        n_acc = n_acc + accept.to(torch.float32)
        outs.add(i - cfg.n_burnin, vals, x)

    acc = torch.stack([a.reshape(-1) for a in accs], dim=1)
    chain_pilots = torch.stack(
        [p.expand_as(x).reshape(-1) for p in pilots], dim=1
    )
    rows = block_rows(acc, n_acc.reshape(-1), chain_pilots, cfg.n_steps)
    return McmcOutput(with_diag_rows(rows, outs, chain_pilots),
                      x.reshape(-1), outs.samples(),
                      logp.reshape(-1) if cfg.with_state else None)


def hmc_move(xs, logp, gs, p0, eps, n_leapfrog: int, value_grad,
             beta=1.0):
    """One HMC move over d dimensions (``mcmc_pallas.py:795-832``,
    ``mcmc_nd_pallas.py:593-626``, with ``beta`` 1, which scales
    exactly; tempered, with the rung's ``beta``,
    ``mcmc_pt_pallas.py:465-500``; ``csrc/log_pdf_grad.cuh``
    ``hmc_move``): ``n_leapfrog`` kick-drift-kick steps from the d blocks
    ``xs``, whose gradient is ``gs``, with the momenta ``p0`` and the steps
    ``eps``, half-kicks of ``(0.5 * beta) * eps_j * g_j``; then ``(x',
    logp', grad(x'), log_alpha)``, ``log_alpha = (beta * logp' - 0.5 *
    |p'|^2) - (beta * logp - 0.5 * |p0|^2)`` with the squares summed in
    dimension order, -3.0e38 where it is NaN (a diverged trajectory
    rejects).  ``value_grad(xs)`` gives ``(log p, [d gradients])``; the
    trajectory's last call gives logp'.  The chain carries the gradient:
    the JAX kernels recompute it at each step, the same function of the
    same x."""
    half = [(0.5 * beta) * e for e in eps]
    xq, p, g = list(xs), list(p0), list(gs)
    for _ in range(n_leapfrog):
        p = [pj + hj * gj for pj, hj, gj in zip(p, half, g)]
        xq = [xj + ej * pj for xj, ej, pj in zip(xq, eps, p)]
        logp_prop, g = value_grad(xq)
        p = [pj + hj * gj for pj, hj, gj in zip(p, half, g)]
    kin0, kinf = p0[0] * p0[0], p[0] * p[0]
    for j in range(1, len(p)):
        kin0 = kin0 + p0[j] * p0[j]
        kinf = kinf + p[j] * p[j]
    log_alpha = (beta * logp_prop - 0.5 * kinf) - (beta * logp - 0.5 * kin0)
    log_alpha = torch.where(torch.isnan(log_alpha), -3.0e38, log_alpha)
    return xq, logp_prop, list(g), log_alpha


def with_diag_rows(rows: torch.Tensor, outs: PhaseOutputs,
                   chain_pilots: torch.Tensor) -> torch.Tensor:
    """``rows`` with the blocks' diagnostic rows after them, when the run
    has diagnostics."""
    diag = outs.rows(chain_pilots, rows.shape[2])
    return rows if diag is None else torch.cat([rows, diag], dim=1)


def mcmc_cuda(
    program: McmcProgram,
    cfg: McmcConfig,
    params: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[DimTables] = None,
    segment: int = 0,
    start: Optional[ChainStart] = None,
) -> McmcOutput:
    """Runs the grid's chains on ``params``' device, with ``tables`` (on
    the same device) for a CUSTOM proposal or target, under the seed word
    of ``segment``, from ``start`` when ``cfg`` resumes.

    A CUDA ``params`` launches the kernel: ``mcmc_cuda.launches`` counts
    the chain-kernel launches, and ``mcmc_cuda.pilot_launches`` the pilot
    kernel's, which an error-bar or diagnostics run launches first;
    ``mcmc_cuda.diag_launches`` and ``mcmc_cuda.sample_launches`` count
    the chain launches with diagnostics and with draws,
    ``mcmc_cuda.hmc_launches`` and ``mcmc_cuda.state_launches`` those of
    HMC and of stateful runs.  A CPU ``params`` runs the plain version.
    Any other device raises.  The launches are asynchronous on the
    current stream."""
    _check_args(cfg, params, len(program.fns), tables)
    check_start(cfg, start, (grid.chains_actual,), params.device)
    if params.device.type == "cpu":
        return mcmc_reference(program.torch_fns, cfg, params, seed, grid,
                              tables, segment, start)
    if params.device.type != "cuda":
        raise ValueError(f"no MCMC kernel for device {params.device}")
    params = params.contiguous()
    kt = kernel_tables([tables], 1)
    host_tables = None if kt is None else ctypes.addressof(kt)
    lib = program.library(cfg)
    k = len(program.fns)
    dev = params.device
    word = seed_word(seed, segment)
    rows = torch.empty(
        (grid.chains_actual // CHAIN_THREADS, row_count(cfg), k + 1),
        dtype=torch.float32, device=dev,
    )
    x_final = torch.empty(grid.chains_actual, dtype=torch.float32, device=dev)
    logp_final = (torch.empty_like(x_final) if cfg.with_state else None)
    start = None if start is None else ChainStart(*(t.contiguous()
                                                    for t in start))
    samples = sample_buffer(cfg, (grid.chains_actual,), dev)
    pilots = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cfg.stat_mode:
            pilots = torch.empty(
                (grid.programs, k), dtype=torch.float32, device=dev
            )
            err = lib.tmc_mcmc_pilots(
                word, None, 1, params.data_ptr(), 0, host_tables,
                grid.chains_per_program, grid.programs, pilots.data_ptr(),
                stream,
            )
            _raise_on(lib, err, "pilot")
            mcmc_cuda.pilot_launches += 1
        err = lib.tmc_mcmc(
            word, None, 1, params.data_ptr(), 0, host_tables, cfg.n_burnin,
            cfg.n_steps, grid.chains_per_program, grid.chains_actual,
            None if pilots is None else pilots.data_ptr(),
            rows.data_ptr(), x_final.data_ptr(), *sample_args(cfg, samples),
            *state_args(start, logp_final), stream,
        )
        _raise_on(lib, err, "chain")
    count_launch(mcmc_cuda, cfg)
    return McmcOutput(rows, x_final, samples, logp_final)


mcmc_cuda.launches = 0
mcmc_cuda.pilot_launches = 0
mcmc_cuda.diag_launches = 0
mcmc_cuda.sample_launches = 0
mcmc_cuda.hmc_launches = 0
mcmc_cuda.state_launches = 0
mcmc_cuda.batch_launches = 0


def mcmc_batch(
    program: McmcProgram,
    cfg: McmcConfig,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: McmcGrid,
    tables: Optional[DimTables] = None,
) -> McmcOutput:
    """R stateless jobs in one launch (and one pilot launch under error
    bars): rep r runs the chains of :func:`mcmc_cuda` with the seed
    ``seeds[r]`` ((R,) int32 words on the params' device) and ``params``
    (6,) for every rep or its row of (R, 6).  Returns an
    :class:`McmcOutput` with a leading rep axis on its rows, final states
    and draws; each rep's are the unbatched run's, bit for bit.  A CUDA
    ``params`` launches the kernels (counted as :func:`mcmc_cuda` counts
    them, and in ``mcmc_cuda.batch_launches``); a CPU one runs the plain
    version rep by rep."""
    if cfg.with_state or cfg.with_diagnostics:
        raise ValueError("a batch runs stateless chains without diagnostics")
    k = len(program.fns)
    r, rowed = check_batch(params, seeds, None, (6,), k, False)
    _check_args(cfg, params[0] if rowed else params, k, tables)
    if params.device.type == "cpu":
        return plain_batch(
            lambda p, word: mcmc_reference(program.torch_fns, cfg, p, word,
                                           grid, tables),
            params, seeds, rowed)
    if params.device.type != "cuda":
        raise ValueError(f"no MCMC kernel for device {params.device}")
    params = params.contiguous()
    seeds = seeds.contiguous()
    kt = kernel_tables([tables], 1)
    host_tables = None if kt is None else ctypes.addressof(kt)
    lib = program.library(cfg)
    dev = params.device
    stride = 6 if rowed else 0
    rows = torch.empty(
        (r, grid.chains_actual // CHAIN_THREADS, row_count(cfg), k + 1),
        dtype=torch.float32, device=dev,
    )
    x_final = torch.empty((r, grid.chains_actual), dtype=torch.float32,
                          device=dev)
    samples = sample_buffer(cfg, (grid.chains_actual,), dev, (r,))
    pilots = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cfg.stat_mode:
            pilots = torch.empty((r, grid.programs, k), dtype=torch.float32,
                                 device=dev)
            err = lib.tmc_mcmc_pilots(
                0, seeds.data_ptr(), r, params.data_ptr(), stride,
                host_tables, grid.chains_per_program, grid.programs,
                pilots.data_ptr(), stream,
            )
            _raise_on(lib, err, "pilot")
            mcmc_cuda.pilot_launches += 1
        err = lib.tmc_mcmc(
            0, seeds.data_ptr(), r, params.data_ptr(), stride, host_tables,
            cfg.n_burnin, cfg.n_steps, grid.chains_per_program,
            grid.chains_actual, None if pilots is None else pilots.data_ptr(),
            rows.data_ptr(), x_final.data_ptr(), *sample_args(cfg, samples),
            None, None, None, stream,
        )
        _raise_on(lib, err, "chain")
    count_launch(mcmc_cuda, cfg)
    mcmc_cuda.batch_launches += 1
    return McmcOutput(rows, x_final, samples)


def state_args(start: Optional[ChainStart],
               logp_final: Optional[torch.Tensor]):
    """The chain entry point's (x0, logp0, logp_final) arguments: null
    where the run has none."""
    x0, logp0 = (None, None) if start is None else (
        start.x.data_ptr(), start.log_p.data_ptr())
    return x0, logp0, None if logp_final is None else logp_final.data_ptr()


def sample_buffer(cfg, shape, dev, lead=()) -> Optional[torch.Tensor]:
    """The draws' buffer of a run, (*lead, m, *shape) float32 (``lead``
    a batch's rep axis), or None."""
    if not cfg.samples:
        return None
    return torch.empty((*lead, cfg.samples, *shape), dtype=torch.float32,
                       device=dev)


def plain_batch(run, params: torch.Tensor, seeds: torch.Tensor,
                rowed: bool) -> McmcOutput:
    """A batch's plain version, rep by rep: ``run(params, word)`` with
    each rep's params (its row where ``rowed``) and seed word, the
    outputs stacked on a leading rep axis."""
    outs = [run(params[i] if rowed else params, int(w) & MASK32)
            for i, w in enumerate(seeds.tolist())]
    return McmcOutput(
        torch.stack([o.rows for o in outs]),
        torch.stack([o.x_final for o in outs]),
        None if outs[0].samples is None
        else torch.stack([o.samples for o in outs]))


def sample_args(cfg, samples: Optional[torch.Tensor]):
    """The chain entry point's (samples, m, stride) arguments."""
    if samples is None:
        return None, 0, 0
    return samples.data_ptr(), cfg.samples, cfg.n_steps // cfg.samples


def count_launch(wrapper, cfg) -> None:
    """Adds one chain launch of ``cfg`` to ``wrapper``'s counts."""
    wrapper.launches += 1
    wrapper.diag_launches += int(bool(cfg.with_diagnostics))
    wrapper.sample_launches += int(bool(cfg.samples))
    if getattr(cfg, "hmc_leapfrog", 0):
        wrapper.hmc_launches += 1
    if getattr(cfg, "with_state", False):
        wrapper.state_launches += 1


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"MCMC {what} kernel launch failed: {lib.tmc_error_string(err)!r}"
        )


def mcmc_finish(out: McmcOutput, grid: McmcGrid, cfg: McmcConfig, k: int):
    """(values (K,), acceptance (), stderr (K,) or None), float32 tensors
    on the rows' device: the JAX wrapper's math (mcmc_pallas.py:1150-1166,
    :1286-1324) over CUDA blocks in place of programs.  Under error bars
    or diagnostics the values come from the blocks' centroids, as the JAX
    kernels' do; :func:`mcmc_diagnostics` gives split-R-hat and ESS.  The
    sums over blocks add in :func:`fixed_sum`'s order, the same as a
    batch's (:func:`mcmc_batch_finish`)."""
    values, acceptance, stderr = _finish(out.rows[None], grid, cfg, k)
    return values[0], acceptance[0], None if stderr is None else stderr[0]


def mcmc_batch_finish(out: McmcOutput, grid: McmcGrid, cfg: McmcConfig,
                      k: int):
    """(values (R, K), acceptance (R,), stderr (R, K) or None) of a
    :func:`mcmc_batch` run: each rep's are :func:`mcmc_finish`'s of the
    unbatched run, bit for bit, as every sum over blocks adds in
    :func:`fixed_sum`'s order."""
    return _finish(out.rows, grid, cfg, k)


def _finish(rows: torch.Tensor, grid: McmcGrid, cfg: McmcConfig, k: int):
    """:func:`mcmc_batch_finish` of (R, blocks, rows, K + 1) rows."""
    tot = fixed_sum(rows[:, :, 0], 1)
    chains = np.float32(grid.chains_actual)
    denom = float(chains * np.float32(cfg.n_steps))
    acceptance = tot[:, k] / denom
    if not cfg.stat_mode:
        return tot[:, :k] / denom, acceptance, None
    n_b = float(CHAIN_THREADS)
    mb = rows[:, :, 2, :k]
    values = fixed_sum(n_b * mb, 1) / float(chains)
    if not cfg.with_stderr:
        return values, acceptance, None
    ss_total = fixed_sum(rows[:, :, 1, :k] + n_b * (mb - values[:, None]) ** 2,
                         1)
    var = ss_total / float(max(chains - np.float32(1.0), np.float32(1.0)))
    return values, acceptance, torch.sqrt(var / float(chains))


def mcmc_diagnostics(out: McmcOutput, grid: McmcGrid, cfg, k: int):
    """(r_hat (K,), ess (K,)) float32 of a diagnostics run (any of the
    three kernels), or None without diagnostics."""
    if not cfg.with_diagnostics:
        return None
    return diag_combine(out.rows, grid.chains_actual, cfg.n_steps, k)
