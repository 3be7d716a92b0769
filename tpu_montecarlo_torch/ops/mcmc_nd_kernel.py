"""Multi-dimensional Metropolis-Hastings: the plain PyTorch version and
the CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/mcmc_nd_pallas.py`` (``build_mcmc_nd_pallas``)
in its independence, random-walk and adaptive random-walk modes, with
HMC (``hmc_leapfrog``: the walk's step becomes an L-step leapfrog
trajectory over the d dimensions), with and without error bars, with
chain state in and out (``with_state``,
``use_init_state``: the JAX package runs nd state on its XLA sweep keyed
on ``jax.random``, ``tpu_montecarlo/api/mcmc_nd.py:431-533``; the port
keeps it in this kernel under the counter stream, the resumed segment
folded into the seed word as the 1-D kernel folds it), for d dimensions
of the uniform, normal and
exponential families, the seven extended families and CUSTOM tables
(``ops/mcmc_tables.py``: target dimensions, and proposal dimensions in
sampler mode or gapped) under a
product target or a traced joint log density.  Both versions here run,
chain for chain, the chains that the JAX kernel runs under ``CounterRng``
(its interpreter stream): each program's stream seeded with (seed ^
0x27D4EB2F, program), dimension j drawn under tag j at counter 0 (the
initial state) and 3i+1 (step i's proposal), the accept uniform under tag
0 at 3i+2, and the same float32 operation order.  Only last-bit
differences of ``log``, ``exp`` and ``erfinv`` between libraries can flip
an accept decision.

The chain layout, the grid (``plan_mcmc_grid``) and the output rows are
the 1-D kernel's (``ops/mcmc_kernel.py``), so :func:`mcmc_finish` turns
the rows into estimates, the acceptance rate and the error bars.  The
parameters are one (d, 6) float32 row per dimension: the proposal's
(p1, p2, 0, 0) or the walk's (step, init_lo, init_hi, target_accept),
then the target's (p1, p2), zeros for a joint target.  The adaptive walk
tunes one per-chain scale of the whole step vector, starting at 1,
toward dimension 0's target_accept.  HMC draws the walk's d normal
steps as its momenta and moves by L kick-drift-kick leapfrog steps of
sizes ``eps_j = scale * step_j`` (a diagonal mass matrix), accepted on
the energy-corrected log ratio, NaN taken as -3e38
(``mcmc_nd_pallas.py:573-617``); the position gradient is the product's
closed forms and table slopes (``sampling.log_pdf_grad``,
``mcmc_tables.log_table_slope``) or the joint log density's reverse-mode
gradient (``ops/grad.py``).  The chain carries the gradient with x and
log p, so a step evaluates L gradients where the JAX kernel evaluates
L + 1, the first the same function of the same x.  A CUSTOM dimension's tables are
run-time arguments, one :class:`DimTables` entry per dimension; the
proposal's logq sums its sampler-mode dimensions first, in dimension
order, then the others, as the JAX kernel does
(``mcmc_nd_pallas.py:395-455``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sampling import DistKind, analytic_log_pdf, log_pdf_grad, normal_from_u01
from ..tracing import TracedFunction
from .integrate_kernel import (
    LANES,
    CounterRng,
    check_batch,
    sample_block,
    uniform_halfopen01,
    uniform_open01,
)
from .lower import (
    cuda_source,
    cuda_target_grad_source,
    cuda_target_source,
    to_torch,
    to_torch_grad,
)
from .mcmc_kernel import (
    CHAIN_THREADS,
    MAX_FUNCTIONS,
    ChainStart,
    Layout,
    McmcGrid,
    McmcOutput,
    Mode,
    block_rows,
    check_knots,
    check_layout,
    check_start,
    check_state,
    count_launch,
    default_layout,
    hmc_move,
    knots_source,
    layout_source,
    outputs_source,
    row_count,
    plain_batch,
    sample_args,
    sample_buffer,
    segment_word,
    state_args,
    state_source,
    with_diag_rows,
)
from .mcmc_diagnostics import PhaseOutputs, check_outputs
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
    "ND_SEED_MIX",
    "McmcNdConfig",
    "McmcNdProgram",
    "check_nd_batch",
    "check_program",
    "draw_proposal",
    "launch_chains",
    "log_target_grad",
    "mcmc_nd_batch",
    "mcmc_nd_cuda",
    "mcmc_nd_reference",
    "nd_seed_word",
]

#: The nd MCMC stream family's seed mix (mcmc_nd_pallas.py:79).
ND_SEED_MIX = 0x27D4EB2F
_LOG_SCALE_MIN = -13.815511
_LOG_SCALE_MAX = 13.815511
_ROW = 6  # floats per dimension in params


def nd_seed_word(seed: int, segment: int = 0) -> int:
    """The nd kernels' seed word: the seed as uint32 (``np.uint32``
    rejects seeds outside [0, 2**32), as the JAX package does) xor
    0x27D4EB2F, with a resumed ``segment`` folded in as the 1-D kernels'
    (``ops/mcmc_kernel.py`` ``segment_word``)."""
    return segment_word(int(np.uint32(seed)) ^ ND_SEED_MIX, segment)


@dataclass(frozen=True)
class McmcNdConfig:
    """What one nd run does.  ``prop_kinds``: the independence
    proposal's family per dimension, ``()`` for the walks;
    ``targ_kinds``: the product target's, or None for a joint log
    density; ``prop_gapped``: per proposal dimension, whether a CUSTOM
    one takes its logq from its log table (the gapped, table, knots and
    full routes of ``api/device.py``; else sampler mode; a stateful run's
    CUSTOM dimensions all read their log tables), ``()`` for none; ``with_diagnostics``,
    ``samples``, ``with_state``, ``use_init_state``,
    ``hmc_leapfrog`` (L > 0, a walk mode) and, per dimension, ``knots``
    (``()`` for none) as the 1-D config's (``ops/mcmc_kernel.py``)."""

    # The path, as messages name it.
    _what = "nd MCMC"

    mode: Mode
    d: int
    prop_kinds: Tuple[DistKind, ...]
    targ_kinds: Optional[Tuple[DistKind, ...]]
    n_steps: int
    n_burnin: int
    with_stderr: bool = False
    prop_gapped: Tuple[bool, ...] = ()
    with_diagnostics: bool = False
    samples: int = 0
    with_state: bool = False
    use_init_state: bool = False
    hmc_leapfrog: int = 0
    knots: Tuple[Tuple[bool, bool, bool], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "mode", Mode(self.mode))
        if self.hmc_leapfrog < 0 or (
                self.hmc_leapfrog and self.mode == Mode.INDEPENDENCE):
            raise ValueError("hmc_leapfrog requires a walk mode")
        for name in ("prop_kinds", "targ_kinds"):
            kinds = getattr(self, name)
            if kinds is not None:
                object.__setattr__(
                    self, name, tuple(DistKind(k) for k in kinds))
        if self.d < 1:
            raise ValueError(f"{self._what} takes d >= 1 dimensions, got {self.d}")
        indep = self.mode == Mode.INDEPENDENCE
        if len(self.prop_kinds) != (self.d if indep else 0):
            raise ValueError(
                "an independence proposal takes one family per dimension "
                "and a walk none"
            )
        gapped = tuple(bool(g) for g in self.prop_gapped) or (
            (False,) * len(self.prop_kinds))
        if len(gapped) != len(self.prop_kinds) or any(
                g and k != DistKind.CUSTOM
                for g, k in zip(gapped, self.prop_kinds)):
            raise ValueError(
                "prop_gapped takes one flag per proposal dimension, set only "
                "for CUSTOM ones"
            )
        object.__setattr__(self, "prop_gapped", gapped)
        knots = tuple(tuple(bool(k) for k in dim) for dim in self.knots)
        if knots and len(knots) != self.d:
            raise ValueError("knots takes one triple per dimension")
        if not any(any(dim) for dim in knots):
            knots = ()
        object.__setattr__(self, "knots", knots)
        if self.targ_kinds is not None and len(self.targ_kinds) != self.d:
            raise ValueError("a product target takes one family per dimension")
        if self.n_steps < 1 or self.n_burnin < 0:
            raise ValueError("n_steps must be positive and n_burnin non-negative")
        check_knots(knots, self.roles)
        check_outputs(self.n_steps, self.with_diagnostics, self.samples)
        check_state(self)
        if self.with_state and any(
                k == DistKind.CUSTOM and not g
                for k, g in zip(self.prop_kinds, gapped)):
            raise ValueError(
                "a stateful run takes its CUSTOM proposal dimensions' logq "
                "from their log tables (prop_gapped): its start has no draw")

    @property
    def state(self):
        """What the library compiles in for HMC and the chain state:
        (leapfrog steps, state out, state in)."""
        return (int(self.hmc_leapfrog), bool(self.with_state),
                bool(self.use_init_state))

    @property
    def outputs(self):
        """(diagnostics, draws): what the library compiles in besides the
        mode and families."""
        return bool(self.with_diagnostics), bool(self.samples)

    @property
    def stat_mode(self) -> bool:
        """Error bars or diagnostics: pilot-shifted sums, values from the
        blocks' centroids."""
        return bool(self.with_stderr or self.with_diagnostics)

    @property
    def compiled(self):
        """What the CUDA library compiles in: mode, d, the families and
        the CUSTOM proposal dimensions' routes (and :attr:`outputs`)."""
        return (self.mode, self.d, self.prop_kinds, self.targ_kinds,
                self.prop_gapped)

    @property
    def roles(self):
        """Per dimension: (proposal is CUSTOM, proposal is gapped, target
        is CUSTOM)."""
        props = self.prop_kinds or (None,) * self.d
        targs = self.targ_kinds or (None,) * self.d
        gapped = self.prop_gapped or (False,) * self.d
        return [(p == DistKind.CUSTOM, g, t == DistKind.CUSTOM)
                for p, g, t in zip(props, gapped, targs)]


class McmcNdProgram:
    """One integrand set and target, lowered both ways: ``torch_fns`` and
    ``torch_target`` (None for a product target) for the plain version,
    and the CUDA library, built at first use.  The library compiles in
    the mode, d and the families (``cfg.compiled``), as the JAX kernel is
    traced per family tuple, so a run's config must have the program's,
    and the :class:`Layout` (``layout``, by default
    :func:`default_layout`'s for the mode and integrand count), and the
    config's outputs (``cfg.outputs``)."""

    kernel_source = "mcmc_nd.cu"
    max_functions = MAX_FUNCTIONS
    #: The library's pilot and chain entry points.
    entry_points = ("tmc_mcmc_nd_pilots", "tmc_mcmc_nd")
    #: The chain entry point's device arrays before the run's sizes.
    chain_inputs = ("params",)
    #: Whether the chain entry point takes (x0, logp0, logp_final).
    takes_state = True
    #: The count columns after the K values of an output row: accepts.
    count_columns = 1
    #: What a failed launch calls the kernel.
    kernel_name = "nd MCMC"
    #: The layout's lines in the generated source.
    layout_source = staticmethod(layout_source)

    def __init__(
        self,
        fns: Sequence[TracedFunction],
        cfg: McmcNdConfig,
        target: Optional[TracedFunction] = None,
        layout: Optional[Layout] = None,
    ):
        if not 1 <= len(fns) <= self.max_functions:
            raise ValueError(
                f"{self.kernel_source} takes 1 to {self.max_functions} "
                f"functions, got {len(fns)}"
            )
        if any(f.n_args != cfg.d for f in fns):
            raise ValueError(
                f"every integrand must take {cfg.d} arguments, one per "
                "dimension"
            )
        if (target is None) != (cfg.targ_kinds is not None):
            raise ValueError(
                "a joint target needs its log density, a product target none"
            )
        if target is not None and target.n_args != cfg.d:
            raise ValueError(
                f"the joint log density must take {cfg.d} arguments"
            )
        self.fns = tuple(fns)
        self.target = target
        self.compiled = cfg.compiled
        self.knots = cfg.knots
        self.outputs = cfg.outputs
        self.state = cfg.state
        self.layout = self._layout(cfg, layout)
        self.torch_fns: List[Callable] = [to_torch(f) for f in fns]
        self.torch_target = None if target is None else to_torch(target)
        # HMC over a joint target: its value and gradient (ops/grad.py).
        self.torch_target_grad = (
            to_torch_grad(target)
            if target is not None and cfg.hmc_leapfrog else None)
        self._lib = None

    def _layout(self, cfg: McmcNdConfig, layout: Optional[Layout]) -> Layout:
        if layout is None:
            return default_layout(cfg.mode, len(self.fns),
                                  bool(cfg.hmc_leapfrog))
        return check_layout(cfg.mode, layout)

    def source(self) -> str:
        """The generated source the kernel includes: the integrands in the
        pointer form, the joint target, and the compiled-in mode, d and
        families."""
        mode, _, prop_kinds, targ_kinds, gapped = self.compiled[:5]

        def kinds(name, ks):
            return f"#define {name} {', '.join(str(int(k)) for k in ks)}\n"

        parts = [
            cuda_source(self.fns, pointer=True),
            f"#define TMC_MODE {int(mode)}\n",
        ]
        if self.layout is not None:
            parts.append(self.layout_source(self.layout))
        if prop_kinds:
            parts.append(kinds("TMC_PROP_KINDS", prop_kinds))
        if DistKind.CUSTOM in prop_kinds:
            parts.append(kinds("TMC_PROP_GAPPED", gapped))
        parts.append(knots_source(self.knots))
        if targ_kinds is None:
            parts.append(cuda_target_source(self.target))
            if self.state[0]:
                parts.append(cuda_target_grad_source(self.target))
        else:
            parts.append(kinds("TMC_TARG_KINDS", targ_kinds))
        parts.append(outputs_source(self.outputs))
        parts.append(state_source(self.state))
        return "".join(parts)

    def library(self):
        if self._lib is None:
            from .build import load_kernel_library

            lib = load_kernel_library(self.kernel_source, self.source())
            p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            pilots, chain = (getattr(lib, name) for name in self.entry_points)
            # seed word, seeds (R,) or null, reps, params, params stride,
            # host tables, chains per program, programs, pilots, stream
            pilots.argtypes = [u, p, i, p, i, p, i, i, p, p]
            # seed word, seeds (R,) or null, reps, params, params stride,
            # the other chain_inputs, host tables, burn-in, steps, chains
            # per program, chains, pilots, rows, x_final, samples, m,
            # stride, (x0, logp0, logp_final,) stream
            chain.argtypes = [u, p, i, p, i,
                              *[p] * (len(self.chain_inputs) - 1), p,
                              i, i, i, i, p, p, p, p, i, i,
                              *[p] * (3 * self.takes_state), p]
            pilots.restype = chain.restype = i
            self._lib = lib
        return self._lib


def _check_args(
    cfg: McmcNdConfig, params: torch.Tensor, k: int,
    max_functions: int = MAX_FUNCTIONS,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
) -> None:
    check_dim_tables(tables, cfg.roles, cfg._what, params.device, cfg.knots)
    if params.dtype != torch.float32 or params.shape != (cfg.d, _ROW):
        raise ValueError(
            f"params must be a ({cfg.d}, {_ROW}) float32 tensor, got "
            f"{tuple(params.shape)} {params.dtype}"
        )
    if not 1 <= k <= max_functions:
        raise ValueError(f"1 to {max_functions} functions, got {k}")


def _summed(logs):
    tot = logs[0]
    for lp in logs[1:]:
        tot = tot + lp
    return tot


def log_target(torch_target, targ_kinds, t1, t2, xs,
               tables=None) -> torch.Tensor:
    """The plain versions' target log density at the d blocks ``xs``: the
    joint target's, or the product's dimensions (closed forms, CUSTOM
    log tables) summed in order."""
    if torch_target is not None:
        return torch.broadcast_to(
            torch_target(*xs).to(torch.float32), xs[0].shape
        )
    return _summed([
        log_table_value(xs[j], tables[j].targ) if kind == DistKind.CUSTOM
        else analytic_log_pdf(kind, t1[j], t2[j], xs[j])
        for j, kind in enumerate(targ_kinds)
    ])


def log_target_grad(torch_target_grad, targ_kinds, t1, t2, xs,
                    tables=None):
    """HMC's position gradient at the d blocks ``xs``, with the target's
    log density: ``(log p, [d gradients])`` of the joint target (its
    ``to_torch_grad``), or of the product, each dimension's closed-form
    gradient or log table slope (``mcmc_nd_pallas.py:584-596``)."""
    if torch_target_grad is not None:
        return torch_target_grad(*xs)
    grads = [
        log_table_slope(xs[j], tables[j].targ) if kind == DistKind.CUSTOM
        else log_pdf_grad(kind, t1[j], t2[j], xs[j])
        for j, kind in enumerate(targ_kinds)
    ]
    return log_target(None, targ_kinds, t1, t2, xs, tables), grads


def draw_proposal(cfg, q1, q2, rng, shape, counter, tags, tables=None):
    """An independence proposal's d blocks at ``counter`` (dimension j
    under ``tags[j]``) and its log density: the sampler-mode dimensions'
    terms summed in dimension order, then the others' (closed forms,
    gapped log tables), then the two sums added
    (``mcmc_nd_pallas.py:395-455``)."""
    xs, drawn, rest = [], None, None
    for j, kind in enumerate(cfg.prop_kinds):
        if kind == DistKind.CUSTOM:
            u = uniform_halfopen01(rng, shape, counter, tags[j])
            x, slope = inverse_draw(u, tables[j].inv)
            if not cfg.prop_gapped[j]:
                lq = sampler_logq(slope, tables[j].inv)
                drawn = lq if drawn is None else drawn + lq
                xs.append(x)
                continue
            lq = log_table_value(x, tables[j].q)
        else:
            x = sample_block(kind, q1[j], q2[j], rng, shape, counter, tags[j])
            lq = analytic_log_pdf(kind, q1[j], q2[j], x)
        rest = lq if rest is None else rest + lq
        xs.append(x)
    if drawn is None:
        return xs, rest
    return xs, drawn if rest is None else drawn + rest


def log_proposal_at(cfg, q1, q2, xs, tables=None) -> torch.Tensor:
    """A stateful run's independence proposal log density at the d blocks
    ``xs`` (a resumed chain's start): its dimensions' closed forms and
    log tables summed in dimension order (no dimension is in sampler
    mode)."""
    return _summed([
        log_table_value(xs[j], tables[j].q) if kind == DistKind.CUSTOM
        else analytic_log_pdf(kind, q1[j], q2[j], xs[j])
        for j, kind in enumerate(cfg.prop_kinds)
    ])


def mcmc_nd_reference(
    torch_fns: Sequence[Callable],
    torch_target: Optional[Callable],
    cfg: McmcNdConfig,
    params: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
    segment: int = 0,
    start: Optional[ChainStart] = None,
    torch_target_grad: Optional[Callable] = None,
) -> McmcOutput:
    """Plain PyTorch version of the kernel, on ``params``' device:
    vectorised over all chains, a Python loop over the steps, with the
    kernel's counters, tags and float32 operation order.  ``tables``
    holds one :class:`DimTables` (or None) per dimension where any is
    CUSTOM; ``segment`` and ``start`` as the 1-D version's, x (d,
    chains); ``torch_target_grad``, HMC's value and gradient of a joint
    target (the program's).  Returns the kernel's rows and ``x_final`` as
    (d, chains)."""
    _check_args(cfg, params, len(torch_fns), tables=tables)
    if (torch_target is None) != (cfg.targ_kinds is not None):
        raise ValueError("a joint target needs its log density, a product none")
    if cfg.hmc_leapfrog and (torch_target_grad is None) != (
            torch_target is None):
        raise ValueError("HMC over a joint target needs its gradient")
    dev = params.device
    check_start(cfg, start, (cfg.d, grid.chains_actual), dev)
    shape = (grid.rows, LANES)
    pids = torch.arange(grid.programs, dtype=torch.int64, device=dev)
    rng = CounterRng(nd_seed_word(seed, segment), pids, device=dev)
    q1, q2, q3, q4, t1, t2 = params.unbind(dim=1)
    dims = range(cfg.d)
    indep = cfg.mode == Mode.INDEPENDENCE

    def propose(counter):  # d blocks of (programs, rows, 128), logq
        return draw_proposal(cfg, q1, q2, rng, shape, counter, range(cfg.d),
                             tables)

    def lp_t(xs):
        return log_target(torch_target, cfg.targ_kinds, t1, t2, xs, tables)

    def values(xs):
        return [f(*xs).to(torch.float32) for f in torch_fns]

    def value_grad(xs):
        return log_target_grad(torch_target_grad, cfg.targ_kinds, t1, t2, xs,
                               tables)

    if start is not None:
        xs = [start.x[j].reshape(grid.programs, *shape) for j in dims]
        logp = start.log_p.reshape(grid.programs, *shape)
        if indep:
            logq = log_proposal_at(cfg, q1, q2, xs, tables)
    else:
        if indep:
            xs, logq = propose(0)
        else:
            xs = [
                q2[j] + (q3[j] - q2[j]) * uniform_halfopen01(rng, shape, 0, j)
                for j in dims
            ]
        logp = lp_t(xs)
    k = len(torch_fns)
    if cfg.stat_mode:
        n_block = float(grid.chains_per_program)
        pilots = [v.sum(dim=(1, 2), keepdim=True) / n_block for v in values(xs)]
    else:
        pilots = [torch.zeros((grid.programs, 1, 1), device=dev)] * k
    outs = PhaseOutputs(cfg.n_steps, cfg.with_diagnostics, cfg.samples, k,
                        xs[0])

    eps = [q1[j] for j in dims]  # the walk's step vector
    if cfg.hmc_leapfrog:
        g = value_grad(xs)[1]
    log_scale = torch.zeros_like(xs[0])
    accs = [torch.zeros_like(xs[0]) for _ in range(k)]
    n_acc = torch.zeros_like(xs[0])
    for i in range(cfg.n_burnin + cfg.n_steps):
        burn = i < cfg.n_burnin
        if cfg.mode == Mode.ADAPTIVE and (burn or i == cfg.n_burnin):
            scale = torch.exp(log_scale)
            eps = [scale * q1[j] for j in dims]
        if indep:
            xp, logq_prop = propose(3 * i + 1)
            logp_prop = lp_t(xp)
            log_alpha = logp_prop + logq - logp - logq_prop
        elif cfg.hmc_leapfrog:
            z = [normal_from_u01(uniform_halfopen01(rng, shape, 3 * i + 1, j))
                 for j in dims]
            xp, logp_prop, g_prop, log_alpha = hmc_move(
                xs, logp, g, z, eps, cfg.hmc_leapfrog, value_grad)
        else:
            xp = [
                xs[j] + eps[j] * normal_from_u01(
                    uniform_halfopen01(rng, shape, 3 * i + 1, j)
                )
                for j in dims
            ]
            logp_prop = lp_t(xp)
            log_alpha = logp_prop - logp
        u = uniform_open01(rng, shape, 3 * i + 2, 0)
        accept = torch.log(u) < log_alpha
        xs = [torch.where(accept, a, b) for a, b in zip(xp, xs)]
        logp = torch.where(accept, logp_prop, logp)
        if indep:
            logq = torch.where(accept, logq_prop, logq)
        elif cfg.hmc_leapfrog:
            g = [torch.where(accept, a, b) for a, b in zip(g_prop, g)]
        if burn:
            if cfg.mode == Mode.ADAPTIVE:
                alpha_p = torch.exp(torch.clamp(log_alpha, max=0.0))
                i_f = torch.full((), float(i + 1), device=dev)
                gamma = torch.exp(-0.6 * torch.log(i_f))
                log_scale = torch.clamp(
                    log_scale + gamma * (alpha_p - q4[0]),
                    _LOG_SCALE_MIN, _LOG_SCALE_MAX,
                )
            continue
        vals = [v - p for v, p in zip(values(xs), pilots)]
        accs = [a + v for a, v in zip(accs, vals)]
        n_acc = n_acc + accept.to(torch.float32)
        outs.add(i - cfg.n_burnin, vals, xs)

    acc = torch.stack([a.reshape(-1) for a in accs], dim=1)
    chain_pilots = torch.stack(
        [p.expand_as(xs[0]).reshape(-1) for p in pilots], dim=1
    )
    rows = block_rows(acc, n_acc.reshape(-1), chain_pilots, cfg.n_steps)
    return McmcOutput(with_diag_rows(rows, outs, chain_pilots),
                      torch.stack([x.reshape(-1) for x in xs]),
                      outs.samples(),
                      logp.reshape(-1) if cfg.with_state else None)


def check_program(program, cfg) -> None:
    """ValueError unless ``program`` was built for what ``cfg`` compiles
    in: its mode, families, knot tables, outputs and state."""
    if ((cfg.compiled, cfg.knots, cfg.outputs, cfg.state)
            != (program.compiled, program.knots, program.outputs,
                program.state)):
        raise ValueError(
            f"the program was built for {program.compiled} with knots "
            f"{program.knots}, outputs {program.outputs} and state "
            f"{program.state}, not {cfg.compiled} with {cfg.knots}, "
            f"{cfg.outputs} and {cfg.state}"
        )


def mcmc_nd_cuda(
    program: McmcNdProgram,
    cfg: McmcNdConfig,
    params: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
    segment: int = 0,
    start: Optional[ChainStart] = None,
) -> McmcOutput:
    """Runs the grid's chains on ``params``' device, with ``tables`` (on
    the same device) where a dimension is CUSTOM, under the seed word of
    ``segment``, from ``start`` when ``cfg`` resumes.

    A CUDA ``params`` launches the kernel: ``mcmc_nd_cuda.launches``
    counts the chain-kernel launches, and ``mcmc_nd_cuda.pilot_launches``
    the pilot kernel's, which an error-bar or diagnostics run launches
    first; ``diag_launches`` and ``sample_launches`` the chain launches
    with diagnostics and with draws, ``hmc_launches`` those of HMC,
    ``state_launches`` the stateful ones and ``batch_launches`` those of
    :func:`mcmc_nd_batch`.  A CPU
    ``params`` runs the plain version.  Any other device raises.  The
    launches are asynchronous on the current stream."""
    check_program(program, cfg)
    _check_args(cfg, params, len(program.fns), tables=tables)
    check_start(cfg, start, (cfg.d, grid.chains_actual), params.device)
    if params.device.type == "cpu":
        return mcmc_nd_reference(
            program.torch_fns, program.torch_target, cfg, params, seed, grid,
            tables, segment, start, program.torch_target_grad,
        )
    if params.device.type != "cuda":
        raise ValueError(f"no nd MCMC kernel for device {params.device}")
    return launch_chains(program, cfg, params, grid, tables,
                         nd_seed_word(seed, segment), mcmc_nd_cuda,
                         start=start)


mcmc_nd_cuda.launches = 0
mcmc_nd_cuda.pilot_launches = 0
mcmc_nd_cuda.diag_launches = 0
mcmc_nd_cuda.sample_launches = 0
mcmc_nd_cuda.hmc_launches = 0
mcmc_nd_cuda.state_launches = 0
mcmc_nd_cuda.batch_launches = 0


def check_nd_batch(cfg: McmcNdConfig, params: torch.Tensor,
                   seeds: torch.Tensor, k: int) -> Tuple[int, bool]:
    """``(R, whether each rep has its params row)`` of an nd or tempered
    batch after the batch's own checks: a stateless run without
    diagnostics, ``seeds`` (R,) int32 words on the params' device and
    ``params`` one (d, 6) row for every rep or R of them."""
    if cfg.with_state or cfg.with_diagnostics:
        raise ValueError("a batch runs stateless chains without diagnostics")
    return check_batch(params, seeds, None, (cfg.d, _ROW), k, False)


def mcmc_nd_batch(
    program: McmcNdProgram,
    cfg: McmcNdConfig,
    params: torch.Tensor,
    seeds: torch.Tensor,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
) -> McmcOutput:
    """R stateless jobs in one launch (and one pilot launch under error
    bars): rep r runs the chains of :func:`mcmc_nd_cuda` with the seed
    ``seeds[r]`` ((R,) int32 words on the params' device) and ``params``
    (d, 6) for every rep or its row of (R, d, 6).  Returns an
    :class:`McmcOutput` with a leading rep axis on its rows, final states
    (R, d, chains) and draws (R, m, d, chains); each rep's are the
    unbatched run's, bit for bit, and :func:`mcmc_batch_finish` finishes
    them.  A CUDA ``params`` launches the kernels (counted as
    :func:`mcmc_nd_cuda` counts them, and in
    ``mcmc_nd_cuda.batch_launches``); a CPU one runs the plain version rep
    by rep."""
    check_program(program, cfg)
    k = len(program.fns)
    r, rowed = check_nd_batch(cfg, params, seeds, k)
    _check_args(cfg, params[0] if rowed else params, k, tables=tables)
    if params.device.type == "cpu":
        return plain_batch(
            lambda p, word: mcmc_nd_reference(
                program.torch_fns, program.torch_target, cfg, p, word, grid,
                tables, torch_target_grad=program.torch_target_grad),
            params, seeds, rowed)
    if params.device.type != "cuda":
        raise ValueError(f"no nd MCMC kernel for device {params.device}")
    return launch_chains(program, cfg, params, grid, tables, 0,
                         mcmc_nd_cuda, seeds=seeds)


def launch_chains(program, cfg, params, grid, tables, word, wrapper,
                  inputs=(), seeds=None, start=None) -> McmcOutput:
    """The pilot launch (under error bars or diagnostics) and the chain
    launch of ``program``'s library (the nd or the tempered kernel's) on
    CUDA ``params``, counted in ``wrapper``'s counts: one job under the
    seed word ``word`` (from ``start`` when ``cfg`` resumes), or with
    ``seeds`` ((R,) int32 words) R jobs, each with ``params`` or its row
    of (R, d, 6), whose outputs take a leading R axis.  ``inputs`` are the
    chain entry point's device arrays after the params (the ladder)."""
    params = params.contiguous()
    inputs = [t.contiguous() for t in inputs]
    kt = kernel_tables(tables, cfg.d)
    host_tables = None if kt is None else ctypes.addressof(kt)
    launch_pilots, launch_chain = (getattr(program.library(), name)
                                   for name in program.entry_points)
    k = len(program.fns)
    dev = params.device
    if seeds is not None:
        seeds = seeds.contiguous()
    lead = () if seeds is None else (len(seeds),)
    seed_args = ((word, None, 1) if seeds is None
                 else (word, seeds.data_ptr(), len(seeds)))
    param_args = (params.data_ptr(), cfg.d * _ROW if params.dim() == 3 else 0)
    rows = torch.empty(
        (*lead, grid.chains_actual // CHAIN_THREADS, row_count(cfg),
         k + program.count_columns),
        dtype=torch.float32, device=dev,
    )
    x_final = torch.empty((*lead, cfg.d, grid.chains_actual),
                          dtype=torch.float32, device=dev)
    logp_final = (torch.empty(grid.chains_actual, dtype=torch.float32,
                              device=dev) if cfg.with_state else None)
    start = None if start is None else ChainStart(*(t.contiguous()
                                                    for t in start))
    samples = sample_buffer(cfg, (cfg.d, grid.chains_actual), dev, lead)
    pilots = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cfg.stat_mode:
            pilots = torch.empty((*lead, grid.programs, k),
                                 dtype=torch.float32, device=dev)
            err = launch_pilots(
                *seed_args, *param_args, host_tables,
                grid.chains_per_program, grid.programs, pilots.data_ptr(),
                stream,
            )
            _raise_on(program, err, "pilot")
            wrapper.pilot_launches += 1
        err = launch_chain(
            *seed_args, *param_args, *(t.data_ptr() for t in inputs),
            host_tables, cfg.n_burnin, cfg.n_steps, grid.chains_per_program,
            grid.chains_actual,
            None if pilots is None else pilots.data_ptr(),
            rows.data_ptr(), x_final.data_ptr(), *sample_args(cfg, samples),
            *(state_args(start, logp_final) if program.takes_state else ()),
            stream,
        )
        _raise_on(program, err, "chain")
    count_launch(wrapper, cfg)
    wrapper.batch_launches += bool(lead)
    return McmcOutput(rows, x_final, samples, logp_final)


def _raise_on(program, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{program.kernel_name} {what} kernel launch failed: "
            f"{program.library().tmc_error_string(err)!r}"
        )
