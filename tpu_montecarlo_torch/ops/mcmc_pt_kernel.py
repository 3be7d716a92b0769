"""Parallel tempering (replica exchange): the plain PyTorch version and the
CUDA kernel's wrapper.

Port of ``tpu_montecarlo/ops/mcmc_pt_pallas.py``
(``build_pt_mcmc_fn_pallas``) in its independence, random-walk and
adaptive random-walk modes, with and without error bars, for d dimensions
of the uniform, normal and exponential families, the seven extended
families and CUSTOM tables (target dimensions, and proposal dimensions on
every route of ``api/device.py``: sampler mode, gapped, knots, full;
their logq is rung-independent and swaps with the state)
under a product target or a
traced joint log density, and a ladder of T >= 2 rungs.  Each chain
carries its whole ladder: rung t runs against ``pi^beta_t`` with
``beta_0 = 1``, and only the cold rung enters the estimates.  Both
versions here run, ladder for ladder, the chains that the JAX kernel runs
under ``CounterRng`` (its interpreter stream):

* each program's stream is seeded with (seed ^ 0x165667B1, program);
* rung t, dimension j draws its initial state at counter 0 and its
  proposal (or the walk's normal step) at 3i+1 under tag ``t*d + j``;
  rung t's accept uniform, from (0, 1], at 3i+2 under tag t; pair
  (t, t+1)'s swap uniform, from [0, 1), at 3i+3 under tag t; i counts
  through burn-in and sampling;
* every rung moves, with acceptance ``beta_t * (logp' - logp)`` (walk) or
  ``beta_t * (logp' - logp) + logq - logq'`` (independence), then the
  pairs of i's parity exchange x, logp and logq when
  ``log(max(v, 1e-38)) < (beta_t - beta_{t+1}) * (logp_{t+1} - logp_t)``,
  then the integrands are evaluated at the cold rung's post-swap state;
* the adaptive walk carries one log scale per rung, which stays with its
  rung through swaps, and samples with ``exp(log(exp(ls)))``;
* tempered HMC (``hmc_leapfrog``, ``mcmc_pt_pallas.py:465-500``) moves
  rung t by the leapfrog of ``ops/mcmc_kernel.py`` ``hmc_move`` under
  the force ``beta_t * grad log pi``: the walk's
  normal steps are its momenta, the half-kicks ``(0.5 * beta_t) * eps_j
  * g_j``, and ``log_alpha = (beta_t logp' - 0.5 |p'|^2) - (beta_t logp -
  0.5 |p0|^2)``, NaN taken as -3e38; each rung carries its gradient,
  which the exchanges swap with x and logp.

Only last-bit differences of ``log``, ``exp`` and ``erfinv`` between
libraries can flip a decision.  The parameters are the nd kernel's (d, 6)
float32 rows (``ops/mcmc_nd_kernel.py``); the ladder is a float32 vector
of the T betas and the T - 1 pair differences, each rounded from float64
(:func:`pack_ladder`), so a new ladder needs no new build.  The output
rows are the 1-D kernel's with one more column, the swap count; the
diagnostics and the draws (``ops/mcmc_diagnostics.py``) are the cold
rung's, at its post-swap states.

On the card a chain's rungs run on lanes of a warp, or its whole ladder
on one thread, as its :class:`PtLayout` says (``csrc/mcmc_pt.cu``); the
layout changes no number the kernel computes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..sampling import normal_from_u01
from .integrate_kernel import (
    LANES,
    CounterRng,
    uniform_halfopen01,
    uniform_open01,
)
from .mcmc_kernel import (
    CHAIN_THREADS,
    McmcGrid,
    McmcOutput,
    Mode,
    block_rows,
    hmc_move,
    mcmc_batch_finish,
    plain_batch,
)
from .mcmc_diagnostics import PhaseOutputs
from .mcmc_nd_kernel import (
    _LOG_SCALE_MAX,
    _LOG_SCALE_MIN,
    McmcNdConfig,
    McmcNdProgram,
    check_nd_batch,
    check_program,
    draw_proposal,
    launch_chains,
    log_target,
    log_target_grad,
)
from .mcmc_tables import DimTables
from .mcmc_nd_kernel import _check_args as _check_nd_args
from .reduce import fixed_sum

__all__ = [
    "LADDER_LAYOUT",
    "MAX_PT_FUNCTIONS",
    "PT_HMC_GROUP",
    "PT_SEED_MIX",
    "McmcPtConfig",
    "McmcPtProgram",
    "PtLayout",
    "check_pt_layout",
    "default_pt_layout",
    "mcmc_pt_batch",
    "mcmc_pt_cuda",
    "mcmc_pt_reference",
    "pack_ladder",
    "pt_attempted_swaps",
    "pt_batch_finish",
    "pt_finish",
    "pt_layout_source",
    "pt_seed_word",
    "rung_lanes",
]

#: The tempered stream family's seed mix (mcmc_pt_pallas.py:81).
PT_SEED_MIX = 0x165667B1
#: Two lanes of the JAX kernel's output row hold the accept and swap
#: counts (mcmc_pt_pallas.py:304-307).
MAX_PT_FUNCTIONS = LANES - 2


class PtLayout(NamedTuple):
    """How the tempered kernel runs a chain's ladder on the card
    (``csrc/mcmc_pt.cu``): ``rung_lanes`` is 1, the whole ladder on one
    thread, or T' (:func:`rung_lanes`), rung t on its own ``lanes``
    consecutive lanes of a warp, each making ``group`` of the rung's
    x-free draws ahead of every round of ``lanes * group`` decisions."""

    rung_lanes: int
    lanes: int
    group: int


#: One thread per ladder, its T rung moves one after another: the layout
#: of any T, and the one above 32 rung lanes.
LADDER_LAYOUT = PtLayout(1, 1, 1)
# The defaults, from sweeps on an H100 (tools/mcmc_layout_sweep.py;
# PERF.md): lanes per rung, at most 4 under an independence proposal (its
# candidates spread) and 2 for a walk, and at most 16 lanes a chain; and
# at most 32 integrand evaluations per round of group * lanes steps (a
# round's steps are unrolled; past that the time grew, to twice at K =
# 126, with no spills), at most 4 steps' draws ahead per lane.
_MAX_LANES = {Mode.INDEPENDENCE: 4, Mode.RANDOM_WALK: 2, Mode.ADAPTIVE: 2}
_MAX_CHAIN_LANES = 16
_MAX_ROUND_VALUES = 32
_MAX_GROUP = 4
#: Tempered HMC's rung moves are L gradient evaluations on the carried
#: chain: one lane per rung (a second lane would repeat the trajectory),
#: and 2 steps' draws ahead, the fastest of groups 1, 2, 4 and 8 at c12b
#: on an H100 (``chip_smoke.py`` phase 53; ``PERF.md``); the ladder
#: layout ran 3.7x slower there.
PT_HMC_GROUP = 2


def rung_lanes(n_temps: int) -> int:
    """T', the lanes of a chain's rungs: the smallest power of two >= T."""
    return 1 << (int(n_temps) - 1).bit_length()


def check_pt_layout(n_temps: int, layout) -> PtLayout:
    """``layout`` as a :class:`PtLayout`, or ValueError when the kernel
    cannot run it for ``n_temps`` rungs."""
    layout = PtLayout(*layout)
    if layout == LADDER_LAYOUT:
        return layout
    t_lanes = rung_lanes(n_temps)
    if layout.rung_lanes == 1:
        raise ValueError(
            "the ladder layout runs one lane and a group of 1, got "
            f"{tuple(layout)}"
        )
    if layout.rung_lanes != t_lanes:
        raise ValueError(
            f"{n_temps} rungs take rung lanes 1 (the ladder) or {t_lanes}, "
            f"got {layout.rung_lanes}"
        )
    if not (layout.lanes >= 1 and 32 % (t_lanes * layout.lanes) == 0
            and layout.group >= 1):
        raise ValueError(
            f"a chain's {t_lanes} x {layout.lanes} lanes must divide a warp "
            f"of 32 and the group be at least 1, got {tuple(layout)}"
        )
    return layout


def default_pt_layout(mode: Mode, n_temps: int, k: int,
                      hmc: bool = False) -> PtLayout:
    """The layout a tempered kernel of ``mode``, ``n_temps`` rungs and
    ``k`` integrands compiles in (``hmc``: tempered HMC): the ladder past
    32 rung lanes, else rungs on lanes (the sweeps found no mode or K
    where the ladder was faster); under HMC one lane per rung and
    PT_HMC_GROUP steps' draws ahead."""
    t_lanes = rung_lanes(n_temps)
    if t_lanes > 32:
        return LADDER_LAYOUT
    if hmc:
        return PtLayout(t_lanes, 1, PT_HMC_GROUP)
    steps = max(1, _MAX_ROUND_VALUES // k)  # per round
    lanes = max(1, min(_MAX_LANES[Mode(mode)], _MAX_CHAIN_LANES // t_lanes,
                       steps))
    return PtLayout(t_lanes, lanes, max(1, min(_MAX_GROUP, steps // lanes)))


def pt_layout_source(layout: PtLayout) -> str:
    """The layout's lines in the generated kernel source."""
    return (f"#define TMC_PT_RUNG_LANES {layout.rung_lanes}\n"
            f"#define TMC_PT_LANES {layout.lanes}\n"
            f"#define TMC_PT_GROUP {layout.group}\n")


def pt_seed_word(seed: int) -> int:
    """The tempered kernel's seed word: the seed as uint32 (``np.uint32``
    rejects seeds outside [0, 2**32), as the JAX package does) xor
    0x165667B1."""
    return int(np.uint32(seed)) ^ PT_SEED_MIX


def pt_attempted_swaps(n_temps: int, n_iters: int, chains: int) -> int:
    """Attempted adjacent exchanges over a run (mcmc_pt_pallas.py:127-136):
    even iterations attempt the pairs (0, 1), (2, 3), ..., odd ones (1, 2),
    (3, 4), ..., on every chain, burn-in included."""
    n_pairs_even = n_temps // 2
    n_pairs_odd = (n_temps - 1) // 2
    n_even = (n_iters + 1) // 2
    n_odd = n_iters // 2
    return chains * (n_even * n_pairs_even + n_odd * n_pairs_odd)


def pack_ladder(betas: Sequence[float]) -> np.ndarray:
    """The (2T - 1,) float32 ladder the kernels read: the T betas, then the
    pair differences ``beta_t - beta_{t+1}`` taken in float64 and rounded
    (rounding the two betas first can give another float32)."""
    b = np.asarray(betas, np.float64)
    return np.concatenate([b, b[:-1] - b[1:]]).astype(np.float32)


@dataclass(frozen=True)
class McmcPtConfig(McmcNdConfig):
    """What one tempered run does: the nd config's fields
    (``ops/mcmc_nd_kernel.py``) and ``n_temps``, the rungs (keyword)."""

    _what = "tempering"

    n_temps: int = field(kw_only=True)

    def __post_init__(self):
        super().__post_init__()
        if self.n_temps < 2:
            raise ValueError(
                f"a ladder has at least 2 rungs, got {self.n_temps}"
            )

    @property
    def compiled(self):
        """What the CUDA library compiles in: mode, d, the families and
        the rungs."""
        return (*super().compiled, self.n_temps)


class McmcPtProgram(McmcNdProgram):
    """The nd program (``ops/mcmc_nd_kernel.py``: ``torch_fns``,
    ``torch_target`` and the CUDA library, built at first use) for the
    tempered kernel, which also compiles in the rung count and a
    :class:`PtLayout` (``layout``, by default :func:`default_pt_layout`'s
    for the mode, rungs and integrand count)."""

    kernel_source = "mcmc_pt.cu"
    max_functions = MAX_PT_FUNCTIONS
    entry_points = ("tmc_mcmc_pt_pilots", "tmc_mcmc_pt")
    chain_inputs = ("params", "ladder")
    takes_state = False
    #: The count columns after the K values: accepts and swaps.
    count_columns = 2
    kernel_name = "tempered MCMC"
    layout_source = staticmethod(pt_layout_source)

    def _layout(self, cfg, layout) -> PtLayout:
        n_temps = self.compiled[-1]
        if layout is None:
            return default_pt_layout(cfg.mode, n_temps, len(self.fns),
                                     bool(cfg.hmc_leapfrog))
        return check_pt_layout(n_temps, layout)

    def source(self) -> str:
        return super().source() + f"#define TMC_T {self.compiled[-1]}\n"


def _check_args(
    cfg: McmcPtConfig, params: torch.Tensor, ladder: torch.Tensor, k: int,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
) -> None:
    _check_nd_args(cfg, params, k, MAX_PT_FUNCTIONS, tables)
    n = 2 * cfg.n_temps - 1
    if ladder.dtype != torch.float32 or ladder.shape != (n,):
        raise ValueError(
            f"ladder must be a ({n},) float32 tensor, got "
            f"{tuple(ladder.shape)} {ladder.dtype}"
        )
    if ladder.device != params.device:
        raise ValueError(
            f"ladder on {ladder.device} but params on {params.device}"
        )


def mcmc_pt_reference(
    torch_fns: Sequence[Callable],
    torch_target: Optional[Callable],
    cfg: McmcPtConfig,
    params: torch.Tensor,
    ladder: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
    torch_target_grad: Optional[Callable] = None,
) -> McmcOutput:
    """Plain PyTorch version of the kernel, on ``params``' device:
    vectorised over the rungs (a leading T dimension) and all chains, a
    Python loop over the steps, with the kernel's counters, tags and
    float32 operation order; ``tables`` and ``torch_target_grad`` as the
    nd version's.  Returns the kernel's rows and ``x_final``, the cold
    rung's final states, as (d, chains)."""
    _check_args(cfg, params, ladder, len(torch_fns), tables)
    if (torch_target is None) != (cfg.targ_kinds is not None):
        raise ValueError("a joint target needs its log density, a product none")
    if cfg.hmc_leapfrog and (torch_target_grad is None) != (
            torch_target is None):
        raise ValueError("HMC over a joint target needs its gradient")
    dev = params.device
    d, n_temps = cfg.d, cfg.n_temps
    shape = (grid.rows, LANES)
    pids = torch.arange(grid.programs, dtype=torch.int64, device=dev)
    rng = CounterRng(pt_seed_word(seed), pids, device=dev)
    q1, q2, q3, q4, t1, t2 = params.unbind(dim=1)
    beta = ladder[:n_temps].reshape(n_temps, 1, 1, 1)
    dbeta = ladder[n_temps:]
    rungs = torch.arange(n_temps, dtype=torch.int64, device=dev)[:, None]
    # Draws of all rungs at once: a (T, 1) tag gives (T, programs, rows,
    # 128) blocks.
    dims = range(d)
    indep = cfg.mode == Mode.INDEPENDENCE
    adaptive = cfg.mode == Mode.ADAPTIVE

    def propose(counter):
        return draw_proposal(cfg, q1, q2, rng, shape, counter,
                             [rungs * d + j for j in dims], tables)

    def lp_t(xs):
        return log_target(torch_target, cfg.targ_kinds, t1, t2, xs, tables)

    def values(xs):
        return [f(*xs).to(torch.float32) for f in torch_fns]

    def value_grad(xs):
        return log_target_grad(torch_target_grad, cfg.targ_kinds, t1, t2, xs,
                               tables)

    if indep:
        xs, logq = propose(0)
    else:
        xs = [
            q2[j] + (q3[j] - q2[j])
            * uniform_halfopen01(rng, shape, 0, rungs * d + j)
            for j in dims
        ]
    logp = lp_t(xs)
    k = len(torch_fns)
    if cfg.stat_mode:
        n_block = float(grid.chains_per_program)
        pilots = [
            v.sum(dim=(1, 2), keepdim=True) / n_block
            for v in values([x[0] for x in xs])
        ]
    else:
        pilots = [torch.zeros((grid.programs, 1, 1), device=dev)] * k
    outs = PhaseOutputs(cfg.n_steps, cfg.with_diagnostics, cfg.samples, k,
                        xs[0][0])

    # Each parity's pairs (t, t+1): the t, the t + 1 and the pairs' beta
    # differences.
    pairs = []
    for parity in (0, 1):
        lo = torch.arange(parity, n_temps - 1, 2, dtype=torch.int64, device=dev)
        pairs.append((lo, lo + 1, dbeta[lo].reshape(-1, 1, 1, 1)))

    def exchange(a, lo, hi, swap):
        a = a.clone()
        a_lo, a_hi = a[lo], a[hi]
        a[lo] = torch.where(swap, a_hi, a_lo)
        a[hi] = torch.where(swap, a_lo, a_hi)
        return a

    eps = [q1[j] for j in dims]  # the walk's step vector, per rung
    if cfg.hmc_leapfrog:
        g = value_grad(xs)[1]
    log_scale = torch.zeros_like(xs[0])
    accs = [torch.zeros_like(xs[0][0]) for _ in range(k)]
    n_acc = torch.zeros_like(xs[0][0])
    swaps = torch.zeros_like(xs[0][0])
    for i in range(cfg.n_burnin + cfg.n_steps):
        burn = i < cfg.n_burnin
        if adaptive and burn:
            scale = torch.exp(log_scale)
            eps = [scale * q1[j] for j in dims]
        elif adaptive and i == cfg.n_burnin:
            # The JAX kernel keeps the scales' logs and exponentiates them
            # each step (mcmc_pt_pallas.py:756, :777, :712).
            scale = torch.exp(torch.log(torch.exp(log_scale)))
            eps = [scale * q1[j] for j in dims]
        if indep:
            xp, logq_prop = propose(3 * i + 1)
            logp_prop = lp_t(xp)
            log_alpha = beta * (logp_prop - logp) + logq - logq_prop
        elif cfg.hmc_leapfrog:
            z = [normal_from_u01(uniform_halfopen01(rng, shape, 3 * i + 1,
                                                    rungs * d + j))
                 for j in dims]
            xp, logp_prop, g_prop, log_alpha = hmc_move(
                xs, logp, g, z, eps, cfg.hmc_leapfrog, value_grad, beta)
        else:
            xp = [
                xs[j] + eps[j] * normal_from_u01(
                    uniform_halfopen01(rng, shape, 3 * i + 1, rungs * d + j)
                )
                for j in dims
            ]
            logp_prop = lp_t(xp)
            log_alpha = beta * (logp_prop - logp)
        u = uniform_open01(rng, shape, 3 * i + 2, rungs)
        accept = torch.log(u) < log_alpha
        xs = [torch.where(accept, a, b) for a, b in zip(xp, xs)]
        logp = torch.where(accept, logp_prop, logp)
        if indep:
            logq = torch.where(accept, logq_prop, logq)
        elif cfg.hmc_leapfrog:
            g = [torch.where(accept, a, b) for a, b in zip(g_prop, g)]
        if adaptive and burn:
            alpha_p = torch.exp(torch.clamp(log_alpha, max=0.0))
            i_f = torch.full((), float(i + 1), device=dev)
            gamma = torch.exp(-0.6 * torch.log(i_f))
            log_scale = torch.clamp(
                log_scale + gamma * (alpha_p - q4[0]),
                _LOG_SCALE_MIN, _LOG_SCALE_MAX,
            )
        lo, hi, dlo = pairs[i % 2]
        if len(lo):
            v = uniform_halfopen01(rng, shape, 3 * i + 3, lo[:, None])
            delta = dlo * (logp[hi] - logp[lo])
            swap = torch.log(torch.clamp(v, min=1e-38)) < delta
            xs = [exchange(x, lo, hi, swap) for x in xs]
            logp = exchange(logp, lo, hi, swap)
            if indep:
                logq = exchange(logq, lo, hi, swap)
            if cfg.hmc_leapfrog:
                g = [exchange(gj, lo, hi, swap) for gj in g]
            swaps = swaps + swap.to(torch.float32).sum(dim=0)
        if burn:
            continue
        n_acc = n_acc + accept[0].to(torch.float32)
        cold = [x[0] for x in xs]
        vals = [v - p for v, p in zip(values(cold), pilots)]
        accs = [a + v for a, v in zip(accs, vals)]
        outs.add(i - cfg.n_burnin, vals, cold)

    acc = torch.stack([a.reshape(-1) for a in accs], dim=1)
    chain_pilots = torch.stack(
        [p.expand_as(accs[0]).reshape(-1) for p in pilots], dim=1
    )
    rows = block_rows(acc, n_acc.reshape(-1), chain_pilots, cfg.n_steps)
    block_swaps = swaps.reshape(-1, CHAIN_THREADS).sum(dim=1)
    swap_col = torch.zeros_like(rows[:, :, :1])
    swap_col[:, 0, 0] = block_swaps
    rows = torch.cat([rows, swap_col], dim=2)
    diag = outs.rows(chain_pilots, k + 2)
    if diag is not None:
        rows = torch.cat([rows, diag], dim=1)
    return McmcOutput(
        rows, torch.stack([x[0].reshape(-1) for x in xs]), outs.samples()
    )


def mcmc_pt_cuda(
    program: McmcPtProgram,
    cfg: McmcPtConfig,
    params: torch.Tensor,
    ladder: torch.Tensor,
    seed: int,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
) -> McmcOutput:
    """Runs the grid's ladders on ``params``' device, with ``tables`` (on
    the same device) where a dimension is CUSTOM.

    A CUDA ``params`` launches the kernel: ``mcmc_pt_cuda.launches``
    counts the chain-kernel launches, and ``mcmc_pt_cuda.pilot_launches``
    the pilot kernel's, which an error-bar or diagnostics run launches
    first; ``diag_launches`` and ``sample_launches`` the chain launches
    with diagnostics and with the cold rung's draws, ``hmc_launches``
    those of tempered HMC and ``batch_launches`` those of
    :func:`mcmc_pt_batch`.  A CPU
    ``params`` runs the plain version.  Any other device raises.  The
    launches are asynchronous on the current stream."""
    check_program(program, cfg)
    _check_args(cfg, params, ladder, len(program.fns), tables)
    if params.device.type == "cpu":
        return mcmc_pt_reference(
            program.torch_fns, program.torch_target, cfg, params, ladder,
            seed, grid, tables, program.torch_target_grad,
        )
    if params.device.type != "cuda":
        raise ValueError(f"no tempered MCMC kernel for device {params.device}")
    return launch_chains(program, cfg, params, grid, tables,
                         pt_seed_word(seed), mcmc_pt_cuda, (ladder,))


mcmc_pt_cuda.launches = 0
mcmc_pt_cuda.pilot_launches = 0
mcmc_pt_cuda.diag_launches = 0
mcmc_pt_cuda.sample_launches = 0
mcmc_pt_cuda.hmc_launches = 0
mcmc_pt_cuda.batch_launches = 0


def mcmc_pt_batch(
    program: McmcPtProgram,
    cfg: McmcPtConfig,
    params: torch.Tensor,
    ladder: torch.Tensor,
    seeds: torch.Tensor,
    grid: McmcGrid,
    tables: Optional[Sequence[Optional[DimTables]]] = None,
) -> McmcOutput:
    """R tempered jobs under one ladder in one launch (and one pilot
    launch under error bars): rep r runs the ladders of
    :func:`mcmc_pt_cuda` with the seed ``seeds[r]`` ((R,) int32 words on
    the params' device) and ``params`` (d, 6) for every rep or its row of
    (R, d, 6).  Returns an :class:`McmcOutput` with a leading rep axis on
    its rows and final cold states (R, d, chains); each rep's are the
    unbatched run's, bit for bit, and :func:`pt_batch_finish` finishes
    them.  Draws and diagnostics run one job at a time, as the JAX
    kernel's (``mcmc_pt_pallas.py:286-304``).  A CUDA ``params`` launches
    the kernels (counted as :func:`mcmc_pt_cuda` counts them, and in
    ``mcmc_pt_cuda.batch_launches``); a CPU one runs the plain version
    rep by rep."""
    if cfg.samples:
        raise ValueError("a tempered batch takes no draws")
    check_program(program, cfg)
    k = len(program.fns)
    r, rowed = check_nd_batch(cfg, params, seeds, k)
    _check_args(cfg, params[0] if rowed else params, ladder, k, tables)
    if params.device.type == "cpu":
        return plain_batch(
            lambda p, word: mcmc_pt_reference(
                program.torch_fns, program.torch_target, cfg, p, ladder, word,
                grid, tables, program.torch_target_grad),
            params, seeds, rowed)
    if params.device.type != "cuda":
        raise ValueError(f"no tempered MCMC kernel for device {params.device}")
    return launch_chains(program, cfg, params, grid, tables, 0, mcmc_pt_cuda,
                         (ladder,), seeds)


def pt_finish(out: McmcOutput, grid: McmcGrid, cfg: McmcPtConfig, k: int):
    """(values (K,), cold acceptance (), swap rate (), stderr (K,) or
    None), float32 tensors on the rows' device: the JAX wrapper's math
    (mcmc_pt_pallas.py:966-1006, :1056-1065) over CUDA blocks in place of
    programs.  The swap rate divides by the attempted exchanges of the
    whole run, burn-in included.  Every sum over blocks adds in
    ``fixed_sum``'s order, the same as a batch's (:func:`pt_batch_finish`)."""
    values, acceptance, swap_rate, stderr = pt_batch_finish(
        McmcOutput(out.rows[None], out.x_final), grid, cfg, k)
    return (values[0], acceptance[0], swap_rate[0],
            None if stderr is None else stderr[0])


def pt_batch_finish(out: McmcOutput, grid: McmcGrid, cfg: McmcPtConfig,
                    k: int):
    """(values (R, K), cold acceptance (R,), swap rate (R,), stderr (R, K)
    or None) of a :func:`mcmc_pt_batch` run: each rep's are
    :func:`pt_finish`'s of the unbatched run, bit for bit."""
    values, acceptance, stderr = mcmc_batch_finish(out, grid, cfg, k)
    attempted = pt_attempted_swaps(
        cfg.n_temps, cfg.n_burnin + cfg.n_steps, grid.chains_actual
    )
    denom = float(np.float32(max(float(attempted), 1.0)))
    swap_rate = fixed_sum(out.rows[:, :, 0, k + 1], 1) / denom
    return values, acceptance, swap_rate, stderr
