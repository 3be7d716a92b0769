"""The cells ``chip_smoke.py`` drives: their integrands, densities,
shapes, closed forms and tolerances.

They live in a module of their own because the port's front end parses
the whole file that defines a traced function on every call: a short
file keeps each public call's host time to the call's own work.
"""

import math

import numpy as np

# bench.py's K=8 set (BASELINE.md config 2).
BENCH_FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: x * x * x,
    lambda x: x * x * x * x,
    lambda x: np.sin(x),
    lambda x: np.exp(-x * x),
    lambda x: x > 1.0,
    lambda x: abs(x),
]
# Closed forms under N(0, 1): E[f] and Var[f] for each bench integrand.
_P_GT1 = 0.5 * math.erfc(1.0 / math.sqrt(2.0))
BENCH_MEANS = [
    0.0, 1.0, 0.0, 3.0, 0.0, 1.0 / math.sqrt(3.0), _P_GT1,
    math.sqrt(2.0 / math.pi),
]
BENCH_VARS = [
    1.0, 2.0, 15.0, 96.0, (1.0 - math.exp(-2.0)) / 2.0,
    1.0 / math.sqrt(5.0) - 1.0 / 3.0, _P_GT1 * (1.0 - _P_GT1),
    1.0 - 2.0 / math.pi,
]
# The MCMC main path (BASELINE.md config 5 in its analytic form) and the
# integrand set its kernel is held against its plain version with.
MCMC_MAIN_FNS = [lambda x: x * x]
MCMC_CHECK_FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: np.sin(x),
    lambda x: x > 1.0,
]
MCMC_MAIN = dict(n_steps=10_000, n_chains=4096, n_burnin=1_000, seed=42)
MCMC_CHECK = dict(n_chains=4096, n_steps=1_000, n_burnin=200)
# The MCMC cells beside the three main paths (phases 31-33 over tables, 35
# and 37 over the families, 44-47 with diagnostics and draws, 48-49 under
# HMC) run, timed and held to their plain versions, at SHORT_MCMC's depth:
# MCMC_MAIN's chains and burn-in, 2,000 sampling steps where it has
# 10,000.  At the full depth their eleven plain versions take ~400 s of the
# script, which must end within 1,200 s on a slow host.  The chain-state
# phases (50-51) split the main path's own depth into two calls.
SHORT_MCMC = dict(MCMC_MAIN, n_steps=2_000)
# Kernel and plain version run the same chain means; their error bars
# differ by float32 summation order in the block SS, s2 - n_b*mean^2 of
# pilot-shifted chain means (1.5e-4 relative at the main shape on an H100);
# a wrong SS or centroid row moves them by 1.6% or more.
STDERR_RTOL = 1e-3
MAIN_SAMPLES = 1_000_000_000
CHECK_SAMPLES = 1 << 24
SEED = 42
RTOL, ATOL = 1e-5, 1e-6
# The 1-D kernel's modes (phases 24-26): the bench set at 2**30 samples
# under N(0, 1) in each, held against the plain version at 2**22 under the
# three families; rQMC as integrate() runs it, 8 rotations of 2**27.
MODE_SAMPLES = 1 << 30
MODE_CHECK_SAMPLES = 1 << 22
MODES_1D = {
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc_stderr": ("mc", True),
    "antithetic_stderr": ("antithetic", True),
}
RQMC_ROTATIONS = 8
# Kernel and plain version sum the same squares in other orders (the kernel
# fuses each square-add); an odd integrand's antithetic pairs cancel
# exactly and leave its error bar at float32 rounding (~1e-11) on both.
STDERR_1D_RTOL, STDERR_1D_ATOL = 1e-4, 1e-9
# Phase 25 scales ATOL and STDERR_1D_ATOL by each column's own size (its
# mean |value| on the pilot grid, or |mean| if larger): a rare-event column
# (config 4's mean is 3.2e-5) is then held to ~1e-5 of itself, as an O(1)
# column is, where a bare 1e-6 would let it be 3 % off.
# The importance-sampling main path, BASELINE.md config 4:
# P(X > 4) under N(0, 1) from the proposal N(4, 1.5), 1e8 samples.
IS_FNS = [lambda x: x > 4.0]
IS_SAMPLES = 100_000_000
IS_EXACT = 0.5 * math.erfc(4.0 / math.sqrt(2.0))  # 3.1671e-5
# BASELINE.md config 3 (benchmarks/run_all.py:148-170): Beta(2, 5) and a
# triangular from_pdf on [0, 2], 512-bin tables, 1e7 samples; closed forms
# E and Var of each integrand.
C3_SAMPLES = 10_000_000
C3_BETA_FNS = [lambda x: x, lambda x: x * x]
C3_BETA_MEANS = [2.0 / 7.0, 6.0 / 56.0]
C3_BETA_VARS = [10.0 / 392.0, 120.0 / 5040.0 - (6.0 / 56.0) ** 2]
C3_TRI_FNS = [lambda x: x]
C3_TRI_MEANS, C3_TRI_VARS = [1.0], [1.0 / 6.0]
C3_TOLERANCE = 0.01  # BASELINE.md's, at 1e7


def tri_pdf(x):
    """Config 3's triangular density on [0, 2], peaked at 1."""
    if 0 <= x <= 1:
        return x
    if 1 < x <= 2:
        return 2 - x
    return 0.0


def untraceable_pdf(x):
    """0.5 on (-1, 1): an int() cast on a data value does not trace, so
    importance sampling reads it from a pdf table."""
    return 0.5 if int(abs(x)) < 1 else 0.0


# The CUSTOM routes of phase 28 and importance sets with table weights.
CUSTOM_IS_FNS = [lambda x: x > 0.5, lambda x: x * x]


# nd main path 1: c9's set (benchmarks/run_all.py:338-354) at 1e9, with
# its closed forms under N(0,1) x U(0,1) x Exp(2): E and Var.
ND_FNS = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
ND_MEANS = [0.0, 2.0]
ND_VARS = [1.0 / 6.0, 2.0 + 1.0 / 12.0 + 1.0 / 4.0]
# nd main path 2: c9c's set (run_all.py:365-371), Sobol over U(0,1)^2,
# E = (e - 1)^2 and Var = ((e^2 - 1) / 2)^2 - (e - 1)^4.
QMC_FNS = [lambda x, y: np.exp(x) * np.exp(y)]
QMC_MEAN = (math.e - 1.0) ** 2
QMC_VAR = ((math.e ** 2 - 1.0) / 2.0) ** 2 - (math.e - 1.0) ** 4
QMC_ROTATIONS = 8
# Kernel and plain version sum the same squares in other orders; a wrong
# count of units or a dropped pair mean moves an error bar by 40 % or more.
ND_STDERR_RTOL = 1e-4
# nd MCMC (benchmarks/run_all.py:373-449): c9d's product target, c9e's
# joint target (the main path) and c10b's walk on it, at MCMC_MAIN's
# shape; and the integrand sets of phase 16, by dimension count.
C9D_FNS = [lambda x, y: x * x + y * y]
C9E_FNS = [lambda x, y: x * y]
ND_MCMC_CHECK_FNS = {
    1: [lambda x: x, lambda x: x * x],
    2: [lambda x, y: x * y, lambda x, y: x * x + y * y,
        lambda x, y: (x > 1.0) * y],
    4: [lambda a, b, c, d: a * b + c - d,
        lambda a, b, c, d: (a > 0.5) * b + c * d],
}


def c9e_target():
    """c9e's joint log density in ``run_all.py:386-390``'s form: a
    bivariate normal with rho = 0.8, its constants read from the
    closure."""
    rho9 = 0.8
    c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))
    return lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y)


def normal_target():
    """A 1-D joint log density: N(0, 1) up to its constant."""
    return lambda x: -0.5 * x * x


def logmix(x):
    """c12's target (``run_all.py:518-522``): 0.5 N(-4,1) + 0.5 N(4,1), up
    to its constant; E[x] = 0, E[x^2] = 17."""
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


# The tempered main path, c12 (run_all.py:518-540), at MCMC_MAIN's shape.
PT_FNS = [lambda x: x, lambda x: x * x]
PT_LADDER = [1.0, 2.0, 4.0, 8.0]
PT_EXACT = [0.0, 17.0]
# MCMC over CUSTOM tables (phases 30-33), at MCMC_MAIN's shape with error
# bars: BASELINE.md config 5 (run_all.py:184-218), E[x^2] = 5 within 6
# error bars and BASELINE's MCMC tolerance; c9f (run_all.py:401-416),
# E[xy] = 0; c12d (run_all.py:570-585), E[x] = 0, E[x^2] = 5.
C5_FNS = [lambda x: x * x]
C5_EXACT = [5.0]
C5_TOLERANCE = 0.2
C9F_FNS = [lambda x, y: x * y]
C9F_EXACT = [0.0]
C12D_FNS = [lambda x: x, lambda x: x * x]
C12D_EXACT = [0.0, 5.0]
# Split-R-hat, ESS and thinned draws (phases 44-47): the main paths, at
# SHORT_MCMC's depth, with DRAWS thinned draws; phase 45's slow-mixing run, tests/test_diagnostics.py
# :33's, whose R-hat must flag it.  Kernel and plain version sum the same
# half-chain values in other orders: R-hat within rel 1e-4, ESS within rel
# 1e-3.
DRAWS = 1000
# MCMC_CHECK's 1,000 steps over 300 draws: a stride of 3 and 100 steps past
# the last draw, run into a buffer DRAW_GUARD rows longer than its draws.
REMAINDER_DRAWS = 300
DRAW_GUARD = 64
SLOW_FNS = [lambda x: x]
SLOW_RUN = dict(n_steps=60, n_chains=512, n_burnin=0)
SLOW_PROPOSAL = (4.0, 0.3)  # N(4, 0.3) for the target N(0, 1)
R_HAT_RTOL, ESS_RTOL = 1e-4, 1e-3
# HMC (phases 48-49), the reference's c11 and c11c (benchmarks/run_all.py:
# 451-505) at SHORT_MCMC's depth, as the other cells beside the main
# paths: (functions, step, exact value) of [x*x] on N(0, 1) and [x] on the
# Beta(2, 5) table target under HMC(step, n_leapfrog=8, adapt=True); the
# value within the reference's MCMC tolerance, 0.1 (BASELINE.md:
# tests/test_mcmc.py:88-148), and the kernel held chain for chain against
# its plain version at the shape it is timed at, no chain split.  Each cell
# is also timed at the groups of HMC_GROUPS (Layout(1, group)).
HMC_LEAPFROG = 8
HMC_CELLS = {"c11": ([lambda x: x * x], 0.9, 1.0),
             "c11c": ([lambda x: x], 0.05, 2.0 / 7.0)}
HMC_TOL = 0.1
HMC_GROUPS = (1, 2, 4, 8)
# nd and tempered HMC (phases 52-53), the reference's c11b and c12b
# (benchmarks/run_all.py:477-486, :542-553) at SHORT_MCMC's depth, with
# error bars: [x*y] on c9e's rho = 0.8 joint under HMC(0.4, L = 8), E[xy]
# = 0.8 within 6 error bars and 0.2; [x*x] on logmix at temperatures
# PT_LADDER under HMC(0.35, L = 8), E[x^2] = 17 within 6 error bars and
# the JAX test's 2.0 (tests/test_tempering.py:482).  Each kernel is held
# against its plain version at the shape it is timed at (nd no chain
# split, tempered at most 1 %), and timed at one lane per chain (nd) or
# per rung (tempered) at each group of HMC_GROUPS, and on the ladder.
HMC_ND_CELLS = {
    "c11b": dict(fns=[lambda x, y: x * y], target=c9e_target,
                 hmc=dict(step_size=0.4, n_leapfrog=HMC_LEAPFROG,
                          init_range=(-4.0, 4.0)),
                 temps=None, exact=0.8, tol=0.2),
    "c12b": dict(fns=[lambda x: x * x], target=lambda: logmix,
                 hmc=dict(step_size=0.35, n_leapfrog=HMC_LEAPFROG,
                          init_range=(3.0, 5.0)),
                 temps=PT_LADDER, exact=17.0, tol=2.0),
}
# Chain state (phases 50-51): c5b and c9e run as two calls of STATE_STEPS
# steps (return_state, then initial_state); the two calls' mean within
# STATE_Z standard errors of the one-call run's (times sqrt 2: the second
# halves draw other streams).
STATE_STEPS = MCMC_MAIN["n_steps"] // 2
STATE_Z = 6.0
# The seven extended families (phases 34-38): each family's arguments, as
# the kernel tests use them.  Phase 34 runs the bench set under each in
# every 1-D mode at MODE_CHECK_SAMPLES and in mc at MODE_SAMPLES.
FAMILY_ARGS = {
    "lognormal": (0.0, 0.5), "cauchy": (0.0, 1.0), "laplace": (3.0, 1.0),
    "logistic": (0.0, 2.0), "gumbel": (1.0, 0.5), "weibull": (1.5, 2.0),
    "pareto": (1.0, 3.0),
}
EULER_GAMMA = 0.5772156649015329
# Phase 35, c5b's chains and burn-in with a family target and proposal:
# Laplace(3, 1) under Logistic(0, 2); E[x] = 3, E[x^2] = 3^2 + 2.
FAM_C5B_FNS = [lambda x: x, lambda x: x * x]
FAM_C5B_EXACT = [3.0, 11.0]
# Phase 36, c9's shape (2^30) over Lognormal(0, 0.5) x Gumbel(1, 0.5):
# E[xy] = e^(1/8) (1 + gamma / 2), E[x^2 + y] = e^(1/2) + 1 + gamma / 2,
# and their variances (the families independent).
FAM_C9_FNS = [lambda x, y: x * y, lambda x, y: x * x + y]
_GUMBEL_M1 = 1.0 + 0.5 * EULER_GAMMA
_GUMBEL_M2 = 0.25 * math.pi ** 2 / 6.0 + _GUMBEL_M1 ** 2
FAM_C9_MEANS = [math.exp(0.125) * _GUMBEL_M1, math.exp(0.5) + _GUMBEL_M1]
FAM_C9_VARS = [math.exp(0.5) * _GUMBEL_M2 - FAM_C9_MEANS[0] ** 2,
               math.exp(2.0) - math.exp(1.0) + 0.25 * math.pi ** 2 / 6.0]
# Phase 37: c9e's chains over a product of family dimensions, Laplace(3, 1)
# x Gumbel(1, 0.5) under Logistic(3, 1) x Gumbel(1, 0.8), E[xy] =
# 3 (1 + gamma / 2), E[x + y] = 4 + gamma / 2; and c12's ladder and walk on
# a family target, Laplace(3, 1): E[x] = 3, E[x^2] = 11.
FAM_ND_FNS = [lambda x, y: x * y, lambda x, y: x + y]
FAM_ND_EXACT = [3.0 * _GUMBEL_M1, 3.0 + _GUMBEL_M1]
FAM_PT_FNS = [lambda x: x, lambda x: x * x]
FAM_PT_EXACT = [3.0, 11.0]
# Phase 38: the JAX package's TPU parity checks of the families
# (benchmarks/tpu_parity.py:803-849), copied: (factory, arguments, E[X]);
# means at 4e6 samples, seed 42, within 2 % (of max(|E|, 0.5)) and 6 error
# bars; the Cauchy CDF at loc, loc -/+ scale within 0.005; a Laplace target
# under a logistic proposal within 0.1; Weibull QMC within 0.005.
PARITY_MEANS = [
    ("lognormal", (0.3, 0.5), math.exp(0.425)),
    ("laplace", (1.0, 2.0), 1.0),
    ("logistic", (0.5, 1.0), 0.5),
    ("gumbel", (0.0, 1.5), 1.5 * EULER_GAMMA),
    ("weibull", (2.0, 1.0), math.gamma(1.5)),
    ("pareto", (1.0, 3.0), 1.5),
]
PARITY_SAMPLES = 4_000_000
PARITY_CAUCHY_FNS = [lambda x: x < 2.0, lambda x: x < 0.5, lambda x: x < 3.5]
PARITY_MEAN_FNS = [lambda x: x]


# nd over CUSTOM dimensions and nd importance sampling (phases 39-43).
# c9b (benchmarks/run_all.py:355-363): E[xy] over Beta(2,5) x U(0,1) =
# 1/7, Var = E[x^2] E[y^2] - 1/49 = (3/28)(1/3) - 1/49, held within 6
# sigma and the reference's 0.01.
C9B_FNS = [lambda x, y: x * y]
C9B_SAMPLES = 10_000_000
C9B_MEAN = 1.0 / 7.0
C9B_VAR = (3.0 / 28.0) / 3.0 - 1.0 / 49.0
C9B_TOLERANCE = 0.01
# c9's set at 2**30 with its normal dimension made CUSTOM, Beta(2,5) x
# U(0,1) x Exp(2): E[xyz] = (2/7)(1/2)(1/2), E[x^2 + y + z] = 3/28 + 1;
# Var[xyz] = (3/28)(1/3)(1/2) - (1/14)^2, Var[x^2 + y + z] = Var[x^2] +
# 1/12 + 1/4 with E[x^4] = 1/42.
ND_CUSTOM_MEANS = [1.0 / 14.0, 3.0 / 28.0 + 1.0]
ND_CUSTOM_VARS = [1.0 / 56.0 - 1.0 / 196.0,
                  1.0 / 42.0 - (3.0 / 28.0) ** 2 + 1.0 / 12.0 + 0.25]
# nd importance sampling, a rare event: P(X > 3, Y > 3) under N(0,1)^2
# from N(3.5, 1.5)^2 at 1e8 with error bars and diagnostics,
# Phi-bar(3)^2 = 1.8222e-6 within 6 standard errors.
ND_RARE_FNS = [lambda x, y: (x > 3.0) * (y > 3.0)]
ND_RARE_SAMPLES = 100_000_000
ND_RARE_EXACT = (0.5 * math.erfc(3.0 / math.sqrt(2.0))) ** 2
# nd importance sampling with table and sampler weights: E[x y^2] under a
# Beta(2,5) pdf table x N(0,1) from Beta(1.5,3) x N(0,1.5), 2**30
# samples: the target table's p and the sampler's q on the stratified
# dimension, traced p and q on the second; 2/7 within 6 standard errors.
ND_TS_FNS = [lambda x, y: x * y * y]
ND_TS_EXACT = 2.0 / 7.0


def beta25_table(tm):
    """Beta(2, 5)'s density as a pdf table on a 2048-knot uniform grid: a
    table p (Beta(2, 5) itself traces)."""
    x = np.linspace(0.0, 1.0, 2048)
    return tm.Distribution.from_pdf_table(x, 30.0 * x * (1.0 - x) ** 4)


def bimodal(x):
    """Config 5's and c12d's target (run_all.py:185-188): 0.5 N(-2, 1) +
    0.5 N(2, 1), unnormalised; E[x^2] = 5."""
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


def wide_pdf(x):
    """c12d's proposal density (run_all.py:570-585), on (-7, 7)."""
    return np.exp(-0.5 * (x / 3.0) ** 2)


def table_moments(dist, powers):
    """E[x^p] for each p of ``powers`` under the density the MCMC kernels
    sample for a CUSTOM target: exp of its downsampled log table
    (``api/device.py``), linear between its knots, by the trapezoid rule
    on 2,000,001 points of its grid (host float64)."""
    from tpu_montecarlo_torch.api.device import _device_uniform_log_tables

    lx, lp = (np.asarray(a, np.float64)
              for a in _device_uniform_log_tables(dist))
    x = np.linspace(lx[0], lx[-1], 2_000_001)
    p = np.exp(np.interp(x, lx, lp))
    mass = np.trapezoid(p, x)
    return [float(np.trapezoid(x ** k * p, x) / mass) for k in powers]


def wide_gap(tm):
    """A proposal with a zero-density gap on (-1, 1), on a 2048-knot grid
    over (-6, 6): the gapped route (gap-respecting tables, a guarded log
    table for q)."""
    x = np.linspace(-6.0, 6.0, 2048)
    return tm.Distribution.from_pdf_table(
        x, np.where(np.abs(x) < 1.0, 0.0, np.exp(-0.1 * x * x)))


# The nd and tempered serving handles (phases 60-63) at SHORT_MCMC's
# depth with error bars: c9e's handle with SERVING_DRAWS thinned draws;
# four rows of c9d's product target N(m, s) x N(m', s'), each under its
# own N(0, s_q)^2 proposal (pack_param_batch_nd) or its own adaptive walk
# (pack_random_walk_batch_nd), for posterior and step-size sweeps.
SERVING_DRAWS = 300
ND_SERVING_TARGETS = [[(0.0, 1.0), (0.0, 1.0)], [(0.5, 1.5), (-0.5, 1.0)],
                      [(1.0, 0.5), (0.25, 2.0)], [(-1.0, 1.0), (1.0, 0.75)]]
ND_SERVING_PROPOSALS = [2.0, 2.5, 1.5, 3.0]  # s_q of N(0, s_q) per dimension
ND_SERVING_STEPS = [(0.8, 0.8), (1.2, 0.9), (0.5, 1.6), (1.0, 0.7)]


# Wide sets and control variates (phases 64-67).  c7
# (benchmarks/run_all.py:262-292): a K-bin histogram of Beta(2, 5) drawn
# from its 2048-entry table, K = 128 (one launch) and 256 (two passes of
# 128), at C7_SAMPLES, through compile_integrate; the reference expects
# the K = 256 per-function rate within ~2x of K = 128's.  Each bin's mass
# is the difference of the Beta(2, 5) CDF, 15 x^2 - 40 x^3 + 45 x^4 - 24
# x^5 + 5 x^6.
C7_SAMPLES = 1 << 27
C7_CHECK_SAMPLES = 1 << 22
C7_TABLE_SIZE = 2048
# A bin's mass under the table the kernel samples (the 2048-entry table,
# resampled to the kernel's strata) differs from Beta(2, 5)'s by up to 4e-5
# (3.9e-5 at K = 128 and 2.1e-5 at K = 256 on an H100): each bin is held
# within 6 sigma + C7_TABLE_TOL of the closed form, and each pass to its
# plain version, which samples the same table, within rel 1e-5.
C7_TABLE_TOL = 1e-4


def _bin(lo, hi):
    return lambda v: (v >= lo) * (v < hi)


def hist_fns(k):
    edges = np.linspace(0.0, 1.0, k + 1)
    return [_bin(float(lo), float(hi)) for lo, hi in zip(edges[:-1], edges[1:])]


def beta25_cdf(x):
    return (15.0 * x ** 2 - 40.0 * x ** 3 + 45.0 * x ** 4 - 24.0 * x ** 5
            + 5.0 * x ** 6)


def hist_masses(k):
    edges = np.linspace(0.0, 1.0, k + 1)
    return np.diff(beta25_cdf(edges))


# The wide MCMC cells at MCMC_CHECK's shape with error bars: K = 254 over
# c5b (N(0, 1) from N(0, 2)) and c9e (the rho = 0.8 joint from N(0, 2)^2),
# two groups of 127; K = 252 over c12's ladder and walk, two groups of
# 126.  f_j = x^2 + c_j x (E = 1 on c5b, 17 on c12's logmix) and x y + c_j
# x (E = 0.8), c_j = j / 64.
def _affine1(c):
    return lambda x: x * x + c * x


def _affine2(c):
    return lambda x, y: x * y + c * x


WIDE_MCMC_K = {"c5b": 254, "c9e": 254, "c12": 252}
WIDE_MCMC_FNS = {
    "c5b": [_affine1(j / 64.0) for j in range(254)],
    "c9e": [_affine2(j / 64.0) for j in range(254)],
    "c12": [_affine1(j / 64.0) for j in range(252)],
}
WIDE_MCMC_EXACT = {"c5b": 1.0, "c9e": 0.8, "c12": 17.0}


# The control-variate cell: exp(x/2) and 31 shifted copies under N(0, 1)
# with the controls x, x^2, x^3 and sin x (known means 0, 1, 0, 0), at
# CV_SAMPLES: 32 + 4 + 128 + 10 = 174 composed integrands (two passes),
# 206 with error bars.
CV_SAMPLES = 1 << 24


def _exp_half(c):
    return lambda x: math.e ** (0.5 * x) + c


CV_FNS = [_exp_half(j / 8.0) for j in range(32)]
CV_MEANS = [math.exp(0.125) + j / 8.0 for j in range(32)]
CV_CONTROLS = [(lambda x: x, 0.0), (lambda x: x * x, 1.0),
               (lambda x: x * x * x, 0.0), (lambda x: math.sin(x), 0.0)]
# The depth at which each wide MCMC pass is held against its plain
# version on the card (the plain version takes a torch op per integrand
# and step): MCMC_CHECK's chains, 20 + 100 steps (50 + 250 before the
# XLA-only table phases 68-71 needed the time).
WIDE_MCMC_CHECK = dict(n_chains=4096, n_steps=100, n_burnin=20)
CV_CHECK_SAMPLES = 1 << 22


# The tables the JAX package runs on its XLA sweep (phases 68-71): the
# 1-D main path's [x^2] on N(0, 1) from a Student-t(5) proposal (the knots
# route) at MCMC_MAIN's shape, E = 1; an adaptive walk on the spiky
# irregular table (the irregular target table), E[x] = 2; c9f with
# dimension 1's proposal Student-t(5, 0, 2), E[xy] = 0; c12d with the
# Student-t(5, 0, 3) proposal and with a gapped proposal (the tempered
# kernel's gapped route), E[x] = 0, E[x^2] = 5; the walk, c9f and c12d at
# SHORT_MCMC's depth.  Each within 6 error bars and XLA_TOLERANCE, the
# reference MCMC tolerance (BASELINE.md).
XLA_TOLERANCE = 0.2
SPIKE_FNS = [lambda x: x]
SPIKE_EXACT = [2.0]
_SPIKE_X = np.sort(np.concatenate([np.linspace(0.0, 4.0, 900),
                                   np.linspace(1.999, 2.001, 200)]))


def spiky_table(tm):
    """A 0.0005-wide spike at 2 on a flat [0, 4] density, tabulated on an
    irregular grid that no uniform grid resamples within its bound (the
    irregular-grid log table); E[x] = 2."""
    return tm.Distribution.from_pdf_table(
        _SPIKE_X,
        0.2 + np.exp(-0.5 * ((_SPIKE_X - 2.0) / 0.0005) ** 2) * 50.0)


def outer_gap(tm):
    """A gapped proposal for c12d's target: c12d's own proposal density
    (``wide_pdf``) on (-8, 8) with no density on 6.5 < |x| < 7, outside the
    target's (-6, 6), so no target mass lies in a gap; its q-table is
    faithful (the gapped route)."""
    x = np.linspace(-8.0, 8.0, 2048)
    ax = np.abs(x)
    return tm.Distribution.from_pdf_table(
        x, np.where((ax > 6.5) & (ax < 7.0), 0.0, wide_pdf(x)))


def short_inverse(tm, d, m=1000):
    """``d`` with a uniform-u inverse of ``m`` knots, off the 128 lanes
    (the "full" route), set through its spec."""
    from tpu_montecarlo_torch.sampling import DistKind, DistSpec
    from tpu_montecarlo_torch.tables import compute_inverse_cdf_table

    inv = compute_inverse_cdf_table(d._x_table, d._cdf_table, m=m)
    d._cached_spec = DistSpec(DistKind.CUSTOM, np.zeros(2, np.float32), inv,
                              np.asarray(d._cdf_table, np.float32))
    return d

# Phases 72-75: expectation_fn's gradient builds and adapt_proposal.
# The bench set's pathwise gradients (d/dmu, d/dsigma) of E[f(mu + sigma
# Z)] at (0, 1) (x > 1's pathwise gradient is 0; E|x| = sigma sqrt(2/pi)
# at mu = 0; E[exp(-x^2)] = exp(-mu^2 / (1 + 2 sigma^2)) / sqrt(1 + 2
# sigma^2)), held within GRAD_Z standard errors of the run (batch means
# over the launch's block rows).
BENCH_GRAD_EXACT = [
    (1.0, 0.0), (0.0, 2.0), (3.0, 0.0), (0.0, 12.0),
    (math.exp(-0.5), 0.0), (0.0, -2.0 * 3.0 ** -1.5), (0.0, 0.0),
    (0.0, math.sqrt(2.0 / math.pi)),
]
GRAD_Z = 5.0
# c9's set over N(0,1) x U(0,1) x Exp(2): each function's (d, 2) gradient,
# rows (mu, sigma), (a, b), (lambda, unused).  E[xyz] = mu (a + b) / (2
# lambda); E[x^2 + y + z] = mu^2 + sigma^2 + (a + b) / 2 + 1 / lambda.
ND_GRAD_EXACT = [
    [(0.25, 0.0), (0.0, 0.0), (0.0, 0.0)],
    [(0.0, 2.0), (0.5, 0.5), (-0.25, 0.0)],
]
# A gradient build against its plain version: the kernel's affine steps
# round once, its libm differs in the last bit and its sums run in another
# order; a pathwise mean within GRAD_RTOL of itself plus GRAD_RTOL of the
# mean |f'(x) dx/dp| on the family's quantile grid.
GRAD_RTOL = 1e-5
# adapt_proposal on the card against the same call on the CPU: one counter
# stream, the per-bin sums in another order; the learned edges within
# ADAPT_EDGE_TOL of the support's width.
ADAPT_SUPPORT = (-8.0, 8.0)
ADAPT_EDGE_TOL = 1e-3
