"""The port's parallel-tempering slice against the JAX package.

The port's plain PyTorch version runs, ladder for ladder, the chains of the
JAX kernel ``build_pt_mcmc_fn_pallas`` in interpret mode (its
``CounterRng`` stream, seeded per (seed ^ 0x165667B1, program); rung t,
dimension j under tag t*d + j; accepts under tag t; pair t's swap uniform
under tag t at counter 3i+3), reached through
``MonteCarloIntegrator(backend="pallas")`` with warnings raised as errors,
so a silent fallback to the XLA sweep fails the test.  That kernel keeps
no state output; the cold rung's final states are the last thinned draw
of ``return_samples=n_steps``.  The tests hold:

* the tempered stream's uniforms bit-equal to the JAX ``CounterRng``;
* per chain, no final cold state more than 1e-4 (relative) from the JAX
  kernel's: the walks sum steps whose last bits differ with ``erfinv``'s;
* the means within rel 1e-5 + abs 1e-6 (float32 summation order), the
  acceptance rates within 1e-7, the swap rates within 1e-6 (the same
  counts; float32 division), the error bars within rel 1e-3 (blocks of 32
  chains against programs of 1,024 as the unit of Chan's recombination).

XLA's CPU backend flushes float32 subnormals to zero (``exp(-91)`` is 0
there and 3e-40 in torch and in CUDA).  A hot rung's walk reaches the
logmix target's far tail, where that decides whether the tempered log
density is finite, and with it the adaptive walk's step; so the port's
plain version is held against the JAX kernel under the same rule
(``torch.set_flush_denormal``).  The port itself keeps subnormals, as its
kernel does; ``test_torch_cuda.py`` holds the kernel against the plain
version.

The JAX package's default route off the TPU is its XLA sweep, keyed on
``jax.random``: there the port agrees only statistically, within 6
combined standard errors, on c12 and c12c at small size.
"""

import contextlib
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops import integrate_pallas as jpl
from tpu_montecarlo.ops.mcmc_pt_pallas import _PT_STREAM_MIX
from tpu_montecarlo.ops.mcmc_pt_pallas import (
    pt_attempted_swaps as j_attempted_swaps,
)

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import tempering as api_pt
from tpu_montecarlo_torch.ops import integrate_kernel as tk
from tpu_montecarlo_torch.ops.mcmc_kernel import Mode, plan_mcmc_grid
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
    LADDER_LAYOUT,
    PT_SEED_MIX,
    McmcPtConfig,
    McmcPtProgram,
    PtLayout,
    default_pt_layout,
    mcmc_pt_cuda,
    mcmc_pt_reference,
    pack_ladder,
    pt_attempted_swaps,
    pt_finish,
    pt_layout_source,
    pt_seed_word,
    rung_lanes,
)
from tpu_montecarlo_torch.sampling import DistKind

REPO = Path(__file__).resolve().parents[1]

N_CHAINS, N_STEPS, N_BURNIN = 1024, 200, 20
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
ACCEPT_ATOL = 1e-7
SWAP_ATOL = 1e-6
STDERR_RTOL = 1e-3
SPLIT_RTOL = 1e-4
LADDER4 = [1.0, 2.0, 4.0, 8.0]


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): E[X] = 0, E[X^2] = 17 (c12's target,
    # benchmarks/run_all.py:518-522).
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


def _c9e_target(x, y):
    # c9e's bivariate normal, rho = 0.8 (run_all.py:386-390).
    return -(x * x - 1.6 * x * y + y * y) / 0.72


def _d3_target(x, y, z):
    return -0.5 * (x * x + y * y - x * y + z * z) - 0.05 * z * z * z * z


FNS1 = [lambda x: x, lambda x: x * x]
FNS2 = [lambda x, y: x * y, lambda x, y: x * x + y * y,
        lambda x, y: (x > 1.0) * y]
FNS3 = [lambda x, y, z: x * y + z, lambda x, y, z: abs(x - z) * y]
C12_WALK = dict(step_size=0.5, adapt=True, init_range=(3.0, 5.0))


def _dist(pkg, spec):
    name, *args = spec
    return getattr(pkg.Distribution, name)(*args)


def _target(pkg, target):
    if callable(target):
        return target
    if isinstance(target, tuple):
        return _dist(pkg, target)
    return [_dist(pkg, s) for s in target]


def _proposal(pkg, proposal):
    if isinstance(proposal, dict):
        return pkg.RandomWalk(**proposal)
    if isinstance(proposal, tuple):
        return _dist(pkg, proposal)
    return [_dist(pkg, s) for s in proposal]


# id: (fns, target, proposal, temperatures, return_stderr, run keywords).
# A target is a joint log density, one spec or a list of per-dimension
# specs; a proposal one spec, a list of specs or RandomWalk's keywords.
CASES = {
    "c12": (FNS1, logmix, C12_WALK, LADDER4, False, {}),
    "walk-1d-distribution": (
        FNS1, ("normal", 1.0, 2.0),
        dict(step_size=1.0, init_range=(-3.0, 5.0)), [1.0, 3.0, 9.0], False,
        {},
    ),
    "c12c": (FNS1, logmix, ("normal", 0.0, 6.0), LADDER4, False, {}),
    "independence-2d-product": (
        FNS2, [("uniform", -1.0, 2.0), ("exponential", 1.5)],
        [("normal", 0.5, 1.5), ("exponential", 1.0)], [1.0, 2.5], False, {},
    ),
    "c9e-walk-T5": (
        FNS2, _c9e_target,
        dict(step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0)),
        [1.0, 2.0, 4.0, 8.0, 16.0], False, dict(n_steps=120),
    ),
    "d3-joint-adaptive": (
        FNS3, _d3_target,
        dict(step_size=[0.9, 0.8, 0.7], adapt=True, target_accept=0.3,
             init_range=[(-3.0, 3.0), (-2.0, 2.0), (-1.0, 1.0)]),
        [1.0, 1.5, 2.25], False, dict(n_steps=100),
    ),
    "walk-stderr": (FNS1, logmix, C12_WALK, LADDER4, True, {}),
    "independence-stderr": (
        FNS1, logmix, ("normal", 0.0, 6.0), LADDER4, True, {},
    ),
    # 16,384 chains plan 2 programs of 8,192: the second program's
    # stream is seeded with program id 1.  A decision lying within the
    # libraries' last-bit differences of its threshold flips: among these
    # 2 million rung moves seed 11 has none, seed 7 one cold accept.
    # test_two_programs_split_rate runs seeds 0-15 and counts them.
    "two-programs": (
        FNS1, logmix, C12_WALK, LADDER4, False,
        dict(n_chains=16_384, n_steps=25, n_burnin=5, seed=11),
    ),
}


def _run_kw(case, seed=None):
    kw = dict(n_chains=N_CHAINS, n_steps=N_STEPS, n_burnin=N_BURNIN, seed=42)
    kw.update(CASES[case][5])
    if seed is not None:
        kw["seed"] = seed
    return kw


@contextlib.contextmanager
def _flushing_subnormals():
    """Flush float32 subnormals to zero, as XLA's CPU backend does, on
    this thread, with torch's intra-op pool cut to this thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs():
    """The interpret-mode JAX kernel's result and final cold states
    (chains, d) per case, run once for the module."""
    cache = {}

    def get(case, seed=None):
        kw = _run_kw(case, seed)
        key = case, kw["seed"]
        if key not in cache:
            fns, target, proposal, temps, stderr, _ = CASES[case]
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
                    fns, _target(jmc, target), _proposal(jmc, proposal),
                    temperatures=temps, return_stderr=stderr,
                    return_samples=kw["n_steps"], **kw,
                )
            last = np.asarray(r.samples[-1])
            cache[key] = (r, last.reshape(kw["n_chains"], -1))
        return cache[key]

    return get


def _port_run(case, monkeypatch, seed=None):
    """The port's public path on the CPU: the result and the final cold
    states of the run (caught at the kernel wrapper), (chains, d)."""
    fns, target, proposal, temps, stderr, _ = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_pt_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_pt, "mcmc_pt_cuda", spy)
    with _flushing_subnormals():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, _target(tm, target), _proposal(tm, proposal),
            temperatures=temps, return_stderr=stderr, **_run_kw(case, seed),
        )
    assert len(outs) == 1
    return r, outs[0].x_final.numpy().T


# -- the tempered stream, bit for bit --------------------------------------


def test_pt_seed_mix_is_the_jax_kernels():
    assert PT_SEED_MIX == _PT_STREAM_MIX
    for seed in (0, 42, 2**31 + 5, 2**32 - 1):
        assert pt_seed_word(seed) == (seed ^ _PT_STREAM_MIX)
    with pytest.raises(OverflowError):
        pt_seed_word(-1)


@pytest.mark.parametrize("form", ["open01", "halfopen01"])
@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_pt_stream_uniforms_bit_equal(form, seed):
    # The JAX kernel seeds with the int32 seed xor the mix
    # (mcmc_pt_pallas.py:352-354); rung t, dimension j of a d = 2 ladder
    # draws under tag t*d + j, accepts and swaps under tag t.
    shape = (8, 128)
    d, n_temps = 2, 4
    jfn = getattr(jpl, f"_uniform_{form}")
    tfn = getattr(tk, f"uniform_{form}")
    seed_i32 = np.array(seed, np.uint32).view(np.int32)
    tags = sorted({t * d + j for t in range(n_temps) for j in range(d)})
    for pid in (0, 3):
        jrng = jpl.CounterRng()
        jrng.seed(jnp.int32(seed_i32) ^ _PT_STREAM_MIX, jnp.int32(pid))
        trng = tk.CounterRng(pt_seed_word(seed), pid)
        for i in (0, 7, 999):
            for counter in {0, 3 * i + 1, 3 * i + 2, 3 * i + 3}:
                for tag in tags:
                    want = np.asarray(jfn(jrng, shape, jnp.int32(counter), tag))
                    got = tfn(trng, shape, counter, tag).numpy()
                    np.testing.assert_array_equal(got, want)
        # All rungs at once, as the plain version draws them: a (T, 1)
        # tag tensor.
        rungs = torch.arange(n_temps)[:, None]
        got = tfn(trng, shape, 3 * 7 + 2, rungs)
        for t in range(n_temps):
            want = np.asarray(jfn(jrng, shape, jnp.int32(3 * 7 + 2), t))
            np.testing.assert_array_equal(got[t, 0].numpy(), want)


@pytest.mark.parametrize("n_temps", [2, 3, 4, 5, 6])
def test_attempted_swaps_match_jax(n_temps):
    for n_iters in (1, 2, 11, 220, 11_000):
        for chains in (1024, 4096):
            assert pt_attempted_swaps(n_temps, n_iters, chains) == (
                j_attempted_swaps(n_temps, n_iters, chains)
            )


def test_ladder_pair_differences_round_from_float64():
    betas = tuple(1.0 / t for t in [1.0, 3.0, 7.0, 11.0])
    got = pack_ladder(betas)
    assert got.dtype == np.float32 and got.shape == (7,)
    np.testing.assert_array_equal(got[:4], np.float32(betas))
    for t in range(3):
        # The JAX kernel multiplies the float64 difference into a float32
        # block: it is rounded once.
        assert got[4 + t] == np.float32(betas[t] - betas[t + 1])
    # Rounding the betas first gives another float32 for some pair.
    assert any(
        np.float32(betas[t]) - np.float32(betas[t + 1]) != got[4 + t]
        for t in range(3)
    )


# -- the plain version against the interpret-mode JAX kernel ----------------


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case, jax_runs, monkeypatch):
    want, x_jax = jax_runs(case)
    got, x_port = _port_run(case, monkeypatch)
    kw = _run_kw(case)
    assert got.n_samples == want.n_samples == kw["n_chains"] * kw["n_steps"]
    assert got.n_functions == len(CASES[case][0])
    assert x_port.shape == x_jax.shape
    split = np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))
    assert not split.any(), f"{split.any(axis=1).sum()} chains split"
    assert got.values.dtype == np.float64 and np.all(np.isfinite(got.values))
    np.testing.assert_allclose(
        got.values, np.asarray(want.values, np.float64),
        rtol=VALUE_RTOL, atol=VALUE_ATOL,
    )
    assert abs(got.acceptance_rate - want.acceptance_rate) <= ACCEPT_ATOL
    assert set(got.diagnostics) == {"swap_rate"}
    swap = got.diagnostics["swap_rate"]
    assert 0.0 < swap < 1.0
    assert abs(swap - want.diagnostics["swap_rate"]) <= SWAP_ATOL
    if CASES[case][4]:
        assert np.all(got.stderr > 0)
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    else:
        assert got.stderr is None


# The two-program run over seeds 0-15: how often a last-bit difference
# between the libraries' logf, expf and erfinv flips a decision.  In a few
# of these runs of ~2 million rung moves one cold move or exchange goes
# the other way; that ladder then differs for some steps and either
# rejoins the JAX kernel's (an exchange brings the same state down) or
# ends split.  At most 1e-4 of the chains may end split (one of 16,384),
# and the acceptance and swap rates may differ by at most SWEEP_DECISIONS
# decisions beyond the exact gates.
SWEEP_SEEDS = range(16)
SWEEP_DECISIONS = 4


@pytest.mark.parametrize("seed", list(SWEEP_SEEDS))
def test_two_programs_split_rate(seed, jax_runs, monkeypatch):
    want, x_jax = jax_runs("two-programs", seed)
    got, x_port = _port_run("two-programs", monkeypatch, seed)
    kw = _run_kw("two-programs", seed)
    split = (np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))).any(
        axis=1)
    moves = kw["n_chains"] * kw["n_steps"]
    attempted = pt_attempted_swaps(
        len(LADDER4), kw["n_burnin"] + kw["n_steps"], kw["n_chains"])
    d_acc = abs(got.acceptance_rate - want.acceptance_rate)
    d_swap = abs(got.diagnostics["swap_rate"] - want.diagnostics["swap_rate"])
    print(f"seed {seed}: {split.sum()} of {split.size} chains split; cold "
          f"accepts differ by {d_acc * moves:.2f}, exchanges by "
          f"{d_swap * attempted:.2f}")
    assert split.mean() <= 1e-4, f"{split.sum()} chains split"
    assert d_acc <= ACCEPT_ATOL + SWEEP_DECISIONS / moves
    assert d_swap <= SWAP_ATOL + SWEEP_DECISIONS / attempted


# -- c12 and c12c against the JAX default route ------------------------------

BENCH_CELLS = {
    "c12": C12_WALK,
    "c12c": ("normal", 0.0, 6.0),
}


@pytest.mark.parametrize("cell", list(BENCH_CELLS))
def test_benchmark_cells_agree_with_jax_default_route(cell):
    # The JAX package's default CPU route is its XLA sweep (jax.random):
    # the two agree within 6 combined standard errors, with E[x] = 0 and
    # E[x^2] = 17 within 6 of each one's own, and swap rates within 0.05.
    kw = dict(n_steps=300, n_chains=1024, n_burnin=100, seed=42,
              temperatures=LADDER4, return_stderr=True)
    proposal = BENCH_CELLS[cell]
    want = jmc.MonteCarloIntegrator().integrate_mcmc(
        FNS1, logmix, _proposal(jmc, proposal), **kw
    )
    got = tm.integrate_mcmc(
        FNS1, logmix, _proposal(tm, proposal), device="cpu", **kw
    )
    for j, exact in enumerate((0.0, 17.0)):
        v, se = float(got.values[j]), float(got.stderr[j])
        wv, wse = float(want.values[j]), float(want.stderr[j])
        assert abs(v - wv) <= 6.0 * np.hypot(se, wse)
        assert abs(v - exact) <= 6.0 * se and abs(wv - exact) <= 6.0 * wse
    assert 0.0 < got.acceptance_rate < 1.0
    swap, wswap = got.diagnostics["swap_rate"], want.diagnostics["swap_rate"]
    assert 0.0 < swap < 1.0 and abs(swap - wswap) <= 0.05


# -- the argument surface ------------------------------------------------------

_N01 = ("normal", 0.0, 1.0)
_WALK = dict(step_size=1.0)
# id: (ladder, run keywords, proposal keywords).
LADDER_ERRORS = {
    "one-rung": ([1.0], {}, _WALK),
    "first-not-one": ([2.0, 4.0], {}, _WALK),
    "decreasing": ([1.0, 4.0, 2.0], {}, _WALK),
    "repeated": ([1.0, 1.0], {}, _WALK),
    "infinite": ([1.0, float("inf")], {}, _WALK),
    "nan": ([1.0, float("nan")], {}, _WALK),
    "return-state": ([1.0, 2.0], dict(return_state=True), _WALK),
    "initial-state": ([1.0, 2.0], dict(initial_state=object()), _WALK),
    "samples-out-of-range": ([1.0, 2.0], dict(return_samples=101), _WALK),
    "diagnostics-short-run": (
        [1.0, 2.0], dict(return_diagnostics=True, n_steps=3), _WALK,
    ),
    "adapt-without-burn-in": (
        [1.0, 2.0], dict(n_burnin=0), dict(step_size=1.0, adapt=True),
    ),
    "joint-walk-without-range": ([1.0, 2.0], dict(target=logmix), _WALK),
}


@pytest.mark.parametrize("case", list(LADDER_ERRORS))
def test_validation_errors_match_jax(case):
    temps, extra, walk = LADDER_ERRORS[case]
    extra = dict(extra)

    def call(pkg, integ):
        kw = dict(n_steps=100, n_chains=64, n_burnin=10)
        kw.update(extra)
        target = kw.pop("target", None) or _dist(pkg, _N01)
        return integ.integrate_mcmc(
            [lambda x: x], target, pkg.RandomWalk(**walk),
            temperatures=temps, **kw,
        )

    with pytest.raises(ValueError) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(ValueError) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def _not_ported_cases():
    integ = tm.MonteCarloIntegrator(device="cpu")
    n = tm.Distribution.normal(0.0, 1.0)
    # Tables the JAX package's tempered kernel leaves to its XLA sweep: a
    # proposal with a zero-density gap, and a heavy-tailed one.
    grid = np.linspace(-6.0, 6.0, 2048)
    gapped = tm.Distribution.from_pdf_table(
        grid, np.where(np.abs(grid) < 1.0, 0.0, np.exp(-0.1 * grid * grid)))
    heavy = tm.Distribution.student_t(5.0)
    cauchy = tm.Distribution.cauchy(0.0, 1.0)
    wide = [(lambda c: lambda x: x + c)(float(c)) for c in range(127)]
    walk = tm.RandomWalk(**C12_WALK)

    def run(fns=FNS1, target=logmix, proposal=walk, **extra):
        return integ.integrate_mcmc(
            fns, target, proposal, n_steps=10, n_burnin=2,
            temperatures=[1.0, 2.0], **extra,
        )

    # id: the call, whose error names the item the id starts with.
    return {
        r"item 9\.8 ": lambda: run(proposal=gapped),
        r"item 9\.8 \(tempering over the CUSTOM dimensions": (
            lambda: run(proposal=heavy)),
        r"item 9\.7 \(tempering over more than 126 functions\)": (
            lambda: integ.compile_mcmc(wide, logmix, walk, n_steps=10,
                                       n_burnin=2, temperatures=[1.0, 2.0],
                                       seed_batch=4)([1, 2, 3, 4])[0]),
        r"item 3 \(integrand front end\)": lambda: integ.compile_mcmc(
            FNS2[:1], "fn f(x: f32, y: f32) -> f32 { return -x * x; }",
            [n, cauchy], temperatures=[1.0, 2.0], seed_batch=4),
        r"item 9\.7 ": lambda: run(fns=wide).values,
    }


# Ids whose item the port has since done: more than 126 functions run in
# passes of at most 126 (api/passes.py), so the call returns its values.
PORTED = (r"item 9\.7 \(tempering over more than 126 functions\)",
          r"item 9\.7 ")
# Ids whose tables the tempered kernel has since taken: the gapped proposal
# on its gap-respecting tables, the heavy-tailed one by knot search.
TABLES = (r"item 9\.8 ", r"item 9\.8 \(tempering over the CUSTOM dimensions")


@pytest.mark.parametrize("item", list(_not_ported_cases()))
def test_out_of_scope_options_name_their_roadmap_items(item):
    if item in TABLES:
        r = _not_ported_cases()[item]()
        assert r.values.shape == (len(FNS1),)
        assert np.all(np.isfinite(r.values))
        assert 0.0 < r.acceptance_rate <= 1.0
        return
    if item in PORTED:
        # 127 functions x + c in two passes (64 + 63): E[x + c] - E[x] = c
        # on the same chains, for every c.
        values = np.asarray(_not_ported_cases()[item]())
        assert values.shape[-1] == 127 and np.all(np.isfinite(values))
        shift = values - values[..., :1]
        np.testing.assert_allclose(shift, np.broadcast_to(
            np.arange(127.0), shift.shape), atol=1e-3)
        return
    with pytest.raises(NotImplementedError,
                       match="tpu_montecarlo_torch yet; see ROADMAP.md, "
                             "queue 1 " + item):
        _not_ported_cases()[item]()


def test_the_jax_package_runs_what_the_port_leaves_for_later():
    # Each 9.x item is a capability of the JAX package, not an error there.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            FNS1, logmix, jmc.RandomWalk(**C12_WALK), n_steps=20,
            n_chains=256, n_burnin=5, temperatures=[1.0, 2.0],
            return_samples=4,
        )
    assert np.asarray(r.samples).shape == (4, 1024, 1)


# -- the kernel wrapper and the public path ------------------------------------


def test_config_and_program_validation():
    n = DistKind.NORMAL
    with pytest.raises(ValueError, match="at least 2 rungs"):
        McmcPtConfig(Mode.RANDOM_WALK, 1, (), None, 10, 2, n_temps=1)
    with pytest.raises(ValueError, match="one family per dimension"):
        McmcPtConfig(Mode.INDEPENDENCE, 2, (n,), None, 10, 2, n_temps=2)
    # The extended families are families like the others.
    assert McmcPtConfig(Mode.INDEPENDENCE, 1, (DistKind.CAUCHY,), None, 10, 2,
                        n_temps=2).prop_kinds == (DistKind.CAUCHY,)
    cfg = McmcPtConfig(Mode.RANDOM_WALK, 1, (), None, 10, 2, n_temps=3)
    f1 = (tm.trace_function(lambda x: x),)
    with pytest.raises(ValueError, match="joint target needs"):
        McmcPtProgram(f1, cfg)
    wide = tuple(tm.trace_function((lambda c: lambda x: x + c)(float(c)))
                 for c in range(127))
    with pytest.raises(ValueError, match="mcmc_pt.cu takes 1 to 126 functions"):
        McmcPtProgram(wide, cfg, tm.trace_function(logmix))
    program = McmcPtProgram(f1, cfg, tm.trace_function(logmix))
    src = program.source()
    assert "#define TMC_T 3\n" in src and "#define TMC_MODE 1\n" in src
    assert "tmc_target_logpdf" in src
    # Layouts: rungs on T' = 4 lanes (T = 3 pads one) with lanes per rung
    # and a group, or the ladder, one thread per ladder; none other.
    target = tm.trace_function(logmix)
    assert program.layout == default_pt_layout(Mode.RANDOM_WALK, 3, 1)
    assert rung_lanes(3) == 4 and rung_lanes(4) == 4 and rung_lanes(33) == 64
    for layout in (LADDER_LAYOUT, (4, 1, 1), (4, 2, 3), (4, 8, 8)):
        taken = McmcPtProgram(f1, cfg, target, layout=layout)
        assert taken.layout == PtLayout(*layout)
        assert pt_layout_source(taken.layout) in taken.source()
    for bad, match in (((2, 1, 4), "rung lanes 1 .the ladder. or 4"),
                       ((8, 1, 4), "rung lanes 1 .the ladder. or 4"),
                       ((1, 2, 1), "ladder layout runs one lane"),
                       ((1, 1, 4), "ladder layout runs one lane"),
                       ((4, 16, 1), "divide a warp"),
                       ((4, 3, 1), "divide a warp"),
                       ((4, 1, 0), "divide a warp")):
        with pytest.raises(ValueError, match=match):
            McmcPtProgram(f1, cfg, target, layout=bad)
    # Past 32 rung lanes, and by default past the thresholds, the ladder.
    many = McmcPtConfig(Mode.RANDOM_WALK, 1, (), None, 10, 2, n_temps=33)
    assert McmcPtProgram(f1, many, target).layout == LADDER_LAYOUT
    with pytest.raises(ValueError, match="rung lanes 1 .the ladder. or 64"):
        McmcPtProgram(f1, many, target, layout=(32, 1, 1))
    assert default_pt_layout(Mode.ADAPTIVE, 33, 1) == LADDER_LAYOUT


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    cfg = McmcPtConfig(Mode.ADAPTIVE, 1, (), None, 8, 2, with_stderr=True,
                       n_temps=4)
    program = McmcPtProgram(
        tuple(tm.trace_function(f) for f in FNS1), cfg,
        tm.trace_function(logmix),
    )
    grid = plan_mcmc_grid(1024)
    params = torch.tensor([[0.5, 3.0, 5.0, 0.44, 0.0, 0.0]])
    ladder = torch.from_numpy(pack_ladder([1.0, 0.5, 0.25, 0.125]))
    before = mcmc_pt_cuda.launches, mcmc_pt_cuda.pilot_launches
    got = mcmc_pt_cuda(program, cfg, params, ladder, 5, grid)
    want = mcmc_pt_reference(
        program.torch_fns, program.torch_target, cfg, params, ladder, 5, grid
    )
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.x_final, want.x_final)
    assert got.rows.shape == (1024 // 32, 3, len(FNS1) + 2)
    assert got.x_final.shape == (1, 1024)
    assert (mcmc_pt_cuda.launches, mcmc_pt_cuda.pilot_launches) == before
    values, acc, swap, stderr = pt_finish(got, grid, cfg, len(FNS1))
    attempted = pt_attempted_swaps(4, 10, 1024)
    assert float(swap) == pytest.approx(float(got.rows[:, 0, 3].sum()) / attempted)
    assert values.shape == stderr.shape == (2,) and 0 < float(acc) < 1
    with pytest.raises(ValueError, match="float32"):
        mcmc_pt_cuda(program, cfg, params.double(), ladder, 5, grid)
    with pytest.raises(ValueError, match=r"\(7,\) float32"):
        mcmc_pt_cuda(program, cfg, params, ladder[:5].contiguous(), 5, grid)
    with pytest.raises(ValueError, match="built for"):
        mcmc_pt_cuda(
            program, McmcPtConfig(Mode.ADAPTIVE, 1, (), None, 8, 2, n_temps=3),
            params, ladder[:5].contiguous(), 5, grid,
        )
    with pytest.raises(ValueError, match="no tempered MCMC kernel"):
        mcmc_pt_cuda(program, cfg, params.to("meta"), ladder.to("meta"), 5,
                     grid)


def test_cache_keys_on_rungs_but_not_on_the_ladder(program_cache):
    kw = dict(n_steps=5, n_chains=256, n_burnin=1, device="cpu")
    walk = tm.RandomWalk(**C12_WALK)
    tm.integrate_mcmc(FNS1, logmix, walk, temperatures=[1.0, 2.0], **kw)
    size = len(program_cache._store)
    # Another ladder of as many rungs needs no new build.
    tm.integrate_mcmc(FNS1, logmix, walk, temperatures=[1.0, 3.0], **kw)
    assert len(program_cache._store) == size
    tm.integrate_mcmc(FNS1, logmix, walk, temperatures=[1.0, 2.0, 4.0], **kw)
    assert len(program_cache._store) == size + 1


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.integrate_mcmc(FNS1, logmix, tm.RandomWalk(**C12_WALK),
                          n_steps=10, temperatures=LADDER4)


def test_runs_with_jax_blocked(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(
        "import math, sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import tpu_montecarlo_torch as tm\n"
        "import tpu_montecarlo_torch.ops.mcmc_pt_kernel\n"
        "def logmix(x):\n"
        "    return math.log(math.exp(-0.5 * (x + 4.0) ** 2)\n"
        "                    + math.exp(-0.5 * (x - 4.0) ** 2))\n"
        "for p in (tm.RandomWalk(step_size=0.5, adapt=True,\n"
        "                        init_range=(3.0, 5.0)),\n"
        "          tm.Distribution.normal(0.0, 6.0)):\n"
        "    r = tm.integrate_mcmc(\n"
        "        [lambda x: x, lambda x: x * x], logmix, p,\n"
        "        n_steps=300, n_chains=1024, n_burnin=100,\n"
        "        temperatures=[1.0, 2.0, 4.0, 8.0], return_stderr=True,\n"
        "        device='cpu')\n"
        "    print(*r.values, *r.stderr, r.diagnostics['swap_rate'])\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(script)], check=True, cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    lines = out.stdout.splitlines()
    assert len(lines) == 2
    for line in lines:
        m1, m2, s1, s2, swap = map(float, line.split())
        assert abs(m1) < 6 * s1 and abs(m2 - 17.0) < 6 * s2
        assert 0 < s1 < 0.2 and 0.0 < swap < 1.0
