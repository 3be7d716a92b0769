"""Split-R-hat and ESS (``return_diagnostics=True``) in the port's three MCMC
paths, against the JAX package, with the thinned draws of the same runs.

* The port's ``split_rhat_ess`` against the JAX package's on seeded
  inputs, the degenerate W == 0 branches (+inf and 1) and the ESS cap
  included: equal within float32 rounding (rel 1e-6).
* The three plain versions, with diagnostics and draws, against the
  interpret-mode JAX kernels (``build_mcmc_fn_pallas`` directly, and
  ``MonteCarloIntegrator(backend="pallas")`` for the nd and tempered
  kernels, warnings raised as errors so a silent fallback to the XLA
  sweep fails): ``r_hat`` within rel 1e-4 and ``ess`` within rel 1e-3
  (blocks of 32 chains against programs of 1,024 as the unit of Chan's
  recombination; measured up to ~1e-7 and ~5e-6), the draws chain for
  chain as the existing chain tests hold final states (at most 1% of the
  draws more than 1e-4 relative apart; measured: none), in the JAX
  package's public shapes.  The cases cover the three modes, odd
  ``n_steps``, error bars beside diagnostics, a CUSTOM table target, an
  extended family, a joint target and the tempered cold rung.
* Values and error bars bit-equal with and without the new outputs.
* The JAX package's own diagnostics tests (``tests/test_diagnostics.py``
  and the tempered ones of ``tests/test_tempering.py``) on the port.

Small sizes throughout: 1,024 chains (the kernels' least grid) and tens of
steps against the JAX kernels.  ``test_torch_cuda.py`` holds the CUDA
kernels against these plain versions.
"""

import contextlib
import math
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
from tpu_montecarlo.ops.mcmc_xla import plan_chains as j_plan_chains
from tpu_montecarlo.ops.mcmc_xla import split_rhat_ess as j_split_rhat_ess
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.tracing import trace_function as j_trace

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.lower import to_torch
from tpu_montecarlo_torch.ops.mcmc_diagnostics import split_rhat_ess
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    McmcConfig,
    Mode,
    mcmc_diagnostics,
    mcmc_finish,
    mcmc_reference,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.sampling import DistKind

R_HAT_RTOL, ESS_RTOL = 1e-4, 1e-3
VALUE_ATOL = 1e-5
STDERR_RTOL = 1e-3
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
N_CHAINS = 1024


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): c12's target (benchmarks/run_all.py:518).
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


def bimodal(x):
    # BASELINE config 5's target, a from_pdf table: E[x^2] = 5.
    return 0.5 * np.exp(-0.5 * (x + 2) ** 2) + 0.5 * np.exp(-0.5 * (x - 2) ** 2)


def _c9e_target(x, y):
    return -(x * x - 1.6 * x * y + y * y) / 0.72


@contextlib.contextmanager
def _flushing_subnormals():
    """XLA's CPU backend flushes float32 subnormals; a hot rung's walk over
    logmix's far tail reads them (tests/test_torch_tempering.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _assert_diagnostics(got, want):
    for key, rtol in (("r_hat", R_HAT_RTOL), ("ess", ESS_RTOL)):
        g, w = got.diagnostics[key], np.asarray(want.diagnostics[key])
        assert g.dtype == np.float64 and g.shape == w.shape
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)


def _assert_draws_agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    split = np.abs(got - want) > SPLIT_RTOL * (1.0 + np.abs(want))
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the draws split"


# -- split_rhat_ess -----------------------------------------------------------

RHAT_CASES = {
    # (w_tot, ss_tot, m_total, n1)
    "mixed": (16.0, 0.14, 8, 10),
    "slow": (3.0, 40.0, 2048, 30),
    "one-draw-sequences": (2.5, 0.5, 64, 1),
    "frozen-apart": (0.0, 5.0, 8, 10),
    "constant": (0.0, 0.0, 8, 10),
    "ess-capped": (16.0, 1e-9, 8, 10),
}


@pytest.mark.parametrize("case", list(RHAT_CASES))
def test_split_rhat_ess_matches_jax(case):
    w_tot, ss_tot, m, n1 = RHAT_CASES[case]
    jr, je = j_split_rhat_ess(jnp.float32(w_tot), jnp.float32(ss_tot), m, n1)
    r, e = split_rhat_ess(torch.tensor(w_tot, dtype=torch.float32),
                          torch.tensor(ss_tot, dtype=torch.float32), m, n1)
    assert r.dtype == e.dtype == torch.float32
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-6)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-6)


def test_split_rhat_ess_matches_jax_on_seeded_vectors():
    rs = np.random.default_rng(15)
    w = rs.uniform(0.0, 50.0, 64).astype(np.float32)
    ss = rs.uniform(0.0, 5.0, 64).astype(np.float32)
    w[:4] = 0.0
    ss[2:6] = 0.0
    jr, je = j_split_rhat_ess(jnp.asarray(w), jnp.asarray(ss), 2048, 250)
    r, e = split_rhat_ess(torch.from_numpy(w), torch.from_numpy(ss), 2048, 250)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    r, e = r.numpy(), e.numpy()
    assert np.isinf(r[:2]).all() and (r[2:4] == 1.0).all()
    assert (e[2:6] == 2048 * 250).all()


# -- the 1-D plain version against the interpret-mode JAX kernel --------------

FNS = [lambda x: x, lambda x: x * x, lambda x: np.sin(x), lambda x: x > 1.0]
_N, _U, _E = DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL
# id: (mode, proposal, target, (6,) params row, stderr, n_steps, n_burnin,
# draws)
CASES_1D = {
    "independence-stderr": (Mode.INDEPENDENCE, _N, _N,
                            [0.0, 2.0, 0, 0, 0.0, 1.0], True, 64, 16, 8),
    "uniform-exponential-odd": (Mode.INDEPENDENCE, _U, _E,
                                [0.0, 6.0, 0, 0, 1.5, 0.0], False, 51, 8, 51),
    "adaptive-walk": (Mode.ADAPTIVE, _N, _N,
                      [0.8, -2.3, 2.3, 0.44, 0.0, 1.0], False, 40, 16, 3),
}


def _jax_1d(case, seed=42):
    mode, prop, targ, row, stderr, n_steps, n_burnin, m = CASES_1D[case]
    walk = mode != Mode.INDEPENDENCE
    run = build_mcmc_fn_pallas(
        tuple(j_trace(f) for f in FNS), JKind(int(prop)), JKind(int(targ)),
        n_steps, n_burnin, j_plan_chains(N_CHAINS, None), interpret=True,
        with_stderr=stderr, with_diagnostics=True, with_samples=m,
        random_walk=walk, rw_adapt=mode == Mode.ADAPTIVE,
    )
    prop_row = np.asarray(row[:4] if walk else row[:2], np.float32)
    args = [np.uint32(seed), prop_row, np.asarray(row[4:], np.float32)]
    return [np.asarray(o) for o in
            run(*args, *[jnp.zeros(1, jnp.float32)] * 6)]


def _port_1d(case, seed=42, **outputs):
    mode, prop, targ, row, stderr, n_steps, n_burnin, m = CASES_1D[case]
    kw = dict(with_stderr=stderr, with_diagnostics=True, samples=m)
    kw.update(outputs)
    cfg = McmcConfig(mode, prop, targ, n_steps, n_burnin, **kw)
    grid = plan_mcmc_grid(plan_chains(N_CHAINS, None))
    fns = [to_torch(tm.trace_function(f)) for f in FNS]
    out = mcmc_reference(fns, cfg, torch.tensor(row, dtype=torch.float32),
                         seed, grid)
    return out, grid, cfg


@pytest.mark.parametrize("case", list(CASES_1D))
def test_1d_plain_version_matches_jax_kernel(case):
    stderr = CASES_1D[case][4]
    want = _jax_1d(case)
    out, grid, cfg = _port_1d(case)
    values, acc, se = mcmc_finish(out, grid, cfg, len(FNS))
    r_hat, ess = mcmc_diagnostics(out, grid, cfg, len(FNS))
    np.testing.assert_allclose(values.numpy(), want[0], rtol=0,
                               atol=VALUE_ATOL)
    assert abs(float(acc) - float(want[1])) <= 1e-4
    i = 2
    if stderr:
        np.testing.assert_allclose(se.numpy(), want[2], rtol=STDERR_RTOL)
        i = 3
    np.testing.assert_allclose(r_hat.numpy(), want[i], rtol=R_HAT_RTOL)
    np.testing.assert_allclose(ess.numpy(), want[i + 1], rtol=ESS_RTOL)
    assert out.samples.shape == want[i + 2].shape == (
        CASES_1D[case][7], grid.chains_actual)
    _assert_draws_agree(out.samples.numpy(), want[i + 2])


@pytest.mark.parametrize("case", list(CASES_1D))
def test_1d_values_unchanged_by_the_outputs(case):
    # With error bars on both sides the sums are pilot-shifted either way:
    # values and error bars bit-equal; the chains' final states too.
    full, grid, cfg = _port_1d(case, with_stderr=True)
    bare, _, bare_cfg = _port_1d(case, with_stderr=True,
                                 with_diagnostics=False, samples=0)
    k = len(FNS)
    for a, b in zip(mcmc_finish(full, grid, cfg, k),
                    mcmc_finish(bare, grid, bare_cfg, k)):
        assert torch.equal(a, b)
    assert torch.equal(full.rows[:, :3], bare.rows)
    assert torch.equal(full.x_final, bare.x_final)


# -- the public calls against MonteCarloIntegrator(backend="pallas") ---------

# id: (functions, target, proposal, temperatures, keywords); each a function
# of the package (jmc or tm).
PUBLIC = {
    "1d-table-target": (
        [lambda x: x * x],
        lambda p: p.Distribution.from_pdf(bimodal, support=(-6.0, 6.0)),
        lambda p: p.Distribution.uniform(-6.0, 6.0), None,
        dict(n_steps=45, n_burnin=10, return_stderr=True, return_samples=9)),
    "1d-family": (
        [lambda x: x, lambda x: x * x],
        lambda p: p.Distribution.laplace(3.0, 1.0),
        lambda p: p.Distribution.logistic(0.0, 2.0), None,
        dict(n_steps=40, n_burnin=10, return_samples=40)),
    "nd-joint-stderr": (
        [lambda x, y: x * y, lambda x, y: x * x + y * y],
        lambda p: _c9e_target,
        lambda p: [p.Distribution.normal(0.0, 2.0)] * 2, None,
        dict(n_steps=41, n_burnin=10, return_stderr=True, return_samples=6)),
    "nd-table-dimension": (
        [lambda x, y: x * y],
        lambda p: [p.Distribution.beta(2.0, 5.0), p.Distribution.normal(0, 1)],
        lambda p: [p.Distribution.beta(2.0, 5.0), p.Distribution.normal(0, 2)],
        None, dict(n_steps=40, n_burnin=10, return_samples=1)),
    "nd-walk-family": (
        [lambda x, y: x + y],
        lambda p: [p.Distribution.gumbel(1.0, 0.5),
                   p.Distribution.laplace(3.0, 1.0)],
        lambda p: p.RandomWalk(step_size=[0.6, 1.0], adapt=True), None,
        dict(n_steps=37, n_burnin=12, return_samples=5)),
    "tempered-c12": (
        [lambda x: x, lambda x: x * x], lambda p: logmix,
        lambda p: p.RandomWalk(step_size=0.5, adapt=True,
                               init_range=(3.0, 5.0)), [1.0, 2.0, 4.0, 8.0],
        dict(n_steps=41, n_burnin=12, return_stderr=True, return_samples=4)),
    "tempered-table-target": (
        [lambda x: x, lambda x: x * x],
        lambda p: p.Distribution.from_pdf(bimodal, support=(-6.0, 6.0)),
        lambda p: p.Distribution.normal(0.0, 4.0), [1.0, 2.0, 4.0],
        dict(n_steps=30, n_burnin=8, return_samples=30)),
    "tempered-2d-product": (
        [lambda x, y: x * y, lambda x, y: x + y],
        lambda p: [p.Distribution.uniform(-1.0, 2.0),
                   p.Distribution.exponential(1.5)],
        lambda p: [p.Distribution.normal(0.5, 1.5),
                   p.Distribution.exponential(1.0)], [1.0, 2.5],
        dict(n_steps=40, n_burnin=10, return_samples=7)),
}


def _public(pkg, case, **extra):
    fns, target, proposal, temps, kw = PUBLIC[case]
    kw = dict(kw, n_chains=N_CHAINS, seed=5, return_diagnostics=True,
              temperatures=temps)
    kw.update(extra)
    if pkg is jmc:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            return jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
                fns, target(jmc), proposal(jmc), **kw)
    with _flushing_subnormals():
        return tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, target(tm), proposal(tm), **kw)


@pytest.mark.parametrize("case", list(PUBLIC))
def test_public_call_matches_jax_pallas_backend(case):
    want = _public(jmc, case)
    got = _public(tm, case)
    np.testing.assert_allclose(got.values, np.asarray(want.values, np.float64),
                               rtol=1e-5, atol=1e-6)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-4
    if PUBLIC[case][4].get("return_stderr"):
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    _assert_diagnostics(got, want)
    if PUBLIC[case][3] is not None:
        assert abs(got.diagnostics["swap_rate"]
                   - want.diagnostics["swap_rate"]) <= 1e-6
    _assert_draws_agree(got.samples, want.samples)


@pytest.mark.parametrize("case", ["nd-joint-stderr", "tempered-c12"])
def test_public_values_unchanged_by_the_outputs(case):
    full = _public(tm, case)
    bare = _public(tm, case, return_diagnostics=False, return_samples=None)
    np.testing.assert_array_equal(full.values, bare.values)
    np.testing.assert_array_equal(full.stderr, bare.stderr)
    assert full.acceptance_rate == bare.acceptance_rate


# -- the JAX package's diagnostics tests on the port --------------------------

N01 = tm.Distribution.normal(0.0, 1.0)
N02 = tm.Distribution.normal(0.0, 2.0)


def _run(fns, target, proposal, **kw):
    return tm.integrate_mcmc(fns, target, proposal, device="cpu", **kw)


def test_well_mixed_near_one():
    r = _run([lambda x: x, lambda x: x * x], N01, N02, n_steps=2000,
             n_chains=512, n_burnin=200, return_diagnostics=True)
    r_hat = r.diagnostics["r_hat"]
    assert r_hat.shape == (2,)
    assert np.all(r_hat > 0.99) and np.all(r_hat < 1.02)


def test_slow_mixing_flagged():
    # Mass at 4, target at 0, a short run: the halves disagree.
    r = _run([lambda x: x], N01, tm.Distribution.normal(4.0, 0.3),
             n_steps=60, n_chains=512, n_burnin=0, return_diagnostics=True)
    assert r.diagnostics["r_hat"][0] > 1.1


def test_ess_tracks_mixing():
    kw = dict(n_chains=512, return_diagnostics=True)
    good = _run([lambda x: x], N01, N02, n_steps=1000, n_burnin=100, **kw)
    stuck = _run([lambda x: x], N01, tm.Distribution.normal(4.0, 0.3),
                 n_steps=60, n_burnin=0, **kw)
    # The port's kernels plan 1024 chains for 512 (the JAX kernels' grid).
    draws_good = 2 * 1024 * (1000 // 2)
    draws_stuck = 2 * 1024 * (60 // 2)
    ess_good = good.diagnostics["ess"][0]
    ess_stuck = stuck.diagnostics["ess"][0]
    assert 0.1 * draws_good < ess_good <= draws_good
    assert ess_stuck < 0.2 * draws_stuck
    assert ess_good / draws_good > 5 * ess_stuck / draws_stuck


def test_diagnostics_none_by_default():
    r = _run([lambda x: x], N01, N02, n_steps=200, n_chains=256, n_burnin=10)
    assert r.diagnostics is None


def test_combined_with_stderr():
    r = _run([lambda x: x], N01, N02, n_steps=1000, n_chains=512,
             n_burnin=100, return_stderr=True, return_diagnostics=True)
    assert r.stderr is not None and r.stderr[0] > 0
    assert 0.99 < r.diagnostics["r_hat"][0] < 1.05
    assert abs(r.values[0]) < 4 * r.stderr[0]


def test_custom_target_table_path():
    r = _run([lambda x: x], tm.Distribution.beta(2.0, 2.0),
             tm.Distribution.uniform(0.0, 1.0), n_steps=1500, n_chains=512,
             n_burnin=150, return_diagnostics=True)
    assert abs(r.values[0] - 0.5) < 0.01
    assert r.diagnostics["r_hat"][0] < 1.02


def test_frozen_chains_read_inf_or_one():
    # A walk whose every step leaves the uniform target's support rejects
    # every move: the chains stay at their distinct initial states.  With
    # two draws per sequence every sum is exact, so W == 0: the means
    # differ for x (R-hat = inf, ESS = the 2048 sequences) and agree for
    # a constant (R-hat = 1, ESS = every draw).
    r = _run([lambda x: x, lambda x: 0.0 * x + 2.0],
             tm.Distribution.uniform(0.0, 1.0),
             tm.RandomWalk(step_size=1e6, init_range=(0.2, 0.8)),
             n_steps=4, n_chains=256, n_burnin=0, return_diagnostics=True)
    assert r.acceptance_rate == 0.0
    np.testing.assert_array_equal(r.diagnostics["r_hat"], [np.inf, 1.0])
    np.testing.assert_array_equal(r.diagnostics["ess"],
                                  [2 * 1024, 2 * 1024 * 2])


@pytest.mark.parametrize("bad", [1, 2, 3])
def test_diagnostics_needs_four_steps(bad):
    for fns, target, proposal in (
            ([lambda x: x], N01, N02),
            ([lambda x, y: x * y], [N01, N01], [N02, N02]),
    ):
        with pytest.raises(ValueError, match="n_steps >= 4"):
            _run(fns, target, proposal, n_steps=bad, n_chains=256,
                 n_burnin=0, return_diagnostics=True)
    with pytest.raises(ValueError, match="return_diagnostics needs n_steps >= 4"):
        _run([lambda x: x], N01, N02, n_steps=bad, n_chains=256, n_burnin=0,
             return_diagnostics=True, temperatures=[1.0, 2.0])


def test_rejected_with_state():
    with pytest.raises(ValueError, match="stateless"):
        _run([lambda x: x], N01, N02, n_steps=100, n_chains=256,
             n_burnin=10, return_diagnostics=True, return_state=True)


def test_nd_diagnostics_near_one():
    r = _run([lambda x, y: x + y, lambda x, y: x * y], [N01, N01], [N02, N02],
             n_steps=800, n_chains=1024, n_burnin=100, seed=5,
             return_diagnostics=True, return_stderr=True)
    assert np.all(np.abs(r.diagnostics["r_hat"] - 1.0) < 0.02)
    assert np.all(r.diagnostics["ess"] > 0)
    assert abs(r.values[1]) < 5 * r.stderr[1]


# The tempered cases of tests/test_tempering.py.

def test_tempered_diagnostics_flag_the_trapped_run():
    # Overdispersed init across both of logmix's basins: the plain walk's
    # chains freeze in the mode they started in (R-hat far above 1); the
    # tempered run mixes (R-hat near 1).
    walk = tm.RandomWalk(step_size=0.5, init_range=(-5.0, 5.0))
    kw = dict(n_steps=2000, n_chains=512, n_burnin=500, seed=12,
              return_diagnostics=True)
    plain = _run([lambda x: x], logmix, walk, **kw)
    pt = _run([lambda x: x], logmix, walk,
              temperatures=[1.0, 2.0, 4.0, 8.0, 16.0], **kw)
    assert plain.diagnostics["r_hat"][0] > 1.5
    assert pt.diagnostics["r_hat"][0] < 1.1
    assert pt.diagnostics["ess"][0] > 100.0
    assert 0.0 < pt.diagnostics["swap_rate"] < 1.0
    assert set(pt.diagnostics) == {"swap_rate", "r_hat", "ess"}
