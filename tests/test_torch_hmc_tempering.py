"""Tempered Hamiltonian Monte Carlo in the port (``HMC`` proposals with
``temperatures=[...]``) against the JAX package.

* The plain version against the interpret-mode JAX kernel
  (``build_pt_mcmc_fn_pallas(..., hmc_leapfrog=L)``, through the JAX
  package's ``backend="pallas"`` calls), ladder for ladder over a short
  run of N_CHAINS x (N_BURNIN + N_STEPS): a 1-D joint target (c12b's
  ``logmix``, whose gradient is ``ops/grad.py``'s), a 1-D Distribution,
  a product of two, a CUSTOM table target and the adaptive banana of
  ``tests/test_tempering.py``.  Rung t's force is ``beta_t`` times the
  gradient; the cold rung's final states, after the last exchange, are
  held as ``tests/test_torch_hmc_nd.py`` holds the nd chains: at a fixed
  step at most MAX_SPLIT of the chains more than 1e-4 (relative) apart
  (measured: none), means within 1e-5 of the column's size, acceptance
  and swap rate within ACCEPT_ATOL; the table target's piecewise-constant
  gradient TABLE_SPLIT and TABLE_ATOL; the adaptive step, whose ulp
  differences the adaptation feeds back into every rung's trajectories,
  ADAPT_SPLIT (measured: 6.4 %) and ADAPT_ATOL.
* The cold rung's split-R-hat and ESS, and its draws, against the JAX
  kernel's on the same ladders: R-hat within rel 1e-4, ESS within rel
  1e-3, at most DRAW_SPLIT of the draws more than 1e-4 apart (measured:
  1 of 20,480, a trajectory's drift of 5e-4 relative that the run's end
  has left).
* The tempered HMC cases of ``tests/test_tempering.py`` on the port, to
  their own tolerances.

Both run one torch thread with float32 subnormals flushed, as XLA's CPU
backend runs.  The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import contextlib
import math
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import tempering as api_pt
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

N_CHAINS, N_STEPS, N_BURNIN = 512, 60, 20
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.0
ACCEPT_ATOL, MEAN_ATOL = 1e-4, 1e-5
TABLE_SPLIT, TABLE_ATOL = 0.03, 5e-3
ADAPT_SPLIT, ADAPT_ATOL = 0.3, 0.05
R_HAT_RTOL, ESS_RTOL, DRAW_SPLIT = 1e-4, 1e-3, 1e-3
LADDER = [1.0, 2.0, 4.0, 8.0, 16.0]


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): E[X] = 0, E[X^2] = 17.
    return math.log(math.exp(-0.5 * (x + 4.0) ** 2)
                    + math.exp(-0.5 * (x - 4.0) ** 2))


def banana(x, y):
    return -0.5 * (x * x / 4.0 + (y - 0.5 * x * x) ** 2)


@contextlib.contextmanager
def _flushing_subnormals():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _target(pkg, spec):
    if callable(spec):
        return spec
    d = pkg.Distribution
    if spec == "beta":
        return d.beta(2.0, 5.0)
    if isinstance(spec, list):
        return [getattr(d, s[0])(*s[1:]) for s in spec]
    return getattr(d, spec[0])(*spec[1:])


# case: (functions, target, HMC arguments, temperatures)
CASES = {
    "logmix": ([lambda x: x, lambda x: x * x], logmix,
               dict(step_size=0.35, n_leapfrog=8, init_range=(3.0, 5.0)),
               [1.0, 2.0, 4.0, 8.0]),
    "normal": ([lambda x: x, lambda x: x * x], ("normal", 3.0, 2.0),
               dict(step_size=0.3, n_leapfrog=5), [1.0, 2.0, 4.0]),
    "product": ([lambda x, y: x * y, lambda x, y: x * x],
                [("normal", 1.0, 1.0), ("normal", -1.0, 2.0)],
                dict(step_size=[0.4, 0.6], n_leapfrog=6), [1.0, 2.0, 4.0]),
    "table": ([lambda v: v], "beta",
              dict(step_size=0.05, n_leapfrog=5, init_range=(0.05, 0.95)),
              [1.0, 2.0]),
    "banana-adaptive": ([lambda x, y: x, lambda x, y: y], banana,
                        dict(step_size=0.15, n_leapfrog=5, adapt=True,
                             init_range=(-2.0, 2.0)), [1.0, 2.0, 4.0]),
}


def _jax_run(case, **kw):
    fns, target, hmc, temps = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        return jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _target(jmc, target), jmc.HMC(**hmc), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42,
            temperatures=temps, **kw)


def _port_run(case, monkeypatch, **kw):
    fns, target, hmc, temps = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_pt_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_pt, "mcmc_pt_cuda", spy)
    with _flushing_subnormals():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, _target(tm, target), tm.HMC(**hmc), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42,
            temperatures=temps, **kw)
    assert len(outs) == 1
    return r, outs[0].x_final.numpy()


def _jax_final(r):
    x = np.asarray(r.samples[-1])  # (chains, d), or (chains,)
    return x.reshape(x.shape[0], -1).T


@pytest.mark.parametrize("case", list(CASES))
def test_plain_tempered_hmc_matches_jax_interpret_kernel(case, monkeypatch):
    want = _jax_run(case, return_samples=N_STEPS)
    got, x_port = _port_run(case, monkeypatch)
    x_jax = _jax_final(want)
    assert x_port.shape == x_jax.shape
    split = float(np.mean(np.any(
        np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax)), axis=0)))
    limit, atol = {"table": (TABLE_SPLIT, TABLE_ATOL),
                   "banana-adaptive": (ADAPT_SPLIT, ADAPT_ATOL)}.get(
        case, (MAX_SPLIT, None))
    assert split <= limit, f"{split:.2%} of the chains split"
    size = np.maximum(np.abs(np.asarray(want.values)), 1.0)
    mean_tol = MEAN_ATOL * size if atol is None else atol * size
    assert np.all(np.abs(got.values - want.values) <= mean_tol), (
        got.values, want.values)
    rate_tol = ACCEPT_ATOL if atol is None else atol
    assert abs(got.acceptance_rate - want.acceptance_rate) <= rate_tol
    assert abs(got.diagnostics["swap_rate"]
               - want.diagnostics["swap_rate"]) <= rate_tol
    assert mcmc_pt_cuda.hmc_launches == 0  # the CPU runs the plain version


def test_cold_rung_diagnostics_and_draws_match_jax(monkeypatch):
    kw = dict(return_diagnostics=True, return_samples=20)
    want = _jax_run("logmix", **kw)
    got, _ = _port_run("logmix", monkeypatch, **kw)
    np.testing.assert_allclose(got.diagnostics["r_hat"],
                               want.diagnostics["r_hat"], rtol=R_HAT_RTOL)
    np.testing.assert_allclose(got.diagnostics["ess"], want.diagnostics["ess"],
                               rtol=ESS_RTOL)
    # The port's draws hold every chain its kernel runs, as the JAX
    # kernel's: the cold rung's post-swap states every third step.
    draws = np.asarray(want.samples)
    assert got.samples.shape == draws.shape
    apart = np.abs(got.samples - draws) > SPLIT_RTOL * (1.0 + np.abs(draws))
    assert apart.mean() <= DRAW_SPLIT


# -- the JAX package's tempered HMC tests on the port ---------------------------


@pytest.fixture(scope="module")
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


def _run(integ, fns, target, proposal, **kw):
    with _flushing_subnormals():
        return integ.integrate_mcmc(fns, target, proposal, **kw)


def test_hmc_tempered(integ):
    pt = _run(integ, [lambda x: x], logmix,
              tm.HMC(step_size=0.3, n_leapfrog=5, init_range=(3.0, 5.0)),
              n_steps=2000, n_chains=512, n_burnin=500, seed=5,
              temperatures=LADDER)
    assert abs(pt.values[0]) < 0.4
    assert pt.acceptance_rate > 0.6


def test_tempered_hmc_table_target_in_kernel(integ):
    r = _run(integ, [lambda v: v], tm.Distribution.beta(2.0, 5.0),
             tm.HMC(step_size=0.05, n_leapfrog=5, init_range=(0.05, 0.95)),
             n_steps=1200, n_chains=1024, n_burnin=300, seed=9,
             temperatures=[1.0, 2.0])
    assert abs(r.values[0] - 2.0 / 7.0) < 0.02


def test_hmc_2d_joint(integ):
    pt = _run(integ, [lambda x, y: x, lambda x, y: y], banana,
              tm.HMC(step_size=0.15, n_leapfrog=5, adapt=True,
                     init_range=(-2.0, 2.0)),
              n_steps=300, n_chains=512, n_burnin=200, seed=4,
              temperatures=[1.0, 2.0, 4.0])
    assert abs(pt.values[0]) < 0.4


def test_c12b_exact_value(integ):
    # The reference's c12b (benchmarks/run_all.py:542-553) at a small
    # shape: E[x^2] = 17 within 6 error bars and the JAX test's 2.0.
    r = _run(integ, [lambda x: x * x], logmix,
             tm.HMC(step_size=0.35, n_leapfrog=8, init_range=(3.0, 5.0)),
             n_steps=600, n_chains=1024, n_burnin=200, seed=42,
             temperatures=[1.0, 2.0, 4.0, 8.0], return_stderr=True)
    assert abs(r.values[0] - 17.0) < min(2.0, 6.0 * r.stderr[0] + 0.5)
    assert 0.0 < r.diagnostics["swap_rate"] < 1.0
