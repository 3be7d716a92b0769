"""nd Hamiltonian Monte Carlo in the port (``HMC`` proposals over d
dimensions) against the JAX package.

* The plain version against the interpret-mode JAX kernel
  (``build_mcmc_nd_pallas(..., hmc_leapfrog=L)``, through the JAX
  package's ``backend="pallas"`` calls), chain for chain over a short run
  of N_CHAINS x (N_BURNIN + N_STEPS): joint targets (c11b's, the rho =
  0.6 joint of ``tests/test_hmc.py``, one and three arguments) whose
  gradient is ``ops/grad.py``'s, and products of closed-form, extended
  and CUSTOM table dimensions.  At a fixed step at most MAX_SPLIT of the
  chains end more than 1e-4 (relative) apart in any dimension (measured:
  none), means within 1e-5 of the column's size, acceptance within
  ACCEPT_ATOL.  A table dimension's gradient is piecewise constant, so a
  last-bit difference in a momentum (torch's and XLA's ``erfinv``) moves
  a trajectory across a knot in one version only (measured: 1.8 % split,
  means 3.2e-5 of the column's size and acceptance 4.9e-5 apart); the
  Laplace x Gumbel product's gradients take torch's and XLA's ``exp``
  (measured: 0.2 % split, 6.5e-5 and 1.6e-5); those hold TABLE_SPLIT
  split and TABLE_ATOL.
  Under the adaptive step every chain's step carries the ulp differences
  of torch's and XLA's ``exp`` and ``log``, and the adaptation feeds them
  back into the trajectories: a one-ulp change of the step splits 41 % of
  the port's own c11b chains over 80 steps.  Against the JAX kernel the
  adaptive c11b case splits 38.6 % of its chains, with means 7.2e-4 of
  the column's size and acceptance 9.4e-4 apart (measured), so it holds
  at most ADAPT_SPLIT split and its means and acceptance within
  ADAPT_ATOL.
* The nd HMC cases of ``tests/test_hmc.py`` (``TestNdHmc`` and the
  in-kernel ones) on the port, to their own tolerances; the sharded case
  stays out (queue 1 item 12).
* The JAX package's errors word for word: a joint target without
  ``init_range``, an adaptive step without burn-in or with chain state.
* Chain state: the JAX package runs nd HMC with state on its XLA sweep
  (keyed on ``jax.random``); the port runs it in its nd kernel, segment 0
  the stateless run's chains bit for bit.  The two agree statistically:
  the two-call means within 6 combined standard errors.

The CUDA kernel is held against the plain version in
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
from tpu_montecarlo_torch.api import mcmc_nd as api_nd
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda

N_CHAINS, N_STEPS, N_BURNIN = 512, 60, 20
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.0
ACCEPT_ATOL, MEAN_ATOL = 1e-4, 1e-5
TABLE_SPLIT, TABLE_ATOL = 0.03, 5e-3
ADAPT_SPLIT, ADAPT_ATOL = 0.45, 0.005

RHO = 0.8
C11B = 1.0 / (2.0 * (1.0 - RHO * RHO))


def c11b(x, y):
    return -C11B * (x * x - 2.0 * RHO * x * y + y * y)


def rho6(x, y):
    return -0.5 * (x * x - 2 * 0.6 * x * y + y * y) / (1 - 0.6 * 0.6)


def normal_1d(x):
    return -0.5 * (x - 1.0) * (x - 1.0) / 4.0


def ring3(x, y, z):
    r = math.sqrt(x * x + y * y + z * z + 1.0)
    return -0.5 * (r - 2.0) ** 2 - 0.1 * z * z


def tri(x):
    return 1.0 - abs(x) if abs(x) < 1 else 0.0


@contextlib.contextmanager
def _flushing_subnormals():
    """One torch thread with float32 subnormals flushed, as XLA's CPU
    backend runs (``tests/test_torch_tempering.py``)."""
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
    return [d.from_pdf(tri) if s == "tri" else getattr(d, s[0])(*s[1:])
            for s in spec]


# case: (functions, target, HMC arguments)
CASES = {
    "c11b": ([lambda x, y: x * y], c11b,
             dict(step_size=0.4, n_leapfrog=8, init_range=(-4.0, 4.0))),
    "rho6": ([lambda x, y: x * y, lambda x, y: x * x], rho6,
             dict(step_size=0.35, n_leapfrog=9, init_range=(-2.0, 2.0))),
    "joint-1d": ([lambda x: x, lambda x: x * x], normal_1d,
                 dict(step_size=0.5, n_leapfrog=6, init_range=(-3.0, 3.0))),
    "joint-3d": ([lambda x, y, z: x * x + y * y, lambda x, y, z: z], ring3,
                 dict(step_size=[0.3, 0.3, 0.5], n_leapfrog=7,
                      init_range=(-2.0, 2.0))),
    "product": ([lambda x, y: x, lambda x, y: y * y],
                [("normal", 0.0, 10.0), ("normal", 0.0, 1.0)],
                dict(step_size=[2.0, 0.2], n_leapfrog=8)),
    "families": ([lambda x, y: x * y, lambda x, y: x + y],
                 [("laplace", 3.0, 1.0), ("gumbel", 1.0, 0.5)],
                 dict(step_size=[0.5, 0.2], n_leapfrog=6)),
    "table": ([lambda x, y: x + y, lambda x, y: y * y],
              [("normal", 1.0, 1.0), "tri"],
              dict(step_size=[0.2, 0.1], n_leapfrog=8,
                   init_range=[(-1.0, 3.0), (-0.9, 0.9)])),
    "c11b-adaptive": ([lambda x, y: x * y], c11b,
                      dict(step_size=0.4, n_leapfrog=8, adapt=True,
                           init_range=(-4.0, 4.0))),
}


def _jax_run(case, **kw):
    fns, target, hmc = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        return jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _target(jmc, target), jmc.HMC(**hmc), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42,
            return_samples=N_STEPS, **kw)


def _port_run(case, monkeypatch, **kw):
    fns, target, hmc = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_nd_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_nd, "mcmc_nd_cuda", spy)
    with _flushing_subnormals():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, _target(tm, target), tm.HMC(**hmc), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42, **kw)
    assert len(outs) == 1
    return r, outs[0].x_final.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_nd_hmc_matches_jax_interpret_kernel(case, monkeypatch):
    want = _jax_run(case)
    got, x_port = _port_run(case, monkeypatch)
    x_jax = np.asarray(want.samples[-1])  # (chains, d), or (chains,)
    x_jax = x_jax.reshape(x_jax.shape[0], -1).T
    assert x_port.shape == x_jax.shape
    split = float(np.mean(np.any(
        np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax)), axis=0)))
    limit, atol = {"table": (TABLE_SPLIT, TABLE_ATOL),
                   "families": (TABLE_SPLIT, TABLE_ATOL),
                   "c11b-adaptive": (ADAPT_SPLIT, ADAPT_ATOL)}.get(
        case, (MAX_SPLIT, None))
    assert split <= limit, f"{split:.2%} of the chains split"
    size = np.maximum(np.abs(np.asarray(want.values)), 1.0)
    mean_tol = MEAN_ATOL * size if atol is None else atol * size
    assert np.all(np.abs(got.values - want.values) <= mean_tol), (
        got.values, want.values)
    accept_tol = ACCEPT_ATOL if atol is None else atol
    assert abs(got.acceptance_rate - want.acceptance_rate) <= accept_tol
    assert mcmc_nd_cuda.hmc_launches == 0  # the CPU runs the plain version


# -- the JAX package's nd HMC tests on the port ---------------------------------


@pytest.fixture(scope="module")
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


def _run(integ, fns, target, proposal, **kw):
    with _flushing_subnormals():
        return integ.integrate_mcmc(fns, target, proposal, **kw)


def test_joint_target_correlation(integ):
    r = _run(integ, [lambda x, y: x * y], rho6,
             tm.HMC(step_size=0.3, n_leapfrog=10, init_range=(-2.0, 2.0)),
             n_steps=3000, n_chains=512, n_burnin=300, seed=61)
    assert abs(r.values[0] - 0.6) < 0.08


def test_nd_joint_target_in_kernel(integ):
    r = _run(integ, [lambda x, y: x * y], rho6,
             tm.HMC(step_size=0.35, n_leapfrog=9, init_range=(-2.0, 2.0)),
             n_steps=2500, n_chains=512, n_burnin=300, seed=29)
    assert abs(r.values[0] - 0.6) < 0.08


def test_product_target_with_table_dim(integ):
    r = _run(integ, [lambda x, y: x + y, lambda x, y: y * y],
             [tm.Distribution.normal(1.0, 1.0), tm.Distribution.from_pdf(tri)],
             tm.HMC(step_size=0.2, n_leapfrog=8, adapt=True,
                    init_range=[(-1.0, 3.0), (-0.9, 0.9)]),
             n_steps=3000, n_chains=512, n_burnin=500, seed=67)
    assert abs(r.values[0] - 1.0) < 0.1
    assert abs(r.values[1] - 1.0 / 6.0) < 0.05


def test_per_dimension_steps(integ):
    r = _run(integ, [lambda x, y: x, lambda x, y: y * y],
             [tm.Distribution.normal(0.0, 10.0), tm.Distribution.normal(0.0, 1.0)],
             tm.HMC(step_size=[2.0, 0.2], n_leapfrog=8), n_steps=2000,
             n_chains=512, n_burnin=300, seed=71)
    assert abs(r.values[0]) < 1.0
    assert abs(r.values[1] - 1.0) < 0.15


def test_nd_product_adaptive_with_stderr(integ):
    r = _run(integ, [lambda x, y: x, lambda x, y: y * y],
             [tm.Distribution.normal(0.0, 10.0), tm.Distribution.normal(0.0, 1.0)],
             tm.HMC(step_size=[2.0, 0.2], n_leapfrog=8, adapt=True),
             n_steps=2000, n_chains=512, n_burnin=500, seed=31,
             return_stderr=True)
    assert abs(r.values[0]) < 1.0
    assert abs(r.values[1] - 1.0) < 0.15
    assert r.stderr[1] > 0


def test_nd_diagnostics_and_samples(integ):
    r = _run(integ, [lambda x, y: x * x + y * y],
             lambda x, y: -0.5 * (x * x + y * y),
             tm.HMC(step_size=0.9, n_leapfrog=8, init_range=(-2.0, 2.0)),
             n_steps=1000, n_chains=512, n_burnin=200, seed=79,
             return_diagnostics=True, return_samples=20)
    assert r.diagnostics["r_hat"][0] < 1.02
    # The port's draws hold every chain the kernel runs (at least 1024).
    assert r.samples.shape == (20, 1024, 2)
    assert abs(r.values[0] - 2.0) < 0.1


def test_module_level_entry_and_d1_joint_target():
    # A 1-D callable target under HMC takes the nd path (its d = 1 case).
    with _flushing_subnormals():
        r = tm.integrate_mcmc([lambda x: x], normal_1d,
                              tm.HMC(step_size=0.5, n_leapfrog=6,
                                     init_range=(-3.0, 3.0)),
                              n_steps=1500, n_chains=512, n_burnin=200,
                              seed=19, device="cpu")
    assert abs(r.values[0] - 1.0) < 0.1


def test_hmc_from_reference_carries_per_dimension_steps():
    kw = dict(step_size=[0.3, 0.4], n_leapfrog=5, adapt=True,
              init_range=[(-1.0, 1.0), (0.0, 2.0)])
    back = tm.RandomWalk.from_reference(jmc.HMC(**kw))
    assert type(back) is tm.HMC and repr(back) == repr(jmc.HMC(**kw))
    np.testing.assert_array_equal(
        back.pack_params_nd(None, 2),
        jmc.HMC(**kw).pack_params_nd(None, 2))


# -- the errors ----------------------------------------------------------------


@pytest.mark.parametrize("hmc,kwargs", [
    (dict(step_size=0.3), {}),                            # no init_range
    (dict(adapt=True, init_range=(-2.0, 2.0)), {"n_burnin": 0}),
    (dict(adapt=True, init_range=(-2.0, 2.0)), {"return_state": True}),
])
def test_errors_match_jax(integ, hmc, kwargs):
    kw = dict(n_steps=100, n_chains=256, n_burnin=10, seed=73)
    kw.update(kwargs)
    with pytest.raises(ValueError) as want:
        jmc.MonteCarloIntegrator().integrate_mcmc(
            [lambda x, y: x], lambda x, y: -(x * x + y * y), jmc.HMC(**hmc),
            **kw)
    with pytest.raises(ValueError) as got:
        integ.integrate_mcmc([lambda x, y: x], lambda x, y: -(x * x + y * y),
                             tm.HMC(**hmc), **kw)
    assert str(got.value) == str(want.value)


# -- chain state -----------------------------------------------------------------


def test_stateful_nd_hmc_segment_zero_is_the_stateless_run(integ):
    kw = dict(n_steps=200, n_chains=1024, n_burnin=50, seed=5)
    hmc = tm.HMC(step_size=0.4, n_leapfrog=8, init_range=(-4.0, 4.0))
    with _flushing_subnormals():
        bare = integ.integrate_mcmc([lambda x, y: x * y], c11b, hmc, **kw)
        r = integ.integrate_mcmc([lambda x, y: x * y], c11b, hmc,
                                 return_state=True, **kw)
    np.testing.assert_array_equal(r.values, bare.values)
    assert r.acceptance_rate == bare.acceptance_rate
    assert r.chain_state.segment == 0 and r.chain_state.x.shape == (2, 1024)


def test_stateful_nd_hmc_agrees_with_jax_xla_sweep(integ):
    kw = dict(n_steps=600, n_chains=1024, seed=11)
    fns = [lambda x, y: x * y, lambda x, y: x * x]

    def two_calls(pkg, run):
        hmc = pkg.HMC(step_size=0.4, n_leapfrog=8, init_range=(-4.0, 4.0))
        r1 = run(fns, c11b, hmc, n_burnin=200, return_state=True, **kw)
        r2 = run(fns, c11b, hmc, n_burnin=0, initial_state=r1.chain_state,
                 return_state=True, **kw)
        return 0.5 * (np.asarray(r1.values) + np.asarray(r2.values))

    got = two_calls(tm, lambda *a, **k: _run(integ, *a, **k))
    want = two_calls(jmc, jmc.MonteCarloIntegrator().integrate_mcmc)
    one = _run(integ, fns, c11b, tm.HMC(step_size=0.4, n_leapfrog=8,
                                        init_range=(-4.0, 4.0)),
               n_burnin=200, return_stderr=True, **dict(kw, n_steps=1200))
    se = np.asarray(one.stderr) * math.sqrt(2.0)
    assert np.all(np.abs(got - want) <= 6.0 * se), (got, want, se)
    assert np.all(np.abs(got - np.array([0.8, 1.0])) <= 6.0 * se)
