"""CUSTOM dimensions in the port's tempered MCMC kernel against the JAX
package.

The plain version of the tempered kernel runs the ladders of the
interpret-mode JAX kernel ``build_pt_mcmc_fn_pallas``, both reached
through their public calls (``MonteCarloIntegrator(backend="pallas")`` on
the CPU; the JAX kernel's final cold states are its last thinned draw):
BASELINE's c12d cell scaled down (the bimodal table target under a
table proposal in sampler mode, T = 4), adaptive walks on a table target
at T = 2 and 4, and a two-dimensional product with a sampler-mode
dimension at T = 2, with error bars.  As in ``tests/test_torch_tempering.py``
the port runs with float32 subnormals flushed, as XLA's CPU backend runs
(the port's kernel keeps them).  Tolerances: at most 1 % of the chains
split, means within 1e-5, acceptance and swap rates within 1e-4, error
bars within rel 1e-3.  The CUDA kernel is held against the plain version
in ``test_torch_cuda.py``.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import tempering as api_pt
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

N_CHAINS, N_STEPS, N_BURNIN = 1024, 40, 10
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
VALUE_ATOL = 1e-5
RATE_ATOL = 1e-4
STDERR_RTOL = 1e-3
LADDER4 = [1.0, 2.0, 4.0, 8.0]


def bimodal(x):
    # BASELINE config 5's target (benchmarks/run_all.py:185-188).
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


def wide(x):
    # c12d's proposal density (run_all.py:570-585).
    return np.exp(-0.5 * (x / 3.0) ** 2)


def _dist(pkg, name):
    d = pkg.Distribution
    return {
        "bimodal": lambda: d.from_pdf(bimodal, support=(-6.0, 6.0)),
        "wide": lambda: d.from_pdf(wide, support=(-7.0, 7.0)),
        "beta": lambda: d.beta(2.0, 5.0),
        "n01": lambda: d.normal(0.0, 1.0),
        "n02": lambda: d.normal(0.0, 2.0),
    }[name]()


def _make(pkg, spec):
    if isinstance(spec, dict):
        return pkg.RandomWalk(**spec)
    if isinstance(spec, str):
        return _dist(pkg, spec)
    return [_dist(pkg, s) for s in spec]


F1 = [lambda x: x, lambda x: x * x]
F2 = [lambda x, y: x * y, lambda x, y: x + y * y]
WALK = dict(step_size=1.0, adapt=True, init_range=(-3.0, 3.0))
# id: (fns, target, proposal, temperatures, stderr).
CASES = {
    # c12d (run_all.py:570-585), scaled down.
    "c12d": (F1, "bimodal", "wide", LADDER4, True),
    "walk-table-target-T2": (F1, "bimodal", WALK, [1.0, 2.0], False),
    "walk-table-product-T4": (F2, ["bimodal", "n01"], WALK, LADDER4, True),
    "sampler-dimension-T2": (F2, ["beta", "n01"], ["beta", "n02"], [1.0, 2.5],
                             True),
}


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


def _run_kw(case):
    temps, stderr = CASES[case][3:]
    return dict(n_steps=N_STEPS, n_chains=N_CHAINS, n_burnin=N_BURNIN,
                seed=42, temperatures=temps, return_stderr=stderr)


def _jax_run(case):
    fns, target, proposal, _, _ = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback to the XLA sweep
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _make(jmc, target), _make(jmc, proposal),
            return_samples=N_STEPS, **_run_kw(case),
        )
    x = np.asarray(r.samples[-1])
    return r, x.reshape(x.shape[0], -1)


def _port_run(case, monkeypatch):
    fns, target, proposal, _, _ = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_pt_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_pt, "mcmc_pt_cuda", spy)
    with _flushing_subnormals():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, _make(tm, target), _make(tm, proposal), **_run_kw(case))
    assert len(outs) == 1
    return r, outs[0].x_final.numpy().T


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case, monkeypatch):
    want, x_jax = _jax_run(case)
    got, x_port = _port_run(case, monkeypatch)
    assert x_port.shape == x_jax.shape
    split = (np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))).any(axis=1)
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    np.testing.assert_allclose(got.values, np.asarray(want.values, np.float64),
                               rtol=0.0, atol=VALUE_ATOL)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= RATE_ATOL
    assert abs(got.diagnostics["swap_rate"]
               - want.diagnostics["swap_rate"]) <= RATE_ATOL
    assert 0.0 < got.diagnostics["swap_rate"] < 1.0
    if CASES[case][4]:
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)


def test_c12d_is_near_its_moments():
    # E[X] = 0 and E[X^2] = 5 under the bimodal target; 6 error bars.
    r = tm.integrate_mcmc(F1, _make(tm, "bimodal"), _make(tm, "wide"),
                          n_steps=200, n_chains=1024, n_burnin=50,
                          temperatures=LADDER4, return_stderr=True,
                          device="cpu")
    assert abs(r.values[0]) < 6.0 * r.stderr[0]
    assert abs(r.values[1] - 5.0) < 6.0 * r.stderr[1]
