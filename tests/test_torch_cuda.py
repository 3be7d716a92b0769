"""The port's CUDA kernels (integrate, MCMC) against their plain PyTorch
versions.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed; the
repository's ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The integrate kernel and its plain version draw the same samples and
evaluate the same float32 operations, so their means agree to float32
summation order and last-bit libm differences: rel 1e-5 + abs 1e-6.  The
MCMC tolerances are stated above their tests.
"""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.integrate_kernel import (
    MAX_FUNCTIONS,
    IntegrateProgram,
    integrate_cuda,
    integrate_reference,
    plan_grid,
)
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    McmcConfig,
    McmcProgram,
    Mode,
    mcmc_cuda,
    mcmc_finish,
    mcmc_reference,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of

BENCH = [
    lambda x: x,
    lambda x: x * x,
    lambda x: x * x * x,
    lambda x: x * x * x * x,
    lambda x: np.sin(x),
    lambda x: np.exp(-x * x),
    lambda x: x > 1.0,
    lambda x: abs(x),
]
RTOL, ATOL = 1e-5, 1e-6


def _family(c):
    def branchy(x):
        if x > c:
            return math.exp(-abs(x)) * c
        return (x - c) ** 2

    return [
        lambda x: x + c,
        lambda x: np.sin(c * x) + np.tanh(x),
        lambda x: (x > c) & (x < c + 0.5),
        branchy,
    ]


# MAX_FUNCTIONS integrands: the most the kernel fuses in one pass.
WIDEST = [f for i in range(MAX_FUNCTIONS // 4) for f in _family(i / 32.0)]
DISTS = [
    tm.Distribution.uniform(-1.0, 2.0),
    tm.Distribution.normal(0.5, 1.5),
    tm.Distribution.exponential(2.0),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_and_plain(fns, dist, device, n_samples):
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in fns))
    grid = plan_grid(n_samples)
    spec = dist_spec_of(dist)
    params = torch.tensor(spec.params, device=device)
    before = integrate_cuda.launches
    got = integrate_cuda(program, spec.kind, params, 42, grid)
    torch.cuda.synchronize()
    assert integrate_cuda.launches == before + 1
    want = integrate_reference(program.torch_fns, spec.kind, params, 42, grid)
    n = grid.actual_samples
    return got.double().cpu().numpy() / n, want.double().cpu().numpy() / n


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS, ids=["uniform", "normal", "exponential"])
def test_kernel_matches_plain_version(cuda_device, dist):
    got, want = _kernel_and_plain(BENCH, dist, cuda_device, 1 << 22)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS, ids=["uniform", "normal", "exponential"])
def test_widest_kernel_matches_plain_version(cuda_device, dist):
    got, want = _kernel_and_plain(WIDEST, dist, cuda_device, 1 << 20)
    assert got.shape == (MAX_FUNCTIONS,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_integrate_on_cuda_matches_cpu(cuda_device):
    d = tm.Distribution.normal(0.0, 1.0)
    before = integrate_cuda.launches
    got = tm.integrate(BENCH, d, n_samples=2_000_000, device=cuda_device)
    assert integrate_cuda.launches == before + 1
    want = tm.integrate(BENCH, d, n_samples=2_000_000, device="cpu")
    np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_bad_params(cuda_device):
    program = IntegrateProgram((tm.trace_function(BENCH[0]),))
    spec = dist_spec_of(DISTS[1])
    params = torch.tensor(spec.params, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        integrate_cuda(program, spec.kind, params, 42, plan_grid(1000))


# -- the MCMC kernel ----------------------------------------------------------
#
# The kernel and the plain version run the same chains (same counters, same
# float32 operation order); a last-bit difference between CUDA's logf,
# expf, erfinvf and torch's can still flip an accept decision near a tie
# and split a chain off.  So: at most 1% of the chains may end more than
# 1e-3 (relative) apart, the acceptance rates agree within 1e-3, and the
# means within 0.2 standard errors (a 1% share of split chains moves a mean
# by far less than that) plus 1e-6 for float32 summation order.  The error
# bars come from the same chain means, but a block's SS is s2 - n_b*mean^2
# in float32 (as in the JAX kernel), and the pilot shift, a mean under the
# initial distribution, can leave chain means far from 0: then the two
# summation orders differ by ~1e-5 to 3e-4 relative on an H100 (more with
# more steps).  A wrong SS or centroid row (n_b - 1 for n_b, a dropped
# pilot restore) moves them by 1.6% or more.
STDERR_RTOL = 1e-3

MCMC_FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: np.sin(x),
    lambda x: x > 1.0,
]
_N, _U, _E = DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL
_WALK = [0.8, -2.3, 2.3, 0.44]
MCMC_CASES = {
    "independence-normal": (Mode.INDEPENDENCE, _N, _N, [0.0, 2.0, 0, 0, 0.0, 1.0], False),
    "uniform-exponential": (Mode.INDEPENDENCE, _U, _E, [0.0, 6.0, 0, 0, 1.5, 0.0], False),
    "exponential-exponential": (Mode.INDEPENDENCE, _E, _E, [1.0, 0.0, 0, 0, 2.0, 0.0], False),
    "random-walk": (Mode.RANDOM_WALK, _N, _N, _WALK + [0.0, 1.0], False),
    "adaptive-walk": (Mode.ADAPTIVE, _N, _N, _WALK + [0.0, 1.0], False),
    "stderr": (Mode.INDEPENDENCE, _N, _N, [0.0, 2.0, 0, 0, 0.0, 1.0], True),
    "adaptive-walk-stderr-uniform": (Mode.ADAPTIVE, _U, _U, [0.5, -1.0, 2.0, 0.44, -1.0, 2.0], True),
}


def _mcmc_kernel_and_plain(case, device, n_chains, n_steps, n_burnin):
    mode, prop, targ, row, stderr = MCMC_CASES[case]
    program = McmcProgram(tuple(tm.trace_function(f) for f in MCMC_FNS))
    cfg = McmcConfig(mode, prop, targ, n_steps, n_burnin, stderr)
    grid = plan_mcmc_grid(plan_chains(n_chains, None))
    params = torch.tensor(row, dtype=torch.float32, device=device)
    before = mcmc_cuda.launches, mcmc_cuda.pilot_launches
    got = mcmc_cuda(program, cfg, params, 42, grid)
    torch.cuda.synchronize()
    assert mcmc_cuda.launches == before[0] + 1
    assert mcmc_cuda.pilot_launches == before[1] + int(stderr)
    want = mcmc_reference(program.torch_fns, cfg, params, 42, grid)
    return cfg, grid, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_mcmc_kernel_matches_plain_version(cuda_device, case):
    cfg, grid, got, want = _mcmc_kernel_and_plain(
        case, cuda_device, n_chains=4096, n_steps=1000, n_burnin=200
    )
    k = len(MCMC_FNS)
    x_k, x_p = got.x_final.cpu(), want.x_final.cpu()
    assert x_k.shape == (grid.chains_actual,) and torch.isfinite(x_k).all()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).float().mean()
    assert split <= 0.01, f"{float(split):.2%} of the chains split"
    v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
    v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
    # The rows carry each block's SS and centroid in every mode.
    _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    np.testing.assert_array_less(
        (v_k - v_p).abs().cpu().numpy(), (0.2 * se + 1e-6).cpu().numpy()
    )
    if cfg.with_stderr:
        np.testing.assert_allclose(
            s_k.cpu().numpy(), s_p.cpu().numpy(), rtol=STDERR_RTOL
        )


@pytest.mark.cuda
def test_integrate_mcmc_on_cuda_matches_cpu(cuda_device):
    kw = dict(n_steps=500, n_chains=2048, n_burnin=100, seed=3,
              return_stderr=True)
    target = tm.Distribution.normal(0.5, 1.5)
    for proposal in (tm.Distribution.normal(0.0, 3.0), tm.RandomWalk(adapt=True)):
        before = mcmc_cuda.launches, mcmc_cuda.pilot_launches
        got = tm.integrate_mcmc(MCMC_FNS, target, proposal,
                                device=cuda_device, **kw)
        assert mcmc_cuda.launches == before[0] + 1
        assert mcmc_cuda.pilot_launches == before[1] + 1
        want = tm.integrate_mcmc(MCMC_FNS, target, proposal, device="cpu", **kw)
        assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
        np.testing.assert_array_less(
            np.abs(got.values - want.values), 0.2 * want.stderr + 1e-6
        )
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)


@pytest.mark.cuda
def test_mcmc_kernel_rejects_bad_params(cuda_device):
    program = McmcProgram((tm.trace_function(MCMC_FNS[0]),))
    cfg = McmcConfig(Mode.INDEPENDENCE, _N, _N, 10, 0)
    params = torch.zeros(6, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        mcmc_cuda(program, cfg, params, 42, plan_mcmc_grid(1024))
