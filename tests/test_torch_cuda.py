"""The port's CUDA integrate kernel against its plain PyTorch version.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed; the
repository's ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel and the plain version draw the same samples and evaluate the
same float32 operations, so their means agree to float32 summation order
and last-bit libm differences: rel 1e-5 + abs 1e-6.
"""

import math

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
from tpu_montecarlo_torch.sampling import dist_spec_of

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
