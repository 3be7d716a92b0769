"""The port's fused 1-D ``integrate`` slice, end to end.

On the CPU the port runs its plain PyTorch version, which draws the very
samples the JAX kernel draws in interpret mode (``CounterRng``), so the
two agree far inside the statistical tolerance: within 1e-5 per mean,
against 2.8e-7 measured for the bench set.  The margin lets one indicator
sample near x = 1 flip between the two packages' erfinv (4.4e-6 each at
~2.3e5 samples).  The CUDA kernel is held against the plain version in
``test_torch_cuda.py``.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import tpu_montecarlo as jmc
from tpu_montecarlo.ops.integrate_pallas import (
    build_integrate_fn_pallas,
    pick_block_rows,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.integrate_kernel import (
    IntegrateProgram,
    integrate_cuda,
    integrate_reference,
    plan_grid,
)
from tpu_montecarlo_torch.sampling import DistKind
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

REPO = Path(__file__).resolve().parents[1]

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
PAIR = [lambda x: x, lambda x: (x - 0.5) ** 2]

N_SMALL = 200_000
THREADS = 1024
CPU_CHUNK = 1 << 22  # the JAX package's max_chunk_elems off the TPU


@pytest.mark.parametrize(
    "make_dist,fns",
    [
        (lambda: jmc.Distribution.normal(0.0, 1.0), BENCH),
        (lambda: jmc.Distribution.uniform(-1.0, 2.0), PAIR),
        (lambda: jmc.Distribution.exponential(2.0), PAIR),
    ],
    ids=["normal-bench8", "uniform", "exponential"],
)
def test_slice_matches_jax_interpret_kernel(make_dist, fns):
    jdist = make_dist()
    spec = j_dist_spec_of(jdist)
    k = len(fns)
    plan = j_plan(N_SMALL, THREADS, max_chunk_elems=CPU_CHUNK)
    # The same plan on both sides: the port's explicit-chunk plan, and the
    # default-chunk plan the public API uses, which is equal at this size.
    port_plan = make_integrate_plan(N_SMALL, THREADS, max_chunk_elems=CPU_CHUNK)
    assert port_plan == make_integrate_plan(N_SMALL, THREADS)
    assert (
        port_plan.total_threads, port_plan.loops_per_chunk,
        port_plan.n_chunks, port_plan.actual_samples,
    ) == (
        plan.total_threads, plan.loops_per_chunk, plan.n_chunks,
        plan.actual_samples,
    )
    # The port's stream geometry is 256-row blocks; so is the JAX one here.
    assert pick_block_rows(k, spec.kind, plan_samples=plan.actual_samples) == 256

    run = build_integrate_fn_pallas(
        tuple(j_trace(f) for f in fns), spec.kind, plan, interpret=True
    )
    dummy = np.zeros(1, np.float32)
    want = np.asarray(run(np.uint32(42), spec.params, dummy, dummy))
    assert plan_grid(port_plan.actual_samples).actual_samples == run.actual_samples

    got = tm.integrate(
        fns, tm.Distribution.from_reference(jdist), n_samples=N_SMALL,
        seed=42, target_threads=THREADS, device="cpu",
    )
    assert got.values.dtype == np.float64 and got.values.shape == (k,)
    np.testing.assert_allclose(got.values, want, rtol=0, atol=1e-5)


# -- the reference tolerances (tests/test_integrator.py) on the port ----------


def test_normal_moments_to_fourth():
    r = tm.integrate(
        [lambda x: x, lambda x: x * x, lambda x: x ** 3, lambda x: x ** 4],
        tm.Distribution.normal(0.0, 1.0), n_samples=10_000_000, device="cpu",
    )
    assert abs(r.values[0]) < 0.01
    assert abs(r.values[1] - 1.0) < 0.01
    assert abs(r.values[2]) < 0.01
    assert abs(r.values[3] - 3.0) < 0.01


def test_uniform_mean_and_variance():
    r = tm.integrate(
        PAIR, tm.Distribution.uniform(0.0, 1.0), n_samples=2_000_000,
        device="cpu",
    )
    assert abs(r.values[0] - 0.5) < 0.01
    assert abs(r.values[1] - 1.0 / 12.0) < 0.01


def test_exponential_mean_and_variance():
    lam = 2.0
    r = tm.integrate(
        [lambda x: x, lambda x: (x - 0.5) ** 2],
        tm.Distribution.exponential(lam), n_samples=2_000_000, device="cpu",
    )
    assert abs(r.values[0] - 1.0 / lam) < 0.01
    assert abs(r.values[1] - 1.0 / lam**2) < 0.01


def test_indicator_and_shifted_normal():
    r = tm.integrate(
        [lambda x: x > 1.0, lambda x: x, lambda x: (x - 3.0) ** 2],
        tm.Distribution.normal(3.0, 2.0), n_samples=2_000_000, device="cpu",
    )
    assert abs(r.values[0] - 0.8413447) < 0.005  # P(X > 1) = Phi(1)
    assert abs(r.values[1] - 3.0) < 0.01
    assert abs(r.values[2] - 4.0) < 0.02


def test_math_constants_and_polynomial():
    r = tm.integrate(
        [lambda x: math.pi, lambda x: math.e, lambda x: 2 * x * x + 3 * x + 1],
        tm.Distribution.normal(0.0, 1.0), n_samples=1_000_000, device="cpu",
    )
    assert abs(r.values[0] - math.pi) < 1e-5
    assert abs(r.values[1] - math.e) < 1e-5
    assert abs(r.values[2] - 3.0) < 0.05


def test_result_object_semantics():
    r = tm.integrate(
        [lambda x: x, lambda x: 1.0 - x], tm.Distribution.uniform(0.0, 1.0),
        n_samples=10_000, device="cpu",
    )
    assert isinstance(r, tm.IntegrationResult)
    assert r.values.dtype == np.float64
    assert r.n_samples == 10_000 and r.n_functions == 2 and len(r) == 2
    assert r[0] == r.values[0]
    assert "IntegrationResult" in repr(r)
    assert r.acceptance_rate is None and r.stderr is None


def test_seeds():
    integ = tm.MonteCarloIntegrator(device="cpu")
    d = tm.Distribution.normal(0.0, 1.0)
    r1 = integ.integrate([lambda x: x * x], d, n_samples=100_000, seed=7)
    r2 = integ.integrate([lambda x: x * x], d, n_samples=100_000, seed=7)
    r3 = integ.integrate([lambda x: x * x], d, n_samples=100_000, seed=8)
    np.testing.assert_array_equal(r1.values, r2.values)
    assert r1.values[0] != r3.values[0]
    # Seeds are uint32 words, as in the JAX package.
    with pytest.raises(OverflowError):
        integ.integrate([lambda x: x], d, n_samples=1000, seed=-1)


def _make_fns(c):
    return [lambda x: x + c, lambda x: c * x * x]


def test_program_cache_hits_for_fresh_identical_lambdas(program_cache):
    d = tm.Distribution.normal(0.0, 1.0)
    tm.integrate(_make_fns(0.5), d, n_samples=1000, device="cpu")
    size = len(program_cache._store)
    tm.integrate(_make_fns(0.5), d, n_samples=1000, device="cpu")
    assert len(program_cache._store) == size
    tm.integrate(_make_fns(1.5), d, n_samples=1000, device="cpu")
    assert len(program_cache._store) == size + 1


def test_program_cache_check_holds_after_the_global_cache_fills(
        program_cache, monkeypatch):
    """The check above, after earlier tests filled the process-wide cache
    to its bound: the test's own cache still sees its insertion."""
    from collections import OrderedDict

    from tpu_montecarlo_torch.api.cache import GLOBAL_CACHE

    monkeypatch.setattr(GLOBAL_CACHE, "_store", OrderedDict(GLOBAL_CACHE._store))
    for i in range(GLOBAL_CACHE._maxsize + 1):
        GLOBAL_CACHE.get_or_build(("filler", i), object)
    assert len(GLOBAL_CACHE._store) == GLOBAL_CACHE._maxsize
    test_program_cache_hits_for_fresh_identical_lambdas(program_cache)
    assert ("filler", 1) in GLOBAL_CACHE._store


# -- what the slice does not take --------------------------------------------


def test_bad_arguments_raise():
    d = tm.Distribution.normal(0.0, 1.0)
    with pytest.raises(ValueError):
        tm.integrate([], d, n_samples=1000, device="cpu")
    with pytest.raises(TypeError):
        tm.integrate([123], d, n_samples=1000, device="cpu")
    with pytest.raises(ValueError):
        tm.integrate([lambda x: x], d, n_samples=0, device="cpu")
    with pytest.raises(ValueError):
        tm.integrate([lambda x: x], d, method="sobol", device="cpu")
    with pytest.raises(ValueError):
        tm.MonteCarloIntegrator(device="mps")


@pytest.mark.parametrize(
    "kwargs",
    [{"control_variates": [(lambda x: x, 0.0)]}],
    ids=["control-variates"],
)
def test_variants_not_ported_yet(kwargs):
    """Control variates, which raised here before they were ported: x
    under its own control of known mean 0 is exactly 0 (the regression
    takes all its variance)."""
    r = tm.integrate(
        [lambda x: x], tm.Distribution.normal(0.0, 1.0), n_samples=1000,
        device="cpu", **kwargs,
    )
    assert r.values.shape == (1,) and abs(r.values[0]) < 1e-6


def test_other_surfaces_not_ported_yet():
    """WGSL strings and a mesh still raise, naming their items; more than
    128 functions and nd control variates, which raised here before, run
    (in passes of at most 128, and as one composed nd set)."""
    d = tm.Distribution.normal(0.0, 1.0)
    many = [_make_fns(float(c))[0] for c in range(129)]
    cases = [
        lambda: tm.integrate(["return x * x;"], d, device="cpu"),
        lambda: tm.MonteCarloIntegrator(device="cpu", mesh="auto"),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            case()
    r = tm.integrate(many, d, n_samples=1000, device="cpu")
    np.testing.assert_allclose(r.values - r.values[0], np.arange(129.0),
                               atol=1e-4)
    cv = tm.integrate(
        [lambda x, y: x], [d, d], n_samples=1 << 14, device="cpu",
        return_stderr=True, control_variates=[(lambda x, y: y, 0.0)],
    )
    assert abs(cv.values[0]) < 6 * cv.stderr[0]


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.integrate([lambda x: x], tm.Distribution.normal(0.0, 1.0))


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    traced = tuple(tm.trace_function(f) for f in PAIR)
    program = IntegrateProgram(traced)
    grid = plan_grid(50_000)
    params = torch.tensor([0.0, 1.0])
    before = integrate_cuda.launches
    got = integrate_cuda(program, DistKind.UNIFORM, params, 3, grid)
    want = integrate_reference(program.torch_values, DistKind.UNIFORM, params, 3, grid)
    assert torch.equal(got, want)
    assert integrate_cuda.launches == before  # no kernel ran
    with pytest.raises(ValueError):
        integrate_cuda(program, DistKind.UNIFORM, params.double(), 3, grid)
    with pytest.raises(ValueError, match="no integrate kernel"):
        integrate_cuda(program, DistKind.UNIFORM, params.to("meta"), 3, grid)


def test_import_leaves_jax_out():
    code = (
        "import sys, tpu_montecarlo_torch\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=REPO, env=env,
        capture_output=True, text=True,
    )
    for path in (REPO / "tpu_montecarlo_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from tpu_montecarlo." not in text, path
