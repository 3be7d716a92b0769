"""The port's importance sampling (``integrate_importance_sampling``, 1-D,
closed-form weights) against the JAX package.

The JAX package folds the weight into each integrand,
``where(q > 0, (f(x) * p(x)) / safe_q, 0)`` (its ``_weighted_fns``
closures, run in its 1-D kernel); the port weighs as that kernel's
``is_weight`` does, ``f(x) * where(q > 0, p(x) / safe_q, 0)``
(``IntegrateProgram(fns, weight=(p, q))``), the two a few ulp apart per
value (2e-6 relative, ``test_weighted_set_evaluates_the_jax_closures``).
The port's plain version
draws, tile for tile, the samples of ``build_integrate_fn_pallas`` in
interpret mode at 256-row blocks, so weighted means agree within 1e-5
absolute plus 1e-5 relative and error bars within 1e-3 relative, as in
``tests/test_torch_integrate_variants.py`` (and 1e-9 absolute for an
error bar that exact antithetic cancellation leaves at float32 rounding).
The public-API cases carry the reference's own tolerances
(``tests/test_importance_sampling.py``, ``tests/test_is_diagnostics.py``).
The CUDA kernel is held against the plain version in
``test_torch_cuda.py``.
"""

import ctypes
import inspect
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import tpu_montecarlo as jmc
from tpu_montecarlo.api.results import _weight_diagnostics as j_weight_diagnostics
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.results import _unit_integrand, _weight_diagnostics
from tpu_montecarlo_torch.ops.integrate_kernel import IntegrateProgram
from tpu_montecarlo_torch.ops.lower import cuda_source, to_torch_set

from test_torch_integrate_variants import (
    _close,
    assert_runs_agree,
    jax_run,
    port_run,
)

CSRC = Path(__file__).resolve().parents[1] / "tpu_montecarlo_torch" / "csrc"
N_SMALL = 1 << 17

# (target, proposal, integrands): a normal, a uniform and an exponential
# proposal, each with a target of another family or parameters.
PAIRS = {
    "rare-event": (lambda pkg: pkg.Distribution.normal(0.0, 1.0),
                   lambda pkg: pkg.Distribution.normal(4.0, 1.5),
                   [lambda x: x > 4.0, lambda x: x * x]),
    "normal-on-uniform": (lambda pkg: pkg.Distribution.normal(0.0, 1.0),
                          lambda pkg: pkg.Distribution.uniform(-5.0, 5.0),
                          [lambda x: x, lambda x: x * x]),
    "exponential-pair": (lambda pkg: pkg.Distribution.exponential(2.0),
                         lambda pkg: pkg.Distribution.exponential(1.0),
                         [lambda x: x, lambda x: np.sin(x)]),
}
MODES = {
    "mc": ("mc", False),
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
}


def _port_program(fns, target, proposal):
    weight = tuple(tm.trace_function(d._pdf_func) for d in (target, proposal))
    return IntegrateProgram(tuple(tm.trace_function(f) for f in fns), weight)


def _jax_weighted(fns, target, proposal):
    """The JAX package's weighted closures for a traced-PDF pair."""
    integ = jmc.MonteCarloIntegrator()
    p_mode, q_mode = integ._pdf_mode(target), integ._pdf_mode(proposal)
    assert p_mode[0] == q_mode[0] == "traced"
    return integ._weighted_fns(tuple(j_trace(f) for f in fns), p_mode[1],
                               q_mode[1])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_version_matches_jax_weighted_kernel(pair, mode):
    method, with_stderr = MODES[mode]
    target, proposal, fns = PAIRS[pair]
    spec = j_dist_spec_of(proposal(jmc))
    wfns = _jax_weighted(fns, target(jmc), proposal(jmc))
    program = _port_program(fns, target(tm), proposal(tm))
    want, actual = jax_run(wfns, spec.kind, spec.params, N_SMALL, method,
                           with_stderr, 42)
    got, grid = port_run(program, spec.kind, spec.params, N_SMALL, method,
                         with_stderr, 42)
    assert grid.actual_samples == actual
    assert_runs_agree(got, want, with_stderr)


def test_weighted_set_evaluates_the_jax_closures():
    # Value for value at a grid that crosses both supports' edges and the
    # zero-density side of the exponential proposal.
    x = np.linspace(-6.0, 9.0, 4001, dtype=np.float32)
    for target, proposal, fns in PAIRS.values():
        wfns = _jax_weighted(fns, target(jmc), proposal(jmc))
        program = _port_program(fns, target(tm), proposal(tm))
        got = program.torch_values(torch.from_numpy(x))
        for j, wf in enumerate(wfns):
            want = np.asarray(wf(x), np.float32)
            np.testing.assert_allclose(got[j].numpy(), want, rtol=2e-6,
                                       atol=1e-30)


_SHIM = r"""
#include "integrand_math.cuh"
#include "integrands.inc"
#if TMC_WEIGHTED
// The kernel's weight of two traced densities, where(q > 0, p / q, 0), and
// the entries the kernel calls with it.
static float weight_at(float x) {
  const float q = tmc_pdf_q(x);
  const bool ok = q > 0.0f;
  return ok ? tmc_pdf_p(x) / (ok ? q : 1.0f) : 0.0f;
}
static void accumulate(float x, float* acc) {
  tmc_accumulate_w(x, weight_at(x), acc);
}
static void accumulate_sq(float x, const float* pilot, float* acc, float* sq) {
  tmc_accumulate_sq_w(x, weight_at(x), pilot, acc, sq);
}
static void accumulate_pair_sq(float x, float y, const float* pilot,
                               float* acc, float* sq) {
  tmc_accumulate_pair_sq_w(x, y, weight_at(x), weight_at(y), pilot, acc, sq);
}
static void values(float x, float* vals) {
  for (int j = 0; j < TMC_K; ++j) vals[j] = 0.0f;
  accumulate(x, vals);
}
#else
static void accumulate(float x, float* acc) { tmc_accumulate(x, acc); }
static void accumulate_sq(float x, const float* pilot, float* acc, float* sq) {
  tmc_accumulate_sq(x, pilot, acc, sq);
}
static void accumulate_pair_sq(float x, float y, const float* pilot,
                               float* acc, float* sq) {
  tmc_accumulate_pair_sq(x, y, pilot, acc, sq);
}
static void values(float x, float* vals) { tmc_values(x, vals); }
#endif
// Per point: acc, sq, the pair entry's acc and sq (with the point and its
// neighbour as the pair) and vals; 5 x TMC_K floats.
extern "C" void tmc_eval(const float* x, long n, const float* pilot,
                         float* out) {
  for (long i = 0; i < n; ++i) {
    float acc[TMC_K], sq[TMC_K], pacc[TMC_K], psq[TMC_K], one[TMC_K];
    for (int j = 0; j < TMC_K; ++j) acc[j] = sq[j] = pacc[j] = psq[j] = one[j] = 0.0f;
    accumulate_sq(x[i], pilot, acc, sq);
    accumulate_pair_sq(x[i], x[(i + 1) % n], pilot, pacc, psq);
    accumulate(x[i], one);
    float* o = out + i * 5 * TMC_K;
    values(x[i], o + 4 * TMC_K);
    for (int j = 0; j < TMC_K; ++j) {
      o[j] = acc[j];
      o[TMC_K + j] = sq[j];
      o[2 * TMC_K + j] = pacc[j];
      o[3 * TMC_K + j] = psq[j];
      if (one[j] != acc[j]) o[j] = TMC_NAN;
    }
  }
}
"""


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_c_entries_match_torch_set(tmp_path, weighted):
    """The generated C entries (host C++ build) against the torch set:
    values, squares about a pilot, and the antithetic pair's sums and
    squared mean; a weighted set's entries with the kernel's weight."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    target, proposal, fns = PAIRS["rare-event"]
    traced = tuple(tm.trace_function(f) for f in fns) + (_unit_integrand(),)
    weight = (tuple(tm.trace_function(d._pdf_func)
                    for d in (target(tm), proposal(tm))) if weighted else None)
    src = cuda_source(traced, weight=weight)
    assert ("#define TMC_WEIGHTED 1" in src) == weighted
    (tmp_path / "integrands.inc").write_text(src)
    (tmp_path / "shim.cpp").write_text(_SHIM)
    so = tmp_path / "libis.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-D__device__=", "-I", str(CSRC), "-I", str(tmp_path),
         str(tmp_path / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_eval.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.tmc_eval.restype = None
    x = np.linspace(-3.0, 9.0, 2001, dtype=np.float32)
    k = len(traced)
    pilot = np.linspace(0.1, 0.5, k).astype(np.float32)
    out = np.empty((len(x), 5, k), np.float32)
    lib.tmc_eval(x.ctypes.data, len(x), pilot.ctypes.data, out.ctypes.data)
    values = IntegrateProgram(traced, weight).torch_values
    v = torch.stack(values(torch.from_numpy(x)), dim=1).numpy()
    y = np.roll(x, -1)
    vy = torch.stack(values(torch.from_numpy(y)), dim=1).numpy()
    rtol = dict(rtol=2e-6, atol=1e-30)
    np.testing.assert_allclose(out[:, 0], v, **rtol)
    np.testing.assert_array_equal(out[:, 4], out[:, 0])
    np.testing.assert_allclose(out[:, 1], (v - pilot) ** 2, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(out[:, 2], v + vy, **rtol)
    np.testing.assert_allclose(out[:, 3], (0.5 * (v + vy) - pilot) ** 2,
                               rtol=1e-5, atol=1e-30)
    if weighted:
        # The unit integrand weighted is the weight itself, p(x) / q(x).
        p = tm.Distribution.normal(0.0, 1.0).pdf
        q = tm.Distribution.normal(4.0, 1.5).pdf
        np.testing.assert_allclose(out[:, 0, -1], [p(t) / q(t) for t in x],
                                   rtol=1e-5)


# -- the public path ------------------------------------------------------------


@pytest.mark.parametrize("family", ["normal", "uniform", "exponential"])
def test_public_rqmc_matches_jax_rotations(family):
    target, proposal, fns = {
        "normal": PAIRS["rare-event"],
        "uniform": PAIRS["normal-on-uniform"],
        "exponential": PAIRS["exponential-pair"],
    }[family]
    n, r, seed = 1 << 18, 4, 5
    spec = j_dist_spec_of(proposal(jmc))
    wfns = _jax_weighted(fns, target(jmc), proposal(jmc))
    seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(r, dtype=np.uint32)
    vals = np.stack([
        jax_run(wfns, spec.kind, spec.params, -(-n // r), "qmc", False, int(s))[0]
        for s in seeds
    ]).astype(np.float64)
    got = tm.integrate_importance_sampling(
        fns, target(tm), proposal(tm), n_samples=n, seed=seed, method="qmc",
        return_stderr=True, qmc_rotations=r, target_threads=1024, device="cpu")
    _close(got.values, vals.mean(axis=0))
    spread = vals.std(axis=0, ddof=1) / np.sqrt(r)
    assert np.all(np.abs(got.stderr - spread)
                  <= 1e-5 + 1e-5 * np.abs(vals.mean(axis=0)))


def _is(fns, target, proposal, n, **kw):
    integ = tm.MonteCarloIntegrator(device="cpu")
    return integ.integrate_importance_sampling(fns, target, proposal,
                                               n_samples=n, **kw)


N, U, E = tm.Distribution.normal, tm.Distribution.uniform, tm.Distribution.exponential

# The reference suite's analytic pairs (tests/test_importance_sampling.py
# TestAnalyticPairs): (functions, target, proposal, n, expected, tolerance).
REFERENCE_CASES = {
    "identical": ([lambda x: x * x], N(0.0, 1.0), N(0.0, 1.0), 1_000_000, [1.0], 0.02),
    "shifted": ([lambda x: x], N(0.0, 1.0), N(0.5, 1.0), 2_000_000, [0.0], 0.02),
    "wider": ([lambda x: x * x], N(0.0, 1.0), N(0.0, 2.0), 2_000_000, [1.0], 0.02),
    "normal-on-uniform": ([lambda x: x * x], N(0.0, 1.0), U(-5.0, 5.0), 2_000_000, [1.0], 0.05),
    "uniform-on-uniform": ([lambda x: x], U(0.0, 1.0), U(-1.0, 2.0), 2_000_000, [0.5], 0.02),
    "exponential-pair": ([lambda x: x], E(2.0), E(1.0), 2_000_000, [0.5], 0.02),
    "rare-event": ([lambda x: x > 4.0], N(0.0, 1.0), N(4.0, 1.5), 10_000_000, [3.167e-5], 3e-6),
    "shared-weights": ([lambda x: x, lambda x: x * x, lambda x: x**4], N(0.0, 1.0),
                       N(0.0, 1.5), 4_000_000, [0.0, 1.0, 3.0], [0.02, 0.02, 0.15]),
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_tolerances(case):
    fns, target, proposal, n, exact, tol = REFERENCE_CASES[case]
    r = _is(fns, target, proposal, n)
    assert r.values.dtype == np.float64 and r.values.shape == (len(fns),)
    assert r.n_samples == n and r.n_functions == len(fns)
    assert r.stderr is None and r.diagnostics is None
    assert np.all(np.abs(r.values - exact) < tol)


def _custom(pdf):
    """A target given by its density alone: importance sampling reads
    nothing else of it."""
    return tm.Distribution(tm.DistributionType.CUSTOM, {}, pdf)


def test_traceable_custom_target():
    # Reference TestTraceableCustomPdfs: pdf = 6x(1-x) on (0, 1), E[X] = 1/2,
    # and cos(x)/2 on (-pi/2, pi/2), E[X^2] = pi^2/4 - 2.
    r = _is([lambda x: x], _custom(lambda x: 6.0 * x * (1.0 - x) if 0.0 < x < 1.0 else 0.0),
            U(0.0, 1.0), 2_000_000)
    assert abs(r.values[0] - 0.5) < 0.02
    r = _is([lambda x: x * x],
            _custom(lambda x: math.cos(x) / 2.0 if abs(x) < math.pi / 2 else 0.0),
            U(-math.pi / 2, math.pi / 2), 2_000_000)
    assert abs(r.values[0] - (math.pi**2 / 4 - 2.0)) < 0.01


def test_rare_event_error_bars_and_methods():
    # P(X > 4) under N(0, 1) from N(4, 1.5), every method: within 6 error
    # bars (rQMC's spread under qmc), the bars far below the estimate.
    p = 3.167124183311986e-5
    for method in ("mc", "antithetic", "qmc"):
        r = _is([lambda x: x > 4.0], N(0.0, 1.0), N(4.0, 1.5), 1 << 20, seed=5,
                method=method, return_stderr=True)
        assert r.stderr[0] > 0 and r.stderr[0] < 0.05 * p, method
        assert abs(r.values[0] - p) < 6 * r.stderr[0], method


@pytest.mark.parametrize(
    "proposal,mean_w",
    [(N(0.0, 1.0), 1.0), (N(1.0, 1.0), 1.0), (N(4.0, 1.5), 1.0)],
    ids=["perfect", "shifted", "config4"],
)
def test_diagnostics_are_the_jax_formula(proposal, mean_w):
    n = 1 << 20
    with_diag = _is([lambda x: x], N(0.0, 1.0), proposal, n, seed=3,
                    return_stderr=True, return_diagnostics=True)
    # The weight's moments: the constant 1 weighted, in its own run.
    w = _is([lambda x: x * 0.0 + 1.0], N(0.0, 1.0), proposal, n, seed=3,
            return_stderr=True)
    want = j_weight_diagnostics(w.values[0], w.stderr[0], n)
    assert with_diag.diagnostics == pytest.approx(want, rel=1e-6)
    assert _weight_diagnostics(w.values[0], w.stderr[0], n) == want
    d = with_diag.diagnostics
    assert abs(d["mean_weight"] - mean_w) < 0.02
    assert abs(d["ess"] - n / (1 + d["weight_cv"] ** 2)) < 1e-3 * n
    # The diagnostics column does not move the user's estimates beyond
    # the float32 order in which the plain version sums its tiles, which
    # the width of the set changes.
    plain = _is([lambda x: x], N(0.0, 1.0), proposal, n, seed=3,
                return_stderr=True)
    np.testing.assert_allclose(with_diag.values, plain.values, rtol=1e-6, atol=0)
    np.testing.assert_allclose(with_diag.stderr, plain.stderr, rtol=1e-5, atol=0)


def test_diagnostics_closed_forms():
    # Reference tests/test_is_diagnostics.py: p == q gives w == 1, so
    # ess == n; q = N(1, 1) for p = N(0, 1) gives ess / n -> e^-1.
    n = 400_000
    d = _is([lambda x: x * x], N(0.0, 1.0), N(0.0, 1.0), n,
            return_diagnostics=True).diagnostics
    assert abs(d["mean_weight"] - 1.0) < 1e-4
    assert d["ess"] > 0.999 * n and d["weight_cv"] < 1e-2
    r = _is([lambda x: x], N(0.0, 1.0), N(1.0, 1.0), 2_000_000,
            return_diagnostics=True)
    assert r.stderr is None
    assert abs(r.diagnostics["ess"] / 2_000_000 - math.exp(-1.0)) < 0.02
    low = _is([lambda x: x], N(0.0, 1.0), N(2.5, 1.0), n, return_diagnostics=True)
    assert low.diagnostics["ess"] < 0.01 * n


def test_unit_integrand_is_x_times_zero_plus_one():
    f = to_torch_set((_unit_integrand(),))
    x = torch.tensor([0.0, -3.5, 1e30, float("inf"), float("nan")])
    got = f(x)[0]
    assert torch.equal(got[:3], torch.ones(3))
    assert torch.isnan(got[3:]).all()  # inf * 0 and nan, as in the JAX package


def test_seeds_and_cache(program_cache):
    args = ([lambda x: x * x], N(0.0, 1.0), N(0.0, 1.5), 100_000)
    r1 = _is(*args, seed=7)
    size = len(program_cache._store)
    r2 = _is(*args, seed=7)
    assert len(program_cache._store) == size
    np.testing.assert_array_equal(r1.values, r2.values)
    assert _is(*args, seed=8).values[0] != r1.values[0]
    # Another proposal is another weighted program.
    _is([lambda x: x * x], N(0.0, 1.0), N(0.0, 2.5), 1000)
    assert len(program_cache._store) == size + 1


def test_module_level_function_keeps_the_jax_defaults():
    got = inspect.signature(tm.integrate_importance_sampling).parameters
    want = inspect.signature(jmc.integrate_importance_sampling).parameters
    for name in ("n_samples", "seed", "method", "return_stderr",
                 "qmc_rotations", "return_diagnostics", "target_threads"):
        assert got[name].default == want[name].default, name
    assert got["device"].default == "cuda"
    assert "integrate_importance_sampling" in tm.__all__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.integrate_importance_sampling([lambda x: x], N(0.0, 1.0), N(0.0, 2.0))


def _untraceable_pdf(x):
    # An int() cast on a data value does not trace.
    return 0.5 if int(abs(x)) < 1 else 0.0


ERRORS = {
    "diagnostics-method": (ValueError, lambda pkg: dict(
        functions=[lambda x: x], target=pkg.Distribution.normal(0.0, 1.0),
        proposal=pkg.Distribution.normal(0.0, 1.5), method="antithetic",
        return_diagnostics=True)),
    "rotations": (ValueError, lambda pkg: dict(
        functions=[lambda x: x], target=pkg.Distribution.normal(0.0, 1.0),
        proposal=pkg.Distribution.normal(0.0, 1.5), method="qmc",
        return_stderr=True, qmc_rotations=1)),
    "method": (ValueError, lambda pkg: dict(
        functions=[lambda x: x], target=pkg.Distribution.normal(0.0, 1.0),
        proposal=pkg.Distribution.normal(0.0, 1.5), method="sobol")),
    "half-sequence": (TypeError, lambda pkg: dict(
        functions=[lambda x: x], target=[pkg.Distribution.normal(0.0, 1.0)],
        proposal=pkg.Distribution.normal(0.0, 1.5))),
    "sequence-lengths": (TypeError, lambda pkg: dict(
        functions=[lambda x: x], target=[pkg.Distribution.normal(0.0, 1.0)],
        proposal=[pkg.Distribution.normal(0.0, 1.5)] * 2)),
    "no-functions": (ValueError, lambda pkg: dict(
        functions=[], target=pkg.Distribution.normal(0.0, 1.0),
        proposal=pkg.Distribution.normal(0.0, 1.5))),
    # A CUSTOM proposal with no tables to sample.
    "custom-proposal-without-tables": (ValueError, lambda pkg: dict(
        functions=[lambda x: x], target=pkg.Distribution.uniform(0.0, 1.0),
        proposal=pkg.Distribution(pkg.DistributionType.CUSTOM, {},
                                  lambda x: 1.0))),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_argument_errors_match_jax(case):
    exc, make = ERRORS[case]

    def call(pkg, integ):
        kw = make(pkg)
        return integ.integrate_importance_sampling(
            kw.pop("functions"), kw.pop("target"), kw.pop("proposal"),
            n_samples=1000, **kw)

    with pytest.raises(exc) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(exc) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def test_one_element_sequences_are_the_scalar_path():
    a = _is([lambda x: x * x], [N(0.0, 1.0)], [N(0.0, 1.5)], 100_000)
    b = _is([lambda x: x * x], N(0.0, 1.0), N(0.0, 1.5), 100_000)
    np.testing.assert_array_equal(a.values, b.values)


def _while_pdf(x):
    # A while loop: the reference traces it in closed form; the port's
    # front end does not have it yet (ROADMAP.md item 3).
    y = 0.0
    while y < 1.0:
        y = y + 1.0
    return 0.5 * y if abs(x) < 1.0 else 0.0


def test_what_is_not_ported_names_its_item():
    integ = tm.MonteCarloIntegrator(device="cpu")
    cases = {
        # A density the front end cannot trace yet names item 3: the PDF
        # table fallback does not take it, since the reference traces it.
        r"item 3 \(integrand front end\)": lambda: integ.integrate_importance_sampling(
            [lambda x: x], _custom(_while_pdf), U(-1.0, 1.0)),
        r"item 3 ": lambda: integ.integrate_importance_sampling(
            [lambda x: x], U(-1.0, 1.0), tm.Distribution.from_pdf(
                _while_pdf, support=(-1.0, 1.0))),
    }
    for item, case in cases.items():
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 " + item):
            case()


def test_compile_importance_sampling_runs():
    """The two handles that raised before the serving handles: over
    sequences, and seed-batched over one Distribution; each element the
    public call's values as float32."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    fns = [lambda x: x * x]
    prog = integ.compile_importance_sampling(fns, N(0.0, 1.0), N(0.0, 2.0),
                                             n_samples=1 << 16, seed_batch=4)
    out = prog([1, 2, 3, 4])
    assert out.shape == (4, 1) and out.dtype == torch.float32
    want = _is(fns, N(0.0, 1.0), N(0.0, 2.0), 1 << 16, seed=3)
    np.testing.assert_array_equal(out[2].numpy(), want.values)
    nd = integ.compile_importance_sampling(
        [lambda x, y: x], [U(0.0, 1.0)] * 2, [U(0.0, 1.0)] * 2,
        n_samples=1 << 16)
    want = integ.integrate_importance_sampling(
        [lambda x, y: x], [U(0.0, 1.0)] * 2, [U(0.0, 1.0)] * 2,
        n_samples=1 << 16, seed=9)
    np.testing.assert_array_equal(nd(9).numpy(), want.values)


def test_runs_with_jax_blocked(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import tpu_montecarlo_torch as tm\n"
        "import tpu_montecarlo_torch.api.importance\n"
        "n = tm.Distribution.normal\n"
        "r = tm.integrate_importance_sampling(\n"
        "    [lambda x: x > 4.0], n(0.0, 1.0), n(4.0, 1.5), n_samples=1 << 18,\n"
        "    return_stderr=True, return_diagnostics=True, device='cpu')\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
        "print(r.values[0], r.stderr[0], r.diagnostics['ess'])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    out = subprocess.run(
        [sys.executable, str(script)], check=True, cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    value, stderr, ess = map(float, out.stdout.split())
    assert abs(value - 3.1671e-5) < 6 * stderr and 0 < ess < 1 << 18
