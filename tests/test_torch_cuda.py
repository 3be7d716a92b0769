"""The port's CUDA kernels (integrate, MCMC, nd integrate, nd MCMC,
tempered MCMC) against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed; the
repository's ``tests/conftest.py`` imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The integrate kernel and its plain version draw the same samples and
evaluate the same float32 operations, so their means agree to float32
summation order and last-bit libm differences: rel 1e-5 + abs 1e-6.  The
MCMC tolerances are stated above their tests.
"""

import ctypes
import math
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.integrate_kernel import (
    MAX_FUNCTIONS,
    IntegrateProgram,
    integrate_cuda,
    integrate_reference,
    plan_grid,
)
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    ChainStart,
    Layout,
    McmcConfig,
    McmcGrid,
    McmcProgram,
    Mode,
    mcmc_cuda,
    mcmc_finish,
    mcmc_reference,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.ops.reduce import fixed_sum
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
    want = integrate_reference(program.torch_values, spec.kind, params, 42, grid)
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


# Integrand counts on both sides of the switch from the cursor loop to the
# run-time position loop (integrate.cu, 17 integrands): each draws the
# same samples through the same transform.
@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 17, 24])
@pytest.mark.parametrize("dist", DISTS, ids=["uniform", "normal", "exponential"])
def test_kernel_sample_loops_match_plain_version(cuda_device, dist, k):
    got, want = _kernel_and_plain(WIDEST[:k], dist, cuda_device, 1 << 22)
    assert got.shape == (k,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_bad_params(cuda_device):
    program = IntegrateProgram((tm.trace_function(BENCH[0]),))
    spec = dist_spec_of(DISTS[1])
    params = torch.tensor(spec.params, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        integrate_cuda(program, spec.kind, params, 42, plan_grid(1000))


# -- the 1-D kernel's modes: antithetic, qmc, error bars, importance sets -----
#
# The kernel and the plain version draw the same samples in every mode, so
# means agree as above; error bars, which come from the same squares, within
# rel 1e-4 (float32 summation order, and the kernel's fused square-adds),
# plus 1e-9 absolute where antithetic pairs of an odd integrand cancel
# exactly and leave only float32 rounding (~1e-11).
STDERR_1D_RTOL, STDERR_1D_ATOL = 1e-4, 1e-9
MODES_1D = {
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
    "qmc-stderr": ("qmc", True),
}


def _modes_kernel_and_plain(program, dist, method, with_stderr, device, n_samples):
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        finish_stderr,
        pilot_values,
    )

    cfg = IntegrateConfig(method, with_stderr)
    grid = plan_grid(n_samples, method)
    spec = dist_spec_of(dist)
    params = torch.tensor(spec.params, device=device)
    pilot = (pilot_values(program.torch_values, spec.kind, params)
             if with_stderr else None)
    before = integrate_cuda.launches
    got = integrate_cuda(program, spec.kind, params, 42, grid, cfg, pilot)
    torch.cuda.synchronize()
    assert integrate_cuda.launches == before + 1
    want = integrate_reference(program.torch_values, spec.kind, params, 42,
                               grid, cfg, pilot)
    if with_stderr:
        return [tuple(t.double().cpu().numpy() for t in
                      finish_stderr(o[0], o[1], pilot, grid, cfg.antithetic))
                for o in (got, want)]
    n = float(np.float32(grid.actual_samples))
    return [((o / n).double().cpu().numpy(), None) for o in (got, want)]


def _check_1d(got, want):
    (m_k, s_k), (m_p, s_p) = got, want
    assert np.all(np.isfinite(m_k))
    np.testing.assert_allclose(m_k, m_p, rtol=RTOL, atol=ATOL)
    if s_p is not None:
        # Zero only where the integrand is constant on the samples (WIDEST
        # holds c * exp(-|x|) for x > c with c = 0).
        assert np.array_equal(s_k > 0, s_p > 0)
        np.testing.assert_allclose(s_k, s_p, rtol=STDERR_1D_RTOL,
                                   atol=STDERR_1D_ATOL)


def _program(fns, weight=None):
    return IntegrateProgram(tuple(tm.trace_function(f) for f in fns), weight)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES_1D))
@pytest.mark.parametrize("dist", DISTS, ids=["uniform", "normal", "exponential"])
def test_kernel_modes_match_plain_version(cuda_device, dist, mode):
    method, with_stderr = MODES_1D[mode]
    _check_1d(*_modes_kernel_and_plain(_program(BENCH), dist, method,
                                       with_stderr, cuda_device, 1 << 22))


# Importance sets: N(0,1) under N(4,1.5), N(0,1) under U(-5,5), Exp(2)
# under Exp(1), with the unit integrand (the weight) of the diagnostics.
IS_PAIRS = {
    "normal": (tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(4.0, 1.5)),
    "uniform": (tm.Distribution.normal(0.0, 1.0), tm.Distribution.uniform(-5.0, 5.0)),
    "exponential": (tm.Distribution.exponential(2.0), tm.Distribution.exponential(1.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc"] + list(MODES_1D))
@pytest.mark.parametrize("pair", list(IS_PAIRS))
def test_weighted_kernel_matches_plain_version(cuda_device, pair, mode):
    from tpu_montecarlo_torch.api.results import _unit_integrand

    method, with_stderr = MODES_1D.get(mode, ("mc", False))
    target, proposal = IS_PAIRS[pair]
    weight = tuple(tm.trace_function(d._pdf_func) for d in (target, proposal))
    program = IntegrateProgram(
        tuple(tm.trace_function(f) for f in [lambda x: x > 1.0, lambda x: x * x])
        + (_unit_integrand(),), weight)
    _check_1d(*_modes_kernel_and_plain(program, proposal, method, with_stderr,
                                       cuda_device, 1 << 22))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mc", "antithetic"])
def test_widest_kernel_with_error_bars(cuda_device, method):
    # 128 integrands with error bars: 256 float32 sums per thread, more
    # than the registers hold (pytest -rP shows nvcc's spill report).
    from tpu_montecarlo_torch.ops.integrate_kernel import IntegrateConfig

    program = _program(WIDEST)
    for line in program.library(IntegrateConfig(method, True)).build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    got, want = _modes_kernel_and_plain(program, DISTS[1], method, True,
                                        cuda_device, 1 << 20)
    assert got[0].shape == (MAX_FUNCTIONS,)
    _check_1d(got, want)


# The run-time position loop (17 integrands and more) in each new mode.
@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES_1D))
def test_wide_loop_modes_match_plain_version(cuda_device, mode):
    method, with_stderr = MODES_1D[mode]
    _check_1d(*_modes_kernel_and_plain(_program(WIDEST[:17]), DISTS[2], method,
                                       with_stderr, cuda_device, 1 << 22))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS, ids=["uniform", "normal", "exponential"])
def test_qmc_kernel_past_two_to_the_32_points(cuda_device, dist):
    # 2**33 points: the plan reaches the segment split (seg = t >> 17).
    from tpu_montecarlo_torch.ops.integrate_kernel import qmc_seg_bits

    assert qmc_seg_bits(plan_grid(1 << 33, "qmc")) == 17
    _check_1d(*_modes_kernel_and_plain(_program(BENCH[:2]), dist, "qmc", False,
                                       cuda_device, 1 << 33))


@pytest.mark.cuda
def test_integrate_modes_on_cuda_match_cpu(cuda_device):
    d = tm.Distribution.normal(0.0, 1.0)
    for kw in (dict(method="mc", return_stderr=True),
               dict(method="antithetic", return_stderr=True),
               dict(method="qmc"),
               dict(method="qmc", return_stderr=True, qmc_rotations=4)):
        before = integrate_cuda.launches
        got = tm.integrate(BENCH, d, n_samples=1 << 20, device=cuda_device, **kw)
        # rQMC's rotations are one seed-batched launch.
        assert integrate_cuda.launches == before + 1
        want = tm.integrate(BENCH, d, n_samples=1 << 20, device="cpu", **kw)
        np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
        if kw["method"] == "qmc" and kw.get("return_stderr"):
            assert np.all(np.abs(got.stderr - want.stderr)
                          <= RTOL * np.abs(want.values) + ATOL)
        elif kw.get("return_stderr"):
            np.testing.assert_allclose(got.stderr, want.stderr,
                                       rtol=STDERR_1D_RTOL, atol=STDERR_1D_ATOL)


@pytest.mark.cuda
def test_importance_sampling_on_cuda_matches_cpu(cuda_device):
    target, proposal = IS_PAIRS["normal"]
    fns = [lambda x: x > 4.0, lambda x: x]
    for kw in (dict(return_stderr=True, return_diagnostics=True),
               dict(method="antithetic", return_stderr=True),
               dict(method="qmc", return_stderr=True, qmc_rotations=4)):
        before = integrate_cuda.launches
        got = tm.integrate_importance_sampling(fns, target, proposal,
                                               n_samples=1 << 20,
                                               device=cuda_device, **kw)
        assert integrate_cuda.launches == before + 1  # rQMC: one batched launch
        want = tm.integrate_importance_sampling(fns, target, proposal,
                                                n_samples=1 << 20,
                                                device="cpu", **kw)
        np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
        if kw.get("method") == "qmc":
            assert np.all(np.abs(got.stderr - want.stderr)
                          <= RTOL * np.abs(want.values) + ATOL)
        else:
            np.testing.assert_allclose(got.stderr, want.stderr,
                                       rtol=STDERR_1D_RTOL, atol=STDERR_1D_ATOL)
        if kw.get("return_diagnostics"):
            for key in ("ess", "mean_weight", "weight_cv"):
                assert got.diagnostics[key] == pytest.approx(
                    want.diagnostics[key], rel=STDERR_1D_RTOL)


def _rows_sum(rows: torch.Tensor) -> torch.Tensor:
    """The integrate kernels' second pass (``csrc/rows_sum.cuh``) over a
    launch's (blocks, n) rows, in its order: thread t adds rows t, t +
    256, ... in turn, then the 256 sums add in a pairwise tree."""
    part = torch.zeros((256, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    for i in range(0, rows.shape[0], 256):
        chunk = rows[i:i + 256]
        part[:len(chunk)] += chunk
    return fixed_sum(part, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES_1D))
def test_kernel_rows_sum_to_the_wrapper_result(cuda_device, mode):
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        MAX_CUDA_BLOCKS,
        IntegrateConfig,
        integrate_rows,
        pilot_values,
    )

    method, with_stderr = MODES_1D[mode]
    cfg = IntegrateConfig(method, with_stderr)
    program = _program(BENCH[:3])
    spec = dist_spec_of(DISTS[0])
    params = torch.tensor(spec.params, device=cuda_device)
    pilot = (pilot_values(program.torch_values, spec.kind, params)
             if with_stderr else None)
    grid = plan_grid(1 << 22, method)
    before = integrate_cuda.launches
    rows = integrate_rows(program, spec.kind, params, 7, grid, cfg, pilot)
    assert integrate_cuda.launches == before + 1
    assert rows.shape == (min(grid.n_tiles, MAX_CUDA_BLOCKS),
                          3 * (2 if with_stderr else 1))
    whole = integrate_cuda(program, spec.kind, params, 7, grid, cfg, pilot)
    # The launch's second pass sums the rows in one order (any batch's).
    assert torch.equal(_rows_sum(rows).reshape(whole.shape), whole)


# -- CUSTOM tables and table weights in the 1-D kernel --------------------------
#
# Each CUSTOM route (stratified tables, gap-respecting tables, the
# knot-exact inverse) and each table weight (uniform-grid table, the
# sampler's own density, an irregular grid's knots) against the plain
# version on the same draws: means within rel 1e-5 plus 1e-6 times the
# column's size (its mean |value| on the pilot grid, or |mean| if larger;
# chip_smoke.py phase 25's scaling: a symmetric mixture's E[x] sums
# values of both signs, so float32 order moves it in proportion to them),
# error bars as above, scaled the same way.


def _untraceable(x):
    # An int() cast on a data value does not trace: a table density.
    return 0.5 if int(abs(x)) < 1 else 0.0


CUSTOM_DISTS = {
    "strata": lambda: tm.Distribution.beta(2.0, 5.0),
    "gapped": lambda: tm.Distribution.mixture(
        [tm.Distribution.uniform(-3.0, -1.0), tm.Distribution.uniform(1.0, 3.0)]),
    "knots": lambda: tm.Distribution.student_t(5.0),
}


def _custom_kernel_and_plain(program, dist, method, with_stderr, device,
                             n_samples):
    from tpu_montecarlo_torch.api.device import sampling_tables
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        finish_stderr,
        pilot_values,
    )

    spec = dist_spec_of(dist)
    tables = None
    if spec.kind == DistKind.CUSTOM:
        tables = sampling_tables(dist, spec, device, with_pdf=program.sampler)
    cfg = IntegrateConfig(method, with_stderr)
    grid = plan_grid(n_samples, method)
    params = torch.tensor(spec.params, device=device)
    pilot = (pilot_values(program.torch_values, spec.kind, params, tables)
             if with_stderr else None)
    size = pilot_values(lambda *a: [v.abs() for v in program.torch_values(*a)],
                        spec.kind, params, tables).double().cpu().numpy()
    before = integrate_cuda.launches
    got = integrate_cuda(program, spec.kind, params, 42, grid, cfg, pilot, tables)
    torch.cuda.synchronize()
    assert integrate_cuda.launches == before + 1
    want = integrate_reference(program.torch_values, spec.kind, params, 42,
                               grid, cfg, pilot, tables)
    if with_stderr:
        runs = [tuple(t.double().cpu().numpy() for t in
                      finish_stderr(o[0], o[1], pilot, grid, cfg.antithetic))
                for o in (got, want)]
    else:
        n = float(np.float32(grid.actual_samples))
        runs = [((o / n).double().cpu().numpy(), None) for o in (got, want)]
    return runs, np.maximum(size, np.abs(runs[1][0]))


def _check_custom(runs, size):
    (m_k, s_k), (m_p, s_p) = runs
    assert np.all(np.isfinite(m_k))
    assert np.all(np.abs(m_k - m_p) <= RTOL * np.abs(m_p) + ATOL * size)
    if s_p is not None:
        assert np.array_equal(s_k > 0, s_p > 0)
        assert np.all(np.abs(s_k - s_p)
                      <= STDERR_1D_RTOL * np.abs(s_p) + STDERR_1D_ATOL * size)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc"] + list(MODES_1D))
@pytest.mark.parametrize("route", list(CUSTOM_DISTS))
def test_custom_kernel_matches_plain_version(cuda_device, route, mode):
    method, with_stderr = MODES_1D.get(mode, ("mc", False))
    _check_custom(*_custom_kernel_and_plain(
        _program(BENCH), CUSTOM_DISTS[route](), method, with_stderr,
        cuda_device, 1 << 22))


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CUSTOM_DISTS))
def test_custom_wide_loop_matches_plain_version(cuda_device, route):
    # The run-time position loop (17 integrands) reads a position's row
    # from the position it counts.
    _check_custom(*_custom_kernel_and_plain(
        _program(WIDEST[:17]), CUSTOM_DISTS[route](), "antithetic", True,
        cuda_device, 1 << 22))


def _weights():
    """name: (program weight, proposal) for each table-weight mode."""
    from tpu_montecarlo_torch.ops.integrate_kernel import SAMPLER, KnotWeightTable

    integ = tm.MonteCarloIntegrator(device="cpu")
    table_target = tm.Distribution(tm.DistributionType.CUSTOM, {}, _untraceable)
    u2 = tm.Distribution.uniform(-2.0, 2.0)
    beta = tm.Distribution.beta(2.0, 5.0)
    table_q = tm.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0))
    heavy = CUSTOM_DISTS["knots"]()
    return {
        "table-p": (integ._is_weight(table_target, u2), u2),
        "table-p-table-q": (integ._is_weight(table_target, table_q), table_q),
        "sampler-q": ((tm.trace_function(tm.Distribution.normal(0.3, 0.1)._pdf_func),
                       SAMPLER), beta),
        "knots-p": ((KnotWeightTable(*table_target.get_or_compute_pdf_table()),
                     tm.trace_function(u2._pdf_func)), u2),
        "table-p-heavy-q": (integ._is_weight(table_target, heavy), heavy),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc"] + list(MODES_1D))
@pytest.mark.parametrize("case", ["table-p", "table-p-table-q", "sampler-q",
                                  "knots-p", "table-p-heavy-q"])
def test_table_weight_kernel_matches_plain_version(cuda_device, case, mode):
    from tpu_montecarlo_torch.api.results import _unit_integrand

    method, with_stderr = MODES_1D.get(mode, ("mc", False))
    weight, proposal = _weights()[case]
    program = IntegrateProgram(
        tuple(tm.trace_function(f) for f in [lambda x: x > 0.5, lambda x: x * x])
        + (_unit_integrand(),), weight)
    _check_custom(*_custom_kernel_and_plain(program, proposal, method,
                                            with_stderr, cuda_device, 1 << 22))


@pytest.mark.cuda
def test_custom_integrate_on_cuda_matches_cpu(cuda_device):
    # The public paths, one launch each (rQMC's rotations: one batched
    # launch).
    for route, make in CUSTOM_DISTS.items():
        d = make()
        for kw in (dict(method="mc", return_stderr=True),
                   dict(method="qmc", return_stderr=True, qmc_rotations=4)):
            before = integrate_cuda.launches
            got = tm.integrate(BENCH[:2], d, n_samples=1 << 20,
                               device=cuda_device, **kw)
            assert integrate_cuda.launches == before + 1  # rQMC: one batched launch
            want = tm.integrate(BENCH[:2], d, n_samples=1 << 20, device="cpu", **kw)
            size = np.maximum(np.abs(want.values), 1.0)
            assert np.all(np.abs(got.values - want.values)
                          <= RTOL * np.abs(want.values) + ATOL * size), route
    target = tm.Distribution(tm.DistributionType.CUSTOM, {}, _untraceable)
    proposal = tm.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0))
    got, want = (tm.integrate_importance_sampling(
        [lambda x: x * x], target, proposal, n_samples=1 << 20, device=dev,
        return_stderr=True, return_diagnostics=True) for dev in (cuda_device, "cpu"))
    np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_1D_RTOL,
                               atol=STDERR_1D_ATOL)


@pytest.mark.cuda
def test_custom_kernel_rejects_missing_tables(cuda_device):
    # A CUSTOM library refuses a launch without its tables, as a wrapper
    # bypassed would give them: the C entry checks, nothing falls back.
    from tpu_montecarlo_torch.api.device import sampling_tables
    from tpu_montecarlo_torch.ops.integrate_kernel import IntegrateConfig, MASK32

    d = CUSTOM_DISTS["strata"]()
    spec = dist_spec_of(d)
    tables = sampling_tables(d, spec, cuda_device)
    program = _program(BENCH[:2])
    lib = program.library(IntegrateConfig(), tables.route)
    params = torch.zeros(2, device=cuda_device)
    partials = torch.empty((1, 1, 2), device=cuda_device)
    sums = torch.empty((1, 2), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    # kind, seed word, seeds, reps, params, stride, pilots, stride, loops,
    # tiles, segment bits, grid, partials, sums, tables, stream
    err = lib.tmc_integrate(3, 42 & MASK32, None, 1, params.data_ptr(), 0,
                            None, 0, 8, 8, -1, 1, partials.data_ptr(),
                            sums.data_ptr(), None, stream)
    assert err != 0
    err = lib.tmc_integrate(1, 42, None, 1, params.data_ptr(), 0, None, 0, 8,
                            8, -1, 1, partials.data_ptr(), sums.data_ptr(),
                            ctypes.addressof(program.kernel_tables(tables, cuda_device)),
                            stream)
    assert err != 0


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


# -- the chain layout (csrc/mcmc_pipeline.cuh) ---------------------------------
#
# Spreading a chain's candidates over lanes and making them in groups
# changes no number the kernels compute: they run the plain version's
# chains, so no chain may split at all, and every layout gives the default
# layout's rows and final states bit for bit.  The grid is 8 programs of
# 1024 chains, so each chain's program and position count; the run lengths
# take in a single step, tail groups and no burn-in.
SEVERAL_PROGRAMS = McmcGrid(programs=8, rows=8, chains_actual=8192)
RUN_LENGTHS = [(1, 0), (7, 3), (1201, 13)]  # (n_steps, n_burnin)
LAYOUTS = [Layout(1, 1), Layout(2, 3), Layout(4, 1), Layout(8, 3)]


def _no_split(got, want, grid, cfg, k):
    """Kernel against plain version: no chain ends apart in any dimension,
    acceptance within 1e-3, means within 0.2 standard errors + 1e-6, error
    bars within STDERR_RTOL."""
    x_k = got.x_final.reshape(-1, grid.chains_actual).cpu()
    x_p = want.x_final.reshape(-1, grid.chains_actual).cpu()
    assert torch.isfinite(x_k).all()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert int(split.sum()) == 0, f"{int(split.sum())} chains split"
    v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
    v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
    _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert torch.isfinite(v_k).all()
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    np.testing.assert_array_less(
        (v_k - v_p).abs().cpu().numpy(), (0.2 * se + 1e-6).cpu().numpy()
    )
    if cfg.with_stderr:
        np.testing.assert_allclose(
            s_k.cpu().numpy(), s_p.cpu().numpy(), rtol=STDERR_RTOL
        )


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps,n_burnin", RUN_LENGTHS,
                         ids=[f"steps{n}-burn{b}" for n, b in RUN_LENGTHS])
@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_mcmc_kernel_splits_no_chain(cuda_device, case, n_steps, n_burnin):
    mode, prop, targ, row, stderr = MCMC_CASES[case]
    program = McmcProgram(tuple(tm.trace_function(f) for f in MCMC_FNS))
    cfg = McmcConfig(mode, prop, targ, n_steps, n_burnin, stderr)
    params = torch.tensor(row, dtype=torch.float32, device=cuda_device)
    before = mcmc_cuda.launches
    got = mcmc_cuda(program, cfg, params, 42, SEVERAL_PROGRAMS)
    torch.cuda.synchronize()
    assert mcmc_cuda.launches == before + 1
    want = mcmc_reference(program.torch_fns, cfg, params, 42, SEVERAL_PROGRAMS)
    _no_split(got, want, SEVERAL_PROGRAMS, cfg, len(MCMC_FNS))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["independence-normal", "adaptive-walk"])
def test_mcmc_layouts_run_the_same_chains(cuda_device, case):
    # K = 1, the main path's [x*x]: every layout against the plain
    # version, and bit for bit against one lane and no grouping.
    mode, prop, targ, row, _ = MCMC_CASES[case]
    traced = (tm.trace_function(lambda x: x * x),)
    cfg = McmcConfig(mode, prop, targ, 1201, 13, True)
    params = torch.tensor(row, dtype=torch.float32, device=cuda_device)
    layouts = LAYOUTS if mode == Mode.INDEPENDENCE else [
        Layout(1, g) for g in (1, 3, 4)]
    runs = []
    for layout in [None, *layouts]:
        program = McmcProgram(traced, layout=layout)
        runs.append(mcmc_cuda(program, cfg, params, 42, SEVERAL_PROGRAMS))
    torch.cuda.synchronize()
    want = mcmc_reference(program.torch_fns, cfg, params, 42, SEVERAL_PROGRAMS)
    for got in runs:
        _no_split(got, want, SEVERAL_PROGRAMS, cfg, 1)
        assert torch.equal(got.rows, runs[0].rows)
        assert torch.equal(got.x_final, runs[0].x_final)


@pytest.mark.cuda
def test_widest_mcmc_kernel_with_error_bars(cuda_device):
    # 127 integrands, the most the kernel takes, with error bars: 127
    # float32 sums per thread.  nvcc's register and spill report (empty
    # when the library is cached); pytest -rP shows it.
    program = McmcProgram(tuple(tm.trace_function(f)
                                for f in WIDEST[:MAX_FUNCTIONS - 1]))
    mode, prop, targ, row, _ = MCMC_CASES["stderr"]
    cfg = McmcConfig(mode, prop, targ, 200, 50, True)
    for line in program.library(cfg).build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    params = torch.tensor(row, dtype=torch.float32, device=cuda_device)
    got = mcmc_cuda(program, cfg, params, 42, SEVERAL_PROGRAMS)
    torch.cuda.synchronize()
    want = mcmc_reference(program.torch_fns, cfg, params, 42, SEVERAL_PROGRAMS)
    assert got.rows.shape == (8192 // 32, 3, MAX_FUNCTIONS)
    _no_split(got, want, SEVERAL_PROGRAMS, cfg, MAX_FUNCTIONS - 1)


# -- the nd integrate kernel --------------------------------------------------
#
# The nd kernel and its plain version draw the same samples (counter
# stream or Sobol net) and evaluate the same float32 operations: means
# within rel 1e-5 + abs 1e-6, as for the 1-D kernel.  Error bars come from
# the same pilot-shifted squares summed in other orders: rel 1e-4 (a wrong
# unit count or a dropped pair mean moves them by 40 % or more).
ND_STDERR_RTOL = 1e-4
ND_FNS = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
ND_DISTS = [
    tm.Distribution.normal(0.0, 1.0),
    tm.Distribution.uniform(0.0, 1.0),
    tm.Distribution.exponential(2.0),
]
ND8_FNS = [
    lambda a, b, c, d, e, f, g, h: a * b + c - d * e + np.exp(-f * f) + g * h,
    lambda a, b, c, d, e, f, g, h: (a > 0.5) * h + abs(b - g) * c,
    lambda a, b, c, d, e, f, g, h: np.sin(a + d) * e - f / (1.0 + h * h),
]
ND8_DISTS = [
    tm.Distribution.normal(0.5, 1.5),
    tm.Distribution.exponential(1.5),
    tm.Distribution.uniform(-1.0, 2.0),
    tm.Distribution.normal(-1.0, 0.5),
    tm.Distribution.uniform(0.0, 1.0),
    tm.Distribution.exponential(4.0),
    tm.Distribution.normal(0.0, 1.0),
    tm.Distribution.uniform(-2.0, 0.0),
]
ND_MODES = [("mc", False), ("antithetic", False), ("qmc", False),
            ("mc", True), ("antithetic", True), ("qmc", True)]


def _nd_kernel_and_plain(fns, dists, method, with_stderr, device, n_samples):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
        IntegrateNdProgram,
        NdConfig,
        finish_stderr,
        integrate_nd_cuda,
        integrate_nd_reference,
        pilot_row,
    )

    d = len(dists)
    specs = [dist_spec_of(dd) for dd in dists]
    kinds = tuple(s.kind for s in specs)
    program = IntegrateNdProgram(tuple(tm.trace_function(f, d) for f in fns), kinds)
    cfg = NdConfig(kinds, method, with_stderr)
    grid = plan_grid(n_samples, method)
    params = torch.tensor(np.stack([s.params for s in specs]), device=device)
    pilot = pilot_row(program.torch_fns, kinds, params) if with_stderr else None
    before = integrate_nd_cuda.launches
    got = integrate_nd_cuda(program, cfg, params, 42, grid, pilot)
    torch.cuda.synchronize()
    assert integrate_nd_cuda.launches == before + 1
    want = integrate_nd_reference(program.torch_fns, cfg, params, 42, grid, pilot)
    if with_stderr:
        return [
            tuple(t.double().cpu().numpy()
                  for t in finish_stderr(o[0], o[1], pilot, grid, cfg.antithetic))
            for o in (got, want)
        ]
    n = float(np.float32(grid.actual_samples))
    return [((o / n).double().cpu().numpy(), None) for o in (got, want)]


def _check_nd(got, want):
    (m_k, s_k), (m_p, s_p) = got, want
    assert np.all(np.isfinite(m_k))
    np.testing.assert_allclose(m_k, m_p, rtol=RTOL, atol=ATOL)
    if s_p is not None:
        assert np.all(s_k > 0)
        np.testing.assert_allclose(s_k, s_p, rtol=ND_STDERR_RTOL, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("method,with_stderr", ND_MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in ND_MODES])
def test_nd_kernel_matches_plain_version(cuda_device, method, with_stderr):
    _check_nd(*_nd_kernel_and_plain(ND_FNS, ND_DISTS, method, with_stderr,
                                    cuda_device, 1 << 22))


@pytest.mark.cuda
@pytest.mark.parametrize("method,with_stderr", ND_MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in ND_MODES])
def test_nd_kernel_in_eight_dimensions(cuda_device, method, with_stderr):
    _check_nd(*_nd_kernel_and_plain(ND8_FNS, ND8_DISTS, method, with_stderr,
                                    cuda_device, 1 << 21))


def _nd_family(c):
    def branchy(x, y):
        if x > c:
            return math.exp(-abs(y)) * c
        return (x - c) ** 2 + y

    return [
        lambda x, y: x * y + c,
        lambda x, y: np.sin(c * x) + np.tanh(y),
        lambda x, y: (x > c) & (y < c + 0.5),
        branchy,
    ]


# MAX_FUNCTIONS two-argument integrands: with error bars, 256 float32 sums
# per thread, more than the registers hold.
ND_WIDEST = [f for i in range(MAX_FUNCTIONS // 4) for f in _nd_family(i / 32.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mc", "antithetic"])
def test_widest_nd_kernel_with_error_bars(cuda_device, method):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import IntegrateNdProgram

    dists = [tm.Distribution.normal(0.0, 1.0), tm.Distribution.uniform(-1.0, 2.0)]
    # nvcc's register and spill report (empty when the library is cached);
    # pytest -rP shows it.
    program = IntegrateNdProgram(
        tuple(tm.trace_function(f, 2) for f in ND_WIDEST),
        tuple(dist_spec_of(d).kind for d in dists),
    )
    for line in program.library().build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    got, want = _nd_kernel_and_plain(ND_WIDEST, dists, method, True,
                                     cuda_device, 1 << 20)
    assert got[0].shape == (MAX_FUNCTIONS,)
    _check_nd(got, want)


@pytest.mark.cuda
def test_nd_qmc_kernel_past_two_to_the_32_points(cuda_device):
    # 2**32 points: the plan reaches the Sobol segment split (seg = t >> 17).
    u = tm.Distribution.uniform(0.0, 1.0)
    fns = [lambda x, y: np.exp(x) * np.exp(y), lambda x, y: x * y]
    _check_nd(*_nd_kernel_and_plain(fns, [u, u], "qmc", False, cuda_device,
                                    1 << 32))


@pytest.mark.cuda
def test_integrate_nd_on_cuda_matches_cpu(cuda_device):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import integrate_nd_cuda

    for kw in (dict(method="mc", return_stderr=True),
               dict(method="antithetic"),
               dict(method="qmc", return_stderr=True, qmc_rotations=4)):
        before = integrate_nd_cuda.launches
        got = tm.integrate(ND_FNS, ND_DISTS, n_samples=1 << 20,
                           device=cuda_device, **kw)
        assert integrate_nd_cuda.launches == before + 1  # rQMC: one batched launch
        want = tm.integrate(ND_FNS, ND_DISTS, n_samples=1 << 20, device="cpu", **kw)
        np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
        if kw["method"] == "qmc":
            # rQMC error bars: the spread of rotations' means, each within
            # the means' tolerance.
            assert np.all(np.abs(got.stderr - want.stderr)
                          <= RTOL * np.abs(want.values) + ATOL)
        elif kw.get("return_stderr"):
            np.testing.assert_allclose(got.stderr, want.stderr,
                                       rtol=ND_STDERR_RTOL)


@pytest.mark.cuda
def test_nd_kernel_rows_sum_to_the_wrapper_result(cuda_device):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
        MAX_CUDA_BLOCKS,
        IntegrateNdProgram,
        NdConfig,
        integrate_nd_cuda,
        integrate_nd_rows,
    )

    u = tm.Distribution.uniform(0.0, 1.0)
    kinds = (dist_spec_of(u).kind,) * 2
    program = IntegrateNdProgram(
        (tm.trace_function(lambda x, y: np.exp(x) * np.exp(y), 2),), kinds
    )
    cfg = NdConfig(kinds, "qmc")
    params = torch.tensor([dist_spec_of(u).params] * 2, device=cuda_device)
    grid = plan_grid(1 << 22, "qmc")
    before = integrate_nd_cuda.launches
    rows = integrate_nd_rows(program, cfg, params, 7, grid)
    assert integrate_nd_cuda.launches == before + 1
    assert rows.shape == (min(grid.n_tiles, MAX_CUDA_BLOCKS), 1)
    assert torch.equal(_rows_sum(rows),
                       integrate_nd_cuda(program, cfg, params, 7, grid))


@pytest.mark.cuda
def test_nd_kernel_rejects_bad_params(cuda_device):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
        IntegrateNdProgram,
        NdConfig,
        integrate_nd_cuda,
    )

    kinds = tuple(dist_spec_of(d).kind for d in ND_DISTS)
    program = IntegrateNdProgram(
        tuple(tm.trace_function(f, 3) for f in ND_FNS), kinds
    )
    params = torch.zeros((3, 2), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        integrate_nd_cuda(program, NdConfig(kinds), params, 42, plan_grid(1000))


# -- the nd MCMC kernel -------------------------------------------------------
#
# The kernel and its plain version run the same chains, as the 1-D MCMC
# kernel and its plain version do, so the 1-D tolerances hold: at most 1%
# of the chains end more than 1e-3 (relative) apart in any dimension, the
# acceptance rates agree within 1e-3, the means within 0.2 standard errors
# plus 1e-6, the error bars within rel 1e-3.


def _c9e_target():
    """c9e's joint log density (benchmarks/run_all.py:386-390): a
    bivariate normal with rho = 0.8, its constants read from the
    closure."""
    rho9 = 0.8
    c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))
    return lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y)


def _normal_target():
    return lambda x: -0.5 * x * x


ND_MCMC_FNS = {
    1: [lambda x: x, lambda x: x * x],
    2: [lambda x, y: x * y, lambda x, y: x * x + y * y,
        lambda x, y: (x > 1.0) * y],
    4: [lambda a, b, c, d: a * b + c - d,
        lambda a, b, c, d: (a > 0.5) * b + c * d],
}
_WALK = dict(step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0))
# id: (target: Distribution list or a maker of the joint log density,
# proposal: Distribution list or RandomWalk keyword arguments, stderr)
ND_MCMC_CASES = {
    "independence-product": (
        [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.5)],
        [tm.Distribution.normal(0.0, 3.0), tm.Distribution.exponential(1.0)],
        False,
    ),
    "independence-joint": (
        _c9e_target, [tm.Distribution.normal(0.0, 2.0)] * 2, False,
    ),
    "walk-joint": (_c9e_target, _WALK, False),
    "adaptive-walk-joint": (_c9e_target, dict(_WALK, adapt=True), False),
    "independence-joint-stderr": (
        _c9e_target, [tm.Distribution.normal(0.0, 2.0)] * 2, True,
    ),
    "adaptive-walk-product-stderr": (
        [tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.normal(0.0, 1.0)],
        dict(step_size=[0.5, 1.5], adapt=True), True,
    ),
    "d1-joint-stderr": (
        _normal_target, [tm.Distribution.normal(0.0, 2.0)], True,
    ),
    "d4-adaptive-walk-product-stderr": (
        [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.5),
         tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.normal(-1.0, 0.5)],
        dict(step_size=[1.0, 0.6, 0.8, 0.4], adapt=True), True,
    ),
}


def _dims(target, proposal) -> int:
    if isinstance(proposal, list):
        return len(proposal)
    if isinstance(target, list):
        return len(target)
    return target().__code__.co_argcount


def _nd_mcmc_setup(target, proposal, stderr, fns, device, n_steps, n_burnin):
    """(program, cfg, params) of one nd MCMC run, as the public path
    builds and packs them."""
    integ = tm.MonteCarloIntegrator(device=device)
    target = target() if callable(target) else target
    proposal = tm.RandomWalk(**proposal) if isinstance(proposal, dict) else proposal
    parsed = integ._parse_nd_mcmc_args(target, proposal)
    return integ._nd_mcmc_kernel_program(fns, proposal, parsed, n_steps,
                                         n_burnin, stderr)


def _check_nd_mcmc(program, cfg, params, grid):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda, mcmc_nd_reference

    before = mcmc_nd_cuda.launches, mcmc_nd_cuda.pilot_launches
    got = mcmc_nd_cuda(program, cfg, params, 42, grid)
    torch.cuda.synchronize()
    assert mcmc_nd_cuda.launches == before[0] + 1
    assert mcmc_nd_cuda.pilot_launches == before[1] + int(cfg.with_stderr)
    want = mcmc_nd_reference(program.torch_fns, program.torch_target, cfg,
                             params, 42, grid)
    x_k, x_p = got.x_final.cpu(), want.x_final.cpu()
    assert x_k.shape == (cfg.d, grid.chains_actual) and torch.isfinite(x_k).all()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%} split"
    k = len(program.fns)
    v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
    v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
    _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert torch.isfinite(v_k).all()
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    np.testing.assert_array_less(
        (v_k - v_p).abs().cpu().numpy(), (0.2 * se + 1e-6).cpu().numpy()
    )
    if cfg.with_stderr:
        np.testing.assert_allclose(
            s_k.cpu().numpy(), s_p.cpu().numpy(), rtol=STDERR_RTOL
        )


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ND_MCMC_CASES))
def test_nd_mcmc_kernel_matches_plain_version(cuda_device, case):
    target, proposal, stderr = ND_MCMC_CASES[case]
    program, cfg, params = _nd_mcmc_setup(
        target, proposal, stderr, ND_MCMC_FNS[_dims(target, proposal)], cuda_device,
        n_steps=1000, n_burnin=200,
    )
    _check_nd_mcmc(program, cfg, params, plan_mcmc_grid(plan_chains(4096, None)))


@pytest.mark.cuda
def test_widest_nd_mcmc_kernel_with_error_bars(cuda_device):
    # 127 two-argument integrands, the most the kernel takes, with error
    # bars: 127 float32 sums per thread.  nvcc's register and spill report
    # (empty when the library is cached); pytest -rP shows it.
    fns = ND_WIDEST[:MAX_FUNCTIONS - 1]
    program, cfg, params = _nd_mcmc_setup(
        _c9e_target, [tm.Distribution.normal(0.0, 2.0)] * 2, True, fns,
        cuda_device, n_steps=200, n_burnin=50,
    )
    for line in program.library().build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    _check_nd_mcmc(program, cfg, params, plan_mcmc_grid(plan_chains(4096, None)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps,n_burnin", RUN_LENGTHS,
                         ids=[f"steps{n}-burn{b}" for n, b in RUN_LENGTHS])
@pytest.mark.parametrize("case", list(ND_MCMC_CASES))
def test_nd_mcmc_kernel_splits_no_chain(cuda_device, case, n_steps, n_burnin):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda, mcmc_nd_reference

    target, proposal, stderr = ND_MCMC_CASES[case]
    program, cfg, params = _nd_mcmc_setup(
        target, proposal, stderr, ND_MCMC_FNS[_dims(target, proposal)],
        cuda_device, n_steps=n_steps, n_burnin=n_burnin,
    )
    before = mcmc_nd_cuda.launches
    got = mcmc_nd_cuda(program, cfg, params, 42, SEVERAL_PROGRAMS)
    torch.cuda.synchronize()
    assert mcmc_nd_cuda.launches == before + 1
    want = mcmc_nd_reference(program.torch_fns, program.torch_target, cfg,
                             params, 42, SEVERAL_PROGRAMS)
    _no_split(got, want, SEVERAL_PROGRAMS, cfg, len(program.fns))


@pytest.mark.cuda
@pytest.mark.parametrize("walk", [False, True], ids=["c9e", "c10b"])
def test_nd_mcmc_layouts_run_the_same_chains(cuda_device, walk):
    # K = 1, c9e's [x*y] on its joint target, independence or c10b's walk:
    # every layout against the plain version, and bit for bit against one
    # lane and no grouping.
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        McmcNdProgram,
        mcmc_nd_cuda,
        mcmc_nd_reference,
    )

    proposal = _WALK if walk else [tm.Distribution.normal(0.0, 2.0)] * 2
    base, cfg, params = _nd_mcmc_setup(
        _c9e_target, proposal, True, [lambda x, y: x * y], cuda_device,
        n_steps=1201, n_burnin=13,
    )
    layouts = [Layout(1, g) for g in (1, 3, 4)] if walk else LAYOUTS
    runs = [mcmc_nd_cuda(base, cfg, params, 42, SEVERAL_PROGRAMS)]
    for layout in layouts:
        program = McmcNdProgram(base.fns, cfg, base.target, layout=layout)
        runs.append(mcmc_nd_cuda(program, cfg, params, 42, SEVERAL_PROGRAMS))
    torch.cuda.synchronize()
    want = mcmc_nd_reference(base.torch_fns, base.torch_target, cfg, params,
                             42, SEVERAL_PROGRAMS)
    for got in runs:
        _no_split(got, want, SEVERAL_PROGRAMS, cfg, 1)
        assert torch.equal(got.rows, runs[0].rows)
        assert torch.equal(got.x_final, runs[0].x_final)


@pytest.mark.cuda
def test_integrate_mcmc_nd_on_cuda_matches_cpu(cuda_device):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda

    kw = dict(n_steps=500, n_chains=2048, n_burnin=100, seed=3,
              return_stderr=True)
    n2 = tm.Distribution.normal(0.0, 2.0)
    for proposal in ([n2, n2], tm.RandomWalk(adapt=True, target_accept=0.234,
                                             init_range=(-4.0, 4.0))):
        before = mcmc_nd_cuda.launches, mcmc_nd_cuda.pilot_launches
        got = tm.integrate_mcmc(ND_MCMC_FNS[2], _c9e_target(), proposal,
                                device=cuda_device, **kw)
        assert mcmc_nd_cuda.launches == before[0] + 1
        assert mcmc_nd_cuda.pilot_launches == before[1] + 1
        want = tm.integrate_mcmc(ND_MCMC_FNS[2], _c9e_target(), proposal,
                                 device="cpu", **kw)
        assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
        np.testing.assert_array_less(
            np.abs(got.values - want.values), 0.2 * want.stderr + 1e-6
        )
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)


@pytest.mark.cuda
def test_nd_mcmc_kernel_rejects_bad_params(cuda_device):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda

    program, cfg, params = _nd_mcmc_setup(
        _c9e_target, _WALK, False, ND_MCMC_FNS[2], cuda_device, 10, 2
    )
    with pytest.raises(ValueError, match="float32"):
        mcmc_nd_cuda(program, cfg, params.double(), 42, plan_mcmc_grid(1024))


# -- the tempered MCMC kernel (csrc/mcmc_pt.cu) --------------------------------
#
# The kernel and its plain version run the same ladders, so the nd MCMC
# tolerances hold, and the swap rates agree within 1e-3.


def _logmix(x):
    # c12's target (benchmarks/run_all.py:518-522): 0.5 N(-4,1) + 0.5 N(4,1).
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


_C12_WALK = dict(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
_LADDER4 = [1.0, 2.0, 4.0, 8.0]
# id: (target: a Distribution list, a Distribution or a maker of the joint
# log density; proposal: Distribution(s) or RandomWalk keyword arguments;
# temperatures; stderr)
PT_CASES = {
    "adaptive-walk-logmix-T4": (lambda: _logmix, _C12_WALK, _LADDER4, False),
    "walk-1d-distribution-T3": (
        tm.Distribution.normal(1.0, 2.0),
        dict(step_size=1.0, init_range=(-3.0, 5.0)), [1.0, 3.0, 9.0], False,
    ),
    "independence-logmix-T4": (
        lambda: _logmix, tm.Distribution.normal(0.0, 6.0), _LADDER4, False,
    ),
    "independence-2d-product-T2": (
        [tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.exponential(1.5)],
        [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.0)],
        [1.0, 2.5], False,
    ),
    "walk-c9e-T5": (_c9e_target, _WALK, [1.0, 2.0, 4.0, 8.0, 16.0], False),
    "adaptive-walk-logmix-stderr": (
        lambda: _logmix, _C12_WALK, _LADDER4, True,
    ),
    "independence-logmix-stderr": (
        lambda: _logmix, tm.Distribution.normal(0.0, 6.0), _LADDER4, True,
    ),
}


def _pt_setup(target, proposal, temps, stderr, fns, device, n_steps,
              n_burnin):
    """(program, cfg, params, ladder) of one tempered run, as the public
    path builds and packs them."""
    integ = tm.MonteCarloIntegrator(device=device)
    if callable(target):
        target = target()
    if isinstance(proposal, dict):
        proposal = tm.RandomWalk(**proposal)
    parsed = integ._parse_nd_mcmc_args(target, proposal)
    return integ._pt_kernel_program(
        fns, proposal, parsed, tuple(1.0 / t for t in temps), n_steps,
        n_burnin, stderr,
    )


def _check_pt(program, cfg, params, ladder, grid):
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        mcmc_pt_cuda,
        mcmc_pt_reference,
        pt_finish,
    )

    before = mcmc_pt_cuda.launches, mcmc_pt_cuda.pilot_launches
    got = mcmc_pt_cuda(program, cfg, params, ladder, 42, grid)
    torch.cuda.synchronize()
    assert mcmc_pt_cuda.launches == before[0] + 1
    assert mcmc_pt_cuda.pilot_launches == before[1] + int(cfg.with_stderr)
    want = mcmc_pt_reference(program.torch_fns, program.torch_target, cfg,
                             params, ladder, 42, grid)
    x_k, x_p = got.x_final.cpu(), want.x_final.cpu()
    assert x_k.shape == (cfg.d, grid.chains_actual) and torch.isfinite(x_k).all()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%} split"
    k = len(program.fns)
    v_k, a_k, w_k, s_k = pt_finish(got, grid, cfg, k)
    v_p, a_p, w_p, s_p = pt_finish(want, grid, cfg, k)
    _, _, _, se = pt_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert torch.isfinite(v_k).all()
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    assert abs(float(w_k) - float(w_p)) <= 1e-3 and 0.0 < float(w_k) < 1.0
    np.testing.assert_array_less(
        (v_k - v_p).abs().cpu().numpy(), (0.2 * se + 1e-6).cpu().numpy()
    )
    if cfg.with_stderr:
        np.testing.assert_allclose(
            s_k.cpu().numpy(), s_p.cpu().numpy(), rtol=STDERR_RTOL
        )


def _pt_fns(d):
    return ND_MCMC_FNS[d]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PT_CASES))
def test_pt_kernel_matches_plain_version(cuda_device, case):
    target, proposal, temps, stderr = PT_CASES[case]
    d = 2 if isinstance(target, list) or target is _c9e_target else 1
    setup = _pt_setup(target, proposal, temps, stderr, _pt_fns(d),
                      cuda_device, n_steps=1000, n_burnin=200)
    _check_pt(*setup, plan_mcmc_grid(plan_chains(4096, None)))


@pytest.mark.cuda
def test_pt_kernel_sixteen_rungs(cuda_device):
    # T = 16 rungs of d = 2, the widest ladder here: 16 x (2 states, logp,
    # log scale) in registers.  nvcc's register and spill report (empty
    # when the library is cached); pytest -rP shows it.
    temps = [1.5 ** t for t in range(16)]
    program, cfg, params, ladder = _pt_setup(
        _c9e_target, dict(_WALK, adapt=True), temps, True, _pt_fns(2),
        cuda_device, n_steps=300, n_burnin=100,
    )
    for line in program.library().build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    _check_pt(program, cfg, params, ladder,
              plan_mcmc_grid(plan_chains(4096, None)))


@pytest.mark.cuda
def test_widest_pt_kernel_with_error_bars(cuda_device):
    # 126 integrands, the most the kernel takes, with error bars, on c12's
    # ladder: 126 float32 sums per thread beside the ladder.
    fns = WIDEST[:MAX_FUNCTIONS - 2]
    program, cfg, params, ladder = _pt_setup(
        lambda: _logmix, _C12_WALK, _LADDER4, True, fns, cuda_device,
        n_steps=200, n_burnin=50,
    )
    for line in program.library().build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    _check_pt(program, cfg, params, ladder,
              plan_mcmc_grid(plan_chains(4096, None)))


@pytest.mark.cuda
def test_integrate_mcmc_tempered_on_cuda_matches_cpu(cuda_device):
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    kw = dict(n_steps=500, n_chains=2048, n_burnin=100, seed=3,
              return_stderr=True, temperatures=_LADDER4)
    for proposal in (tm.RandomWalk(**_C12_WALK),
                     tm.Distribution.normal(0.0, 6.0)):
        before = mcmc_pt_cuda.launches, mcmc_pt_cuda.pilot_launches
        got = tm.integrate_mcmc(ND_MCMC_FNS[1], _logmix, proposal,
                                device=cuda_device, **kw)
        assert mcmc_pt_cuda.launches == before[0] + 1
        assert mcmc_pt_cuda.pilot_launches == before[1] + 1
        want = tm.integrate_mcmc(ND_MCMC_FNS[1], _logmix, proposal,
                                 device="cpu", **kw)
        assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
        assert abs(got.diagnostics["swap_rate"]
                   - want.diagnostics["swap_rate"]) <= 1e-3
        np.testing.assert_array_less(
            np.abs(got.values - want.values), 0.2 * want.stderr + 1e-6
        )
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)


@pytest.mark.cuda
def test_pt_kernel_rejects_bad_params(cuda_device):
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    program, cfg, params, ladder = _pt_setup(
        lambda: _logmix, _C12_WALK, _LADDER4, False, _pt_fns(1), cuda_device,
        10, 2,
    )
    grid = plan_mcmc_grid(1024)
    with pytest.raises(ValueError, match="float32"):
        mcmc_pt_cuda(program, cfg, params.double(), ladder, 42, grid)
    with pytest.raises(ValueError, match=r"\(7,\) float32"):
        mcmc_pt_cuda(program, cfg, params, ladder[:5], 42, grid)
    with pytest.raises(ValueError, match="ladder on cpu"):
        mcmc_pt_cuda(program, cfg, params, ladder.cpu(), 42, grid)


# -- the tempered kernel's layouts ----------------------------------------------
#
# A layout changes no number the tempered kernel computes: the default
# layout and every layout below give the ladder layout's rows and final
# states bit for bit (zero split ladders), in every mode of PT_CASES, at
# T = 16 and 24 (32 rung lanes, blocks of 1,024 threads) and at K = 126,
# over 8 programs at 1, 7 and 1,201 steps.
PT_LAYOUT_CASES = {
    **PT_CASES,
    "adaptive-walk-c9e-T16": (_c9e_target, dict(_WALK, adapt=True),
                              [1.5 ** t for t in range(16)], True),
    "adaptive-walk-c9e-T24": (_c9e_target, dict(_WALK, adapt=True),
                              [1.2 ** t for t in range(24)], True),
    "adaptive-walk-logmix-K126-stderr": (lambda: _logmix, _C12_WALK,
                                         _LADDER4, True),
}


def _pt_case_fns(case, target):
    if "K126" in case:
        return WIDEST[:MAX_FUNCTIONS - 2]
    return _pt_fns(2 if isinstance(target, list) or target is _c9e_target
                   else 1)


def _pt_layouts(n_temps):
    """Rungs on lanes: one, two or four lanes per rung, groups of 1 to
    4."""
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import PtLayout, rung_lanes

    t_lanes = rung_lanes(n_temps)
    return [PtLayout(t_lanes, lanes, group)
            for lanes, group in ((1, 1), (1, 3), (2, 1), (2, 4), (4, 3))
            if t_lanes * lanes <= 32]


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps,n_burnin", RUN_LENGTHS,
                         ids=[f"steps{n}-burn{b}" for n, b in RUN_LENGTHS])
@pytest.mark.parametrize("case", list(PT_LAYOUT_CASES))
def test_pt_layouts_run_the_ladder_layouts_chains(cuda_device, case, n_steps,
                                                  n_burnin):
    from concurrent.futures import ThreadPoolExecutor

    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        LADDER_LAYOUT,
        McmcPtProgram,
        mcmc_pt_cuda,
    )

    target, proposal, temps, stderr = PT_LAYOUT_CASES[case]
    base, cfg, params, ladder = _pt_setup(
        target, proposal, temps, stderr, _pt_case_fns(case, target),
        cuda_device, n_steps=n_steps, n_burnin=n_burnin,
    )
    programs = [McmcPtProgram(base.fns, cfg, base.target, layout=layout)
                for layout in (LADDER_LAYOUT, None, *_pt_layouts(len(temps)))]
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda p: p.library(), programs))
    runs = [mcmc_pt_cuda(p, cfg, params, ladder, 42, SEVERAL_PROGRAMS)
            for p in programs]
    torch.cuda.synchronize()
    for program, got in zip(programs[1:], runs[1:]):
        assert torch.equal(got.rows, runs[0].rows), program.layout
        assert torch.equal(got.x_final, runs[0].x_final), program.layout
    if n_steps > 1000:
        # The ladder layout against the plain version.
        _check_pt(programs[0], cfg, params, ladder, SEVERAL_PROGRAMS)


@pytest.mark.cuda
def test_pt_kernel_past_32_rungs_takes_the_ladder(cuda_device):
    # T = 33 would need 64 rung lanes: the ladder layout, one thread per
    # ladder, runs it.
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import LADDER_LAYOUT

    program, cfg, params, ladder = _pt_setup(
        lambda: _logmix, _C12_WALK, [1.1 ** t for t in range(33)], False,
        _pt_fns(1), cuda_device, n_steps=300, n_burnin=100,
    )
    assert program.layout == LADDER_LAYOUT
    _check_pt(program, cfg, params, ladder,
              plan_mcmc_grid(plan_chains(4096, None)))


# -- the MCMC kernels, bit for bit ----------------------------------------------
#
# sha256 (first 16 hex digits) of the rows and final states of c5b, c9e,
# c12 and c12c at their main shape (4096 chains x (1,000 + 10,000) steps,
# error bars on, default layouts), as tools/mcmc_layout_sweep.py prints
# them: read on an H100 (CUDA 12 toolkit) from the kernels as they were at
# commit e1fa41d.  A change to a header they share (counter_rng.cuh,
# integrand_math.cuh, the lowering) must leave their chains as they were.
MCMC_DIGESTS = {
    "c5b": ("ce85a1ff091ba840", "ac9938cf8ab0b8a4"),
    "c9e": ("7984f9f4489012be", "8925440880a69e7a"),
    "c12": ("a5eae55349111f12", "7a48bbccc45c826e"),
    "c12c": ("ac6f1a2a47ade534", "640a252c499d639f"),
}


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(MCMC_DIGESTS))
def test_mcmc_kernels_run_their_recorded_chains(cuda_device, cell):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    grid = plan_mcmc_grid(plan_chains(4096, None))
    n02 = tm.Distribution.normal(0.0, 2.0)
    if cell == "c5b":
        program = McmcProgram((tm.trace_function(lambda x: x * x),))
        cfg = McmcConfig(Mode.INDEPENDENCE, _N, _N, 10_000, 1_000, True)
        params = torch.tensor([0.0, 2.0, 0.0, 0.0, 0.0, 1.0],
                              dtype=torch.float32, device=cuda_device)
        got = mcmc_cuda(program, cfg, params, 42, grid)
    elif cell == "c9e":
        program, cfg, params = _nd_mcmc_setup(
            _c9e_target, [n02, n02], True, [lambda x, y: x * y], cuda_device,
            n_steps=10_000, n_burnin=1_000)
        got = mcmc_nd_cuda(program, cfg, params, 42, grid)
    else:
        proposal = _C12_WALK if cell == "c12" else tm.Distribution.normal(0.0, 6.0)
        program, cfg, params, ladder = _pt_setup(
            lambda: _logmix, proposal, _LADDER4, True, _pt_fns(1), cuda_device,
            n_steps=10_000, n_burnin=1_000)
        got = mcmc_pt_cuda(program, cfg, params, ladder, 42, grid)
    torch.cuda.synchronize()
    assert (_digest(got.rows), _digest(got.x_final)) == MCMC_DIGESTS[cell]


# -- CUSTOM tables in the three MCMC kernels -----------------------------------
#
# Every table route of the 1-D, nd and tempered kernels (a table target,
# a sampler-mode proposal, a gapped proposal, the walks on a table target,
# error bars) against its plain version on the card, at 4096 chains x (200
# + 1000) steps, with the tolerances of the MCMC tests above (and the swap
# rates within 1e-3).  Each run is set up as the public path sets it up:
# the same routes, parameter rows and device tables.


def _bimodal(x):
    # BASELINE config 5's target (benchmarks/run_all.py:185-188).
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


def _custom_dist(name):
    d = tm.Distribution
    if name == "bimodal":
        return d.from_pdf(_bimodal, support=(-6.0, 6.0))
    if name == "wide":  # c12d's proposal (run_all.py:570-585)
        return d.from_pdf(lambda x: np.exp(-0.5 * (x / 3.0) ** 2),
                          support=(-7.0, 7.0))
    if name == "wide-gap":
        x = np.linspace(-6.0, 6.0, 2048)
        return d.from_pdf_table(
            x, np.where(np.abs(x) < 1.0, 0.0, np.exp(-0.1 * x * x)))
    if name == "beta":
        return d.beta(2.0, 5.0)
    return {"u6": d.uniform(-6.0, 6.0), "n01": d.normal(0.0, 1.0),
            "n02": d.normal(0.0, 2.0)}[name]


def _custom_spec(spec):
    if isinstance(spec, dict):
        return tm.RandomWalk(**spec)
    if isinstance(spec, str):
        return _custom_dist(spec)
    return [_custom_dist(s) for s in spec]


_TWALK = dict(step_size=1.0, adapt=True, init_range=(-3.0, 3.0))
_F1 = [lambda x: x, lambda x: x * x]
_F2 = [lambda x, y: x * y, lambda x, y: x + y * y]
# id: (path, fns, target, proposal, temperatures or None, stderr)
CUSTOM_MCMC_CASES = {
    "config5": ("1d", _F1, "bimodal", "u6", None, False),
    "sampler-proposal": ("1d", _F1, "beta", "beta", None, True),
    "gapped-proposal": ("1d", _F1, "bimodal", "wide-gap", None, False),
    "walk-table-target": ("1d", _F1, "bimodal", dict(step_size=1.5), None, False),
    "adaptive-walk-table-target-stderr": ("1d", _F1, "bimodal", _TWALK, None,
                                          True),
    "c9f": ("nd", _F2, ["beta", "n01"], ["beta", "n02"], None, True),
    "nd-gapped-last": ("nd", _F2, ["n01", "bimodal"], ["n02", "wide-gap"], None,
                       False),
    "nd-adaptive-walk-table": ("nd", _F2, ["bimodal", "n01"], _TWALK, None,
                               False),
    "c12d": ("pt", _F1, "bimodal", "wide", [1.0, 2.0, 4.0, 8.0], True),
    "pt-adaptive-walk-table-T2": ("pt", _F1, "bimodal", _TWALK, [1.0, 2.0],
                                  False),
    "pt-sampler-dimension-T2": ("pt", _F2, ["beta", "n01"], ["beta", "n02"],
                                [1.0, 2.5], True),
}


def custom_mcmc_setup(case, device, n_steps, n_burnin):
    """(run kernel, run plain version, cfg, k) of a CUSTOM MCMC case on
    ``device``, set up as the public path sets it up."""
    path, fns, target, proposal, temps, stderr = CUSTOM_MCMC_CASES[case]
    return public_mcmc_setup(path, fns, _custom_spec(target),
                             _custom_spec(proposal), temps, stderr, device,
                             n_steps, n_burnin)


def public_mcmc_setup(path, fns, target, proposal, temps, stderr, device,
                      n_steps, n_burnin):
    """(run kernel, run plain version, cfg, k) of an MCMC run on the 1-D
    ("1d"), nd ("nd") or tempered ("pt") kernel, set up as the public path
    sets it up: the same routes, parameter rows and device tables."""
    from tpu_montecarlo_torch.api.mcmc_nd import dim_tables
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        mcmc_nd_cuda,
        mcmc_nd_reference,
    )
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        mcmc_pt_cuda,
        mcmc_pt_reference,
    )

    integ = tm.MonteCarloIntegrator(device=device)
    if path == "1d":
        prog, cfg, params, tables = integ._mcmc_kernel_program(
            integ._trace_user_functions(fns), target, proposal, n_steps,
            n_burnin, stderr)
        return ((lambda g: mcmc_cuda(prog, cfg, params, 42, g, tables)),
                (lambda g: mcmc_reference(prog.torch_fns, cfg, params, 42, g,
                                          tables)), cfg, len(fns))
    parsed = integ._parse_nd_mcmc_args(target, proposal)
    tables = dim_tables(parsed[0], parsed[1], parsed[3], device)
    if path == "nd":
        prog, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, n_steps, n_burnin, stderr)
        return ((lambda g: mcmc_nd_cuda(prog, cfg, params, 42, g, tables)),
                (lambda g: mcmc_nd_reference(
                    prog.torch_fns, prog.torch_target, cfg, params, 42, g,
                    tables, torch_target_grad=prog.torch_target_grad)),
                cfg, len(fns))
    prog, cfg, params, ladder = integ._pt_kernel_program(
        fns, proposal, parsed, tuple(1.0 / t for t in temps), n_steps,
        n_burnin, stderr)
    return ((lambda g: mcmc_pt_cuda(prog, cfg, params, ladder, 42, g, tables)),
            (lambda g: mcmc_pt_reference(
                prog.torch_fns, prog.torch_target, cfg, params, ladder, 42, g,
                tables, torch_target_grad=prog.torch_target_grad)),
            cfg, len(fns))


def check_public_mcmc(path, setup, max_split=0.01):
    """The kernel against its plain version at 4096 chains: at most
    ``max_split`` of the chains split, acceptance within 1e-3, means within
    0.2 standard errors + 1e-6, error bars within STDERR_RTOL, swap rates
    within 1e-3."""
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda, pt_finish

    kernel, plain, cfg, k = setup
    grid = plan_mcmc_grid(plan_chains(4096, None))
    wrapper = {"1d": mcmc_cuda, "nd": mcmc_nd_cuda, "pt": mcmc_pt_cuda}[path]
    before = wrapper.launches
    got = kernel(grid)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(grid)
    x_k = got.x_final.reshape(-1, grid.chains_actual).cpu()
    x_p = want.x_final.reshape(-1, grid.chains_actual).cpu()
    assert torch.isfinite(x_k).all()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0).float().mean()
    assert split <= max_split, f"{float(split):.2%} of the chains split"
    v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
    v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
    _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    np.testing.assert_array_less(
        (v_k - v_p).abs().cpu().numpy(), (0.2 * se + 1e-6).cpu().numpy())
    if cfg.with_stderr:
        np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(),
                                   rtol=STDERR_RTOL)
    if path == "pt":
        sw_k, sw_p = (float(pt_finish(o, grid, cfg, k)[2]) for o in (got, want))
        assert abs(sw_k - sw_p) <= 1e-3 and 0.0 < sw_k < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUSTOM_MCMC_CASES))
def test_custom_mcmc_kernel_matches_plain_version(cuda_device, case):
    check_public_mcmc(CUSTOM_MCMC_CASES[case][0],
                      custom_mcmc_setup(case, cuda_device, 1000, 200))


@pytest.mark.cuda
def test_custom_integrate_mcmc_on_cuda_matches_cpu(cuda_device):
    # Config 5's public call, scaled down, on the card and on the CPU.
    kw = dict(n_steps=500, n_chains=2048, n_burnin=100, seed=3,
              return_stderr=True)
    before = mcmc_cuda.launches
    got = tm.integrate_mcmc(_F1, _custom_dist("bimodal"), _custom_dist("u6"),
                            device=cuda_device, **kw)
    assert mcmc_cuda.launches == before + 1
    want = tm.integrate_mcmc(_F1, _custom_dist("bimodal"), _custom_dist("u6"),
                             device="cpu", **kw)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
    np.testing.assert_array_less(np.abs(got.values - want.values),
                                 0.2 * want.stderr + 1e-6)


@pytest.mark.cuda
def test_custom_mcmc_kernel_rejects_missing_tables(cuda_device):
    # A table library never runs without its tables, and tables on another
    # device than the run's are refused.
    kernel, _, cfg, _ = custom_mcmc_setup("config5", cuda_device, 10, 0)
    program = McmcProgram((tm.trace_function(lambda x: x),))
    params = torch.zeros(6, device=cuda_device)
    with pytest.raises(ValueError, match="one DimTables entry"):
        mcmc_cuda(program, cfg, params, 42, plan_mcmc_grid(1024))
    from tpu_montecarlo_torch.api.device import mcmc_dim_tables

    cpu_tables = mcmc_dim_tables(None, _custom_dist("bimodal"), "cpu")
    with pytest.raises(ValueError, match="lie on cpu"):
        mcmc_cuda(program, cfg, params, 42, plan_mcmc_grid(1024), cpu_tables)


# -- the tables the JAX package runs on its XLA sweep -------------------------
#
# The knots route (a knot-exact proposal: Student-t, the gapped mixture
# with no faithful q-table), the full route (an inverse off the 128 lanes,
# or a stateful run's with no faithful q-table: a uniform or an irregular
# q-table), the irregular target table under walks and HMC, and the gapped
# route of the tempered kernel, each against its plain version on the card
# at 4096 chains x (200 + 1000) steps, as the CUSTOM cases above.

_SPIKE_X = np.sort(np.concatenate([np.linspace(0.0, 4.0, 900),
                                   np.linspace(1.999, 2.001, 200)]))
_SPIKE_P = 0.2 + np.exp(-0.5 * ((_SPIKE_X - 2.0) / 0.0005) ** 2) * 50.0


def _short_inverse(d, m=1000):
    """``d`` with a uniform-u inverse of ``m`` knots (off the 128 lanes:
    the "full" route), set through its spec."""
    from tpu_montecarlo_torch.sampling import DistSpec
    from tpu_montecarlo_torch.tables import compute_inverse_cdf_table

    inv = compute_inverse_cdf_table(d._x_table, d._cdf_table, m=m)
    d._cached_spec = DistSpec(DistKind.CUSTOM, np.zeros(2, np.float32), inv,
                              np.asarray(d._cdf_table, np.float32))
    return d


def _xla_dist(name):
    d = tm.Distribution
    if name.startswith("t5"):  # t5, t5s2, t5s3: Student-t(5, 0, scale)
        return d.student_t(5.0, 0.0, float(name[3:] or 1))
    if name == "spiky":
        return d.from_pdf_table(_SPIKE_X, _SPIKE_P)
    if name == "spiky-short":
        return _short_inverse(d.from_pdf_table(_SPIKE_X, _SPIKE_P))
    if name == "beta-short":
        return _short_inverse(d.beta(2.0, 5.0))
    if name == "gapped-mixture":
        return d.mixture([d.uniform(-3.0, -1.0), d.uniform(1.0, 3.0)])
    if name == "n208":
        return d.normal(2.0, 0.8)
    return _custom_dist(name)


def _xla_spec(spec):
    if isinstance(spec, dict):
        kw = dict(spec)
        return tm.HMC(**kw) if kw.pop("hmc", False) else tm.RandomWalk(**kw)
    if isinstance(spec, str):
        return _xla_dist(spec)
    return [_xla_dist(s) for s in spec]


_SPIKE_WALK = dict(step_size=0.8, adapt=True, init_range=(1.0, 3.0))
_SPIKE_HMC = dict(step_size=0.2, n_leapfrog=4, init_range=(1.0, 3.0),
                  hmc=True)
# id: (path, fns, target, proposal, temperatures or None, stderr, each
# proposal dimension's route (None for an analytic one; None for a walk),
# the config's knots)
_NO = (False, False, False)
XLA_TABLE_CASES = {
    "1d-knots": ("1d", _F1, "n01", "t5", None, True, ["knots"],
                 (True, True, False)),
    "1d-knots-gapped-mixture": ("1d", _F1, "gapped-mixture", "gapped-mixture",
                                None, False, ["knots"], (True, True, True)),
    "1d-full-uniform-q": ("1d", _F1, "beta", "beta-short", None, False,
                          ["full"], _NO),
    "1d-full-irregular-q": ("1d", _F1, "n208", "spiky-short", None, False,
                            ["full"], (False, True, False)),
    "1d-walk-irregular-target": ("1d", _F1, "spiky", _SPIKE_WALK, None, True,
                                 None, (False, False, True)),
    "1d-hmc-irregular-target": ("1d", _F1, "spiky", _SPIKE_HMC, None, False,
                                None, (False, False, True)),
    "nd-knots-c9f": ("nd", _F2, ["beta", "n01"], ["beta", "t5s2"], None, True,
                     ["sampler", "knots"], (_NO, (True, True, False))),
    "nd-full-irregular-target": ("nd", _F2, ["spiky", "n01"],
                                 ["spiky-short", "n02"], None, False,
                                 ["full", None], ((False, True, True), _NO)),
    "nd-walk-irregular-target": ("nd", _F2, ["spiky", "n01"], _SPIKE_WALK,
                                 None, False, None,
                                 ((False, False, True), _NO)),
    "nd-hmc-irregular-target": ("nd", _F2, ["spiky", "n01"],
                                dict(_SPIKE_HMC, step_size=[0.2, 0.5]), None,
                                False, None, ((False, False, True), _NO)),
    "pt-knots-c12d": ("pt", _F1, "bimodal", "t5s3", [1.0, 2.0, 4.0, 8.0], True,
                      ["knots"], ((True, True, False),)),
    "pt-gapped": ("pt", _F1, "bimodal", "wide-gap", [1.0, 2.0], True,
                  ["gapped"], ()),
    "pt-full-irregular-target": ("pt", _F1, "spiky", "spiky-short", [1.0, 2.0],
                                 False, ["full"], ((False, True, True),)),
    "pt-walk-irregular-target": ("pt", _F1, "spiky", _SPIKE_WALK, [1.0, 2.0],
                                 False, None, ((False, False, True),)),
}


def xla_table_setup(case, device, n_steps, n_burnin):
    path, fns, target, proposal, temps, stderr = XLA_TABLE_CASES[case][:6]
    return public_mcmc_setup(path, fns, _xla_spec(target),
                             _xla_spec(proposal), temps, stderr, device,
                             n_steps, n_burnin)


@pytest.fixture(scope="module")
def xla_table_libraries():
    """Builds the section's libraries at once (nvcc in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    grid = plan_mcmc_grid(1024)
    with ThreadPoolExecutor(max_workers=32) as pool:
        for f in [pool.submit(lambda c=c: xla_table_setup(c, device, 10, 2)[0](
                      grid)) for c in XLA_TABLE_CASES]:
            f.result()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(XLA_TABLE_CASES))
def test_xla_table_kernel_matches_plain_version(cuda_device,
                                                xla_table_libraries, case):
    from tpu_montecarlo_torch.api.device import mcmc_proposal_route

    path, _, _, proposal, _, _, routes, knots = XLA_TABLE_CASES[case]
    setup = xla_table_setup(case, cuda_device, 1000, 200)
    assert setup[2].knots == knots
    if routes is not None:
        dims = _xla_spec(proposal)
        dims = dims if isinstance(dims, list) else [dims]
        assert [mcmc_proposal_route(d)
                if dist_spec_of(d).kind == DistKind.CUSTOM else None
                for d in dims] == routes
    check_public_mcmc(path, setup)


# -- the extended families ---------------------------------------------------
#
# Lognormal, Cauchy, Laplace, logistic, Gumbel, Weibull and Pareto through
# the five kernels, each against its plain version on the card.  An
# extended family compiles into 1-D integrate libraries of its own
# (TMC_FAMILY); the fixture builds them all at once, one nvcc each.  Means
# within RTOL + ATOL times each column's size (its mean |value| on the
# pilot grid): a Cauchy sample reaches 6e6, so a column of x sums terms
# that large, in two orders.

FAMILY_ARGS = {
    "lognormal": (0.0, 0.5), "cauchy": (0.0, 1.0), "laplace": (3.0, 1.0),
    "logistic": (0.0, 2.0), "gumbel": (1.0, 0.5), "weibull": (1.5, 2.0),
    "pareto": (1.0, 3.0),
}
FAMILY_FNS = [lambda x: x, lambda x: x * x, lambda x: np.exp(-x * x),
              lambda x: x > 1.0]


def _family_dist(name, *args):
    return getattr(tm.Distribution, name)(*(args or FAMILY_ARGS[name]))


@pytest.fixture(scope="module")
def family_program():
    """The 1-D program of FAMILY_FNS with every family's library in every
    mode built, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        library_route,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program = _program(FAMILY_FNS)
    cfgs = [IntegrateConfig(*m) for m in [("mc", False), *MODES_1D.values()]]
    with ThreadPoolExecutor(max_workers=16) as pool:
        for f in [pool.submit(program.library, c,
                              library_route(DistKind[name.upper()]))
                  for name in FAMILY_ARGS for c in cfgs]:
            f.result()
    return program


def _check_family(runs, program, dist, device):
    from tpu_montecarlo_torch.ops.integrate_kernel import pilot_values

    (m_k, s_k), (m_p, s_p) = runs
    spec = dist_spec_of(dist)
    size = pilot_values(lambda x: [v.abs() for v in program.torch_values(x)],
                        spec.kind, torch.tensor(spec.params, device=device))
    size = np.maximum(size.double().cpu().numpy(), np.abs(m_p))
    assert np.all(np.isfinite(m_k))
    assert np.all(np.abs(m_k - m_p) <= RTOL * np.abs(m_p) + ATOL * size)
    if s_p is not None:
        assert np.all(np.abs(s_k - s_p)
                      <= STDERR_1D_RTOL * s_p + STDERR_1D_ATOL * size)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc"] + list(MODES_1D))
@pytest.mark.parametrize("name", list(FAMILY_ARGS))
def test_family_kernel_matches_plain_version(cuda_device, family_program, name,
                                             mode):
    method, with_stderr = MODES_1D.get(mode, ("mc", False))
    dist = _family_dist(name)
    runs = _modes_kernel_and_plain(family_program, dist, method, with_stderr,
                                   cuda_device, 1 << 22)
    _check_family(runs, family_program, dist, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc", "antithetic-stderr", "qmc"])
def test_family_importance_kernel_matches_plain_version(cuda_device, mode):
    # A Laplace target under a logistic proposal, both traced densities.
    method, with_stderr = MODES_1D.get(mode, ("mc", False))
    target, proposal = _family_dist("laplace"), _family_dist("logistic", 2.5, 2.0)
    program = _program(FAMILY_FNS[:2], tuple(
        tm.trace_function(d._pdf_func) for d in (target, proposal)))
    runs = _modes_kernel_and_plain(program, proposal, method, with_stderr,
                                   cuda_device, 1 << 22)
    _check_family(runs, program, proposal, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILY_ARGS))
def test_family_integrate_on_cuda_matches_cpu(cuda_device, name):
    before = integrate_cuda.launches
    got = tm.integrate(FAMILY_FNS, _family_dist(name), n_samples=1 << 21,
                       device=cuda_device, method="qmc", return_stderr=True,
                       qmc_rotations=4)
    assert integrate_cuda.launches == before + 1  # rQMC: one batched launch
    want = tm.integrate(FAMILY_FNS, _family_dist(name), n_samples=1 << 21,
                        device="cpu", method="qmc", return_stderr=True,
                        qmc_rotations=4)
    size = np.maximum(np.abs(want.values), 1.0)
    assert np.all(np.abs(got.values - want.values) <= 1e-5 * size)


FAMILY_ND_DISTS = [
    [_family_dist(n) for n in ("lognormal", "cauchy", "laplace", "logistic")],
    [_family_dist(n) for n in ("gumbel", "weibull", "pareto")]
    + [tm.Distribution.normal(0.0, 1.0)],
]


@pytest.mark.cuda
@pytest.mark.parametrize("method,with_stderr", ND_MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in ND_MODES])
@pytest.mark.parametrize("dims", [0, 1], ids=["lognormal-cauchy-laplace-logistic",
                                              "gumbel-weibull-pareto-normal"])
def test_family_nd_kernel_matches_plain_version(cuda_device, dims, method,
                                                with_stderr):
    fns = [lambda a, b, c, d: np.exp(-a * a) * c + d, lambda a, b, c, d: (b > 1.0) + a * d]
    got, want = _nd_kernel_and_plain(fns, FAMILY_ND_DISTS[dims], method,
                                     with_stderr, cuda_device, 1 << 22)
    assert np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-5)
    if with_stderr:
        np.testing.assert_allclose(got[1], want[1], rtol=ND_STDERR_RTOL)


_F1F = [lambda x: x, lambda x: np.exp(-x * x)]
_F2F = [lambda x, y: x * y, lambda x, y: x + y]
# id: (path, fns, target, proposal, temperatures or None, stderr); a name
# is a family at FAMILY_ARGS, a tuple a family at its own parameters.
FAMILY_MCMC_CASES = {
    "laplace-target-logistic-proposal": ("1d", _F1F, "laplace", ("logistic", 0.0, 2.0), None, True),
    "cauchy-target-cauchy-proposal": ("1d", _F1F, "cauchy", ("cauchy", 0.0, 2.0), None, False),
    "gumbel-target-walk": ("1d", _F1F, "gumbel", dict(step_size=0.6), None, False),
    "weibull-target-pareto-proposal": ("1d", _F1F, "weibull", ("pareto", 0.2, 1.5), None, False),
    "pareto-target-adaptive-walk": ("1d", _F1F, "pareto", dict(adapt=True), None, True),
    "lognormal-target-gumbel-proposal": ("1d", _F1F, "lognormal", ("gumbel", 1.0, 0.6), None, False),
    "nd-lognormal-gumbel": ("nd", _F2F, ["lognormal", "gumbel"],
                            [("weibull", 1.5, 2.0), ("logistic", 1.0, 1.0)], None, True),
    "nd-walk-cauchy-laplace": ("nd", _F2F, ["cauchy", "laplace"],
                               dict(step_size=[2.0, 1.0], adapt=True), None, False),
    "pt-gumbel-target": ("pt", _F1F, "gumbel",
                         dict(step_size=0.5, adapt=True, init_range=(0.0, 2.0)),
                         [1.0, 2.0, 4.0], True),
    "pt-cauchy-proposals": ("pt", _F2F, ["laplace", "logistic"],
                            [("cauchy", 3.0, 1.0), ("cauchy", 0.0, 2.0)], [1.0, 2.5],
                            False),
}


def _family_spec(spec):
    if isinstance(spec, dict):
        return tm.RandomWalk(**spec)
    if isinstance(spec, list):
        return [_family_spec(s) for s in spec]
    if isinstance(spec, str):
        return _family_dist(spec)
    return _family_dist(*spec)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FAMILY_MCMC_CASES))
def test_family_mcmc_kernels_match_plain_versions(cuda_device, case):
    path, fns, target, proposal, temps, stderr = FAMILY_MCMC_CASES[case]
    check_public_mcmc(path, public_mcmc_setup(
        path, fns, _family_spec(target), _family_spec(proposal), temps, stderr,
        cuda_device, 1000, 200))


# -- nd over CUSTOM dimensions and nd importance weights ----------------------
#
# Each CUSTOM route of the nd kernel (the stratified tables, their gapped
# twin, the flat inverse, the flat gapped tables, the knot-exact inverse)
# and each weight kind (traced, uniform-grid table, irregular-grid table,
# the sampler's density on the stratified and on the flat route) against
# the plain version at 2**22: the same draws, so means within rel 1e-5 +
# abs 1e-6 and error bars within rel 1e-4 + abs 1e-9, each absolute term
# times the column's size (its mean |value| on the weighted pilot grid,
# or |mean| if larger: a rare event's column is held to itself).


def _nd_grid_pdf():
    x = np.linspace(0.0, 1.0, 2048)
    return tm.Distribution.from_pdf_table(x, np.where((x > 0.4) & (x < 0.6), 0.0, 1.0))


def _nd_beta_table():
    x = np.linspace(0.0, 1.0, 2048)
    return tm.Distribution.from_pdf_table(x, 30.0 * x * (1.0 - x) ** 4)


def _nd_spiky():
    x = np.unique(np.concatenate([np.linspace(0.0, 1.0, 300),
                                  0.5 + np.geomspace(1e-5, 1e-3, 60)]))
    return tm.Distribution.from_pdf_table(x, 1.0 + 50.0 * np.exp(-(((x - 0.5) / 1e-5) ** 2)))


def _nd_named(name):
    d = tm.Distribution
    return {
        "beta25": lambda: d.beta(2.0, 5.0), "beta33": lambda: d.beta(3.0, 3.0),
        "beta153": lambda: d.beta(1.5, 3.0), "beta22": lambda: d.beta(2.0, 2.0),
        "u01": lambda: d.uniform(0.0, 1.0), "n01": lambda: d.normal(0.0, 1.0),
        "n015": lambda: d.normal(0.0, 1.5), "n3515": lambda: d.normal(3.5, 1.5),
        "gapped": _nd_grid_pdf, "t5": lambda: d.student_t(5.0),
        "betatab": _nd_beta_table, "spiky": _nd_spiky,
    }[name]()


_NDF2 = [lambda x, y: x * y, lambda x, y: x + y * y]
_NDF3 = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y - z]
# id: (fns, proposals, targets or None)
ND_CUSTOM_CASES = {
    "strata": (_NDF2, ("beta25", "u01"), None),
    "strata-flat": (_NDF2, ("beta25", "beta33"), None),
    "gapped-strata": (_NDF2, ("gapped", "u01"), None),
    "flat-gapped": (_NDF2, ("u01", "gapped"), None),
    "knots": (_NDF2, ("t5", "n01"), None),
    "is-traced": ([lambda x, y: (x > 3.0) * (y > 3.0)], ("n3515", "n3515"), ("n01", "n01")),
    "is-table-p-sampler-q": ([lambda x, y: x * y * y], ("beta153", "n015"), ("betatab", "n01")),
    "is-two-samplers": (_NDF2, ("beta153", "beta33"), ("beta25", "betatab")),
    "is-knot-p": (_NDF2, ("u01", "n01"), ("spiky", "n01")),
    "is-heavy-gapped-q": (_NDF2, ("t5", "gapped"), ("n01", "u01")),
    "is-three-dims": (_NDF3, ("beta153", "beta33", "beta22"), ("betatab", "beta25", "beta22")),
}


def _nd_new_kernel_and_plain(case, method, with_stderr, device, n_samples):
    from tpu_montecarlo_torch.api.device import nd_tables
    from tpu_montecarlo_torch.api.results import _unit_integrand
    from tpu_montecarlo_torch.ops import integrate_nd_kernel as nk

    fns, props, targs = ND_CUSTOM_CASES[case]
    props = [_nd_named(n) for n in props]
    d = len(props)
    integ = tm.MonteCarloIntegrator(device="cpu")
    traced = tuple(tm.trace_function(f, d) for f in fns)
    weight = None
    if targs is not None:
        traced += (_unit_integrand(d),)
        weight = tuple(integ._is_weight_dim(_nd_named(t), q) for t, q in zip(targs, props))
    kinds = tuple(dist_spec_of(q).kind for q in props)
    program = nk.IntegrateNdProgram(traced, kinds, weight)
    cfg = nk.NdConfig(kinds, method, with_stderr)
    tables = nd_tables(props, cfg, device, program.sampler_dims)
    grid = plan_grid(n_samples, method)
    params = torch.tensor(np.stack([dist_spec_of(q).params for q in props]), device=device)
    pilot = (nk.pilot_row(program.torch_fns, kinds, params, tables, program.torch_weight)
             if with_stderr else None)
    # The weight is never negative: |f w| = |f| w.
    size = nk.pilot_row([lambda *x, f=f: f(*x).abs() for f in program.torch_fns], kinds,
                        params, tables, program.torch_weight).double().cpu().numpy()
    before = nk.integrate_nd_cuda.launches
    got = nk.integrate_nd_cuda(program, cfg, params, 42, grid, pilot, tables)
    torch.cuda.synchronize()
    assert nk.integrate_nd_cuda.launches == before + 1
    want = nk.integrate_nd_reference(program.torch_fns, cfg, params, 42, grid, pilot,
                                     tables, program.torch_weight)
    if with_stderr:
        out = [tuple(t.double().cpu().numpy()
                     for t in nk.finish_stderr(o[0], o[1], pilot, grid, cfg.antithetic))
               for o in (got, want)]
    else:
        n = float(np.float32(grid.actual_samples))
        out = [((o / n).double().cpu().numpy(), None) for o in (got, want)]
    return out, np.maximum(size, np.abs(out[1][0]))


def _check_nd_new(got, want, size):
    (m_k, s_k), (m_p, s_p) = got, want
    assert np.all(np.isfinite(m_k))
    assert np.all(np.abs(m_k - m_p) <= RTOL * np.abs(m_p) + ATOL * size), (m_k, m_p)
    if s_p is not None:
        assert np.all(s_k > 0)
        assert np.all(np.abs(s_k - s_p) <= ND_STDERR_RTOL * np.abs(s_p) + 1e-9 * size)


ND_CUSTOM_RUNS = (
    [("strata", m, s) for m, s in ND_MODES]
    + [("strata-flat", "mc", False), ("strata-flat", "antithetic", True),
       ("strata-flat", "qmc", False), ("gapped-strata", "mc", False),
       ("gapped-strata", "antithetic", True), ("flat-gapped", "mc", True),
       ("flat-gapped", "qmc", False), ("knots", "mc", True), ("knots", "qmc", False)]
    + [(c, m, s) for c in ("is-traced", "is-table-p-sampler-q") for m, s in ND_MODES]
    + [("is-two-samplers", "mc", True), ("is-two-samplers", "qmc", False),
       ("is-knot-p", "mc", True), ("is-heavy-gapped-q", "mc", True),
       ("is-heavy-gapped-q", "antithetic", False), ("is-three-dims", "mc", True),
       ("is-three-dims", "antithetic", True)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("case,method,with_stderr", ND_CUSTOM_RUNS,
                         ids=[f"{c}-{m}{'-stderr' if s else ''}" for c, m, s in ND_CUSTOM_RUNS])
def test_nd_custom_kernel_matches_plain_version(cuda_device, case, method, with_stderr):
    (got, want), size = _nd_new_kernel_and_plain(case, method, with_stderr, cuda_device,
                                                 1 << 22)
    _check_nd_new(got, want, size)


@pytest.mark.cuda
def test_integrate_nd_custom_on_cuda_matches_cpu(cuda_device):
    # c9b and an nd importance set with table and sampler weights through
    # the public calls, on the card and on the CPU: the same draws, so the
    # means agree to float32 summation order.
    d = tm.Distribution
    on = {dev: tm.MonteCarloIntegrator(device=dev) for dev in ("cpu", "cuda")}
    b, u = d.beta(2.0, 5.0), d.uniform(0.0, 1.0)
    r = {k: i.integrate([lambda x, y: x * y], [b, u], n_samples=1 << 20, seed=3,
                        return_stderr=True) for k, i in on.items()}
    np.testing.assert_allclose(r["cuda"].values, r["cpu"].values, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r["cuda"].stderr, r["cpu"].stderr, rtol=ND_STDERR_RTOL)
    s = {k: i.integrate_importance_sampling(
        [lambda x, y: x * y * y], [_nd_beta_table(), d.normal(0.0, 1.0)],
        [d.beta(1.5, 3.0), d.normal(0.0, 1.5)], n_samples=1 << 20, seed=3,
        return_stderr=True, return_diagnostics=True) for k, i in on.items()}
    np.testing.assert_allclose(s["cuda"].values, s["cpu"].values, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s["cuda"].stderr, s["cpu"].stderr, rtol=ND_STDERR_RTOL)
    assert abs(s["cuda"].diagnostics["ess"] - s["cpu"].diagnostics["ess"]) <= (
        1e-3 * s["cpu"].diagnostics["ess"])


@pytest.mark.cuda
def test_nd_custom_kernel_rejects_missing_tables(cuda_device):
    # A CUSTOM library launched with no tables, or a stratified route under
    # qmc, returns an error and runs nothing.
    from tpu_montecarlo_torch.api.device import nd_tables
    from tpu_montecarlo_torch.ops import integrate_nd_kernel as nk

    props = [tm.Distribution.beta(2.0, 5.0), tm.Distribution.uniform(0.0, 1.0)]
    kinds = tuple(dist_spec_of(q).kind for q in props)
    program = nk.IntegrateNdProgram((tm.trace_function(lambda x, y: x * y, 2),), kinds)
    cfg = nk.NdConfig(kinds)
    tables = nd_tables(props, cfg, cuda_device)
    lib = program.library(nk.nd_routes(cfg, tables))
    params = torch.zeros((2, 2), device=cuda_device)
    partials = torch.empty((1, 1, 1), device=cuda_device)
    sums = torch.empty((1, 1), device=cuda_device)
    out = partials.data_ptr(), sums.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    # method, stderr, seed word, seeds, reps, params, stride, directions,
    # pilots, stride, loops, tiles, segment bits, grid, partials, sums,
    # tables, stream
    err = lib.tmc_integrate_nd(0, 0, 42, None, 1, params.data_ptr(), 0, None,
                               None, 0, 1, 1, -1, 1, *out, None, stream)
    assert err != 0
    kt = program.kernel_tables(tables, cuda_device)
    dirs = program.direction_numbers(cuda_device)
    err = lib.tmc_integrate_nd(2, 0, 42, None, 1, params.data_ptr(), 0,
                               dirs.data_ptr(), None, 0, 1, 1, -1, 1, *out,
                               ctypes.addressof(kt), stream)
    assert err != 0
    err = lib.tmc_integrate_nd(0, 0, 42, None, 1, params.data_ptr(), 0, None,
                               None, 0, 1, 1, -1, 1, *out,
                               ctypes.addressof(kt), stream)
    torch.cuda.synchronize()
    assert err == 0


# -- split-R-hat, ESS and thinned draws in the three MCMC kernels --------------
#
# A library with diagnostics and draws compiled in (TMC_DIAG, TMC_SAMPLES)
# runs the plain version's chains: check_public_mcmc's tolerances hold, and
# R-hat within rel 1e-4 and ESS within rel 1e-3 (the block sums of the
# half-chain values, in other orders), every draw of a chain that does not
# split within 1e-3 (relative) of the plain version's, at most as many
# split draws as check_public_mcmc allows split chains.  The first three
# rows and the final states are those of the same run without the outputs,
# bit for bit.  1,001 steps (an odd last step in neither half), 300 draws
# (a stride of 3: 1,001 = 300 x 3 + 101, a remainder far past the stride),
# 4096 chains; the draws' buffer is a view of one OUT_GUARD rows longer,
# whose rows past the m draws must stay as they were.  nvcc's register and
# spill report of each library (empty when it is cached) shows with -rP.
OUT_STEPS, OUT_BURNIN, OUT_DRAWS, OUT_GUARD = 1001, 200, 300, 64
_SENTINEL = -7777.0
_LOGMIX = _logmix
_C9E = _c9e_target()
# id: (path, functions, target, proposal, temperatures, stderr, layout)
OUTPUT_CASES = {
    **{f"1d-independence-k{k}": ("1d", WIDEST[:k] if k > 1 else [lambda x: x * x],
                                 "n01", "n02", None, True, None)
       for k in (1, 8, 32, MAX_FUNCTIONS - 1)},
    **{f"1d-adaptive-walk-k{k}": ("1d", WIDEST[:k] if k > 1 else [lambda x: x * x],
                                  "n01", dict(adapt=True), None, False, None)
       for k in (1, 8, 32)},
    "1d-walk-four-functions": ("1d", MCMC_FNS, ("uniform", -1.0, 2.0),
                               dict(step_size=0.5), None, True, None),
    "1d-config5-table-target": ("1d", _F1, "bimodal", "u6", None, True, None),
    "1d-family": ("1d", _F1, ("laplace", 3.0, 1.0), ("logistic", 0.0, 2.0),
                  None, False, None),
    "nd-c9e": ("nd", [lambda x, y: x * y], _C9E, ["n02", "n02"], None, True,
               None),
    "nd-adaptive-walk-product": ("nd", ND_MCMC_FNS[2], [("uniform", -1.0, 2.0), "n01"],
                                 dict(step_size=[0.5, 1.5], adapt=True), None,
                                 False, None),
    "nd-table-dimension": ("nd", _F2, ["beta", "n01"], ["beta", "n02"], None,
                           True, None),
    "nd-family": ("nd", _F2, [("lognormal", 0.0, 0.5), ("gumbel", 1.0, 0.5)],
                  [("weibull", 1.5, 2.0), ("logistic", 1.0, 1.0)], None, False,
                  None),
    "pt-c12": ("pt", _F1, _LOGMIX, _C12_WALK, _LADDER4, True, None),
    "pt-c12-ladder": ("pt", _F1, _LOGMIX, _C12_WALK, _LADDER4, True, "ladder"),
    "pt-independence-logmix": ("pt", _F1, _LOGMIX, ("normal", 0.0, 6.0),
                               _LADDER4, False, None),
    "pt-independence-logmix-ladder": ("pt", _F1, _LOGMIX, ("normal", 0.0, 6.0),
                                      _LADDER4, False, "ladder"),
    "pt-2d-product": ("pt", _F2, [("uniform", -1.0, 2.0), ("exponential", 1.5)],
                      [("normal", 0.5, 1.5), ("exponential", 1.0)], [1.0, 2.5],
                      True, None),
    "pt-2d-product-ladder": ("pt", _F2, [("uniform", -1.0, 2.0), ("exponential", 1.5)],
                             [("normal", 0.5, 1.5), ("exponential", 1.0)],
                             [1.0, 2.5], True, "ladder"),
    "pt-c12d-tables": ("pt", _F1, "bimodal", "wide", _LADDER4, True, None),
    "pt-family": ("pt", _F1F, ("gumbel", 1.0, 0.5),
                  dict(step_size=0.5, adapt=True, init_range=(0.0, 2.0)),
                  [1.0, 2.0, 4.0], False, None),
    "pt-33-rungs": ("pt", _F1, _LOGMIX, _C12_WALK, [1.1 ** t for t in range(33)],
                    False, None),
}


def _output_spec(spec):
    if callable(spec) and not isinstance(spec, tm.Distribution):
        return spec
    if isinstance(spec, dict):
        return tm.RandomWalk(**spec)
    if isinstance(spec, list):
        return [_output_spec(s) for s in spec]
    if isinstance(spec, tuple):
        return getattr(tm.Distribution, spec[0])(*spec[1:])
    return _custom_dist(spec)


def _outputs_setup(case, device, with_diagnostics, samples, stderr=None):
    """(kernel, plain, cfg, program) of an OUTPUT_CASES run with the given
    outputs (and error bars, when ``stderr`` overrides the case's), set up
    as the public path sets it up; kernel and plain take a grid."""
    from tpu_montecarlo_torch.api.mcmc_nd import dim_tables
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        mcmc_nd_cuda,
        mcmc_nd_reference,
    )
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        LADDER_LAYOUT,
        McmcPtProgram,
        mcmc_pt_cuda,
        mcmc_pt_reference,
    )

    path, fns, target, proposal, temps, case_stderr, layout = OUTPUT_CASES[case]
    stderr = case_stderr if stderr is None else stderr
    target, proposal = _output_spec(target), _output_spec(proposal)
    integ = tm.MonteCarloIntegrator(device=device)
    outs = (OUT_STEPS, OUT_BURNIN, stderr, with_diagnostics, samples)
    if path == "1d":
        prog, cfg, params, tables = integ._mcmc_kernel_program(
            integ._trace_user_functions(fns), target, proposal, *outs)
        return ((lambda g: mcmc_cuda(prog, cfg, params, 42, g, tables)),
                (lambda g: mcmc_reference(prog.torch_fns, cfg, params, 42, g,
                                          tables)), cfg, prog)
    parsed = integ._parse_nd_mcmc_args(target, proposal)
    tables = dim_tables(parsed[0], parsed[1], parsed[3], device)
    if path == "nd":
        prog, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, *outs)
        return ((lambda g: mcmc_nd_cuda(prog, cfg, params, 42, g, tables)),
                (lambda g: mcmc_nd_reference(prog.torch_fns, prog.torch_target,
                                             cfg, params, 42, g, tables)),
                cfg, prog)
    prog, cfg, params, ladder = integ._pt_kernel_program(
        fns, proposal, parsed, tuple(1.0 / t for t in temps), *outs)
    if layout == "ladder":
        prog = McmcPtProgram(prog.fns, cfg, prog.target, layout=LADDER_LAYOUT)
    return ((lambda g: mcmc_pt_cuda(prog, cfg, params, ladder, 42, g, tables)),
            (lambda g: mcmc_pt_reference(prog.torch_fns, prog.torch_target,
                                         cfg, params, ladder, 42, g, tables)),
            cfg, prog)


@pytest.fixture(scope="module")
def output_libraries():
    """Every OUTPUT_CASES library, with the outputs and without (error bars
    on), built at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    setups = [_outputs_setup(case, device, *outs)
              for case in OUTPUT_CASES
              for outs in ((True, OUT_DRAWS), (False, 0, True))]
    with ThreadPoolExecutor(max_workers=16) as pool:
        list(pool.map(lambda s: (s[3].library(s[2]) if isinstance(s[3], McmcProgram)
                                 else s[3].library()), setups))


def _guard_draw_buffers(monkeypatch) -> list:
    """Makes the three wrappers' draws' buffers the first m rows of ones
    OUT_GUARD rows longer, filled with _SENTINEL; returns the list to which
    each whole buffer is added.  (The nd and tempered wrappers share the
    nd module's launch.)"""
    from tpu_montecarlo_torch.ops import mcmc_kernel, mcmc_nd_kernel

    whole = []

    def guarded(cfg, shape, dev, lead=()):
        if not cfg.samples:
            return None
        assert not lead, "the guard takes one job's draws"
        buf = torch.full((cfg.samples + OUT_GUARD, *shape), _SENTINEL,
                         dtype=torch.float32, device=dev)
        whole.append(buf)
        return buf[:cfg.samples]

    for mod in (mcmc_kernel, mcmc_nd_kernel):
        monkeypatch.setattr(mod, "sample_buffer", guarded)
    return whole


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OUTPUT_CASES))
def test_mcmc_outputs_kernel_matches_plain_version(cuda_device, output_libraries,
                                                   case, monkeypatch):
    from tpu_montecarlo_torch.ops.mcmc_kernel import mcmc_diagnostics
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    path = OUTPUT_CASES[case][0]
    whole = _guard_draw_buffers(monkeypatch)
    kernel, plain, cfg, prog = _outputs_setup(case, cuda_device, True,
                                              OUT_DRAWS)
    lib = prog.library(cfg) if path == "1d" else prog.library()
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    grid = plan_mcmc_grid(plan_chains(4096, None))
    wrapper = {"1d": mcmc_cuda, "nd": mcmc_nd_cuda, "pt": mcmc_pt_cuda}[path]
    before = (wrapper.launches, wrapper.pilot_launches, wrapper.diag_launches,
              wrapper.sample_launches)
    got = kernel(grid)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.pilot_launches, wrapper.diag_launches,
            wrapper.sample_launches) == tuple(b + 1 for b in before)
    k = len(prog.fns)
    d = got.x_final.reshape(-1, grid.chains_actual).shape[0]
    assert got.rows.shape == (grid.chains_actual // 32, 7, k + 1 + (path == "pt"))
    assert got.samples.shape == ((OUT_DRAWS, grid.chains_actual) if path == "1d"
                                 else (OUT_DRAWS, d, grid.chains_actual))
    # No draw past the m rows.
    assert len(whole) == 1
    assert bool((whole[0][OUT_DRAWS:] == _SENTINEL).all())
    # Bit for bit the run without the outputs, with the pilot shift that
    # diagnostics take: error bars on.
    bare = _outputs_setup(case, cuda_device, False, 0, stderr=True)[0](grid)
    torch.cuda.synchronize()
    assert torch.equal(got.rows[:, :3], bare.rows)
    assert torch.equal(got.x_final, bare.x_final)
    check_public_mcmc(path, (kernel, plain, cfg, k))
    want = plain(grid)
    (r_k, e_k), (r_p, e_p) = (mcmc_diagnostics(o, grid, cfg, k)
                              for o in (got, want))
    assert torch.isfinite(r_k).all() and torch.isfinite(e_k).all()
    np.testing.assert_allclose(r_k.cpu().numpy(), r_p.cpu().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(e_k.cpu().numpy(), e_p.cpu().numpy(),
                               rtol=1e-3)
    s_k = got.samples.reshape(OUT_DRAWS, -1, grid.chains_actual).cpu()
    s_p = want.samples.reshape(OUT_DRAWS, -1, grid.chains_actual).cpu()
    split = ((s_k - s_p).abs() > 1e-3 * (1.0 + s_p.abs())).any(dim=1)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%}"


# -- HMC and chain state in the 1-D and nd MCMC kernels ------------------------
#
# HMC runs the walk's draws through the leapfrog (csrc/log_pdf_grad.cuh),
# so kernel and plain version run the same chains as for the walks: at most
# 1% of the chains split (check_public_mcmc's tolerances; on an H100, c11
# and c11c split none at this shape).  A stateful run at segment 0 is the
# stateless run's kernel bit for bit; a resumed segment is held to its
# plain version from the same start, its final log densities within rel
# 1e-5 where the chains agree.
HMC_CASES = {
    # name: (target, HMC arguments)
    "c11": (("normal", 0.0, 1.0), dict(step_size=0.9, n_leapfrog=8, adapt=True)),
    "c11c": ("beta", dict(step_size=0.05, n_leapfrog=8, adapt=True)),
    "normal-fixed": (("normal", 0.5, 1.5), dict(step_size=0.3, n_leapfrog=5)),
    "uniform": (("uniform", -1.0, 2.5), dict(step_size=0.4, n_leapfrog=4)),
    "exponential": (("exponential", 2.0), dict(step_size=0.1, n_leapfrog=8)),
    "lognormal": (("lognormal", 0.0, 0.5), dict(step_size=0.1, n_leapfrog=6)),
    "cauchy": (("cauchy", 0.0, 1.0), dict(step_size=0.5, n_leapfrog=4)),
    "laplace": (("laplace", 3.0, 1.0), dict(step_size=0.5, n_leapfrog=6)),
    "logistic": (("logistic", 0.0, 2.0),
                 dict(step_size=1.0, n_leapfrog=5, adapt=True)),
    "gumbel": (("gumbel", 1.0, 0.5), dict(step_size=0.2, n_leapfrog=4)),
    "weibull": (("weibull", 1.5, 2.0), dict(step_size=0.2, n_leapfrog=5)),
    "pareto": (("pareto", 1.0, 3.0), dict(step_size=0.05, n_leapfrog=4)),
    "table-fixed": ("beta", dict(step_size=0.05, n_leapfrog=8)),
}
HMC_FNS = [lambda x: x, lambda x: x * x]


def _hmc_target(spec):
    if spec == "beta":
        return tm.Distribution.beta(2.0, 5.0)
    return getattr(tm.Distribution, spec[0])(*spec[1:])


def _hmc_setup(case, device, n_steps, n_burnin):
    target, kw = HMC_CASES[case]
    return public_mcmc_setup("1d", HMC_FNS, _hmc_target(target),
                             tm.HMC(**kw), None, False, device, n_steps,
                             n_burnin)


# name: (target, proposal) of a stateful case (1-D unless the target is a
# list).
STATE_CASES = {
    "independence": (("normal", 0.0, 1.0), ("normal", 0.0, 2.0)),
    "table-proposal": ("beta", "beta"),
    "gapped-proposal": (("uniform", 0.0, 1.0), "gap"),
    # A spiky table with no faithful q-table: the "full" route, logq from
    # its irregular log table.
    "full-proposal": (("normal", 2.0, 0.8), "spiky"),
    "walk": (("normal", 0.0, 1.0), dict(step_size=0.8)),
    "hmc": (("normal", 0.5, 1.5), dict(step_size=0.3, n_leapfrog=5, hmc=True)),
    "nd-c9e": ("c9e", [("normal", 0.0, 2.0)] * 2),
    "nd-table-dimension": (["beta", ("normal", 0.0, 1.0)],
                           ["beta", ("normal", 0.0, 2.0)]),
    "nd-walk": ([("normal", 0.0, 1.0)] * 2, dict(step_size=[1.0, 1.5])),
    "nd-hmc": ([("normal", 0.0, 1.0), ("normal", 1.0, 2.0)],
               dict(step_size=[0.3, 0.5], n_leapfrog=5, hmc=True)),
}


def _state_spec(spec):
    if isinstance(spec, list):
        return [_state_spec(s) for s in spec]
    if isinstance(spec, dict):
        kw = dict(spec)
        return tm.HMC(**kw) if kw.pop("hmc", False) else tm.RandomWalk(**kw)
    if spec == "beta":
        return tm.Distribution.beta(2.0, 5.0)
    if spec == "gap":
        x = np.linspace(0.0, 1.0, 2048)
        return tm.Distribution.from_pdf_table(
            x, np.where((x > 0.4) & (x < 0.6), 0.0, 1.0))
    if spec == "c9e":
        return _c9e_target()
    if spec == "spiky":
        return _xla_dist(spec)
    return getattr(tm.Distribution, spec[0])(*spec[1:])


def _state_setup(case, device, n_steps, n_burnin, segment, start):
    """(kernel, plain) callables of a grid for one segment of a stateful
    case, set up as the public path sets it up (fresh when ``start`` is
    None), and the config."""
    from tpu_montecarlo_torch.api.mcmc_nd import dim_tables
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        mcmc_nd_cuda,
        mcmc_nd_reference,
    )

    target, proposal = (_state_spec(s) for s in STATE_CASES[case])
    integ = tm.MonteCarloIntegrator(device=device)
    resume = start is not None
    if not case.startswith("nd-"):
        prog, cfg, params, tables = integ._mcmc_kernel_program(
            integ._trace_user_functions([lambda x: x, lambda x: x * x]),
            target, proposal, n_steps, n_burnin, False, with_state=True,
            use_init_state=resume)
        return ((lambda g: mcmc_cuda(prog, cfg, params, 42, g, tables,
                                     segment, start)),
                (lambda g: mcmc_reference(prog.torch_fns, cfg, params, 42, g,
                                          tables, segment, start)), cfg)
    fns = [lambda x, y: x * y, lambda x, y: x + y]
    parsed = integ._parse_nd_mcmc_args(target, proposal)
    prog, cfg, params = integ._nd_mcmc_kernel_program(
        fns, proposal, parsed, n_steps, n_burnin, False, with_state=True,
        use_init_state=resume)
    tables = dim_tables(parsed[0], parsed[1], parsed[3], device, True)
    return ((lambda g: mcmc_nd_cuda(prog, cfg, params, 42, g, tables, segment,
                                    start)),
            (lambda g: mcmc_nd_reference(prog.torch_fns, prog.torch_target,
                                         cfg, params, 42, g, tables, segment,
                                         start, prog.torch_target_grad)), cfg)


@pytest.fixture(scope="module")
def hmc_state_libraries():
    """Builds every library of this section at once (nvcc in parallel):
    each case runs once on a small grid."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    grid = plan_mcmc_grid(1024)
    with ThreadPoolExecutor(max_workers=32) as pool:
        futures = [pool.submit(lambda c=c: _hmc_setup(c, device, 10, 2)[0](grid))
                   for c in HMC_CASES]
        futures += [pool.submit(_state_build, case, device, resume, grid)
                    for case in STATE_CASES for resume in (False, True)]
        for f in futures:
            f.result()
    torch.cuda.synchronize()


def _state_build(case, device, resume, grid):
    start = None
    if resume:
        d = 2 if case.startswith("nd-") else 1
        x = torch.full((d, grid.chains_actual) if d > 1
                       else (grid.chains_actual,), 0.3, device=device)
        start = ChainStart(x, torch.zeros(grid.chains_actual, device=device))
    _state_setup(case, device, 2, 0, int(resume), start)[0](grid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HMC_CASES))
def test_hmc_kernel_matches_plain_version(cuda_device, hmc_state_libraries,
                                          case):
    before = mcmc_cuda.hmc_launches
    check_public_mcmc("1d", _hmc_setup(case, cuda_device, 1000, 200))
    assert mcmc_cuda.hmc_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c11", "c11c"])
def test_hmc_layouts_run_the_same_chains(cuda_device, case):
    # The leapfrog waits on the step before: one lane; any group of draws
    # made ahead runs the same chains bit for bit.
    target, kw = HMC_CASES[case]
    integ = tm.MonteCarloIntegrator(device=cuda_device)
    prog, cfg, params, tables = integ._mcmc_kernel_program(
        integ._trace_user_functions(HMC_FNS), _hmc_target(target),
        tm.HMC(**kw), 301, 13, False)
    runs = [mcmc_cuda(McmcProgram(prog.fns, layout=layout), cfg, params, 42,
                      SEVERAL_PROGRAMS, tables)
            for layout in (None, Layout(1, 1), Layout(1, 3), Layout(1, 8))]
    torch.cuda.synchronize()
    for got in runs[1:]:
        assert torch.equal(got.rows, runs[0].rows)
        assert torch.equal(got.x_final, runs[0].x_final)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STATE_CASES))
def test_state_kernel_matches_plain_version(cuda_device, hmc_state_libraries,
                                            case):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda

    nd = case.startswith("nd-")
    wrapper = mcmc_nd_cuda if nd else mcmc_cuda
    grid = plan_mcmc_grid(plan_chains(4096, None))
    # Segment 0: the stateless run's kernel, bit for bit.
    kernel0 = _state_setup(case, cuda_device, 600, 200, 0, None)[0]
    before = wrapper.state_launches
    got0 = kernel0(grid)
    integ = tm.MonteCarloIntegrator(device=cuda_device)
    target, proposal = (_state_spec(s) for s in STATE_CASES[case])
    if nd:
        fns = [lambda x, y: x * y, lambda x, y: x + y]
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        prog, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, 600, 200, False)
        from tpu_montecarlo_torch.api.mcmc_nd import dim_tables

        bare = mcmc_nd_cuda(prog, cfg, params, 42, grid,
                            dim_tables(parsed[0], parsed[1], parsed[3],
                                       cuda_device))
    else:
        prog, cfg, params, tables = integ._mcmc_kernel_program(
            integ._trace_user_functions([lambda x: x, lambda x: x * x]),
            target, proposal, 600, 200, False)
        bare = mcmc_cuda(prog, cfg, params, 42, grid, tables)
    torch.cuda.synchronize()
    assert wrapper.state_launches == before + 1
    # A sampler-mode CUSTOM proposal's stateful run reads its full inverse
    # and its log table: other chains.
    if case not in ("table-proposal", "full-proposal", "nd-table-dimension"):
        assert torch.equal(got0.rows, bare.rows)
        assert torch.equal(got0.x_final, bare.x_final)
    # Segment 1, from the kernel's segment 0, against its plain version.
    start = ChainStart(got0.x_final, got0.logp_final)
    kernel1, plain1, cfg1 = _state_setup(case, cuda_device, 600, 0, 1, start)
    got, want = kernel1(grid), plain1(grid)
    torch.cuda.synchronize()
    x_k = got.x_final.reshape(-1, grid.chains_actual).cpu()
    x_p = want.x_final.reshape(-1, grid.chains_actual).cpu()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%}"
    keep = ~split
    np.testing.assert_allclose(got.logp_final.cpu()[keep].numpy(),
                               want.logp_final.cpu()[keep].numpy(),
                               rtol=1e-5, atol=1e-5)
    v_k, a_k, _ = mcmc_finish(got, grid, cfg1, 2)
    v_p, a_p, _ = mcmc_finish(want, grid, cfg1, 2)
    _, _, se = mcmc_finish(want, grid, replace(
        cfg1, with_stderr=True, with_state=False, use_init_state=False), 2)
    assert abs(float(a_k) - float(a_p)) <= 1e-3
    np.testing.assert_array_less((v_k - v_p).abs().cpu().numpy(),
                                 (0.2 * se + 1e-6).cpu().numpy())


@pytest.mark.cuda
def test_integrate_mcmc_state_and_hmc_on_cuda_match_cpu(cuda_device):
    kw = dict(n_steps=300, n_chains=2048, seed=3)
    n = tm.Distribution.normal(0.5, 1.5)
    for proposal in (tm.Distribution.normal(0.0, 3.0),
                     tm.HMC(step_size=0.4, n_leapfrog=6)):
        runs = {}
        for device in (cuda_device, "cpu"):
            r0 = tm.integrate_mcmc(HMC_FNS, n, proposal, n_burnin=100,
                                   return_state=True, device=device, **kw)
            r1 = tm.integrate_mcmc(HMC_FNS, n, proposal, n_burnin=0,
                                   initial_state=r0.chain_state,
                                   return_state=True, device=device, **kw)
            runs[device] = (r0, r1)
        for got, want in zip(runs[cuda_device], runs["cpu"]):
            assert got.chain_state.segment == want.chain_state.segment
            split = np.abs(got.chain_state.x - want.chain_state.x) > 1e-3 * (
                1.0 + np.abs(want.chain_state.x))
            assert split.mean() <= 0.01
            assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
            np.testing.assert_allclose(got.values, want.values, atol=2e-3)


# -- nd and tempered HMC -------------------------------------------------------
#
# The nd and tempered kernels run HMC on the walk's draws (the leapfrog of
# csrc/log_pdf_grad.cuh; a joint target's gradient generated by
# ops/grad.py), so kernel and plain version run the same chains: at most
# 1% of the chains split (check_public_mcmc's tolerances).
ND_HMC_CASES = {
    # name: (path, functions, target, HMC arguments, temperatures)
    "nd-joint": ("nd", [lambda x, y: x * y], "c11b",
                 dict(step_size=0.4, n_leapfrog=8, init_range=(-4.0, 4.0)),
                 None),
    "nd-joint-adaptive": ("nd", [lambda x, y: x * y], "c11b",
                          dict(step_size=0.4, n_leapfrog=8, adapt=True,
                               init_range=(-4.0, 4.0)), None),
    "nd-product": ("nd", [lambda x, y: x, lambda x, y: y * y],
                   [("normal", 0.0, 10.0), ("normal", 0.0, 1.0)],
                   dict(step_size=[2.0, 0.2], n_leapfrog=8), None),
    "nd-table-dimension": ("nd", [lambda x, y: x + y, lambda x, y: y * y],
                           [("normal", 1.0, 1.0), "beta"],
                           dict(step_size=[0.2, 0.05], n_leapfrog=8,
                                init_range=[(-1.0, 3.0), (0.05, 0.95)]),
                           None),
    "pt-joint": ("pt", [lambda x: x, lambda x: x * x], "logmix",
                 dict(step_size=0.35, n_leapfrog=8, init_range=(3.0, 5.0)),
                 [1.0, 2.0, 4.0, 8.0]),
    "pt-product": ("pt", [lambda x, y: x * y, lambda x, y: x * x],
                   [("normal", 1.0, 1.0), ("normal", -1.0, 2.0)],
                   dict(step_size=[0.4, 0.6], n_leapfrog=6),
                   [1.0, 2.0, 4.0]),
    "pt-adaptive": ("pt", [lambda x, y: x, lambda x, y: y], "banana",
                    dict(step_size=0.15, n_leapfrog=5, adapt=True,
                         init_range=(-2.0, 2.0)), [1.0, 2.0, 4.0]),
    "pt-table": ("pt", [lambda v: v], "beta",
                 dict(step_size=0.05, n_leapfrog=5, init_range=(0.05, 0.95)),
                 [1.0, 2.0]),
}


def _banana(x, y):
    return -0.5 * (x * x / 4.0 + (y - 0.5 * x * x) ** 2)


def _logmix(x):
    return math.log(math.exp(-0.5 * (x + 4.0) ** 2)
                    + math.exp(-0.5 * (x - 4.0) ** 2))


def _nd_hmc_target(spec):
    if spec == "c11b":
        return _c9e_target()
    if spec == "logmix":
        return _logmix
    if spec == "banana":
        return _banana
    if spec == "beta":
        return _hmc_target(spec)
    return [_hmc_target(s) for s in spec]


def _nd_hmc_setup(case, device, n_steps, n_burnin):
    path, fns, target, kw, temps = ND_HMC_CASES[case]
    return public_mcmc_setup(path, fns, _nd_hmc_target(target), tm.HMC(**kw),
                             temps, False, device, n_steps, n_burnin)


@pytest.fixture(scope="module")
def nd_hmc_libraries():
    """Builds every nd and tempered HMC library of this section at once
    (nvcc in parallel): each case runs once on a small grid."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    grid = plan_mcmc_grid(1024)
    with ThreadPoolExecutor(max_workers=16) as pool:
        futures = [pool.submit(
            lambda c=c: _nd_hmc_setup(c, device, 10, 2)[0](grid))
            for c in ND_HMC_CASES]
        futures += [pool.submit(_state_build, "nd-hmc", device, resume, grid)
                    for resume in (False, True)]
        for f in futures:
            f.result()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ND_HMC_CASES))
def test_nd_and_tempered_hmc_kernels_match_plain_version(
        cuda_device, nd_hmc_libraries, case):
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    path = ND_HMC_CASES[case][0]
    wrapper = mcmc_nd_cuda if path == "nd" else mcmc_pt_cuda
    before = wrapper.hmc_launches
    check_public_mcmc(path, _nd_hmc_setup(case, cuda_device, 1000, 200))
    assert wrapper.hmc_launches == before + 1


@pytest.mark.cuda
def test_tempered_hmc_layouts_run_the_same_ladders(cuda_device):
    # Rungs on one lane each at any group, and the ladder layout, run the
    # same ladders bit for bit.
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        LADDER_LAYOUT,
        McmcPtProgram,
        PtLayout,
        mcmc_pt_cuda,
    )

    integ = tm.MonteCarloIntegrator(device=cuda_device)
    _, fns, target, kw, temps = ND_HMC_CASES["pt-joint"]
    parsed = integ._parse_nd_mcmc_args(_nd_hmc_target(target), tm.HMC(**kw))
    prog, cfg, params, ladder = integ._pt_kernel_program(
        fns, tm.HMC(**kw), parsed, tuple(1.0 / t for t in temps), 301, 13,
        False)
    runs = [mcmc_pt_cuda(p, cfg, params, ladder, 42, SEVERAL_PROGRAMS)
            for p in [prog] + [McmcPtProgram(prog.fns, cfg, prog.target,
                                             layout=layout)
                               for layout in (PtLayout(4, 1, 1),
                                              PtLayout(4, 1, 8),
                                              LADDER_LAYOUT)]]
    torch.cuda.synchronize()
    for got in runs[1:]:
        assert torch.equal(got.rows, runs[0].rows)
        assert torch.equal(got.x_final, runs[0].x_final)


@pytest.mark.cuda
def test_integrate_mcmc_nd_and_tempered_hmc_on_cuda_match_cpu(cuda_device):
    kw = dict(n_steps=300, n_chains=2048, n_burnin=100, seed=3)
    hmc = tm.HMC(step_size=0.4, n_leapfrog=8, init_range=(-4.0, 4.0))
    calls = [
        lambda dev: tm.integrate_mcmc([lambda x, y: x * y], _c9e_target(), hmc,
                                      device=dev, **kw),
        lambda dev: tm.integrate_mcmc([lambda x, y: x * x + y * y],
                                      _c9e_target(), hmc, device=dev,
                                      return_diagnostics=True,
                                      return_samples=20, **kw),
        lambda dev: tm.integrate_mcmc(
            [lambda x: x * x], _logmix,
            tm.HMC(step_size=0.35, n_leapfrog=8, init_range=(3.0, 5.0)),
            temperatures=[1.0, 2.0, 4.0, 8.0], device=dev, **kw),
    ]
    for call in calls:
        got, want = call(cuda_device), call("cpu")
        assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-3
        np.testing.assert_allclose(got.values, want.values, atol=2e-3,
                                   rtol=1e-4)
        if got.samples is not None:  # nd HMC with diagnostics and draws
            np.testing.assert_allclose(got.diagnostics["r_hat"],
                                       want.diagnostics["r_hat"], rtol=1e-4)
            np.testing.assert_allclose(got.samples, want.samples, atol=1e-3)


# -- the batch axis of the integrate, nd integrate and 1-D MCMC kernels -------
#
# R jobs in one launch: rep r's rows (and final states and draws) are the
# unbatched launch's with seed r (and row r), bit for bit, and so are its
# sums, summed as the unbatched path sums them.  A batch of one is the
# existing path.

BATCH_SEEDS = [7, 42, 2**32 - 5]


def _seed_words(device, seeds=BATCH_SEEDS):
    return torch.from_numpy(np.asarray(seeds, np.uint32).view(np.int32)).to(device)


def _batch_cases():
    """(name, functions, distribution rows, method, error bars)."""
    n = [tm.Distribution.normal(0.5, 1.5), tm.Distribution.normal(-1.0, 0.5),
         tm.Distribution.normal(2.0, 3.0)]
    return {
        "mc": (BENCH, n[:1], "mc", False),
        "mc-stderr": (BENCH, n[:1], "mc", True),
        "antithetic-stderr": (BENCH, n[:1], "antithetic", True),
        "qmc": (BENCH, n[:1], "qmc", False),
        "qmc-stderr": (BENCH, n[:1], "qmc", True),
        "params-mc": (BENCH, n, "mc", False),
        "params-stderr": (BENCH, n, "mc", True),
        "params-gumbel": (BENCH[:4], [tm.Distribution.gumbel(1.0, 0.5),
                                      tm.Distribution.gumbel(-2.0, 3.0),
                                      tm.Distribution.gumbel(0.0, 1.0)],
                          "antithetic", True),
        "custom": (BENCH[:4], [tm.Distribution.beta(2.0, 5.0)], "mc", True),
        "custom-qmc": (BENCH[:4], [tm.Distribution.beta(2.0, 5.0)], "qmc", False),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_batch_cases()))
def test_integrate_batch_is_its_unbatched_launches(cuda_device, case):
    from tpu_montecarlo_torch.api.device import sampling_tables
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        integrate_batch,
        integrate_batch_rows,
        integrate_rows,
        pilot_values,
    )

    fns, dists, method, stderr = _batch_cases()[case]
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in fns))
    cfg = IntegrateConfig(method, stderr)
    grid = plan_grid(1 << 22, method)
    spec = dist_spec_of(dists[0])
    tables = None
    if spec.kind == DistKind.CUSTOM:
        tables = sampling_tables(dists[0], spec, cuda_device)
    rows = [torch.tensor(dist_spec_of(d).params, device=cuda_device)
            for d in dists]
    pilots = [pilot_values(program.torch_values, spec.kind, p, tables)
              if stderr else None for p in rows]
    per_rep = len(rows) > 1
    params = torch.stack(rows) if per_rep else rows[0]
    pilot = (torch.stack(pilots) if per_rep else pilots[0]) if stderr else None
    seeds = _seed_words(cuda_device, BATCH_SEEDS[:len(rows)] if per_rep
                        else BATCH_SEEDS)
    before = (integrate_cuda.launches, integrate_cuda.batch_launches)
    batch_rows = integrate_batch_rows(program, spec.kind, params, seeds, grid,
                                      cfg, pilot, tables)
    assert (integrate_cuda.launches, integrate_cuda.batch_launches) == (
        before[0] + 1, before[1] + 1)
    sums = integrate_batch(program, spec.kind, params, seeds, grid, cfg, pilot,
                           tables)
    for r, seed in enumerate(seeds.cpu().numpy().view(np.uint32).tolist()):
        p = rows[r] if per_rep else rows[0]
        pl = pilots[r] if per_rep else pilots[0]
        assert torch.equal(batch_rows[r], integrate_rows(
            program, spec.kind, p, seed, grid, cfg, pl, tables))
        assert torch.equal(sums[r], integrate_cuda(
            program, spec.kind, p, seed, grid, cfg, pl, tables))
    # A batch of one is the existing path.
    one = integrate_batch(program, spec.kind, params[:1] if per_rep else params,
                          seeds[:1], grid, cfg,
                          pilot[:1] if per_rep and stderr else pilot, tables)
    assert torch.equal(one[0], integrate_cuda(program, spec.kind, rows[0],
                                              BATCH_SEEDS[0], grid, cfg,
                                              pilots[0], tables))
    # And the batch is the plain version's, rep by rep.
    cpu_tables = None if tables is None else sampling_tables(dists[0], spec, "cpu")
    want = integrate_batch(
        program, spec.kind, params.cpu(), seeds.cpu(), grid, cfg,
        None if pilot is None else pilot.cpu(), cpu_tables)
    np.testing.assert_allclose(sums.double().cpu().numpy(),
                               want.double().numpy(), rtol=RTOL,
                               atol=ATOL * grid.actual_samples)


def _nd_batch_cases():
    c9 = [[tm.Distribution.normal(0.0, 1.0), tm.Distribution.uniform(0.0, 1.0),
           tm.Distribution.exponential(2.0)],
          [tm.Distribution.normal(1.0, 0.5), tm.Distribution.uniform(-1.0, 1.0),
           tm.Distribution.exponential(0.5)]]
    b = [[tm.Distribution.beta(2.0, 5.0), tm.Distribution.uniform(0.0, 1.0),
          tm.Distribution.exponential(2.0)]]
    return {
        "mc": (c9[:1], "mc", False),
        "antithetic-stderr": (c9[:1], "antithetic", True),
        "qmc": (c9[:1], "qmc", False),
        "params-stderr": (c9, "mc", True),
        "params-qmc-stderr": (c9, "qmc", True),
        "custom": (b, "mc", True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_nd_batch_cases()))
def test_nd_batch_is_its_unbatched_launches(cuda_device, case):
    from tpu_montecarlo_torch.api.device import nd_tables
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
        IntegrateNdProgram,
        NdConfig,
        integrate_nd_batch,
        integrate_nd_batch_rows,
        integrate_nd_cuda,
        integrate_nd_rows,
        pilot_row,
    )

    dists, method, stderr = _nd_batch_cases()[case]
    fns = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
    kinds = tuple(dist_spec_of(d).kind for d in dists[0])
    program = IntegrateNdProgram(tuple(tm.trace_function(f, 3) for f in fns),
                                 kinds)
    cfg = NdConfig(kinds, method, with_stderr=stderr)
    grid = plan_grid(1 << 22, method)
    tables = nd_tables(dists[0], cfg, cuda_device)
    rows = [torch.tensor(np.stack([dist_spec_of(d).params for d in row]),
                         device=cuda_device) for row in dists]
    pilots = [pilot_row(program.torch_fns, kinds, p, tables) if stderr else None
              for p in rows]
    per_rep = len(rows) > 1
    params = torch.stack(rows) if per_rep else rows[0]
    pilot = (torch.stack(pilots) if per_rep else pilots[0]) if stderr else None
    seeds = _seed_words(cuda_device, BATCH_SEEDS[:len(rows)] if per_rep
                        else BATCH_SEEDS)
    before = integrate_nd_cuda.batch_launches
    batch_rows = integrate_nd_batch_rows(program, cfg, params, seeds, grid,
                                         pilot, tables)
    assert integrate_nd_cuda.batch_launches == before + 1
    sums = integrate_nd_batch(program, cfg, params, seeds, grid, pilot, tables)
    for r, seed in enumerate(seeds.cpu().numpy().view(np.uint32).tolist()):
        p = rows[r] if per_rep else rows[0]
        pl = pilots[r] if per_rep else pilots[0]
        assert torch.equal(batch_rows[r], integrate_nd_rows(
            program, cfg, p, seed, grid, pl, tables))
        assert torch.equal(sums[r], integrate_nd_cuda(program, cfg, p, seed,
                                                      grid, pl, tables))
    one = integrate_nd_batch(program, cfg, params[:1] if per_rep else params,
                             seeds[:1], grid,
                             pilot[:1] if per_rep and stderr else pilot, tables)
    assert torch.equal(one[0], integrate_nd_cuda(program, cfg, rows[0],
                                                 BATCH_SEEDS[0], grid,
                                                 pilots[0], tables))


MCMC_BATCH = {
    "independence": (Mode.INDEPENDENCE, [0.0, 3.0, 0.0, 0.0], 0),
    "walk": (Mode.RANDOM_WALK, [1.0, -2.0, 3.0, 0.44], 0),
    "adaptive": (Mode.ADAPTIVE, [1.0, -2.0, 3.0, 0.44], 0),
    "hmc": (Mode.ADAPTIVE, [0.4, -2.0, 3.0, 0.8], 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", ["none", "stderr", "draws"])
@pytest.mark.parametrize("per_rep", [False, True], ids=["seeds", "params"])
@pytest.mark.parametrize("mode", list(MCMC_BATCH))
def test_mcmc_batch_is_its_unbatched_launches(cuda_device, mode, per_rep,
                                              outputs):
    from tpu_montecarlo_torch.ops.mcmc_kernel import (
        McmcOutput,
        mcmc_batch,
        mcmc_batch_finish,
    )

    code, prop_row, leapfrog = MCMC_BATCH[mode]
    program = McmcProgram(tuple(tm.trace_function(f) for f in BENCH[:3]))
    cfg = McmcConfig(code, DistKind.NORMAL, DistKind.NORMAL, 200, 50,
                     with_stderr=outputs == "stderr",
                     samples=8 if outputs == "draws" else 0,
                     hmc_leapfrog=leapfrog)
    grid = plan_mcmc_grid(plan_chains(4096, None))
    targets = [(0.5, 1.5), (-1.0, 0.5), (2.0, 3.0)]
    rows = [torch.tensor([*prop_row[:1], *prop_row[1:], *t],
                         dtype=torch.float32, device=cuda_device)
            for t in (targets if per_rep else targets[:1])]
    if per_rep:
        rows = [r.clone() for r in rows]
        for i, r in enumerate(rows):
            r[0] *= 1.0 + 0.25 * i  # a step (or proposal mean) per rep
    params = torch.stack(rows) if per_rep else rows[0]
    seeds = _seed_words(cuda_device)
    before = (mcmc_cuda.launches, mcmc_cuda.batch_launches)
    out = mcmc_batch(program, cfg, params, seeds, grid)
    assert (mcmc_cuda.launches, mcmc_cuda.batch_launches) == (
        before[0] + 1, before[1] + 1)
    values, acceptance, stderr = mcmc_batch_finish(out, grid, cfg, 3)
    for r, seed in enumerate(BATCH_SEEDS):
        one = mcmc_cuda(program, cfg, rows[r] if per_rep else rows[0], seed,
                        grid)
        assert torch.equal(out.rows[r], one.rows)
        assert torch.equal(out.x_final[r], one.x_final)
        if cfg.samples:
            assert torch.equal(out.samples[r], one.samples)
        v, a, s = mcmc_finish(one, grid, cfg, 3)
        assert torch.equal(values[r], v) and torch.equal(acceptance[r], a)
        if stderr is not None:
            assert torch.equal(stderr[r], s)
    one = mcmc_batch(program, cfg, params[:1] if per_rep else params,
                     seeds[:1], grid)
    ref = mcmc_cuda(program, cfg, rows[0], BATCH_SEEDS[0], grid)
    assert torch.equal(one.rows[0], ref.rows)
    assert isinstance(one, McmcOutput)


@pytest.mark.cuda
def test_handles_on_the_card(cuda_device):
    """The public handles on the card: a batched element is its unbatched
    call bit for bit (seeds given as a list or as a tensor on the card),
    and close to the CPU handle."""
    d = tm.Distribution.normal(0.5, 1.5)
    gpu = tm.MonteCarloIntegrator()  # "cuda": seeds on any CUDA index
    cpu = tm.MonteCarloIntegrator(device="cpu")
    kw = dict(n_samples=1 << 22, return_stderr=True)
    batched = gpu.compile_integrate(BENCH, d, seed_batch=3, **kw)
    single = gpu.compile_integrate(BENCH, d, **kw)
    values, se = batched(_seed_words(cuda_device))
    assert values.device.type == "cuda"
    v2, s2 = batched(BATCH_SEEDS)
    assert torch.equal(values, v2) and torch.equal(se, s2)
    for r, seed in enumerate(BATCH_SEEDS):
        v, s = single(seed)
        assert torch.equal(values[r], v) and torch.equal(se[r], s)
    want, _ = cpu.compile_integrate(BENCH, d, seed_batch=3, **kw)(BATCH_SEEDS)
    np.testing.assert_allclose(values.cpu().double().numpy(),
                               want.double().numpy(), rtol=RTOL, atol=ATOL)
    target, walks = tm.Distribution.normal(0.0, 1.0), [
        tm.RandomWalk(step_size=s, adapt=True) for s in (0.5, 1.0, 2.0)]
    prog = gpu.compile_mcmc([lambda x: x * x], target, walks[0], n_steps=500,
                            n_chains=4096, n_burnin=100, seed_batch=3,
                            param_batch=True, return_stderr=True)
    got = prog(BATCH_SEEDS, tm.pack_param_batch([target] * 3),
               tm.pack_random_walk_batch(walks, target))
    for r, walk in enumerate(walks):
        one = gpu.compile_mcmc([lambda x: x * x], target, walk, n_steps=500,
                               n_chains=4096, n_burnin=100,
                               return_stderr=True)(BATCH_SEEDS[r])
        for g, o in zip(got, one):
            assert torch.equal(g[r], o)


# The nd and tempered kernels' batch axis.  Each rep of a batched launch
# is its unbatched launch, bit for bit (rows, final states, draws and the
# finished values, acceptance, swap rate and error bars), for R = 1, 2,
# 4 and 7 seeds, with one parameter row for every rep or one a rep; one
# chain launch (and one pilot launch under error bars) a batch.  The last
# rep is held against the plain version, chain for chain, at the
# tolerances of _check_nd_mcmc and _check_pt.
R_SEEDS = [7, 42, 2**32 - 5, 11, 12345, 3, 99]
BATCH_STEPS = dict(n_steps=200, n_burnin=50)


def _hmc_walk(**kw):
    return tm.HMC(step_size=0.3, n_leapfrog=3, init_range=(-2.0, 2.0), **kw)


# id: (target, proposal (a maker), stderr, draws, a row per rep)
ND_MCMC_BATCH = {
    "independence-product-params-stderr": (
        [tm.Distribution.normal(0.5, 1.5), tm.Distribution.exponential(1.5)],
        lambda: [tm.Distribution.normal(0.0, 3.0),
                 tm.Distribution.exponential(1.0)], True, 0, True),
    "independence-joint-stderr-draws": (
        _c9e_target, lambda: [tm.Distribution.normal(0.0, 2.0)] * 2, True, 8,
        False),
    "adaptive-walk-product-params-stderr": (
        [tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.normal(0.0, 1.0)],
        lambda: tm.RandomWalk(step_size=[0.5, 1.5], adapt=True), True, 0,
        True),
    "walk-joint-draws": (_c9e_target, lambda: tm.RandomWalk(**_WALK), False,
                         8, False),
    "hmc-joint-stderr": (_c9e_target, _hmc_walk, True, 0, False),
    "custom-product-stderr": (
        [tm.Distribution.beta(2.0, 5.0), tm.Distribution.normal(0.0, 1.0)],
        lambda: [tm.Distribution.uniform(0.0, 1.0),
                 tm.Distribution.normal(0.0, 2.0)], True, 0, False),
}


def _rep_rows(params, reps):
    """R parameter rows: the first column (a proposal's first word or a
    walk's step) and the target's first word moved per rep."""
    rows = params.expand(reps, *params.shape).clone()
    for r in range(reps):
        rows[r, :, 0] *= 1.0 + 0.25 * r
        rows[r, :, 4] += 0.1 * r
    return rows


def _same(got, want):
    assert got is None and want is None or torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 2, 4, 7])
@pytest.mark.parametrize("case", list(ND_MCMC_BATCH))
def test_mcmc_nd_batch_is_its_unbatched_launches(cuda_device, case, reps):
    from tpu_montecarlo_torch.api.mcmc_nd import dim_tables
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        mcmc_nd_batch,
        mcmc_nd_cuda,
        mcmc_nd_reference,
    )
    from tpu_montecarlo_torch.ops.mcmc_kernel import mcmc_batch_finish

    target, proposal, stderr, draws, per_rep = ND_MCMC_BATCH[case]
    integ = tm.MonteCarloIntegrator(device=cuda_device)
    target = target() if callable(target) else target
    parsed = integ._parse_nd_mcmc_args(target, proposal())
    fns = ND_MCMC_FNS[parsed[3]]
    program, cfg, params = integ._nd_mcmc_kernel_program(
        fns, proposal(), parsed, BATCH_STEPS["n_steps"],
        BATCH_STEPS["n_burnin"], stderr, samples=draws)
    tables = dim_tables(parsed[0], parsed[1], parsed[3], cuda_device)
    grid = plan_mcmc_grid(plan_chains(4096, None))
    rows = _rep_rows(params, reps) if per_rep else params
    seeds = _seed_words(cuda_device, R_SEEDS[:reps])
    before = (mcmc_nd_cuda.launches, mcmc_nd_cuda.batch_launches,
              mcmc_nd_cuda.pilot_launches)
    out = mcmc_nd_batch(program, cfg, rows, seeds, grid, tables)
    assert (mcmc_nd_cuda.launches, mcmc_nd_cuda.batch_launches,
            mcmc_nd_cuda.pilot_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(stderr))
    k = len(program.fns)
    finished = mcmc_batch_finish(out, grid, cfg, k)
    for r, seed in enumerate(R_SEEDS[:reps]):
        row = rows[r] if per_rep else params
        one = mcmc_nd_cuda(program, cfg, row, seed, grid, tables)
        assert torch.equal(out.rows[r], one.rows)
        assert torch.equal(out.x_final[r], one.x_final)
        _same(None if out.samples is None else out.samples[r], one.samples)
        for got, want in zip(finished, mcmc_finish(one, grid, cfg, k)):
            _same(None if got is None else got[r], want)
    want = mcmc_nd_reference(program.torch_fns, program.torch_target, cfg,
                             row, R_SEEDS[reps - 1], grid, tables,
                             torch_target_grad=program.torch_target_grad)
    x_k, x_p = out.x_final[-1].cpu(), want.x_final.cpu()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%}"
    v_p, a_p, _ = mcmc_finish(want, grid, cfg, k)
    _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert abs(float(finished[1][-1]) - float(a_p)) <= 1e-3
    np.testing.assert_array_less(
        (finished[0][-1] - v_p).abs().cpu().numpy(),
        (0.2 * se + 1e-6).cpu().numpy())


# id: (target, proposal (a maker), temperatures, stderr, d).  The last
# runs 33 rungs: past 32 rung lanes, on the ladder layout.
PT_BATCH = {
    "adaptive-walk-logmix-stderr": (lambda: _logmix,
                                    lambda: tm.RandomWalk(**_C12_WALK),
                                    _LADDER4, True, 1),
    "independence-logmix": (lambda: _logmix,
                            lambda: tm.Distribution.normal(0.0, 6.0),
                            _LADDER4, False, 1),
    "hmc-logmix-stderr": (lambda: _logmix, _hmc_walk, _LADDER4, True, 1),
    "independence-2d-product-params-stderr": (
        [tm.Distribution.uniform(-1.0, 2.0), tm.Distribution.exponential(1.5)],
        lambda: [tm.Distribution.normal(0.5, 1.5),
                 tm.Distribution.exponential(1.0)], [1.0, 2.5], True, 2),
    "walk-ladder-T33-stderr": (
        tm.Distribution.normal(1.0, 2.0),
        lambda: tm.RandomWalk(step_size=1.0, init_range=(-3.0, 5.0)),
        [1.0 + 0.25 * t for t in range(33)], True, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 2, 4, 7])
@pytest.mark.parametrize("case", list(PT_BATCH))
def test_mcmc_pt_batch_is_its_unbatched_launches(cuda_device, case, reps):
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
        LADDER_LAYOUT,
        mcmc_pt_batch,
        mcmc_pt_cuda,
        mcmc_pt_reference,
        pt_batch_finish,
        pt_finish,
    )

    target, proposal, temps, stderr, d = PT_BATCH[case]
    program, cfg, params, ladder = _pt_setup(
        target, proposal(), temps, stderr, _pt_fns(d), cuda_device,
        **BATCH_STEPS)
    if len(temps) > 32:
        assert program.layout == LADDER_LAYOUT
    grid = plan_mcmc_grid(plan_chains(4096, None))
    per_rep = "params" in case
    rows = _rep_rows(params, reps) if per_rep else params
    seeds = _seed_words(cuda_device, R_SEEDS[:reps])
    before = (mcmc_pt_cuda.launches, mcmc_pt_cuda.batch_launches,
              mcmc_pt_cuda.pilot_launches)
    out = mcmc_pt_batch(program, cfg, rows, ladder, seeds, grid)
    assert (mcmc_pt_cuda.launches, mcmc_pt_cuda.batch_launches,
            mcmc_pt_cuda.pilot_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(stderr))
    k = len(program.fns)
    finished = pt_batch_finish(out, grid, cfg, k)
    for r, seed in enumerate(R_SEEDS[:reps]):
        row = rows[r] if per_rep else params
        one = mcmc_pt_cuda(program, cfg, row, ladder, seed, grid)
        assert torch.equal(out.rows[r], one.rows)
        assert torch.equal(out.x_final[r], one.x_final)
        for got, want in zip(finished, pt_finish(one, grid, cfg, k)):
            _same(None if got is None else got[r], want)
    want = mcmc_pt_reference(program.torch_fns, program.torch_target, cfg,
                             row, ladder, R_SEEDS[reps - 1], grid, None,
                             program.torch_target_grad)
    x_k, x_p = out.x_final[-1].cpu(), want.x_final.cpu()
    split = ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).any(dim=0)
    assert split.float().mean() <= 0.01, f"{float(split.float().mean()):.2%}"
    v_p, a_p, w_p, _ = pt_finish(want, grid, cfg, k)
    _, _, _, se = pt_finish(want, grid, replace(cfg, with_stderr=True), k)
    assert abs(float(finished[1][-1]) - float(a_p)) <= 1e-3
    assert abs(float(finished[2][-1]) - float(w_p)) <= 1e-3
    np.testing.assert_array_less(
        (finished[0][-1] - v_p).abs().cpu().numpy(),
        (0.2 * se + 1e-6).cpu().numpy())


@pytest.mark.cuda
def test_nd_and_tempered_batch_refusals(cuda_device):
    """A batch runs stateless chains without diagnostics, a tempered one
    without draws; the kernels refuse them too (a launch error raises)."""
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_batch
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_batch

    grid = plan_mcmc_grid(plan_chains(4096, None))
    seeds = _seed_words(cuda_device, R_SEEDS[:2])
    integ = tm.MonteCarloIntegrator(device=cuda_device)
    walk = tm.RandomWalk(**_WALK)
    parsed = integ._parse_nd_mcmc_args(_c9e_target(), walk)
    program, cfg, params = integ._nd_mcmc_kernel_program(
        ND_MCMC_FNS[2], walk, parsed, 20, 5, False, with_diagnostics=True)
    with pytest.raises(ValueError, match="without diagnostics"):
        mcmc_nd_batch(program, cfg, params, seeds, grid)
    program, cfg, params, ladder = _pt_setup(
        lambda: _logmix, tm.RandomWalk(**_C12_WALK), _LADDER4, False,
        _pt_fns(1), cuda_device, 20, 5)
    with pytest.raises(ValueError, match="no draws"):
        mcmc_pt_batch(program, replace(cfg, samples=4), params, ladder, seeds,
                      grid)
    lib = program.library()
    rows = torch.empty((2, 128, 3, 3), device=cuda_device)
    x = torch.empty((2, 1, 4096), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for reps, stride in ((0, 0), (65536, 0), (2, 5)):
        assert lib.tmc_mcmc_pt(0, seeds.data_ptr(), reps, params.data_ptr(),
                               stride, ladder.data_ptr(), None, 5, 20, 1024,
                               4096, None, rows.data_ptr(), x.data_ptr(),
                               None, 0, 0, stream) != 0


@pytest.mark.cuda
def test_nd_and_tempered_handles_on_the_card(cuda_device):
    """The nd and tempered handles on the card: one chain launch a batch
    call, a batched element its unbatched call bit for bit, and close to
    the CPU handle."""
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
    from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

    gpu = tm.MonteCarloIntegrator()
    cpu = tm.MonteCarloIntegrator(device="cpu")
    kw = dict(n_steps=300, n_chains=4096, n_burnin=100, return_stderr=True)
    n = tm.Distribution.normal
    fns = ND_MCMC_FNS[2]
    targets = [[n(0.5 * r, 1.0), n(1.0, 1.0 + r)] for r in range(3)]
    walks = [tm.RandomWalk(step_size=[0.5 + 0.25 * r, 1.0], adapt=True)
             for r in range(3)]
    cases = [
        ("nd seeds", gpu.compile_mcmc(fns, _c9e_target(), [n(0.0, 2.0)] * 2,
                                      seed_batch=3, return_samples=5, **kw),
         lambda r: gpu.compile_mcmc(fns, _c9e_target(), [n(0.0, 2.0)] * 2,
                                    return_samples=5, **kw)(R_SEEDS[r]),
         (R_SEEDS[:3],), mcmc_nd_cuda),
        ("nd walks", gpu.compile_mcmc(fns, targets[0], walks[0], seed_batch=3,
                                      param_batch=True, **kw),
         lambda r: gpu.compile_mcmc(fns, targets[r], walks[r],
                                    **kw)(R_SEEDS[r]),
         (R_SEEDS[:3], tm.pack_param_batch_nd(targets),
          tm.pack_random_walk_batch_nd(walks, targets)), mcmc_nd_cuda),
        ("tempered", gpu.compile_mcmc(ND_MCMC_FNS[1], _logmix,
                                      tm.RandomWalk(**_C12_WALK),
                                      temperatures=_LADDER4, seed_batch=3,
                                      **kw),
         lambda r: gpu.compile_mcmc(ND_MCMC_FNS[1], _logmix,
                                    tm.RandomWalk(**_C12_WALK),
                                    temperatures=_LADDER4, **kw)(R_SEEDS[r]),
         (R_SEEDS[:3],), mcmc_pt_cuda),
    ]
    for name, prog, one, args, wrapper in cases:
        before = (wrapper.launches, wrapper.batch_launches)
        got = prog(*args)
        assert (wrapper.launches, wrapper.batch_launches) == (
            before[0] + 1, before[1] + 1), name
        assert got[0].device.type == "cuda"
        for r in range(3):
            want = one(r)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert torch.equal(g[r], w), name
    got = cases[2][1](R_SEEDS[:3])
    want = cpu.compile_mcmc(ND_MCMC_FNS[1], _logmix,
                            tm.RandomWalk(**_C12_WALK), temperatures=_LADDER4,
                            seed_batch=3, **kw)(R_SEEDS[:3])
    np.testing.assert_array_less(
        (got[0].cpu() - want[0]).abs().numpy(),
        (0.2 * want[3] + 1e-6).numpy())


# -- sets wider than one launch takes, and control variates -------------------


@pytest.mark.cuda
def test_wide_integrate_passes_on_the_card(cuda_device):
    """More than 128 functions on the card: one launch a group, the same
    integrand bit-equal in both passes, each pass its single launch over
    its group bit for bit, and the plain version's values on the CPU
    within rel 1e-5 + 1e-6."""
    sq = tm.trace_function(lambda x: x * x)
    gpu = tm.MonteCarloIntegrator()
    n01 = tm.Distribution.normal(0.0, 1.0)
    before = integrate_cuda.launches
    r = gpu.integrate([sq] * 129, n01, n_samples=1 << 22)
    assert integrate_cuda.launches == before + 2
    assert np.all(r.values == r.values[0])
    fns = [tm.trace_function(f) for f in WIDEST] + [sq, sq]
    for stderr in (False, True):
        wide = gpu.integrate(fns, n01, n_samples=1 << 22,
                             return_stderr=stderr)
        parts = [gpu.integrate(fns[:65], n01, n_samples=1 << 22,
                               return_stderr=stderr),
                 gpu.integrate(fns[65:], n01, n_samples=1 << 22,
                               return_stderr=stderr)]
        np.testing.assert_array_equal(
            wide.values, np.concatenate([p.values for p in parts]))
        if stderr:
            np.testing.assert_array_equal(
                wide.stderr, np.concatenate([p.stderr for p in parts]))
    cpu = tm.MonteCarloIntegrator(device="cpu").integrate(
        fns, n01, n_samples=1 << 22)
    np.testing.assert_allclose(wide.values, cpu.values, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wide_mcmc_passes_run_the_same_chains_on_the_card(cuda_device):
    """Two groups on the card, 1-D, nd and tempered: the same integrand
    bit-equal at the same place of each pass (the call checks the passes'
    states and counts), and close to the CPU's plain passes."""
    gpu = tm.MonteCarloIntegrator()
    cpu = tm.MonteCarloIntegrator(device="cpu")
    n = tm.Distribution.normal
    kw = dict(n_steps=300, n_chains=4096, n_burnin=100, return_stderr=True)
    one = tm.trace_function(lambda x: x * x + 0.5 * x)
    two = tm.trace_function(lambda x, y: x * y + 0.5 * x, 2)
    cases = [
        ([one] * 128, n(0.0, 1.0), n(0.0, 2.0), {}),
        ([two] * 128, _c9e_target(), [n(0.0, 2.0)] * 2, {}),
        ([one] * 128, _logmix, tm.RandomWalk(**_C12_WALK),
         {"temperatures": _LADDER4}),
    ]
    for fns, target, proposal, extra in cases:
        got = gpu.integrate_mcmc(fns, target, proposal, **kw, **extra)
        np.testing.assert_array_equal(got.values[:64], got.values[64:])
        np.testing.assert_array_equal(got.stderr[:64], got.stderr[64:])
        want = cpu.integrate_mcmc(fns, target, proposal, **kw, **extra)
        np.testing.assert_array_less(np.abs(got.values - want.values),
                                     0.2 * want.stderr + 1e-6)


@pytest.mark.cuda
def test_control_variates_on_the_card(cuda_device):
    """A composed set over 128 (two passes) on the card against the CPU's
    plain version: values within rel 1e-5, error bars within rel 1e-3."""
    fns = [(lambda c: lambda x: math.e ** (0.5 * x) + c)(j / 8.0)
           for j in range(20)]
    controls = [(lambda x: x, 0.0), (lambda x: x * x, 1.0),
                (lambda x: x * x * x, 0.0), (lambda x: math.sin(x), 0.0)]
    kw = dict(n_samples=1 << 22, return_stderr=True,
              control_variates=controls)
    n01 = tm.Distribution.normal(0.0, 1.0)
    before = integrate_cuda.launches
    got = tm.MonteCarloIntegrator().integrate(fns, n01, **kw)
    assert integrate_cuda.launches == before + 2
    want = tm.MonteCarloIntegrator(device="cpu").integrate(fns, n01, **kw)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5)
    np.testing.assert_allclose(got.stderr, want.stderr, rtol=1e-3)


# -- the gradient builds (expectation_fn): kernels 1 and 2 ---------------------------
#
# A gradient build draws its value build's samples and adds each value in
# the same order, so its value sums are the value build's bit for bit;
# its pathwise sums are held against the plain version's within 1e-5
# relative plus 1e-5 of the mean |f'(x) dx/dp| on the quantile grid (the
# kernel's affine steps round once, its transcendentals differ from
# torch's in the last bit, and the sums' orders differ).

GRAD_FAMILIES = {
    DistKind.UNIFORM: (-1.0, 2.0),
    DistKind.NORMAL: (0.5, 1.5),
    DistKind.EXPONENTIAL: (2.0, 0.0),
    DistKind.LOGNORMAL: (0.0, 0.5),
    DistKind.CAUCHY: (0.0, 1.0),
    DistKind.LAPLACE: (3.0, 1.0),
    DistKind.LOGISTIC: (0.0, 2.0),
    DistKind.GUMBEL: (1.0, 0.5),
    DistKind.WEIBULL: (1.5, 2.0),
    DistKind.PARETO: (1.0, 3.0),
}
GRAD_CASES = [(k, m) for k in (DistKind.UNIFORM, DistKind.NORMAL,
                               DistKind.EXPONENTIAL)
              for m in ("mc", "antithetic", "qmc")] + [
    (k, "mc") for k in GRAD_FAMILIES if k > DistKind.CUSTOM]
GRAD_TOL = 1e-5


def _grad_size(program, kind, params):
    """(K, 2): the mean |f_k'(x) dx/dp| over the 1,024 quantile midpoints
    of the family."""
    from tpu_montecarlo_torch.sampling import transform_grad_from_u

    u = (torch.arange(1024, dtype=torch.float32) + 0.5) / 1024.0
    p = params.cpu()
    x, d1, d2 = transform_grad_from_u(u, kind, p[0], p[1])
    out = []
    for vg in program.torch_grads:
        _, (g,) = vg(x)
        out.append([float((g * d).abs().mean()) for d in (d1, d2)])
    return np.array(out)


@pytest.fixture(scope="module")
def grad_libraries():
    """BENCH's program with its value and gradient libraries for every
    GRAD_CASES configuration, built at once."""
    from tpu_montecarlo_torch.api.passes import build_all
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        library_route,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program = _program(BENCH)
    libs = {(IntegrateConfig(m, grad=g), library_route(k))
            for k, m in GRAD_CASES for g in (False, True)}
    build_all([lambda c=c, r=r: program.library(c, r) for c, r in libs])
    return program


@pytest.mark.cuda
@pytest.mark.parametrize("kind,method", GRAD_CASES,
                         ids=[f"{k.name.lower()}-{m}" for k, m in GRAD_CASES])
def test_grad_kernel_matches_plain_version(cuda_device, grad_libraries, kind,
                                           method):
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        integrate_grad_cuda,
        integrate_grad_reference,
    )

    program = grad_libraries
    cfg = IntegrateConfig(method, grad=True)
    grid = plan_grid(1 << 22, method)
    params = torch.tensor(GRAD_FAMILIES[kind], device=cuda_device)
    before = (integrate_cuda.launches, integrate_cuda.grad_launches)
    sums, grads = integrate_grad_cuda(program, kind, params, 42, grid, cfg)
    torch.cuda.synchronize()
    assert (integrate_cuda.launches, integrate_cuda.grad_launches) == (
        before[0] + 1, before[1] + 1)
    values = integrate_cuda(program, kind, params, 42, grid,
                            IntegrateConfig(method))
    assert torch.equal(sums, values)
    want_s, want_g = integrate_grad_reference(program, kind, params, 42, grid,
                                              cfg)
    assert torch.equal(want_s, integrate_reference(
        program.torch_values, kind, params, 42, grid, IntegrateConfig(method)))
    n = float(np.float32(grid.actual_samples))
    m_k, m_p = (sums / n).double().cpu().numpy(), (want_s / n).double().cpu().numpy()
    assert np.all(np.isfinite(m_k))
    np.testing.assert_allclose(m_k, m_p, rtol=RTOL, atol=ATOL)
    g_k, g_p = (grads / n).double().cpu().numpy(), (want_g / n).double().cpu().numpy()
    size = _grad_size(program, kind, params)
    with np.errstate(invalid="ignore"):
        close = (g_k == g_p) | (np.abs(g_k - g_p) <= GRAD_TOL * (np.abs(g_p) + size))
    assert np.all(close), (g_k, g_p)
    # An indicator's pathwise gradient is 0, as under jax.grad.
    assert np.array_equal(g_k[6], [0.0, 0.0])


@pytest.mark.cuda
def test_grad_kernel_wide_set_in_passes(cuda_device):
    """33 functions: one value launch on the run-time position loop, two
    gradient groups of 17 and 16, the second compiled onto that loop
    (``wide_loop``); values bit for bit, gradients against the plain
    version."""
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateConfig,
        integrate_grad_reference,
    )

    fns = [(lambda c: lambda x: np.sin(c * x) + x * x)(0.1 * j)
           for j in range(33)]
    integ = tm.MonteCarloIntegrator()
    est = integ.expectation_fn(fns, tm.Distribution.normal(0.0, 1.0),
                               n_samples=1 << 22)
    leaf = torch.tensor([0.5, 1.5], device=cuda_device, requires_grad=True)
    before = integrate_cuda.grad_launches
    vals = est(leaf)
    torch.cuda.synchronize()
    assert integrate_cuda.grad_launches == before + 2
    ref = integ.integrate(fns, tm.Distribution.normal(0.5, 1.5),
                          n_samples=1 << 22)
    np.testing.assert_array_equal(vals.detach().cpu().numpy(),
                                  np.float32(ref.values))
    (jac,) = torch.autograd.grad(vals[7], leaf)
    program = _program(fns)
    grid = plan_grid(1 << 22)
    _, want = integrate_grad_reference(program, DistKind.NORMAL,
                                       torch.tensor([0.5, 1.5], device=cuda_device),
                                       42, grid, IntegrateConfig("mc", grad=True))
    n = float(np.float32(grid.actual_samples))
    np.testing.assert_allclose(jac.cpu().numpy(), (want[7] / n).cpu().numpy(),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_nd_grad_kernel_matches_plain_version(cuda_device, method):
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
        IntegrateNdProgram,
        NdConfig,
        integrate_nd_cuda,
        integrate_nd_grad_cuda,
        integrate_nd_grad_reference,
    )

    kinds = (DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL)
    fns = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
    program = IntegrateNdProgram(tuple(tm.trace_function(f, 3) for f in fns),
                                 kinds)
    params = torch.tensor([[0.0, 1.0], [0.0, 1.0], [2.0, 0.0]],
                          device=cuda_device)
    grid = plan_grid(1 << 22, method)
    cfg = NdConfig(kinds, method, grad=True)
    before = integrate_nd_cuda.grad_launches
    sums, grads = integrate_nd_grad_cuda(program, cfg, params, 42, grid)
    torch.cuda.synchronize()
    assert integrate_nd_cuda.grad_launches == before + 1
    assert torch.equal(sums, integrate_nd_cuda(
        program, NdConfig(kinds, method), params, 42, grid))
    want_s, want_g = integrate_nd_grad_reference(program.torch_grads, cfg,
                                                 params, 42, grid)
    n = float(np.float32(grid.actual_samples))
    np.testing.assert_allclose((sums / n).cpu().numpy(),
                               (want_s / n).cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose((grads / n).cpu().numpy(),
                               (want_g / n).cpu().numpy(), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.cuda
def test_expectation_fn_on_cuda_matches_cpu(cuda_device):
    """The public estimator, 1-D and nd, on the card against the CPU's
    plain version: values and gradients within the kernels' tolerances;
    on the card, one gradient launch a group."""
    fns = [lambda x: x * x, lambda x: np.exp(0.5 * x)]
    nd_fns = [lambda x, y: x * y + y * y]
    runs = [(fns, tm.Distribution.normal(0.0, 1.0), [[0.5, 1.5]]),
            (nd_fns, [tm.Distribution.normal(0.0, 1.0),
                      tm.Distribution.gumbel(1.0, 0.5)],
             [[0.5, 1.5], [1.0, 0.5]])]
    for f, dist, p in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            est = tm.expectation_fn(f, dist, n_samples=1 << 21, device=dev)
            leaf = torch.tensor(p if len(p) > 1 else p[0], requires_grad=True)
            vals = est(leaf, seed=3)
            assert vals.device.type == dev
            vals.sum().backward()
            out[dev] = (vals.detach().cpu().numpy(), leaf.grad.numpy())
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_adapt_proposal_on_cuda_matches_cpu(cuda_device):
    """The card's adaptation draws the CPU's points: the learned edges
    within 1e-3 of the support's width (the per-bin sums' order differs,
    which moves an edge by a sliver of a bin), and the learned proposal's
    IS run on kernel 1 within 5 % of P(X > 4)."""
    target = tm.Distribution.normal(0.0, 1.0)
    edges, learned = {}, {}
    for dev in ("cuda", "cpu"):
        learned[dev], hist = tm.adapt_proposal(
            lambda x: x > 4.0, target, support=(-8.0, 8.0), device=dev,
            return_history=True)
        edges[dev] = hist["edges"][0]
    assert np.max(np.abs(edges["cuda"] - edges["cpu"])) <= 1e-3 * 16.0
    r = tm.integrate_importance_sampling([lambda x: x > 4.0], target,
                                         learned["cuda"],
                                         n_samples=10_000_000,
                                         return_stderr=True)
    truth = 0.5 * math.erfc(4.0 / math.sqrt(2.0))
    assert abs(r.values[0] - truth) < 0.05 * truth
