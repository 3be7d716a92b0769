"""The port's nd importance sampling against the JAX package.

``integrate_importance_sampling(fns, [targets], [proposals])`` with
d >= 2 dimensions runs in the nd kernel: each dimension drawn from its
proposal, every integrand times the product weight prod_j
where(q_j > 0, p_j / q_j, 0) in dimension order, as the JAX kernel's
``weight`` (``integrate_nd_pallas.py:498-520``) computes it in its
kernel route (``_try_is_nd_kernel``).  Each factor is a traced density,
a uniform-grid pdf table (``"table"``) or, for a CUSTOM proposal
dimension, the sampler's own density (``"sampler"``: the stratified
tables' ``qs`` on the stratified dimension, ``(1 / (m - 1)) / dt[i0]``
on the flat inverse).  So the plain version, on the same draws, is held
against the interpret-mode kernel ``build_integrate_nd_pallas(...,
is_weight_nd=...)`` where that kernel keeps 256-row blocks (each shape
asserts that it does):

* means within rel 2e-6 + 1e-6 x each column's size (its mean |value|
  on the pilot grid, or the |mean| if larger): the same weights up to a
  last-bit difference of libm ``exp`` in a traced density (the 1-D
  importance tests' 2e-6, ``tests/test_torch_importance.py``), summed in
  another float32 order;
* error bars within rel 1e-4 + 1e-9 x size.

Where the JAX package leaves its kernel (a gapped or heavy-tailed CUSTOM
proposal, a q that does not trace, a table with no uniform grid, ``qmc``
with error bars or diagnostics), it folds ``f * prod p / prod q`` into
the integrands on its XLA sweep; the port stays in its kernel, and the
JAX package's own nd importance tests (``tests/test_nd.py``,
``tests/test_is_diagnostics.py``) hold it statistically, with their own
tolerances.
"""

import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from scipy.special import erfinv

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.ops.integrate_nd_pallas import build_integrate_nd_pallas
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.device import nd_tables
from tpu_montecarlo_torch.api.results import _unit_integrand
from tpu_montecarlo_torch.ops import integrate_nd_kernel as nk
from tpu_montecarlo_torch.ops.integrate_kernel import (
    SAMPLER,
    KnotWeightTable,
    UniformWeightTable,
    plan_grid,
)
from tpu_montecarlo_torch.sampling import dist_spec_of
from tpu_montecarlo_torch.tracing import TracedFunction
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

CPU_CHUNK = 1 << 22
THREADS = 1024
MEAN_RTOL, MEAN_ATOL = 2e-6, 1e-6
STDERR_RTOL, STDERR_ATOL = 1e-4, 1e-9
N = 1 << 17


def _untraceable(x):
    # An int() cast on a data value does not trace.
    return 0.5 if int(abs(x)) < 1 else 0.0


def _dist(pkg, name):
    d = pkg.Distribution
    return {
        "n01": lambda: d.normal(0.0, 1.0),
        "n0515": lambda: d.normal(0.5, 1.5),
        "nm0309": lambda: d.normal(-0.3, 0.9),
        "n015": lambda: d.normal(0.0, 1.5),
        "u22": lambda: d.uniform(-2.0, 2.0),
        "exp2": lambda: d.exponential(2.0),
        "exp15": lambda: d.exponential(1.5),
        "beta25": lambda: d.beta(2.0, 5.0),
        "beta153": lambda: d.beta(1.5, 3.0),
        "beta33": lambda: d.beta(3.0, 3.0),
        "table": lambda: d(pkg.DistributionType.CUSTOM, {}, _untraceable),
        "beta25tab": lambda: _beta25_table(pkg),
    }[name]()


def _beta25_table(pkg):
    """Beta(2, 5)'s density as a pdf table on a uniform grid (its p is
    then a table; Beta(2, 5) itself traces)."""
    x = np.linspace(0.0, 1.0, 2048)
    return pkg.Distribution.from_pdf_table(x, 30.0 * x * (1.0 - x) ** 4)


F2 = [lambda x, y: x * y, lambda x, y: x + y * y]

# name: (targets, proposals, JAX weight modes per dimension)
IS_CASES = {
    "traced": (("n01", "exp2"), ("n0515", "exp15"),
               (("traced", "traced"), ("traced", "traced"))),
    "table-p": (("table", "n01"), ("u22", "nm0309"),
                (("table", "traced"), ("traced", "traced"))),
    "sampler-q": (("beta25tab", "n01"), ("beta153", "n015"),
                  (("table", "sampler"), ("traced", "traced"))),
    "two-samplers": (("beta25", "beta33"), ("beta153", "beta33"),
                     (("traced", "sampler"), ("traced", "sampler"))),
}
MODES = {
    "mc": ("mc", False),
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
}
RUNS = [(c, m) for c in IS_CASES for m in MODES
        if c in ("traced", "sampler-q") or m in ("mc-stderr", "qmc")]


def _jax_inputs(targets, proposals):
    """The JAX kernel route's is_weight_nd and weight tables
    (``_try_is_nd_kernel``)."""
    integ = jmc.MonteCarloIntegrator()
    weight, tables, modes = [], [], []
    for t, q in zip(targets, proposals):
        p_mode = integ._pdf_mode(t)
        if p_mode[0] == "traced":
            p_arg = p_mode[1]
        else:
            p_k = jdevice._uniform_table_mode(t, p_mode)
            p_arg = "table"
            tables += [np.asarray(a) for a in jdevice._device_mode_tables(t, p_k)]
        if j_dist_spec_of(q).kind == JKind.CUSTOM:
            q_arg = "sampler"
        else:
            q_arg = integ._pdf_mode(q)[1]
        weight.append((p_arg, q_arg))
        modes.append(tuple(a if isinstance(a, str) else "traced" for a in (p_arg, q_arg)))
    return tuple(weight), tables, tuple(modes)


def _jax_run(fns, targets, proposals, method, with_stderr, n, seed=42):
    weight, wtables, modes = _jax_inputs(targets, proposals)
    specs = [j_dist_spec_of(q) for q in proposals]
    kinds = tuple(s.kind for s in specs)
    d = len(kinds)
    sizes = tuple(s.x_table.shape[0] if s.kind == JKind.CUSTOM else 0 for s in specs)
    run = build_integrate_nd_pallas(
        tuple(j_trace(f, d) for f in fns), kinds,
        j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK), interpret=True,
        method=method, with_stderr=with_stderr, table_sizes=sizes,
        is_weight_nd=weight,
    )
    assert run.block_rows == 256
    x_tables = tuple(s.x_table if s.kind == JKind.CUSTOM else jnp.zeros(1, jnp.float32)
                     for s in specs)
    out = run(np.int32(seed), np.stack([s.params for s in specs]), x_tables,
              tuple(wtables))
    if with_stderr:
        out = (np.asarray(out[0]), np.asarray(out[1]))
    else:
        out = np.asarray(out)
    return out, run.actual_samples, modes


def _port_program(fns, targets, proposals, integ=None):
    integ = integ or tm.MonteCarloIntegrator(device="cpu")
    weight = tuple(integ._is_weight_dim(t, q) for t, q in zip(targets, proposals))
    kinds = tuple(dist_spec_of(q).kind for q in proposals)
    d = len(kinds)
    return nk.IntegrateNdProgram(tuple(tm.trace_function(f, d) for f in fns),
                                 kinds, weight)


def _port_run(program, proposals, method, with_stderr, n, seed=42):
    cfg = nk.NdConfig(program.kinds, method, with_stderr)
    params = torch.tensor(np.stack([dist_spec_of(q).params for q in proposals]))
    tables = nd_tables(proposals, cfg, "cpu", program.sampler_dims)
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    # The weight is never negative: |f w| = |f| w.
    size = nk.pilot_row([lambda *x, f=f: f(*x).abs() for f in program.torch_fns],
                        program.kinds, params, tables, program.torch_weight)
    if not with_stderr:
        sums = nk.integrate_nd_cuda(program, cfg, params, seed, grid, tables=tables)
        return (sums / float(np.float32(grid.actual_samples))).numpy(), grid, size.numpy()
    pilot = nk.pilot_row(program.torch_fns, program.kinds, params, tables,
                         program.torch_weight)
    sums, sqs = nk.integrate_nd_cuda(program, cfg, params, seed, grid, pilot, tables)
    mean, se = nk.finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return (mean.numpy(), se.numpy()), grid, size.numpy()


def _close(got, want, rtol, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol
    assert np.all(np.abs(got - want) <= tol), (got, want, tol)


def _agree(got, want, with_stderr, size):
    size = np.maximum(np.asarray(size, np.float64),
                      np.abs(want[0] if with_stderr else want))
    if with_stderr:
        _close(got[0], want[0], MEAN_RTOL, MEAN_ATOL * size)
        _close(got[1], want[1], STDERR_RTOL, STDERR_ATOL * size)
        assert np.all(got[1] > 0)
    else:
        assert got.dtype == np.float32
        _close(got, want, MEAN_RTOL, MEAN_ATOL * size)


@pytest.mark.parametrize("case,mode", RUNS, ids=[f"{c}-{m}" for c, m in RUNS])
def test_plain_version_matches_jax_interpret_kernel(case, mode):
    # Every weight kind (traced, uniform table, the sampler's density on
    # the stratified route and, under qmc or on a second CUSTOM dimension,
    # on the flat one) in every method: the module docstring's
    # tolerances.
    method, with_stderr = MODES[mode]
    t_names, q_names, modes = IS_CASES[case]
    j_t = [_dist(jmc, nm) for nm in t_names]
    j_q = [_dist(jmc, nm) for nm in q_names]
    fns = F2 + [lambda x, y: (x > 0.5) * 1.0]
    want, actual, got_modes = _jax_run(fns, j_t, j_q, method, with_stderr, N)
    assert got_modes == modes
    program = _port_program(fns, [_dist(tm, nm) for nm in t_names],
                            [_dist(tm, nm) for nm in q_names])
    kinds = {"traced": TracedFunction, "table": UniformWeightTable}
    for pair, mode_pair in zip(program.weight, modes):
        for w, m in zip(pair, mode_pair):
            assert w is SAMPLER if m == "sampler" else isinstance(w, kinds[m])
    got, grid, size = _port_run(program, [_dist(tm, nm) for nm in q_names],
                                method, with_stderr, N)
    assert grid.actual_samples == actual
    _agree(got, want, with_stderr, size)


def test_weighted_pilot_matches_jax():
    # The weighted pilot: each dimension's quantile grid, the CUSTOM one
    # through its full inverse, and the product weight at those points.
    # The JAX kernel's _pilot_weight_nd (integrate_nd_pallas.py:776-813)
    # interpolates a table p on its own grid and searches the raw inverse
    # for a sampler q's slope; the port reads the table as the kernel does
    # and takes the slope of the interval the point was drawn from: the
    # same function up to rounding, so the pilots agree within rel 1e-5
    # (any pilot keeps the error bar exact).
    t_names, q_names, _ = IS_CASES["sampler-q"]
    targets = [_dist(tm, nm) for nm in t_names]
    proposals = [_dist(tm, nm) for nm in q_names]
    fns = [lambda x, y: x * y * y, lambda x, y: x + y]
    program = _port_program(fns, targets, proposals)
    cfg = nk.NdConfig(program.kinds, "mc", True)
    params = torch.tensor(np.stack([dist_spec_of(q).params for q in proposals]))
    tables = nd_tables(proposals, cfg, "cpu", program.sampler_dims)
    got = nk.pilot_row(program.torch_fns, program.kinds, params, tables,
                       program.torch_weight).numpy()
    # The JAX formula in float64 at the JAX grid's points.
    base = (np.arange(1024, dtype=np.float32) + np.float32(0.5)) / np.float32(1024)
    u = [np.clip(np.mod(base + np.float32(j) * np.float32(0.3819660113), np.float32(1)),
                 np.float32(1e-7), np.float32(1 - 1e-7)).astype(np.float32) for j in (0, 1)]
    t = j_dist_spec_of(_dist(jmc, q_names[0])).x_table
    m = t.size
    pos = u[0] * np.float32(m - 1)
    i0 = np.clip(pos.astype(np.int32), 0, m - 2)
    x0 = (t[i0] + (pos - i0.astype(np.float32)) * (t[i0 + 1] - t[i0])).astype(np.float64)
    j_t = _dist(jmc, t_names[0])
    integ = jmc.MonteCarloIntegrator()
    gx, gv = (np.asarray(a, np.float64) for a in jdevice._device_mode_tables(
        j_t, jdevice._uniform_table_mode(j_t, integ._pdf_mode(j_t))))
    p0 = np.where((x0 >= gx[0]) & (x0 <= gx[-1]), np.interp(x0, gx, gv), 0.0)
    i = np.clip(np.searchsorted(t, x0, side="right") - 1, 0, m - 2)
    dt = (t[i + 1] - t[i]).astype(np.float64)
    q0 = np.where(dt > 0, (1.0 / (m - 1)) / np.maximum(dt, 1e-38), 0.0)
    x1 = 1.5 * np.sqrt(2.0) * erfinv(2.0 * u[1].astype(np.float64) - 1.0)
    r1 = np.exp(-0.5 * x1**2) / (np.exp(-0.5 * (x1 / 1.5) ** 2) / 1.5)
    w = (p0 / q0) * r1
    want = [np.mean(x0 * x1 * x1 * w), np.mean((x0 + x1) * w)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weight_routes_of_each_dimension():
    # _is_weight_dim takes the JAX kernel route's densities where it has
    # them and stays in the kernel where it has none: a gapped or
    # heavy-tailed CUSTOM proposal's q is its density (traced, or its
    # table), a table with no uniform grid is read on its own grid.
    integ = tm.MonteCarloIntegrator(device="cpu")
    d = tm.Distribution
    beta = _beta25_table(tm)
    gapped = d.mixture([d.uniform(-3.0, -1.0), d.uniform(1.0, 3.0)])
    heavy = d.student_t(5.0)
    p, q = integ._is_weight_dim(d.normal(0.0, 1.0), d.beta(2.0, 5.0))
    assert isinstance(p, TracedFunction) and q is SAMPLER
    for proposal in (gapped, heavy):
        assert dist_spec_of(proposal).exact_inverse
        p, q = integ._is_weight_dim(beta, proposal)
        assert isinstance(p, UniformWeightTable)
        assert isinstance(q, (TracedFunction, UniformWeightTable, KnotWeightTable))
        assert q is not SAMPLER
    x = np.unique(np.concatenate([np.linspace(0.0, 1.0, 300),
                                  0.5 + np.geomspace(1e-5, 1e-3, 60)]))
    spiky = d.from_pdf_table(x, 1.0 + 50.0 * np.exp(-(((x - 0.5) / 1e-5) ** 2)))
    p, _ = integ._is_weight_dim(spiky, d.uniform(0.0, 1.0))
    assert isinstance(p, KnotWeightTable)


# -- the public path --------------------------------------------------------------------

PUBLIC_CASES = {
    "traced-mc-stderr": ("traced", dict(method="mc", return_stderr=True)),
    "traced-antithetic": ("traced", dict(method="antithetic")),
    "sampler-q-diagnostics": ("sampler-q", dict(method="mc", return_stderr=True,
                                                return_diagnostics=True)),
    "table-p-qmc": ("table-p", dict(method="qmc")),
}


@pytest.mark.parametrize("case", list(PUBLIC_CASES))
def test_public_path_matches_jax_pallas_backend(case):
    # MonteCarloIntegrator(device="cpu") against the JAX package's
    # interpret-mode kernel route (backend="pallas") through
    # integrate_importance_sampling: the module docstring's tolerances; the
    # diagnostics from the same weight column.
    name, kw = PUBLIC_CASES[case]
    t_names, q_names, _ = IS_CASES[name]
    kw = dict(dict(n_samples=N, seed=42), **kw)
    fns = F2
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate_importance_sampling(
        fns, [_dist(jmc, nm) for nm in t_names], [_dist(jmc, nm) for nm in q_names], **kw)
    integ = tm.MonteCarloIntegrator(device="cpu")
    targets = [_dist(tm, nm) for nm in t_names]
    proposals = [_dist(tm, nm) for nm in q_names]
    got = integ.integrate_importance_sampling(fns, targets, proposals, **kw)
    assert got.values.shape == (2,) and got.n_functions == 2
    program = _port_program(fns, targets, proposals, integ)
    _, _, size = _port_run(program, proposals, "mc", False, 1 << 15)
    size = np.maximum(size, np.abs(want.values))
    _close(got.values, want.values, MEAN_RTOL, MEAN_ATOL * size)
    if kw.get("return_stderr"):
        _close(got.stderr, want.stderr, STDERR_RTOL, STDERR_ATOL * size)
    else:
        assert got.stderr is None
    if kw.get("return_diagnostics"):
        for key in ("ess", "mean_weight", "weight_cv"):
            _close(got.diagnostics[key], want.diagnostics[key], 1e-4, 0.0)
    else:
        assert got.diagnostics is None


def test_diagnostics_column_is_the_weight():
    # The weight column is the constant 1 of d arguments, weighted: its
    # values are the product weight itself.
    unit = _unit_integrand(3)
    assert unit.n_args == 3 and unit.key == ("unit_integrand", 3)
    x = torch.linspace(-2.0, 2.0, 9)
    assert torch.equal(tm.ops.lower.to_torch(unit)(x, x, x), torch.ones(9))


def test_argument_errors_match_jax():
    # The JAX package's argument errors, word for word and in its order
    # (api/importance.py:118-157 there).
    n = [tm.Distribution.normal(0.0, 1.0), jmc.Distribution.normal(0.0, 1.0)]
    cases = [
        (TypeError, lambda pkg, d: ([lambda x, y: x], [d, d], d)),
        (TypeError, lambda pkg, d: ([lambda x, y: x], [d, d], [d])),
        (TypeError, lambda pkg, d: ([lambda x, y: x], [], [])),
    ]
    for err, make in cases:
        msgs = []
        for pkg, d, integ in ((tm, n[0], tm.MonteCarloIntegrator(device="cpu")),
                              (jmc, n[1], jmc.MonteCarloIntegrator(backend="pallas"))):
            fns, t, q = make(pkg, d)
            with pytest.raises(err) as info:
                integ.integrate_importance_sampling(fns, t, q, n_samples=1000)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    for pkg, integ in ((tm, tm.MonteCarloIntegrator(device="cpu")),
                       (jmc, jmc.MonteCarloIntegrator(backend="pallas"))):
        d = pkg.Distribution.normal(0.0, 1.0)
        with pytest.raises(ValueError, match="iid"):
            integ.integrate_importance_sampling(
                [lambda x, y: x + y], [d, d], [d, d], n_samples=1000,
                method="qmc", return_diagnostics=True)


# -- the JAX package's nd importance tests, on the port ---------------------------------


@pytest.fixture
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


def test_corner_tail_event(integ):
    # tests/test_nd.py::TestImportanceSamplingNd::test_corner_tail_event.
    n = tm.Distribution.normal(0.0, 1.0)
    prop = tm.Distribution.normal(3.5, 1.0)
    p_tail = (0.5 * math.erfc(3 / math.sqrt(2))) ** 2
    r = integ.integrate_importance_sampling(
        [lambda x, y: ((x > 3.0) & (y > 3.0)) * 1.0], [n, n], [prop, prop],
        n_samples=4_000_000, seed=6)
    assert abs(r.values[0] - p_tail) < 0.3 * p_tail


def test_p_equals_q_recovers_plain_expectation(integ):
    # test_nd.py::TestImportanceSamplingNd::test_p_equals_q_recovers_plain_expectation.
    n = tm.Distribution.normal(0.0, 1.0)
    r = integ.integrate_importance_sampling(
        [lambda x, y: x * x + y * y], [n, n], [n, n], n_samples=1_000_000, seed=2)
    assert abs(r.values[0] - 2.0) < 0.03


def test_table_pdf_dim_routes_and_integrates(integ):
    # test_nd.py::TestImportanceSamplingNd::test_table_pdf_dim_routes_and_integrates.
    b, u = tm.Distribution.beta(2.0, 2.0), tm.Distribution.uniform(0.0, 1.0)
    r = integ.integrate_importance_sampling(
        [lambda x, y: x * y], [b, u], [u, u], n_samples=2_000_000, seed=8)
    assert abs(r.values[0] - 0.25) < 0.01


def test_stderr_nd_is(integ):
    # test_nd.py::TestImportanceSamplingNd::test_stderr_nd_is.
    n = tm.Distribution.normal(0.0, 1.0)
    r = integ.integrate_importance_sampling(
        [lambda x, y: x + y], [n, n], [n, n], n_samples=1_000_000, seed=3,
        return_stderr=True)
    assert r.stderr is not None and r.stderr[0] > 0
    assert abs(r.values[0]) < 6 * r.stderr[0]


def test_is_weights_ride_the_kernel(integ):
    # test_nd.py::TestNdPallas::test_is_weights_ride_the_kernel.
    nx = tm.Distribution.normal(0.0, 1.0)
    r = integ.integrate_importance_sampling(
        [lambda x, y: x * x + y * y], [nx, nx], [nx, nx], n_samples=500_000, seed=2)
    assert abs(r.values[0] - 2.0) < 0.04


def test_nd_product_weights(integ):
    # tests/test_is_diagnostics.py::TestDiagnostics::test_nd_product_weights:
    # ESS/n = e^{-(mu1^2 + mu2^2)}.
    n = 2_000_000
    r = integ.integrate_importance_sampling(
        [lambda x, y: x + y], [tm.Distribution.normal(0.0, 1.0)] * 2,
        [tm.Distribution.normal(0.8, 1.0), tm.Distribution.normal(0.6, 1.0)],
        n_samples=n, return_diagnostics=True)
    d = r.diagnostics
    assert abs(d["mean_weight"] - 1.0) < 0.01
    assert abs(d["ess"] / n - math.exp(-1.0)) < 0.02


def test_gapped_and_heavy_proposals_stay_in_the_kernel(integ):
    # A gapped and a heavy-tailed CUSTOM proposal dimension, which the JAX
    # package folds into its XLA sweep: E[x^2 y] under N(0,1) x Exp(1)
    # targets from them (the gapped proposal covers |x| in [1, 3]: E_p
    # restricted there), within 6 error bars of the closed form in mc,
    # antithetic, and qmc with rotations.
    d = tm.Distribution
    heavy = d.student_t(5.0)
    for method, kw in (("mc", {}), ("antithetic", {}), ("qmc", dict(qmc_rotations=4))):
        r = integ.integrate_importance_sampling(
            [lambda x, y: x * x * y], [d.normal(0.0, 1.0), d.exponential(1.0)],
            [heavy, d.exponential(0.8)], n_samples=1 << 19, seed=5,
            method=method, return_stderr=True, **kw)
        assert abs(r.values[0] - 1.0) < 6 * r.stderr[0] + 2e-3
    gapped = d.mixture([d.uniform(-3.0, -1.0), d.uniform(1.0, 3.0)])
    r = integ.integrate_importance_sampling(
        [lambda x, y: (abs(x) > 1.0) * (abs(x) < 3.0) * y], [d.normal(0.0, 1.0), d.uniform(0, 1)],
        [gapped, d.uniform(0, 1)], n_samples=1 << 19, seed=5, return_stderr=True)
    want = math.erfc(1.0 / math.sqrt(2.0)) - math.erfc(3.0 / math.sqrt(2.0))
    assert abs(r.values[0] - want * 0.5) < 6 * r.stderr[0] + 1e-3
