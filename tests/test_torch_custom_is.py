"""The port's importance weights from tables against the JAX package's
interpret-mode kernel: the non-traced route of
``tpu_montecarlo/api/importance.py`` (``_get_is_program``, :255-430).

A density that does not trace becomes a uniform-grid pdf table
(``"table"``: resampled where the grid is irregular, then downsampled),
and an irregular-grid CUSTOM proposal that no uniform grid represents
takes q from its own sampler (``"sampler"``: the stratified tables'
``qs``).  The port routes each pair as the JAX package does
(``_is_weight`` against the JAX package's own routing steps), and its
plain version weighs each sample as ``build_integrate_fn_pallas(...,
is_weight=...)`` does in interpret mode, ``f(x) * where(q > 0, p / q,
0)``, on the same draws: means and error bars to the tolerances of
``tests/test_torch_custom.py`` (sizes at 2**17 samples).  The
uniform-grid lookup itself is held value for value.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.ops.integrate_pallas import build_integrate_fn_pallas
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.device import sampling_tables
from tpu_montecarlo_torch.ops.integrate_kernel import (
    SAMPLER,
    IntegrateConfig,
    IntegrateProgram,
    StrataTables,
    UniformWeightTable,
    finish_stderr,
    integrate_cuda,
    pilot_values,
    plan_grid,
)
from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

from test_torch_custom import (
    CPU_CHUNK,
    MODES,
    N_SMALL,
    THREADS,
    _size,
    assert_runs_agree,
    jax_run,
    port_run,
)


def _untraceable(x):
    # An int() cast on a data value does not trace.
    return 0.5 if int(abs(x)) < 1 else 0.0


def _irregular_density(pkg):
    """A (self-normalised) from_pdf_table density with a spike 1e-5 wide
    on knots that resolve it: no uniform grid of at most 65,536 knots
    meets the resampling bound, so q comes from the sampler."""
    d = np.geomspace(1e-5, 1e-3, 60)
    x = np.unique(np.concatenate([np.linspace(0.0, 1.0, 300), 0.5 - d, 0.5 + d, [0.5]]))
    return pkg.Distribution.from_pdf_table(
        x, 1.0 + 50.0 * np.exp(-(((x - 0.5) / 1e-5) ** 2)))


# name: (target factory, proposal factory, JAX weight modes)
IS_CASES = {
    "table-p": (lambda pkg: pkg.Distribution(pkg.DistributionType.CUSTOM, {}, _untraceable),
                lambda pkg: pkg.Distribution.uniform(-2.0, 2.0), ("table", "traced")),
    "table-q": (lambda pkg: pkg.Distribution.uniform(-1.0, 1.0),
                lambda pkg: pkg.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0)),
                ("traced", "table")),
    "table-p-table-q": (lambda pkg: pkg.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0)),
                        lambda pkg: pkg.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0)),
                        ("table", "table")),
    "sampler-q": (lambda pkg: pkg.Distribution.normal(0.7, 0.2), _irregular_density,
                  ("traced", "sampler")),
    "table-p-sampler-q": (lambda pkg: pkg.Distribution.from_pdf(_untraceable, support=(-1.0, 1.0)),
                          _irregular_density, ("table", "sampler")),
}


def _jax_is_inputs(target, proposal):
    """The JAX package's kernel route for this pair
    (``_get_is_program``): is_weight and the weight tables' arguments."""
    integ = jmc.MonteCarloIntegrator()
    p_mode, q_mode = integ._pdf_mode(target), integ._pdf_mode(proposal)
    p_k = jdevice._uniform_table_mode(target, p_mode)
    q_k = jdevice._uniform_table_mode(proposal, q_mode, "proposal")
    if q_k is None:
        x_t = np.asarray(q_mode[1], np.float64)
        v_t = np.asarray(q_mode[2], np.float64)
        assert abs(np.trapezoid(v_t, x_t) - 1.0) <= 1e-3
        q_k = ("sampler",)
    modes, weight, tables = [], [], []
    for dist, mode, role in ((target, p_k, "target"), (proposal, q_k, "proposal")):
        modes.append(mode[0])
        weight.append(mode[1] if mode[0] == "traced" else mode[0])
        if mode[0] == "table":
            tables += [np.asarray(t) for t in jdevice._device_mode_tables(dist, mode, role)]
    return tuple(modes), tuple(weight), tables


# Every mode for a table on both sides and for the sampler's q; the
# other pairs in mc with error bars and qmc.
IS_RUNS = [(c, m) for c in IS_CASES for m in MODES
           if c in ("table-p-table-q", "sampler-q") or m in ("mc-stderr", "qmc")]


@pytest.mark.parametrize("case,mode", IS_RUNS, ids=[f"{c}-{m}" for c, m in IS_RUNS])
def test_table_weights_match_jax_interpret_kernel(case, mode):
    method, with_stderr = MODES[mode]
    target, proposal, modes = IS_CASES[case]
    jt_, jq = target(jmc), proposal(jmc)
    got_modes, j_weight, wtables = _jax_is_inputs(jt_, jq)
    assert got_modes == modes
    fns = [lambda x: x, lambda x: x * x, lambda x: x > 0.5]
    integ = tm.MonteCarloIntegrator(device="cpu")
    tt_, tq = target(tm), proposal(tm)
    weight = integ._is_weight(tt_, tq)
    kinds = {"traced": tm.tracing.TracedFunction, "table": UniformWeightTable}
    for w, m in zip(weight, modes):
        assert w is SAMPLER if m == "sampler" else isinstance(w, kinds[m])
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in fns), weight)
    jfns = tuple(j_trace(f) for f in fns)
    want, actual = _jax_weighted_run(jfns, jq, method, with_stderr, j_weight,
                                     wtables)
    got, grid = _port_weighted_run(program, tq, method, with_stderr)
    assert grid.actual_samples == actual
    assert_runs_agree(got, want, with_stderr, _size(program, tq))


def _jax_weighted_run(jfns, jq, method, with_stderr, j_weight, wtables):
    spec = j_dist_spec_of(jq)
    if spec.kind == JKind.CUSTOM:
        return jax_run(jfns, jq, N_SMALL, method, with_stderr, 42,
                       is_weight=j_weight, weight_tables=wtables)
    plan = j_plan(N_SMALL, THREADS, max_chunk_elems=CPU_CHUNK)
    run = build_integrate_fn_pallas(jfns, spec.kind, plan, interpret=True,
                                    method=method, with_stderr=with_stderr,
                                    block_rows=256, is_weight=j_weight)
    dummy = np.zeros(1, np.float32)
    out = run(np.uint32(42), spec.params, dummy, dummy, *wtables)
    if with_stderr:
        return (np.asarray(out[0]), np.asarray(out[1])), run.actual_samples
    return np.asarray(out), run.actual_samples


def _port_weighted_run(program, tq, method, with_stderr):
    spec = dist_spec_of(tq)
    if spec.kind == DistKind.CUSTOM:
        return port_run(program, tq, N_SMALL, method, with_stderr, 42)
    cfg = IntegrateConfig(method, with_stderr)
    grid = plan_grid(make_integrate_plan(N_SMALL, THREADS).actual_samples, method)
    p = torch.tensor(spec.params)
    if not with_stderr:
        sums = integrate_cuda(program, spec.kind, p, 42, grid, cfg)
        return (sums / float(np.float32(grid.actual_samples))).numpy(), grid
    pilot = pilot_values(program.torch_values, spec.kind, p)
    sums, sqs = integrate_cuda(program, spec.kind, p, 42, grid, cfg, pilot)
    mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return (mean.numpy(), se.numpy()), grid


def test_weight_lookup_matches_jax():
    # The uniform-grid lookup value for value, across the grid's edges,
    # its knots and the padding past x_max.
    from tpu_montecarlo.ops.integrate_pallas import (
        pad_uniform_table, uniform_table_value)

    rng = np.random.default_rng(17)
    for n in (200, 1000):
        xs = np.linspace(-1.25, 3.5, n).astype(np.float32)
        v = rng.uniform(0.0, 3.0, n).astype(np.float32)
        x = np.concatenate([rng.uniform(-2.0, 4.5, 1024), xs,
                            [np.nextafter(xs[-1], np.float32(9))]]).astype(np.float32)
        rows = -(-len(x) // 128)
        xb = np.pad(x, (0, rows * 128 - len(x))).reshape(rows, 128)
        tab = pad_uniform_table(jnp.asarray(xs), jnp.asarray(v), 0.0)
        want = np.asarray(uniform_table_value(jnp.asarray(xb), tab, rows, 0.0,
                                              max_unroll_segments=64))
        got = UniformWeightTable(xs, v)(torch.from_numpy(xb)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampler_mode_checks():
    # A sampler-mode weight needs strata tables with the sampler's density,
    # and only it takes them.
    td = tm.Distribution.beta(2.0, 5.0)
    spec = dist_spec_of(td)
    fns = (tm.trace_function(lambda x: x),)
    sampler = IntegrateProgram(fns, (tm.trace_function(lambda x: 2.0 * x), SAMPLER))
    plain = IntegrateProgram(fns)
    p = torch.zeros(2)
    grid = plan_grid(1 << 15)
    cfg = IntegrateConfig("mc")
    with_q = sampling_tables(td, spec, "cpu", with_pdf=True)
    without = sampling_tables(td, spec, "cpu")
    assert isinstance(with_q, StrataTables) and with_q.qs is not None
    for prog, tabs in ((sampler, without), (plain, with_q)):
        with pytest.raises(ValueError, match="sampler"):
            integrate_cuda(prog, DistKind.CUSTOM, p, 1, grid, cfg, tables=tabs)
    with pytest.raises(ValueError, match="non-gapped"):
        gapped = tm.Distribution.from_pdf_table(
            np.linspace(0.0, 1.0, 2048),
            np.where(np.abs(np.linspace(0.0, 1.0, 2048) - 0.5) < 0.1, 0.0, 1.0))
        sampling_tables(gapped, dist_spec_of(gapped), "cpu", with_pdf=True)
    with pytest.raises(ValueError, match="CUSTOM runs"):
        integrate_cuda(plain, DistKind.CUSTOM, p, 1, grid, cfg)
