"""The port's CUSTOM tables and table weights in the 1-D integrate kernel's
plain version against the JAX package's interpret-mode kernel.

``build_integrate_fn_pallas(..., DistKind.CUSTOM, plan, interpret=True,
block_rows=256)`` draws the samples that the port's plain version draws,
tile for tile (the port keeps 256-row tiles), on the same host tables:

* the row-stratified inverse CDF (``prep_inv_table_stratified``) and the
  gap-respecting stratified tables, in mc, antithetic and qmc: samples
  within 4 ulp (the same float32 lookup ``ts + frac * dts``);
* means within 1e-5 relative plus 1e-5 absolute times the column's size
  (its mean |value| over the stratified knots, or |mean| if larger): float32
  summation order, which weighs more here than for the analytic families,
  since a tile's rows run through the strata in order, so the JAX
  kernel's sums (an accumulator per position, summed in row order) pass
  through partial sums of the column's whole |value| mass (measured on a
  symmetric gapped mixture: the JAX kernel's E[x] 1.07e-5 from the exact
  float64 mean of its own samples, the port's 3e-8);
* error bars within 1e-3 relative (the same squares up to order, and a
  pilot over the stratified knots), as in
  ``tests/test_torch_integrate_variants.py``; 1e-9 absolute on an error
  bar that exact antithetic cancellation leaves at float32 rounding;
* importance weights from pdf tables and from the proposal's own sampler
  are held in ``tests/test_torch_custom_is.py``.

Heavy-tailed tables take the knot-exact inverse in the port (the JAX
package's XLA searchsorted sampler keyed on ``jax.random`` cannot be
matched bit for bit): the inverse is held to numpy's interpolation over
the knots, and its moments to the reference's tolerances in
``tests/test_torch_custom_api.py``.  Sizes stay at 2**17 samples.  The
CUDA kernel is held against the plain version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.ops import qmc as jqmc
from tpu_montecarlo.ops.integrate_pallas import (
    CounterRng as JCounterRng,
    _sample_subblocks,
    _sample_subblocks_antithetic,
    _sample_subblocks_qmc,
    build_integrate_fn_pallas,
    prep_inv_table_stratified as j_prep,
)
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.device import sampling_tables
from tpu_montecarlo_torch.ops import integrate_kernel as ik
from tpu_montecarlo_torch.ops import qmc
from tpu_montecarlo_torch.ops.integrate_kernel import (
    IntegrateConfig,
    IntegrateProgram,
    KnotTables,
    finish_stderr,
    integrate_cuda,
    knot_interp,
    pilot_values,
    plan_grid,
)
from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

from test_torch_integrate_variants import (
    MEAN_ATOL,
    MEAN_RTOL,
    STDERR_ATOL,
    STDERR_RTOL,
)

THREADS = 1024
CPU_CHUNK = 1 << 22  # the JAX package's max_chunk_elems off the TPU
N_SMALL = 1 << 17
FNS = [lambda x: x, lambda x: x * x, lambda x: np.exp(-x * x), lambda x: x > 0.5]


def _gapped_table(pkg):
    x = np.linspace(0.0, 1.0, 2048)
    p = np.where((x > 0.4) & (x < 0.6), 0.0, 1.0)
    return pkg.Distribution.from_pdf_table(x, p)


# name: (factory, gapped)
DISTS = {
    "beta-2-5": (lambda pkg: pkg.Distribution.beta(2.0, 5.0), False),
    "mixture": (lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(-3.0, 1.0), pkg.Distribution.normal(3.0, 0.5)],
        weights=(0.3, 0.7)), False),
    "gapped-mixture": (lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.uniform(-3.0, -1.0), pkg.Distribution.uniform(1.0, 3.0)]),
        True),
    "gapped-table": (_gapped_table, True),
}
MODES = {
    "mc": ("mc", False),
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
}


def _jax_tables(jd):
    """The JAX kernel's (x_table, cdf_table) arguments: the inverse table,
    or the gap-respecting (32, 128) tables of a gapped spec."""
    spec = j_dist_spec_of(jd)
    if spec.exact_inverse:
        ts, dts = jdevice._device_gapped_tables(jd, spec, stratified=True,
                                                segments=32)
        return spec, np.asarray(ts), np.asarray(dts)
    return spec, spec.x_table, spec.cdf_table


def jax_run(fns, jd, n, method, with_stderr, seed, is_weight=None,
            weight_tables=()):
    """The interpret-mode JAX kernel at 256-row blocks on a CUSTOM
    sampling distribution: (means[, stderrs]) and its sample count."""
    spec, x_table, cdf_table = _jax_tables(jd)
    plan = j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK)
    run = build_integrate_fn_pallas(
        fns, JKind.CUSTOM, plan, interpret=True, method=method,
        with_stderr=with_stderr, block_rows=256, is_weight=is_weight,
        gapped_tables=spec.exact_inverse)
    out = run(np.asarray(seed, np.uint32), spec.params, x_table, cdf_table,
              *weight_tables)
    if with_stderr:
        return (np.asarray(out[0]), np.asarray(out[1])), run.actual_samples
    return np.asarray(out), run.actual_samples


def _size(program, td):
    """Each column's mean |value| over the pilot grid (the stratified
    knots of a CUSTOM ``td``)."""
    spec = dist_spec_of(td)
    tables = (sampling_tables(td, spec, "cpu", with_pdf=program.sampler)
              if spec.kind == DistKind.CUSTOM else None)
    size = pilot_values(lambda *a: [v.abs() for v in program.torch_values(*a)],
                        spec.kind, torch.tensor(spec.params), tables)
    return size.numpy().astype(np.float64)


def port_run(program, td, n, method, with_stderr, seed):
    """The port's plain version on the same plan and tables."""
    spec = dist_spec_of(td)
    tables = sampling_tables(td, spec, "cpu", with_pdf=program.sampler)
    cfg = IntegrateConfig(method, with_stderr)
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    p = torch.tensor(spec.params)
    if not with_stderr:
        sums = integrate_cuda(program, spec.kind, p, seed, grid, cfg,
                              tables=tables)
        return (sums / float(np.float32(grid.actual_samples))).numpy(), grid
    pilot = pilot_values(program.torch_values, spec.kind, p, tables)
    sums, sqs = integrate_cuda(program, spec.kind, p, seed, grid, cfg, pilot,
                               tables)
    mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return (mean.numpy(), se.numpy()), grid


def assert_runs_agree(got, want, with_stderr, size):
    """Means within MEAN_ATOL of each column's size (``size``, or the
    mean's |value| if larger), error bars as the module docstring says."""
    size = np.maximum(size, np.abs(want[0] if with_stderr else want))
    if with_stderr:
        _close(got[0], want[0], atol=MEAN_ATOL * size)
        _close(got[1], want[1], rtol=STDERR_RTOL, atol=STDERR_ATOL)
        assert np.all(got[1] > 0)
    else:
        assert got.dtype == np.float32
        _close(got, want, atol=MEAN_ATOL * size)


def _close(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol
    assert np.all(np.abs(got - want) <= tol), (got, want, tol)


def _ulps(got, want, n=4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = n * np.spacing(np.maximum(np.abs(got), np.abs(want)))
    err = np.abs(got.astype(np.float64) - want)
    worst = np.unravel_index(np.argmax(err - tol), err.shape)
    assert np.all(err <= tol), (worst, got[worst], want[worst])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dist", list(DISTS))
def test_plain_version_matches_jax_interpret_kernel(dist, mode):
    method, with_stderr = MODES[mode]
    make, gapped = DISTS[dist]
    jd, td = make(jmc), make(tm)
    assert j_dist_spec_of(jd).exact_inverse == gapped
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    jfns = tuple(j_trace(f) for f in FNS)
    # A second seed word, past 2**31, for plain mc.
    for seed in (42, (1 << 31) + 3) if mode == "mc" else (42,):
        want, actual = jax_run(jfns, jd, N_SMALL, method, with_stderr, seed)
        got, grid = port_run(program, td, N_SMALL, method, with_stderr, seed)
        assert grid.actual_samples == actual
        assert_runs_agree(got, want, with_stderr, _size(program, td))


def _tile_tables(dist, with_pdf=False):
    """Both packages' tables for one tile: the JAX (256, 128) rows and
    the port's (32, 128) StrataTables."""
    make, gapped = DISTS[dist]
    jd, td = make(jmc), make(tm)
    spec, x_table, cdf_table = _jax_tables(jd)
    if gapped:
        jtabs = tuple(jnp.repeat(jnp.asarray(t), 8, axis=0)
                      for t in (x_table, cdf_table))
    else:
        jtabs = tuple(j_prep(x_table, 256, with_pdf=with_pdf))
    return jtabs, sampling_tables(td, dist_spec_of(td), "cpu", with_pdf=with_pdf)


def _pairs(samples, with_pdf):
    """Sub-blocks as (x, q) pairs, q None without a sampler density."""
    return [tuple(s) if with_pdf else (s, None) for s in samples]


# A gapped spec has no sampler density (the JAX package raises for it).
TILE_CASES = [(d, w) for d in DISTS for w in (False, True)
              if not (w and DISTS[d][1])]


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
@pytest.mark.parametrize("dist,with_pdf", TILE_CASES,
                         ids=[f"{d}-{'x-and-q' if w else 'x'}" for d, w in TILE_CASES])
def test_tile_samples_match_jax(dist, with_pdf, method):
    jtabs, tabs = _tile_tables(dist, with_pdf)
    seed, pid, blk = (1 << 31) + 9, 3, 5
    zero = jnp.float32(0.0)
    if method == "qmc":
        b = 7
        shift = jqmc.derive_shift(jnp.asarray(seed, jnp.uint32), 1)
        want = _sample_subblocks_qmc(JKind.CUSTOM, zero, zero, jnp.int32(b),
                                     shift, jtabs, with_pdf=with_pdf)
        got = ik.sample_subblocks_qmc(
            DistKind.CUSTOM, 0.0, 0.0, torch.tensor([b]),
            qmc.derive_shift(seed, 1).reshape(1), tables=tabs)
        got = [tuple(t[0] for t in g) if with_pdf else g[0] for g in got]
    else:
        rng = JCounterRng()
        rng.seed(jnp.asarray(seed, jnp.uint32).astype(jnp.int32), pid)
        jdraw = (_sample_subblocks_antithetic if method == "antithetic"
                 else _sample_subblocks)
        tdraw = (ik.sample_subblocks_antithetic if method == "antithetic"
                 else ik.sample_subblocks)
        want = jdraw(JKind.CUSTOM, zero, zero, rng, blk, jtabs,
                     with_pdf=with_pdf)
        got = tdraw(DistKind.CUSTOM, 0.0, 0.0, ik.CounterRng(seed, pid), blk,
                    tables=tabs)
    assert len(got) == len(want) == (2 if method == "antithetic" else 1)
    for (gx, gq), (wx, wq) in zip(_pairs(got, with_pdf), _pairs(want, with_pdf)):
        _ulps(gx.numpy(), wx)
        if with_pdf:
            _ulps(gq.numpy(), wq)


def test_gapped_tiles_never_sample_inside_the_gap():
    # tests/test_gapped_pallas.py's gap (0.4, 0.6): no draw of a tile, in
    # any method, lands a knot spacing inside it.
    _, tabs = _tile_tables("gapped-table")
    for method in ("mc", "antithetic", "qmc"):
        grid = plan_grid(1 << 20, method)
        xs = ik.tile_subblocks(IntegrateConfig(method),
                               DistKind.CUSTOM, 0.0, 0.0, 42, grid,
                               torch.arange(8), tabs)
        x = torch.cat([s.reshape(-1) for s in xs])
        assert not torch.any((x > 0.4 + 1e-3) & (x < 0.6 - 1e-3))
        assert torch.any(x < 0.4) and torch.any(x > 0.6)


def test_pilot_is_the_stratified_knots():
    # The JAX kernel's CUSTOM pilot block is its (256, 128) ts table.
    jd, td = jmc.Distribution.beta(2.0, 5.0), tm.Distribution.beta(2.0, 5.0)
    ts = np.asarray(j_prep(j_dist_spec_of(jd).x_table, 256)[0])
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    tabs = sampling_tables(td, dist_spec_of(td), "cpu")
    got = pilot_values(program.torch_values, DistKind.CUSTOM,
                       torch.zeros(2), tabs).numpy()
    want = [np.mean(np.asarray(j_trace(f)(ts), np.float32)) for f in FNS]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_knot_inverse_is_the_piecewise_linear_inverse():
    # The knot-exact route against numpy's interpolation over the CDF
    # knots, in float64: within a few float32 ulps of x (the port rounds
    # the fraction and the step once each), over uniforms on the 2**-24
    # grid, both tails and every knot itself.
    td = tm.Distribution.student_t(5.0)
    spec = dist_spec_of(td)
    assert spec.heavy_tail and spec.exact_inverse
    tabs = sampling_tables(td, spec, "cpu")
    assert isinstance(tabs, KnotTables)
    rng = np.random.default_rng(5)
    u = np.concatenate([
        rng.integers(0, 1 << 24, 50_000) * 2.0**-24,
        np.asarray(spec.cdf_table, np.float64), [0.0, 1.0 - 2.0**-24, 1.0],
    ]).astype(np.float32)
    got = knot_interp(torch.from_numpy(u), tabs.cdf, tabs.x).numpy()
    cdf = spec.cdf_table.astype(np.float64)
    xk = spec.x_table.astype(np.float64)
    want = np.interp(u.astype(np.float64), cdf, xk)
    # Within 8 ulp of the larger end of the knot interval.
    i = np.clip(np.searchsorted(cdf, u, side="right") - 1, 0, len(cdf) - 2)
    size = np.maximum(np.abs(xk[i]), np.abs(xk[i + 1])).astype(np.float32)
    assert np.all(np.abs(got - want) <= 8 * np.spacing(size))


# -- the kernel's lookups, built for the host --------------------------------

_LOOKUP_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
static inline float erfinvf(float) { return 0.0f; }  // not called here
#include "integrate_draw.cuh"
using namespace tmc;

// strata_x at each top-24 word and tile position, at w (mirror 0) or at
// 1 - w (mirror 1), as integrate.cu's draw and draw_pair call it.
extern "C" void strata(const float* ts, const float* dts, const float* qs,
                       const uint32_t* top, const uint32_t* pos, int n,
                       int mirror, float* x, float* q) {
  Tables tb{};
  tb.ts = ts;
  tb.dts = dts;
  tb.qs = qs;
  for (int i = 0; i < n; ++i) {
    const float pw = mirror ? (1.0f - halfopen_top(top[i])) * 127.0f
                            : float(top[i]) * kW127;
    x[i] = qs ? strata_x<true>(tb, pos[i], pw, q + i)
              : strata_x<false>(tb, pos[i], pw, nullptr);
  }
}

extern "C" void knots(const float* keys, const float* vals, int m,
                      const float* u, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = knot_interp(u[i], keys, vals, m);
}

extern "C" void weight_table(const float* keys, const float* vals,
                             const float* dx, float x0, float step,
                             float x_max, int n_tab, int uniform,
                             const float* x, int n, float* out) {
  const WeightTab t{keys, vals, dx, x0, step, x_max, n_tab};
  for (int i = 0; i < n; ++i) {
    out[i] = uniform ? uniform_table_value(x[i], t) : knot_table_value(x[i], t);
  }
}
"""


@pytest.fixture(scope="module")
def lookups(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    csrc = Path(ik.__file__).resolve().parents[1] / "csrc"
    d = tmp_path_factory.mktemp("lookups")
    (d / "shim.cpp").write_text(_LOOKUP_SHIM)
    so = d / "liblookups.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(csrc), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.strata.argtypes = [ptr] * 5 + [i32, i32, ptr, ptr]
    lib.knots.argtypes = [ptr, ptr, i32, ptr, i32, ptr]
    lib.weight_table.argtypes = [ptr] * 3 + [f32] * 3 + [i32, i32, ptr, i32, ptr]
    for fn in (lib.strata, lib.knots, lib.weight_table):
        fn.restype = None
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data


@pytest.mark.parametrize("dist,with_pdf", TILE_CASES,
                         ids=[f"{d}-{'x-and-q' if w else 'x'}" for d, w in TILE_CASES])
def test_kernel_strata_lookup_is_the_plain_one(lookups, dist, with_pdf):
    # integrate_draw.cuh's strata_x, built for the host without fused
    # multiply-adds as the kernel is built (--fmad=false), bit for bit
    # against the plain draw over a whole tile: the stratum of position
    # pos is pos >> 10 (its row / 8), at w and at its mirror 1 - w.
    _, tabs = _tile_tables(dist, with_pdf)
    ts, dts = (np.ascontiguousarray(t.numpy()) for t in (tabs.ts, tabs.dts))
    qs = None if tabs.qs is None else np.ascontiguousarray(tabs.qs.numpy())
    rng = ik.CounterRng(42, 3)
    m = (rng.bits((256, 128), 5, 0) >> 8).numpy().astype(np.uint32)
    top = np.ascontiguousarray((m << 8).reshape(-1))
    pos = np.arange(top.size, dtype=np.uint32)
    w = torch.from_numpy(m.astype(np.float32) * np.float32(2.0**-24))
    for mirror in (0, 1):
        x = np.empty(top.size, np.float32)
        q = np.empty(top.size, np.float32)
        lookups.strata(_ptr(ts), _ptr(dts), _ptr(qs), _ptr(top), _ptr(pos),
                       top.size, mirror, _ptr(x), _ptr(q))
        want = ik._custom_draw(tabs, 1.0 - w if mirror else w, 256)
        wx, wq = want if with_pdf else (want, None)
        np.testing.assert_array_equal(x, wx.reshape(-1).numpy())
        if with_pdf:
            np.testing.assert_array_equal(q, wq.reshape(-1).numpy())


def test_kernel_knot_and_weight_lookups_are_the_plain_ones(lookups):
    # knot_interp (the knot-exact inverse and the irregular-grid weight)
    # and the uniform-grid weight lookup, bit for bit against the plain
    # versions, over uniforms on the 2**-24 grid with both ends, and x
    # across each table's edges.
    rng = np.random.default_rng(23)
    spec = dist_spec_of(tm.Distribution.student_t(5.0))
    cdf, xk = spec.cdf_table, spec.x_table
    u = np.concatenate([rng.integers(0, 1 << 24, 65536) * 2.0**-24, cdf,
                        [0.0, 1.0]]).astype(np.float32)
    out = np.empty_like(u)
    lookups.knots(_ptr(cdf), _ptr(xk), len(cdf), _ptr(u), u.size, _ptr(out))
    want = knot_interp(torch.from_numpy(u), torch.from_numpy(cdf),
                       torch.from_numpy(xk)).numpy()
    np.testing.assert_array_equal(out, want)
    x = np.concatenate([rng.uniform(-2.0, 4.5, 65536), [-1.25, 3.5]]).astype(np.float32)
    for n in (200, 1000):
        xs = np.sort(rng.uniform(-1.25, 3.5, n)).astype(np.float32)
        xs[0], xs[-1] = -1.25, 3.5
        v = rng.uniform(0.0, 3.0, n).astype(np.float32)
        for table in (ik.UniformWeightTable(np.linspace(-1.25, 3.5, n), v),
                      ik.KnotWeightTable(xs, v)):
            uniform = isinstance(table, ik.UniformWeightTable)
            keys, vals = (None, table.vals) if uniform else (table.xs, table.vals)
            dx = table.dx if uniform else None
            x0, step, x_max = (float(g) for g in table.grid)
            got = np.empty_like(x)
            lookups.weight_table(_ptr(keys), _ptr(vals), _ptr(dx), x0, step,
                                 x_max, len(vals), int(uniform), _ptr(x),
                                 x.size, _ptr(got))
            np.testing.assert_array_equal(got, table(torch.from_numpy(x)).numpy())
