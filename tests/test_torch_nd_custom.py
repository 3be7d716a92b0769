"""The port's nd ``integrate`` over CUSTOM dimensions against the JAX
package.

The JAX kernel ``build_integrate_nd_pallas`` draws its first CUSTOM
dimension through the row-stratified tables under ``mc`` and
``antithetic`` and every other one (every one under ``qmc``) through the
full inverse (``integrate_nd_pallas.py:78-90``, ``:422-491``).  The
port's plain version draws the same way from the same uniforms, wherever
the JAX kernel keeps 256-row blocks (every shape here asserts that it
does), so:

* the host tables (``nd_custom_dim``) are the JAX package's, bit for bit:
  the stratified tables with their sampler density, the flat inverse and
  its forward differences;
* the draws are bit-equal: each route at ``w`` and at its mirror
  ``1 - w``, the sampler's density on both routes, against the JAX
  kernel's stratified lookups and its full-inverse formula; the kernel's
  own lookups (``csrc/integrate_draw.cuh``, built with the host's g++
  without fused multiply-adds, as nvcc builds them with ``--fmad=false``)
  are bit-equal to the plain ones;
* means within 1e-6 + 1e-6 |mean| of the interpret-mode kernel's (the
  float32 summation order over up to 2**18 values of order 1), error
  bars within rel 1e-4 (the same squares summed in another order, and a
  pilot whose mean over 1,024 points differs in its last bits).

The JAX package's own nd tests over table dimensions
(``tests/test_nd.py``) run on the port as they run there, their
tolerances unchanged.  A gap-respecting dimension, which the JAX package
sends to its XLA sweep, stays in the port's kernel and is held to that
test's 0.25 within 0.01.  The CUDA kernel is held against the plain
version in ``test_torch_cuda.py``.
"""

import ctypes
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops.integrate_nd_pallas import build_integrate_nd_pallas
from tpu_montecarlo.ops.integrate_pallas import (
    _stratified_sample_from_w,
    _stratified_sample_pdf_from_w,
    prep_inv_table as j_prep_inv_table,
    prep_inv_table_stratified as j_prep_inv_table_stratified,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.device import nd_custom_dim, nd_tables
from tpu_montecarlo_torch.ops import integrate_nd_kernel as nk
from tpu_montecarlo_torch.ops.integrate_kernel import plan_grid
from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

CSRC = Path(nk.__file__).resolve().parents[1] / "csrc"
CPU_CHUNK = 1 << 22
THREADS = 1024
MEAN_ATOL = MEAN_RTOL = 1e-6
STDERR_RTOL = 1e-4


def _tri(x):
    return x if 0 <= x <= 1 else (2 - x if 1 < x <= 2 else 0.0)


def _gapped_pdf(pkg):
    x = np.linspace(0.0, 1.0, 2048)
    return pkg.Distribution.from_pdf_table(x, np.where((x > 0.4) & (x < 0.6),
                                                       0.0, 1.0))


def _dist(pkg, name):
    d = pkg.Distribution
    return {
        "beta25": lambda: d.beta(2.0, 5.0),
        "beta33": lambda: d.beta(3.0, 3.0),
        "tri": lambda: d.from_pdf(_tri, support=(0.0, 2.0)),
        "u01": lambda: d.uniform(0.0, 1.0),
        "n01": lambda: d.normal(0.0, 1.0),
        "exp2": lambda: d.exponential(2.0),
        "gapped": lambda: _gapped_pdf(pkg),
        "t5": lambda: d.student_t(5.0),
    }[name]()


F2 = [lambda x, y: x * y, lambda x, y: x + y * y]
F3 = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y - z]

# name: (functions, dimensions, method, with_stderr, samples)
REF_CASES = {
    "beta-u-mc": (F2, ("beta25", "u01"), "mc", False, 1 << 17),
    "beta-u-antithetic": (F2, ("beta25", "u01"), "antithetic", False, 1 << 17),
    "beta-u-mc-stderr": (F2, ("beta25", "u01"), "mc", True, 1 << 17),
    "beta-u-antithetic-stderr": (F2, ("beta25", "u01"), "antithetic", True, 1 << 17),
    "beta-u-qmc": (F2, ("beta25", "u01"), "qmc", False, 1 << 17),
    "u-beta-exp-mc": (F3, ("u01", "beta25", "exp2"), "mc", False, 1 << 16),
    "two-custom-mc": (F2, ("beta25", "beta33"), "mc", False, 1 << 17),
    "two-custom-antithetic-stderr": (F2, ("beta25", "beta33"), "antithetic", True, 1 << 16),
    "two-custom-qmc": (F2, ("beta25", "beta33"), "qmc", False, 1 << 16),
    "tri-n-custom-mc-stderr": (F3, ("tri", "n01", "beta33"), "mc", True, 1 << 16),
}


def _close(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _jax_run(fns, names, method, with_stderr, n, seed):
    """The interpret-mode JAX kernel's result and its plan."""
    dists = [_dist(jmc, nm) for nm in names]
    specs = [j_dist_spec_of(dd) for dd in dists]
    kinds = tuple(s.kind for s in specs)
    d = len(kinds)
    sizes = tuple(s.x_table.shape[0] if s.x_table is not None else 0 for s in specs)
    run = build_integrate_nd_pallas(
        tuple(j_trace(f, d) for f in fns), kinds,
        j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK), interpret=True,
        method=method, with_stderr=with_stderr, table_sizes=sizes,
    )
    assert run.block_rows == 256
    x_tables = tuple(s.x_table if s.x_table is not None else jnp.zeros(1, jnp.float32)
                     for s in specs)
    out = run(np.int32(seed), np.stack([s.params for s in specs]), x_tables)
    return out, run.actual_samples


def _port_run(fns, names, method, with_stderr, n, seed):
    """The port's plain version through its parts, as the public path
    calls them."""
    dists = [_dist(tm, nm) for nm in names]
    kinds = tuple(dist_spec_of(dd).kind for dd in dists)
    d = len(kinds)
    program = nk.IntegrateNdProgram(tuple(tm.trace_function(f, d) for f in fns), kinds)
    cfg = nk.NdConfig(kinds, method, with_stderr)
    params = torch.tensor(np.stack([dist_spec_of(dd).params for dd in dists]))
    tables = nd_tables(dists, cfg, "cpu")
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    if not with_stderr:
        sums = nk.integrate_nd_reference(program.torch_fns, cfg, params, seed,
                                         grid, tables=tables)
        return (sums / float(np.float32(grid.actual_samples))).numpy(), grid
    pilot = nk.pilot_row(program.torch_fns, kinds, params, tables)
    sums, sqs = nk.integrate_nd_reference(program.torch_fns, cfg, params, seed,
                                          grid, pilot, tables)
    mean, se = nk.finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return (mean.numpy(), se.numpy()), grid


@pytest.mark.parametrize("case", list(REF_CASES))
def test_plain_version_matches_jax_interpret_kernel(case):
    # Means within 1e-6 + 1e-6 |mean|, error bars within rel 1e-4 (module
    # docstring), at shapes where the JAX plan keeps 256 rows.
    fns, names, method, with_stderr, n = REF_CASES[case]
    for seed in (42, -3):
        want, actual = _jax_run(fns, names, method, with_stderr, n, seed)
        got, grid = _port_run(fns, names, method, with_stderr, n, seed)
        assert grid.actual_samples == actual
        if with_stderr:
            _close(got[0], want[0])
            _close(got[1], want[1], rtol=STDERR_RTOL, atol=0.0)
            assert np.all(got[1] > 0)
        else:
            assert got.shape == (len(fns),) and got.dtype == np.float32
            _close(got, want)


# -- the host tables and the draws, bit for bit ----------------------------------


@pytest.mark.parametrize("name", ["beta25", "beta33", "tri"])
def test_host_tables_match_jax(name):
    # The stratified tables (tiled by the JAX package to one row per block
    # row, kept (32, 128) here), their sampler density, and the flat
    # inverse with its forward differences: equal bit for bit.
    spec = dist_spec_of(_dist(tm, name))
    j_spec = j_dist_spec_of(_dist(jmc, name))
    np.testing.assert_array_equal(spec.x_table, j_spec.x_table)
    for sampler in (False, True):
        strat = nd_custom_dim(_dist(tm, name), spec, "cpu", True, sampler)
        want = j_prep_inv_table_stratified(jnp.asarray(j_spec.x_table), 256,
                                           with_pdf=sampler)
        got = [strat.draw.ts, strat.draw.dts] + ([strat.draw.qs] if sampler else [])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.repeat_interleave(8, dim=0).numpy(),
                                          np.asarray(w))
        flat = nd_custom_dim(_dist(tm, name), spec, "cpu", False, sampler)
        assert flat.draw is flat.full and flat.route == "flat"
        for g, w in zip((flat.draw.t, flat.draw.dt), j_prep_inv_table(j_spec.x_table)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))
        assert flat.draw.inv_du == np.float32(1.0 / (spec.x_table.shape[0] - 1))


def _tile_w(seed=42, j=1):
    grid = plan_grid(1 << 20)
    return nk.nd_uniforms("mc", seed, grid, torch.tensor([7]), j, False)[0]


def _flat_formula(t, dt, w):
    """The JAX kernel's full-inverse draw and sampler density
    (integrate_nd_pallas.py:437-449), in numpy float32."""
    m = t.shape[0]
    pos = w * np.float32(m - 1)
    i0 = np.clip(pos.astype(np.int32), 0, m - 2)
    frac = pos - i0.astype(np.float32)
    x = t[i0] + frac * dt[i0]
    inv_du = np.float32(1.0 / (m - 1))
    with np.errstate(divide="ignore"):
        q = np.where(dt[i0] > 0, inv_du / np.maximum(dt[i0], np.float32(1e-38)),
                     np.float32(0.0)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("mirror", [False, True], ids=["w", "mirror"])
def test_draws_match_jax_routes(mirror):
    # Every route's samples (and sampler densities) over a whole tile, at
    # w and at 1 - w: the stratified route against the JAX kernel's own
    # lookups, the flat one against its formula.
    w = _tile_w()
    if mirror:
        w = 1.0 - w
    b = _dist(tm, "beta25")
    spec = dist_spec_of(b)
    j_t = jnp.asarray(j_dist_spec_of(_dist(jmc, "beta25")).x_table)
    ts, dts, qs = j_prep_inv_table_stratified(j_t, 256, with_pdf=True)
    for sampler in (False, True):
        strat = nd_custom_dim(b, spec, "cpu", True, sampler)
        got = nk._custom_dim_draw(strat, w, sampler)
        if sampler:
            wx, wq = _stratified_sample_pdf_from_w(ts, dts, qs, jnp.asarray(w.numpy()))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(wx))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(wq))
        else:
            wx = _stratified_sample_from_w(ts, dts, jnp.asarray(w.numpy()))
            np.testing.assert_array_equal(got.numpy(), np.asarray(wx))
        flat = nd_custom_dim(b, spec, "cpu", False, sampler)
        got = nk._custom_dim_draw(flat, w, sampler)
        t, dt = (np.asarray(a).reshape(-1) for a in j_prep_inv_table(j_t))
        fx, fq = _flat_formula(t, dt, w.numpy())
        if sampler:
            np.testing.assert_array_equal(got[0].numpy(), fx)
            np.testing.assert_array_equal(got[1].numpy(), fq)
        else:
            np.testing.assert_array_equal(got.numpy(), fx)


def test_nd_draws_route_each_custom_dimension():
    # Only the first CUSTOM dimension stratifies, and only under mc and
    # antithetic: its samples then carry the row's stratum (a row's draws
    # lie inside its stratum's x range); the second draws through the flat
    # inverse, as under qmc every one does.
    names = ("beta25", "u01", "beta33")
    dists = [_dist(tm, nm) for nm in names]
    kinds = tuple(dist_spec_of(dd).kind for dd in dists)
    params = torch.tensor(np.stack([dist_spec_of(dd).params for dd in dists]))
    grid = plan_grid(1 << 20)
    tiles = torch.tensor([3, 9])
    for method in ("mc", "antithetic", "qmc"):
        cfg = nk.NdConfig(kinds, method)
        tables = nd_tables(dists, cfg, "cpu")
        assert nk.nd_routes(cfg, tables) == (
            (2, 0, 2) if method == "qmc" else (1, 0, 2))
        assert cfg.strat_dim == (-1 if method == "qmc" else 0)
        sets = nk.nd_draws(cfg, params, 5, grid, tiles, tables)
        assert len(sets) == (2 if method == "antithetic" else 1)
        for xs, qs in sets:
            assert all(q is None for q in qs)
            if method == "qmc":
                continue
            ts = tables[0].draw.ts
            rows = xs[0].reshape(2, 32, 8 * 128)
            assert torch.all(rows >= ts[:, :1].reshape(1, 32, 1))
            assert torch.all(rows <= ts[:, -1:].reshape(1, 32, 1))


def test_wrong_tables_raise():
    dists = [_dist(tm, "beta25"), _dist(tm, "beta33")]
    kinds = tuple(dist_spec_of(dd).kind for dd in dists)
    cfg = nk.NdConfig(kinds)
    tables = nd_tables(dists, cfg, "cpu")
    with pytest.raises(ValueError, match="strata or knots route"):
        nk.nd_routes(cfg, tables[::-1])
    with pytest.raises(ValueError, match="CustomDim"):
        nk.nd_routes(cfg, [tables[0], None])
    with pytest.raises(ValueError, match="flat or knots route under 'qmc'"):
        nk.nd_routes(nk.NdConfig(kinds, "qmc"), tables)
    program = nk.IntegrateNdProgram((tm.trace_function(F2[0], 2),), kinds)
    with pytest.raises(ValueError, match="CUSTOM dimensions, and only they"):
        program.library(None)
    p = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="no nd integrate kernel"):
        nk.integrate_nd_rows(program, cfg, p, 3, plan_grid(1000), tables=tables)


# -- the kernel's lookups, built for the host -------------------------------------

_SHIM = r"""
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

// integrate_nd.cu's CUSTOM draw of a tile's top-24 words at positions
// pos on `route`, at w (mirror 0) or at 1 - w (mirror 1), with the
// sampler's density where want_q.
extern "C" void nd_custom(int route, const float* t, const float* dt,
                          const float* qs, float inv_du, int m,
                          const uint32_t* top, const uint32_t* pos, int n,
                          int mirror, int want_q, float* x, float* q) {
  NdDim d{};
  d.t = t;
  d.dt = dt;
  d.qs = qs;
  d.inv_du = inv_du;
  d.m = m;
  for (int i = 0; i < n; ++i) {
    const float w = halfopen_top(top[i]);
    const float v = mirror ? 1.0f - w : w;
    const float pw = mirror ? v * 127.0f : float(top[i]) * kW127;
    x[i] = want_q ? nd_custom_x<true>(route, v, pw, pos[i], d, q + i)
                  : nd_custom_x<false>(route, v, pw, pos[i], d, nullptr);
  }
}

extern "C" void ratio(const float* p, const float* q, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = weight_ratio(p[i], q[i]);
}
"""


@pytest.fixture(scope="module")
def lookups(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("ndlookups")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libndlookups.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nd_custom.argtypes = [i32, ptr, ptr, ptr, f32, i32, ptr, ptr, i32, i32,
                              i32, ptr, ptr]
    lib.ratio.argtypes = [ptr, ptr, i32, ptr]
    lib.nd_custom.restype = lib.ratio.restype = None
    return lib


def _np(t):
    return None if t is None else np.ascontiguousarray(t.numpy())


def _ptr(a):
    return None if a is None else a.ctypes.data


ROUTE_CASES = [("beta25", True, False), ("beta25", True, True),
               ("beta25", False, False), ("beta25", False, True),
               ("gapped", True, False), ("gapped", False, False),
               ("t5", True, False)]


@pytest.mark.parametrize(
    "name,stratified,sampler", ROUTE_CASES,
    ids=[f"{n}-{'strata' if s else 'flat'}{'-q' if q else ''}" for n, s, q in ROUTE_CASES])
def test_kernel_custom_draw_is_the_plain_one(lookups, name, stratified, sampler):
    # integrate_draw.cuh's nd_custom_x on every route (strata, gapped
    # strata, flat, flat gapped, knots), with the sampler's density on the
    # strata and flat routes, bit for bit against the plain draw over a
    # whole tile at w and at 1 - w; a gapped table's zero slopes give a
    # density of 0, not NaN.
    dist = _dist(tm, name)
    tab = nd_custom_dim(dist, dist_spec_of(dist), "cpu", stratified, sampler)
    draw = tab.draw
    rng = nk.CounterRng(42, 3)
    m24 = (rng.bits((256, 128), 5, 0) >> 8).numpy().astype(np.uint32)
    top = np.ascontiguousarray((m24 << 8).reshape(-1))
    pos = np.arange(top.size, dtype=np.uint32)
    w = torch.from_numpy(m24.astype(np.float32) * np.float32(2.0**-24))
    if tab.route == "knots":
        t, dt, qs, m, inv_du = _np(draw.x), _np(draw.cdf), None, draw.x.shape[0], 0.0
    elif tab.route == "strata":
        t, dt, qs, m, inv_du = _np(draw.ts), _np(draw.dts), _np(draw.qs), 0, 0.0
    else:
        t, dt, qs, m, inv_du = _np(draw.t), _np(draw.dt), None, draw.t.shape[0], draw.inv_du
    code = nk.ROUTES[tab.route]
    for mirror in (0, 1):
        x = np.empty(top.size, np.float32)
        q = np.empty(top.size, np.float32)
        lookups.nd_custom(code, _ptr(t), _ptr(dt), _ptr(qs), inv_du, m,
                          _ptr(top), _ptr(pos), top.size, mirror, int(sampler),
                          _ptr(x), _ptr(q))
        want = nk._custom_dim_draw(tab, 1.0 - w if mirror else w, sampler)
        wx, wq = want if sampler else (want, None)
        np.testing.assert_array_equal(x, wx.reshape(-1).numpy())
        if sampler:
            np.testing.assert_array_equal(q, wq.reshape(-1).numpy())


def test_kernel_flat_sampler_density_at_zero_slopes(lookups):
    # A flat inverse with repeated knots (zero slopes, as a table with a
    # point mass or a flat run has): the sampler's density there is 0, so
    # the dimension's weight factor is 0, not inf or NaN, in the kernel's
    # lookup and in the plain one alike.
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0.0, 1.0, 512)).astype(np.float32)
    t[100:140] = t[100]
    t[300:301] = t[299]
    flat = nk.FlatTables(torch.from_numpy(t), torch.from_numpy(
        np.concatenate([t[1:] - t[:-1], np.zeros(1, np.float32)])))
    tab = nk.CustomDim(flat, flat)
    m24 = rng.integers(0, 1 << 24, 65536).astype(np.uint32)
    top = np.ascontiguousarray(m24 << 8)
    pos = np.arange(top.size, dtype=np.uint32)
    x = np.empty(top.size, np.float32)
    q = np.empty(top.size, np.float32)
    lookups.nd_custom(nk.ROUTES["flat"], _ptr(t), _ptr(_np(flat.dt)), None,
                      flat.inv_du, t.size, _ptr(top), _ptr(pos), top.size, 0, 1,
                      _ptr(x), _ptr(q))
    wx, wq = nk._custom_dim_draw(tab, torch.from_numpy(
        m24.astype(np.float32) * np.float32(2.0**-24)), True)
    np.testing.assert_array_equal(x, wx.numpy())
    np.testing.assert_array_equal(q, wq.numpy())
    assert np.sum(q == 0.0) > 1000 and np.all(np.isfinite(q))
    r = nk.kernel_weight(torch.ones_like(wq), wq)
    assert torch.all(torch.isfinite(r)) and torch.all(r[wq == 0] == 0)


def test_kernel_weight_ratio_is_the_plain_one(lookups):
    rng = np.random.default_rng(3)
    p = rng.uniform(0.0, 3.0, 4096).astype(np.float32)
    q = rng.uniform(-1.0, 3.0, 4096).astype(np.float32)
    q[:16] = 0.0
    out = np.empty_like(p)
    lookups.ratio(_ptr(p), _ptr(q), p.size, _ptr(out))
    want = nk.kernel_weight(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(out, want)
    assert np.all(out[:16] == 0.0)


# -- the pilot -----------------------------------------------------------------------


def test_pilot_row_matches_jax_grid():
    # A CUSTOM dimension's pilot grid goes through its full inverse, as
    # the JAX kernel's _pilot_row_of builds it: its points equal, and the
    # pilots' means within the means' tolerance.
    names = ("beta25", "u01", "beta33")
    fns = F3
    dists = [_dist(tm, nm) for nm in names]
    kinds = tuple(dist_spec_of(dd).kind for dd in dists)
    params = torch.tensor(np.stack([dist_spec_of(dd).params for dd in dists]))
    cfg = nk.NdConfig(kinds, "mc", True)
    tables = nd_tables(dists, cfg, "cpu")
    program = nk.IntegrateNdProgram(tuple(tm.trace_function(f, 3) for f in fns), kinds)
    got = nk.pilot_row(program.torch_fns, kinds, params, tables).numpy()
    # The JAX pilot: quantile grids offset by the golden ratio's fraction
    # per dimension, a CUSTOM one through its m-knot inverse.
    base = (np.arange(1024, dtype=np.float32) + np.float32(0.5)) / np.float32(1024)
    xs = []
    for j, dd in enumerate(dists):
        u = np.mod(base + np.float32(j) * np.float32(0.3819660113), np.float32(1.0))
        u = np.clip(u, np.float32(1e-7), np.float32(1.0 - 1e-7)).astype(np.float32)
        if kinds[j] == DistKind.CUSTOM:
            t = dist_spec_of(dd).x_table
            m = t.shape[0]
            pos = u * np.float32(m - 1)
            i0 = np.clip(pos.astype(np.int32), 0, m - 2)
            frac = pos - i0.astype(np.float32)
            xs.append(t[i0] + frac * (t[i0 + 1] - t[i0]))
        else:
            xs.append(u)
        got_x = nk._pilot_grid(j, kinds[j], params[j, 0], params[j, 1],
                               torch.from_numpy(u), tables).numpy()
        np.testing.assert_array_equal(got_x, xs[-1])
    want = [np.mean(fn(*[torch.from_numpy(x) for x in xs]).numpy(), dtype=np.float64)
            for fn in program.torch_fns]
    _close(got, want)


# -- the public path -------------------------------------------------------------------

PUBLIC_CASES = {
    "c9b": (F2[:1], ("beta25", "u01"), dict(method="mc")),
    "beta-u-antithetic-stderr": (F2, ("beta25", "u01"), dict(method="antithetic", return_stderr=True)),
    "two-custom-qmc": (F2, ("beta25", "beta33"), dict(method="qmc")),
    "two-custom-rqmc": (F2, ("beta25", "beta33"), dict(method="qmc", return_stderr=True,
                                                       qmc_rotations=4)),
    "u-beta-exp-stderr": (F3, ("u01", "beta25", "exp2"), dict(method="mc", return_stderr=True,
                                                              seed=(1 << 31) + 1)),
}


@pytest.mark.parametrize("case", list(PUBLIC_CASES))
def test_public_path_matches_jax_pallas_backend(case):
    # MonteCarloIntegrator(device="cpu") against the JAX package's
    # interpret-mode kernel through integrate(): means within 1e-6 + 1e-6
    # |mean|, error bars within rel 1e-4, rQMC spreads within the means'
    # tolerance.
    fns, names, kw = PUBLIC_CASES[case]
    kw = dict(dict(n_samples=1 << 17, seed=42), **kw)
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate(
        fns, [_dist(jmc, nm) for nm in names], **kw)
    got = tm.MonteCarloIntegrator(device="cpu").integrate(
        fns, [_dist(tm, nm) for nm in names], **kw)
    assert got.values.dtype == np.float64 and got.values.shape == (len(fns),)
    _close(got.values, want.values)
    if kw.get("method") == "qmc" and kw.get("return_stderr"):
        atol = MEAN_ATOL + MEAN_RTOL * np.abs(want.values)
        assert np.all(np.abs(got.stderr - want.stderr) <= atol)
    elif kw.get("return_stderr"):
        _close(got.stderr, want.stderr, rtol=STDERR_RTOL, atol=0.0)
    else:
        assert got.stderr is None


# -- the JAX package's nd table tests, on the port -------------------------------------


@pytest.fixture
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


def test_mixed_families_with_table_dim(integ):
    # tests/test_nd.py::TestNdIntegrate::test_mixed_families_with_table_dim.
    u, ex, b = tm.Distribution.uniform(0.0, 1.0), tm.Distribution.exponential(2.0), \
        tm.Distribution.beta(2.0, 5.0)
    r = integ.integrate([lambda x, y, z: x * y * z], [u, ex, b],
                        n_samples=2_000_000, seed=7)
    assert abs(r.values[0] - 0.5 * 0.5 * (2.0 / 7.0)) < 0.005


def test_table_dims_ride_the_kernel(integ):
    # tests/test_nd.py::TestNdPallas::test_table_dims_ride_the_kernel.
    b, b2 = tm.Distribution.beta(2.0, 5.0), tm.Distribution.beta(3.0, 3.0)
    u = tm.Distribution.uniform(0.0, 1.0)
    r = integ.integrate([lambda x, y: x * y], [b, u], n_samples=200_000, seed=6)
    assert abs(r.values[0] - (2.0 / 7.0) * 0.5) < 0.01
    r2 = integ.integrate([lambda x, y: x * y], [b, b2], n_samples=500_000, seed=8)
    assert abs(r2.values[0] - (2.0 / 7.0) * 0.5) < 0.008
    r3 = integ.integrate([lambda x, y: x + y], [b, u], n_samples=200_000, seed=9,
                         return_stderr=True)
    assert r3.stderr[0] > 0
    assert abs(r3.values[0] - (2.0 / 7.0 + 0.5)) < 6 * r3.stderr[0] + 0.01
    r4 = integ.integrate([lambda x, y: x * y], [b, u], n_samples=200_000, seed=10,
                         method="qmc")
    assert abs(r4.values[0] - (2.0 / 7.0) * 0.5) < 0.005


def test_gapped_table_dim_stays_in_the_kernel(integ):
    # tests/test_nd.py::TestNdPallas::test_gapped_table_dim_falls_back_with_warning:
    # the JAX package sends the gap-respecting dimension to its XLA sweep
    # with a warning; the port draws it in its kernel (the gap-respecting
    # strata, or the flat gapped tables), warns of nothing, and holds the
    # same 0.25 within 0.01 in every method.
    gapped, u = _gapped_pdf(tm), tm.Distribution.uniform(0.0, 1.0)
    assert dist_spec_of(gapped).exact_inverse
    for method in ("mc", "antithetic", "qmc"):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            r = integ.integrate([lambda x, y: x * y], [gapped, u],
                                n_samples=200_000, seed=6, method=method)
        assert not rec
        assert abs(r.values[0] - 0.25) < 0.01
    # No sample lands inside the gap (its zero-density knots; the pdf
    # table ramps linearly over the knot interval at each edge), on the
    # stratified route or the flat one.
    inside = [lambda x, y: (x > 0.401) * (x < 0.599), lambda x, y: (y > 0.401) * (y < 0.599)]
    for dims in ([gapped, u], [u, gapped]):
        r = integ.integrate(inside, dims, n_samples=200_000, seed=3)
        k = 0 if dims[0] is gapped else 1
        assert r.values[k] == 0.0 and abs(r.values[1 - k] - 0.198) < 0.01


def test_heavy_tailed_dim_takes_the_knot_route(integ):
    # Student-t(5) (heavy-tailed: the JAX package's XLA sampler) as the
    # stratified and as a second dimension: E[X^2] = 5/3 within 0.1, as
    # the 1-D knot route is held (tests/test_torch_custom_api.py).
    t5, n = tm.Distribution.student_t(5.0), tm.Distribution.normal(0.0, 1.0)
    assert dist_spec_of(t5).heavy_tail
    for dims in ([t5, n], [n, t5], [t5, t5]):
        r = integ.integrate([lambda x, y: x * x + y * y], dims, n_samples=1 << 19,
                            seed=4, return_stderr=True)
        want = sum(5.0 / 3.0 if dd is t5 else 1.0 for dd in dims)
        assert abs(r.values[0] - want) < 0.1 and r.stderr[0] > 0
