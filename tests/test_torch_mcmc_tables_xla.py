"""The CUSTOM tables that the JAX package's MCMC kernel gates send to its
XLA sweep, in the port's 1-D, nd and tempered MCMC kernels.

The JAX package runs a heavy-tailed proposal, an inverse table whose
length is not a multiple of 128, a proposal whose q-table is needed and
not faithful, a target with no uniform-grid log table and (tempered)
every gapped proposal on its XLA sweep, keyed on ``jax.random``.  The
port keeps them in its kernels under the counter stream, on the routes of
``api/device.py``: ``"knots"`` (the knot-exact inverse over the CDF knots),
``"full"`` (the flat inverse at full length), both with logq from the
full log-pdf table on its own grid, the irregular-grid target table, and
the ``"gapped"`` route in the tempered kernel.

* Routes: defined exactly where the JAX gates return XLA, and unchanged
  where they keep the workload.
* Lookups, on the same seeded numpy inputs: the knot-exact draw against
  ``sampling.transform_from_u(..., exact_inverse=True)`` and the flat one
  against its other branch; the irregular log table against
  ``log_pdf_from_table(..., uniform=False)`` and its slope against
  ``jax.grad`` of that lookup.
* Whole runs of the plain versions against the JAX package's default
  (XLA) route, which no port can match bit for bit: each mean within 6
  combined standard errors and the reference MCMC tolerance (0.1-0.2,
  BASELINE.md); seed-batched handles whose reps equal their unbatched
  runs bit for bit.
* The kernels' copies of the lookups (``csrc/counter_rng.cuh``
  ``knot_draw`` and ``knot_log_pdf``, ``csrc/log_pdf_grad.cuh``
  ``knot_log_pdf_slope``), built with g++, bit for bit the plain ones.
* ``chip_smoke.py``'s bound counts a knot search nested in the sample
  loop at its levels, on a synthetic SASS listing.

The CUDA kernels are held against these plain versions, chain for chain,
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import math
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo import sampling as jsampling
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import DistSpec as JDistSpec
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import device as tdevice
from tpu_montecarlo_torch.ops.mcmc_tables import (
    InverseTable,
    KnotTable,
    flat_inverse,
    inverse_draw,
    log_table_slope,
    log_table_value,
)
from tpu_montecarlo_torch.sampling import DistKind, DistSpec, dist_spec_of
from tpu_montecarlo_torch.tables import compute_inverse_cdf_table, is_uniform_grid

CSRC = pathlib.Path(tm.__file__).parent / "csrc"
ULPS = 8
SLOPE_RTOL = 1e-5
SIGMAS, REF_TOL = 6.0, 0.2
RUN = dict(n_steps=400, n_chains=512, n_burnin=100)
HANDLE = dict(n_steps=40, n_chains=256, n_burnin=10)

_SPIKE_X = np.sort(np.concatenate([np.linspace(0.0, 4.0, 900),
                                   np.linspace(1.999, 2.001, 200)]))
_SPIKE_P = 0.2 + np.exp(-0.5 * ((_SPIKE_X - 2.0) / 0.0005) ** 2) * 50.0
_GAP_X = np.linspace(-6.0, 6.0, 2048)
_GAP_P = np.where(np.abs(_GAP_X) < 0.05, 0.0, np.exp(-0.02 * _GAP_X ** 2))


def _short_inverse(pkg):
    """Beta(2, 5) whose uniform-u inverse has 1,000 knots (no public
    constructor makes one: it is set through the spec)."""
    d = pkg.Distribution.beta(2.0, 5.0)
    inv = compute_inverse_cdf_table(d._x_table, d._cdf_table, m=1000)
    spec = DistSpec if pkg is tm else JDistSpec
    kind = DistKind.CUSTOM if pkg is tm else JKind.CUSTOM
    d._cached_spec = spec(kind, np.zeros(2, np.float32), inv,
                          np.asarray(d._cdf_table, np.float32))
    return d


DISTS = {
    "t5": lambda p: p.Distribution.student_t(5.0),
    "t3": lambda p: p.Distribution.student_t(3.0),
    "gapped-mixture": lambda p: p.Distribution.mixture(
        [p.Distribution.uniform(-3.0, -1.0), p.Distribution.uniform(1.0, 3.0)]),
    "spiky": lambda p: p.Distribution.from_pdf_table(_SPIKE_X, _SPIKE_P),
    "short-inverse": _short_inverse,
    "gap": lambda p: p.Distribution.from_pdf_table(_GAP_X, _GAP_P),
}


def _both(name):
    return DISTS[name](jmc), DISTS[name](tm)


def _faithful(jd):
    return jdevice._proposal_kernel_log_tables(jd) is not None


def _jax_keeps(jd, stateful=False, tempered=False):
    """Whether the JAX package's kernel gate keeps a CUSTOM proposal:
    ``_mcmc_pallas_ok`` (``api/mcmc.py:454-500``; nd, ``api/mcmc_nd.py
    :198-219``) or, ``tempered``, ``_pt_pallas_eligible``
    (``api/tempering.py:330-426``)."""
    s = j_dist_spec_of(jd)
    lanes = s.x_table.shape[0] % 128 == 0
    if tempered:
        return not (s.exact_inverse or s.heavy_tail) and lanes
    ok = not s.heavy_tail and (s.exact_inverse or lanes)
    if ok and (stateful or s.exact_inverse):
        ok = _faithful(jd)
    return ok


def _want_route(jd, stateful=False, tempered=False):
    s = j_dist_spec_of(jd)
    if _jax_keeps(jd, stateful, tempered):
        if s.exact_inverse:
            return "gapped"
        return "table" if stateful else "sampler"
    if s.exact_inverse:
        # The tempered kernel now takes a faithful gapped proposal itself.
        if tempered and not s.heavy_tail and _faithful(jd):
            return "gapped"
        return "knots"
    return "full"


# -- routes --------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DISTS))
@pytest.mark.parametrize("stateful", [False, True])
def test_routes_are_defined_where_the_jax_gates_return_xla(name, stateful):
    jd, td = _both(name)
    for tempered in (False, True):
        if tempered and stateful:
            continue  # the tempered paths are stateless
        want = _want_route(jd, stateful, tempered)
        assert tdevice.mcmc_proposal_route(td, stateful) == want
    assert tdevice.mcmc_target_route(td) == (
        "grid" if jdevice._uniform_log_tables(jd) is not None else "knots")
    route = tdevice.mcmc_proposal_route(td, stateful)
    tables = tdevice.mcmc_dim_tables(td, td, "cpu", stateful)
    assert (tables.q is not None) == (route != "sampler")
    assert tables.knots == (
        route == "knots",
        route in ("knots", "full") and not is_uniform_grid(
            td.get_log_pdf_table()[0]),
        tdevice.mcmc_target_route(td) == "knots")
    assert isinstance(tables.inv, KnotTable) == (route == "knots")
    if route == "full":
        assert tables.inv.t.shape[0] == dist_spec_of(td).x_table.shape[0]


def test_xla_cases_of_the_jax_gates_are_the_ones_named():
    # Student-t is heavy and knot-exact, the mixture gapped with no faithful
    # q-table, the spiky table unfaithful (stateful) and irregular as a
    # target, the short inverse off the 128 lanes.
    routes = {n: tdevice.mcmc_proposal_route(DISTS[n](tm)) for n in DISTS}
    assert routes == {"t5": "knots", "t3": "knots", "gapped-mixture": "knots",
                      "spiky": "sampler", "short-inverse": "full",
                      "gap": "gapped"}
    assert tdevice.mcmc_proposal_route(DISTS["spiky"](tm), True) == "full"
    assert tdevice.mcmc_target_route(DISTS["spiky"](tm)) == "knots"


# -- lookups ---------------------------------------------------------------------


def _within_ulps(got, want, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    tol = ULPS * np.spacing(np.maximum(ref, np.float32(1e-30)))
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def _uniforms(n=4096, seed=0):
    u = np.random.default_rng(seed).random(n, dtype=np.float32)
    return np.concatenate([u, np.float32([0.0, 0.5, 1.0 - 2.0 ** -24])])


@pytest.mark.parametrize("name", ["t5", "t3", "gapped-mixture"])
def test_knot_exact_draw_is_the_jax_packages(name):
    jd, td = _both(name)
    spec = dist_spec_of(td)
    # The route draws u from [0, 1): the CDF knots below 1 as well (at
    # u = 1 over the CDF's tied top knots jnp.interp takes the one before).
    knots = spec.cdf_table[::7]
    u = np.concatenate([_uniforms(), knots[knots < 1.0]])
    want = np.asarray(jsampling.transform_from_u(
        jnp.asarray(u), JKind.CUSTOM, jnp.zeros(2),
        jnp.asarray(j_dist_spec_of(jd).x_table),
        jnp.asarray(j_dist_spec_of(jd).cdf_table), exact_inverse=True))
    tab = KnotTable.of(spec.cdf_table, spec.x_table, "cpu")
    got, slope = inverse_draw(torch.from_numpy(u), tab)
    # An interpolation between knots v0, v1 rounds on the scale of both.
    x = np.asarray(spec.x_table, np.float32)
    i = np.clip(np.searchsorted(spec.cdf_table, u, side="right") - 1, 0,
                x.shape[0] - 2)
    _within_ulps(got.numpy(), want,
                 np.maximum(np.abs(x[i]), np.abs(x[i + 1])))
    assert not slope.any()


def test_full_length_draw_is_the_jax_packages():
    jd, td = _both("short-inverse")
    spec = dist_spec_of(td)
    assert spec.x_table.shape[0] == 1000 and not spec.exact_inverse
    u = _uniforms(seed=1)
    want = np.asarray(jsampling.transform_from_u(
        jnp.asarray(u), JKind.CUSTOM, jnp.zeros(2),
        jnp.asarray(j_dist_spec_of(jd).x_table)))
    got, slope = inverse_draw(torch.from_numpy(u), InverseTable.of(
        *flat_inverse(spec.x_table), "cpu"))
    _within_ulps(got.numpy(), want, 1e-3)
    assert (slope >= 0).all()


def _log_points(lx, seed):
    rng = np.random.default_rng(seed)
    lo, hi = float(lx[0]), float(lx[-1])
    span = hi - lo
    x = rng.uniform(lo - 0.05 * span, hi + 0.05 * span, 4096)
    return np.concatenate([x, lx[::5], [lo, hi]]).astype(np.float32)


@pytest.mark.parametrize("name", ["t5", "spiky", "gapped-mixture"])
def test_irregular_log_table_is_the_jax_packages(name):
    jd, td = _both(name)
    lx, lp = (np.asarray(a, np.float32) for a in td.get_log_pdf_table())
    assert not is_uniform_grid(lx)
    x = _log_points(lx, 2)
    want = np.asarray(jsampling.log_pdf_from_table(
        jnp.asarray(x), jnp.asarray(lx), jnp.asarray(lp), uniform=False))
    tab = KnotTable.of(lx, lp, "cpu")
    got = log_table_value(torch.from_numpy(x), tab).numpy()
    i = np.clip(np.searchsorted(lx, x, side="right") - 1, 0, lx.shape[0] - 2)
    _within_ulps(got, want, np.maximum(np.abs(lp[i]), np.abs(lp[i + 1])))
    assert np.all(got[(x < lx[0]) | (x > lx[-1])] == -100.0)


@pytest.mark.parametrize("name", ["t5", "spiky"])
def test_irregular_log_table_slope_is_jax_grad(name):
    jd, td = _both(name)
    lx, lp = (np.asarray(a, np.float32) for a in td.get_log_pdf_table())
    x = _log_points(lx, 3)
    # Away from knots, where the slope is one interval's.
    i = np.searchsorted(lx, x)
    near = np.minimum(np.abs(x - lx[np.clip(i, 0, lx.shape[0] - 1)]),
                      np.abs(x - lx[np.clip(i - 1, 0, lx.shape[0] - 1)]))
    x = x[near > 1e-4 * (1.0 + np.abs(x))]
    jlx, jlp = jnp.asarray(lx), jnp.asarray(lp)
    want = np.asarray(jax.vmap(jax.grad(
        lambda v: jsampling.log_pdf_from_table(v, jlx, jlp, uniform=False)))(
            jnp.asarray(x)))
    got = log_table_slope(torch.from_numpy(x), KnotTable.of(lx, lp, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=SLOPE_RTOL, atol=1e-30)
    assert np.all(got.numpy()[(x < lx[0]) | (x > lx[-1])] == 0.0)


_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
static inline float erfinvf(float) { return 0.0f; }  // not called here
#include "log_pdf_grad.cuh"
using namespace tmc;

extern "C" void knots(const float* v, const float* d, int n, float x0,
                      float x_max, const uint32_t* m, const float* x,
                      int count, float* draw, float* logp, float* slope) {
  const TableRef ref{v, d, x0, 0.0f, x_max, 0.0f, n};
  for (int i = 0; i < count; ++i) {
    draw[i] = knot_draw(ref, m[i]);
    logp[i] = log_table_at<true>(ref, x[i]);
    slope[i] = log_table_slope_at<true>(ref, x[i]);
  }
}
"""


@pytest.fixture(scope="module")
def lookups(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("knot_lookups")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libknots.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.knots.argtypes = [ptr, ptr, i32, f32, f32, ptr, ptr, i32, ptr, ptr,
                          ptr]
    lib.knots.restype = None
    return lib


def _kernel_knots(lib, keys, vals, m, x):
    """The g++-built lookups over one knot table: (draws at the mantissas
    ``m``, log table at ``x``, its slope at ``x``)."""
    keys, vals = (np.ascontiguousarray(a, np.float32) for a in (keys, vals))
    out = [np.empty(m.size, np.float32) for _ in range(3)]
    lib.knots(keys.ctypes.data, vals.ctypes.data, keys.size, float(keys[0]),
              float(keys[-1]), m.ctypes.data, x.ctypes.data, m.size,
              *(o.ctypes.data for o in out))
    return out


@pytest.mark.parametrize("name", ["t5", "spiky", "gapped-mixture"])
def test_kernel_knot_lookups_are_the_plain_ones(lookups, name):
    # The knot-exact draw at a 2**24 stride of mantissas (the [0, 1)
    # uniforms) and both ends; the irregular log table and its slope at
    # and past the grid's ends.
    td = DISTS[name](tm)
    spec = dist_spec_of(td)
    lx, lp = td.get_log_pdf_table()
    m = np.concatenate([np.arange(0, 1 << 24, 193, dtype=np.uint32),
                        np.array([0, 1, (1 << 24) - 1], np.uint32)])
    x = np.resize(_log_points(lx, 4), m.size).astype(np.float32)
    draw = _kernel_knots(lookups, spec.cdf_table, spec.x_table, m, x)[0]
    u = torch.from_numpy(m.astype(np.float32) * np.float32(2.0**-24))
    inv = KnotTable.of(spec.cdf_table, spec.x_table, "cpu")
    np.testing.assert_array_equal(draw, inverse_draw(u, inv)[0].numpy())
    _, logp, slope = _kernel_knots(lookups, lx, lp, m, x)
    tab = KnotTable.of(lx, lp, "cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(logp, log_table_value(xt, tab).numpy())
    np.testing.assert_array_equal(slope, log_table_slope(xt, tab).numpy())


# -- whole runs against the JAX package's XLA route ------------------------------


def _n01(p):
    return p.Distribution.normal(0.0, 1.0)


def _spiky_target(p):
    return DISTS["spiky"](p)


def _bimodal(x):  # E[x] = 0, E[x^2] = 5
    return 0.5 * math.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * math.exp(
        -0.5 * (x - 2.0) ** 2)


def _bimodal_target(p):
    return p.Distribution.from_pdf(_bimodal, support=(-6.0, 6.0))


# id: (functions, target, proposal, extra keywords, exact values)
CASES = {
    "1d-t5-proposal": (
        [lambda x: x * x], _n01,
        lambda p: p.Distribution.student_t(5.0), {}, [1.0]),
    "walk-irregular-target": (
        [lambda x: x], _spiky_target,
        lambda p: p.RandomWalk(step_size=0.8, adapt=True,
                               init_range=(1.0, 3.0)), {}, [2.0]),
    "hmc-irregular-target": (
        [lambda x: x], _spiky_target,
        lambda p: p.HMC(step_size=0.2, n_leapfrog=4, init_range=(1.0, 3.0)),
        {}, [2.0]),
    "nd-heavy-dim": (
        [lambda x, y: x, lambda x, y: y * y],
        lambda p: [p.Distribution.beta(2.0, 5.0), _n01(p)],
        lambda p: [p.Distribution.beta(2.0, 5.0),
                   p.Distribution.student_t(5.0, 0.0, 2.0)],
        {}, [2.0 / 7.0, 1.0]),
    "tempered-gapped-dim": (
        [lambda x: x, lambda x: x * x], _bimodal_target,
        lambda p: DISTS["gap"](p), {"temperatures": [1.0, 2.0]}, [0.0, 5.0]),
    "tempered-heavy-dim": (
        [lambda x: x, lambda x: x * x], _bimodal_target,
        lambda p: p.Distribution.student_t(5.0, 0.0, 3.0),
        {"temperatures": [1.0, 2.0]}, [0.0, 5.0]),
}


def _run_both(name, seed=11, **kw):
    fns, target, proposal, extra, _ = CASES[name]
    got = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        fns, target(tm), proposal(tm), seed=seed, return_stderr=True,
        **RUN, **extra, **kw)
    want = jmc.MonteCarloIntegrator().integrate_mcmc(
        fns, target(jmc), proposal(jmc), seed=seed, return_stderr=True,
        **RUN, **extra, **kw)
    return got, want


def _hold(got, want, exact):
    got_v, want_v = np.asarray(got.values), np.asarray(want.values)
    assert got_v.shape == want_v.shape == (len(exact),)
    assert np.all(np.isfinite(got_v))
    diff = np.abs(got_v - want_v)
    assert np.all(diff < SIGMAS * np.hypot(got.stderr, want.stderr) + 1e-6)
    assert np.all(diff < REF_TOL)
    assert np.all(np.abs(got_v - np.asarray(exact)) < REF_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_runs_match_the_jax_xla_route(name):
    got, want = _run_both(name)
    _hold(got, want, CASES[name][4])
    assert abs(got.acceptance_rate - want.acceptance_rate) < 0.1


def test_stateful_spiky_proposal_resumes_against_the_jax_xla_route():
    # The spiky table's q-table is not faithful: a stateful run takes the
    # "full" route (full inverse, logq from its irregular log table).
    assert tdevice.mcmc_proposal_route(DISTS["spiky"](tm), True) == "full"
    results = []
    for pkg, integ in ((tm, tm.MonteCarloIntegrator(device="cpu")),
                       (jmc, jmc.MonteCarloIntegrator())):
        target, prop = pkg.Distribution.normal(2.0, 0.8), DISTS["spiky"](pkg)
        first = integ.integrate_mcmc([lambda v: v], target, prop, seed=5,
                                     return_state=True, **RUN)
        kw = dict(RUN, n_burnin=0)
        second = integ.integrate_mcmc([lambda v: v], target, prop, seed=6,
                                      initial_state=first.chain_state, **kw)
        results.append((first, second))
    for got, want in zip(*results):
        assert abs(got.values[0] - want.values[0]) < 0.1
        assert abs(got.values[0] - 2.0) < 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_seed_batched_handles_are_their_unbatched_runs(name):
    fns, target, proposal, extra, _ = CASES[name]
    integ = tm.MonteCarloIntegrator(device="cpu")
    args = (fns, target(tm), proposal(tm))
    batched = integ.compile_mcmc(*args, seed_batch=2, **HANDLE, **extra)
    values, accept = batched([3, 4])[:2]
    for r, seed in enumerate((3, 4)):
        one = integ.compile_mcmc(*args, **HANDLE, **extra)(seed)
        assert torch.equal(values[r], one[0])
        assert torch.equal(accept[r], one[1])
    assert torch.isfinite(values).all()


# -- the knot searches in chip_smoke.py's bounds ---------------------------------

# A sample loop (0x10-0xc0, one uniform conversion) around a knot search
# (0x50-0x80: a shift, a load and a compare a level) that a branch skips on
# the cheapest path, as knot_interp's early return from the last key does;
# with the branch taken out, the cheapest path runs one level.
_SEARCH_LISTING = """
\t\tFunction : _ZN3tmc11mcmc_kernelILi0EEEvv
        /*0000*/                   MOV R4, RZ ;
        /*0010*/                   I2FP.F32.U32 R7, R5 ;
        /*0020*/                   FSETP.GE.AND P1, PT, R7, 1, PT ;
        /*0030*/               @P1 BRA 0x90 ;
        /*0040*/                   MOV R2, RZ ;
        /*0050*/                   SHF.R.S32.HI R3, RZ, 0x1, R6 ;
        /*0060*/                   LDG.E R8, [R10.64] ;
        /*0070*/                   ISETP.GT.AND P2, PT, R6, RZ, PT ;
        /*0080*/               @P2 BRA 0x50 ;
        /*0090*/                   FADD R9, R9, R7 ;
        /*00a0*/                   IADD3 R4, R4, 0x1, RZ ;
        /*00b0*/                   ISETP.NE.AND P3, PT, R4, 0x80, PT ;
        /*00c0*/               @P3 BRA 0x10 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
"""


@pytest.mark.parametrize("skipped", [True, False])
def test_chip_smoke_bound_counts_knot_search_levels(skipped):
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    sass = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = sass  # its dataclasses look it up
    spec.loader.exec_module(sass)
    listing = (_SEARCH_LISTING if skipped else _SEARCH_LISTING.replace(
        "@P1 BRA 0x90", "NOP"))
    plain, _ = sass.per_sample(listing, "mcmc_kernel", 1)
    assert "search_loops" not in plain
    # The cheapest path: I2FP, FSETP, (BRA or NOP), [the search once],
    # FADD, IADD3, ISETP, BRA.
    assert plain["alu"] == (2 if skipped else 4)
    most, least = sass.per_sample(listing, "mcmc_kernel", 1, searches=10)
    assert most == least
    # Ten levels of the search's two alu instructions (SHF, ISETP) and
    # four issued, whether the path ran one of them or none.
    assert most["alu"] == 2 + 10 * 2
    assert most["issue"] == plain["issue"] + (10 if skipped else 9) * 4
    assert most["fma"] == plain["fma"] and most["xu"] == plain["xu"]
    assert most["search_loops"] == 1
