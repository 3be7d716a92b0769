"""MCMC over CUSTOM tables in the port's 1-D kernel against the JAX package,
and the host table helpers the three MCMC kernels read.

* The host helpers (``tables.downsample_log_table``,
  ``guard_proposal_log_floor``, ``log_pdf_from_pdf``,
  ``Distribution.get_log_pdf_table`` and the staging of ``api/device.py``:
  the downsampled proposal inverse, the flat gap-respecting tables, the
  uniform-grid and downsampled log tables, the gapped proposal's q-table
  pipeline) give the JAX package's arrays bit for bit, on Beta(2, 5), the
  bimodal ``from_pdf`` of BASELINE config 5, an irregular
  ``from_pdf_table``, a table with a zero-density gap and a gapped
  mixture; and each proposal takes the JAX kernel gate's route.
* The kernel's table lookups (``csrc/counter_rng.cuh``), built for the
  host with g++ and no fused multiply-adds as the kernel is built, give
  the plain versions' values bit for bit (the sampler-mode density
  within 2 ulp: ``logf`` of two libraries).
* The plain version of the 1-D kernel runs the chains of the
  interpret-mode JAX kernel, both reached through their public calls
  (``MonteCarloIntegrator(backend="pallas")`` on the CPU; the JAX
  kernel's final states are its last thinned draw), for every table
  route: a table target under a closed-form proposal (config 5's shape,
  scaled down), a sampler-mode proposal, a gapped proposal, the fixed and
  adaptive walks on a table target, and error bars.  The tolerances are
  ``tests/test_torch_mcmc.py``'s: at most 1 % of the chains split
  (final states more than 1e-4 relative apart; measured: none), means
  within 1e-5, acceptance within 1e-4, error bars within rel 1e-3.

The CUDA kernel is held against the plain version in
``test_torch_cuda.py``.
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

import tpu_montecarlo as jmc
from tpu_montecarlo import tables as jtables
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.ops.integrate_pallas import prep_inv_table as j_prep_inv_table
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch import tables as ttables
from tpu_montecarlo_torch.api import device as tdevice
from tpu_montecarlo_torch.api import mcmc as api_mcmc
from tpu_montecarlo_torch.ops import mcmc_tables as mt
from tpu_montecarlo_torch.ops.mcmc_kernel import mcmc_cuda
from tpu_montecarlo_torch.sampling import dist_spec_of

CSRC = Path(__file__).resolve().parents[1] / "tpu_montecarlo_torch" / "csrc"

N_CHAINS, N_STEPS, N_BURNIN = 1024, 40, 10
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
VALUE_ATOL = 1e-5
ACCEPT_ATOL = 1e-4
STDERR_RTOL = 1e-3


def bimodal(x):
    # BASELINE config 5's target (benchmarks/run_all.py:185-188).
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


_IRR_X = np.concatenate([np.linspace(-3.0, 0.0, 40, endpoint=False),
                         np.linspace(0.0, 3.0, 400)])
_IRR_P = np.exp(-0.5 * _IRR_X * _IRR_X) * (1.0 + 0.3 * np.sin(3.0 * _IRR_X))
_GAP_X = np.linspace(0.0, 1.0, 2048)
_GAP_P = np.where((_GAP_X > 0.4) & (_GAP_X < 0.6), 0.0, 1.0)
_WIDE_X = np.linspace(-6.0, 6.0, 2048)
_WIDE_P = np.where(np.abs(_WIDE_X) < 1.0, 0.0, np.exp(-0.1 * _WIDE_X * _WIDE_X))

# name: maker of the same Distribution in either package.
DISTS = {
    "beta": lambda p: p.Distribution.beta(2.0, 5.0),
    "bimodal": lambda p: p.Distribution.from_pdf(bimodal, support=(-6.0, 6.0)),
    "irregular": lambda p: p.Distribution.from_pdf_table(_IRR_X, _IRR_P),
    "gap": lambda p: p.Distribution.from_pdf_table(_GAP_X, _GAP_P),
    "wide-gap": lambda p: p.Distribution.from_pdf_table(_WIDE_X, _WIDE_P),
    "gapped-mixture": lambda p: p.Distribution.mixture(
        [p.Distribution.uniform(-3.0, -1.0), p.Distribution.uniform(1.0, 3.0)]),
    "uniform": lambda p: p.Distribution.uniform(-1.0, 2.0),
}
CUSTOM = [name for name in DISTS if name != "uniform"]


def _both(name):
    return DISTS[name](jmc), DISTS[name](tm)


def _equal(a, b):
    """Two helpers' results are the same arrays (or both None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- the host helpers, bit for bit -------------------------------------------


@pytest.mark.parametrize("name", list(DISTS))
def test_log_pdf_table_is_the_jax_packages(name):
    jd, td = _both(name)
    _equal(jd.get_log_pdf_table(), td.get_log_pdf_table())
    _equal(jd.get_log_pdf_table(-50.0), td.get_log_pdf_table(-50.0))
    assert td.get_log_pdf_table() is td.get_log_pdf_table()  # cached


def test_uniform_log_table_keeps_its_last_knot():
    # The half-open uniform's pdf reads 0 at x = max; the log table keeps
    # log(1 / width) there (reference: __init__.py:598-606).
    _, lp = tm.Distribution.uniform(-1.0, 3.0).get_log_pdf_table()
    assert lp[-1] == np.float32(np.log(0.25)) and np.all(lp > -2.0)


@pytest.mark.parametrize("floor", [-100.0, -30.0])
def test_log_pdf_from_pdf_is_the_jax_packages(floor):
    pdf = np.array([0.0, -1.0, 1e-20, 1e-16, 0.5, 3.0, np.float32(7e-39)])
    for a in (pdf, pdf.astype(np.float32)):
        _equal([jtables.log_pdf_from_pdf(a, floor)],
               [ttables.log_pdf_from_pdf(a, floor)])


def _synthetic_log_tables():
    x = np.linspace(-4.0, 4.0, 4096)
    smooth = -0.5 * x * x
    cliff = np.where(np.abs(x) < 2.0, -0.5 * x * x, -100.0)
    island = np.where((x > -1.0) & (x < 0.5), 0.3, -100.0)
    wiggle = np.log1p(0.9 * np.sin(40.0 * x) ** 2) - 0.1 * x * x
    return {"smooth": (x, smooth), "cliff": (x, cliff),
            "island": (x, island), "wiggle": (x, wiggle)}


@pytest.mark.parametrize("strict", [False, True], ids=["target", "proposal"])
@pytest.mark.parametrize("name", [*_synthetic_log_tables(), *CUSTOM])
def test_downsample_log_table_is_the_jax_packages(name, strict):
    if name in DISTS:
        lx, lp = DISTS[name](tm).get_log_pdf_table()
    else:
        lx, lp = _synthetic_log_tables()[name]
    _equal(jtables.downsample_log_table(lx, lp, strict=strict),
           ttables.downsample_log_table(lx, lp, strict=strict))


@pytest.mark.parametrize("name", [*_synthetic_log_tables(), *CUSTOM])
def test_guard_proposal_log_floor_is_the_jax_packages(name):
    if name in DISTS:
        lp = DISTS[name](tm).get_log_pdf_table()[1]
    else:
        lp = _synthetic_log_tables()[name][1]
    _equal([jtables.guard_proposal_log_floor(lp)],
           [ttables.guard_proposal_log_floor(lp)])


@pytest.mark.parametrize("name", CUSTOM)
def test_mcmc_log_tables_are_the_jax_packages(name):
    # The uniform-grid log tables, the gapped proposal's q-table pipeline
    # and the downsampled target table, as api/device.py stages them.
    jd, td = _both(name)
    _equal(jdevice._uniform_log_tables(jd), tdevice._uniform_log_tables(td))
    _equal(jdevice._proposal_kernel_log_tables(jd),
           tdevice._proposal_kernel_log_tables(td))
    if tdevice._uniform_log_tables(td) is not None:
        want = [np.asarray(a) for a in jdevice._device_uniform_log_tables(jd)]
        _equal(want, tdevice._device_uniform_log_tables(td))


@pytest.mark.parametrize("name", ["beta", "bimodal", "irregular"])
def test_proposal_inverse_is_the_jax_packages(name):
    # The downsampled inverse of a sampler-mode proposal, and its flat
    # (value, forward difference) tables.
    jd, td = _both(name)
    j_inv = np.asarray(jdevice._mcmc_prop_inverse(jd, j_dist_spec_of(jd)))
    t_inv = tdevice._mcmc_prop_inverse(td, dist_spec_of(td))
    _equal([j_inv], [t_inv])
    assert 256 <= t_inv.shape[0] <= 4096 and t_inv.shape[0] % 128 == 0
    _equal([np.asarray(a).reshape(-1) for a in j_prep_inv_table(j_inv)],
           mt.prep_inv_table(t_inv))


@pytest.mark.parametrize("name", ["gap", "wide-gap", "gapped-mixture"])
def test_flat_gapped_tables_are_the_jax_packages(name):
    jd, td = _both(name)
    want = jdevice._device_gapped_tables(jd, j_dist_spec_of(jd),
                                         stratified=False)
    got = tdevice._device_gapped_tables(td, dist_spec_of(td), stratified=False)
    _equal([np.asarray(a) for a in want], got)
    # The integrate kernel's stratified tables stay beside them.
    strat = tdevice._device_gapped_tables(td, dist_spec_of(td))
    assert strat[0].shape == (32, 128)


def _jax_route(dist):
    """The route the JAX kernel gate (``_mcmc_pallas_ok``) gives a
    stateless CUSTOM proposal, and where it sends it to its XLA sweep the
    port's route for what that sweep reads: ``"knots"`` for a knot-exact
    spec, ``"full"`` for another."""
    spec = j_dist_spec_of(dist)
    xla = "knots" if spec.exact_inverse else "full"
    if spec.heavy_tail:
        return xla
    if spec.exact_inverse:
        return (xla if jdevice._proposal_kernel_log_tables(dist) is None
                else "gapped")
    return "sampler" if spec.x_table.shape[0] % 128 == 0 else xla


@pytest.mark.parametrize("name", CUSTOM)
def test_proposal_routes_are_the_jax_gates(name):
    jd, td = _both(name)
    assert tdevice.mcmc_proposal_route(td) == _jax_route(jd)
    assert (tdevice.mcmc_target_route(td) == "grid") == (
        jdevice._uniform_log_tables(jd) is not None)


def test_device_tables_are_staged_once_per_distribution():
    d = DISTS["wide-gap"](tm)
    first = tdevice.mcmc_dim_tables(d, d, "cpu")
    second = tdevice.mcmc_dim_tables(d, d, "cpu")
    assert first.inv is second.inv and first.q is second.q
    assert first.targ is second.targ
    assert tdevice.mcmc_dim_tables(tm.Distribution.normal(0, 1),
                                   tm.Distribution.normal(0, 1), "cpu") is None
    inv = tdevice.mcmc_dim_tables(DISTS["beta"](tm), None, "cpu").inv
    assert inv.log_m1 == float(np.float32(np.log(inv.t.shape[0] - 1.0)))


# -- the kernel's table lookups, built for the host ----------------------------

_LOOKUP_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
static inline float erfinvf(float) { return 0.0f; }  // not called here
#include "counter_rng.cuh"
using namespace tmc;

extern "C" void draws(const float* t, const float* dt, int n, float log_m1,
                      const uint32_t* m, int count, float* x, float* slope,
                      float* logq) {
  const TableRef ref{t, dt, 0.0f, 0.0f, 0.0f, log_m1, n};
  for (int i = 0; i < count; ++i) {
    x[i] = table_draw(ref, m[i], slope[i]);
    logq[i] = sampler_logq(ref, slope[i]);
  }
}

extern "C" void log_table(const float* v, const float* d, float x0,
                          float step, float x_max, int n, const float* x,
                          int count, float* out) {
  const TableRef ref{v, d, x0, step, x_max, 0.0f, n};
  for (int i = 0; i < count; ++i) out[i] = table_log_pdf(ref, x[i]);
}
"""


@pytest.fixture(scope="module")
def lookups(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("mcmc_lookups")
    (d / "shim.cpp").write_text(_LOOKUP_SHIM)
    so = d / "liblookups.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.draws.argtypes = [ptr, ptr, i32, f32, ptr, i32, ptr, ptr, ptr]
    lib.log_table.argtypes = [ptr, ptr, f32, f32, f32, i32, ptr, i32, ptr]
    lib.draws.restype = lib.log_table.restype = None
    return lib


def _ptr(a):
    return a.ctypes.data


@pytest.mark.parametrize("name", ["beta", "wide-gap"])
def test_kernel_inverse_draw_is_the_plain_one(lookups, name):
    # Every mantissa of a 2**24 stride across [0, 1) and both ends: the
    # draw and its slope bit for bit; the sampler-mode density within 2
    # ulp (logf of glibc against torch's).
    tabs = tdevice.mcmc_dim_tables(DISTS[name](tm), None, "cpu")
    inv = tabs.inv
    t, dt = (np.ascontiguousarray(a.numpy()) for a in (inv.t, inv.dt))
    m = np.concatenate([np.arange(0, 1 << 24, 97, dtype=np.uint32),
                        np.array([0, 1, (1 << 24) - 1], np.uint32)])
    x, slope, logq = (np.empty(m.size, np.float32) for _ in range(3))
    lookups.draws(_ptr(t), _ptr(dt), t.size, inv.log_m1, _ptr(m), m.size,
                  _ptr(x), _ptr(slope), _ptr(logq))
    u = torch.from_numpy(m.astype(np.float32) * np.float32(2.0**-24))
    wx, ws = mt.inverse_draw(u, inv)
    np.testing.assert_array_equal(x, wx.numpy())
    np.testing.assert_array_equal(slope, ws.numpy())
    want_q = mt.sampler_logq(ws, inv).numpy()
    assert np.all(np.abs(logq - want_q) <= 2 * np.spacing(np.abs(want_q)))


@pytest.mark.parametrize("name", ["bimodal", "beta", "wide-gap"])
def test_kernel_log_table_is_the_plain_one(lookups, name):
    # Across and past the grid's ends, and on every knot.
    tab = tdevice.mcmc_dim_tables(None, DISTS[name](tm), "cpu").targ
    v, d = (np.ascontiguousarray(a.numpy()) for a in (tab.vals, tab.dx))
    x0, step, x_max = tab.grid
    n = v.size
    rng = np.random.default_rng(7)
    span = x_max - x0
    x = np.concatenate([
        rng.uniform(x0 - 0.2 * span, x_max + 0.2 * span, 50_000),
        x0 + step * np.arange(n), [x0, x_max, np.nextafter(x_max, np.inf),
                                   np.nextafter(x0, -np.inf)],
    ]).astype(np.float32)
    got = np.empty_like(x)
    lookups.log_table(_ptr(v), _ptr(d), x0, step, x_max, n, _ptr(x), x.size,
                      _ptr(got))
    want = mt.log_table_value(torch.from_numpy(x), tab).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == -100.0


# -- the 1-D kernel's table routes against the interpret-mode JAX kernel -------

# id: (fns, target, proposal, stderr); a target or proposal is a DISTS
# name, ("normal" | "uniform", p1, p2) or RandomWalk's keyword arguments.
CASES = {
    # BASELINE config 5, scaled down: a table target under U(-6, 6).
    "config5": ([lambda x: x * x], "bimodal", ("uniform", -6.0, 6.0), True),
    "table-target-normal-proposal": (
        [lambda x: x, lambda x: x * x], "bimodal", ("normal", 0.0, 3.0), False),
    "irregular-target": ([lambda x: x * x], "irregular", ("normal", 0.0, 2.0),
                         False),
    "sampler-proposal": ([lambda x: x, lambda x: x * x], "beta", "beta", True),
    "sampler-proposal-closed-form-target": (
        [lambda x: x, lambda x: (x > 0.3) * 1.0], ("normal", 0.3, 0.15), "beta",
        False),
    "gapped-proposal": ([lambda x: x, lambda x: x * x], ("uniform", 0.0, 1.0),
                        "gap", False),
    "gapped-proposal-table-target": ([lambda x: x * x], "bimodal", "wide-gap",
                                     True),
    "walk": ([lambda x: x, lambda x: x * x], "bimodal", dict(step_size=1.5),
             False),
    "adaptive-walk-stderr": (
        [lambda x: x * x], "bimodal",
        dict(step_size=1.0, adapt=True, init_range=(-3.0, 3.0)), True),
}


def _make(pkg, spec):
    if isinstance(spec, str):
        return DISTS[spec](pkg)
    if isinstance(spec, dict):
        return pkg.RandomWalk(**spec)
    name, *args = spec
    return getattr(pkg.Distribution, name)(*args)


def _jax_run(case, seed=42):
    """The interpret-mode JAX kernel through its public call: the result
    and the chains' final states (its last thinned draw)."""
    fns, target, proposal, stderr = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback to the XLA sweep
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _make(jmc, target), _make(jmc, proposal), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=seed,
            return_stderr=stderr, return_samples=N_STEPS,
        )
    return r, np.asarray(r.samples[-1]).reshape(-1)


def _port_run(case, monkeypatch, seed=42):
    """The port's public call on the CPU: the result and the final states
    (caught at the kernel wrapper)."""
    fns, target, proposal, stderr = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_mcmc, "mcmc_cuda", spy)
    r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        fns, _make(tm, target), _make(tm, proposal), n_steps=N_STEPS,
        n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=seed, return_stderr=stderr,
    )
    assert len(outs) == 1
    return r, outs[0].x_final.numpy()


def assert_runs_agree(got, x_port, want, x_jax, stderr):
    assert x_port.shape == x_jax.shape
    split = np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    assert np.all(np.isfinite(got.values))
    np.testing.assert_allclose(got.values, np.asarray(want.values, np.float64),
                               rtol=0.0, atol=VALUE_ATOL)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= ACCEPT_ATOL
    if stderr:
        assert np.all(got.stderr > 0)
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    else:
        assert got.stderr is None


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case, monkeypatch):
    want, x_jax = _jax_run(case)
    got, x_port = _port_run(case, monkeypatch)
    assert_runs_agree(got, x_port, want, x_jax, CASES[case][3])


def test_config5_is_near_its_second_moment():
    # E[X^2] of the bimodal target is 5 (the (-6, 6) cut is negligible);
    # 1024 chains x 40 steps hold it within 6 error bars.
    r = tm.integrate_mcmc([lambda x: x * x], DISTS["bimodal"](tm),
                          tm.Distribution.uniform(-6.0, 6.0), n_steps=200,
                          n_chains=1024, n_burnin=50, return_stderr=True,
                          device="cpu")
    assert abs(r.values[0] - 5.0) < 6.0 * r.stderr[0]
    assert 0.2 < r.acceptance_rate < 0.8


def test_gapped_route_compiles_its_logq_table():
    # The route is compiled in; the tables are run-time arguments.
    from tpu_montecarlo_torch.ops.mcmc_kernel import (
        McmcConfig,
        McmcProgram,
        Mode,
        plan_mcmc_grid,
    )
    from tpu_montecarlo_torch.sampling import DistKind

    program = McmcProgram((tm.trace_function(lambda x: x),))
    c = DistKind.CUSTOM
    for gapped in (False, True):
        cfg = McmcConfig(Mode.INDEPENDENCE, c, c, 10, 2, prop_gapped=gapped)
        assert f"#define TMC_PROP_GAPPED {int(gapped)}\n" in program.source(cfg)
        assert cfg.compiled == (Mode.INDEPENDENCE, c, c, gapped)
    with pytest.raises(ValueError, match="only a CUSTOM proposal is gapped"):
        api_mcmc.mcmc_cuda(
            program, McmcConfig(Mode.INDEPENDENCE, DistKind.NORMAL, c, 2, 0,
                                prop_gapped=True),
            torch.zeros(6), 1, plan_mcmc_grid(256))


def test_table_runs_need_their_tables():
    from tpu_montecarlo_torch.ops.mcmc_kernel import (
        McmcConfig,
        McmcProgram,
        Mode,
        plan_mcmc_grid,
    )
    from tpu_montecarlo_torch.sampling import DistKind

    program = McmcProgram((tm.trace_function(lambda x: x),))
    grid = plan_mcmc_grid(256)
    cfg = McmcConfig(Mode.RANDOM_WALK, DistKind.CUSTOM, DistKind.CUSTOM, 2, 0)
    params = torch.tensor([1.0, -1.0, 1.0, 0.44, 0.0, 0.0])
    with pytest.raises(ValueError, match="one DimTables entry"):
        mcmc_cuda(program, cfg, params, 1, grid)
    beta = DISTS["beta"](tm)
    wrong = tdevice.mcmc_dim_tables(beta, None, "cpu")  # a proposal's only
    with pytest.raises(ValueError, match="do not match its families"):
        mcmc_cuda(program, cfg, params, 1, grid, wrong)
    right = tdevice.mcmc_dim_tables(None, beta, "cpu")
    out = mcmc_cuda(program, cfg, params, 1, grid, right)
    assert out.x_final.shape == (1024,)
    normal = McmcConfig(Mode.RANDOM_WALK, DistKind.NORMAL, DistKind.NORMAL, 2, 0)
    with pytest.raises(ValueError, match="takes no tables"):
        mcmc_cuda(program, normal, params, 1, grid, right)


# -- the port's staged tables in the interpret-mode JAX kernel -----------------

# id: (target, proposal, walk, stderr): a table target and a table proposal
# in sampler mode, a gapped proposal, and an adaptive walk on a table.
KERNEL_CASES = {
    "sampler": ("bimodal", "beta", None, True),
    "gapped": ("bimodal", "wide-gap", None, False),
    "adaptive-walk": ("bimodal", None, dict(step_size=1.0, adapt=True,
                                           init_range=(-3.0, 3.0)), False),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_port_tables_in_the_jax_kernel_give_the_plain_chains(case):
    # build_mcmc_fn_pallas(..., interpret=True) fed the port's own host
    # tables as the JAX package's _prep takes them (the proposal's inverse
    # and second table, the target's and a gapped proposal's log tables),
    # against mcmc_reference on the same tables: the staging is the same
    # at the kernel's door, not only through the two public calls.
    import jax.numpy as jnp
    from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
    from tpu_montecarlo.sampling import DistKind as JKind
    from tpu_montecarlo.tracing import trace_function as j_trace

    from tpu_montecarlo_torch.ops.lower import to_torch
    from tpu_montecarlo_torch.ops.mcmc_kernel import (
        mcmc_finish,
        mcmc_reference,
        plan_chains,
        plan_mcmc_grid,
    )

    target_name, prop_name, walk, stderr = KERNEL_CASES[case]
    fns = [lambda x: x, lambda x: x * x]
    target = DISTS[target_name](tm)
    proposal = tm.RandomWalk(**walk) if walk else DISTS[prop_name](tm)
    integ = tm.MonteCarloIntegrator(device="cpu")
    program, cfg, params, tables = integ._mcmc_kernel_program(
        tuple(tm.trace_function(f) for f in fns), target, proposal, N_STEPS,
        N_BURNIN, stderr)
    gapped = cfg.compiled[3]
    dummy = jnp.zeros(1, jnp.float32)
    lx, lp = tdevice._device_uniform_log_tables(target)
    prop_tabs = [dummy] * 2 + [dummy] * 2
    if walk is None:
        spec = dist_spec_of(proposal)
        if gapped:
            t, dt = tdevice._device_gapped_tables(proposal, spec,
                                                  stratified=False)
            qx, qp = tdevice._device_uniform_log_tables(proposal, "proposal")
            prop_tabs = [t, dt, qx, qp]
        else:
            prop_tabs = [tdevice._mcmc_prop_inverse(proposal, spec), dummy,
                         dummy, dummy]
    run = build_mcmc_fn_pallas(
        tuple(j_trace(f) for f in fns), JKind.CUSTOM, JKind.CUSTOM, N_STEPS,
        N_BURNIN, plan_chains(N_CHAINS, None), interpret=True,
        prop_gapped=gapped, with_stderr=stderr, random_walk=walk is not None,
        rw_adapt=bool(walk and walk.get("adapt")), with_samples=N_STEPS)
    row = params.numpy()
    out = run(np.uint32(42), row[:4] if walk else row[:2], row[4:],
              *prop_tabs[:2], lx, lp, *prop_tabs[2:])
    x_jax = np.asarray(out[-1])[-1].reshape(-1)
    grid = plan_mcmc_grid(plan_chains(N_CHAINS, None))
    got = mcmc_reference([to_torch(f) for f in program.fns], cfg, params, 42,
                         grid, tables)
    x_port = got.x_final.numpy()
    split = np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    values, acc, _ = mcmc_finish(got, grid, cfg, len(fns))
    np.testing.assert_allclose(values.numpy(), np.asarray(out[0]),
                               rtol=0.0, atol=VALUE_ATOL)
    assert abs(float(acc) - float(out[1])) <= ACCEPT_ATOL
