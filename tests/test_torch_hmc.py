"""Hamiltonian Monte Carlo over one dimension in the port (``HMC``
proposals of ``integrate_mcmc``) against the JAX package.

* The position gradient: ``sampling.log_pdf_grad`` for the ten closed-form
  families against ``jax.grad`` of the JAX package's ``analytic_log_pdf``
  on a grid that holds each family's support edges, ties and the floor.
  Both evaluate the same expression (``jax.grad``'s jaxpr, op for op), so
  they differ only where torch's and XLA's ``log`` and ``exp`` differ in
  the last bit; near a zero of the gradient, where its terms cancel, that
  bit is the largest term's.  The gradient is held within GRAD_ULPS ulp of
  the largest term of its expression (the gradient itself where nothing
  cancels).  Both run one torch thread with float32 subnormals flushed, as
  XLA's CPU backend flushes them.
* A CUSTOM target's gradient, its log table's slope, against the JAX
  kernel's ``uniform_table_slope`` bit for bit.
* The kernel's copies (``csrc/log_pdf_grad.cuh``: the gradient and the
  leapfrog move), built with g++, against the torch versions: the gradient
  within GRAD_ULPS ulp of the largest term, the move's end state, its
  gradient there and log acceptance ratio within MOVE_RTOL.
* The plain version against the interpret-mode JAX kernel
  (``build_mcmc_fn_pallas(..., hmc_leapfrog=L)``, through the JAX
  package's ``backend="pallas"`` calls) for every closed-form family and
  CUSTOM targets, fixed and adaptive, over a short run, chain for chain as
  ``tests/test_torch_families_kernels.py`` holds the walks: at most
  MAX_SPLIT of the chains' final states more than 1e-4 (relative) apart,
  means within 1e-5 of the column's size, acceptance within ACCEPT_ATOL.
  A CUSTOM target's gradient is piecewise constant: a last-bit difference
  in the momentum (torch's and XLA's ``erfinv``) or in an adapted step
  (``exp``) moves a trajectory across a knot of the table in one version
  and not in the other, and from there the two trajectories differ.
  Measured over 40 steps: 0.4-0.9 % of the chains split at a fixed step,
  9.5 % under the adaptive step (whose ulp differences reach every
  chain), with or without the leapfrog's multiply-adds fused as XLA's CPU
  compiler fuses them.  So the CUSTOM cases hold at most TABLE_SPLIT[case]
  split and their means and acceptance within TABLE_ATOL, a few times the
  measured differences (up to 5.2e-4).
* The 1-D cases of ``tests/test_hmc.py`` run on the port, to their own
  tolerances.

The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import contextlib
import ctypes
import shutil
import subprocess
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo.ops.integrate_pallas import pad_uniform_table as j_pad
from tpu_montecarlo.ops.integrate_pallas import uniform_table_slope
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import analytic_log_pdf as j_analytic_log_pdf

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import mcmc as api_mcmc
from tpu_montecarlo_torch.ops.integrate_kernel import LANES
from tpu_montecarlo_torch.ops.mcmc_kernel import hmc_move, mcmc_cuda
from tpu_montecarlo_torch.ops.mcmc_tables import log_table, log_table_slope
from tpu_montecarlo_torch.sampling import (
    LOG_PDF_FLOOR,
    DistKind,
    analytic_log_pdf,
    log_pdf_grad,
)

CSRC = Path(__file__).resolve().parents[1] / "tpu_montecarlo_torch" / "csrc"
F32 = np.float32
GRAD_ULPS = 4
MOVE_RTOL = 1e-5
N_CHAINS, N_STEPS, N_BURNIN = 1024, 40, 10
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
ACCEPT_ATOL = 1e-4
MEAN_ATOL = 1e-5
TABLE_SPLIT = {"table": 0.015, "from-pdf": 0.01, "table-adaptive": 0.12}
TABLE_ATOL = 2e-3

PARAMS = {
    "uniform": (-1.0, 2.5),
    "normal": (0.5, 1.5),
    "exponential": (2.0, 0.0),
    "lognormal": (0.0, 0.5),
    "cauchy": (0.0, 1.0),
    "laplace": (3.0, 1.0),
    "logistic": (0.0, 2.0),
    "gumbel": (1.0, 0.5),
    "weibull": (1.5, 2.0),
    "pareto": (1.0, 3.0),
}


@contextlib.contextmanager
def _flushing_subnormals():
    """One torch thread with float32 subnormals flushed, as XLA's CPU
    backend runs (``tests/test_torch_tempering.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _grid(name):
    """Points over the family's body and tails, its support edges, the
    floor's region and the ties of its max and min."""
    p1, p2 = PARAMS[name]
    rs = np.random.default_rng(sum(map(ord, name)))
    edges = [p1, p2, 0.0, -0.0, 1e-30, -1e-30, 1e20, -1e20, 3e15, -3e15]
    near = [np.nextafter(F32(e), F32(s)) for e in (p1, p2, 0.0)
            for s in (-np.inf, np.inf)]
    return np.concatenate([
        rs.standard_normal(4000) * 4.0 + p1, rs.standard_cauchy(500) * 20.0,
        np.linspace(-12.0, 12.0, 2001), edges, near,
    ]).astype(F32)


def _term_scale(name, x):
    """The magnitude of the largest term of the gradient's expression at
    ``x`` (float64), where its terms cancel; None where none do."""
    p1, p2 = PARAMS[name]
    x = x.astype(np.float64)
    with np.errstate(all="ignore"):
        if name == "lognormal":
            d = np.maximum(x, 1e-30)
            return (1.0 + np.abs((np.log(d) - p1) / p2) / p2) / d
        if name == "logistic":
            return np.full_like(x, 3.0 / p2)
        if name == "gumbel":  # exp(-z) carries z's rounding too
            z = (x - p1) / p2
            return (1.0 + np.exp(-z) * (1.0 + np.abs(z))) / p2
        if name == "weibull":  # (x / lambda)^k carries k log(x / lambda)'s
            d = np.maximum(x, 1e-30)
            lt = np.log(d / p2)
            return (p1 * np.exp(p1 * lt) * (1.0 + p1 * np.abs(lt))
                    + abs(p1 - 1.0)) / d
    return None


def _assert_grad_close(name, x, got, want):
    ok = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), ok), name
    scale = np.abs(want[ok]).astype(np.float64)
    terms = _term_scale(name, x[ok])
    if terms is not None:
        scale = np.minimum(np.maximum(scale, terms), np.finfo(F32).max)
    with np.errstate(over="ignore"):
        tol = GRAD_ULPS * np.spacing(scale.astype(F32)).astype(np.float64)
    err = np.abs(got[ok].astype(np.float64) - want[ok].astype(np.float64))
    worst = int(np.argmax(err - tol))
    assert np.all(err <= tol), (name, x[ok][worst], got[ok][worst],
                                want[ok][worst])


# -- the gradient ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(PARAMS))
def test_family_gradient_matches_jax_grad(name):
    kind = DistKind[name.upper()]
    p1, p2 = (F32(p) for p in PARAMS[name])
    x = _grid(name)
    grad = jax.grad(lambda v: jnp.sum(j_analytic_log_pdf(JKind(int(kind)),
                                                         p1, p2, v)))
    want = np.asarray(grad(jnp.asarray(x)))
    with _flushing_subnormals():
        got = log_pdf_grad(kind, p1, p2, torch.from_numpy(x)).numpy()
    assert got.dtype == F32
    _assert_grad_close(name, x, got, want)
    # The gradient is 0 wherever the log density is the flat floor (every
    # family but the normal floors it), or NaN where jax.grad's is (the
    # Gumbel's far left, where exp(-z) overflows).
    if kind == DistKind.NORMAL:
        return
    with _flushing_subnormals():
        lp = analytic_log_pdf(kind, torch.tensor(p1), torch.tensor(p2),
                              torch.from_numpy(x)).numpy()
    floor = lp == LOG_PDF_FLOOR
    assert np.all((got[floor] == 0.0)
                  | (np.isnan(got[floor]) & np.isnan(want[floor])))


@pytest.mark.parametrize("name,x,want", [
    # Support edges and ties, where jax.grad's rules decide.
    ("exponential", 0.0, -2.0),        # x >= 0 holds at 0
    ("uniform", -1.0, 0.0),
    ("laplace", 3.0, -1.0),            # |x - mu| at mu: the slope of x >= mu
    ("pareto", 1.0, -2.0),             # max(x, x_min) ties: half of -4
    ("weibull", 0.0, 0.0),
    ("lognormal", 0.0, 0.0),
])
def test_gradient_at_support_edges_follows_jax_grad(name, x, want):
    kind = DistKind[name.upper()]
    p1, p2 = PARAMS[name]
    got = float(log_pdf_grad(kind, p1, p2, torch.tensor([x]))[0])
    grad = jax.grad(lambda v: j_analytic_log_pdf(JKind(int(kind)), F32(p1),
                                                 F32(p2), v))
    assert got == want == float(grad(F32(x)))


def _table_target():
    return tm.Distribution.beta(2.0, 5.0)


def test_table_slope_matches_jax_uniform_table_slope():
    from tpu_montecarlo_torch.api.device import _device_uniform_log_tables

    lx, lp = _device_uniform_log_tables(_table_target())
    tab = log_table(lx, lp, "cpu")
    rs = np.random.default_rng(5)
    x = np.concatenate([rs.uniform(-0.2, 1.2, 16 * LANES - 8),
                        [0.0, 1.0, lx[0], lx[-1], -1e-3, 1.5, 0.5, 1e20]])
    x = x.astype(F32)
    j_tab = j_pad(jnp.asarray(lx), jnp.asarray(lp), LOG_PDF_FLOOR)
    want = np.asarray(uniform_table_slope(
        jnp.asarray(x.reshape(-1, LANES)), j_tab, x.size // LANES,
        max_unroll_segments=4)).reshape(-1)
    got = log_table_slope(torch.from_numpy(x), tab).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[(x < lx[0]) | (x > lx[-1])] == 0.0)


# -- the kernel's copies, built with g++ ----------------------------------------

_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
static inline float erfinvf(float) { return 0.0f; }
#include "log_pdf_grad.cuh"

extern "C" void grads(int kind, float p1, float p2, const float* x, long n,
                      float* out) {
  for (long i = 0; i < n; ++i) out[i] = tmc::log_pdf_grad(kind, p1, p2, x[i]);
}

extern "C" void moves(int kind, float p1, float p2, const float* x,
                      const float* p0, long n, float eps, float* out) {
  auto value_grad = [&](const float (&v)[1], float (&g)[1]) {
    g[0] = tmc::log_pdf_grad(kind, p1, p2, v[0]);
    return tmc::log_pdf(kind, p1, p2, v[0]);
  };
  for (long i = 0; i < n; ++i) {
    const float xs[1] = {x[i]}, ps[1] = {p0[i]}, es[1] = {eps};
    float gs[1];
    const float logp = value_grad(xs, gs);
    const tmc::HmcProposal<1> h =
        tmc::hmc_move<5, 1>(xs, logp, gs, ps, es, 1.0f, value_grad);
    out[4 * i] = h.x[0];
    out[4 * i + 1] = h.logp;
    out[4 * i + 2] = h.g[0];
    out[4 * i + 3] = h.log_alpha;
  }
}
"""


@pytest.fixture(scope="module")
def host_hmc(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("hmc")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libhmc.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    f, p, n = ctypes.c_float, ctypes.c_void_p, ctypes.c_long
    lib.grads.argtypes = [ctypes.c_int, f, f, p, n, p]
    lib.moves.argtypes = [ctypes.c_int, f, f, p, p, n, f, p]
    lib.grads.restype = lib.moves.restype = None
    return lib


@pytest.mark.parametrize("name", list(PARAMS))
def test_kernel_gradient_and_move_match_plain_version(host_hmc, name):
    kind = DistKind[name.upper()]
    p1, p2 = PARAMS[name]
    x = _grid(name)
    x = x[np.abs(x) < 1e10]  # trajectories from here stay finite
    got = np.empty_like(x)
    host_hmc.grads(int(kind), p1, p2, x.ctypes.data, len(x), got.ctypes.data)
    want = log_pdf_grad(kind, p1, p2, torch.from_numpy(x)).numpy()
    _assert_grad_close(name, x, got, want)

    rs = np.random.default_rng(3)
    p0 = rs.standard_normal(len(x)).astype(F32)
    eps = 0.05
    out = np.empty(4 * len(x), F32)
    host_hmc.moves(int(kind), p1, p2, x.ctypes.data, p0.ctypes.data, len(x),
                   eps, out.ctypes.data)
    t1, t2 = torch.tensor(F32(p1)), torch.tensor(F32(p2))
    tx = torch.from_numpy(x)
    (xq,), logp, (g,), la = hmc_move(
        [tx], analytic_log_pdf(kind, t1, t2, tx),
        [log_pdf_grad(kind, t1, t2, tx)], [torch.from_numpy(p0)],
        [torch.tensor(F32(eps))], 5,
        lambda v: (analytic_log_pdf(kind, t1, t2, v[0]),
                   [log_pdf_grad(kind, t1, t2, v[0])]))
    for col, ref in enumerate((xq, logp, g, la)):
        ref = ref.numpy().astype(np.float64)
        host = out[col::4].astype(np.float64)
        ok = np.isfinite(ref) & (np.abs(ref) < 1e30)
        np.testing.assert_allclose(host[ok], ref[ok], rtol=MOVE_RTOL,
                                   atol=MOVE_RTOL)


# -- the plain version against the interpret-mode JAX kernel --------------------


def _target(pkg, spec):
    if spec == "table":
        return pkg.Distribution.beta(2.0, 5.0)
    if spec == "from_pdf":
        return pkg.Distribution.from_pdf(
            lambda x: np.exp(-0.5 * (x - 1.0) ** 2), support=(-5.0, 7.0))
    return getattr(pkg.Distribution, spec)(*(
        PARAMS[spec][:1] if spec == "exponential" else PARAMS[spec]))


# case: (target, step, n_leapfrog, adapt, init_range)
HMC_CASES = {
    "uniform": ("uniform", 0.4, 4, False, None),
    "normal": ("normal", 0.3, 5, False, None),
    "normal-adaptive": ("normal", 0.9, 8, True, None),
    "exponential": ("exponential", 0.1, 8, False, None),
    "lognormal": ("lognormal", 0.1, 6, False, None),
    "cauchy": ("cauchy", 0.5, 4, False, None),
    "laplace": ("laplace", 0.5, 6, False, None),
    "logistic-adaptive": ("logistic", 1.0, 5, True, None),
    "gumbel": ("gumbel", 0.2, 4, False, None),
    "weibull": ("weibull", 0.2, 5, False, None),
    "pareto": ("pareto", 0.05, 4, False, None),
    "table": ("table", 0.05, 8, False, None),
    "table-adaptive": ("table", 0.05, 8, True, None),
    "from-pdf": ("from_pdf", 0.4, 8, False, (-1.0, 3.0)),
}
FNS = [lambda x: x, lambda x: x * x]


def _hmc(pkg, case):
    _, step, n_leapfrog, adapt, init_range = HMC_CASES[case]
    return pkg.HMC(step_size=step, n_leapfrog=n_leapfrog, adapt=adapt,
                   init_range=init_range)


def _jax_hmc(case):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            FNS, _target(jmc, HMC_CASES[case][0]), _hmc(jmc, case),
            n_steps=N_STEPS, n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42,
            return_samples=N_STEPS)
    return r, np.asarray(r.samples[-1])


def _port_hmc(case, monkeypatch):
    outs = []

    def spy(*args):
        outs.append(mcmc_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_mcmc, "mcmc_cuda", spy)
    with _flushing_subnormals():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            FNS, _target(tm, HMC_CASES[case][0]), _hmc(tm, case),
            n_steps=N_STEPS, n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42)
    assert len(outs) == 1 and outs[0] is not None
    return r, outs[0].x_final.numpy()


def _split_share(x_port, x_jax):
    return float(np.mean(np.abs(x_port - x_jax)
                         > SPLIT_RTOL * (1.0 + np.abs(x_jax))))


@pytest.mark.parametrize("case", list(HMC_CASES))
def test_plain_hmc_matches_jax_interpret_kernel(case, monkeypatch):
    want, x_jax = _jax_hmc(case)
    got, x_port = _port_hmc(case, monkeypatch)
    assert x_port.shape == x_jax.shape
    split = _split_share(x_port, x_jax)
    assert split <= TABLE_SPLIT.get(case, MAX_SPLIT), (
        f"{split:.2%} of the chains split")
    size = np.maximum(np.abs(np.asarray(want.values)), 1.0)
    mean_tol, accept_tol = (
        (TABLE_ATOL, TABLE_ATOL) if case in TABLE_SPLIT
        else (MEAN_ATOL * size, ACCEPT_ATOL))
    assert np.all(np.abs(got.values - want.values) <= mean_tol), (
        got.values, want.values)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= accept_tol
    assert mcmc_cuda.hmc_launches == 0  # the CPU runs the plain version


# -- the JAX package's 1-D HMC tests on the port --------------------------------


@pytest.fixture(scope="module")
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


def _run(integ, fns, target, proposal, **kw):
    with _flushing_subnormals():
        return integ.integrate_mcmc(fns, target, proposal, **kw)


def test_normal_target_moments(integ):
    r = _run(integ, [lambda x: x, lambda x: x * x],
             tm.Distribution.normal(3.0, 2.0), tm.HMC(step_size=0.4, n_leapfrog=8),
             n_steps=2000, n_chains=1024, n_burnin=300, seed=7)
    assert abs(r.values[0] - 3.0) < 0.1
    assert abs(r.values[1] - 13.0) < 0.5
    assert 0.5 < r.acceptance_rate <= 1.0


def test_exponential_target(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.exponential(2.0),
             tm.HMC(step_size=0.1, n_leapfrog=8), n_steps=3000, n_chains=1024,
             n_burnin=500, seed=11)
    assert abs(r.values[0] - 0.5) < 0.05


def test_extended_family_target(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.laplace(2.0, 1.0),
             tm.HMC(step_size=0.5, n_leapfrog=6), n_steps=3000, n_chains=1024,
             n_burnin=500, seed=13)
    assert abs(r.values[0] - 2.0) < 0.1


def test_custom_table_target(integ):
    target = tm.Distribution.from_pdf(lambda x: np.exp(-0.5 * (x - 1.0) ** 2),
                                      support=(-5.0, 7.0))
    r = _run(integ, [lambda x: x, lambda x: (x - 1.0) ** 2], target,
             tm.HMC(step_size=0.4, n_leapfrog=8), n_steps=3000, n_chains=1024,
             n_burnin=500, seed=17)
    assert abs(r.values[0] - 1.0) < 0.1
    assert abs(r.values[1] - 1.0) < 0.15


def test_module_level_entry():
    with _flushing_subnormals():
        r = tm.integrate_mcmc([lambda x: x], tm.Distribution.normal(-1.0, 1.0),
                              tm.HMC(step_size=0.5, n_leapfrog=5), n_steps=1500,
                              n_chains=512, n_burnin=200, seed=19, device="cpu")
    assert abs(r.values[0] + 1.0) < 0.1


def test_exact_at_coarse_steps(integ):
    r = _run(integ, [lambda x: x * x], tm.Distribution.normal(0.0, 1.0),
             tm.HMC(step_size=1.8, n_leapfrog=3), n_steps=4000, n_chains=1024,
             n_burnin=500, seed=23)
    assert r.acceptance_rate < 0.9  # the integrator is coarse
    assert abs(r.values[0] - 1.0) < 0.06  # and the chain still exact


def test_adapts_down_from_huge_step(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.normal(3.0, 2.0),
             tm.HMC(step_size=8.0, n_leapfrog=5, adapt=True), n_steps=2000,
             n_chains=1024, n_burnin=800, seed=29)
    assert abs(r.values[0] - 3.0) < 0.15
    assert 0.65 < r.acceptance_rate < 0.95


def test_custom_target_accept(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.normal(0.0, 1.0),
             tm.HMC(step_size=2.0, n_leapfrog=5, adapt=True, target_accept=0.6),
             n_steps=2000, n_chains=1024, n_burnin=1000, seed=31)
    assert abs(r.acceptance_rate - 0.6) < 0.12


def test_mixes_faster_than_random_walk(integ):
    target = tm.Distribution.normal(0.0, 5.0)
    kw = dict(n_steps=400, n_chains=512, n_burnin=200, seed=37,
              return_diagnostics=True)
    r_hmc = _run(integ, [lambda x: x], target,
                 tm.HMC(step_size=1.0, n_leapfrog=10), **kw)
    r_rw = _run(integ, [lambda x: x], target, tm.RandomWalk(step_size=1.0), **kw)
    assert r_hmc.diagnostics["ess"][0] > 3 * r_rw.diagnostics["ess"][0]
    assert r_hmc.diagnostics["r_hat"][0] < 1.02


def test_stderr(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.normal(2.0, 1.0),
             tm.HMC(step_size=0.5, n_leapfrog=6), n_steps=1000, n_chains=1024,
             n_burnin=200, seed=41, return_stderr=True)
    assert r.stderr[0] > 0
    assert abs(r.values[0] - 2.0) < 6 * r.stderr[0]


def test_diagnostics(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.normal(0.0, 1.0),
             tm.HMC(step_size=0.6, n_leapfrog=8), n_steps=1000, n_chains=512,
             n_burnin=200, seed=43, return_diagnostics=True)
    assert r.diagnostics["r_hat"][0] < 1.02
    assert r.diagnostics["ess"][0] > 1000


def test_return_samples(integ):
    r = _run(integ, [lambda x: x], tm.Distribution.normal(1.0, 2.0),
             tm.HMC(step_size=0.4, n_leapfrog=8), n_steps=1000, n_chains=512,
             n_burnin=200, seed=47, return_samples=50)
    # The port's draws hold every chain the kernel runs (at least 1024),
    # as the JAX kernel's do.
    assert r.samples.shape == (50, 1024)
    assert abs(np.mean(r.samples) - 1.0) < 0.2
    assert abs(np.std(r.samples) - 2.0) < 0.3


def test_resume_fixed_step(integ):
    target = tm.Distribution.normal(3.0, 1.0)
    prop = tm.HMC(step_size=0.4, n_leapfrog=6)
    r1 = _run(integ, [lambda x: x], target, prop, n_steps=800, n_chains=512,
              n_burnin=200, seed=53, return_state=True)
    r2 = _run(integ, [lambda x: x], target, prop, n_steps=800, n_chains=512,
              n_burnin=0, seed=53, initial_state=r1.chain_state)
    assert abs(r1.values[0] - 3.0) < 0.1
    assert abs(r2.values[0] - 3.0) < 0.1


# -- the HMC object and what stays for later ------------------------------------


@pytest.mark.parametrize("kwargs", [
    {"n_leapfrog": 0},
    {"n_leapfrog": -3},
    {"step_size": 0.0},
    {"step_size": [0.5, -1.0]},
    {"init_range": (2.0, 1.0)},
])
def test_hmc_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jmc.HMC(**kwargs)
    with pytest.raises(ValueError) as got:
        tm.HMC(**kwargs)
    assert str(got.value) == str(want.value)


def test_hmc_object_matches_jax():
    kw = dict(step_size=0.3, n_leapfrog=7, adapt=True, target_accept=0.7,
              init_range=(-1.0, 2.0))
    j, t = jmc.HMC(**kw), tm.HMC(**kw)
    assert repr(t) == repr(j)
    assert repr(tm.HMC()) == repr(jmc.HMC())
    assert isinstance(t, tm.RandomWalk)
    back = tm.RandomWalk.from_reference(j)
    assert type(back) is tm.HMC and repr(back) == repr(j)
    target = tm.Distribution.normal(0.0, 1.0)
    np.testing.assert_array_equal(
        t.pack_params(target), j.pack_params(jmc.Distribution.normal(0.0, 1.0)))


def test_adaptive_hmc_needs_burn_in_and_no_state(integ):
    n = tm.Distribution.normal(0.0, 1.0)
    for kwargs in ({"n_burnin": 0}, {"return_state": True}):
        with pytest.raises(ValueError) as want:
            jmc.MonteCarloIntegrator().integrate_mcmc(
                [lambda x: x], jmc.Distribution.normal(0.0, 1.0),
                jmc.HMC(adapt=True), n_steps=10, **kwargs)
        with pytest.raises(ValueError) as got:
            integ.integrate_mcmc([lambda x: x], n, tm.HMC(adapt=True),
                                 n_steps=10, **kwargs)
        assert str(got.value) == str(want.value)
