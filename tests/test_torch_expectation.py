"""``expectation_fn``, 1-D and nd, in the port against the JAX package
(``tpu_montecarlo/api/integrate.py:301-405``) and against autograd.

* Values: an estimator without ``requires_grad`` is ``integrate``'s run,
  bit for bit, under ``mc``, ``antithetic`` and ``qmc``, 1-D and nd; the
  gradient build's value sums are the value build's, bit for bit.
* The plain gradient version against ``torch.autograd`` through the plain
  forward on the same uniforms, for the uniform, normal, exponential and
  every extended family, 1-D and nd: per sample, each pathwise term
  within 1e-6 relative (plus 1e-6 of the block's largest term, for the
  few terms a last-bit difference of ``log`` moves near a zero), and the
  sums over a run within 1e-6 of the sum of the terms' magnitudes.  The
  uniforms are the port's counter stream; autograd differentiates
  ``transform_from_u`` with the parameters as per-sample leaves (Cauchy's
  single-rounding ``fma_f32`` has no autograd rule, so its forward there
  is ``p1 + p2 * t``, the JAX package's own spelling).
* Against the JAX package's ``expectation_fn`` and ``jax.grad``: under
  ``qmc`` the port's kernel and the JAX package's XLA sweep
  (``tpu_montecarlo/ops/integrate_xla.py:45-76``) draw the points 0 ..
  N - 1 of one rotated radical inverse where both plans draw the same N.
  At the JAX tests' 400,000 samples they do not (the XLA plan draws
  458,752, the port's 256-row tiles round that to 524,288), so the
  comparison runs at 2**18, where both draw 262,144 points: values and
  gradients within 1e-5 relative (the normal's erfinv and the sums' order
  differ).  Under ``mc`` the streams differ (``jax.random`` keys there,
  the counter hash here): both are held to the closed forms at the JAX
  tests' tolerances (``tests/test_expectation_grad.py:49-113``,
  ``tests/test_nd.py:357-370``, ``tests/test_families.py:182-196``).
* Validation word for word (CUSTOM rejected, the params shape), and the
  second-order gradient and ``torch.func.vmap``, which raise naming
  ROADMAP item 10.
* The kernels' derivative functions (``tmc::ext_inv_grad``,
  ``tmc::transform_top_grad``, ``tmc::transform_pair_top_grad``) built
  with g++ against their torch twin on the same uniforms.
"""

import ctypes
import importlib
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch import sampling as tsamp
from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.ops.integrate_kernel import (
    CounterRng,
    IntegrateConfig,
    IntegrateProgram,
    integrate_grad_reference,
    integrate_reference,
    plan_grid,
    uniform_halfopen01,
    uniform_open01,
)
from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    integrate_nd_grad_reference,
    integrate_nd_reference,
)
from tpu_montecarlo_torch.ops.lower import to_torch, to_torch_grad
from tpu_montecarlo_torch.sampling import DistKind

F32 = np.float32
CPU = tm.MonteCarloIntegrator(device="cpu")
# The JAX tests' sample count, and the one where the two qmc plans draw
# the same points.
N = 400_000
N_QMC = 1 << 18
# Every analytic family at its factory's arguments (as the families'
# tests take them).
FAMILY_PARAMS = {
    DistKind.UNIFORM: (0.5, 2.0),
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
FNS = [lambda x: x, lambda x: x * x, lambda x: np.sin(x),
       lambda x: np.exp(-x * x), lambda x: x > 1.0, lambda x: abs(x)]


def _autograd_transform(u, kind, p1, p2):
    """transform_from_u for autograd: Cauchy's inverse as ``p1 + p2 *
    t`` (its fma_f32 has no autograd rule), the others as they are."""
    if kind == DistKind.CAUCHY:
        t = tsamp.fast_tan(tsamp._PI_F * (tsamp._clip_u(u) - 0.5))
        return p1 + p2 * t
    return tsamp.transform_from_u(u, kind, p1, p2)


def _uniforms(kind, seed=3):
    """Two tiles' worth of the counter stream: (0, 1] for the
    exponential, [0, 1) for the others (the kernels' convention)."""
    draw = uniform_open01 if kind == DistKind.EXPONENTIAL else uniform_halfopen01
    return draw(CounterRng(seed, 0), (512, 128), 0, 0)


def _close_terms(plain, auto, what):
    """Per-sample terms within 1e-6 relative plus 1e-6 of the largest."""
    big = float(auto.abs().max())
    np.testing.assert_allclose(plain.numpy(), auto.numpy(), rtol=1e-6,
                               atol=1e-6 * big, err_msg=what)


# -- values: integrate's run, bit for bit ----------------------------------------------


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_values_are_integrates_bit_for_bit(method):
    for d, p in [(tm.Distribution.normal(1.5, 2.0), [1.5, 2.0]),
                 (tm.Distribution.uniform(0.0, 2.0), [0.0, 2.0]),
                 (tm.Distribution.gumbel(1.0, 0.5), [1.0, 0.5])]:
        est = CPU.expectation_fn(FNS, d, n_samples=100_000, method=method)
        vals = est(torch.tensor(p), seed=7)
        ref = CPU.integrate(FNS, d, n_samples=100_000, seed=7, method=method)
        assert vals.dtype == torch.float32 and vals.shape == (len(FNS),)
        np.testing.assert_array_equal(vals.numpy(), F32(ref.values))
        # The gradient build's values: the same bits.
        pg = torch.tensor(p, requires_grad=True)
        np.testing.assert_array_equal(est(pg, seed=7).detach().numpy(),
                                      F32(ref.values))


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_nd_values_are_integrates_bit_for_bit(method):
    dims = [tm.Distribution.normal(0.0, 1.0), tm.Distribution.uniform(0, 1),
            tm.Distribution.exponential(2.0)]
    fns = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
    rows = torch.tensor([[0.0, 1.0], [0.0, 1.0], [2.0, 0.0]])
    est = CPU.expectation_fn(fns, dims, n_samples=100_000, method=method)
    ref = CPU.integrate(fns, dims, n_samples=100_000, seed=5, method=method)
    np.testing.assert_array_equal(est(rows, seed=5).numpy(), F32(ref.values))
    np.testing.assert_array_equal(
        est(rows.clone().requires_grad_(), seed=5).detach().numpy(),
        F32(ref.values))


def test_single_element_sequence_is_the_scalar_estimator():
    nx = tm.Distribution.normal(0.0, 1.0)
    e1 = CPU.expectation_fn([lambda x: x * x], [nx], n_samples=100_000)
    e2 = CPU.expectation_fn([lambda x: x * x], nx, n_samples=100_000)
    p = torch.tensor([0.3, 1.1])
    assert torch.equal(e1(p), e2(p))


def test_wide_set_gradient_groups_take_the_value_builds_loop(monkeypatch):
    """33 functions are one value group on the kernel's run-time position
    loop (17 or more) and two gradient groups of 17 and 16: the second
    is compiled onto the same loop (``wide_loop``), so its value sums are
    the value build's; the gradient concatenates the groups'."""
    # The module, not the package's ``integrate`` function of that name.
    api_integrate = importlib.import_module("tpu_montecarlo_torch.api.integrate")
    seen = []
    real = api_integrate.integrate_grad_cuda

    def spy(program, kind, row, word, grid, cfg):
        seen.append((len(program.fns), cfg.wide_loop))
        return real(program, kind, row, word, grid, cfg)

    monkeypatch.setattr(api_integrate, "integrate_grad_cuda", spy)
    fns = [(lambda c: lambda x: x * x + c * x)(0.1 * j) for j in range(33)]
    est = CPU.expectation_fn(fns, tm.Distribution.normal(0.0, 1.0),
                             n_samples=1 << 15)
    leaf = torch.tensor([0.5, 1.5], requires_grad=True)
    vals = est(leaf)
    assert seen == [(17, False), (16, True)]
    ref = CPU.integrate(fns, tm.Distribution.normal(0.5, 1.5),
                        n_samples=1 << 15)
    np.testing.assert_array_equal(vals.detach().numpy(), F32(ref.values))
    (g,) = torch.autograd.grad(vals[32], leaf)
    # d/dm E[x^2 + c x] = 2m + c, d/ds = 2s, c = 3.2.
    np.testing.assert_allclose(g.numpy(), [4.2, 3.0], atol=0.05)


# -- the plain gradient against autograd --------------------------------------------------


@pytest.mark.parametrize("kind", list(FAMILY_PARAMS), ids=lambda k: k.name)
def test_plain_derivatives_match_autograd_per_sample(kind):
    """The plain twin's x (transform_from_u's, bit for bit) and each
    pathwise term f'(x) dx/dp against autograd with per-sample parameter
    leaves, on the same uniforms; then their sums."""
    p1, p2 = (torch.tensor(v, dtype=torch.float32) for v in FAMILY_PARAMS[kind])
    u = _uniforms(kind)
    x, d1, d2 = tsamp.transform_grad_from_u(u, kind, p1, p2)
    assert torch.equal(x, tsamp.transform_from_u(u, kind, p1, p2))
    for f in FNS:
        traced = tm.trace_function(f)
        value, (g,) = to_torch_grad(traced)(x)
        assert torch.equal(value, to_torch(traced)(x))
        a1 = p1.expand(u.shape).clone().requires_grad_()
        a2 = p2.expand(u.shape).clone().requires_grad_()
        v = to_torch(traced)(_autograd_transform(u, kind, a1, a2))
        want = (torch.autograd.grad(v.sum(), [a1, a2], allow_unused=True)
                if v.requires_grad else (None, None))
        for c, (d, w) in enumerate(zip((d1, d2), want)):
            w = torch.zeros_like(u) if w is None else w
            _close_terms(g * d, w, f"{kind.name} parameter {c}")
            assert abs(float((g * d).double().sum() - w.double().sum())) <= (
                1e-6 * float(w.abs().double().sum()) + 1e-30)


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_plain_gradient_run_matches_autograd(method):
    """The gradient build's plain version over a whole run against
    autograd through ``integrate_reference`` with the parameters as
    leaves: integrands whose pathwise terms keep one sign, so the sums
    hold 1e-6 relative."""
    fns = [lambda x: x * x, lambda x: np.exp(0.5 * x)]
    prog = IntegrateProgram(tuple(tm.trace_function(f) for f in fns))
    grid = plan_grid(1 << 17, method)
    for kind, p in [(DistKind.NORMAL, (0.5, 1.5)),
                    (DistKind.UNIFORM, (0.5, 2.0)),
                    (DistKind.EXPONENTIAL, (2.0, 0.0)),
                    (DistKind.LOGNORMAL, (0.0, 0.5)),
                    (DistKind.PARETO, (1.0, 3.0))]:
        params = torch.tensor(p)
        sums, grads = integrate_grad_reference(
            prog, kind, params, 11, grid, IntegrateConfig(method, grad=True))
        leaf = params.clone().requires_grad_()
        ref = integrate_reference(prog.torch_values, kind, leaf, 11, grid,
                                  IntegrateConfig(method))
        np.testing.assert_array_equal(sums.numpy(), ref.detach().numpy())
        for j in range(len(fns)):
            (want,) = torch.autograd.grad(ref[j], leaf, retain_graph=True)
            np.testing.assert_allclose(grads[j].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-30,
                                       err_msg=f"{kind.name} f{j} {method}")


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_nd_plain_gradient_matches_autograd(method):
    """nd: the plain gradient version against autograd through
    ``integrate_nd_reference``, every analytic family as a dimension
    beside N(0.5, 1.5)."""
    fns = [lambda x, y: x * x + y * y, lambda x, y: np.exp(0.25 * (x + y))]
    grid = plan_grid(1 << 16, method)
    for kind, p in FAMILY_PARAMS.items():
        if kind == DistKind.CAUCHY:
            continue  # fma_f32 has no autograd rule: the per-sample test
        kinds = (DistKind.NORMAL, kind)
        prog = IntegrateNdProgram(
            tuple(tm.trace_function(f, 2) for f in fns), kinds)
        rows = torch.tensor([[0.5, 1.5], list(p)])
        sums, grads = integrate_nd_grad_reference(
            prog.torch_grads, NdConfig(kinds, method, grad=True), rows, 2,
            grid)
        leaf = rows.clone().requires_grad_()
        ref = integrate_nd_reference(prog.torch_fns, NdConfig(kinds, method),
                                     leaf, 2, grid)
        np.testing.assert_array_equal(sums.numpy(), ref.detach().numpy())
        for j in range(len(fns)):
            (want,) = torch.autograd.grad(ref[j], leaf, retain_graph=True)
            np.testing.assert_allclose(grads[j].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kind.name} f{j} {method}")


def test_nd_plain_derivatives_per_sample_every_family():
    """Each family as an nd dimension: the nd draws' derivatives are the
    1-D twin's, per sample, and the pathwise terms of a 2-ary integrand
    match autograd with per-sample leaves (Cauchy and the uniform
    included)."""
    from tpu_montecarlo_torch.ops.integrate_nd_kernel import nd_draws_grad

    grid = plan_grid(1 << 15)
    tiles = torch.arange(1)
    traced = tm.trace_function(lambda x, y: x * y + 0.5 * y * y, 2)
    for kind, p in FAMILY_PARAMS.items():
        kinds = (DistKind.NORMAL, kind)
        rows = torch.tensor([[0.5, 1.5], list(p)])
        cfg = NdConfig(kinds, "mc", grad=True)
        ((xs, ds),) = nd_draws_grad(cfg, rows, 9, grid, tiles)
        _, gs = to_torch_grad(traced)(*xs)
        u = uniform_open01 if kind == DistKind.EXPONENTIAL else uniform_halfopen01
        u1 = u(CounterRng(9, tiles), (256, 128), tiles, 1)
        leaves = [rows[1, c].expand(u1.shape).clone().requires_grad_()
                  for c in (0, 1)]
        y = _autograd_transform(u1, kind, *leaves)
        v = to_torch(traced)(xs[0], y)
        want = torch.autograd.grad(v.sum(), leaves, allow_unused=True)
        for c in (0, 1):
            w = torch.zeros_like(y) if want[c] is None else want[c]
            _close_terms(gs[1] * ds[1][c], w, f"nd {kind.name} parameter {c}")


# -- against the JAX package's expectation_fn and jax.grad -------------------------------


@pytest.mark.parametrize("family", ["normal", "uniform"])
def test_qmc_matches_jax_on_the_same_points(family):
    """Under qmc at 2**18 the two draw the same points (module
    docstring): values and gradients within 1e-5 relative."""
    p = [1.0, 2.0] if family == "normal" else [0.0, 2.0]
    fns = [lambda x: x * x, lambda x: np.exp(0.5 * x)]
    jd = getattr(jmc.Distribution, family)(*p)
    jest = jmc.expectation_fn(fns, jd, n_samples=N_QMC, method="qmc")
    jp = jnp.asarray(p, jnp.float32)
    jvals = np.asarray(jest(jp, seed=7))
    jgrads = np.stack([np.asarray(jax.grad(lambda q, i=i: jest(q, seed=7)[i])(jp))
                       for i in range(len(fns))])
    est = CPU.expectation_fn(fns, getattr(tm.Distribution, family)(*p),
                             n_samples=N_QMC, method="qmc")
    leaf = torch.tensor(p, requires_grad=True)
    vals = est(leaf, seed=7)
    grads = torch.stack([torch.autograd.grad(vals[i], leaf, retain_graph=True)[0]
                         for i in range(len(fns))])
    np.testing.assert_allclose(vals.detach().numpy(), jvals, rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), jgrads, rtol=1e-5)


def _grad(est, p, i=0, seed=42):
    leaf = torch.tensor(p, dtype=torch.float32, requires_grad=True)
    est(leaf, seed=seed)[i].backward()
    return leaf.grad.numpy()


def _jgrad(jest, p, i=0):
    return np.asarray(jax.grad(lambda q: jest(q)[i])(jnp.asarray(p, jnp.float32)))


# name: (functions, family, params, closed-form gradient of f0, tolerance),
# the JAX tests' cases and tolerances.
MC_CASES = {
    "normal_second_moment": ([lambda x: x * x], "normal", [1.0, 2.0],
                             [2.0, 4.0], 0.05),
    "uniform_mean": ([lambda x: x], "uniform", [-1.0, 3.0], [0.5, 0.5], 0.01),
    "exponential_mean": ([lambda x: x], "exponential", [2.0, 0.0],
                         [-0.25, None], 0.01),
    "lognormal_mean": ([lambda x: x], "lognormal", [0.0, 0.5],
                       [math.exp(0.125), 0.5 * math.exp(0.125)], 0.03),
}


@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_gradients_match_jax_statistically(case):
    fns, family, p, want, tol = MC_CASES[case]
    ctor = p[:1] if family == "exponential" else p
    est = tm.expectation_fn(fns, getattr(tm.Distribution, family)(*ctor),
                            n_samples=N, device="cpu")
    jest = jmc.expectation_fn(fns, getattr(jmc.Distribution, family)(*ctor),
                              n_samples=N)
    for g in (_grad(est, p), _jgrad(jest, p)):
        for got, w in zip(g, want):
            if w is not None:
                assert abs(got - w) < tol, (case, g)


def test_qmc_gradient_of_the_second_moment():
    est = CPU.expectation_fn([lambda x: x * x], tm.Distribution.normal(0, 1),
                             n_samples=N, method="qmc")
    g = _grad(est, [1.0, 2.0])
    assert abs(g[0] - 2.0) < 0.01 and abs(g[1] - 4.0) < 0.01


def test_nd_value_and_gradients_match_jax_statistically():
    nx = tm.Distribution.normal(0.0, 1.0)
    est = CPU.expectation_fn([lambda x, y: x * y], [nx, nx], n_samples=N)
    jn = jmc.Distribution.normal(0.0, 1.0)
    jest = jmc.MonteCarloIntegrator().expectation_fn(
        [lambda x, y: x * y], [jn, jn], n_samples=N)
    p = [[1.0, 1.0], [3.0, 2.0]]
    leaf = torch.tensor(p, requires_grad=True)
    v = est(leaf)
    v[0].backward()
    jp = jnp.asarray(p, jnp.float32)
    jg = np.asarray(jax.grad(lambda q: jest(q)[0])(jp))
    for val, g in ((float(v[0].detach()), leaf.grad.numpy()),
                   (float(jest(jp)[0]), jg)):
        # E[XY] = m1 m2: d/dm1 = m2 = 3, d/dm2 = m1 = 1, d/ds = 0.
        assert abs(val - 3.0) < 0.05
        assert abs(g[0, 0] - 3.0) < 0.05 and abs(g[1, 0] - 1.0) < 0.05
        assert abs(g[0, 1]) < 0.05


def test_indicator_gets_zero_pathwise_gradient():
    est = CPU.expectation_fn([lambda x: x > 1.0, lambda x: x > 1.0],
                             tm.Distribution.normal(0, 1), n_samples=100_000)
    g = _grad(est, [0.0, 1.0])
    assert np.array_equal(g, [0.0, 0.0])


# -- validation and what is not ported ------------------------------------------------


def test_custom_rejected_with_the_jax_message():
    with pytest.raises(ValueError, match="expectation_fn applies") as port:
        tm.expectation_fn([lambda x: x], tm.Distribution.beta(2.0, 5.0),
                          device="cpu")
    with pytest.raises(ValueError) as jax_e:
        jmc.expectation_fn([lambda x: x], jmc.Distribution.beta(2.0, 5.0))
    assert str(port.value) == str(jax_e.value)
    with pytest.raises(ValueError, match="expectation_fn applies"):
        CPU.expectation_fn([lambda x, y: x],
                           [tm.Distribution.normal(0, 1),
                            tm.Distribution.beta(2.0, 5.0)])


def test_params_shape_checked_word_for_word():
    est = CPU.expectation_fn([lambda x: x], tm.Distribution.normal(0, 1),
                             n_samples=N)
    jest = jmc.expectation_fn([lambda x: x], jmc.Distribution.normal(0, 1),
                              n_samples=N)
    for bad in (np.asarray([2.0], F32), np.zeros((3, 2), F32)):
        with pytest.raises(ValueError, match=r"\(2,\) params") as port:
            est(torch.from_numpy(bad))
        with pytest.raises(ValueError) as jax_e:
            jest(jnp.asarray(bad))
        assert str(port.value) == str(jax_e.value)
    nx = tm.Distribution.normal(0, 1)
    nd = CPU.expectation_fn([lambda x, y: x + y], [nx, nx], n_samples=N)
    with pytest.raises(ValueError,
                       match=r"expected a \(2, 2\) params array .*\(2,\)"):
        nd(torch.zeros(2))


def test_second_order_and_vmap_name_item_10():
    est = CPU.expectation_fn([lambda x: x * x], tm.Distribution.normal(0, 1),
                             n_samples=100_000)
    item = "ROADMAP.md, queue 1 item 10 "
    leaf = torch.tensor([0.3, 1.2], requires_grad=True)
    with pytest.raises(NotImplementedError, match=item):
        torch.autograd.grad(est(leaf)[0], leaf, create_graph=True)
    grid = torch.tensor([[m, 1.0] for m in (-1.0, 0.0, 2.0)])
    with pytest.raises(NotImplementedError, match=item):
        torch.func.vmap(est)(grid)
    # First order without a graph of the gradient runs, on float64 leaves
    # too (the gradient comes back in the leaf's type).
    leaf64 = torch.tensor([0.3, 1.2], dtype=torch.float64, requires_grad=True)
    est(leaf64)[0].backward()
    assert leaf64.grad.dtype == torch.float64


# -- the kernels' derivative functions, built with g++ -----------------------------------

_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
// erfinv in double by Newton steps on erf, rounded: a float32 erfinv that
// is exact but for its last rounding.
static inline float erfinvf(float x) {
  double y = x, w = -log((1.0 - y) * (1.0 + y)), z;
  z = w < 5.0 ? 0.5 * sqrt(w) : sqrt(w) - 1.0;
  z = y < 0 ? -z : z;
  for (int i = 0; i < 60; ++i) {
    const double step = (erf(z) - y) / (1.1283791670955126 * exp(-z * z));
    z -= step;
    if (fabs(step) < 1e-17 * (1.0 + fabs(z))) break;
  }
  return float(z);
}
#include "integrate_draw.cuh"

extern "C" void inv_grad(int kind, float p1, float p2, const float* u, long n,
                         float* x, float* d1, float* d2) {
  for (long i = 0; i < n; ++i) x[i] = tmc::ext_inv_grad(kind, u[i], p1, p2, d1[i], d2[i]);
}

extern "C" void top_grad(int kind, float p1, float p2, const uint32_t* top,
                         long n, float* x, float* d, float* y, float* e) {
  const tmc::Family f = tmc::family(p1, p2);
  for (long i = 0; i < n; ++i) {
    x[i] = tmc::transform_top_grad(kind, top[i], f, d + 2 * i);
    tmc::transform_pair_top_grad(kind, top[i], f, x[n + i], y[i], e + 2 * i,
                                 e + 2 * (n + i));
  }
}
"""


@pytest.fixture(scope="module")
def host_grads(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("grads")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libgrads.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    f, p, n = ctypes.c_float, ctypes.c_void_p, ctypes.c_long
    lib.inv_grad.argtypes = [ctypes.c_int, f, f, p, n, p, p, p]
    lib.top_grad.argtypes = [ctypes.c_int, f, f, p, n, p, p, p, p]
    lib.inv_grad.restype = lib.top_grad.restype = None
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("kind", list(FAMILY_PARAMS), ids=lambda k: k.name)
def test_kernel_derivatives_match_their_torch_twin(host_grads, kind):
    """transform_top_grad, the antithetic pair's and (extended families)
    ext_inv_grad on 2**16 mantissas through both tails, against
    ``transform_grad_from_u``: the samples within the affine steps' one
    fused rounding (1 ulp of the larger term) or the libraries' last
    bits, the derivatives within 1e-5 relative plus 1e-6 of the largest
    (the extended families' log and exp in the two libraries)."""
    p1, p2 = FAMILY_PARAMS[kind]
    m = np.unique(np.concatenate([
        np.arange(1 << 12), (1 << 24) - 1 - np.arange(1 << 12),
        np.linspace(0, (1 << 24) - 1, 1 << 15).astype(np.int64)]))
    n = len(m)
    top = (m.astype(np.uint32) << np.uint32(8))
    x = np.zeros(2 * n, F32)
    d = np.zeros((n, 2), F32)
    y = np.zeros(n, F32)
    e = np.zeros((2 * n, 2), F32)
    host_grads.top_grad(int(kind), F32(p1), F32(p2), _ptr(top), n, _ptr(x),
                        _ptr(d), _ptr(y), _ptr(e))
    u = torch.from_numpy((m + (kind == DistKind.EXPONENTIAL)).astype(F32)
                         * F32(2.0 ** -24))
    tp1, tp2 = torch.tensor(p1), torch.tensor(p2)
    if kind == DistKind.NORMAL:
        z = tsamp.normal_from_u01(u)
        want = [(tp1 + tp2 * z, torch.ones_like(z), z),
                (tp1 - tp2 * z, torch.ones_like(z), -z)]
    else:
        want = [tsamp.transform_grad_from_u(u, kind, tp1, tp2),
                tsamp.transform_grad_from_u(1.0 - u, kind, tp1, tp2)]
    got = [(x[:n], d[:, 0], d[:, 1]), (y, e[n:, 0], e[n:, 1])]
    for (gx, g1, g2), (wx, w1, w2) in zip(got, want):
        wx = wx.numpy()
        np.testing.assert_allclose(gx, wx, rtol=4e-6,
                                   atol=2e-7 * max(abs(p1), 1.0))
        for g, w in ((g1, w1.numpy()), (g2, w2.numpy())):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
    # The pair's first member is the draw, with its derivatives.
    assert np.array_equal(x[:n], x[n:]) and np.array_equal(e[:n], d)
    if kind in tsamp.ANALYTIC_EXT:
        uu = u.numpy()
        xi, e1, e2 = (np.zeros(n, F32) for _ in range(3))
        host_grads.inv_grad(int(kind), F32(p1), F32(p2), _ptr(uu), n,
                            _ptr(xi), _ptr(e1), _ptr(e2))
        np.testing.assert_array_equal(xi, x[:n])
