"""The seven extended families (lognormal, Cauchy, Laplace, logistic,
Gumbel, Weibull, Pareto) in the port against the JAX package: the
registry rows, the factories, the quantiles and what is built on them.

* The inverse CDFs on kernel uniforms ``m * 2**-24`` (both tails in full,
  a stride through the middle; Cauchy on every one) and the clamp edges,
  against the JAX rows under jit (as the interpret-mode kernels run
  them).  Cauchy is bit-equal: the port copies the JAX package's tangent
  polynomial with the fused multiply-adds XLA's CPU compiler makes of it.
  The others differ only by the float32 ``log``, ``exp`` and ``erfinv`` of
  the two libraries (and by the fused multiply-adds of the affine steps):
  each is held to the float64 evaluation of the same formula within
  PORT_ULPS ulp of its scale (the affine step's larger term for the
  location families, the sample for the others), the JAX package within
  JAX_ULPS (measured: its float32 ``log`` and ``exp`` are coarser), and the
  two to each other within the sum.  The lognormal is the exponential of a
  normal and is held in the log domain, to the normal's erfinv tolerance
  (``tests/test_torch_sampling.py``).
* The log densities, on the samples and on wild inputs, within 2e-6
  relative plus 2e-6 absolute (the Pareto density's log cancels to 0 at
  one x), all finite.
* The kernels' copy of each row (``csrc/counter_rng.cuh``), built here
  with g++, against the plain version on the same uniforms: Cauchy
  bit-equal over all 2**24 mantissas, the others within their libm
  bound.
* Factories, validation errors word for word, ``params`` and ``support``,
  the pdf closures, ``quantile`` to 1e-12, ``from_reference``,
  ``dist_spec_of``, a mixture of Cauchy components, and the random walk's
  start ranges over each family.
"""

import ctypes
import math
import shutil
import subprocess
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import tpu_montecarlo as jmc
from tpu_montecarlo import sampling as jsamp
from tpu_montecarlo.ops import fast_math as jfast

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch import sampling as tsamp
from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.sampling import ANALYTIC_EXT, DistKind

F32 = np.float32
# name: factory arguments, as the chip smoke test and the kernel tests use
# them.
FAMILIES = {
    "lognormal": (0.0, 0.5),
    "cauchy": (0.0, 1.0),
    "laplace": (3.0, 1.0),
    "logistic": (0.0, 2.0),
    "gumbel": (1.0, 0.5),
    "weibull": (1.5, 2.0),
    "pareto": (1.0, 3.0),
}
NAMES = list(FAMILIES)
# Parameters the rows are held at: each family's own, and a second pair.
ROW_PARAMS = {
    "lognormal": [(0.0, 0.5), (0.3, 1.7)],
    "cauchy": [(0.0, 1.0), (0.3, 1.7), (-5.0, 0.01), (1e4, 3.0)],
    "laplace": [(3.0, 1.0), (-0.7, 0.3)],
    "logistic": [(0.0, 2.0), (1.3, 0.6)],
    "gumbel": [(1.0, 0.5), (-2.0, 3.0)],
    "weibull": [(1.5, 2.0), (0.5, 1.0)],
    "pareto": [(1.0, 3.0), (0.5, 1.2)],
}
LOCATION = {"cauchy", "laplace", "logistic", "gumbel"}
# Largest gaps, in ulp of each sample's scale: the port against float64,
# the JAX package against float64 (both measured on this grid, with a
# margin), and the two packages against each other.
PORT_ULPS = {"laplace": 4, "logistic": 4, "gumbel": 4, "weibull": 20,
             "pareto": 16}
JAX_ULPS = {"laplace": 4, "logistic": 4, "gumbel": 4, "weibull": 24,
            "pareto": 20}
# The kernels' rows (glibc's logf and expf here) against the plain
# version's, in ulp of the scale: each within PORT_ULPS of the formula.
HOST_ULPS = {name: 2 * ulps for name, ulps in PORT_ULPS.items()}
LOG_PDF_RTOL = LOG_PDF_ATOL = 2e-6
# The normal's erfinv tolerance (tests/test_torch_sampling.py), in z.
Z_ATOL = 5e-5


def _mantissas(every: bool) -> np.ndarray:
    """Kernel mantissas m: all 2**24, or both tails in full and a stride
    through the middle."""
    if every:
        return np.arange(1 << 24, dtype=np.int64)
    return np.concatenate([
        np.arange(0, 1 << 16),
        np.arange(1 << 16, (1 << 24) - (1 << 16), 97),
        np.arange((1 << 24) - (1 << 16), 1 << 24),
    ]).astype(np.int64)


def _kernel_uniforms(every: bool = False) -> np.ndarray:
    """The kernel uniforms m * 2**-24 and the clamp edges."""
    u = _mantissas(every).astype(F32) * F32(2.0**-24)
    lo, hi = F32(1e-7), F32(1.0 - 1e-7)
    edges = np.array([1.0, lo, np.nextafter(lo, F32(0)), np.nextafter(lo, F32(1)),
                      hi, np.nextafter(hi, F32(1)), 1e-30, 0.5], F32)
    return np.concatenate([u, edges])


@pytest.fixture(scope="module")
def uniforms():
    return _kernel_uniforms()


def _jax_inv(name, u, p1, p2):
    row = jsamp.ANALYTIC_EXT[jsamp.DistKind[name.upper()]]
    return np.asarray(jax.jit(lambda v: row.inv_cdf(v, F32(p1), F32(p2)))(u))


def _port_inv(name, u, p1, p2):
    row = ANALYTIC_EXT[DistKind[name.upper()]]
    return row.inv_cdf(torch.from_numpy(u), torch.tensor(p1),
                       torch.tensor(p2)).numpy()


def _truth(name, u, p1, p2):
    """The row's formula in float64 on the float32 inputs, with the float32
    roundings of its exact or correctly rounded steps (the clamp, u - 0.5,
    1 - 2|t|, 1 - u, the logistic's u / (1 - u))."""
    p1, p2 = float(F32(p1)), float(F32(p2))
    uc = np.clip(u, F32(1e-7), F32(1.0 - 1e-7))
    d = uc.astype(np.float64)
    if name == "laplace":
        t = (uc - F32(0.5)).astype(F32)
        inner = (F32(1.0) - F32(2.0) * np.abs(t)).astype(np.float64)
        mag = -np.log(inner)
        return p1 + p2 * np.where(t >= 0, mag, -mag)
    if name == "logistic":
        ratio = (uc / (F32(1.0) - uc)).astype(F32)
        return p1 + p2 * np.log(ratio.astype(np.float64))
    if name == "gumbel":
        return p1 - p2 * np.log(-np.log(d))
    if name == "weibull":
        return p2 * (-np.log(d)) ** (1.0 / p1)
    if name == "pareto":
        return p1 * d ** (-1.0 / p2)
    raise ValueError(name)


def _scale_ulps(name, got, want, p1):
    """|got - want| in ulp of the sample's scale."""
    want = np.asarray(want, np.float64)
    scale = (np.maximum(abs(float(F32(p1))), np.abs(want - float(F32(p1))))
             if name in LOCATION else np.abs(want))
    return np.abs(np.asarray(got, np.float64) - want) / np.spacing(
        scale.astype(F32)).astype(np.float64)


# -- the inverse CDFs -----------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_inverse_cdf_matches_jax(name, uniforms):
    if name == "cauchy":  # bit for bit at every kernel uniform
        uniforms = _kernel_uniforms(every=True)
    for p1, p2 in ROW_PARAMS[name]:
        got = _port_inv(name, uniforms, p1, p2)
        want = _jax_inv(name, uniforms, p1, p2)
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        if name == "cauchy":
            np.testing.assert_array_equal(got, want)
            # The clamp keeps the draws inside the 1e-7 quantiles, where the
            # polynomial's cosine, near its zero, doubles the extreme draw.
            assert np.abs(got - F32(p1)).max() < 7e6 * p2
            continue
        if name == "lognormal":
            # exp(p1 + p2 z): z to the normal's erfinv tolerance.
            assert np.all(got > 0)
            np.testing.assert_allclose(np.log(got.astype(np.float64)),
                                       np.log(want.astype(np.float64)),
                                       rtol=0, atol=Z_ATOL * p2 + 1e-6)
            continue
        truth = _truth(name, uniforms, p1, p2)
        port = _scale_ulps(name, got, truth, p1).max()
        jax_ = _scale_ulps(name, want, truth, p1).max()
        assert port <= PORT_ULPS[name], port
        assert jax_ <= JAX_ULPS[name], jax_
        both = _scale_ulps(name, got, want, p1).max()
        assert both <= PORT_ULPS[name] + JAX_ULPS[name], both


def test_fast_tan_matches_jax_under_jit():
    # Past Cauchy's own arguments: several periods, k rounded half to even.
    rs = np.random.default_rng(5)
    x = np.concatenate([rs.uniform(-50.0, 50.0, 200_000),
                        np.arange(-20, 21) * np.pi / 2,
                        np.arange(-20, 21) * np.pi]).astype(F32)
    want = np.asarray(jax.jit(jfast.fast_tan)(x))
    got = tsamp.fast_tan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c rounded once to float32, by exact rational arithmetic
    (ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = F32(float(v))  # within one float32 step of the answer
    best = None
    for cand in (np.nextafter(r, F32(-np.inf)), r, np.nextafter(r, F32(np.inf))):
        d = abs(Fraction(float(cand)) - v)
        even = int(np.asarray(cand).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return best[1]


def test_fma_f32_rounds_once():
    rs = np.random.default_rng(11)
    a = rs.standard_normal(3000).astype(F32)
    b = rs.standard_normal(3000).astype(F32)
    c = rs.standard_normal(3000).astype(F32) * F32(1e-3)
    # Ties a float64 sum lands on: 1 + 2^-24 (+ or - a hair) is a float32
    # midpoint that only the exact error breaks.
    one, eps = F32(1.0), F32(2.0**-24)
    a = np.concatenate([a, [eps, eps, eps, F32(1.5)]]).astype(F32)
    b = np.concatenate([b, [one, F32(1.0) + F32(2.0**-23), F32(1.0) - F32(2.0**-24), F32(2.0)]]).astype(F32)
    c = np.concatenate([c, [one, one, one, F32(-3.0)]]).astype(F32)
    got = tsamp.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)], F32)
    np.testing.assert_array_equal(got, want)
    assert got[-4] == F32(1.0)  # the tie, broken to even
    assert got[-3] > F32(1.0) and got[-2] == F32(1.0)


# -- the log densities -------------------------------------------------------------


WILD = np.array([-1e30, -1e20, -100.0, -1.0, -0.0, 0.0, 1e-30, 1e-7, 1.0, 3.0,
                 100.0, 1e15, 1e20, 1e30], F32)


@pytest.mark.parametrize("name", NAMES)
def test_log_pdf_matches_jax(name):
    rs = np.random.default_rng(3)
    kind = DistKind[name.upper()]
    for p1, p2 in ROW_PARAMS[name]:
        draws = _port_inv(name, rs.random(50_000, dtype=F32), p1, p2)
        x = np.concatenate([draws, WILD, rs.normal(p1, 30.0, 5000).astype(F32),
                            [F32(p1), np.nextafter(F32(p1), F32(-np.inf))]])
        x = x.astype(F32)
        jrow = jsamp.ANALYTIC_EXT[jsamp.DistKind[name.upper()]]
        want = np.asarray(jax.jit(lambda v: jrow.log_pdf(v, F32(p1), F32(p2)))(x))
        got = tsamp.analytic_log_pdf(kind, torch.tensor(p1), torch.tensor(p2),
                                     torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=LOG_PDF_RTOL,
                                   atol=LOG_PDF_ATOL)
        assert got.min() >= -100.0
        # The density integrates the pdf closure: exp(log pdf) = pdf.
        d = getattr(tm.Distribution, name)(p1, p2)
        inside = (got > -50.0) & (np.abs(x) < 1e6)
        host = np.array([d.pdf(float(v)) for v in x[inside][:2000]])
        np.testing.assert_allclose(np.exp(got[inside][:2000].astype(np.float64)),
                                   host, rtol=2e-4)


# -- the kernels' rows, built with g++ ------------------------------------------------

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
#include "counter_rng.cuh"

extern "C" void rows(int kind, float p1, float p2, const float* u,
                     const float* x, long n, float* inv, float* lp) {
  for (long i = 0; i < n; ++i) {
    inv[i] = tmc::ext_inv(kind, u[i], p1, p2);
    lp[i] = tmc::log_pdf(kind, p1, p2, x[i]);
  }
}

extern "C" void draws(int kind, float p1, float p2, const long long* m,
                      long n, float* out) {
  for (long i = 0; i < n; ++i) out[i] = tmc::transform(kind, uint32_t(m[i]), p1, p2);
}
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("rows")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "librows.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    f, p = ctypes.c_float, ctypes.c_void_p
    lib.rows.argtypes = [ctypes.c_int, f, f, p, p, ctypes.c_long, p, p]
    lib.draws.argtypes = [ctypes.c_int, f, f, p, ctypes.c_long, p]
    lib.rows.restype = lib.draws.restype = None
    return lib


@pytest.mark.parametrize("name", NAMES)
def test_kernel_rows_match_plain_version(host_rows, name):
    kind = DistKind[name.upper()]
    every = name == "cauchy"  # bit for bit at every kernel uniform
    uniforms = _kernel_uniforms(every)
    m = _mantissas(every)
    for p1, p2 in ROW_PARAMS[name][:2]:
        want = _port_inv(name, uniforms, p1, p2)
        x = np.ascontiguousarray(want)
        inv = np.empty_like(uniforms)
        lp = np.empty_like(uniforms)
        host_rows.rows(int(kind), p1, p2, uniforms.ctypes.data, x.ctypes.data,
                       len(uniforms), inv.ctypes.data, lp.ctypes.data)
        want_lp = tsamp.analytic_log_pdf(kind, torch.tensor(p1),
                                         torch.tensor(p2),
                                         torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(lp, want_lp, rtol=LOG_PDF_RTOL,
                                   atol=LOG_PDF_ATOL)
        if name == "cauchy":
            np.testing.assert_array_equal(inv, want)
        elif name == "lognormal":
            np.testing.assert_allclose(np.log(inv.astype(np.float64)),
                                       np.log(want.astype(np.float64)),
                                       rtol=0, atol=1e-6 * (1.0 + p2))
        else:
            assert _scale_ulps(name, inv, want, p1).max() <= HOST_ULPS[name]
        # tmc::transform draws from the [0, 1) uniform of the mantissa.
        drawn = np.empty(len(m), F32)
        host_rows.draws(int(kind), p1, p2, m.ctypes.data, len(m),
                        drawn.ctypes.data)
        np.testing.assert_array_equal(drawn, inv[: len(m)])


# -- factories, quantiles, specs ---------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_factory_matches_jax(name):
    args = FAMILIES[name]
    jd = getattr(jmc.Distribution, name)(*args)
    td = getattr(tm.Distribution, name)(*args)
    assert td.dist_type.name == jd.dist_type.name == name.upper()
    assert td.params == jd.params
    lo, hi = td.params["support"]
    xs = np.concatenate([np.linspace(max(lo, -40.0) - 1.0, min(hi, 40.0) + 1.0, 301),
                         [lo, hi, 0.0, -1.0]])
    assert [td.pdf(float(x)) for x in xs] == [jd.pdf(float(x)) for x in xs]
    carried = tm.Distribution.from_reference(jd)
    assert carried.dist_type == td.dist_type and carried.params == td.params
    spec = tsamp.dist_spec_of(td)
    jspec = jsamp.dist_spec_of(jd)
    assert int(spec.kind) == int(jspec.kind)
    assert spec.params.dtype == np.float32
    np.testing.assert_array_equal(spec.params, jspec.params)


VALIDATION = [
    ("lognormal", (0.0, 0.0)), ("lognormal", (0.0, -1.0)),
    ("cauchy", (0.0, 0.0)), ("laplace", (1.0, -2.0)),
    ("logistic", (0.0, 0.0)), ("gumbel", (0.0, float("nan"))),
    ("weibull", (0.0, 1.0)), ("weibull", (1.0, -1.0)),
    ("pareto", (0.0, 1.0)), ("pareto", (1.0, 0.0)),
]


@pytest.mark.parametrize("name,args", VALIDATION,
                         ids=[f"{n}{a}" for n, a in VALIDATION])
def test_validation_errors_match_jax(name, args):
    with pytest.raises(ValueError) as want:
        getattr(jmc.Distribution, name)(*args)
    with pytest.raises(ValueError) as got:
        getattr(tm.Distribution, name)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", NAMES)
def test_quantile_matches_jax(name):
    for args in ROW_PARAMS[name]:
        jd = getattr(jmc.Distribution, name)(*args)
        td = getattr(tm.Distribution, name)(*args)
        for q in (1e-7, 1e-6, 0.01, 0.3, 0.5, 0.7, 0.99, 1.0 - 1e-7):
            want = jd.quantile(q)
            assert math.isclose(td.quantile(q), want, rel_tol=1e-12,
                                abs_tol=1e-12), (q, td.quantile(q), want)
        for q in (0.0, 1.0, -0.5):
            with pytest.raises(ValueError, match="q must be in"):
                td.quantile(q)


@pytest.mark.parametrize("name", NAMES)
def test_quantile_inverts_the_sampler(name):
    # The host quantile and the float32 inverse CDF are one function, up to
    # float32 rounding (Cauchy's tangent turns pi (u - 1/2)'s rounding into
    # 4e-5 relative at u = 0.001); the Weibull and Pareto samplers draw
    # from the exchangeable 1 - u, so their inverse at u is the quantile
    # at 1 - u.
    args = FAMILIES[name]
    td = getattr(tm.Distribution, name)(*args)
    q = np.array([0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999], F32)
    drawn = _port_inv(name, q, *args).astype(np.float64)
    level = 1.0 - q.astype(np.float64) if name in ("weibull", "pareto") else q
    want = np.array([td.quantile(float(v)) for v in level])
    rtol = 1e-4 if name == "cauchy" else 2e-5
    np.testing.assert_allclose(drawn, want, rtol=rtol, atol=2e-5)


@pytest.mark.parametrize("name", NAMES)
def test_random_walk_ranges_over_family_targets(name):
    # Chains start over the target's central 98 % interval, its quantiles.
    jd = getattr(jmc.Distribution, name)(*FAMILIES[name])
    td = tm.Distribution.from_reference(jd)
    for kwargs in ({}, {"step_size": 0.3, "adapt": True}):
        want = jmc.RandomWalk(**kwargs).pack_params(jd)
        got = tm.RandomWalk(**kwargs).pack_params(td)
        np.testing.assert_array_equal(got, want)
    rows = tm.RandomWalk().pack_params_nd([td, tm.Distribution.normal()], 2)
    np.testing.assert_array_equal(
        rows, jmc.RandomWalk().pack_params_nd([jd, jmc.Distribution.normal()], 2))


def test_mixture_of_cauchy_components_matches_jax():
    # tests/test_mixture.py: per-component quantile knots resolve a Cauchy
    # beside a normal; the port builds the same table bit for bit.
    def mix(pkg):
        return pkg.Distribution.mixture(
            [pkg.Distribution.cauchy(0.0, 1.0), pkg.Distribution.normal(5.0, 1.0)],
            weights=[0.5, 0.5])

    td, jd = mix(tm), mix(jmc)
    np.testing.assert_array_equal(td._x_table, jd._x_table)
    np.testing.assert_array_equal(td._cdf_table, jd._cdf_table)
    xs = np.asarray(td._x_table, np.float64)
    cdf = np.asarray(td._cdf_table, np.float64)
    true_abs1 = 0.5 * (2.0 * math.atan(1.0) / math.pi)
    assert abs(np.interp(1.0, xs, cdf) - np.interp(-1.0, xs, cdf) - true_abs1) < 5e-3
    spec, jspec = tsamp.dist_spec_of(td), jsamp.dist_spec_of(jd)
    assert (spec.exact_inverse, spec.heavy_tail) == (jspec.exact_inverse,
                                                     jspec.heavy_tail)
    np.testing.assert_array_equal(spec.x_table, jspec.x_table)


def test_family_mixture_integrates_on_the_cpu():
    # Two Laplace modes: a gap-free table sampled through the strata.
    d = tm.Distribution.mixture([tm.Distribution.laplace(-3.0, 0.5),
                                 tm.Distribution.laplace(3.0, 0.5)])
    r = tm.integrate([lambda x: x * x], d, n_samples=1 << 20, device="cpu",
                     return_stderr=True)
    assert abs(r.values[0] - 9.5) < 6 * r.stderr[0] + 0.01


# -- what stays with later items ------------------------------------------------------


def test_family_features_of_later_items_still_raise():
    """The family features of later items, which raised here before.
    ``expectation_fn`` over Weibull(1.5, 2): its pathwise gradient is the
    plain forward's autograd gradient on the same uniforms (autograd
    through ``integrate_reference`` with the parameters as leaves), within
    1e-6 relative.  The family sets over more than 127 (126) functions
    run in passes over one set of chains: E[x + k] - E[x] = k, every
    row."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    w = tm.Distribution.weibull(1.5, 2.0)
    c = tm.Distribution.cauchy(0.0, 1.0)
    wide1 = [(lambda k: lambda x: x + k)(float(k)) for k in range(127)]
    wide2 = [(lambda k: lambda x, y: x + k)(float(k)) for k in range(128)]
    fns = [lambda x: x, lambda x: x * x]
    est = integ.expectation_fn(fns, w, n_samples=1 << 17)
    leaf = torch.tensor([1.5, 2.0], requires_grad=True)
    got = torch.stack([torch.autograd.grad(est(leaf, seed=3)[j], leaf)[0]
                       for j in range(len(fns))])
    from tpu_montecarlo_torch.ops.integrate_kernel import (
        IntegrateProgram,
        integrate_reference,
        plan_grid,
    )

    prog = IntegrateProgram(tuple(tm.trace_function(f) for f in fns))
    grid = plan_grid(1 << 17)
    plain = torch.tensor([1.5, 2.0], requires_grad=True)
    sums = integrate_reference(prog.torch_values, DistKind.WEIBULL, plain, 3,
                               grid)
    want = torch.stack([torch.autograd.grad(sums[j], plain,
                                            retain_graph=True)[0]
                        for j in range(len(fns))]) / grid.actual_samples
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    short = dict(n_steps=10, n_burnin=2)
    runs = {
        "8.8": integ.compile_mcmc(wide2, [c, w], [w, w], seed_batch=2,
                                  **short),
        "9.7": integ.compile_mcmc(wide1, c, w, seed_batch=2,
                                  temperatures=[1.0, 2.0], **short),
    }
    for item, prog in runs.items():
        values = prog([1, 2])[0].numpy()
        assert np.all(np.isfinite(values)), item
        shift = values - values[:, :1]
        np.testing.assert_allclose(shift, np.broadcast_to(
            np.arange(float(values.shape[1])), shift.shape), atol=1e-3,
            err_msg=item)


def test_family_handles_take_param_and_seed_batches():
    """The serving handles over the extended families, which raised
    before them: a Weibull param batch, each row its unbatched handle,
    and a seed-batched MCMC handle over a Cauchy target."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    ws = [tm.Distribution.weibull(1.5, 2.0), tm.Distribution.weibull(2.5, 1.0)]
    prog = integ.compile_integrate([lambda x: x], ws[0], n_samples=1 << 16,
                                   seed_batch=2, param_batch=True)
    out = prog([3, 4], tm.pack_param_batch(ws))
    for r, (seed, w) in enumerate(zip([3, 4], ws)):
        one = integ.compile_integrate([lambda x: x], w, n_samples=1 << 16)
        assert torch.equal(out[r], one(seed))
    c = tm.Distribution.cauchy(0.0, 1.0)
    kw = dict(n_steps=20, n_chains=256, n_burnin=5)
    batched = integ.compile_mcmc([lambda x: x], c, ws[0], seed_batch=2, **kw)
    single = integ.compile_mcmc([lambda x: x], c, ws[0], **kw)
    vals, acc = batched([5, 6])
    v6, a6 = single(6)
    assert torch.equal(vals[1], v6) and torch.equal(acc[1], a6)


def test_sampling_rows_are_the_registry():
    assert tuple(ANALYTIC_EXT) == tuple(DistKind(k) for k in range(4, 11))
    assert tsamp.ANALYTIC_KINDS == tuple(DistKind(k) for k in (0, 1, 2)) + tuple(
        ANALYTIC_EXT)
    for kind, row in ANALYTIC_EXT.items():
        jrow = jsamp.ANALYTIC_EXT[jsamp.DistKind(int(kind))]
        assert (row.name, row.param_names) == (jrow.name, jrow.param_names)
    with pytest.raises(ValueError, match="No analytic log-pdf"):
        tsamp.analytic_log_pdf(DistKind.CUSTOM, 0.0, 1.0, torch.zeros(2))
    x = tsamp.transform_from_u(torch.tensor([0.25, 0.75]), DistKind.LAPLACE,
                               torch.tensor(3.0), torch.tensor(1.0))
    np.testing.assert_allclose(x.numpy(), [3.0 - math.log(2.0), 3.0 + math.log(2.0)],
                               rtol=1e-6)
