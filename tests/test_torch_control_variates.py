"""Control variates on the port (``integrate(..., control_variates=[(g,
E[g]), ...])``), against the JAX package's ``backend="pallas"`` route.

The port composes the same set as the JAX package (f, g, the
pilot-shifted f*g and g*g products, f*f under error bars) as IR over the
traced functions (``tracing.shifted``, ``tracing.product``) and runs it
as ONE integrand set: the 1-D or nd handle, in passes of at most 128
where it is wider.  Every case of ``tests/test_control_variates.py`` runs
on the port.  In 1-D the JAX package's kernel in interpret mode draws
the port's uniforms (256-row tiles for these sets), so the two agree
closely: values within rel 1e-5 and error bars within rel 1e-3 + 1e-9
(measured: 7e-7 and 5e-5 at most).  The pilots, each function's float32
value at the median, may differ by an ulp between torch's and XLA's CPU
math; the correction does not depend on them but through float32
rounding.  The nd case runs on the JAX package's XLA sweep, so it is held
statistically: within 6 combined error bars.
"""

import math

import numpy as np
import pytest

import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.lower import cuda_source, to_torch
from tpu_montecarlo_torch.tracing import product, shifted

E_HALF = math.exp(0.125)  # E[exp(X/2)], X ~ N(0,1)
N = 1 << 17
VALUE_RTOL = 1e-5
STDERR_RTOL, STDERR_ATOL = 1e-3, 1e-9


def _normal(pkg):
    return pkg.Distribution.normal(0.0, 1.0)


def _triangle(pkg):
    return pkg.Distribution.from_pdf(
        lambda x: 1.0 - abs(x) if abs(x) < 1 else 0.0)


def _both(fns, make, controls, n=N, seed=5, return_stderr=True):
    """(port, JAX pallas route) results of one control-variate call."""
    kw = dict(n_samples=n, seed=seed, return_stderr=return_stderr,
              control_variates=controls)
    got = tm.MonteCarloIntegrator(device="cpu").integrate(fns, make(tm), **kw)
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate(
        fns, make(jmc), **kw)
    np.testing.assert_allclose(got.values, want.values, rtol=VALUE_RTOL)
    if return_stderr:
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL,
                                   atol=STDERR_ATOL)
    return got


def _plain(fns, make, n=N, seed=5):
    return tm.integrate(fns, make(tm), n_samples=n, seed=seed,
                        return_stderr=True, device="cpu")


def test_estimate_and_reduction():
    """exp(x/2) with control x (E = 0): the corrected estimate stays right
    and its residual error bar falls well under the plain one."""
    f = [lambda x: math.e ** (0.5 * x)]
    cv = _both(f, _normal, [(lambda x: x, 0.0)])
    assert abs(cv.values[0] - E_HALF) < 0.005
    assert cv.stderr[0] < 0.5 * _plain(f, _normal).stderr[0]


def test_two_controls_beat_one():
    f = [lambda x: math.e ** (0.5 * x)]
    one = _both(f, _normal, [(lambda x: x, 0.0)])
    two = _both(f, _normal, [(lambda x: x, 0.0), (lambda x: x * x, 1.0)])
    assert abs(two.values[0] - E_HALF) < 0.002
    assert two.stderr[0] < 0.5 * one.stderr[0]


def test_perfect_control_is_exact():
    """g == f with known mean: the regression removes all the variance."""
    r = _both([lambda x: x * x], _normal, [(lambda x: x * x, 1.0)], seed=7)
    assert abs(r.values[0] - 1.0) < 1e-6
    assert r.stderr[0] < 1e-9


def test_unbiased_with_useless_control():
    """An uncorrelated control does not bias the estimate."""
    r = _both([lambda x: x * x], _normal, [(lambda x: x, 0.0)], seed=11)
    assert abs(r.values[0] - 1.0) < 0.02


def test_degenerate_constant_control():
    """A constant control: zero variance and covariance, coefficient 0
    from the minimum-norm solution, the estimate left uncorrected."""
    r = _both([lambda x: x * x], _normal, [(lambda x: 1.0, 1.0)], seed=7)
    assert abs(r.values[0] - 1.0) < 0.03
    assert np.isfinite(r.stderr[0])


def test_custom_table_distribution():
    f = [lambda x: math.e ** x]
    cv = _both(f, _triangle, [(lambda x: x, 0.0)], seed=3)
    true = math.e + math.exp(-1.0) - 2.0  # int e^x (1 - |x|) dx
    assert abs(cv.values[0] - true) < 0.01
    assert cv.stderr[0] < 0.7 * _plain(f, _triangle, seed=3).stderr[0]


def test_multiple_integrands_share_controls():
    r = _both([lambda x: math.e ** (0.5 * x), lambda x: x * x * x + x],
              _normal, [(lambda x: x, 0.0), (lambda x: x * x, 1.0)], seed=9)
    assert abs(r.values[0] - E_HALF) < 0.005
    assert abs(r.values[1]) < 0.05
    assert np.all(np.isfinite(r.stderr))


def _shifted_exp(c):
    return lambda x: math.e ** (0.5 * x) + c


def test_a_composed_set_over_128_runs_in_passes():
    """20 functions and 4 controls with error bars compose 20 + 4 + 80 +
    10 + 20 = 134 integrands: two passes of 67 on both sides."""
    fns = [_shifted_exp(c / 8.0) for c in range(20)]
    controls = [(lambda x: x, 0.0), (lambda x: x * x, 1.0),
                (lambda x: x ** 3, 0.0), (lambda x: math.sin(x), 0.0)]
    r = _both(fns, _normal, controls, n=1 << 15)
    want = E_HALF + np.arange(20) / 8.0
    assert np.all(np.abs(r.values - want) < 6 * r.stderr)
    # Each shifted copy has the same residual: one set of coefficients
    # but the intercept.
    np.testing.assert_allclose(r.stderr, r.stderr[0], rtol=1e-3)


def test_nd_control():
    """E[exp(0.3 (x + y))] over N(0,1) x U(0,1) with control x + y: the
    JAX package runs nd on its XLA sweep, so the two are held within 6
    combined error bars, and each within 6 of the closed form."""
    def dists(pkg):
        return [pkg.Distribution.normal(0.0, 1.0),
                pkg.Distribution.uniform(0.0, 1.0)]

    f = [lambda x, y: math.e ** (0.3 * (x + y))]
    kw = dict(n_samples=N, seed=3, return_stderr=True,
              control_variates=[(lambda x, y: x + y, 0.5)])
    got = tm.integrate(f, dists(tm), device="cpu", **kw)
    want = jmc.integrate(f, dists(jmc), **kw)
    true = math.exp(0.045) * (math.exp(0.3) - 1.0) / 0.3
    assert abs(got.values[0] - true) < 6 * got.stderr[0]
    assert abs(got.values[0] - want.values[0]) < 6 * np.hypot(
        got.stderr[0], want.stderr[0])
    plain = tm.integrate(f, dists(tm), device="cpu", n_samples=N, seed=3,
                         return_stderr=True)
    assert got.stderr[0] < 0.5 * plain.stderr[0]


ERRORS = {
    "qmc": dict(method="qmc", control_variates=[(lambda x: x, 0.0)]),
    "antithetic": dict(method="antithetic",
                       control_variates=[(lambda x: x, 0.0)]),
    "empty": dict(control_variates=[]),
    "malformed-pair": dict(control_variates=[lambda x: x]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_the_jax_package(case):
    """``method != "mc"`` and an empty list are ValueErrors, a malformed
    pair a TypeError, with the JAX package's messages."""
    kw = dict(n_samples=1000, **ERRORS[case])
    with pytest.raises((ValueError, TypeError)) as want:
        jmc.integrate([lambda x: x], _normal(jmc), **kw)
    with pytest.raises(want.type) as got:
        tm.integrate([lambda x: x], _normal(tm), device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_composed_functions_lower_both_ways():
    """``shifted`` and ``product`` are IR: the torch lowering computes
    (f - a)(g - b) in float32 as written, and the CUDA source has one
    device function per composed integrand."""
    f = tm.trace_function(lambda x: x * x)
    g = tm.trace_function(lambda x: math.sin(x))
    fg = product(shifted(f, 0.5), shifted(g, 0.25))
    x = torch.linspace(-3.0, 3.0, 101)
    want = (x * x - np.float32(0.5)) * (torch.sin(x) - np.float32(0.25))
    assert torch.equal(to_torch(fg)(x), want)
    src = cuda_source([f, g, fg])
    assert "#define TMC_K 3" in src and "f_2(" in src
    with pytest.raises(ValueError):
        product(f, tm.trace_function(lambda x, y: x, 2))


def test_pilots_key_the_composed_programs(program_cache):
    """The composed functions carry their pilots in their content keys:
    the same f and g under another median make new programs; the same
    call again makes none."""
    f = [lambda x: x * x]
    controls = [(lambda x: x, 0.0)]

    def run(mean):
        tm.integrate(f, tm.Distribution.normal(mean, 1.0), n_samples=1024,
                     device="cpu", control_variates=controls)
        return len(program_cache._store)

    first = run(0.0)
    assert first == 1
    assert run(1.0) == 2
    assert run(0.0) == 2
    ident = lambda x: x  # noqa: E731
    a, b = tm.trace_function(ident), tm.trace_function(ident)
    assert shifted(a, 0.5).key != shifted(a, 0.25).key
    assert shifted(a, 0.5).key == shifted(b, 0.5).key
    assert product(a, b).key == product(b, a).key
