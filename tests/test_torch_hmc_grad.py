"""The port's reverse-mode gradient of the traced IR (``ops/grad.py``)
against ``jax.grad`` of the JAX package's trace.

* A battery of targets that together use every operation of the tracer's
  function table (``tracing._FUNC_MAP``; ``test_battery_uses_every_op``
  holds that), among them c11b's and c12b's targets, the rho = 0.6 joint
  of ``tests/test_hmc.py`` and the banana of ``tests/test_tempering.py``.
  ``to_torch_grad`` is held against ``jax.jit(jax.grad(lambda v:
  jnp.sum(f(*v))))`` outside a kernel within GRAD_ULPS ulp of the
  largest term of the gradient's expression (the largest magnitude of
  any cotangent term ``grad_ir`` adds at the point, or of the gradient
  itself), one torch thread with float32 subnormals flushed, as XLA's CPU
  backend runs.  XLA's compiler fuses multiply-adds (measured: 35 % of
  c11b's gradients differ in the last bit from the op-by-op trace), and
  torch's and XLA's transcendental functions differ in the last bit.
* Op by op (``jax.disable_jit``), where torch and XLA round every
  operation alike (the arithmetic, comparison and selection targets),
  the two gradients agree bit for bit: the IR gradient takes JAX's
  operation order and its order of summing a node's cotangents.
* JAX's rules at the edges: a max/min tie takes half, |x| at 0 the slope
  of x >= 0, the zero cotangent of a ``where``'s other branch still
  multiplies its partials (NaN where that branch is 0 / 0), floor and
  sign pass nothing.
* Inside ``kernelize`` (the Pallas kernels' tracing context) the JAX
  package differentiates its fast_math forms of the trig, hyperbolic,
  ``expm1``, ``cbrt`` and ``copysign`` calls.  Where those are
  polynomials and ``exp``/``log`` (sin, cos, tan, atan, cosh, acosh,
  expm1) the port's gradient holds within KERNEL_RTOL relative and
  KERNEL_ATOL absolute (measured: 1.7e-4 of sin's near its zero, 3.8e-7
  absolute; 1.6e-4 of tan's near its pole); fast_atan's is NaN at 0.
  Where they move the sign through an int32 bitcast (``fast_copysign``:
  copysign, atan2, asin, acos, sinh, asinh, atanh, cbrt) ``jax.grad``
  of the JAX kernel is 0 and the port's is the function's: a routing
  difference the tests pin.
* The generated C gradient (``lower.cuda_target_grad_source``), built
  with g++ ``-ffp-contract=off`` as ``tests/test_torch_hmc.py`` builds its
  shim, against the torch lowering: bit for bit on the exact targets,
  within GRAD_ULPS ulp of the largest term elsewhere (glibc's and
  torch's libm).
"""

import contextlib
import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo.ops.fast_math import kernelize
from tpu_montecarlo.tracing import trace_function as j_trace

from tpu_montecarlo_torch import tracing as t_tracing
from tpu_montecarlo_torch.ops.grad import grad_ir
from tpu_montecarlo_torch.ops.lower import (
    _torch_program,
    cuda_target_grad_source,
    cuda_target_source,
    to_torch,
    to_torch_grad,
    topo_order,
)

F32 = np.float32
GRAD_ULPS = 4
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 1e-6
N_POINTS = 2048

RHO = 0.8
C11B = 1.0 / (2.0 * (1.0 - RHO * RHO))


def c11b(x, y):
    return -C11B * (x * x - 2.0 * RHO * x * y + y * y)


def logmix(x):
    return math.log(math.exp(-0.5 * (x + 4.0) ** 2)
                    + math.exp(-0.5 * (x - 4.0) ** 2))


def rho6(x, y):
    return -0.5 * (x * x - 2 * 0.6 * x * y + y * y) / (1 - 0.6 * 0.6)


def banana(x, y):
    return -0.5 * (x * x / 4.0 + (y - 0.5 * x * x) ** 2)


def arith(x, y):
    a = x * y + x / (y * y + 3.0) - x * x * x + (x - y) ** 3 / 5.0
    b = abs(y) + 1.0 / (1.0 + x * x) - (-x)
    c = max(x, y) - min(x, 0.5) + (x if x > y else y * 2.0)
    return a * b + c + np.square(x - 1.0) * np.minimum(y, 1.0)


def selects(x, y):
    z = x * y
    if z > 1.0:
        z = z * z - x
    else:
        z = z / (y * y + 1.0)
    w = np.where((x > 0) & (y < 1.0), z, -z * x) + (x > y) * y
    return w + np.clip(x, -1.0, 1.0) * y + np.fmax(x, y) * np.fmin(x, 0.3)


def steps(x, y):
    return (math.floor(x) * y + np.sign(x) * y + round(y) + math.trunc(x) * x
            + np.heaviside(x, 0.5) * y + (x % 2.0) + (x // 1.5)
            + math.ceil(y) * x + np.step(0.2, y) * x)


def trig(x, y):
    return (math.sin(x) * math.cos(y) + math.tan(0.3 * x)
            + math.atan2(x, y) + np.arctan(y) + math.sinh(0.2 * x)
            + math.cosh(0.1 * y) + math.tanh(x * y))


def inverse(x, y):
    return (math.asin(0.5 * math.tanh(x)) + math.acos(0.3 * math.tanh(y))
            + np.arcsinh(x) + np.arccosh(2.0 + y * y)
            + np.arctanh(0.5 * math.tanh(x * y)))


def powers(x, y):
    return (np.cbrt(x) + np.exp2(0.3 * y) + np.expm1(0.2 * x)
            + math.log2(1.0 + x * x) + math.log10(2.0 + y * y)
            + math.hypot(x, y) + math.copysign(x, y)
            + math.fmod(x, 1.5 + y * y) + abs(x) ** 1.7
            + (0.1 * x * x + 1.0) ** (0.5 * y) + np.log1p(y * y)
            + math.sqrt(x * x + 0.5)
            + math.exp(-x * x) + np.power(abs(y) + 0.5, 1.5))


def misc(x, y):
    c = (x >= y) | (y <= -1.0)
    e = (x == 0.5) or not (y != 1.0)
    return (np.degrees(y) + np.radians(x) + np.where(x > 0, np.log(x), -1e3)
            + np.fabs(y) + np.mix(x, y, 0.3) + np.smoothstep(-1.0, 1.0, x)
            + np.fract(y) * x + c * y + e * x)


def smooth(x, y):
    t = x * 0.5 + 0.5
    return (t - math.floor(t)) * y + x * x / (1.0 + y * y)


BATTERY = {
    "c11b": c11b, "c12b": logmix, "rho6": rho6, "banana": banana,
    "arith": arith, "selects": selects, "steps": steps, "trig": trig,
    "inverse": inverse, "powers": powers, "misc": misc, "smooth": smooth,
}
# The targets whose every operation torch and XLA round alike.
EXACT = ("c11b", "rho6", "banana", "arith", "selects", "steps", "smooth")


def _arity(f):
    return f.__code__.co_argcount


@contextlib.contextmanager
def _flushing_subnormals():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _points(name, d):
    rs = np.random.default_rng(sum(map(ord, name)))
    pts = rs.standard_normal((d, N_POINTS)) * 2.5
    # Ties, zeros and the edges of the selects.
    edge = np.array([0.0, -0.0, 1.0, 0.5, -1.0, 1.5, 2.0, 3.0], np.float64)
    pts[:, :len(edge)] = edge
    pts[:, len(edge):2 * len(edge)] = edge[::-1]
    return [p.astype(F32) for p in pts]


def _jax_grad(f, xs, jit=True):
    jf = j_trace(f, n_args=len(xs)) if len(xs) > 1 else j_trace(f)
    g = jax.grad(lambda v: jnp.sum(jf(*v)))
    args = tuple(jnp.asarray(x) for x in xs)
    if jit:
        return [np.asarray(w) for w in jax.jit(g)(args)]
    with jax.disable_jit():
        return [np.asarray(w) for w in g(args)]


def _port(f, d):
    return t_tracing.trace_function(f, d)


def _term_scale(fn, xs, roots=None):
    """The largest magnitude, per point, of the terms of the gradient's
    expression (every float32 node it reads, the forward ones included:
    XLA's fused multiply-adds round them otherwise), where finite; with
    ``roots``, of those roots' expressions."""
    if roots is None:
        roots = grad_ir(fn)[1]
    terms = [n for n in topo_order(roots)
             if n.dtype == "f32" and n.op not in ("const", "arg")]
    if not terms:
        return np.zeros(N_POINTS)
    vals = _torch_program(terms)(*[torch.from_numpy(x) for x in xs])
    stack = torch.stack([v.double().abs() for v in vals])
    stack = torch.where(torch.isfinite(stack), stack, 0.0)
    return stack.max(dim=0).values.numpy()


def _assert_close(got, want, scale, ulps, what):
    ok = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), ok), what
    with np.errstate(over="ignore"):
        s = np.minimum(np.maximum(np.abs(want[ok]).astype(np.float64),
                                  scale[ok]), np.finfo(F32).max)
        tol = ulps * np.spacing(s.astype(F32)).astype(np.float64)
    err = np.abs(got[ok].astype(np.float64) - want[ok].astype(np.float64))
    worst = int(np.argmax(err - tol))
    assert np.all(err <= tol), (what, got[ok][worst], want[ok][worst],
                                tol[worst])


def test_battery_uses_every_op():
    ops = set()
    for f in BATTERY.values():
        fn = _port(f, _arity(f))
        ops |= {n.op for n in topo_order([fn.ir])}
    wanted = (t_tracing.UNARY_OPS | t_tracing.BINARY_OPS
              | t_tracing.COMPARE_OPS | t_tracing.LOGIC_OPS
              | {"select", "to_f32", "not"})
    assert wanted - ops == set()


@pytest.mark.parametrize("name", list(BATTERY))
def test_gradient_matches_jax_grad(name):
    f = BATTERY[name]
    d = _arity(f)
    xs = _points(name, d)
    want = _jax_grad(f, xs)
    fn = _port(f, d)
    with _flushing_subnormals():
        value, got = to_torch_grad(fn)(*[torch.from_numpy(x) for x in xs])
        plain = to_torch(fn)(*[torch.from_numpy(x) for x in xs])
        scale = _term_scale(fn, xs)
    # The value is the plain lowering's, bit for bit.
    assert torch.equal(torch.nan_to_num(value, 7.0),
                       torch.nan_to_num(plain, 7.0))
    for j in range(d):
        assert got[j].dtype == torch.float32
        _assert_close(got[j].numpy(), want[j], scale, GRAD_ULPS,
                      f"{name} d/dx{j}")


@pytest.mark.parametrize("name", EXACT)
def test_gradient_matches_op_by_op_jax_bit_for_bit(name):
    f = BATTERY[name]
    d = _arity(f)
    xs = _points(name, d)
    want = _jax_grad(f, xs, jit=False)
    with _flushing_subnormals():
        _, got = to_torch_grad(_port(f, d))(*[torch.from_numpy(x) for x in xs])
    for j in range(d):
        np.testing.assert_array_equal(got[j].numpy(), want[j])


@pytest.mark.parametrize("f,x,want", [
    (lambda x: max(x, 1.0) * 2.0, 1.0, 1.0),          # a tie takes half
    (lambda x: min(3.0, x) + min(x, x), 3.0, 1.5),     # ties, summed
    (lambda x: abs(x) * 3.0, 0.0, 3.0),                # |x| at 0: +1
    (lambda x: abs(x) * 3.0, -0.0, 3.0),
    (lambda x: np.where(x > 0, np.log(x), 0.0), 0.0, math.nan),  # 0 * inf
    (lambda x: np.where(x > 0, np.log(x), 0.0), -2.0, -0.0),
    (lambda x: math.floor(x) * 2.0 + np.sign(x), 0.0, 0.0),
    (lambda x: x ** 2.5, 0.0, 0.0),
    (lambda x: math.sqrt(x), 0.0, math.inf),
])
def test_gradient_at_edges_follows_jax_grad(f, x, want):
    jf = j_trace(f)
    jax_g = float(jax.grad(lambda v: jnp.sum(jf(v)))(F32(x)))
    _, got = to_torch_grad(_port(f, 1))(torch.tensor([x], dtype=torch.float32))
    got = float(got[0][0])
    for v in (got, jax_g):
        if math.isnan(want):
            assert math.isnan(v)
        else:
            assert v == want and math.copysign(1.0, v) == math.copysign(
                1.0, want)


def test_unreached_argument_gets_zero():
    fn = _port(lambda x, y: x * x, 2)
    _, grads = grad_ir(fn)
    assert grads[1].op == "const" and grads[1].value == 0.0
    _, got = to_torch_grad(fn)(torch.ones(4), torch.ones(4))
    assert torch.equal(got[1], torch.zeros(4))


# The dispatched functions whose fast_math forms the JAX kernel can
# differentiate, each in a target of one argument.
KERNEL_OPS = {
    "sin": lambda x: math.sin(x),
    "cos": lambda x: math.cos(x),
    "tan": lambda x: math.tan(0.3 * x),
    "atan": lambda x: np.arctan(x),
    "cosh": lambda x: math.cosh(0.1 * x),
    "acosh": lambda x: np.arccosh(2.0 + x * x),
    "expm1": lambda x: np.expm1(0.2 * x),
}
# The ones whose fast_math forms move the sign through an int32 bitcast
# (fast_copysign), which jax.grad passes nothing through.
BITCAST_OPS = {
    "copysign": lambda x: math.copysign(x, x - 1.0),
    "atan2": lambda x: math.atan2(x, 1.3),
    "asin": lambda x: math.asin(0.5 * math.tanh(x)),
    "acos": lambda x: math.acos(0.3 * math.tanh(x)),
    "sinh": lambda x: math.sinh(0.2 * x),
    "asinh": lambda x: np.arcsinh(x),
    "atanh": lambda x: np.arctanh(0.5 * math.tanh(x)),
    "cbrt": lambda x: np.cbrt(x),
}


def _kernel_grad(f, x):
    jf = kernelize(j_trace(f))
    g = jax.jit(jax.grad(lambda v: jnp.sum(jf(v))))
    return np.asarray(g(jnp.asarray(x))).astype(np.float64)


@pytest.mark.parametrize("name", list(KERNEL_OPS))
def test_gradient_within_kernelize_tolerance(name):
    # Inside a Pallas kernel the JAX package differentiates fast_math's
    # polynomials (kernelize); the port differentiates the functions.
    f = KERNEL_OPS[name]
    x = _points(name, 1)[0]
    want = _kernel_grad(f, x)
    with _flushing_subnormals():
        _, got = to_torch_grad(_port(f, 1))(torch.from_numpy(x))
    got = got[0].numpy().astype(np.float64)
    assert np.isfinite(got).all()
    # fast_atan's untaken branch 1 / x makes its gradient NaN at 0.
    ok = np.isfinite(want)
    assert np.all(x[~ok] == 0.0) and (ok.all() or name == "atan")
    err = np.abs(got[ok] - want[ok])
    assert np.all(err <= KERNEL_RTOL * np.abs(want[ok]) + KERNEL_ATOL)


@pytest.mark.parametrize("name", list(BITCAST_OPS))
def test_kernel_bitcast_forms_pass_no_gradient(name):
    # Where fast_math's form ends in fast_copysign, the JAX kernel's
    # gradient is 0 on one side of the bitcast (every point for copysign,
    # atan2, asin, acos, cbrt; sinh, asinh and atanh keep only what
    # reaches them past it): HMC in the JAX kernel moves on that.  The
    # port's gradient is the function's (test_gradient_matches_jax_grad).
    f = BITCAST_OPS[name]
    x = _points(name, 1)[0]
    want = _kernel_grad(f, x)
    _, got = to_torch_grad(_port(f, 1))(torch.from_numpy(x))
    got = got[0].numpy()
    stock = _jax_grad(f, [x])[0]
    assert np.mean(want == 0.0) > 0.99
    assert np.mean(np.isclose(got, stock, rtol=1e-5, atol=1e-6)) > 0.99
    assert np.mean(got != 0.0) > 0.99


# -- the generated C gradient, built with g++ -----------------------------------

_SHIM = r"""
#include <cmath>
#include <math.h>
#define __device__
#include "integrand_math.cuh"
#include "target.inc"

extern "C" void value_grad(const float* x, long n, int d, float* out) {
  float p[8], g[8];
  for (long i = 0; i < n; ++i) {
    for (int j = 0; j < d; ++j) p[j] = x[j * n + i];
    out[i] = tmc_target_logpdf_grad(p, g);
    for (int j = 0; j < d; ++j) out[(j + 1) * n + i] = g[j];
    if (tmc_target_logpdf(p) != out[i] && out[i] == out[i]) out[i] = -7.0f;
  }
}
"""
CSRC = (__import__("pathlib").Path(__file__).resolve().parents[1]
        / "tpu_montecarlo_torch" / "csrc")


@pytest.fixture(scope="module")
def gxx():
    exe = shutil.which("g++")
    if exe is None:
        pytest.skip("g++ is not installed")
    return exe


@pytest.mark.parametrize("name", list(BATTERY))
def test_c_gradient_matches_torch_lowering(gxx, tmp_path, name):
    f = BATTERY[name]
    d = _arity(f)
    fn = _port(f, d)
    (tmp_path / "target.inc").write_text(
        cuda_target_source(fn) + cuda_target_grad_source(fn))
    (tmp_path / "shim.cpp").write_text(_SHIM)
    so = tmp_path / "libgrad.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), "-I", str(tmp_path), str(tmp_path / "shim.cpp"),
         "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.value_grad.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_void_p]
    xs = _points(name, d)
    flat = np.ascontiguousarray(np.stack(xs))
    out = np.empty((d + 1, N_POINTS), F32)
    lib.value_grad(flat.ctypes.data, N_POINTS, d, out.ctypes.data)
    value, grads = to_torch_grad(fn)(*[torch.from_numpy(x) for x in xs])
    assert not np.any(out[0] == -7.0)  # the value is tmc_target_logpdf's
    scales = [_term_scale(fn, xs, [fn.ir]), _term_scale(fn, xs)]
    for j, want in enumerate([value, *grads]):
        want = want.numpy()
        if name in EXACT:
            np.testing.assert_array_equal(out[j], want)
        else:
            _assert_close(out[j], want, scales[min(j, 1)], GRAD_ULPS,
                          f"{name} column {j}")
