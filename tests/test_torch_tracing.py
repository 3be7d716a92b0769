"""The port's integrand front end against ``tpu_montecarlo.tracing``.

Each integrand goes through both front ends and is evaluated on one numpy
float32 grid: the JAX-traced function, the port's torch lowering, and the
port's C lowering (the integrand source the CUDA kernel includes),
compiled here as host C++ with ``g++ -D__device__=`` and called through
ctypes.  Rejected constructs must raise ``TraceError`` with the JAX
package's messages.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo import tracing as jtr
from tpu_montecarlo_torch import tracing as ttr
from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.ops.lower import cuda_source, to_torch

GLOBAL_SHIFT = 0.25
FLAG = True


def _make_scaled(scale):
    return lambda x: scale * x * x + GLOBAL_SHIFT


def _helper(t):
    return t * t + 1.0


def piecewise(x):
    if x < 0.0:
        return -x
    return x * x


def nested_partial_return(x):
    y = x
    if x > 0.5:
        if x > 1.5:
            return 2.0
        y = x + 1.0
    else:
        y = x - 1.0
    return y * 0.5


def branch_assign(x):
    """Docstring and annotated and augmented assignments."""
    acc: float = 1.0
    if x > 0.0:
        acc += x
    else:
        acc -= 0.5 * x
    acc *= 2.0
    return acc


def both_branches_return(x):
    if x >= 1.0:
        return 1.0
    else:
        return x > 0.25


BENCH = [
    lambda x: x,
    lambda x: x * x,
    lambda x: x * x * x,
    lambda x: x * x * x * x,
    lambda x: np.sin(x),
    lambda x: np.exp(-x * x),
    lambda x: x > 1.0,
    lambda x: abs(x),
]
MORE = [
    piecewise,
    nested_partial_return,
    branch_assign,
    both_branches_return,
    lambda x: x if x > 0 else -2.0 * x,
    _make_scaled(2.5),
    lambda x: math.sqrt(abs(x)) + math.log1p(x * x) - math.atan2(x, 2.0),
    lambda x: np.tanh(x) * np.cos(x) + np.floor(x) + np.hypot(x, 1.0),
    lambda x: x ** 3 - (x + 4.0) ** -2 + abs(x) ** 0.5,
    lambda x: (x > -0.5) and (x < 0.5),
    lambda x: not (x > 0.0),
    lambda x: (x > 0.0) & (x < 1.0) | (x < -2.0),
    lambda x: 0.0 < x < 1.0,
    lambda x: x % 1.5 + x // 0.7,
    lambda x: max(x, 0.0) + min(x, 1.0, 0.5) + np.clip(x, -1.0, 1.0),
    lambda x: _helper(x) / 2.0,
    lambda x: math.pi * x + math.e + FLAG,
    lambda x: np.where(x > 0, x, 0.0) + np.sign(x) + np.heaviside(x, 0.5),
    lambda x: np.round(x * 2.0) + math.degrees(x) + np.exp2(x) + np.expm1(x),
    lambda x: np.cbrt(x) + np.arcsinh(x) + np.fmod(x, 0.3) + np.square(x),
    lambda x: jnp.sin(x) + jnp.maximum(x, 0.0),
    lambda x: 3.0,
]
ALL = BENCH + MORE


def _grid() -> np.ndarray:
    rs = np.random.default_rng(7)
    special = np.array(
        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1.5, -2.0, 0.25, 0.7, 1.4, -1.4],
        np.float32,
    )
    return np.concatenate(
        [special, rs.uniform(-3.0, 3.0, 2000).astype(np.float32)]
    )


def _jax_values(fn, x):
    out = np.asarray(jtr.trace_function(fn)(jnp.asarray(x)))
    assert out.dtype == np.float32
    return np.broadcast_to(out, x.shape)


def _torch_values(fn, x):
    out = to_torch(ttr.trace_function(fn))(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == x.shape
    return out


@pytest.mark.parametrize("idx", range(len(ALL)))
def test_front_end_matches_jax(idx):
    x = _grid()
    fn = ALL[idx]
    np.testing.assert_allclose(
        _torch_values(fn, x), _jax_values(fn, x), rtol=2e-6, atol=1e-6
    )


def test_bench_results_bitwise_where_exact():
    """Arithmetic, comparisons and abs round the same in both: bit-equal."""
    x = _grid()
    for idx in (0, 1, 2, 3, 6, 7):
        np.testing.assert_array_equal(
            _torch_values(BENCH[idx], x), _jax_values(BENCH[idx], x)
        )


_SHIM = r"""
#include "integrand_math.cuh"
#include "integrands.inc"
extern "C" int tmc_k(void) { return TMC_K; }
extern "C" void tmc_eval(const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i) {
    float acc[TMC_K];
    for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
    tmc_accumulate(x[i], acc);
    for (int j = 0; j < TMC_K; ++j) out[i * TMC_K + j] = acc[j];
  }
}
extern "C" void tmc_values_at(const float* x, long n, float* out) {
  for (long i = 0; i < n; ++i) tmc_values(x[i], out + i * TMC_K);
}
"""


@pytest.fixture(scope="module")
def host_lowering(tmp_path_factory):
    """The C lowering of every test integrand, built as host C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("lowering")
    traced = [ttr.trace_function(f) for f in ALL]
    (d / "integrands.inc").write_text(cuda_source(traced))
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libintegrands.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-D__device__=", "-I", str(CSRC), "-I", str(d),
         str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_k.restype = ctypes.c_int
    lib.tmc_eval.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    lib.tmc_eval.restype = None
    lib.tmc_values_at.argtypes = lib.tmc_eval.argtypes
    lib.tmc_values_at.restype = None
    assert lib.tmc_k() == len(ALL)
    return lib


def test_c_lowering_matches_torch_lowering(host_lowering):
    x = _grid()
    out = np.empty((x.size, len(ALL)), np.float32)
    host_lowering.tmc_eval(x.ctypes.data, x.size, out.ctypes.data)
    for j, fn in enumerate(ALL):
        np.testing.assert_allclose(
            out[:, j], _torch_values(fn, x), rtol=2e-6, atol=1e-6,
            err_msg=f"integrand {j}",
        )


def test_c_values_entry_matches_accumulate(host_lowering):
    # tmc_values (the MCMC kernel's per-point entry) stores what
    # tmc_accumulate adds to zeroed sums: the same f_j(x), bit for bit.
    x = _grid()
    acc = np.empty((x.size, len(ALL)), np.float32)
    vals = np.empty_like(acc)
    host_lowering.tmc_eval(x.ctypes.data, x.size, acc.ctypes.data)
    host_lowering.tmc_values_at(x.ctypes.data, x.size, vals.ctypes.data)
    np.testing.assert_array_equal(vals, acc)


def test_cuda_source_shape():
    src = cuda_source([ttr.trace_function(f) for f in BENCH])
    assert "#define TMC_K 8" in src
    for j in range(8):
        assert f"static __device__ inline float f_{j}(float x)" in src
    assert "acc[7] += f_7(x);" in src
    assert "vals[7] = f_7(x);" in src
    # Integer powers are multiply chains, not powf.
    assert "powf" not in src


# d-ary integrands (the nd kernel's entries): a 3-argument set.
ND = [
    lambda x, y, z: x * y * z,
    lambda x, y, z: x * x + y + z,
    lambda x, y, z: np.exp(x) * np.exp(y) - z,
    lambda x, y, z: np.where(x > y, z, -z) + abs(x - z),
    lambda x, y, z: 2.5,
]

_ND_SHIM = r"""
#include "integrand_math.cuh"
#include "integrands_nd.inc"
extern "C" int tmc_d(void) { return TMC_D; }
// Per point: acc, sq (pilot-shifted squares) and vals, 3 x TMC_K floats.
extern "C" void tmc_eval_nd(const float* x, long n, const float* pilot,
                            float* out) {
  for (long i = 0; i < n; ++i) {
    float acc[TMC_K], sq[TMC_K], acc2[TMC_K];
    for (int j = 0; j < TMC_K; ++j) acc[j] = sq[j] = acc2[j] = 0.0f;
    tmc_accumulate_nd_sq(x + i * TMC_D, pilot, acc, sq);
    tmc_accumulate_nd(x + i * TMC_D, acc2);
    float* o = out + i * 3 * TMC_K;
    tmc_values_nd(x + i * TMC_D, o + 2 * TMC_K);
    for (int j = 0; j < TMC_K; ++j) {
      o[j] = acc[j];
      o[TMC_K + j] = sq[j];
      if (acc2[j] != acc[j]) o[j] = TMC_NAN;
    }
  }
}
"""


def test_c_lowering_of_d_ary_integrands(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    traced = [ttr.trace_function(f, 3) for f in ND]
    src = cuda_source(traced)
    assert "#define TMC_D 3" in src
    assert "static __device__ inline float f_0(const float* x) {" in src
    (tmp_path / "integrands_nd.inc").write_text(src)
    (tmp_path / "shim.cpp").write_text(_ND_SHIM)
    so = tmp_path / "libnd.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-D__device__=", "-I", str(CSRC), "-I", str(tmp_path),
         str(tmp_path / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_d.restype = ctypes.c_int
    lib.tmc_eval_nd.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.tmc_eval_nd.restype = None
    assert lib.tmc_d() == 3
    g = _grid()
    pts = np.ascontiguousarray(
        np.stack([g, np.roll(g, 7), np.roll(g, 501)], axis=1)
    )
    k = len(ND)
    pilot = np.linspace(-1.0, 1.0, k).astype(np.float32)
    out = np.empty((len(g), 3, k), np.float32)
    lib.tmc_eval_nd(pts.ctypes.data, len(g), pilot.ctypes.data, out.ctypes.data)
    cols = [torch.from_numpy(np.ascontiguousarray(pts[:, i])) for i in range(3)]
    for j, fn in enumerate(traced):
        want = to_torch(fn)(*cols).numpy()
        got_acc, got_sq, got_vals = out[:, 0, j], out[:, 1, j], out[:, 2, j]
        np.testing.assert_allclose(got_acc, want, rtol=2e-6, atol=1e-6)
        np.testing.assert_array_equal(got_vals, got_acc)
        dd = got_acc - pilot[j]
        np.testing.assert_array_equal(got_sq, dd * dd)
        jax_vals = np.asarray(jtr.trace_function(ND[j], 3)(*map(jnp.asarray, cols)))
        np.testing.assert_allclose(
            want, np.broadcast_to(jax_vals, want.shape), rtol=2e-6, atol=1e-6
        )


REJECTED = [
    lambda x: int(x),
    lambda x: float(x) + 1.0,
    lambda x: bool(x),
    lambda x: complex(x),
    lambda x: str(x),
    lambda x: len(x),
    lambda x: list(x),
    lambda x: math.gamma(x),
    lambda x: "text",
    lambda x: None,
]


def _no_return(x):
    y = x * 2.0  # noqa: F841


@pytest.mark.parametrize("idx", range(len(REJECTED) + 1))
def test_rejected_constructs_raise_trace_error(idx):
    fn = (REJECTED + [_no_return])[idx]
    with pytest.raises(jtr.TraceError) as want:
        jtr.trace_function(fn)
    with pytest.raises(ttr.TraceError) as got:
        ttr.trace_function(fn)
    assert str(got.value) == str(want.value)
    assert not ttr.is_traceable(fn)


def _with_while(x):
    n = 0.0
    while n < x:
        n = n + 1.0
    return n


NOT_PORTED = [
    _with_while,
    lambda x: jnp.logaddexp(x, 1.0),
    lambda x: jax.nn.relu(x),
]


@pytest.mark.parametrize("idx", range(len(NOT_PORTED)))
def test_constructs_not_ported_raise_not_implemented(idx):
    fn = NOT_PORTED[idx]
    jtr.trace_function(fn)  # the JAX package accepts it
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttr.trace_function(fn)
    assert not ttr.is_traceable(fn)


def test_function_fingerprint_matches_jax():
    for fn in (BENCH[4], _make_scaled(2.5), MORE[15], piecewise):
        assert ttr.function_fingerprint(fn) == jtr.function_fingerprint(fn)
    # Fresh closures over equal constants share a key; other values do not.
    assert ttr.function_fingerprint(_make_scaled(2.5)) == \
        ttr.function_fingerprint(_make_scaled(2.5))
    assert ttr.function_fingerprint(_make_scaled(2.5)) != \
        ttr.function_fingerprint(_make_scaled(3.0))
