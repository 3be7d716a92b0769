"""The integrate kernels' stream cursor, tile walk and family transforms
(``csrc/counter_rng.cuh``, ``csrc/integrate_draw.cuh``), compiled with the
host's g++ and held against the formulas the rest of the port uses.

* The cursor gives the bits of ``tmc::mantissa`` and of the torch
  ``CounterRng`` at every position of a tile, for several (seed, program,
  block, tag): largest gap 0.
* ``TileWalk`` steps (program, block) as ``divmod(tile, loops)`` and seeds
  each program's stream as ``tmc::seed_state``.
* ``default_unroll`` keeps a loop body to about 8 uniforms and 64
  integrand calls.
* Each rewritten transform is held against the reference formula
  (``tmc::transform``, which the MCMC kernels and the plain version follow;
  the antithetic pair as written below) over all 2^24 mantissas.  The
  extended families' rows are not rewritten: bit-equal.  Built
  with ``TMC_CONTRACT=0`` the uniform and normal rewrites (the 2^-32 and
  2^-31 scalings, the clamps) are bit-equal.  With the fused multiply-adds
  of the default build, the largest gap allowed is 1 ulp of the larger
  term of the affine step (max(|p1|, |x - p1|), the scale at which the
  reference rounds too).  The exponential's multiply by -1 / p1 in place
  of the division: at most EXP_ULPS ulp of the reference sample, the bound
  measured over these parameters (0 where p1 is a power of two).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.ops.integrate_kernel import CounterRng
from tpu_montecarlo_torch.sampling import ANALYTIC_EXT, DistKind

N_MANTISSAS = 1 << 24
TILE = 1 << 15
# Largest gap, in ulp of the reference exponential sample, of log(u) * (-1
# / p1) against -log(u) / p1 over all mantissas and the rates below.
EXP_ULPS = 1

_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
// A float32 inverse error function (Giles, 2010).  Any one serves: the
// reference formula and the rewrite call the same.
static inline float erfinvf(float x) {
  float w = -logf((1.0f - x) * (1.0f + x)), p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * w;
    p = -3.5233877e-06f + p * w;
    p = -4.39150654e-06f + p * w;
    p = 0.00021858087f + p * w;
    p = -0.00125372503f + p * w;
    p = -0.00417768164f + p * w;
    p = 0.246640727f + p * w;
    p = 1.50140941f + p * w;
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = 0.000100950558f + p * w;
    p = 0.00134934322f + p * w;
    p = -0.00367342844f + p * w;
    p = 0.00573950773f + p * w;
    p = -0.0076224613f + p * w;
    p = 0.00943887047f + p * w;
    p = 1.00167406f + p * w;
    p = 2.83297682f + p * w;
  }
  return p * x;
}
#include "integrate_draw.cuh"
#include "sobol.cuh"
using namespace tmc;

// Position t + 256 i of the tile, as the kernels walk it: thread t steps
// its cursor word by 256 positions.
extern "C" void tile_cursor(uint32_t seed, uint32_t pid, uint32_t blk,
                            uint32_t tag, uint32_t* out) {
  const uint32_t base = block_base(seed_state(seed, pid), blk, tag);
  const uint32_t step = 256u * kCursorStride;
  for (uint32_t t = 0; t < 256u; ++t) {
    const uint32_t x0 = cursor(base, t);
    for (uint32_t i = 0; i < 128u; ++i) out[t + 256u * i] = cursor_top24(x0 + i * step);
  }
}

extern "C" void tile_mantissa(uint32_t seed, uint32_t pid, uint32_t blk,
                              uint32_t tag, uint32_t* out) {
  const uint32_t base = block_base(seed_state(seed, pid), blk, tag);
  for (uint32_t pos = 0; pos < 32768u; ++pos) out[pos] = mantissa(base, pos);
}

extern "C" void sobol_words(const uint32_t* word, uint32_t shift, long n,
                            uint32_t* top) {
  for (long i = 0; i < n; ++i) top[i] = sobol_top24(word[i], shift);
}

extern "C" int unroll(int k, int d) { return default_unroll(k, d); }

extern "C" void walk(uint32_t seed, uint32_t loops, uint32_t first,
                     uint32_t stride, int n, uint32_t* pid, uint32_t* blk,
                     uint32_t* state, uint32_t* seeded) {
  TileWalk w(seed, loops, first, stride);
  for (int k = 0; k < n; ++k) {
    state[k] = w.stream();
    pid[k] = w.pid;
    blk[k] = w.blk;
    seeded[k] = seed_state(seed, w.pid);
    w.next();
  }
}

// The antithetic pair in the reference's float32 operations: two
// roundings per affine step, the clamp as a compare, an IEEE division.
static void reference_pair(int kind, uint32_t m, float p1, float p2, float& a,
                        float& b) {
  if (kind == kUniform) {
    const float u = halfopen01(m);
    const float xa = p1 + u * (p2 - p1);
    const float xb = p1 + (1.0f - u) * (p2 - p1);
    a = xa >= p2 ? next_below(p2) : xa;
    b = xb >= p2 ? next_below(p2) : xb;
  } else if (kind == kNormal) {
    const float z = normal_from_u01(halfopen01(m));
    a = p1 + p2 * z;
    b = p1 - p2 * z;
  } else if (kind == kExponential) {
    const float u = open01(m);
    a = -logf(fmaxf(u, kULo)) / p1;
    b = -logf(fmaxf(1.0f - u, kULo)) / p1;
  } else {
    const float u = halfopen01(m);
    a = ext_inv(kind, u, p1, p2);
    b = ext_inv(kind, 1.0f - u, p1, p2);
  }
}

// Every mantissa's sample (pair = 0) or pair (pair = 1, a then b): the
// reference formula and the rewrite.
extern "C" void samples(int kind, int pair, float p1, float p2,
                        float* reference, float* rewrite) {
  const Family f = family(p1, p2);
  for (uint32_t m = 0; m < (1u << 24); ++m) {
    if (pair) {
      reference_pair(kind, m, p1, p2, reference[m], reference[m + (1u << 24)]);
      transform_pair_top(kind, m << 8, f, rewrite[m], rewrite[m + (1u << 24)]);
    } else {
      reference[m] = transform(kind, m, p1, p2);
      rewrite[m] = transform_top(kind, m << 8, f);
    }
  }
}
"""


def _build(tmp_path_factory, contract: int):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(f"stream{contract}")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libstream.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-DTMC_CONTRACT={contract}", "-I", str(CSRC),
         str(d / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    u32, ptr = ctypes.c_uint32, ctypes.c_void_p
    lib.tile_cursor.argtypes = [u32] * 4 + [ptr]
    lib.tile_mantissa.argtypes = [u32] * 4 + [ptr]
    lib.sobol_words.argtypes = [ptr, u32, ctypes.c_long, ptr]
    lib.walk.argtypes = [u32] * 4 + [ctypes.c_int] + [ptr] * 4
    lib.unroll.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.unroll.restype = ctypes.c_int
    lib.samples.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_float, ptr, ptr]
    for fn in (lib.tile_cursor, lib.tile_mantissa, lib.sobol_words, lib.walk,
               lib.samples):
        fn.restype = None
    return lib


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The header as the kernels build it (TMC_CONTRACT=1)."""
    return _build(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def unfused(tmp_path_factory):
    return _build(tmp_path_factory, 0)


STREAMS = [(42, 0, 0, 0), (42, 3, 17, 1), (7, 0, 511, 2), (0xFFFFFFFF, 63, 5, 7),
           (2**31 + 5, 1000, 0, 31)]


@pytest.mark.parametrize("seed,pid,blk,tag", STREAMS)
def test_cursor_is_the_counter_stream(fused, seed, pid, blk, tag):
    cur = np.empty(TILE, np.uint32)
    ref = np.empty(TILE, np.uint32)
    fused.tile_cursor(seed, pid, blk, tag, cur.ctypes.data)
    fused.tile_mantissa(seed, pid, blk, tag, ref.ctypes.data)
    np.testing.assert_array_equal(cur, ref << np.uint32(8))
    bits = CounterRng(seed, pid).bits((256, 128), blk, tag).reshape(-1).numpy()
    np.testing.assert_array_equal(cur.astype(np.int64), bits & 0xFFFFFF00)


def test_sobol_top24_is_the_mantissa_in_place(fused):
    # The rotated word's top 24 bits, (word + shift) >> 8 as the JAX
    # package's Sobol uniforms take them, shifted back in place.
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    top = np.empty_like(words)
    for shift in (0, 0x9E3779B9, 0xFFFFFFFF):
        fused.sobol_words(words.ctypes.data, shift, words.size, top.ctypes.data)
        want = (words + np.uint32(shift)) >> np.uint32(8) << np.uint32(8)
        np.testing.assert_array_equal(top, want)


@pytest.mark.parametrize("loops,first,stride", [
    (512, 0, 8192), (512, 511, 8192), (8, 3, 8192), (1, 5, 7), (3, 2, 2),
    (512, 8191, 528), (24, 100, 1056),
])
def test_tile_walk_steps_as_divmod(fused, loops, first, stride):
    n = 200
    out = [np.empty(n, np.uint32) for _ in range(4)]
    fused.walk(42, loops, first, stride, n, *(o.ctypes.data for o in out))
    pid, blk, state, seeded = out
    tiles = first + stride * np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(pid, tiles // loops)
    np.testing.assert_array_equal(blk, tiles % loops)
    np.testing.assert_array_equal(state, seeded)
    want = CounterRng(42, torch.from_numpy(tiles // loops)).state.numpy()
    np.testing.assert_array_equal(state.astype(np.int64), want)


# The integrate kernels' samples (nd: positions) per loop body: the power
# of two at or below min(8 // d, 64 // K), at least 1.
@pytest.mark.parametrize("k,d,want", [
    (1, 1, 8), (8, 1, 8), (9, 1, 4), (16, 1, 4), (24, 1, 2), (32, 1, 2),
    (64, 1, 1), (128, 1, 1), (2, 3, 2), (1, 2, 4), (128, 2, 1), (1, 9, 1),
])
def test_default_unroll_keeps_a_body_small(fused, k, d, want):
    assert fused.unroll(k, d) == want


FAMILIES = [
    (DistKind.UNIFORM, -1.0, 2.0), (DistKind.UNIFORM, 0.0, 1.0),
    (DistKind.UNIFORM, -2.0, 0.0), (DistKind.UNIFORM, 1000.0, 1000.5),
    (DistKind.NORMAL, 0.0, 1.0), (DistKind.NORMAL, 0.5, 1.5),
    (DistKind.NORMAL, -1.0, 0.5),
    (DistKind.EXPONENTIAL, 2.0, 0.0), (DistKind.EXPONENTIAL, 1.5, 0.0),
    (DistKind.EXPONENTIAL, 1.0, 0.0), (DistKind.EXPONENTIAL, 0.3, 0.0),
    (DistKind.LOGNORMAL, 0.0, 0.5), (DistKind.CAUCHY, 0.0, 1.0),
    (DistKind.LAPLACE, 3.0, 1.0), (DistKind.LOGISTIC, 0.0, 2.0),
    (DistKind.GUMBEL, 1.0, 0.5), (DistKind.WEIBULL, 1.5, 2.0),
    (DistKind.PARETO, 1.0, 3.0),
]
IDS = [f"{k.name.lower()}({p1},{p2})" for k, p1, p2 in FAMILIES]


def _samples(lib, kind, pair, p1, p2):
    n = N_MANTISSAS * (2 if pair else 1)
    reference, rewrite = np.empty(n, np.float32), np.empty(n, np.float32)
    lib.samples(int(kind), int(pair), p1, p2, reference.ctypes.data,
                rewrite.ctypes.data)
    assert np.all(np.isfinite(reference))
    return reference, rewrite


def _ulps(reference, rewrite, scale):
    return np.abs(rewrite.astype(np.float64) - reference) / np.spacing(
        np.abs(scale).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("pair", [False, True], ids=["sample", "pair"])
@pytest.mark.parametrize("kind,p1,p2", FAMILIES, ids=IDS)
def test_transforms_within_their_ulp_bounds(fused, unfused, kind, p1, p2,
                                            pair):
    reference, rewrite = _samples(fused, kind, pair, p1, p2)
    if kind in ANALYTIC_EXT:
        # The extended families take tmc::transform's row as it is.
        np.testing.assert_array_equal(rewrite, reference)
        return
    if kind == DistKind.EXPONENTIAL:
        assert _ulps(reference, rewrite, reference).max() <= EXP_ULPS
        if float(np.log2(p1)).is_integer():
            np.testing.assert_array_equal(rewrite, reference)
        return
    # The affine step's larger term: p1 or the scaled uniform / normal.
    scale = np.maximum(np.abs(np.float32(p1)), np.abs(reference - np.float32(p1)))
    assert _ulps(reference, rewrite, np.maximum(scale, np.abs(reference))).max() <= 1
    if kind == DistKind.UNIFORM:
        assert np.all(rewrite < np.float32(p2)) and np.all(rewrite >= np.float32(p1))
    # Without the fused multiply-adds the rewrite is the reference's formula.
    reference0, rewrite0 = _samples(unfused, kind, pair, p1, p2)
    np.testing.assert_array_equal(reference0, reference)
    np.testing.assert_array_equal(rewrite0, reference)
