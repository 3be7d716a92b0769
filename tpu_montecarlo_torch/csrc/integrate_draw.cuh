// The integrate kernels' family transforms (integrate.cu, integrate_nd.cu),
// written for the fewest instructions per sample.
//
// They take the top 24 bits of a uniform word in place (tmc::cursor_top24,
// or a rotated Sobol word with its low 8 bits cleared) and give the
// samples of tmc::transform and of the antithetic pair with these
// rewrites, each held against tmc::transform over all 2^24 mantissas
// by tests/test_torch_integrate_stream.py:
//
// * float(top) * 2^-32 is float(top >> 8) * 2^-24 bit for bit (top has at
//   most 24 significant bits, so both are exact), and (0, 1] adds 2^-24
//   exactly: the uniforms are unchanged;
// * the uniform family scales float(top) by (p2 - p1) * 2^-32 at once (the
//   power of two is exact), and its clamp below the open bound p2 is a min
//   with next_below(p2): a sample below p2 is at most next_below(p2);
// * the normal family's 2u - 1 is float(top) * 2^-31 - 1, exact, clamped
//   to the images of u's clamp [1e-7, 1 - 1e-7] (2u - 1 is monotone);
// * the affine steps p1 + u * (p2 - p1), p1 + p2 * z and p1 - p2 * z round
//   once (tmc_fma), at most one ulp of the larger term from tmc::transform's
//   two roundings;
// * the exponential multiplies log(u) by -1 / p1, computed once per
//   thread, where tmc::transform divides: within the bound that test
//   measured (0 ulp where p1 is a power of two).
//
// The MCMC kernels keep tmc::transform, whose bits their chains need.
#pragma once

#include <cstdint>

#include "counter_rng.cuh"
#include "integrand_math.cuh"

namespace tmc {

constexpr float kInv2Pow32 = 1.0f / 4294967296.0f;
constexpr float kInv2Pow31 = 1.0f / 2147483648.0f;
// 2 * kULo - 1 and 2 * kUHi - 1 in float32: the clamp of 2u - 1.
constexpr float kVLo = -0x1.fffffap-1f;
constexpr float kVHi = 0x1.fffff8p-1f;

// Samples (nd: positions) per loop body for k integrands of a point of d
// uniforms: about 8 uniforms' worth and at most 64 / k samples, so that a
// body of k integrands stays in the instruction cache, as a power of two
// (the choice of tools/integrate_sweep.py on an H100, PERF.md section 6).
constexpr int default_unroll(int k, int d) {
  const int n = 8 / d < 64 / k ? 8 / d : 64 / k;
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// [0, 1) and (0, 1] uniforms of a top-24 word.
__device__ __forceinline__ float halfopen_top(uint32_t top) {
  return float(top) * kInv2Pow32;
}

__device__ __forceinline__ float open_top(uint32_t top) {
  return fmaf(float(top), kInv2Pow32, kInv2Pow24);  // exact: one rounding
}

// One dimension's parameters, as each sample reads them: (p1, p2) of
// tmc::transform and what a thread computes from them once.
struct Family {
  float p1, p2;
  float width;    // uniform: p2 - p1
  float scaled;   // uniform: (p2 - p1) * 2^-32
  float below;    // uniform: next_below(p2), the largest sample
  float neg_inv;  // exponential: -1 / p1
};

__device__ __forceinline__ Family family(float p1, float p2) {
  return Family{p1, p2, p2 - p1, (p2 - p1) * kInv2Pow32, next_below(p2),
                -(1.0f / p1)};
}

// kSqrt2 * erfinvf(2u - 1) of u = clamp(top * 2^-32, kULo, kUHi).
__device__ __forceinline__ float normal_z(uint32_t top) {
  const float v = fmaf(float(top), kInv2Pow31, -1.0f);  // exact
  return kSqrt2 * erfinvf(fminf(fmaxf(v, kVLo), kVHi));
}

// tmc::transform(kind, top >> 8, p1, p2) under the rewrites above.  Called
// with a compile-time kind, so the family's branch folds away.
__device__ __forceinline__ float transform_top(int kind, uint32_t top,
                                               const Family& f) {
  if (kind == kUniform) {
    return fminf(tmc_fma(float(top), f.scaled, f.p1), f.below);
  }
  if (kind == kNormal) return tmc_fma(f.p2, normal_z(top), f.p1);
  return logf(fmaxf(open_top(top), kULo)) * f.neg_inv;
}

// The antithetic pair: the transform at u and at its mirror 1 - u (exact
// for u on the 2^-24 grid), the normal pair reflecting z about the mean.
__device__ __forceinline__ void transform_pair_top(int kind, uint32_t top,
                                                   const Family& f, float& a,
                                                   float& b) {
  if (kind == kUniform) {
    a = fminf(tmc_fma(float(top), f.scaled, f.p1), f.below);
    b = fminf(tmc_fma(1.0f - halfopen_top(top), f.width, f.p1), f.below);
  } else if (kind == kNormal) {
    const float z = normal_z(top);
    a = tmc_fma(f.p2, z, f.p1);
    b = tmc_fma(-f.p2, z, f.p1);
  } else {
    const float u = open_top(top);
    a = logf(fmaxf(u, kULo)) * f.neg_inv;
    b = logf(fmaxf(1.0f - u, kULo)) * f.neg_inv;
  }
}

// A CUDA block's walk over the tiles first, first + stride, ... of a plan
// of programs x loops tiles, tile = pid * loops + blk: (pid, blk) step by
// (stride / loops, stride % loops), with no 64-bit division per tile, and
// the program's stream state is seeded only when pid changes.
struct TileWalk {
  uint32_t seed, loops, step_pid, step_blk, pid, blk, seeded, state;

  __device__ __forceinline__ TileWalk(uint32_t seed_word, uint32_t n_loops,
                                      uint32_t first, uint32_t stride)
      : seed(seed_word),
        loops(n_loops),
        step_pid(stride / n_loops),
        step_blk(stride % n_loops),
        pid(first / n_loops),
        blk(first % n_loops),
        seeded(first / n_loops),
        state(seed_state(seed_word, first / n_loops)) {}

  // CounterRng(seed, pid).state of the current tile's program.
  __device__ __forceinline__ uint32_t stream() {
    if (pid != seeded) {
      seeded = pid;
      state = seed_state(seed, pid);
    }
    return state;
  }

  __device__ __forceinline__ void next() {
    pid += step_pid;
    blk += step_blk;
    if (blk >= loops) {
      blk -= loops;
      ++pid;
    }
  }
};

}  // namespace tmc
