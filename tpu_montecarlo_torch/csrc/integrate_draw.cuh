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
//   measured (0 ulp where p1 is a power of two);
// * the extended families take tmc::transform's row unchanged, from the
//   same [0, 1) uniform (float(top) * 2^-32).
//
// The MCMC kernels keep tmc::transform, whose bits their chains need.
//
// CUSTOM tables and importance-weight tables (integrate.cu's CUSTOM family
// and kernel weights) are read here too, each as ops/integrate_kernel.py's
// plain version reads it, operation for operation (built with
// --fmad=false, so no product is fused into a sum unless written so):
//
// * strata_x: the row-stratified inverse CDF, stratum pos >> 10 (row / 8)
//   of a 256-row tile's 32, knot j and fraction of w * 127;
// * knot_interp (counter_rng.cuh, shared with the MCMC kernels): a binary
//   search over sorted knots (the last with key <= u) and linear
//   interpolation, the knot-exact inverse CDF;
// * uniform_table_value: a padded uniform-grid pdf table, 0 off its grid;
// * nd_custom_x: the nd kernel's CUSTOM dimension on its route (strata,
//   the flat full inverse with its sampler density, or knots).
//
// Tables are read with __ldg (tmc::ldg, counter_rng.cuh) from global
// memory: (32, 128) float32 strata tables are 16 KB each and stay in L1;
// staging them in shared memory is left for later.
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

// tmc::transform(kind, top >> 8, p1, p2) under the rewrites above; an
// extended family takes tmc::ext_inv of the [0, 1) uniform as it is.
// Called with a compile-time kind, so the family's branch folds away.
__device__ __forceinline__ float transform_top(int kind, uint32_t top,
                                               const Family& f) {
  if (kind == kUniform) {
    return fminf(tmc_fma(float(top), f.scaled, f.p1), f.below);
  }
  if (kind == kNormal) return tmc_fma(f.p2, normal_z(top), f.p1);
  if (kind == kExponential) {
    return logf(fmaxf(open_top(top), kULo)) * f.neg_inv;
  }
  return ext_inv(kind, halfopen_top(top), f.p1, f.p2);
}

// The antithetic pair: the transform at u and at its mirror 1 - u (exact
// for u on the 2^-24 grid), the normal pair reflecting z about the mean;
// an extended family evaluates its inverse at 1 - u afresh.
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
  } else if (kind == kExponential) {
    const float u = open_top(top);
    a = logf(fmaxf(u, kULo)) * f.neg_inv;
    b = logf(fmaxf(1.0f - u, kULo)) * f.neg_inv;
  } else {
    const float u = halfopen_top(top);
    a = ext_inv(kind, u, f.p1, f.p2);
    b = ext_inv(kind, 1.0f - u, f.p1, f.p2);
  }
}

// The gradient builds (TMC_GRAD): transform_top's and transform_pair_top's
// samples, bit for bit, with each sample's derivatives in (p1, p2), d[0]
// and d[1], the pathwise derivatives jax.grad takes through the JAX
// package's transforms with the uniform held fixed
// (sampling.transform_grad_from_u is the plain twin): the uniform
// (1 - u, u) times the share of its clamp min(x, next_below(p2)) that
// reaches x (jnp.minimum's: 1 below, 0.5 at a tie, 0 on the clamp, whose
// bound is a stopped gradient); the normal (1, z), its mirror (1, -z);
// the exponential (-x / p1, 0); an extended family's tmc::ext_inv_grad.
__device__ __forceinline__ float uniform_grad(float pre, float below, float u,
                                              float* d) {
  const float share = pre < below ? 1.0f : (pre == below ? 0.5f : 0.0f);
  d[0] = share * (1.0f - u);
  d[1] = share * u;
  return fminf(pre, below);
}

__device__ __forceinline__ float transform_top_grad(int kind, uint32_t top,
                                                    const Family& f,
                                                    float* d) {
  if (kind == kUniform) {
    return uniform_grad(tmc_fma(float(top), f.scaled, f.p1), f.below,
                        halfopen_top(top), d);
  }
  if (kind == kNormal) {
    const float z = normal_z(top);
    d[0] = 1.0f;
    d[1] = z;
    return tmc_fma(f.p2, z, f.p1);
  }
  if (kind == kExponential) {
    const float x = logf(fmaxf(open_top(top), kULo)) * f.neg_inv;
    d[0] = x * f.neg_inv;
    d[1] = 0.0f;
    return x;
  }
  return ext_inv_grad(kind, halfopen_top(top), f.p1, f.p2, d[0], d[1]);
}

__device__ __forceinline__ void transform_pair_top_grad(int kind,
                                                        uint32_t top,
                                                        const Family& f,
                                                        float& a, float& b,
                                                        float* da,
                                                        float* db) {
  if (kind == kUniform) {
    const float u = halfopen_top(top);
    const float v = 1.0f - u;  // exact
    a = uniform_grad(tmc_fma(float(top), f.scaled, f.p1), f.below, u, da);
    b = uniform_grad(tmc_fma(v, f.width, f.p1), f.below, v, db);
  } else if (kind == kNormal) {
    const float z = normal_z(top);
    a = tmc_fma(f.p2, z, f.p1);
    b = tmc_fma(-f.p2, z, f.p1);
    da[0] = db[0] = 1.0f;
    da[1] = z;
    db[1] = -z;
  } else if (kind == kExponential) {
    const float u = open_top(top);
    a = logf(fmaxf(u, kULo)) * f.neg_inv;
    b = logf(fmaxf(1.0f - u, kULo)) * f.neg_inv;
    da[0] = a * f.neg_inv;
    db[0] = b * f.neg_inv;
    da[1] = db[1] = 0.0f;
  } else {
    const float u = halfopen_top(top);
    a = ext_inv_grad(kind, u, f.p1, f.p2, da[0], da[1]);
    b = ext_inv_grad(kind, 1.0f - u, f.p1, f.p2, db[0], db[1]);
  }
}

constexpr int kStrata = 32;  // strata of a 256-row tile (STRATA)
// A position's stratum: pos >> kStratumShift = (pos / 128) / (256 / 32).
constexpr int kStratumShift = 10;
constexpr float kW127 = 127.0f * kInv2Pow32;  // exact

// One importance-weight density's table (ops/integrate_kernel.py
// _WeightTab): a padded uniform-grid table (vals, dx, x0, step, x_max, n
// padded knots), or an irregular grid (keys, vals, x0 = keys[0], x_max =
// keys[n - 1], n knots).
struct WeightTab {
  const float* keys;
  const float* vals;
  const float* dx;
  float x0, step, x_max;
  int n;
};

// Every table a launch reads (ops/integrate_kernel.py _KernelTables).
struct Tables {
  const float* ts;   // strata: (kStrata, 128) knots
  const float* dts;  // strata: slopes
  const float* qs;   // strata: the sampler's density, or null
  const float* xk;   // knots: x knots
  const float* ck;   // knots: CDF knots
  int m;             // knots: knot count
  WeightTab p, q;
};

// The stratified draw at the top-24 word of w (w = top * 2^-32, in [0, 1))
// for the position pos of its tile; *q gets the sampler's density where
// WITH_Q.  w * 127 is top * (127 * 2^-32): a power of two scales exactly.
// The (kStrata, 128) tables' draw at pw for position pos; `idx` gets the
// table index it read, where a sampler's density sits in its qs table.
__device__ __forceinline__ float strata_lookup(const float* ts,
                                               const float* dts, uint32_t pos,
                                               float pw, int& idx) {
  const int j = int(pw);  // pw >= 0: truncation
  const float frac = pw - float(j);
  idx = int(pos >> kStratumShift) * kLanes + j;
  return ldg(ts + idx) + frac * ldg(dts + idx);
}

template <bool WITH_Q>
__device__ __forceinline__ float strata_x(const Tables& tb, uint32_t pos,
                                          float pw, float* q) {
  int idx;
  const float x = strata_lookup(tb.ts, tb.dts, pos, pw, idx);
  if constexpr (WITH_Q) *q = ldg(tb.qs + idx);
  return x;
}

// A padded uniform-grid table at x (tmc::grid_table_value), 0 off
// [x0, x_max].
__device__ __forceinline__ float uniform_table_value(float x,
                                                     const WeightTab& t) {
  return grid_table_value(x, t.vals, t.dx, t.x0, t.step, t.x_max, t.n, 0.0f);
}

// An irregular-grid table at x: knot_interp, 0 off [x0, x_max].
__device__ __forceinline__ float knot_table_value(float x,
                                                  const WeightTab& t) {
  return (x >= t.x0 && x <= t.x_max) ? knot_interp(x, t.keys, t.vals, t.n)
                                     : 0.0f;
}

// -- CUSTOM dimensions and product weights of the nd integrate kernel ----

// A CUSTOM dimension's route in integrate_nd.cu (TMC_ROUTES): the
// row-stratified tables (the first CUSTOM dimension under mc and
// antithetic), the flat full inverse (the others, and every one under
// qmc), or the knot-exact inverse of a heavy-tailed table.
enum NdRoute { kNdAnalytic = 0, kNdStrata = 1, kNdFlat = 2, kNdKnots = 3 };

// One dimension's tables in the nd kernel (ops/integrate_nd_kernel.py
// _NdDim): t and dt are the strata tables' knots and slopes, the flat
// inverse's m knots and its forward differences (a gapped table's
// slopes), or the knot route's x and CDF knots; qs is the strata tables'
// sampler density (sampler-mode q only); inv_du = float32(1 / (m - 1));
// p and q are the weight's tables, where its mode reads one.
struct NdDim {
  const float* t;
  const float* dt;
  const float* qs;
  float inv_du;
  int m;
  WeightTab p, q;
};

// The flat inverse's sampler density at a draw of slope dt (the JAX nd
// kernel's full-inverse sampler q): (1 / (m - 1)) / dt, 0 where dt is 0.
__device__ __forceinline__ float flat_sampler_q(float dt, float inv_du) {
  return dt > 0.0f ? inv_du / fmaxf(dt, 1e-38f) : 0.0f;
}

// A CUSTOM dimension's sample at the [0, 1) uniform w of position pos on
// `route` (pw = w * 127, the strata tables' knot position, passed in: it
// is float(top) * kW127 for a top-24 word); *q gets the sampler's density
// where WITH_Q (strata: its qs table; flat: flat_sampler_q).
template <bool WITH_Q>
__device__ __forceinline__ float nd_custom_x(int route, float w, float pw,
                                             uint32_t pos, const NdDim& d,
                                             float* q) {
  if (route == kNdStrata) {
    int idx;
    const float x = strata_lookup(d.t, d.dt, pos, pw, idx);
    if constexpr (WITH_Q) *q = ldg(d.qs + idx);
    return x;
  }
  if (route == kNdFlat) {
    float slope;
    const float x = inverse_table_u(w, d.t, d.dt, d.m, slope);
    if constexpr (WITH_Q) *q = flat_sampler_q(slope, d.inv_du);
    return x;
  }
  return knot_interp(w, d.dt, d.t, d.m);
}

// One dimension's factor of the product weight, where(q > 0, p / q, 0),
// with p and q given.
__device__ __forceinline__ float weight_ratio(float p, float q) {
  const bool ok = q > 0.0f;
  const float safe_q = ok ? q : 1.0f;
  return ok ? p / safe_q : 0.0f;
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
