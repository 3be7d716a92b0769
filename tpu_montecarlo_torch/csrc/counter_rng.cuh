// The counter-based sample stream, the family transforms and the family
// log densities, shared by the port's kernels.
//
// tmc::pcg is the PCG output mix of the JAX package's CounterRng
// (tpu_montecarlo/ops/integrate_pallas.py:107-133, ops/qmc.py _pcg_mix):
// a stream is seeded per (seed word, program), a draw with block counter
// c and tag t takes base = pcg(state + c * 15485863 + t * 7199369), and
// position pos = row * 128 + lane gets the bits pcg(base + pos *
// 2654435761).  Uniforms come from the top 24 bits; tmc::transform turns
// them into a sample of the family with the JAX kernels' formulas and
// float32 operation order (sampling.normal_from_u01, the exponential
// inverse transform, the uniform's clamp below its open bound, and the
// extended families' registry rows, sampling.ANALYTIC_EXT), and
// tmc::log_pdf the MCMC kernels' closed-form log densities.
//
// The extended families (kLognormal .. kPareto) are one row each: an
// inverse CDF of a [0, 1) uniform, which clamps it into [1e-7, 1 - 1e-7]
// (tmc::ext_inv), and a log density floored at kLogPdfFloor
// (tmc::ext_log_pdf), in the JAX expressions' float32 order (the kernels
// build with --fmad=false).  Cauchy's tangent is the JAX package's
// polynomial (tmc::fast_tan, ops/fast_math.py there), not libdevice tanf:
// that polynomial, with the fused multiply-adds the JAX package's CPU
// compiler gives it, defines its Cauchy samples.  A kernel
// calls these rows with a compile-time family, so a library compiles in
// only the rows it draws.
//
// The CUSTOM family's table primitives follow: a table read (tmc::ldg),
// the flat inverse-CDF draw with its slope, the padded uniform-grid
// table's lookup, the knot search with linear interpolation (knot_interp,
// the integrate kernels' knot-exact inverse too), and the MCMC kernels'
// per-dimension table references (TableRef, McmcTables) with their draws
// (flat or knot-exact), sampler-mode density and log table lookups
// (uniform or irregular grid), each as ops/mcmc_tables.py's plain version
// computes it.
#pragma once

#include <cstdint>

namespace tmc {

constexpr int kLanes = 128;
constexpr float kInv2Pow24 = 1.0f / 16777216.0f;
constexpr float kULo = 1e-7f;
constexpr float kUHi = 0.99999988079071044921875f;  // float32(1 - 1e-7)
constexpr float kSqrt2 = 1.41421353816986083984375f;  // float32(sqrt 2)
constexpr float kSqrt2Pi = 2.5066282749176025390625f;  // float32(2.50662827463)
constexpr float kLogPdfFloor = -100.0f;

enum Kind {
  kUniform = 0,
  kNormal = 1,
  kExponential = 2,
  kCustom = 3,
  kLognormal = 4,
  kCauchy = 5,
  kLaplace = 6,
  kLogistic = 7,
  kGumbel = 8,
  kWeibull = 9,
  kPareto = 10,
};

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  const uint32_t word = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (word >> 22u) ^ word;
}

// CounterRng(words...).seed: the stream state of one program.
__device__ __forceinline__ uint32_t seed_state(uint32_t seed, uint32_t pid) {
  return pcg(pcg(0x9E3779B9u ^ seed) ^ pid);
}

// The base of one (counter, tag) block of a program's stream.
__device__ __forceinline__ uint32_t block_base(uint32_t state, uint32_t counter,
                                               uint32_t tag) {
  return pcg(state + counter * 15485863u + tag * 7199369u);
}

// The 24-bit mantissa of position pos in the block at `base`.
__device__ __forceinline__ uint32_t mantissa(uint32_t base, uint32_t pos) {
  return pcg(base + pos * 2654435761u) >> 8;
}

// The stream cursor, for loops that walk a block's positions (the
// integrate kernels).  The hash of position pos starts with two affine
// steps, x = (base + pos * 2654435761) * 747796405 + 2891336453 mod 2^32,
// which is cursor(base, 0) + pos * kCursorStride: a thread that walks
// pos0, pos0 + s, ... steps one word by s * kCursorStride and finishes
// the hash from it (cursor_top24), with the bits of tmc::mantissa.
constexpr uint32_t kCursorStride = 2654435761u * 747796405u;  // mod 2^32

__device__ __forceinline__ uint32_t cursor(uint32_t base, uint32_t pos) {
  return (base + pos * 2654435761u) * 747796405u + 2891336453u;
}

// mantissa(base, pos) << 8 from the cursor word x of pos: the top 24 bits
// of the hash in place, the low 8 cleared in the same logic operation.
__device__ __forceinline__ uint32_t cursor_top24(uint32_t x) {
  const uint32_t word = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return ((word >> 22u) ^ word) & 0xFFFFFF00u;
}

__device__ __forceinline__ float halfopen01(uint32_t m) {  // [0, 1)
  return float(m) * kInv2Pow24;
}

__device__ __forceinline__ float open01(uint32_t m) {  // (0, 1]
  return float(m + 1u) * kInv2Pow24;
}

__device__ __forceinline__ float next_below(float hi) {
  const int bits = __float_as_int(hi);
  const int dec = hi > 0.0f ? bits - 1 : (hi < 0.0f ? bits + 1 : -2147483647);
  return __int_as_float(dec);
}

__device__ __forceinline__ float normal_from_u01(float u) {
  u = fminf(fmaxf(u, kULo), kUHi);
  return kSqrt2 * erfinvf(2.0f * u - 1.0f);
}

// -- The extended families -------------------------------------------------

constexpr float kPiF = 0x1.921fb6p+1f;          // float32(pi)
constexpr float kPiHi = 3.140625f;                // 201 / 64, 8 bits
constexpr float kPiLo = 0x1.fb5444p-11f;          // float32(pi - kPiHi)
constexpr float kInvPi = 0x1.45f306p-2f;          // float32(1 / pi)
constexpr float kTiny = 0x1.4484c0p-100f;         // float32(1e-30)
constexpr float kCauchySplit = 0x1.c6bf52p+49f;   // float32(1e15)

// The JAX package's fast_tan: k = round(x / pi) half to even, r = (x - k
// pi_hi) - k pi_lo, tan = sin_poly(r) / cos_poly(r) (the signs cancel),
// with the fused multiply-adds XLA's CPU compiler makes of it under jit
// (sampling.fast_tan): the reduction's last step, each Horner step, the
// sine's r + (r s) p and the cosine's 1 + s p.
__device__ __forceinline__ float fast_tan(float x) {
  const float k = rintf(x * kInvPi);
  const float r = fmaf(-k, kPiLo, x - k * kPiHi);
  const float s = r * r;
  float ps = fmaf(2.6000516e-06f, s, -1.9806616e-04f);
  ps = fmaf(ps, s, 8.333017e-03f);
  ps = fmaf(ps, s, -1.6666657e-01f);
  float pc = fmaf(-2.6077066e-07f, s, 2.4761885e-05f);
  pc = fmaf(pc, s, -1.3888404e-03f);
  pc = fmaf(pc, s, 4.166664e-02f);
  pc = fmaf(pc, s, -5e-01f);
  return fmaf(r * s, ps, r) / fmaf(s, pc, 1.0f);
}

__device__ __forceinline__ float clip_u(float u) {
  return fminf(fmaxf(u, kULo), kUHi);
}

// An extended family's inverse CDF at the uniform u: lognormal (mu, sigma),
// Cauchy, Laplace, logistic and Gumbel (loc, scale), Weibull (shape,
// scale), Pareto (x_min, alpha).
__device__ __forceinline__ float ext_inv(int kind, float u, float p1,
                                         float p2) {
  if (kind == kLognormal) return expf(p1 + p2 * normal_from_u01(u));
  if (kind == kCauchy) {
    return fmaf(p2, fast_tan(kPiF * (clip_u(u) - 0.5f)), p1);
  }
  if (kind == kLaplace) {
    const float t = clip_u(u) - 0.5f;
    const float mag = -logf(1.0f - 2.0f * fabsf(t));
    return p1 + p2 * (t >= 0.0f ? mag : -mag);
  }
  if (kind == kLogistic) {
    const float uc = clip_u(u);
    return p1 + p2 * logf(uc / (1.0f - uc));
  }
  if (kind == kGumbel) return p1 - p2 * logf(-logf(clip_u(u)));
  if (kind == kWeibull) {
    const float e = -logf(clip_u(u));
    return p2 * expf(logf(e) / p1);
  }
  return p1 * expf(-logf(clip_u(u)) / p2);  // kPareto
}

// ext_inv's sample (bit for bit) with its derivatives in (p1, p2) at the
// fixed uniform u, d1 and d2: the pathwise derivatives jax.grad takes
// through the JAX package's registry inverse, in its float32 grouping
// (sampling.transform_grad_from_u is the plain twin).  clip_u does not
// depend on the parameters.
__device__ __forceinline__ float ext_inv_grad(int kind, float u, float p1,
                                              float p2, float& d1,
                                              float& d2) {
  if (kind == kLognormal) {
    const float z = normal_from_u01(u);
    const float x = expf(p1 + p2 * z);
    d1 = x;
    d2 = x * z;
    return x;
  }
  d1 = 1.0f;
  if (kind == kCauchy) {
    const float t = fast_tan(kPiF * (clip_u(u) - 0.5f));
    d2 = t;
    return fmaf(p2, t, p1);
  }
  if (kind == kLaplace) {
    const float t = clip_u(u) - 0.5f;
    const float mag = -logf(1.0f - 2.0f * fabsf(t));
    d2 = t >= 0.0f ? mag : -mag;
    return p1 + p2 * d2;
  }
  if (kind == kLogistic) {
    const float uc = clip_u(u);
    d2 = logf(uc / (1.0f - uc));
    return p1 + p2 * d2;
  }
  if (kind == kGumbel) {
    const float l = logf(-logf(clip_u(u)));
    d2 = -l;
    return p1 - p2 * l;
  }
  if (kind == kWeibull) {
    const float le = logf(-logf(clip_u(u)));
    const float e = expf(le / p1);
    d1 = -((p2 * e) * (1.0f / (p1 * p1))) * le;
    d2 = e;
    return p2 * e;
  }
  // kPareto
  const float a = -logf(clip_u(u));
  const float e = expf(a / p2);
  d1 = e;
  d2 = -((p1 * e) * (1.0f / (p2 * p2))) * a;
  return p1 * e;
}

// An extended family's log density at x, floored at kLogPdfFloor (and the
// floor off its support).  x is finite: no argument below is NaN.
__device__ __forceinline__ float ext_log_pdf(int kind, float p1, float p2,
                                             float x) {
  if (kind == kLognormal) {
    const float lx = logf(fmaxf(x, kTiny));
    const float z = (lx - p1) / p2;
    const float val = -0.5f * z * z - lx - logf(p2 * kSqrt2Pi);
    return x > 0.0f ? fmaxf(val, kLogPdfFloor) : kLogPdfFloor;
  }
  if (kind == kCauchy) {
    const float az = fabsf((x - p1) / p2);
    const float zc = fminf(az, kCauchySplit);
    const float log_term = az > kCauchySplit ? 2.0f * logf(fmaxf(az, kTiny))
                                             : logf(1.0f + zc * zc);
    return fmaxf(-(logf(kPiF * p2) + log_term), kLogPdfFloor);
  }
  if (kind == kLaplace) {
    return fmaxf(-fabsf(x - p1) / p2 - logf(2.0f * p2), kLogPdfFloor);
  }
  if (kind == kLogistic) {
    const float z = (x - p1) / p2;
    const float t = -z;  // softplus(t) = max(t, 0) + log(1 + exp(-|t|))
    const float softplus = fmaxf(t, 0.0f) + logf(1.0f + expf(-fabsf(t)));
    return fmaxf(-z - 2.0f * softplus - logf(p2), kLogPdfFloor);
  }
  if (kind == kGumbel) {
    const float z = (x - p1) / p2;
    return fmaxf(-(z + expf(-z)) - logf(p2), kLogPdfFloor);
  }
  if (kind == kWeibull) {
    const float lt = logf(fmaxf(x, kTiny) / p2);
    const float val = logf(p1 / p2) + (p1 - 1.0f) * lt - expf(p1 * lt);
    return x > 0.0f ? fmaxf(val, kLogPdfFloor) : kLogPdfFloor;
  }
  // kPareto
  const float val =
      logf(p2) + p2 * logf(p1) - (p2 + 1.0f) * logf(fmaxf(x, p1));
  return x >= p1 ? fmaxf(val, kLogPdfFloor) : kLogPdfFloor;
}

// One sample of the family from the mantissa m: uniform (p1, p2) =
// (min, max), normal (mean, std), exponential (lambda, -), an extended
// family from the [0, 1) uniform.
__device__ __forceinline__ float transform(int kind, uint32_t m, float p1,
                                           float p2) {
  if (kind == kUniform) {
    const float x = p1 + halfopen01(m) * (p2 - p1);
    return x >= p2 ? next_below(p2) : x;
  }
  if (kind == kNormal) return p1 + p2 * normal_from_u01(halfopen01(m));
  if (kind == kExponential) return -logf(fmaxf(open01(m), kULo)) / p1;
  return ext_inv(kind, halfopen01(m), p1, p2);
}

// sampling.analytic_log_pdf, in its float32 operation order: uniform on
// [p1, p2), normal (mean, std), exponential (lambda, -), and kLogPdfFloor
// out of support; the extended families' rows.
__device__ __forceinline__ float log_pdf(int kind, float p1, float p2,
                                         float x) {
  if (kind == kUniform) {
    return (p1 <= x && x < p2) ? -logf(p2 - p1) : kLogPdfFloor;
  }
  if (kind == kNormal) {
    const float z = (x - p1) / p2;
    return -0.5f * z * z - logf(p2 * kSqrt2Pi);
  }
  if (kind == kExponential) {
    return x >= 0.0f ? logf(p1) - p1 * x : kLogPdfFloor;
  }
  return ext_log_pdf(kind, p1, p2, x);
}

// -- CUSTOM tables --------------------------------------------------------

// A table read: through the read-only data cache on the card, a plain read
// in host builds (the CPU tests compile the lookups with g++).
__device__ __forceinline__ float ldg(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The flat inverse-CDF table t of n knots (with dt its forward
// differences, or a gapped table's slopes) at the [0, 1) uniform u:
// pos = u * (n - 1), i0 = clamp(int(pos), 0, n - 2), x = t[i0]
// + (pos - i0) * dt[i0]; `slope` gets dt[i0] (ops/mcmc_tables.py
// inverse_draw; mcmc_pallas.py:243-261).
__device__ __forceinline__ float inverse_table_u(float u, const float* t,
                                                 const float* dt, int n,
                                                 float& slope) {
  const float pos = u * float(n - 1);
  const int p0 = int(pos);
  const int i0 = p0 < 0 ? 0 : (p0 > n - 2 ? n - 2 : p0);
  const float frac = pos - float(i0);
  slope = ldg(dt + i0);
  return ldg(t + i0) + frac * slope;
}

// inverse_table_u at the [0, 1) uniform of the mantissa m.
__device__ __forceinline__ float inverse_table_x(uint32_t m, const float* t,
                                                 const float* dt, int n,
                                                 float& slope) {
  return inverse_table_u(halfopen01(m), t, dt, n, slope);
}

// A padded uniform-grid table (n values, forward differences dx) at x:
// pos = (x - x0) / step (a true division), i0 = clamp(int(pos), 0, n - 2),
// vals[i0] + clamp(pos - i0, 0, 1) * dx[i0]; `outside` off [x0, x_max]
// (integrate_pallas.py uniform_table_value: 0 for a pdf, -100 for a log
// pdf).
__device__ __forceinline__ float grid_table_value(float x, const float* vals,
                                                  const float* dx, float x0,
                                                  float step, float x_max,
                                                  int n, float outside) {
  const float pos = (x - x0) / step;
  const int p0 = int(pos);
  const int i0 = p0 < 0 ? 0 : (p0 > n - 2 ? n - 2 : p0);
  const float frac = fminf(fmaxf(pos - float(i0), 0.0f), 1.0f);
  const float val = ldg(vals + i0) + frac * ldg(dx + i0);
  return (x >= x0 && x <= x_max) ? val : outside;
}

// The knot interval of the m sorted keys at u: the last knot i with
// keys[i] <= u, by binary search, clamped to [0, m - 2].
__device__ __forceinline__ int knot_index(float u, const float* keys,
                                          int m) {
  int lo = 0;
  int n = m;
  while (n > 0) {
    const int half = n >> 1;
    if (ldg(keys + lo + half) <= u) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo < 1 ? 0 : (lo - 1 > m - 2 ? m - 2 : lo - 1);
}

// Linear interpolation of vals over the m sorted keys at u: i =
// knot_index(u), t = (u - keys[i]) / (keys[i + 1] - keys[i]) (0 over a
// flat pair) clamped to [0, 1]; vals[m - 1] from the last key on.
__device__ __forceinline__ float knot_interp(float u, const float* keys,
                                             const float* vals, int m) {
  if (u >= ldg(keys + m - 1)) return ldg(vals + m - 1);
  const int i = knot_index(u, keys, m);
  const float k0 = ldg(keys + i);
  const float d = ldg(keys + i + 1) - k0;
  const float v0 = ldg(vals + i);
  const float t = d > 0.0f ? (u - k0) / d : 0.0f;
  return v0 + fminf(fmaxf(t, 0.0f), 1.0f) * (ldg(vals + i + 1) - v0);
}

// One CUSTOM table of an MCMC kernel (ops/mcmc_tables.py _TableRef): a
// proposal's flat inverse (v the n knots, d their forward differences or
// gap slopes, log_m1 = float32(log(n - 1))), a uniform-grid log table
// (v the n padded values, d their forward differences, x0, step, x_max),
// or a knot table of n sorted keys v and values d: a knot-exact inverse
// (the CDF knots and the x knots) or an irregular-grid log table (the x
// grid, x0 = v[0] and x_max = v[n - 1], and the log densities).  Which
// one a role holds is compiled into the kernel, never read at run time.
struct TableRef {
  const float* v;
  const float* d;
  float x0, step, x_max, log_m1;
  int n;
};

// A launch's tables, per dimension j: the CUSTOM proposal's inverse, a
// gapped proposal's log table and the CUSTOM target's log table (null
// where the dimension has none).  Passed by value.
template <int D>
struct McmcTables {
  TableRef inv[D], q[D], targ[D];
};

// A CUSTOM proposal's draw at the mantissa m; `slope` gets its slope.
__device__ __forceinline__ float table_draw(const TableRef& t, uint32_t m,
                                            float& slope) {
  return inverse_table_x(m, t.v, t.d, t.n, slope);
}

// The sampler's own log density at a draw of slope `slope` (sampler mode,
// the JAX kernel's float32 order): -logf(max(slope, 1e-30)) - log_m1.
__device__ __forceinline__ float sampler_logq(const TableRef& t,
                                              float slope) {
  return -logf(fmaxf(slope, 1e-30f)) - t.log_m1;
}

// A log table at x, kLogPdfFloor off its grid.
__device__ __forceinline__ float table_log_pdf(const TableRef& t, float x) {
  return grid_table_value(x, t.v, t.d, t.x0, t.step, t.x_max, t.n,
                          kLogPdfFloor);
}

// A knot-exact proposal's draw at the mantissa m: knot_interp of its x
// knots over its CDF knots at the [0, 1) uniform (the JAX package's
// jnp.interp(u, cdf_table, x_table), sampling.transform_from_u).
__device__ __forceinline__ float knot_draw(const TableRef& t, uint32_t m) {
  return knot_interp(halfopen01(m), t.v, t.d, t.n);
}

// An irregular-grid log table at x: knot_interp over its grid,
// kLogPdfFloor off [x0, x_max] (sampling.log_pdf_from_table,
// uniform=False).
__device__ __forceinline__ float knot_log_pdf(const TableRef& t, float x) {
  return (x >= t.x0 && x <= t.x_max) ? knot_interp(x, t.v, t.d, t.n)
                                     : kLogPdfFloor;
}

// A log table at x on its compiled-in grid: knots (irregular) or uniform.
template <bool kKnots>
__device__ __forceinline__ float log_table_at(const TableRef& t, float x) {
  if constexpr (kKnots) {
    return knot_log_pdf(t, x);
  } else {
    return table_log_pdf(t, x);
  }
}

}  // namespace tmc
