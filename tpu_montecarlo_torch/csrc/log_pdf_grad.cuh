// Hamiltonian Monte Carlo's position gradient and leapfrog move for the
// MCMC kernels (mcmc.cu over one dimension, mcmc_nd.cu over d, mcmc_pt.cu
// on each tempered rung).
//
// tmc::log_pdf_grad is d/dx of tmc::log_pdf for the ten closed-form
// families: the expression that jax.grad of the JAX package's closed form
// traces (mcmc_pallas.py:378-382), read off its jaxpr and written in the
// same float32 order (sampling.log_pdf_grad is its torch twin).  Where the
// log density is the flat floor (off the support, or floored inside it)
// the gradient is 0; a tie of a max or min takes half the slope, as
// jax.grad does (Pareto at x_min); |x - mu| at x = mu takes the slope of
// x >= mu (Laplace).  A CUSTOM target's gradient is its log table's slope,
// dx[i0] / step on the table's grid and 0 off it (the JAX kernel's
// uniform_table_slope, at the index the log-table lookup reads), or on an
// irregular grid the slope of the knot interval the lookup reads, 0 off
// it (jax.grad of jnp.interp, the JAX package's XLA sweep).
//
// tmc::hmc_move (hmc_move.cuh, included here) is the leapfrog move that
// takes these gradients.  A joint target's gradient is generated from its
// traced expression (ops/grad.py, tmc_target_logpdf_grad).
//
// Plain C++ that also compiles on the host with
// g++ -D__device__= -D__forceinline__=inline -ffp-contract=off, so the CPU
// tests hold it against the torch twins.
#pragma once

#include "counter_rng.cuh"
#include "hmc_move.cuh"
#include "integrand_math.cuh"  // tmc_minimum, tmc_maximum

namespace tmc {

// The share of the derivative of m, max(a, b) or min(a, b), that
// jax.grad gives a: 1 where m is a alone, 0 where it is b alone (or NaN),
// 0.5 at a tie.
__device__ __forceinline__ float share(float a, float m, float b) {
  return (a == m ? 1.0f : 0.0f) / (m == b ? 2.0f : 1.0f);
}

// share() of a log density floored at kLogPdfFloor.
__device__ __forceinline__ float floor_share(float val) {
  return share(val, tmc_maximum(val, kLogPdfFloor), kLogPdfFloor);
}

// d/dx of log_pdf(kind, p1, p2, x) for a closed-form family.
__device__ __forceinline__ float log_pdf_grad(int kind, float p1, float p2,
                                              float x) {
  if (kind == kUniform) return 0.0f;
  if (kind == kNormal) {
    const float e = (x - p1) / p2;
    return (-0.5f * e + -0.5f * e) / p2;
  }
  if (kind == kExponential) return p1 * -(x >= 0.0f ? 1.0f : 0.0f);
  if (kind == kLognormal) {
    const float d = tmc_maximum(x, kTiny);
    const float m = share(x, d, kTiny);
    const float n = logf(d);
    const float p = (n - p1) / p2;
    const float q = -0.5f * p;
    const float val = q * p - n - logf(p2 * kSqrt2Pi);
    const bool inside = x > 0.0f;
    const float bo = inside ? floor_share(val) : 0.0f;
    const float bv = (q * bo + -0.5f * (bo * p)) / p2;
    return (-bo + bv) / d * m;
  }
  if (kind == kCauchy) {
    const float e = (x - p1) / p2;
    const float f = fabsf(e);
    const float h = tmc_minimum(f, kCauchySplit);
    const float q = share(f, h, kCauchySplit);
    const bool far = f > kCauchySplit;
    const float s = tmc_maximum(f, kTiny);
    const float bb = share(f, s, kTiny);
    const float bf = 1.0f + h * h;
    const float log_term = far ? 2.0f * logf(s) : logf(bf);
    const float bl = -(logf(kPiF * p2) + log_term);
    const float by = -(1.0f * floor_share(bl));
    const float bz = far ? by : 0.0f;
    const float cc = (far ? 0.0f : by) / bf;
    const float ck = 2.0f * bz / s * bb + (h * cc + cc * h) * q;
    const bool pos = e >= 0.0f;
    return ((pos ? ck : 0.0f) + -(pos ? 0.0f : ck)) / p2;
  }
  if (kind == kLaplace) {
    const float d = x - p1;
    const float k = -fabsf(d) / p2 - logf(2.0f * p2);
    const float y = -(1.0f * floor_share(k) / p2);
    const bool pos = d >= 0.0f;
    return (pos ? y : 0.0f) + -(pos ? 0.0f : y);
  }
  if (kind == kLogistic) {
    const float e = (x - p1) / p2;
    const float g = -e;
    const float h = tmc_maximum(g, 0.0f);
    const float q = share(g, h, 0.0f);
    const float u = expf(-fabsf(g));
    const float v = 1.0f + u;
    const float bb = -e - 2.0f * (h + logf(v)) - logf(p2);
    const float bn = 1.0f * floor_share(bb);
    const float bp = 2.0f * -bn;
    const float bs = -(bp / v * u);
    const bool pos = g >= 0.0f;
    const float bx = (pos ? bs : 0.0f) + -(pos ? 0.0f : bs);
    return (-(bx + bp * q) + -bn) / p2;
  }
  if (kind == kGumbel) {
    const float e = (x - p1) / p2;
    const float g = expf(-e);
    const float k = -(e + g) - logf(p2);
    const float w = -(1.0f * floor_share(k));
    return (w + -(w * g)) / p2;
  }
  if (kind == kWeibull) {
    const float d = tmc_maximum(x, kTiny);
    const float m = share(x, d, kTiny);
    const float n = d / p2;
    const float o = logf(n);
    const float r = p1 - 1.0f;
    const float v = expf(p1 * o);
    const float val = logf(p1 / p2) + r * o - v;
    const bool inside = x > 0.0f;
    const float bp = inside ? 1.0f * floor_share(val) : 0.0f;
    return (p1 * (-bp * v) + r * bp) / n / p2 * m;
  }
  // kPareto
  const float d = tmc_maximum(x, p1);
  const float m = share(x, d, p1);
  const float r = p2 + 1.0f;
  const float val = logf(p2) + p2 * logf(p1) - r * logf(d);
  const bool inside = x >= p1;
  const float bn = inside ? 1.0f * floor_share(val) : 0.0f;
  return r * -bn / d * m;
}

// A log table's slope at x: dx[i0] / step at the index the lookup
// (table_log_pdf) reads, 0 off [x0, x_max].
__device__ __forceinline__ float table_log_pdf_slope(const TableRef& t,
                                                     float x) {
  const float pos = (x - t.x0) / t.step;
  const int p0 = int(pos);
  const int i0 = p0 < 0 ? 0 : (p0 > t.n - 2 ? t.n - 2 : p0);
  const float slope = ldg(t.d + i0) / t.step;
  return (x >= t.x0 && x <= t.x_max) ? slope : 0.0f;
}

// An irregular-grid log table's slope at x: (d[i + 1] - d[i]) / (v[i + 1]
// - v[i]) over the knot interval i that knot_log_pdf reads (the last knot
// with v[i] <= x, clamped to [0, n - 2]; 0 over a flat pair), 0 off [x0,
// x_max] (jax.grad of sampling.log_pdf_from_table, uniform=False).  The
// search is knot_interp's (knot_index): at x = x_max it keeps the last
// interval where knot_interp returns the last value early.
__device__ __forceinline__ float knot_log_pdf_slope(const TableRef& t,
                                                    float x) {
  const int i = knot_index(x, t.v, t.n);
  const float dk = ldg(t.v + i + 1) - ldg(t.v + i);
  const float slope = dk > 0.0f ? (ldg(t.d + i + 1) - ldg(t.d + i)) / dk
                                : 0.0f;
  return (x >= t.x0 && x <= t.x_max) ? slope : 0.0f;
}

// A log table's slope at x on its compiled-in grid (log_table_at's).
template <bool kKnots>
__device__ __forceinline__ float log_table_slope_at(const TableRef& t,
                                                    float x) {
  if constexpr (kKnots) {
    return knot_log_pdf_slope(t, x);
  } else {
    return table_log_pdf_slope(t, x);
  }
}

}  // namespace tmc
