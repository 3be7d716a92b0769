// What the d-dimensional MCMC kernels share: the (d, 6) parameter rows
// and the CUSTOM tables, the compiled-in families, the proposal draws,
// the target and proposal log densities, the chains' initial states and
// the error-bar pilot kernel.
//
// Included by mcmc_nd.cu and mcmc_pt.cu after the generated source
// (tmc_integrands.inc), which defines TMC_K, TMC_D, tmc_values_nd and
// TMC_MODE; for an independence proposal TMC_PROP_KINDS (and, when a
// dimension is CUSTOM, TMC_PROP_GAPPED: per dimension 1 for logq from its
// log table, 0 for sampler mode); for a product target TMC_TARG_KINDS,
// else tmc_target_logpdf(const float* x); and, where a dimension reads a
// knot table, TMC_PROP_KNOTS, TMC_Q_KNOTS and TMC_TARG_KNOTS (per
// dimension 1 for a knot-exact draw, an irregular q-table, an irregular
// target table).
//
// Under HMC (TMC_HMC = L, a walk mode) the target's position gradient is
// the product's per-dimension closed forms (tmc::log_pdf_grad) and log
// table slopes, or the joint target's generated
// tmc_target_logpdf_grad(const float* x, float* g), its reverse-mode
// gradient (ops/grad.py), which the generated source holds only then.
//
// A CUSTOM dimension draws from its flat inverse table (counter_rng.cuh
// tmc::table_draw) or, on the knots route, by knot search over its CDF
// knots (tmc::knot_draw), under the dimension's tag.  Its log density is
// the sampler's own at the draw (sampler mode) or its log table at x (a
// gapped proposal's guarded one; on the knots and full routes its full
// log-pdf table, on a uniform or an irregular grid);
// the proposal's logq sums the sampler-mode dimensions first, in
// dimension order, then the others in dimension order, and adds the two
// sums, as the JAX kernels do (mcmc_nd_pallas.py:395-455,
// mcmc_pt_pallas.py:421-464).  A CUSTOM target dimension takes its log
// table at x, on a uniform or an irregular grid.
//
// The initial state of a chain is drawn at counter 0, dimension j under
// tag j, from the seed word's stream for its program: the nd kernel's
// chains, and the cold rung of the tempered kernel's ladders (its rung t
// draws under tag t * d + j, so rung 0 under tag j).  Both kernels'
// error-bar runs take their pilots from f at that state, so one pilot
// kernel serves both, called with each kernel's own seed word.
//
// A batch of R jobs runs in one launch of either kernel, rep r on
// blockIdx.y: its seed word (rep_seed), its (d, 6) parameter row (a
// stride of 0 or d x 6 floats), its programs' pilots and its slabs of
// the outputs.  Chains, programs and the counter stream see blockIdx.x
// and gridDim.x alone, so a rep runs the chains of the unbatched launch
// with its seed and row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "log_pdf_grad.cuh"

#ifndef TMC_PROP_KINDS
#define TMC_PROP_KINDS 0  // walks draw from no proposal family
#endif
#ifndef TMC_PROP_GAPPED
#define TMC_PROP_GAPPED 0  // no CUSTOM proposal dimension's logq from a table
#endif
#ifndef TMC_PROP_KNOTS
#define TMC_PROP_KNOTS 0  // no knot-exact proposal dimension
#endif
#ifndef TMC_Q_KNOTS
#define TMC_Q_KNOTS 0  // no irregular proposal log table
#endif
#ifndef TMC_TARG_KNOTS
#define TMC_TARG_KNOTS 0  // no irregular target log table
#endif
#ifndef TMC_DIAG
#define TMC_DIAG 0  // 1: the split-half diagnostic rows
#endif
#ifndef TMC_SAMPLES
#define TMC_SAMPLES 0  // 1: the thinned draws
#endif
#ifndef TMC_HMC
#define TMC_HMC 0  // L > 0: HMC with L leapfrog steps
#endif

namespace {

enum Mode { kIndependence = 0, kRandomWalk = 1, kAdaptive = 2 };
constexpr int kMode = TMC_MODE;
// The sampling phase's compiled-in outputs (mcmc_pipeline.cuh).
constexpr bool kDiag = TMC_DIAG != 0;
constexpr bool kDraws = TMC_SAMPLES != 0;
constexpr int kLeapfrog = TMC_HMC;
static_assert(kLeapfrog == 0 || kMode != kIndependence,
              "HMC is a walk mode");

// Chains per block (ops/mcmc_kernel.py: CHAIN_THREADS): one warp in
// mcmc_pt.cu, 32 * TMC_LANES threads in mcmc_nd.cu.
constexpr int kChainThreads = 32;
constexpr int kPilotThreads = 256;
constexpr int kRow = 6;  // floats per dimension in params
constexpr float kLogScaleMin = -13.815511f;
constexpr float kLogScaleMax = 13.815511f;

using Tables = tmc::McmcTables<TMC_D>;

// Per dimension j, the params row: the proposal's (p1, p2, -, -) or the
// walk's (step, init_lo, init_hi, target_accept), then the target's
// (p1, p2); and the CUSTOM tables.
struct Params {
  float q1[TMC_D], q2[TMC_D], q3[TMC_D], q4[TMC_D], t1[TMC_D], t2[TMC_D];
  Tables tb;
};

__device__ __forceinline__ Params load_params(const float* p,
                                              const Tables& tb) {
  Params r;
  r.tb = tb;
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    r.q1[j] = p[j * kRow];
    r.q2[j] = p[j * kRow + 1];
    r.q3[j] = p[j * kRow + 2];
    r.q4[j] = p[j * kRow + 3];
    r.t1[j] = p[j * kRow + 4];
    r.t2[j] = p[j * kRow + 5];
  }
  return r;
}

// The family of proposal dimension j.  Called with j unrolled, so it folds
// to a constant and each family branch is resolved at compile time (as do
// the functions below).
__device__ __forceinline__ int prop_kind(int j) {
  const int kinds[TMC_D] = {TMC_PROP_KINDS};
  return kinds[j];
}

// Whether proposal dimension j is CUSTOM and takes its log density from its
// draw's slope (sampler mode), not from a gapped table's log table.
__device__ __forceinline__ bool sampler_dim(int j) {
  const int gapped[TMC_D] = {TMC_PROP_GAPPED};
  return prop_kind(j) == tmc::kCustom && gapped[j] == 0;
}

// Whether dimension j's proposal draws by knot search, its log table and
// its target's log table lie on irregular grids (folded as prop_kind).
__device__ __forceinline__ bool knot_draw_dim(int j) {
  const int knots[TMC_D] = {TMC_PROP_KNOTS};
  return knots[j] != 0;
}

__device__ __forceinline__ bool q_knots_dim(int j) {
  const int knots[TMC_D] = {TMC_Q_KNOTS};
  return knots[j] != 0;
}

__device__ __forceinline__ bool targ_knots_dim(int j) {
  const int knots[TMC_D] = {TMC_TARG_KNOTS};
  return knots[j] != 0;
}

__device__ __forceinline__ uint32_t draw(uint32_t state, uint32_t counter,
                                         uint32_t tag, uint32_t pos) {
  return tmc::mantissa(tmc::block_base(state, counter, tag), pos);
}

#ifdef TMC_TARG_KINDS
// Target dimension j's log density at x: its family's closed form, or its
// log table.
__device__ __forceinline__ float log_target_dim(int j, const Params& p,
                                                float x) {
  const int kinds[TMC_D] = {TMC_TARG_KINDS};
  if (kinds[j] != tmc::kCustom) {
    return tmc::log_pdf(kinds[j], p.t1[j], p.t2[j], x);
  }
  return targ_knots_dim(j) ? tmc::knot_log_pdf(p.tb.targ[j], x)
                           : tmc::table_log_pdf(p.tb.targ[j], x);
}
#endif

// The target's log density at x: the product's dimensions in order, or
// the joint log density.
__device__ __forceinline__ float log_target(const float* x, const Params& p) {
#ifdef TMC_TARG_KINDS
  float tot = log_target_dim(0, p, x[0]);
#pragma unroll
  for (int j = 1; j < TMC_D; ++j) tot = tot + log_target_dim(j, p, x[j]);
  return tot;
#else
  return tmc_target_logpdf(x);
#endif
}

#if TMC_HMC > 0
// The target's log density at x, and its gradient there in g (HMC).
__device__ __forceinline__ float log_target_grad(const float (&x)[TMC_D],
                                                 const Params& p,
                                                 float (&g)[TMC_D]) {
#ifdef TMC_TARG_KINDS
  const int kinds[TMC_D] = {TMC_TARG_KINDS};
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    if (kinds[j] != tmc::kCustom) {
      g[j] = tmc::log_pdf_grad(kinds[j], p.t1[j], p.t2[j], x[j]);
    } else {
      g[j] = targ_knots_dim(j)
                 ? tmc::knot_log_pdf_slope(p.tb.targ[j], x[j])
                 : tmc::table_log_pdf_slope(p.tb.targ[j], x[j]);
    }
  }
  return log_target(x, p);
#else
  return tmc_target_logpdf_grad(x, g);
#endif
}

// log_target_grad as tmc::hmc_move's value_grad.
struct TargetGrad {
  const Params& p;

  __device__ __forceinline__ float operator()(const float (&x)[TMC_D],
                                              float (&g)[TMC_D]) const {
    return log_target_grad(x, p, g);
  }
};
#endif

// Proposal dimension j's draw at the mantissa m: its family's transform,
// or its inverse table's draw, flat or knot-exact (`slope` gets the draw's
// slope; 0 for a closed-form family and a knot-exact draw).
__device__ __forceinline__ float draw_dim(int j, const Params& p, uint32_t m,
                                          float& slope) {
  if (prop_kind(j) == tmc::kCustom && knot_draw_dim(j)) {
    slope = 0.0f;
    return tmc::knot_draw(p.tb.inv[j], m);
  }
  if (prop_kind(j) == tmc::kCustom) {
    return tmc::table_draw(p.tb.inv[j], m, slope);
  }
  slope = 0.0f;
  return tmc::transform(prop_kind(j), m, p.q1[j], p.q2[j]);
}

// The independence proposal's log density at x, drawn with the slopes
// `slope`: the sampler-mode dimensions' terms summed in dimension order,
// then the other dimensions' (closed forms, gapped log tables) in
// dimension order, then the two sums added; with no sampler-mode
// dimension, the dimensions in order.
__device__ __forceinline__ float log_proposal(const float* x,
                                              const float* slope,
                                              const Params& p) {
  float drawn = 0.0f, rest = 0.0f;
  bool any_drawn = false, any_rest = false;
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    if (sampler_dim(j)) {
      const float l = tmc::sampler_logq(p.tb.inv[j], slope[j]);
      drawn = any_drawn ? drawn + l : l;
      any_drawn = true;
    } else {
      const float l =
          prop_kind(j) != tmc::kCustom
              ? tmc::log_pdf(prop_kind(j), p.q1[j], p.q2[j], x[j])
              : (q_knots_dim(j) ? tmc::knot_log_pdf(p.tb.q[j], x[j])
                                : tmc::table_log_pdf(p.tb.q[j], x[j]));
      rest = any_rest ? rest + l : l;
      any_rest = true;
    }
  }
  if (!any_drawn) return rest;
  return any_rest ? drawn + rest : drawn;
}

// A chain's state at counter 0, dimension j drawn under tag tag0 + j: a
// draw of dimension j's proposal (its slope in `slope`), or for a walk
// lo_j + (hi_j - lo_j) * u.
__device__ __forceinline__ void initial_x(const Params& p, uint32_t state,
                                          uint32_t pos, float* x,
                                          float* slope, uint32_t tag0 = 0u) {
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    const uint32_t m = draw(state, 0u, tag0 + uint32_t(j), pos);
    if (kMode == kIndependence) {
      x[j] = draw_dim(j, p, m, slope[j]);
    } else {
      x[j] = p.q2[j] + (p.q3[j] - p.q2[j]) * tmc::halfopen01(m);
      slope[j] = 0.0f;
    }
  }
}

// Sums `v` over the warp with a fixed shuffle tree; lane 0 gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The seed word a batch's rep blockIdx.y runs under, as an unbatched
// launch with its seed's word would: `seeds[rep] ^ mix` (the kernel's
// seed mix; the host's nd_seed_word or pt_seed_word of the seed), or
// `seed` without a seed vector.
__device__ __forceinline__ uint32_t rep_seed(uint32_t seed,
                                             const uint32_t* seeds,
                                             uint32_t mix) {
  return seeds != nullptr ? seeds[blockIdx.y] ^ mix : seed;
}

// Whether a launch of `reps` jobs with a parameter stride of
// `param_stride` floats is one the kernels take.
inline bool batch_valid(int reps, int param_stride) {
  return reps >= 1 && reps <= 65535 &&
         (param_stride == 0 || param_stride == TMC_D * kRow);
}

// The per-program pilots of an error-bar run: the mean of f_k over the
// initial states (tag j) of the program's chains, one block per program;
// rep blockIdx.y of a batch under its seed word and row, its (programs,
// K) pilots at `pilots + rep * programs * K`.
__global__ void __launch_bounds__(kPilotThreads)
mcmc_nd_pilot_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
                     uint32_t mix, const float* __restrict__ params,
                     int param_stride, const Tables tb,
                     int chains_per_program, float* __restrict__ pilots) {
  const int rep = blockIdx.y;
  seed = rep_seed(seed, seeds, mix);
  pilots += size_t(rep) * gridDim.x * TMC_K;
  const Params p = load_params(params + rep * param_stride, tb);
  const uint32_t pid = blockIdx.x;
  const uint32_t state = tmc::seed_state(seed, pid);
  float acc[TMC_K];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) acc[k] = 0.0f;
  float x[TMC_D], slope[TMC_D], vals[TMC_K];
  for (int pos = threadIdx.x; pos < chains_per_program;
       pos += kPilotThreads) {
    initial_x(p, state, uint32_t(pos), x, slope);
    tmc_values_nd(x, vals);
#pragma unroll
    for (int k = 0; k < TMC_K; ++k) acc[k] += vals[k];
  }
  __shared__ float scratch[kPilotThreads / 32][TMC_K];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) {
    const float s = warp_sum(acc[k]);
    if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32][k] = s;
  }
  __syncthreads();
  const float n_block = float(chains_per_program);
  for (int k = threadIdx.x; k < TMC_K; k += kPilotThreads) {
    float s = 0.0f;
    for (int w = 0; w < kPilotThreads / 32; ++w) s += scratch[w][k];
    pilots[pid * TMC_K + k] = s / n_block;
  }
}

// The launch's tables from the host pointer `tables` (a
// tmc::McmcTables<TMC_D>, or null where no dimension is CUSTOM).
inline Tables tables_of(const void* tables) {
  return tables != nullptr ? *static_cast<const Tables*>(tables) : Tables{};
}

// Whether a chain launch's outputs are ones the library can take:
// diagnostics need n_steps >= 4, and draws a buffer, m >= 1 and m * stride
// <= n_steps.
inline bool outputs_valid(int n_steps, const float* samples, int m,
                          int stride) {
  return (!kDiag || n_steps >= 4) &&
         (!kDraws || (samples != nullptr && m >= 1 && stride >= 1 &&
                      int64_t(m) * stride <= n_steps));
}

// Launches the pilot kernel: (programs, K) floats, for each of `reps`
// jobs (seeded by rep_seed with `seeds`, a device array of `reps` seeds
// or null, and `mix`; rows `param_stride` floats apart).  Returns
// cudaGetLastError() (0 when the launch was accepted).
inline int launch_pilots(uint32_t seed, const uint32_t* seeds, uint32_t mix,
                         int reps, const float* params, int param_stride,
                         const void* tables, int chains_per_program,
                         int programs, float* pilots, void* stream) {
  if (!batch_valid(reps, param_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_nd_pilot_kernel<<<dim3(programs, reps), kPilotThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      seed, seeds, mix, params, param_stride, tables_of(tables),
      chains_per_program, pilots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
