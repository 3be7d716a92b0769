// Multi-dimensional Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_mcmc_nd_pallas
// (tpu_montecarlo/ops/mcmc_nd_pallas.py:338-796, pallas_call at :868) in
// its independence, random-walk and adaptive random-walk modes, with and
// without error bars, for d dimensions of the uniform, normal and
// exponential families, under a product target or a traced joint log
// density.  Under the JAX package's CounterRng (the interpreter's stream)
// it runs the very chains that kernel runs:
//
// * chain c belongs to program p = c / chains_per_program at position
//   pos = c % chains_per_program (row * 128 + lane in the JAX block); the
//   program's stream is seeded with (seed ^ 0x27D4EB2F, p), the nd MCMC
//   family's own mix (the wrapper passes the mixed word);
// * counter 0 draws the initial state, dimension j under tag j: a draw of
//   dimension j's proposal family, or for a walk x0_j = lo_j + (hi_j -
//   lo_j) * u;
// * step i, counted globally through burn-in and sampling, draws
//   dimension j's proposal (or the walk's normal step) at counter 3i+1,
//   tag j, and the accept uniform, from (0, 1], at 3i+2, tag 0;
// * log_alpha = logp' + logq - logp - logq' (independence) or logp' -
//   logp (walk), accepted when logf(u) < log_alpha.  logp and logq are
//   the dimensions' log densities summed in dimension order, or logp is
//   the joint target's value; the chain carries them and replaces them
//   only on acceptance;
// * the walk proposes x'_j = x_j + (scale * step_j) * z_j.  The adaptive
//   walk carries ONE per-chain log scale, starting at 0, that multiplies
//   the whole step vector; through burn-in Robbins-Monro moves it toward
//   dimension 0's target_accept, gamma = expf(-0.6f * logf(i + 1)),
//   clipped to +-13.815511, and sampling freezes it.  (The 1-D kernel's
//   log step starts at logf(step) instead.)
// * burn-in advances the chains without evaluating the integrands; each
//   sampling step adds f_k(x) - pilot_k to the chain's float32 sums, in
//   step order, and counts acceptances.  The pilot (error-bar runs only,
//   else 0) is the mean of f_k(x0) over the chain's program, computed by
//   mcmc_nd_pilot_kernel before the chains run.
//
// Output: per CUDA block, mcmc.cu's three rows of K + 1 floats (sums and
// the accept count; SS of the chain means; their centroid), so
// ops/mcmc_kernel.py's mcmc_finish combines the blocks as for the 1-D
// kernel; and x_final, the chains' final states as d rows of n_chains.
//
// What bounds it on the card: latency, as for mcmc.cu.  A chain is a
// serial loop of n_burnin + n_steps steps of d + 1 draws (two PCG hashes
// each), d transforms, the log densities and logf of the accept uniform;
// nothing is read from memory in the loop.  So the design is mcmc.cu's:
// one chain per thread and 32 chains per block, so 4096 chains reach 128
// of the 132 SMs; the d chain states, logp and logq live in registers.
// The mode, d and every dimension's family are compiled in (TMC_MODE,
// TMC_D, TMC_PROP_KINDS, TMC_TARG_KINDS, as integrate_nd.cu's TMC_KINDS),
// so the SASS loop is the path a step really takes.  Sums are reduced
// once, at the end, with warp shuffles in a fixed order: no atomics.
//
// Built without --use_fast_math and with --fmad=false, as the other
// kernels, so every float32 add and multiply rounds as in the plain
// PyTorch version and the JAX package.
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
// TMC_K, TMC_D, f_k(const float* x), tmc_values_nd; TMC_MODE; for
// independence TMC_PROP_KINDS; TMC_TARG_KINDS for a product target, else
// tmc_target_logpdf(const float* x).
#include "tmc_integrands.inc"
// Params, the families, log_target, log_proposal, initial_x, warp_sum and
// the pilot kernel, shared with mcmc_pt.cu.
#include "mcmc_nd_common.cuh"

namespace {

// One MH step at global index i: moves (x, logp, logq) and returns
// whether the proposal was accepted; *log_alpha receives the log
// acceptance ratio (the adaptive walk reads it).  `eps` is the walk's
// step vector, scale * step_j.
__device__ __forceinline__ bool mh_step(const Params& p, uint32_t state,
                                        uint32_t pos, uint32_t i,
                                        const float* eps, float* x,
                                        float& logp, float& logq,
                                        float* log_alpha) {
  float xp[TMC_D];
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    const uint32_t m = draw(state, 3u * i + 1u, uint32_t(j), pos);
    if (kMode == kIndependence) {
      xp[j] = tmc::transform(prop_kind(j), m, p.q1[j], p.q2[j]);
    } else {
      xp[j] = x[j] + eps[j] * tmc::normal_from_u01(tmc::halfopen01(m));
    }
  }
  const float logp_prop = log_target(xp, p);
  float logq_prop = 0.0f, la;
  if (kMode == kIndependence) {
    logq_prop = log_proposal(xp, p);
    la = logp_prop + logq - logp - logq_prop;
  } else {
    la = logp_prop - logp;
  }
  const float u = tmc::open01(draw(state, 3u * i + 2u, 0u, pos));
  const bool accept = logf(u) < la;
  if (accept) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) x[j] = xp[j];
    logp = logp_prop;
    logq = logq_prop;
  }
  *log_alpha = la;
  return accept;
}

__global__ void __launch_bounds__(kChainThreads)
mcmc_nd_kernel(uint32_t seed, const float* __restrict__ params, int n_burnin,
               int n_steps, int chains_per_program,
               const float* __restrict__ pilots, float* __restrict__ rows,
               float* __restrict__ x_final) {
  constexpr int kW = TMC_K + 1;  // row width: K sums and the accept count
  __shared__ float s_pilot[TMC_K];

  const Params p = load_params(params);
  const int chain = blockIdx.x * kChainThreads + threadIdx.x;
  // A block lies inside one program: 32 divides chains_per_program.
  const uint32_t pid = uint32_t(chain / chains_per_program);
  const uint32_t pos = uint32_t(chain % chains_per_program);
  const uint32_t state = tmc::seed_state(seed, pid);
  for (int k = threadIdx.x; k < TMC_K; k += kChainThreads) {
    s_pilot[k] = pilots != nullptr ? pilots[pid * TMC_K + k] : 0.0f;
  }
  __syncwarp();

  float x[TMC_D];
  initial_x(p, state, pos, x);
  float logp = log_target(x, p);
  float logq = kMode == kIndependence ? log_proposal(x, p) : 0.0f;
  float eps[TMC_D];  // the walk's step vector
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) eps[j] = p.q1[j];
  float la;
  const uint32_t n_iters = uint32_t(n_burnin) + uint32_t(n_steps);

  // Burn-in: advance the chains, no integrands, no accept count.
  float log_scale = 0.0f;
  for (uint32_t i = 0; i < uint32_t(n_burnin); ++i) {
    if (kMode == kAdaptive) {
      const float scale = expf(log_scale);
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) eps[j] = scale * p.q1[j];
    }
    mh_step(p, state, pos, i, eps, x, logp, logq, &la);
    if (kMode == kAdaptive) {
      const float alpha_p = expf(tmc_minimum(la, 0.0f));
      const float gamma = expf(-0.6f * logf(float(i + 1u)));
      log_scale = tmc_minimum(
          tmc_maximum(log_scale + gamma * (alpha_p - p.q4[0]), kLogScaleMin),
          kLogScaleMax);
    }
  }
  if (kMode == kAdaptive) {
    const float scale = expf(log_scale);
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) eps[j] = scale * p.q1[j];
  }

  float acc[TMC_K];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) acc[k] = 0.0f;
  float n_acc = 0.0f;
  float vals[TMC_K];
  for (uint32_t i = uint32_t(n_burnin); i < n_iters; ++i) {
    if (mh_step(p, state, pos, i, eps, x, logp, logq, &la)) n_acc += 1.0f;
    tmc_values_nd(x, vals);
#pragma unroll
    for (int k = 0; k < TMC_K; ++k) acc[k] += vals[k] - s_pilot[k];
  }
  const int n_chains = gridDim.x * kChainThreads;
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) x_final[j * n_chains + chain] = x[j];

  // The block's rows, written by lane 0: sums, then the SS and centroid
  // of the chain means.
  const bool lane0 = threadIdx.x == 0;
  const float inv_steps = 1.0f / float(n_steps);
  const float n_b = float(kChainThreads);
  float* out = rows + size_t(blockIdx.x) * 3 * kW;
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) {
    const float cm = acc[k] * inv_steps;
    const float s = warp_sum(acc[k]);
    const float s1 = warp_sum(cm);
    const float s2 = warp_sum(cm * cm);
    if (lane0) {
      const float mbs = s1 / n_b;
      out[k] = s;
      out[kW + k] = tmc_maximum(s2 - n_b * mbs * mbs, 0.0f);
      out[2 * kW + k] = mbs + s_pilot[k];
    }
  }
  const float accepted = warp_sum(n_acc);
  if (lane0) {
    out[TMC_K] = accepted;
    out[kW + TMC_K] = 0.0f;
    out[2 * kW + TMC_K] = 0.0f;
  }
}

}  // namespace

// Error-bar runs: the per-program pilots, (programs, K) floats, of the
// chains' initial states.  `params` holds TMC_D x 6 floats.  Returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int tmc_mcmc_nd_pilots(unsigned int seed, const float* params,
                                  int chains_per_program, int programs,
                                  float* pilots, void* stream) {
  return launch_pilots(seed, params, chains_per_program, programs, pilots,
                       stream);
}

// Runs n_chains chains, 32 to a block, on `stream` (chains_per_program
// a multiple of 32, n_chains of chains_per_program).  `params` holds
// TMC_D x 6 floats; `pilots` may be null (no shift); `rows` holds
// (n_chains / 32) x 3 x (TMC_K + 1) floats, `x_final` TMC_D x n_chains.
// Returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int tmc_mcmc_nd(unsigned int seed, const float* params,
                           int n_burnin, int n_steps, int chains_per_program,
                           int n_chains, const float* pilots, float* rows,
                           float* x_final, void* stream) {
  if (chains_per_program % kChainThreads != 0 ||
      n_chains % chains_per_program != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_nd_kernel<<<n_chains / kChainThreads, kChainThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      seed, params, n_burnin, n_steps, chains_per_program, pilots, rows,
      x_final);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
