// 1-D Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_mcmc_fn_pallas
// (tpu_montecarlo/ops/mcmc_pallas.py:612-1007, pallas_call at :1095) in
// its independence, random-walk and adaptive random-walk modes, with and
// without error bars, for the uniform, normal and exponential families.
// Under the JAX package's CounterRng (the interpreter's stream) it runs
// the very chains that kernel runs:
//
// * chain c belongs to program p = c / chains_per_program at position
//   pos = c % chains_per_program (row * 128 + lane in the JAX block); the
//   program's stream is seeded with (seed ^ 0x5BD1E995, p);
// * counter 0 draws the initial state: a proposal draw, or for a random
//   walk x0 = lo + u * (hi - lo); step i, counted globally through
//   burn-in and sampling, draws the proposal (or the walk's normal step)
//   at counter 3i+1 and the accept uniform, from (0, 1], at 3i+2;
// * log_alpha = logp' + logq - logp - logq' (independence) or logp' -
//   logp (walk), accepted when logf(u) < log_alpha; the chain carries
//   logp and logq and replaces them only on acceptance;
// * the adaptive walk updates its log step through burn-in by
//   Robbins-Monro, gamma = expf(-0.6f * logf(i + 1)), clipped to
//   +-13.815511, and freezes it for sampling;
// * burn-in advances the chains without evaluating the integrands; each
//   sampling step adds f_j(x) - pilot_j to the chain's float32 sums, in
//   step order, and counts acceptances.  The pilot (error-bar runs only,
//   else 0) is the mean of f_j(x0) over the chain's program, computed by
//   mcmc_pilot_kernel before the chains run.
//
// Output: per CUDA block, three rows of K + 1 floats: (sum_c acc_cj,
// accept count), (SS_j, 0), (centroid_j, 0), where the SS and centroid
// are those of the block's per-chain means acc_cj / n_steps (shifted by
// the pilot, which the centroid restores).  The unit of recombination of
// the error bars is the CUDA block, not the JAX program: Chan's formula is
// exact for any partition, and the wrapper combines the blocks.
//
// What bounds it on the card: latency.  A chain is a serial loop of
// n_burnin + n_steps steps, each about two hundred dependent float32 and
// integer operations (two PCG hashes per draw, erfinvf or logf for the
// proposal, two log densities, logf of the accept uniform); nothing is
// read from memory in the loop.  At the main shape, 4096 chains, 256
// threads per block would fill only 16 of the 132 SMs.  So one chain is
// one thread and a block holds only 32 chains (one warp): 4096 chains
// spread over 128 SMs, each running its serial loop at the full rate
// of one warp scheduler.  The chain count is the caller's and is never
// changed.  Sums are reduced once, at the end, with warp shuffles and a
// fixed order: no atomics, so a result is the same on every run.
//
// Built without --use_fast_math and with --fmad=false, as integrate.cu,
// so every float32 add and multiply rounds as in the plain PyTorch
// version and the JAX package.
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "tmc_integrands.inc"  // TMC_K, f_0 .. f_{K-1}, tmc_values

namespace {

using tmc::log_pdf;

enum Mode { kIndependence = 0, kRandomWalk = 1, kAdaptive = 2 };

// One warp per block (ops/mcmc_kernel.py: CHAIN_THREADS); see the header.
constexpr int kChainThreads = 32;
constexpr int kPilotThreads = 256;
constexpr float kLogStepMin = -13.815511f;
constexpr float kLogStepMax = 13.815511f;

// The run's parameters: the proposal row (p1, p2, -, -) or the walk's
// (step, init_lo, init_hi, target_accept), then the target's (p1, p2).
struct Params {
  float q1, q2, q3, q4, t1, t2;
};

__device__ __forceinline__ Params load_params(const float* p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5]};
}

__device__ __forceinline__ uint32_t draw(uint32_t state, uint32_t counter,
                                         uint32_t pos) {
  return tmc::mantissa(tmc::block_base(state, counter, 0u), pos);
}

// The chain's state at counter 0.
__device__ __forceinline__ float initial_x(int mode, int prop_kind,
                                           const Params& p, uint32_t state,
                                           uint32_t pos) {
  const uint32_t m = draw(state, 0u, pos);
  if (mode == kIndependence) return tmc::transform(prop_kind, m, p.q1, p.q2);
  return p.q2 + tmc::halfopen01(m) * (p.q3 - p.q2);
}

// One MH step at global index i: moves (x, logp, logq) and returns
// whether the proposal was accepted; *log_alpha receives the log
// acceptance ratio (the adaptive walk reads it).
template <int MODE>
__device__ __forceinline__ bool mh_step(int prop_kind, int targ_kind,
                                        const Params& p, uint32_t state,
                                        uint32_t pos, uint32_t i, float step,
                                        float& x, float& logp, float& logq,
                                        float* log_alpha) {
  const uint32_t m = draw(state, 3u * i + 1u, pos);
  float xp, logq_prop = 0.0f, la;
  if (MODE == kIndependence) {
    xp = tmc::transform(prop_kind, m, p.q1, p.q2);
    logq_prop = log_pdf(prop_kind, p.q1, p.q2, xp);
  } else {
    xp = x + step * tmc::normal_from_u01(tmc::halfopen01(m));
  }
  const float logp_prop = log_pdf(targ_kind, p.t1, p.t2, xp);
  if (MODE == kIndependence) {
    la = logp_prop + logq - logp - logq_prop;
  } else {
    la = logp_prop - logp;
  }
  const float u = tmc::open01(draw(state, 3u * i + 2u, pos));
  const bool accept = logf(u) < la;
  if (accept) {
    x = xp;
    logp = logp_prop;
    logq = logq_prop;
  }
  *log_alpha = la;
  return accept;
}

// Sums `v` over the warp with a fixed shuffle tree; lane 0 gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sums `v` over the block: the warp's sum, then the warps in order.  Lane
// 0 of warp w leaves its warp's sum in scratch[w * stride + j]; the caller
// reads scratch after __syncthreads.
__device__ __forceinline__ void warp_sum_to(float v, float* scratch,
                                            int stride, int j) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) scratch[(threadIdx.x / 32) * stride + j] = v;
}

__global__ void __launch_bounds__(kPilotThreads)
mcmc_pilot_kernel(int mode, int prop_kind, uint32_t seed,
                  const float* __restrict__ params, int chains_per_program,
                  float* __restrict__ pilots) {
  const Params p = load_params(params);
  const uint32_t pid = blockIdx.x;
  const uint32_t state = tmc::seed_state(seed, pid);
  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
  float vals[TMC_K];
  for (int pos = threadIdx.x; pos < chains_per_program;
       pos += kPilotThreads) {
    tmc_values(initial_x(mode, prop_kind, p, state, uint32_t(pos)), vals);
#pragma unroll
    for (int j = 0; j < TMC_K; ++j) acc[j] += vals[j];
  }
  __shared__ float scratch[kPilotThreads / 32][TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) warp_sum_to(acc[j], &scratch[0][0], TMC_K, j);
  __syncthreads();
  const float n_block = float(chains_per_program);
  for (int j = threadIdx.x; j < TMC_K; j += kPilotThreads) {
    float s = 0.0f;
    for (int w = 0; w < kPilotThreads / 32; ++w) s += scratch[w][j];
    pilots[pid * TMC_K + j] = s / n_block;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kChainThreads)
mcmc_kernel(int prop_kind, int targ_kind, uint32_t seed,
            const float* __restrict__ params, int n_burnin, int n_steps,
            int chains_per_program, const float* __restrict__ pilots,
            float* __restrict__ rows, float* __restrict__ x_final) {
  constexpr int kW = TMC_K + 1;  // row width: K sums and the accept count
  __shared__ float s_pilot[TMC_K];

  const Params p = load_params(params);
  const int chain = blockIdx.x * kChainThreads + threadIdx.x;
  // A block lies inside one program: 32 divides chains_per_program.
  const uint32_t pid = uint32_t(chain / chains_per_program);
  const uint32_t pos = uint32_t(chain % chains_per_program);
  const uint32_t state = tmc::seed_state(seed, pid);
  for (int j = threadIdx.x; j < TMC_K; j += kChainThreads) {
    s_pilot[j] = pilots != nullptr ? pilots[pid * TMC_K + j] : 0.0f;
  }
  __syncwarp();

  float x = initial_x(MODE, prop_kind, p, state, pos);
  float logp = log_pdf(targ_kind, p.t1, p.t2, x);
  float logq =
      MODE == kIndependence ? log_pdf(prop_kind, p.q1, p.q2, x) : 0.0f;
  float step = p.q1;
  float la;
  const uint32_t n_iters = uint32_t(n_burnin) + uint32_t(n_steps);

  // Burn-in: advance the chains, no integrands, no accept count.
  float log_step = logf(p.q1);
  for (uint32_t i = 0; i < uint32_t(n_burnin); ++i) {
    if (MODE == kAdaptive) step = expf(log_step);
    mh_step<MODE>(prop_kind, targ_kind, p, state, pos, i, step, x, logp,
                  logq, &la);
    if (MODE == kAdaptive) {
      const float alpha_p = expf(tmc_minimum(la, 0.0f));
      const float gamma = expf(-0.6f * logf(float(i + 1u)));
      log_step = tmc_minimum(
          tmc_maximum(log_step + gamma * (alpha_p - p.q4), kLogStepMin),
          kLogStepMax);
    }
  }
  if (MODE == kAdaptive) step = expf(log_step);

  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
  float n_acc = 0.0f;
  float vals[TMC_K];
  for (uint32_t i = uint32_t(n_burnin); i < n_iters; ++i) {
    if (mh_step<MODE>(prop_kind, targ_kind, p, state, pos, i, step, x, logp,
                      logq, &la)) {
      n_acc += 1.0f;
    }
    tmc_values(x, vals);
#pragma unroll
    for (int j = 0; j < TMC_K; ++j) acc[j] += vals[j] - s_pilot[j];
  }
  x_final[chain] = x;

  // The block's rows, written by lane 0: sums, then the SS and centroid
  // of the chain means.
  const bool lane0 = threadIdx.x == 0;
  const float inv_steps = 1.0f / float(n_steps);
  const float n_b = float(kChainThreads);
  float* out = rows + size_t(blockIdx.x) * 3 * kW;
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) {
    const float cm = acc[j] * inv_steps;
    const float s = warp_sum(acc[j]);
    const float s1 = warp_sum(cm);
    const float s2 = warp_sum(cm * cm);
    if (lane0) {
      const float mbs = s1 / n_b;
      out[j] = s;
      out[kW + j] = tmc_maximum(s2 - n_b * mbs * mbs, 0.0f);
      out[2 * kW + j] = mbs + s_pilot[j];
    }
  }
  const float accepted = warp_sum(n_acc);
  if (lane0) {
    out[TMC_K] = accepted;
    out[kW + TMC_K] = 0.0f;
    out[2 * kW + TMC_K] = 0.0f;
  }
}

template <int MODE>
cudaError_t launch(int prop_kind, int targ_kind, uint32_t seed,
                   const float* params, int n_burnin, int n_steps,
                   int chains_per_program, int n_chains, const float* pilots,
                   float* rows, float* x_final, cudaStream_t s) {
  mcmc_kernel<MODE><<<n_chains / kChainThreads, kChainThreads, 0, s>>>(
      prop_kind, targ_kind, seed, params, n_burnin, n_steps,
      chains_per_program, pilots, rows, x_final);
  return cudaGetLastError();
}

}  // namespace

// Error-bar runs: the per-program pilots, (programs, K) floats, of the
// chains' initial states.  Returns cudaGetLastError() (0 when accepted).
extern "C" int tmc_mcmc_pilots(int mode, int prop_kind, unsigned int seed,
                               const float* params, int chains_per_program,
                               int programs, float* pilots, void* stream) {
  mcmc_pilot_kernel<<<programs, kPilotThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      mode, prop_kind, seed, params, chains_per_program, pilots);
  return static_cast<int>(cudaGetLastError());
}

// Runs n_chains chains, 32 to a block, on `stream` (chains_per_program
// a multiple of 32, n_chains of chains_per_program).  `pilots` may be
// null (no shift); `rows` holds (n_chains / 32) x 3 x (TMC_K + 1) floats,
// `x_final` n_chains.  Returns cudaGetLastError() (0 when accepted).
extern "C" int tmc_mcmc(int mode, int prop_kind, int targ_kind,
                        unsigned int seed, const float* params, int n_burnin,
                        int n_steps, int chains_per_program, int n_chains,
                        const float* pilots, float* rows, float* x_final,
                        void* stream) {
  if (chains_per_program % kChainThreads != 0 ||
      n_chains % chains_per_program != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kIndependence:
      return static_cast<int>(launch<kIndependence>(
          prop_kind, targ_kind, seed, params, n_burnin, n_steps,
          chains_per_program, n_chains, pilots, rows, x_final, s));
    case kRandomWalk:
      return static_cast<int>(launch<kRandomWalk>(
          prop_kind, targ_kind, seed, params, n_burnin, n_steps,
          chains_per_program, n_chains, pilots, rows, x_final, s));
    case kAdaptive:
      return static_cast<int>(launch<kAdaptive>(
          prop_kind, targ_kind, seed, params, n_burnin, n_steps,
          chains_per_program, n_chains, pilots, rows, x_final, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
