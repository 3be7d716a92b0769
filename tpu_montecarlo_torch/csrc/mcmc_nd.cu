// Multi-dimensional Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_mcmc_nd_pallas
// (tpu_montecarlo/ops/mcmc_nd_pallas.py:138, kernel at :338-796,
// pallas_call at :868) in
// its independence, random-walk and adaptive random-walk modes, with and
// without error bars, for d dimensions of the uniform, normal and
// exponential families and CUSTOM tables (target dimensions, and proposal
// dimensions in sampler mode or gapped), under a product target or a
// traced joint log density.  Under the JAX package's CounterRng (the
// interpreter's stream) it runs the very chains that kernel runs:
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
//   only on acceptance.  A CUSTOM dimension draws from its inverse table
//   and reads its log tables (mcmc_nd_common.cuh, whose logq sums the
//   sampler-mode dimensions first, as the JAX kernel does);
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
// * HMC (TMC_HMC = L, a walk mode; mcmc_nd_pallas.py:573-617) takes the
//   walk's d normal draws as its momenta and its accept uniform, and moves
//   by tmc::hmc_move (hmc_move.cuh): L kick-drift-kick leapfrog steps
//   of sizes eps_j, the energy-corrected log_alpha.  The gradient is the
//   product's closed forms and table slopes or the joint target's
//   generated gradient (mcmc_nd_common.cuh log_target_grad).  The chain
//   carries it with x and logp (a resumed one computes it at x0 once), so
//   a step evaluates L gradients; the adaptive step is the walk's;
// * a stateful run (TMC_STATE) also writes each chain's final log
//   density; a resumed one (TMC_INIT_STATE) starts from the given x0 (d x
//   n_chains) and logp0 (logp0 is not recomputed) in place of counter 0's
//   draws, and an independence proposal takes logq at x0 from its
//   dimensions' families and log tables (a stateful run's CUSTOM
//   dimensions all read their log tables).  The wrapper folds the resumed
//   segment into the seed word, segment * 0x9E3779B1, as the 1-D kernel's.
//   (The JAX package runs nd state on its XLA sweep, keyed on jax.random;
//   here it stays in this kernel under the counter stream.)
//
// Output: per CUDA block, mcmc.cu's three rows of K + 1 floats (sums and
// the accept count; SS of the chain means; their centroid), so
// ops/mcmc_kernel.py's mcmc_finish combines the blocks as for the 1-D
// kernel; and x_final, the chains' final states as d rows of n_chains.
// Split-R-hat and ESS (TMC_DIAG) and thinned draws (TMC_SAMPLES) are
// mcmc.cu's (mcmc_nd_pallas.py:290-310, :466-493, :765-790): four more
// rows per block, and the draws as (m, d, n_chains) floats.
//
// What bounds it on the card, as for mcmc.cu.  A chain is a serial
// recurrence of n_burnin + n_steps steps, and over the closed-form
// families nothing is read from memory in the loop (a CUSTOM dimension's
// tables are read with __ldg, part of the x-free candidate under an
// independence proposal, on the carried chain of a walk's target).
// Under an independence proposal (c9e, the main path) a step's d + 1
// draws (two PCG hashes each), d transforms, the target's and the
// proposal's log densities and logf of the accept uniform are all x-free;
// only the decision (three float32 adds, a compare, the d + 2 selects)
// carries from step to step.  So the least time is the card's
// arithmetic pipes over the run's x-free work, or the carried path over
// the steps, whichever is longer.  The design is mcmc.cu's
// (csrc/mcmc_pipeline.cuh): each chain on TMC_LANES lanes of a warp,
// TMC_GROUP candidates made ahead by every lane, the group's decisions
// run in step order on the candidates taken by __shfl_sync, so 4096
// chains on 4 lanes fill the four schedulers of 128 SMs.  A walk's
// proposal x_j + eps_j * z_j depends on x, so walks keep one lane per
// chain and make only their d normal steps, accept uniforms and adaptive
// gains ahead.  A block holds 32 chains (32 * TMC_LANES threads); the d
// chain states, logp and logq live in registers.  The mode, d, every
// dimension's family and the layout are compiled in (TMC_MODE, TMC_D,
// TMC_PROP_KINDS, TMC_PROP_GAPPED, TMC_TARG_KINDS, TMC_LANES, TMC_GROUP,
// and a knot table's TMC_PROP_KNOTS, TMC_Q_KNOTS, TMC_TARG_KNOTS, as
// integrate_nd.cu's TMC_KINDS), so the SASS loop is the path a step
// really takes; the tables are run-time arguments (tmc::McmcTables<d>).
// Sums are reduced once, at the end, with warp shuffles in a fixed order:
// no atomics; each chain's sums are added in step order.
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
// tmc_target_logpdf(const float* x); TMC_LANES, TMC_GROUP.
#include "tmc_integrands.inc"
// Params, the families, log_target, log_proposal, initial_x, warp_sum and
// the pilot kernel, shared with mcmc_pt.cu.
#include "mcmc_nd_common.cuh"
#include "mcmc_pipeline.cuh"

namespace {

constexpr int kLanes = TMC_LANES;
constexpr int kGroup = TMC_GROUP;
static_assert(kMode == kIndependence || kLanes == 1,
              "a walk runs one lane per chain");
static_assert(kLanes >= 1 && 32 % kLanes == 0 && kGroup >= 1,
              "lanes divide a warp");
constexpr int kThreads = kChainThreads * kLanes;
constexpr int kRows = tmc::block_row_count(kDiag);
using Outputs = tmc::StepOutputs<TMC_K, TMC_D, kDiag, kDraws>;
#ifndef TMC_STATE
#define TMC_STATE 0  // 1: the final log densities
#endif
#ifndef TMC_INIT_STATE
#define TMC_INIT_STATE 0  // 1: the chains start from x0, logp0
#endif
constexpr bool kState = TMC_STATE != 0;
constexpr bool kInitState = TMC_INIT_STATE != 0;
static_assert(!kInitState || kState, "a resumed run is stateful");
// The nd family's seed mix (ops/mcmc_nd_kernel.py ND_SEED_MIX).
constexpr uint32_t kSeedMix = 0x27D4EB2Fu;

// The candidate of independence step i: dimension j drawn under tag j.
struct Propose {
  Params p;
  uint32_t state, pos;

  __device__ __forceinline__ tmc::Candidate<TMC_D> operator()(
      uint32_t i) const {
    tmc::Candidate<TMC_D> c;
    float slope[TMC_D];
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      c.x[j] = draw_dim(j, p, draw(state, 3u * i + 1u, uint32_t(j), pos),
                        slope[j]);
    }
    c.logp = log_target(c.x, p);
    c.logq = log_proposal(c.x, slope, p);
    c.logu = logf(tmc::open01(draw(state, 3u * i + 2u, 0u, pos)));
    return c;
  }
};

// What walk step i takes from the stream, made ahead of the group's
// moves: the d normal steps, logf of the accept uniform and, in the
// adaptive burn-in, the Robbins-Monro gain.
struct WalkDraw {
  float z[TMC_D];
  float logu, gamma;
};

template <bool kAdapt>
struct WalkDraws {
  uint32_t state, pos;

  __device__ __forceinline__ WalkDraw operator()(uint32_t i) const {
    WalkDraw w;
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      w.z[j] = tmc::normal_from_u01(
          tmc::halfopen01(draw(state, 3u * i + 1u, uint32_t(j), pos)));
    }
    w.logu = logf(tmc::open01(draw(state, 3u * i + 2u, 0u, pos)));
    w.gamma = kAdapt ? expf(-0.6f * logf(float(int(i + 1u)))) : 0.0f;
    return w;
  }
};

// One walk step: x'_j = x_j + eps_j * z_j with eps the step vector scale
// * step_j, accepted when logf(u) < logp' - logp, or under HMC
// (kLeapfrog > 0) the trajectory of tmc::hmc_move from the momenta z and
// the chain's gradient g; the adaptive burn-in moves its one log scale by
// Robbins-Monro after each.
template <bool kAdapt, class Visit>
struct WalkStep {
  const Params& p;
  float (&x)[TMC_D];
  float& logp;
  float (&g)[TMC_D];
  float (&eps)[TMC_D];
  float& log_scale;
  Visit& visit;

  __device__ __forceinline__ void operator()(uint32_t, const WalkDraw& w) {
    if (kAdapt) {
      const float scale = expf(log_scale);
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) eps[j] = scale * p.q1[j];
    }
    float la;
    bool accept;
#if TMC_HMC > 0
    const tmc::HmcProposal<TMC_D> m = tmc::hmc_move<kLeapfrog, TMC_D>(
        x, logp, g, w.z, eps, 1.0f, TargetGrad{p});
    la = m.log_alpha;
    accept = w.logu < la;
    if (accept) {
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) {
        x[j] = m.x[j];
        g[j] = m.g[j];
      }
      logp = m.logp;
    }
#else
    float xp[TMC_D];
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) xp[j] = x[j] + eps[j] * w.z[j];
    const float logp_prop = log_target(xp, p);
    la = logp_prop - logp;
    accept = w.logu < la;
    if (accept) {
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) x[j] = xp[j];
      logp = logp_prop;
    }
#endif
    if (kAdapt) {
      const float alpha_p = expf(tmc_minimum(la, 0.0f));
      log_scale = tmc_minimum(
          tmc_maximum(log_scale + w.gamma * (alpha_p - p.q4[0]),
                      kLogScaleMin),
          kLogScaleMax);
    }
    visit(x, accept);
  }
};

// The sampling phase's per-chain sums, in step order: f_k(x) - pilot_k
// and the accept count; and the outputs' part (diagnostic halves, draws).
template <class Out>
struct Sums {
  float (&acc)[TMC_K];
  float& n_acc;
  const float* pilot;
  Out& out;

  __device__ __forceinline__ void operator()(const float (&x)[TMC_D],
                                             bool accepted) {
    if (accepted) n_acc += 1.0f;
    float vals[TMC_K];
    tmc_values_nd(x, vals);
#pragma unroll
    for (int k = 0; k < TMC_K; ++k) {
      const float v = vals[k] - pilot[k];
      acc[k] += v;
      out.add(k, v);
    }
    out.step(x);
  }
};

// Rep blockIdx.y of a batch is one job (mcmc_nd_common.cuh): its seed
// word, its parameter row (`param_stride` 0 or TMC_D x 6), its programs'
// pilots, and its slabs of rows, final states and draws.
__global__ void __launch_bounds__(kThreads)
mcmc_nd_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
               const float* __restrict__ params, int param_stride,
               const Tables tb, int n_burnin, int n_steps,
               int chains_per_program, const float* __restrict__ pilots,
               float* __restrict__ rows, float* __restrict__ x_final,
               tmc::Draws draws, const float* __restrict__ x0,
               const float* __restrict__ logp0,
               float* __restrict__ logp_final) {
  __shared__ float s_pilot[TMC_K];

  const int rep = blockIdx.y;
  seed = rep_seed(seed, seeds, kSeedMix);
  const size_t rep_chains = size_t(gridDim.x) * kChainThreads;
  if (pilots != nullptr) {
    pilots += size_t(rep) * (rep_chains / chains_per_program) * TMC_K;
  }
  rows += size_t(rep) * gridDim.x * kRows * (TMC_K + 1);
  x_final += size_t(rep) * TMC_D * rep_chains;
  if constexpr (kDraws) {
    draws.out += size_t(rep) * draws.m * TMC_D * rep_chains;
  }
  const Params p = load_params(params + rep * param_stride, tb);
  // The chain's lanes are kLanes consecutive threads of one warp.
  const int lane = threadIdx.x % kLanes;
  const int chain = blockIdx.x * kChainThreads + threadIdx.x / kLanes;
  // A block lies inside one program: 32 divides chains_per_program.
  const uint32_t pid = uint32_t(chain / chains_per_program);
  const uint32_t pos = uint32_t(chain % chains_per_program);
  const uint32_t state = tmc::seed_state(seed, pid);
  for (int k = threadIdx.x; k < TMC_K; k += kThreads) {
    s_pilot[k] = pilots != nullptr ? pilots[pid * TMC_K + k] : 0.0f;
  }
  if constexpr (kDiag) tmc::zero_diag_sums<TMC_K>();
  __syncthreads();

  const int n_chains = gridDim.x * kChainThreads;
  float x[TMC_D], slope[TMC_D];
  float logp;
  if constexpr (kInitState) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      x[j] = x0[j * n_chains + chain];
      slope[j] = 0.0f;  // no dimension is in sampler mode
    }
    logp = logp0[chain];
  } else {
    initial_x(p, state, pos, x, slope);
    logp = log_target(x, p);
  }
  float logq = kMode == kIndependence ? log_proposal(x, slope, p) : 0.0f;
  const uint32_t n_burn = uint32_t(n_burnin);

  float acc[TMC_K];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) acc[k] = 0.0f;
  float n_acc = 0.0f;
  Outputs out =
      Outputs::start(draws, chain, gridDim.x * kChainThreads, lane == 0);
  Sums<Outputs> sums{acc, n_acc, s_pilot, out};
  tmc::NoVisit none;
  // Under diagnostics the sampling phase runs in halves, each ended by
  // the block's reduction of the chains' halves.
  auto half_done = [&] { tmc::end_half<TMC_K, kLanes>(out, n_steps); };

  // Burn-in advances the chains without evaluating the integrands and
  // without counting acceptances; sampling adds both.
  if constexpr (kMode == kIndependence) {
    const Propose make{p, state, pos};
    tmc::SelectStep<TMC_D, tmc::NoVisit> burn{x, logp, logq, none};
    tmc::pipeline<kLanes, kGroup, tmc::Candidate<TMC_D>>(0u, n_burn, lane,
                                                         make, burn);
    tmc::SelectStep<TMC_D, Sums<Outputs>> sample{x, logp, logq, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<kLanes, kGroup, tmc::Candidate<TMC_D>>(b, e, lane, make,
                                                           sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  } else {
    constexpr bool kAdapt = kMode == kAdaptive;
    float eps[TMC_D];  // the walk's step vector
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) eps[j] = p.q1[j];
    float log_scale = 0.0f;
    float g[TMC_D];  // HMC's gradient at x
#if TMC_HMC > 0
    log_target_grad(x, p, g);
#endif
    WalkStep<kAdapt, tmc::NoVisit> burn{p, x, logp, g, eps, log_scale, none};
    tmc::pipeline<1, kGroup, WalkDraw>(0u, n_burn, 0,
                                       WalkDraws<kAdapt>{state, pos}, burn);
    if (kAdapt) {
      const float scale = expf(log_scale);
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) eps[j] = scale * p.q1[j];
    }
    WalkStep<false, Sums<Outputs>> sample{p, x, logp, g,
                                          eps, log_scale, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<1, kGroup, WalkDraw>(b, e, 0, WalkDraws<false>{state, pos},
                                         sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) x_final[j * n_chains + chain] = x[j];
    if constexpr (kState) logp_final[chain] = logp;
  }

  // The block's rows: sums, then the SS and centroid of the chain means;
  // under diagnostics the four rows of the half-chain sequences.
  float* block_rows = rows + size_t(blockIdx.x) * kRows * (TMC_K + 1);
  if constexpr (kDiag) {
    tmc::write_diag_rows<TMC_K, 1>(s_pilot, n_steps,
                                   block_rows + 3 * (TMC_K + 1));
  }
  tmc::write_block_rows<TMC_K, kLanes>(acc, n_acc, s_pilot, n_steps,
                                       block_rows);
}

}  // namespace

// Error-bar runs: the per-program pilots, (programs, K) floats, of the
// chains' initial states.  `params` holds TMC_D x 6 floats; `tables` is a
// host pointer to the CUSTOM tables (tmc::McmcTables<TMC_D>) or null.
// A batch of `reps` jobs runs in one launch: rep r under the seed word
// `seeds[r] ^ 0x27D4EB2F` (`seeds` a device array of `reps` seeds), or
// `seed` for every rep where `seeds` is null; with its TMC_D x 6 row at
// `params + r * param_stride` (0 or TMC_D x 6); its pilots at `pilots +
// r * programs * TMC_K`.  Returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int tmc_mcmc_nd_pilots(unsigned int seed, const unsigned int* seeds,
                                  int reps, const float* params,
                                  int param_stride, const void* tables,
                                  int chains_per_program, int programs,
                                  float* pilots, void* stream) {
  return launch_pilots(seed, seeds, kSeedMix, reps, params, param_stride,
                       tables, chains_per_program, programs, pilots, stream);
}

// Runs n_chains chains, 32 to a block of 32 * TMC_LANES threads, on
// `stream` (chains_per_program a multiple of 32, n_chains of
// chains_per_program).  `params` holds TMC_D x 6 floats; `tables` as
// tmc_mcmc_nd_pilots'; `pilots` may be null (no shift); `rows` holds
// (n_chains / 32) x R x (TMC_K + 1) floats, R = 7 with TMC_DIAG (n_steps
// >= 4) and 3 without, `x_final` TMC_D x n_chains; with TMC_SAMPLES,
// `samples` holds m x TMC_D x n_chains floats, row j the states after
// sampling step j * stride (1 <= m, m * stride <= n_steps), else it is
// ignored.  With TMC_INIT_STATE the chains start from x0 (TMC_D x
// n_chains floats) and logp0 (n_chains), with TMC_STATE `logp_final`
// gets their final log densities (n_chains); else these are ignored.
// A batch of `reps` jobs runs in one launch, each seeded and with its
// parameter row as in tmc_mcmc_nd_pilots, rep r's pilots at `pilots + r *
// (n_chains / chains_per_program) * TMC_K`, its rows, `x_final` and
// draws at r times their sizes above; a stateful run, or one with
// diagnostics, is one job (as the JAX kernel's, mcmc_nd_pallas.py:303).
// Returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int tmc_mcmc_nd(unsigned int seed, const unsigned int* seeds,
                           int reps, const float* params, int param_stride,
                           const void* tables, int n_burnin, int n_steps,
                           int chains_per_program, int n_chains,
                           const float* pilots, float* rows, float* x_final,
                           float* samples, int m, int stride, const float* x0,
                           const float* logp0, float* logp_final,
                           void* stream) {
  if (!batch_valid(reps, param_stride) ||
      ((kState || kInitState || kDiag) && reps != 1) ||
      chains_per_program % kChainThreads != 0 ||
      n_chains % chains_per_program != 0 ||
      !outputs_valid(n_steps, samples, m, stride) ||
      (kInitState && (x0 == nullptr || logp0 == nullptr)) ||
      (kState && logp_final == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_nd_kernel<<<dim3(n_chains / kChainThreads, reps), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      seed, seeds, params, param_stride, tables_of(tables), n_burnin,
      n_steps, chains_per_program, pilots, rows, x_final,
      tmc::Draws{samples, m, stride}, x0, logp0, logp_final);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
