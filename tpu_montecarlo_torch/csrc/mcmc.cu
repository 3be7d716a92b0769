// 1-D Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_mcmc_fn_pallas
// (tpu_montecarlo/ops/mcmc_pallas.py:387, kernel at :612-1007, pallas_call
// at :1095) in its independence, random-walk and adaptive random-walk
// modes, with HMC (TMC_HMC) and chain state in and out (TMC_STATE,
// TMC_INIT_STATE), with and without error bars, for the closed-form
// families and CUSTOM tables (a table target; a table proposal in sampler
// mode or gapped).
// Under the JAX package's CounterRng (the interpreter's stream) it runs
// the very chains that kernel runs:
//
// * chain c belongs to program p = c / chains_per_program at position
//   pos = c % chains_per_program (row * 128 + lane in the JAX block); the
//   program's stream is seeded with (seed ^ 0x5BD1E995, p), the seed word
//   of a resumed segment also xor segment * 0x9E3779B1 (the wrapper
//   passes the word);
// * counter 0 draws the initial state: a proposal draw, or for a random
//   walk x0 = lo + u * (hi - lo); step i, counted globally through
//   burn-in and sampling, draws the proposal (or the walk's normal step)
//   at counter 3i+1 and the accept uniform, from (0, 1], at 3i+2;
// * log_alpha = logp' + logq - logp - logq' (independence) or logp' -
//   logp (walk), accepted when logf(u) < log_alpha; the chain carries
//   logp and logq and replaces them only on acceptance;
// * a CUSTOM proposal draws from its flat inverse table with the same
//   counters, x = t[i0] + frac * dt[i0] at pos = u * (m - 1), or, on the
//   knots route (TMC_PROP_KNOTS), from its CDF knots by knot_interp at u
//   (the knot-exact inverse of a heavy-tailed or unfaithful gapped table),
//   and takes logq from its own slope, -logf(max(dt[i0], 1e-30)) - log(m -
//   1) (sampler mode), or from its log table at x: a gapped proposal's
//   guarded one, or on the knots and full routes its full log-pdf table,
//   on a uniform or, TMC_Q_KNOTS, an irregular grid; a CUSTOM target's
//   logp is its log table at x, uniform or, TMC_TARG_KNOTS, irregular,
//   -100 off its grid (the shared lookups of counter_rng.cuh,
//   ops/mcmc_tables.py);
// * the adaptive walk updates its log step through burn-in by
//   Robbins-Monro, gamma = expf(-0.6f * logf(i + 1)), clipped to
//   +-13.815511, and freezes it for sampling;
// * HMC (TMC_HMC = L, a walk mode) takes the walk's normal draw as its
//   momentum and the walk's accept uniform, and moves by L kick-drift-kick
//   leapfrog steps with the energy-corrected log_alpha (hmc_move.cuh; the
//   gradients log_pdf_grad.cuh's: the closed forms' jax.grad expressions,
//   a table target's slope, on an irregular table the knot interval's);
//   the
//   chain carries the gradient at x, so a step evaluates L gradients; its
//   adaptive step follows the walk's rule;
// * a stateful run (TMC_STATE) also writes each chain's final log
//   density; a resumed one (TMC_INIT_STATE) starts from the given x0 and
//   logp0 (logp0 is not recomputed) in place of counter 0's draw, and an
//   independence proposal takes logq at x0 from its family or, CUSTOM,
//   from its log table (a stateful run's CUSTOM proposal always reads its
//   log table: the wrapper routes it as gapped);
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
// Split-R-hat and ESS (TMC_DIAG, build_mcmc_fn_pallas's with_diagnostics,
// mcmc_pallas.py:292-363): the sampling phase runs as its two halves of
// n1 = n_steps / 2 steps and the odd last step; through each half a chain
// also sums the values it adds and their squares, and at the half's end
// the block reduces those to the sums of the half-sequence means, of
// their squares and of the squares (mcmc_pipeline.cuh end_half).  Four
// more rows per block then hold the JAX kernel's stat rows 3-6 over the
// block's 64 sequences, which the wrapper recombines by Chan's formula.
// The pilot shift applies whenever diagnostics are on.  Thinned draws
// (TMC_SAMPLES, with_samples): the post-step state after sampling steps
// j * stride, j < m, stored by the chain's lane 0 as (m, n_chains) floats;
// from step m * stride on the phase runs with the writer stopped (the
// steps left when m does not divide n_steps).  Neither changes a decision or the order of a chain's sums, so the
// values and error bars are those of a run without them.
//
// What bounds it on the card.  A chain is a serial recurrence of
// n_burnin + n_steps steps, and over the closed-form families nothing is
// read from memory in the loop.
// Under an independence proposal (the main path) most of a step is x-free:
// two PCG hashes per draw, erfinvf or logf for the proposal, two log
// densities and logf of the accept uniform.  Only the decision (three
// float32 adds, a compare, the selects) carries from step to step: the
// least time is the card's arithmetic pipes over the whole run's x-free
// work, or that carried path over the steps, whichever is longer.  The
// design (csrc/mcmc_pipeline.cuh) takes the x-free work off the carried
// path: each chain runs on TMC_LANES lanes of a warp, every lane makes
// TMC_GROUP candidates ahead, and all of the chain's lanes then take the
// group's candidates by __shfl_sync and run its decisions in step order.
// With 4096 chains and 4 lanes a chain, the card runs 512 warps, one per
// scheduler of 128 SMs, where one lane per chain filled one scheduler of
// four.  A walk's proposal depends on x, so walks keep one lane per chain
// and make only their normal steps, accept uniforms and adaptive gains
// ahead.  The chain count is the caller's and is never changed; a block
// holds 32 chains (32 * TMC_LANES threads).  Sums are reduced once, at
// the end, with warp shuffles in a fixed order: no atomics, so a result is
// the same on every run, and each chain's sums are added in step order as
// in the plain version.
//
// CUSTOM tables (BASELINE config 5: a table target under U(-6, 6)) add
// table loads, read with __ldg from global memory (a downsampled table of
// a few hundred to a few thousand floats stays in L1).  Under an
// independence proposal the draw, its logq and the target's lookup at x'
// are all x-free, so they are part of the candidate made ahead; a walk's
// lookup at x' = x + step * z sits on the carried chain, a division and
// two dependent loads each step, or on an irregular grid a knot search of
// ceil(log2 n) dependent loads and the interpolation's loads after it.
//
// The mode, the two families, a CUSTOM proposal's route and the layout are
// compiled in (TMC_MODE, TMC_PROP_KIND, TMC_TARG_KIND, TMC_PROP_GAPPED,
// TMC_PROP_KNOTS, TMC_Q_KNOTS, TMC_TARG_KNOTS, TMC_LANES, TMC_GROUP from
// the generated source, as mcmc_nd.cu's), so no
// step branches on them at run time.  The tables themselves are run-time
// arguments (tmc::McmcTables<1>, by value): a new table needs no new
// build.
//
// Built without --use_fast_math and with --fmad=false, as integrate.cu,
// so every float32 add and multiply rounds as in the plain PyTorch
// version and the JAX package.
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
// TMC_K, f_0 .. f_{K-1}, tmc_values; TMC_MODE, TMC_TARG_KIND, for an
// independence proposal TMC_PROP_KIND (and TMC_PROP_GAPPED for a CUSTOM
// one); TMC_LANES, TMC_GROUP.
#include "tmc_integrands.inc"
#include "log_pdf_grad.cuh"
#include "mcmc_pipeline.cuh"

#ifndef TMC_PROP_KIND
#define TMC_PROP_KIND 0  // walks draw from no proposal family
#endif
#ifndef TMC_PROP_GAPPED
// A CUSTOM proposal's logq: 1 from its log table (a gapped proposal, or
// any of a stateful run), 0 the sampler's own.
#define TMC_PROP_GAPPED 0
#endif
#ifndef TMC_PROP_KNOTS
#define TMC_PROP_KNOTS 0  // 1: a CUSTOM proposal's knot-exact draw
#endif
#ifndef TMC_Q_KNOTS
#define TMC_Q_KNOTS 0  // 1: its log table on an irregular grid
#endif
#ifndef TMC_TARG_KNOTS
#define TMC_TARG_KNOTS 0  // 1: a CUSTOM target's log table irregular
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
#ifndef TMC_STATE
#define TMC_STATE 0  // 1: the final log densities
#endif
#ifndef TMC_INIT_STATE
#define TMC_INIT_STATE 0  // 1: the chains start from x0, logp0
#endif

namespace {

using tmc::log_pdf;

enum Mode { kIndependence = 0, kRandomWalk = 1, kAdaptive = 2 };

constexpr int kMode = TMC_MODE;
constexpr int kPropKind = TMC_PROP_KIND;
constexpr int kTargKind = TMC_TARG_KIND;
constexpr bool kPropGapped = TMC_PROP_GAPPED != 0;
constexpr bool kPropKnots = TMC_PROP_KNOTS != 0;
constexpr bool kQKnots = TMC_Q_KNOTS != 0;
constexpr bool kTargKnots = TMC_TARG_KNOTS != 0;
static_assert(!(kPropKnots || kQKnots) || kPropGapped,
              "the knots and full routes take logq from a log table");
constexpr int kLanes = TMC_LANES;
constexpr int kGroup = TMC_GROUP;
static_assert(kMode == kIndependence || kLanes == 1,
              "a walk runs one lane per chain");
static_assert(kLanes >= 1 && 32 % kLanes == 0 && kGroup >= 1,
              "lanes divide a warp");
// Chains per block (ops/mcmc_kernel.py: CHAIN_THREADS); see the header.
constexpr int kChains = 32;
constexpr int kThreads = kChains * kLanes;
constexpr int kPilotThreads = 256;
constexpr bool kDiag = TMC_DIAG != 0;
constexpr bool kDraws = TMC_SAMPLES != 0;
constexpr int kRows = tmc::block_row_count(kDiag);
constexpr int kLeapfrog = TMC_HMC;
constexpr bool kState = TMC_STATE != 0;
constexpr bool kInitState = TMC_INIT_STATE != 0;
static_assert(kLeapfrog == 0 || kMode != kIndependence,
              "HMC is a walk mode");
static_assert(!kInitState || kState, "a resumed run is stateful");
static_assert(!kState || kPropKind != tmc::kCustom || kPropGapped,
              "a stateful run's CUSTOM proposal reads its log table");
using Outputs = tmc::StepOutputs<TMC_K, 1, kDiag, kDraws>;
constexpr float kLogStepMin = -13.815511f;
constexpr float kLogStepMax = 13.815511f;

using Tables = tmc::McmcTables<1>;

// The run's parameters: the proposal row (p1, p2, -, -) or the walk's
// (step, init_lo, init_hi, target_accept), then the target's (p1, p2);
// and the CUSTOM tables.
struct Params {
  float q1, q2, q3, q4, t1, t2;
  Tables tb;
};

__device__ __forceinline__ Params load_params(const float* p,
                                              const Tables& tb) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5], tb};
}

// The target's log density at x: its family's closed form, or its log
// table.
__device__ __forceinline__ float log_target(const Params& p, float x) {
  if constexpr (kTargKind == tmc::kCustom) {
    return tmc::log_table_at<kTargKnots>(p.tb.targ[0], x);
  } else {
    return log_pdf(kTargKind, p.t1, p.t2, x);
  }
}

// The target's d/dx log density at x (HMC's gradient).
__device__ __forceinline__ float grad_target(const Params& p, float x) {
  if constexpr (kTargKind == tmc::kCustom) {
    return tmc::log_table_slope_at<kTargKnots>(p.tb.targ[0], x);
  } else {
    return tmc::log_pdf_grad(kTargKind, p.t1, p.t2, x);
  }
}

// The independence proposal's log density at a resumed chain's x0: its
// family's closed form, or its log table.
__device__ __forceinline__ float logq_at(const Params& p, float x) {
  if constexpr (kPropKind == tmc::kCustom) {
    return tmc::log_table_at<kQKnots>(p.tb.q[0], x);
  } else {
    return log_pdf(kPropKind, p.q1, p.q2, x);
  }
}

// The independence proposal's draw at the mantissa m, and its log density
// in `logq`: the family's transform and closed form; for a CUSTOM
// proposal the inverse table's draw (or the knot-exact one), and the
// sampler's own density at it or the proposal's log table at x.
__device__ __forceinline__ float propose(const Params& p, uint32_t m,
                                         float& logq) {
  if constexpr (kPropKind == tmc::kCustom) {
    float slope = 0.0f;
    const float x = kPropKnots ? tmc::knot_draw(p.tb.inv[0], m)
                               : tmc::table_draw(p.tb.inv[0], m, slope);
    if constexpr (kPropGapped) {
      logq = tmc::log_table_at<kQKnots>(p.tb.q[0], x);
    } else {
      logq = tmc::sampler_logq(p.tb.inv[0], slope);
    }
    return x;
  } else {
    const float x = tmc::transform(kPropKind, m, p.q1, p.q2);
    logq = log_pdf(kPropKind, p.q1, p.q2, x);
    return x;
  }
}

__device__ __forceinline__ uint32_t draw(uint32_t state, uint32_t counter,
                                         uint32_t pos) {
  return tmc::mantissa(tmc::block_base(state, counter, 0u), pos);
}

// The chain's state at counter 0; `logq` gets an independence proposal's
// log density there.
__device__ __forceinline__ float initial_x(const Params& p, uint32_t state,
                                           uint32_t pos, float& logq) {
  const uint32_t m = draw(state, 0u, pos);
  logq = 0.0f;
  if constexpr (kMode == kIndependence) return propose(p, m, logq);
  return p.q2 + tmc::halfopen01(m) * (p.q3 - p.q2);
}

// The candidate of independence step i.
struct Propose {
  Params p;
  uint32_t state, pos;

  __device__ __forceinline__ tmc::Candidate<1> operator()(uint32_t i) const {
    tmc::Candidate<1> c;
    c.x[0] = propose(p, draw(state, 3u * i + 1u, pos), c.logq);
    c.logp = log_target(p, c.x[0]);
    c.logu = logf(tmc::open01(draw(state, 3u * i + 2u, pos)));
    return c;
  }
};

// What walk step i takes from the stream, made ahead of the group's
// moves: the normal step z, logf of the accept uniform and, in the
// adaptive burn-in, the Robbins-Monro gain.
struct WalkDraw {
  float z, logu, gamma;
};

template <bool kAdapt>
struct WalkDraws {
  uint32_t state, pos;

  __device__ __forceinline__ WalkDraw operator()(uint32_t i) const {
    WalkDraw w;
    w.z = tmc::normal_from_u01(tmc::halfopen01(draw(state, 3u * i + 1u, pos)));
    w.logu = logf(tmc::open01(draw(state, 3u * i + 2u, pos)));
    w.gamma = kAdapt ? expf(-0.6f * logf(float(int(i + 1u)))) : 0.0f;
    return w;
  }
};

// A walk's move from (x, logp) with the normal draw z and the step: x' =
// x + step * z and log_alpha = logp' - logp, or under HMC the trajectory
// of kLeapfrog steps from the momentum z and the gradient g at x.
__device__ __forceinline__ tmc::HmcProposal<1> walk_move(const Params& p,
                                                        float x, float logp,
                                                        float g, float z,
                                                        float step) {
  if constexpr (kLeapfrog > 0) {
    const float xs[1] = {x}, gs[1] = {g}, zs[1] = {z}, steps[1] = {step};
    return tmc::hmc_move<kLeapfrog, 1>(
        xs, logp, gs, zs, steps, 1.0f,
        [&](const float (&v)[1], float (&gv)[1]) {
          gv[0] = grad_target(p, v[0]);
          return log_target(p, v[0]);
        });
  } else {
    tmc::HmcProposal<1> m;
    m.x[0] = x + step * z;
    m.logp = log_target(p, m.x[0]);
    m.log_alpha = m.logp - logp;
    return m;
  }
}

// One walk step (walk_move), accepted when logf(u) < log_alpha; the
// adaptive burn-in moves its log step by Robbins-Monro after each.  Under
// HMC the chain carries its gradient g with x and logp.
template <bool kAdapt, class Visit>
struct WalkStep {
  const Params& p;
  float (&x)[1];
  float& logp;
  float& g;
  float& step;
  float& log_step;
  Visit& visit;

  __device__ __forceinline__ void operator()(uint32_t, const WalkDraw& w) {
    if (kAdapt) step = expf(log_step);
    const tmc::HmcProposal<1> m = walk_move(p, x[0], logp, g, w.z, step);
    const float la = m.log_alpha;
    const bool accept = w.logu < la;
    if (accept) {
      x[0] = m.x[0];
      logp = m.logp;
      if constexpr (kLeapfrog > 0) g = m.g[0];
    }
    if (kAdapt) {
      const float alpha_p = expf(tmc_minimum(la, 0.0f));
      log_step = tmc_minimum(
          tmc_maximum(log_step + w.gamma * (alpha_p - p.q4), kLogStepMin),
          kLogStepMax);
    }
    visit(x, accept);
  }
};

// The sampling phase's per-chain sums, in step order: f_j(x) - pilot_j
// and the accept count; and the outputs' part (diagnostic halves, draws).
template <class Out>
struct Sums {
  float (&acc)[TMC_K];
  float& n_acc;
  const float* pilot;
  Out& out;

  __device__ __forceinline__ void operator()(const float (&x)[1],
                                             bool accepted) {
    if (accepted) n_acc += 1.0f;
    float vals[TMC_K];
    tmc_values(x[0], vals);
#pragma unroll
    for (int j = 0; j < TMC_K; ++j) {
      const float v = vals[j] - pilot[j];
      acc[j] += v;
      out.add(j, v);
    }
    out.step(x);
  }
};

// Sums `v` over the warp with a fixed shuffle tree; lane 0 gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The seed-mixed word a batch's rep `blockIdx.y` runs under, seeding as
// an unbatched launch with its seed word would: `seeds[rep] ^ 0x5BD1E995`
// (the host's seed_word, segment 0), or `seed` without a seed vector.
__device__ __forceinline__ uint32_t rep_seed(uint32_t seed,
                                             const uint32_t* seeds) {
  return seeds != nullptr ? seeds[blockIdx.y] ^ 0x5BD1E995u : seed;
}

// Rep blockIdx.y of a batch: its parameter row (`param_stride` 0 or 6) and
// its programs' pilots, (programs, K) floats a rep.
__global__ void __launch_bounds__(kPilotThreads)
mcmc_pilot_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
                  const float* __restrict__ params, int param_stride,
                  const Tables tb, int chains_per_program,
                  float* __restrict__ pilots) {
  const int rep = blockIdx.y;
  seed = rep_seed(seed, seeds);
  pilots += size_t(rep) * gridDim.x * TMC_K;
  const Params p = load_params(params + rep * param_stride, tb);
  const uint32_t pid = blockIdx.x;
  const uint32_t state = tmc::seed_state(seed, pid);
  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
  float vals[TMC_K];
  float logq;
  for (int pos = threadIdx.x; pos < chains_per_program;
       pos += kPilotThreads) {
    tmc_values(initial_x(p, state, uint32_t(pos), logq), vals);
#pragma unroll
    for (int j = 0; j < TMC_K; ++j) acc[j] += vals[j];
  }
  __shared__ float scratch[kPilotThreads / 32][TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) {
    const float s = warp_sum(acc[j]);
    if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32][j] = s;
  }
  __syncthreads();
  const float n_block = float(chains_per_program);
  for (int j = threadIdx.x; j < TMC_K; j += kPilotThreads) {
    float s = 0.0f;
    for (int w = 0; w < kPilotThreads / 32; ++w) s += scratch[w][j];
    pilots[pid * TMC_K + j] = s / n_block;
  }
}

// Rep blockIdx.y of a batch is one job: its seed word (rep_seed), its
// parameter row (`param_stride` 0 or 6), its programs' pilots, and its
// slabs of rows, final states and draws.  Chains, programs and positions
// count from blockIdx.x and gridDim.x alone, so a rep runs the chains of
// the unbatched launch with its seed.
__global__ void __launch_bounds__(kThreads)
mcmc_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
            const float* __restrict__ params, int param_stride,
            const Tables tb, int n_burnin, int n_steps,
            int chains_per_program, const float* __restrict__ pilots,
            float* __restrict__ rows, float* __restrict__ x_final,
            tmc::Draws draws, const float* __restrict__ x0,
            const float* __restrict__ logp0, float* __restrict__ logp_final) {
  __shared__ float s_pilot[TMC_K];

  const int rep = blockIdx.y;
  seed = rep_seed(seed, seeds);
  const size_t rep_chains = size_t(gridDim.x) * kChains;
  if (pilots != nullptr) {
    pilots += size_t(rep) * (rep_chains / chains_per_program) * TMC_K;
  }
  rows += size_t(rep) * gridDim.x * kRows * (TMC_K + 1);
  x_final += size_t(rep) * rep_chains;
  if constexpr (kDraws) draws.out += size_t(rep) * draws.m * rep_chains;
  const Params p = load_params(params + rep * param_stride, tb);
  // The chain's lanes are kLanes consecutive threads of one warp.
  const int lane = threadIdx.x % kLanes;
  const int chain = blockIdx.x * kChains + threadIdx.x / kLanes;
  // A block lies inside one program: 32 divides chains_per_program.
  const uint32_t pid = uint32_t(chain / chains_per_program);
  const uint32_t pos = uint32_t(chain % chains_per_program);
  const uint32_t state = tmc::seed_state(seed, pid);
  for (int j = threadIdx.x; j < TMC_K; j += kThreads) {
    s_pilot[j] = pilots != nullptr ? pilots[pid * TMC_K + j] : 0.0f;
  }
  if constexpr (kDiag) tmc::zero_diag_sums<TMC_K>();
  __syncthreads();

  float logq;
  float x[1];
  float logp;
  if constexpr (kInitState) {
    x[0] = x0[chain];
    logp = logp0[chain];
    logq = kMode == kIndependence ? logq_at(p, x[0]) : 0.0f;
  } else {
    x[0] = initial_x(p, state, pos, logq);
    logp = log_target(p, x[0]);
  }
  const uint32_t n_burn = uint32_t(n_burnin);

  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
  float n_acc = 0.0f;
  Outputs out = Outputs::start(draws, chain, gridDim.x * kChains, lane == 0);
  Sums<Outputs> sums{acc, n_acc, s_pilot, out};
  tmc::NoVisit none;
  // Under diagnostics the sampling phase runs in halves, each ended by
  // the block's reduction of the chains' halves.
  auto half_done = [&] { tmc::end_half<TMC_K, kLanes>(out, n_steps); };

  // Burn-in advances the chains without evaluating the integrands and
  // without counting acceptances; sampling adds both.
  if constexpr (kMode == kIndependence) {
    const Propose make{p, state, pos};
    tmc::SelectStep<1, tmc::NoVisit> burn{x, logp, logq, none};
    tmc::pipeline<kLanes, kGroup, tmc::Candidate<1>>(0u, n_burn, lane, make,
                                                     burn);
    tmc::SelectStep<1, Sums<Outputs>> sample{x, logp, logq, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<kLanes, kGroup, tmc::Candidate<1>>(b, e, lane, make,
                                                       sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  } else {
    constexpr bool kAdapt = kMode == kAdaptive;
    float step = p.q1;
    float log_step = logf(p.q1);
    float g = kLeapfrog > 0 ? grad_target(p, x[0]) : 0.0f;
    WalkStep<kAdapt, tmc::NoVisit> burn{p, x, logp, g, step, log_step, none};
    tmc::pipeline<1, kGroup, WalkDraw>(0u, n_burn, 0,
                                       WalkDraws<kAdapt>{state, pos}, burn);
    if (kAdapt) step = expf(log_step);
    WalkStep<false, Sums<Outputs>> sample{
        p, x, logp, g, step, log_step, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<1, kGroup, WalkDraw>(b, e, 0, WalkDraws<false>{state, pos},
                                         sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  }
  if (lane == 0) {
    x_final[chain] = x[0];
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

// The launch's tables from the host pointer `tables` (a tmc::McmcTables<1>,
// or null for the closed-form families).
Tables tables_of(const void* tables) {
  return tables != nullptr ? *static_cast<const Tables*>(tables) : Tables{};
}

}  // namespace

// Error-bar runs: the per-program pilots, (programs, K) floats, of the
// chains' initial states.  `tables` is a host pointer to the CUSTOM tables
// (tmc::McmcTables<1>) or null.  Returns cudaGetLastError() (0 when
// accepted).
// A batch of `reps` jobs runs in one launch: rep r under the seed word
// `seeds[r] ^ 0x5BD1E995` (`seeds` a device array of `reps` seeds), or
// `seed` for every rep where `seeds` is null; with its (6,) parameter row
// at `params + r * param_stride` (0 or 6); its pilots at `pilots + r *
// programs * TMC_K`.
extern "C" int tmc_mcmc_pilots(unsigned int seed, const unsigned int* seeds,
                               int reps, const float* params,
                               int param_stride, const void* tables,
                               int chains_per_program, int programs,
                               float* pilots, void* stream) {
  if (reps < 1 || reps > 65535 || (param_stride != 0 && param_stride != 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_pilot_kernel<<<dim3(programs, reps), kPilotThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      seed, seeds, params, param_stride, tables_of(tables),
      chains_per_program, pilots);
  return static_cast<int>(cudaGetLastError());
}

// Runs n_chains chains, 32 to a block of 32 * TMC_LANES threads, on
// `stream` (chains_per_program a multiple of 32, n_chains of
// chains_per_program).  `tables` as tmc_mcmc_pilots'; `pilots` may be
// null (no shift); `rows` holds (n_chains / 32) x R x (TMC_K + 1) floats,
// R = 7 with TMC_DIAG (n_steps >= 4) and 3 without, `x_final` n_chains;
// with TMC_SAMPLES, `samples` holds m x n_chains floats, row j the
// states after sampling step j * stride (1 <= m, m * stride <= n_steps),
// else it is ignored.  With TMC_INIT_STATE the chains start from x0 and
// logp0 (n_chains floats each), with TMC_STATE `logp_final` gets their
// final log densities (n_chains floats); else these are ignored.
// A batch of `reps` jobs runs in one launch, each seeded and with its
// parameter row as in tmc_mcmc_pilots, rep r's pilots at `pilots + r *
// (n_chains / chains_per_program) * TMC_K`, its rows, `x_final` and
// draws at r times their sizes above; a stateful run is one job.
// Returns cudaGetLastError() (0 when accepted).
extern "C" int tmc_mcmc(unsigned int seed, const unsigned int* seeds,
                        int reps, const float* params, int param_stride,
                        const void* tables, int n_burnin, int n_steps,
                        int chains_per_program, int n_chains,
                        const float* pilots, float* rows, float* x_final,
                        float* samples, int m, int stride, const float* x0,
                        const float* logp0, float* logp_final,
                        void* stream) {
  if (reps < 1 || reps > 65535 || (param_stride != 0 && param_stride != 6) ||
      ((kState || kInitState) && reps != 1) ||
      chains_per_program % kChains != 0 ||
      n_chains % chains_per_program != 0 || (kDiag && n_steps < 4) ||
      (kDraws && (samples == nullptr || m < 1 || stride < 1 ||
                  int64_t(m) * stride > n_steps)) ||
      (kInitState && (x0 == nullptr || logp0 == nullptr)) ||
      (kState && logp_final == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_kernel<<<dim3(n_chains / kChains, reps), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      seed, seeds, params, param_stride, tables_of(tables), n_burnin,
      n_steps, chains_per_program, pilots, rows, x_final,
      tmc::Draws{samples, m, stride}, x0, logp0, logp_final);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
