// Parallel-tempering (replica-exchange) Metropolis-Hastings kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_pt_mcmc_fn_pallas
// (tpu_montecarlo/ops/mcmc_pt_pallas.py:332-867, pallas_call at :928) in
// its independence, random-walk and adaptive random-walk modes and
// tempered HMC (TMC_HMC), with and without error bars, for d dimensions of the uniform, normal and
// exponential families and CUSTOM tables (target dimensions on a uniform
// or an irregular grid, and proposal dimensions on every route of
// mcmc_nd_common.cuh: sampler mode, gapped, knots, full; logq, from the
// draw or a log table, is rung-independent and swaps with the state, as a
// closed form's) under a product target or
// a traced joint log density, and a ladder of T >= 2 rungs.  Under the
// JAX package's CounterRng (the interpreter's stream) it runs the very
// ladders that kernel runs:
//
// * chain c belongs to program p = c / chains_per_program at position
//   pos = c % chains_per_program; the program's stream is seeded with
//   (seed ^ 0x165667B1, p), the tempered family's own mix (the wrapper
//   passes the mixed word).  Each chain carries its whole ladder: rung t
//   runs against pi^beta_t, beta_0 = 1 (the cold rung);
// * counter 0 draws the initial state of every rung, rung t dimension j
//   under tag t * d + j: a draw of the proposal family, or for a walk
//   lo_j + (hi_j - lo_j) * u;
// * step i, counted globally through burn-in and sampling, moves every
//   rung: rung t draws dimension j's proposal (or the walk's normal step)
//   at counter 3i+1, tag t * d + j, and its accept uniform, from (0, 1],
//   at 3i+2, tag t.  log_alpha = beta_t * (logp' - logp) (walk) or
//   beta_t * (logp' - logp) + logq - logq' (independence: q is not
//   tempered), accepted when logf(u) < log_alpha;
// * then the adjacent pairs (t, t+1) with t of i's parity try to
//   exchange: pair t draws v from [0, 1) at 3i+3, tag t, and swaps x,
//   logp and (independence) logq when logf(max(v, 1e-38f)) < (beta_t -
//   beta_{t+1}) * (logp_{t+1} - logp_t), the beta difference rounded to
//   float32 from float64.  A v of 0 (one draw in 2^24) takes the
//   subnormal 1e-38f, whose logf is -87.5: the kernel is built without
//   flush-to-zero, as the plain version and the JAX kernel compute it;
// * the adaptive walk carries one log scale per rung, starting at 0, that
//   stays with its rung through swaps; in burn-in Robbins-Monro moves it
//   toward dimension 0's target_accept on expf(min(log_alpha, 0)) of the
//   tempered log_alpha, gamma = expf(-0.6f * logf(i + 1)), clipped to
//   +-13.815511.  Sampling proposes with the scale expf(logf(expf(ls))),
//   the JAX kernel's round trip (scales, then their log, then exp);
// * tempered HMC (TMC_HMC = L, a walk mode; mcmc_pt_pallas.py:465-500)
//   takes the walk's d normal draws of rung t as its momenta and moves it
//   by tmc::hmc_move (hmc_move.cuh) with beta_t: half-kicks of
//   ((0.5f * beta_t) * eps_j) * g_j, log_alpha = (beta_t logp' - 0.5f
//   |p'|^2) - (beta_t logp - 0.5f |p0|^2); each rung carries its gradient
//   (mcmc_nd_common.cuh log_target_grad), which its exchanges swap with x
//   and logp; its adaptive step is the walk's.  On lanes a rung runs on
//   one lane (tmc::PtWalkStep); the ladder runs it in rung_move;
// * burn-in moves and swaps only; each sampling step moves, counts the
//   cold rung's accept, swaps, then adds f_k(x) - pilot_k at the cold
//   rung's post-swap state.  The swap count covers burn-in too.  The pilot
//   (error-bar runs only, else 0) is the mean of f_k over the program's
//   cold initial states, which are the nd kernel's initial states, so
//   mcmc_nd_common.cuh's pilot kernel computes it with this seed word.
//
// Output: per CUDA block, three rows of K + 2 floats (sums, the cold
// accept count and the swap count; SS of the chain means; their
// centroid), which ops/mcmc_pt_kernel.py's pt_finish combines; and
// x_final, the cold rung's final states as d rows of n_chains.
// Split-R-hat and ESS (TMC_DIAG) and thinned draws (TMC_SAMPLES) are
// mcmc.cu's over the cold rung (mcmc_pt_pallas.py:285-303, :596-665,
// :801-860): every lane keeps halves at its rung's values, as it adds
// its sums, and the block reduces the cold rung's lane 0; that lane
// writes the cold rung's post-swap draws as (m, d, n_chains) floats.  The
// ladder runs its sampling loop in the same parts.
//
// What bounds it on the card: latency, as for mcmc.cu and mcmc_nd.cu.  A
// chain is a serial loop of n_burnin + n_steps steps, each T rung moves
// of d + 1 draws (two PCG hashes each), d transforms, the log densities
// and logf of the accept uniform, then the active parity's swap draws;
// over the closed-form families nothing is read from memory in the loop
// (a CUSTOM dimension's tables are read with __ldg, as in mcmc.cu, on the
// carried chain only where a walk looks its target up at x').  The T rung
// moves of one step
// are independent of each other: the function's parallel work is T x
// chains rung moves per step (4 x 4096 on c12: 512 warps, one for each of
// the card's schedulers), and what carries from one step to the next is
// each rung's decision and its pair's exchange.
//
// Two layouts, compiled in (TMC_PT_RUNG_LANES, TMC_PT_LANES,
// TMC_PT_GROUP; ops/mcmc_pt_kernel.py's PtLayout), both 32 chains to a
// block and bit for bit the same ladders:
//
// * rungs on lanes (TMC_PT_RUNG_LANES = T', the smallest power of two
//   >= T): a chain's rung t runs on TMC_PT_LANES (L) consecutive lanes of
//   one warp, its segment of T' * L lanes padded past rung T - 1.  Each
//   lane keeps its rung's x, logp, logq and log scale in registers and
//   makes TMC_PT_GROUP of its x-free draws ahead of the group's decisions
//   (the walk's normal steps, logf(u), the swap's logf(v) and the
//   adaptive gain; under independence the whole candidate), spread over
//   its rung's L lanes, through mcmc_pipeline.cuh's pipeline; after each
//   decision the pairs exchange by __shfl_sync between their lanes.  The
//   cold rung's lanes add the integrands.  A block holds 32 * T' * L
//   threads;
// * the ladder (TMC_PT_RUNG_LANES = 1): one thread carries its chain's
//   whole ladder, T x (d states, logp[, logq][, log scale]) in registers,
//   and overlaps the T rung moves of a step itself; one warp to a block.
//   Every rung and pair loop is unrolled with compile-time indices, so no
//   ladder array is indexed at run time (that would put it in local
//   memory).  The swaps branch on i & 1, uniform across the warp, and
//   compute only the active parity's pairs; the JAX kernel computes both
//   parities and masks one, and since the pairs of the inactive parity
//   would swap nothing and the draws are counter-based, the chains are the
//   same.  It takes any T and is the layout above 32 rung lanes.
//
// T, d, the mode and the families are compiled in (TMC_T, TMC_D,
// TMC_MODE, TMC_*_KINDS).  The ladder itself (the betas and the pair
// differences) and the CUSTOM tables (tmc::McmcTables<d>) are run-time
// arguments: a new ladder or table needs no new build.  Sums are reduced
// once, at the end, with warp shuffles in a fixed order over the block's
// 32 chains: no atomics.
//
// Built without --use_fast_math and with --fmad=false, as the other
// kernels, so every float32 add and multiply rounds as in the plain
// PyTorch version and the JAX package.
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
// TMC_K, TMC_D, f_k(const float* x), tmc_values_nd; TMC_MODE, TMC_T; for
// independence TMC_PROP_KINDS; TMC_TARG_KINDS for a product target, else
// tmc_target_logpdf(const float* x); TMC_PT_RUNG_LANES, TMC_PT_LANES,
// TMC_PT_GROUP.
#include "tmc_integrands.inc"
#include "mcmc_nd_common.cuh"
#include "mcmc_pipeline.cuh"

namespace {

// The tempered family's seed mix (ops/mcmc_pt_kernel.py PT_SEED_MIX).
constexpr uint32_t kSeedMix = 0x165667B1u;
constexpr int kT = TMC_T;  // rungs
static_assert(kT >= 2, "a ladder has at least two rungs");
constexpr int kW = TMC_K + 2;  // row width: sums, accepts and swaps
constexpr int kRungLanes = TMC_PT_RUNG_LANES;
constexpr int kLanes = TMC_PT_LANES;  // lanes per rung
constexpr int kGroup = TMC_PT_GROUP;
constexpr bool kLadder = kRungLanes == 1;
// A chain's lanes, and the block's threads.
constexpr int kChainLanes = kRungLanes * kLanes;
constexpr int kThreads = kChainThreads * kChainLanes;
static_assert(kLadder ? kLanes == 1 && kGroup == 1
                      : kRungLanes >= kT && kRungLanes < 2 * kT &&
                            (kRungLanes & (kRungLanes - 1)) == 0,
              "rung lanes: 1 (the ladder) or T', the power of two >= T");
static_assert(kChainLanes <= 32 && 32 % kChainLanes == 0 && kGroup >= 1,
              "a chain's lanes divide a warp");
constexpr int kRows = tmc::block_row_count(kDiag);
using Outputs = tmc::StepOutputs<TMC_K, TMC_D, kDiag, kDraws>;

// The ladder as the wrapper packs it: the T betas, then the T - 1 pair
// differences beta_t - beta_{t+1}, each rounded to float32 from float64.
struct Ladder {
  float beta[kT], dbeta[kT - 1];
};

__device__ __forceinline__ Ladder load_ladder(const float* l) {
  Ladder r;
#pragma unroll
  for (int t = 0; t < kT; ++t) r.beta[t] = l[t];
#pragma unroll
  for (int t = 0; t + 1 < kT; ++t) r.dbeta[t] = l[kT + t];
  return r;
}

// The target's log density, for the step functors.
struct Target {
  const Params& p;

  __device__ __forceinline__ float operator()(const float (&x)[TMC_D]) const {
    return log_target(x, p);
  }
};

// The walk step's target: its log density, or under HMC its log density
// and gradient (tmc::hmc_move's value_grad).
#if TMC_HMC > 0
using WalkTarget = TargetGrad;
#else
using WalkTarget = Target;
#endif

// The sampling phase's per-lane sums, in step order: f_k(x) - pilot_k and
// the accept count, and the outputs' part (diagnostic halves, draws).
// Every lane of a chain adds them at its rung's state (no branch); the
// rows take the cold rung's, lane 0's, and lane 0 writes the draws.
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


// -- rungs on lanes -----------------------------------------------------------

// The swap uniform's tags of a lane: the lower rung of its pair at even
// and at odd steps.
struct SwapTags {
  uint32_t even, odd;

  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return (i & 1u) ? odd : even;
  }
};

// Independence step i's candidate for rung `rung`, made ahead.
struct PtPropose {
  Params p;
  uint32_t state, pos;
  int rung;
  SwapTags tag;

  __device__ __forceinline__ tmc::PtCandidate<TMC_D> operator()(
      uint32_t i) const {
    tmc::PtCandidate<TMC_D> c;
    float slope[TMC_D];
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      c.c.x[j] = draw_dim(
          j, p, draw(state, 3u * i + 1u, uint32_t(rung * TMC_D + j), pos),
          slope[j]);
    }
    c.c.logp = log_target(c.c.x, p);
    c.c.logq = log_proposal(c.c.x, slope, p);
    c.c.logu = logf(tmc::open01(draw(state, 3u * i + 2u, uint32_t(rung),
                                     pos)));
    c.logv = tmc::swap_logv(
        tmc::halfopen01(draw(state, 3u * i + 3u, tag(i), pos)));
    return c;
  }
};

// Walk step i's draws for rung `rung`, made ahead.
template <bool kAdapt>
struct PtWalkDraws {
  uint32_t state, pos;
  int rung;
  SwapTags tag;

  __device__ __forceinline__ tmc::PtWalkDraw<TMC_D> operator()(
      uint32_t i) const {
    tmc::PtWalkDraw<TMC_D> w;
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      w.z[j] = tmc::normal_from_u01(tmc::halfopen01(
          draw(state, 3u * i + 1u, uint32_t(rung * TMC_D + j), pos)));
    }
    w.logu = logf(tmc::open01(draw(state, 3u * i + 2u, uint32_t(rung), pos)));
    // A signed conversion (the same float for i < 2^31): chip_smoke.py's
    // bound counts the unsigned ones as the step's uniforms.
    w.gamma = kAdapt ? expf(-0.6f * logf(float(int(i + 1u)))) : 0.0f;
    w.logv = tmc::swap_logv(
        tmc::halfopen01(draw(state, 3u * i + 3u, tag(i), pos)));
    return w;
  }
};

// Sums `v` over the chain's kChainLanes lanes (integer-valued floats, so
// the order does not matter); every lane gets the sum.
__device__ __forceinline__ float chain_sum(float v) {
#pragma unroll
  for (int off = kChainLanes / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off, kChainLanes);
  }
  return v;
}

__device__ __forceinline__ void run_lanes(const Params& p,
                                          const float* __restrict__ ladder,
                                          uint32_t state, uint32_t pos,
                                          int n_burnin, int n_steps,
                                          const float* s_pilot,
                                          float (&acc)[TMC_K],
                                          float (&counts)[2], float* x_cold,
                                          const tmc::Draws& draws,
                                          int chain) {
  const int seg = threadIdx.x % kChainLanes;
  const int rung = seg / kLanes;
  const int l = seg % kLanes;
  tmc::Rung<TMC_D> r;
  r.real = rung < kT;
  r.beta = r.real ? ladder[rung] : 0.0f;
  r.even = tmc::pair_lane<kLanes>(rung, l, kT, 0, ladder + kT);
  r.odd = tmc::pair_lane<kLanes>(rung, l, kT, 1, ladder + kT);
  r.swaps = 0.0f;
  float slope[TMC_D];
  initial_x(p, state, pos, r.x, slope, uint32_t(rung * TMC_D));
  r.logp = log_target(r.x, p);
  r.logq = kMode == kIndependence ? log_proposal(r.x, slope, p) : 0.0f;
#if TMC_HMC > 0
  log_target_grad(r.x, p, r.g);
#endif

  const SwapTags tag{uint32_t(r.even.lo), uint32_t(r.odd.lo)};
  const uint32_t n_burn = uint32_t(n_burnin);
  float n_acc = 0.0f;
  Outputs out =
      Outputs::start(draws, chain, gridDim.x * kChainThreads, seg == 0);
  Sums<Outputs> sums{acc, n_acc, s_pilot, out};
  tmc::NoVisit none;
  // Under diagnostics the sampling phase runs in halves, each ended by
  // the block's reduction of the cold rungs' halves.
  auto half_done = [&] { tmc::end_half<TMC_K, kChainLanes>(out, n_steps); };
  if constexpr (kMode == kIndependence) {
    const PtPropose make{p, state, pos, rung, tag};
    tmc::PtSelectStep<kChainLanes, TMC_D, tmc::NoVisit> burn{r, none};
    tmc::pipeline<kLanes, kGroup, tmc::PtCandidate<TMC_D>>(0u, n_burn, l,
                                                           make, burn);
    tmc::PtSelectStep<kChainLanes, TMC_D, Sums<Outputs>> sample{r, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<kLanes, kGroup, tmc::PtCandidate<TMC_D>>(b, e, l, make,
                                                             sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  } else {
    constexpr bool kAdapt = kMode == kAdaptive;
    const WalkTarget target{p};
    float eps[TMC_D];  // the rung's step vector
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) eps[j] = p.q1[j];
    float log_scale = 0.0f;
    tmc::PtWalkStep<kChainLanes, TMC_D, kAdapt, WalkTarget, tmc::NoVisit,
                    kLeapfrog>
        burn{target, p.q1, p.q4[0], kLogScaleMin, kLogScaleMax, r, eps,
             log_scale, none};
    tmc::pipeline<kLanes, kGroup, tmc::PtWalkDraw<TMC_D>>(
        0u, n_burn, l, PtWalkDraws<kAdapt>{state, pos, rung, tag}, burn);
    if (kAdapt) {
      const float scale = expf(logf(expf(log_scale)));
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) eps[j] = scale * p.q1[j];
    }
    tmc::PtWalkStep<kChainLanes, TMC_D, false, WalkTarget, Sums<Outputs>,
                    kLeapfrog>
        sample{target, p.q1, p.q4[0], kLogScaleMin, kLogScaleMax, r, eps,
               log_scale, sums};
    auto run = [&](uint32_t b, uint32_t e) {
      tmc::pipeline<kLanes, kGroup, tmc::PtWalkDraw<TMC_D>>(
          b, e, l, PtWalkDraws<false>{state, pos, rung, tag}, sample);
    };
    tmc::sampling_phase(n_burn, uint32_t(n_steps), out, run, half_done);
  }
  counts[0] = n_acc;  // lane 0's is the cold rung's
  counts[1] = chain_sum(r.swaps);
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) x_cold[j] = r.x[j];
}

// -- the ladder ---------------------------------------------------------------

// One tempered MH move of rung t at global step i: moves (x, logp, logq;
// under HMC the gradient g) and returns whether the proposal was
// accepted; *log_alpha receives the tempered log acceptance ratio (the
// adaptive walk reads it).  `eps` is the rung's step vector, scale *
// step_j.
__device__ __forceinline__ bool rung_move(const Params& p, uint32_t state,
                                          uint32_t pos, uint32_t i, int t,
                                          float beta,
                                          const float (&eps)[TMC_D],
                                          float (&x)[TMC_D], float& logp,
                                          float& logq, float (&g)[TMC_D],
                                          float* log_alpha) {
#if TMC_HMC > 0
  float z[TMC_D];
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    z[j] = tmc::normal_from_u01(tmc::halfopen01(
        draw(state, 3u * i + 1u, uint32_t(t * TMC_D + j), pos)));
  }
  const tmc::HmcProposal<TMC_D> m = tmc::hmc_move<kLeapfrog, TMC_D>(
      x, logp, g, z, eps, beta, TargetGrad{p});
  const float u = tmc::open01(draw(state, 3u * i + 2u, uint32_t(t), pos));
  const bool accept = logf(u) < m.log_alpha;
  if (accept) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      x[j] = m.x[j];
      g[j] = m.g[j];
    }
    logp = m.logp;
  }
  *log_alpha = m.log_alpha;
  return accept;
#else
  float xp[TMC_D], slope[TMC_D];
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    const uint32_t m = draw(state, 3u * i + 1u, uint32_t(t * TMC_D + j), pos);
    if (kMode == kIndependence) {
      xp[j] = draw_dim(j, p, m, slope[j]);
    } else {
      xp[j] = x[j] + eps[j] * tmc::normal_from_u01(tmc::halfopen01(m));
    }
  }
  const float logp_prop = log_target(xp, p);
  float logq_prop = 0.0f, la;
  if (kMode == kIndependence) {
    logq_prop = log_proposal(xp, slope, p);
    la = tmc::tempered_log_alpha<true>(beta, logp_prop, logp, logq_prop,
                                       logq);
  } else {
    la = tmc::tempered_log_alpha<false>(beta, logp_prop, logp, 0.0f, 0.0f);
  }
  const float u = tmc::open01(draw(state, 3u * i + 2u, uint32_t(t), pos));
  const bool accept = logf(u) < la;
  if (accept) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) x[j] = xp[j];
    logp = logp_prop;
    logq = logq_prop;
  }
  *log_alpha = la;
  return accept;
#endif
}

// Pair (t, t+1)'s exchange at step i; adds one to `swaps` when it swaps.
__device__ __forceinline__ void try_swap(uint32_t state, uint32_t pos,
                                         uint32_t i, int t, float dbeta,
                                         float (&x)[kT][TMC_D],
                                         float (&logp)[kT],
                                         float (&logq)[kT],
                                         float (&g)[kT][TMC_D],
                                         float& swaps) {
  const float v = tmc::halfopen01(draw(state, 3u * i + 3u, uint32_t(t), pos));
  if (tmc::swap_accepted(tmc::swap_logv(v), dbeta, logp[t], logp[t + 1])) {
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      const float a = x[t][j];
      x[t][j] = x[t + 1][j];
      x[t + 1][j] = a;
      if (kLeapfrog > 0) {
        const float b = g[t][j];
        g[t][j] = g[t + 1][j];
        g[t + 1][j] = b;
      }
    }
    const float pa = logp[t];
    logp[t] = logp[t + 1];
    logp[t + 1] = pa;
    if (kMode == kIndependence) {
      const float qa = logq[t];
      logq[t] = logq[t + 1];
      logq[t + 1] = qa;
    }
    swaps += 1.0f;
  }
}

// The exchanges of step i: the pairs (t, t+1) with t of i's parity.
__device__ __forceinline__ void exchange(uint32_t state, uint32_t pos,
                                         uint32_t i, const Ladder& lad,
                                         float (&x)[kT][TMC_D],
                                         float (&logp)[kT],
                                         float (&logq)[kT],
                                         float (&g)[kT][TMC_D],
                                         float& swaps) {
  if (i & 1u) {
#pragma unroll
    for (int t = 1; t + 1 < kT; t += 2) {
      try_swap(state, pos, i, t, lad.dbeta[t], x, logp, logq, g, swaps);
    }
  } else {
#pragma unroll
    for (int t = 0; t + 1 < kT; t += 2) {
      try_swap(state, pos, i, t, lad.dbeta[t], x, logp, logq, g, swaps);
    }
  }
}

__device__ __forceinline__ void run_ladder(const Params& p,
                                           const float* __restrict__ ladder,
                                           uint32_t state, uint32_t pos,
                                           int n_burnin, int n_steps,
                                           const float* s_pilot,
                                           float (&acc)[TMC_K],
                                           float (&counts)[2],
                                           float* x_cold,
                                           const tmc::Draws& draws,
                                           int chain) {
  const Ladder lad = load_ladder(ladder);
  float x[kT][TMC_D], logp[kT], logq[kT];
  float g[kT][TMC_D];  // under HMC each rung's gradient at x
  float eps[kT][TMC_D];  // each rung's step vector
  float log_scale[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float slope[TMC_D];
    initial_x(p, state, pos, x[t], slope, uint32_t(t * TMC_D));
    logp[t] = log_target(x[t], p);
    logq[t] = kMode == kIndependence ? log_proposal(x[t], slope, p) : 0.0f;
#if TMC_HMC > 0
    log_target_grad(x[t], p, g[t]);
#endif
    log_scale[t] = 0.0f;
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) eps[t][j] = p.q1[j];
  }
  float la, swaps = 0.0f;

  // Burn-in: move every rung (adapting the walk's scales) and exchange.
  for (uint32_t i = 0; i < uint32_t(n_burnin); ++i) {
    // A signed conversion, as in PtWalkDraws.
    const float gamma = expf(-0.6f * logf(float(int(i) + 1)));
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (kMode == kAdaptive) {
        const float scale = expf(log_scale[t]);
#pragma unroll
        for (int j = 0; j < TMC_D; ++j) eps[t][j] = scale * p.q1[j];
      }
      rung_move(p, state, pos, i, t, lad.beta[t], eps[t], x[t], logp[t],
                logq[t], g[t], &la);
      if (kMode == kAdaptive) {
        const float alpha_p = expf(tmc_minimum(la, 0.0f));
        log_scale[t] = tmc_minimum(
            tmc_maximum(log_scale[t] + gamma * (alpha_p - p.q4[0]),
                        kLogScaleMin),
            kLogScaleMax);
      }
    }
    exchange(state, pos, i, lad, x, logp, logq, g, swaps);
  }
  if (kMode == kAdaptive) {
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float scale = expf(logf(expf(log_scale[t])));
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) eps[t][j] = scale * p.q1[j];
    }
  }

  float n_acc = 0.0f;
  Outputs out = Outputs::start(draws, chain, gridDim.x * kChainThreads, true);
  Sums<Outputs> sums{acc, n_acc, s_pilot, out};
  auto run = [&](uint32_t b, uint32_t e) {
    for (uint32_t i = b; i < e; ++i) {
      bool cold_accepted = false;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const bool accepted =
            rung_move(p, state, pos, i, t, lad.beta[t], eps[t], x[t],
                      logp[t], logq[t], g[t], &la);
        if (t == 0) cold_accepted = accepted;
      }
      exchange(state, pos, i, lad, x, logp, logq, g, swaps);
      sums(x[0], cold_accepted);
    }
  };
  auto half_done = [&] { tmc::end_half<TMC_K, 1>(out, n_steps); };
  tmc::sampling_phase(uint32_t(n_burnin), uint32_t(n_steps), out, run,
                      half_done);
  counts[0] = n_acc;
  counts[1] = swaps;
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) x_cold[j] = x[0][j];
}

// Rep blockIdx.y of a batch is one job (mcmc_nd_common.cuh): its seed
// word, its parameter row (`param_stride` 0 or TMC_D x 6), its programs'
// pilots, and its slabs of rows and final states, on either layout; the
// ladder is every rep's.
__global__ void __launch_bounds__(kThreads)
mcmc_pt_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
               const float* __restrict__ params, int param_stride,
               const float* __restrict__ ladder, const Tables tb,
               int n_burnin, int n_steps, int chains_per_program,
               const float* __restrict__ pilots, float* __restrict__ rows,
               float* __restrict__ x_final, const tmc::Draws draws) {
  __shared__ float s_pilot[TMC_K];

  const int rep = blockIdx.y;
  seed = rep_seed(seed, seeds, kSeedMix);
  const size_t rep_chains = size_t(gridDim.x) * kChainThreads;
  if (pilots != nullptr) {
    pilots += size_t(rep) * (rep_chains / chains_per_program) * TMC_K;
  }
  rows += size_t(rep) * gridDim.x * kRows * kW;
  x_final += size_t(rep) * TMC_D * rep_chains;
  const Params p = load_params(params + rep * param_stride, tb);
  const int chain = blockIdx.x * kChainThreads + threadIdx.x / kChainLanes;
  // A block lies inside one program: 32 divides chains_per_program.
  const uint32_t pid = uint32_t(chain / chains_per_program);
  const uint32_t pos = uint32_t(chain % chains_per_program);
  const uint32_t state = tmc::seed_state(seed, pid);
  for (int k = threadIdx.x; k < TMC_K; k += kThreads) {
    s_pilot[k] = pilots != nullptr ? pilots[pid * TMC_K + k] : 0.0f;
  }
  if constexpr (kDiag) tmc::zero_diag_sums<TMC_K>();
  __syncthreads();

  float acc[TMC_K];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) acc[k] = 0.0f;
  float counts[2];  // the cold accepts, the swaps
  float x_cold[TMC_D];
  if constexpr (kLadder) {
    run_ladder(p, ladder, state, pos, n_burnin, n_steps, s_pilot, acc,
               counts, x_cold, draws, chain);
  } else {
    run_lanes(p, ladder, state, pos, n_burnin, n_steps, s_pilot, acc, counts,
              x_cold, draws, chain);
  }
  if (threadIdx.x % kChainLanes == 0) {
    const int n_chains = gridDim.x * kChainThreads;
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) x_final[j * n_chains + chain] = x_cold[j];
  }

  // The block's rows: sums, then the SS and centroid of the chain means;
  // under diagnostics the four rows of the cold half-chain sequences.
  float* block_rows = rows + size_t(blockIdx.x) * kRows * kW;
  if constexpr (kDiag) {
    tmc::write_diag_rows<TMC_K, 2>(s_pilot, n_steps, block_rows + 3 * kW);
  }
  tmc::write_block_rows<TMC_K, kChainLanes, 2>(acc, counts, s_pilot, n_steps,
                                               block_rows);
}

}  // namespace

// Error-bar runs: the per-program pilots, (programs, K) floats, of the
// cold rung's initial states (mcmc_nd_common.cuh).  `seed` is the
// tempered seed word; `params` holds TMC_D x 6 floats; `tables` is a host
// pointer to the CUSTOM tables (tmc::McmcTables<TMC_D>) or null.  A batch
// of `reps` jobs runs in one launch: rep r under the seed word `seeds[r]
// ^ 0x165667B1` (`seeds` a device array of `reps` seeds), or `seed` for
// every rep where `seeds` is null; with its TMC_D x 6 row at `params + r
// * param_stride` (0 or TMC_D x 6); its pilots at `pilots + r * programs
// * TMC_K`.  Returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int tmc_mcmc_pt_pilots(unsigned int seed, const unsigned int* seeds,
                                  int reps, const float* params,
                                  int param_stride, const void* tables,
                                  int chains_per_program, int programs,
                                  float* pilots, void* stream) {
  return launch_pilots(seed, seeds, kSeedMix, reps, params, param_stride,
                       tables, chains_per_program, programs, pilots, stream);
}

// Runs n_chains ladders, 32 to a block of 32 * TMC_PT_RUNG_LANES *
// TMC_PT_LANES threads, on `stream` (chains_per_program a multiple of 32,
// n_chains of chains_per_program).  `params` holds TMC_D x 6 floats,
// `ladder` 2 * TMC_T - 1 (Ladder); `tables` as tmc_mcmc_pt_pilots';
// `pilots` may be null (no shift);
// `rows` holds (n_chains / 32) x R x (TMC_K + 2) floats, R = 7 with
// TMC_DIAG (n_steps >= 4) and 3 without, `x_final` TMC_D x n_chains; with
// TMC_SAMPLES, `samples` holds m x TMC_D x n_chains floats, row j the
// cold rung's post-swap states after sampling step j * stride (1 <= m,
// m * stride <= n_steps), else it is ignored.  A batch of `reps` jobs
// runs in one launch under one ladder, each seeded and with its parameter
// row as in tmc_mcmc_pt_pilots, rep r's pilots at `pilots + r * (n_chains
// / chains_per_program) * TMC_K`, its rows and `x_final` at r times their
// sizes above; a run with draws or diagnostics is one job (as the JAX
// kernel's, mcmc_pt_pallas.py:286-304).  Returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int tmc_mcmc_pt(unsigned int seed, const unsigned int* seeds,
                           int reps, const float* params, int param_stride,
                           const float* ladder, const void* tables,
                           int n_burnin, int n_steps, int chains_per_program,
                           int n_chains, const float* pilots, float* rows,
                           float* x_final, float* samples, int m, int stride,
                           void* stream) {
  if (!batch_valid(reps, param_stride) ||
      ((kDraws || kDiag) && reps != 1) ||
      chains_per_program % kChainThreads != 0 ||
      n_chains % chains_per_program != 0 ||
      !outputs_valid(n_steps, samples, m, stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc_pt_kernel<<<dim3(n_chains / kChainThreads, reps), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      seed, seeds, params, param_stride, ladder, tables_of(tables),
      n_burnin, n_steps, chains_per_program, pilots, rows, x_final,
      tmc::Draws{samples, m, stride});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
