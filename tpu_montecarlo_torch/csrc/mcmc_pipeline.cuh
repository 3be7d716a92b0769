// The pipelined Metropolis-Hastings step that the 1-D and nd MCMC kernels
// share (mcmc.cu, mcmc_nd.cu): a chain's steps run in groups, the part of
// each step that does not depend on the chain's state is made ahead of the
// group's decisions, and under an independence proposal it is spread over
// several lanes of a warp.
//
// Under an independence proposal a step's candidate -- the proposal x',
// its target and proposal log densities logp' and logq', and logf(u) of
// the accept uniform -- depends only on (program, step, position), never
// on the chain's state.  Only the decision
//
//     la = ((logp' + logq) - logp) - logq',   accept = logf(u) < la,
//
// in that float32 order, and the select carry from one step to the next.
// So a chain's steps run in groups of G * L: each of the chain's L lanes
// (consecutive lanes of one warp) makes G candidates, lane l those of the
// group's steps g * L + l, and then every lane of the chain takes the
// group's candidates from their lanes with __shfl_sync, in step order, and
// runs the same decisions.  The L lanes thus hold the same chain state
// throughout, and a step's draws, transforms and log densities sit off the
// dependent path that runs from one decision to the next.
//
// A random walk's candidate x' = x + step * z depends on x, so a walk
// keeps one lane per chain (L = 1) and makes only the x-independent part
// of its steps ahead (the normal step z, logf(u), the adaptive gain).
//
// The tempered kernel (mcmc_pt.cu) runs the same pipeline on each rung of
// a ladder: rung t of a chain on its own lanes, its x-free draws made
// ahead, and after every step the pairs of rungs of the step's parity
// exchange states between their lanes by __shfl_sync (the second half of
// this file).
//
// Everything here but the block rows is plain C++ that also compiles on
// the host with `g++ -D__device__= -D__forceinline__=inline`, so the
// decisions, the grouping and the exchanges (lanes run as threads) are
// tested on the CPU against a float32 loop.
#pragma once

#include <cstdint>
#include <type_traits>

#include "hmc_move.cuh"        // PtWalkStep under HMC
#include "integrand_math.cuh"  // tmc_minimum, tmc_maximum (and host math)

namespace tmc {

// The candidate of one independence step, in D dimensions.
template <int D>
struct Candidate {
  float x[D];
  float logp;  // target log density at x
  float logq;  // proposal log density at x
  float logu;  // logf of the accept uniform
};

// The independence log acceptance ratio in the JAX kernels' float32 order.
__device__ __forceinline__ float independence_log_alpha(float logp_prop,
                                                        float logq_prop,
                                                        float logp,
                                                        float logq) {
  return ((logp_prop + logq) - logp) - logq_prop;
}

// One independence decision: moves (x, logp, logq) to the candidate when
// logf(u) < la (strict) and returns whether it did.
template <int D>
__device__ __forceinline__ bool select_candidate(const Candidate<D>& c,
                                                 float (&x)[D], float& logp,
                                                 float& logq) {
  const bool accept =
      c.logu < independence_log_alpha(c.logp, c.logq, logp, logq);
  if (accept) {
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = c.x[j];
    logp = c.logp;
    logq = c.logq;
  }
  return accept;
}

// `v` from lane `src` of the caller's segment of L consecutive lanes.  A
// host build may define TMC_HOST_SHFL(v, src, width) to run lanes as
// threads (the CPU tests do); without it the host takes only L = 1.
template <int L>
__device__ __forceinline__ float from_lane(float v, int src) {
  if constexpr (L == 1) {
    return v;
  } else {
#if defined(__CUDACC__)
    return __shfl_sync(0xffffffffu, v, src, L);
#elif defined(TMC_HOST_SHFL)
    return TMC_HOST_SHFL(v, src, L);
#else
    static_assert(L == 1, "lanes exchange values only on the card");
    return v;
#endif
  }
}

template <int L, int D>
__device__ __forceinline__ Candidate<D> from_lane(const Candidate<D>& c,
                                                  int src) {
  Candidate<D> r;
#pragma unroll
  for (int j = 0; j < D; ++j) r.x[j] = from_lane<L>(c.x[j], src);
  r.logp = from_lane<L>(c.logp, src);
  r.logq = from_lane<L>(c.logq, src);
  r.logu = from_lane<L>(c.logu, src);
  return r;
}

// What a tempered step takes from the stream, made ahead of the group's
// decisions: under an independence proposal the rung's candidate and the
// swap's log uniform; for a walk the normal steps z, logf(u), the adaptive
// gain and the swap's log uniform.
template <int D>
struct PtCandidate {
  Candidate<D> c;
  float logv;  // swap_logv of the swap uniform of the lane's pair
};

template <int D>
struct PtWalkDraw {
  float z[D];
  float logu, gamma, logv;
};

template <int L, int D>
__device__ __forceinline__ PtCandidate<D> from_lane(const PtCandidate<D>& c,
                                                    int src) {
  return {from_lane<L>(c.c, src), from_lane<L>(c.logv, src)};
}

template <int L, int D>
__device__ __forceinline__ PtWalkDraw<D> from_lane(const PtWalkDraw<D>& w,
                                                   int src) {
  PtWalkDraw<D> r;
#pragma unroll
  for (int j = 0; j < D; ++j) r.z[j] = from_lane<L>(w.z[j], src);
  r.logu = from_lane<L>(w.logu, src);
  r.gamma = from_lane<L>(w.gamma, src);
  r.logv = from_lane<L>(w.logv, src);
  return r;
}

// One group of G * L steps from step i0: this lane (`lane` of L) makes
// the candidates of steps i0 + g * L + lane with make(i), then step(i, c)
// runs on every step's candidate in step order.  A tail group (kTail)
// runs only its first n_valid steps: its other candidates are made (at
// counters past the run, never used) and exchanged, so every lane of the
// warp takes part in every shuffle.
template <int L, int G, bool kTail, class Cand, class Make, class Step>
__device__ __forceinline__ void pipeline_group(uint32_t i0, uint32_t n_valid,
                                               int lane, const Make& make,
                                               Step& step) {
  Cand own[G];
#pragma unroll
  for (int g = 0; g < G; ++g) own[g] = make(i0 + uint32_t(g * L + lane));
#pragma unroll
  for (int s = 0; s < G * L; ++s) {
    Cand c;
    if constexpr (L == 1) {
      c = own[s];
    } else {
      c = from_lane<L>(own[s / L], s % L);
    }
    if (!kTail || uint32_t(s) < n_valid) step(i0 + uint32_t(s), c);
  }
}

// Runs steps [begin, end) of a chain in groups of G * L (see above): full
// groups in a loop, then one tail group for what is left.
template <int L, int G, class Cand, class Make, class Step>
__device__ __forceinline__ void pipeline(uint32_t begin, uint32_t end,
                                         int lane, const Make& make,
                                         Step& step) {
  constexpr uint32_t kSteps = uint32_t(G * L);
  uint32_t i0 = begin;
  for (; i0 + kSteps <= end; i0 += kSteps) {
    pipeline_group<L, G, false, Cand>(i0, kSteps, lane, make, step);
  }
  if (i0 < end) {
    pipeline_group<L, G, true, Cand>(i0, end - i0, lane, make, step);
  }
}

// The step functor of an independence phase: each decision in order, then
// visit(x, accepted) (the sampling phase's sums; nothing in burn-in).
template <int D, class Visit>
struct SelectStep {
  float (&x)[D];
  float& logp;
  float& logq;
  Visit& visit;

  __device__ __forceinline__ void operator()(uint32_t,
                                             const Candidate<D>& c) {
    visit(x, select_candidate(c, x, logp, logq));
  }
};

struct NoVisit {
  template <int D>
  __device__ __forceinline__ void operator()(const float (&)[D], bool) {}
};

// -- The sampling phase's optional outputs ------------------------------------
//
// Diagnostics (TMC_DIAG) split each chain's sampling phase into two halves
// of n1 = n_steps / 2 steps (an odd last step is in neither) and keep, per
// half, the sums and squares of the pilot-shifted values f_k(x) - pilot_k
// that the chain's sums add; at the end of each half the block reduces
// them (end_half) to the JAX kernels' split-half statistics
// (mcmc_pallas.py:292-340).  Thinned draws (TMC_SAMPLES) store the
// post-step state at the phase's steps j * stride, j < m.  Neither changes
// a decision or the order in which the sums are added.

// The draws of a run: m rows of D * n_chains floats, row j holding the
// states after sampling step j * stride, dimension-major (out[(j * D +
// dim) * n_chains + chain]); `out` null when the run takes none.
struct Draws {
  float* out;
  int m, stride;
};

// Called by every lane of a chain once per sampling step, in step order,
// with the post-step state; a down-counter reaches 0 at the draw steps of
// the chain's writing lane (on the other lanes it starts at 0 and does
// not come back to it within 2^32 steps).  It would write on past the
// m-th draw: sampling_phase stops it at step m * stride (`span`).  A step
// costs a decrement and a compare; a draw step the stores and two moves.
template <int D>
struct DrawWriter {
  float* dst;          // the chain's column of the next draw's row
  uint32_t n_chains;
  uint32_t count;      // steps to the next draw
  uint32_t stride;
  uint32_t span;       // m * stride: the sampling steps that hold the draws

  __device__ __forceinline__ void operator()(const float (&x)[D]) {
    if (--count == 0u) {
      count = stride;
#pragma unroll
      for (int dim = 0; dim < D; ++dim) dst[size_t(dim) * n_chains] = x[dim];
      dst += size_t(D) * n_chains;
    }
  }
};

// A chain's diagnostic halves (kDiag): the current half's sums s_k and
// squares q_k of the values it adds; and its draws (kDraws).  With
// neither, every member and call compiles to nothing.
template <int K, int D, bool kDiag, bool kDraws>
struct StepOutputs {
  static constexpr bool kHalves = kDiag;
  static constexpr bool kWrites = kDraws;
  float s[kDiag ? K : 1], q[kDiag ? K : 1];
  DrawWriter<D> draws;

  // A chain's lane at the start of the sampling phase: halves at 0, and
  // the writer of the chain's draws (`writes` on the one lane of the
  // chain that stores them).
  __device__ __forceinline__ static StepOutputs start(const Draws& d,
                                                      int chain,
                                                      int n_chains,
                                                      bool writes) {
    StepOutputs out{};
    if constexpr (kDraws) {
      out.draws.dst = d.out + chain;
      out.draws.n_chains = uint32_t(n_chains);
      out.draws.count = writes ? 1u : 0u;
      out.draws.stride = uint32_t(d.stride);
      out.draws.span = uint32_t(d.m) * uint32_t(d.stride);
    }
    return out;
  }

  __device__ __forceinline__ void add(int k, float v) {
    if constexpr (kDiag) {
      s[k] += v;
      q[k] += v * v;
    }
  }
  __device__ __forceinline__ void step(const float (&x)[D]) {
    if constexpr (kDraws) draws(x);
  }
  // No draw after this: the counter at 0, as on a lane that never writes.
  __device__ __forceinline__ void stop_draws() {
    if constexpr (kDraws) draws.count = 0u;
  }
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int k = 0; k < (kDiag ? K : 1); ++k) s[k] = q[k] = 0.0f;
  }
};

// Rows per block of a kernel's sampling phase: sums, SS and centroid,
// then the four diagnostic rows.
constexpr int block_row_count(bool diag) { return diag ? 7 : 3; }

// Runs a sampling phase of n_steps steps from `begin` with run(b, e),
// which runs steps [b, e): in one piece, or under diagnostics
// (Out::kHalves) as the two halves of n1 = n_steps / 2 steps and then the
// odd last step, if any, calling half_done() on every thread after each
// half.  With draws (Out::kWrites) a piece that holds step begin + m *
// stride, the first after the m-th draw's stride, runs in two, the
// writer stopped between them, so no step from there on writes.  The
// draws are counter-based, so no cut changes a chain.
template <class Out, class Run, class HalfDone>
__device__ __forceinline__ void sampling_phase(uint32_t begin,
                                               uint32_t n_steps, Out& out,
                                               Run& run,
                                               HalfDone& half_done) {
  const auto piece = [&](uint32_t b, uint32_t e) {
    if constexpr (Out::kWrites) {
      const uint32_t cut = begin + out.draws.span;
#pragma unroll 1
      while (b < e) {
        if (b >= cut) out.stop_draws();
        const uint32_t stop = b < cut && cut < e ? cut : e;
        run(b, stop);
        b = stop;
      }
    } else {
      run(b, e);
    }
  };
  if constexpr (!Out::kHalves) {
    piece(begin, begin + n_steps);
  } else {
    const uint32_t n1 = n_steps / 2u;
#pragma unroll 1
    for (uint32_t part = 0; part < 3u; ++part) {
      const uint32_t b = begin + part * n1;
      piece(b, part < 2u ? b + n1 : begin + n_steps);
      if (part < 2u) half_done();
    }
  }
}

// -- Parallel tempering (mcmc_pt.cu) ----------------------------------------
//
// A chain's ladder of T rungs runs on W = T' * L consecutive lanes of a
// warp, T' the smallest power of two >= T: rung t on the L lanes t * L +
// l, which hold the same rung state and make its x-free draws in turn, as
// above.  Lanes of rungs t >= T pad the segment: they take part in every
// shuffle, decide nothing and count nothing.  Step i moves every rung,
// then the pairs (t, t + 1) with t of i's parity exchange: both lanes of a
// pair take the partner's logp by shuffle, compute the same delta from the
// same operands, hold the same swap uniform (both draw it, under the
// pair's tag t) and so take the same decision; on a swap each takes the
// partner's x, logp and (independence) logq.  An adaptive walk's log
// scale stays with its rung, so on a lane it never moves.

// The tempered log acceptance ratio in the JAX kernel's float32 order
// (mcmc_pt_pallas.py:449): beta * (logp' - logp), then under an
// independence proposal (q is not tempered) + logq - logq'.  The only
// code of this formula; it rounds otherwise than independence_log_alpha.
template <bool kIndep>
__device__ __forceinline__ float tempered_log_alpha(float beta,
                                                   float logp_prop,
                                                   float logp,
                                                   float logq_prop,
                                                   float logq) {
  const float la = beta * (logp_prop - logp);
  return kIndep ? (la + logq) - logq_prop : la;
}

// logf of a swap uniform v from [0, 1), a v of 0 taken as the subnormal
// 1e-38f (logf -87.5): the kernels are built without flush-to-zero.
__device__ __forceinline__ float swap_logv(float v) {
  return logf(fmaxf(v, 1e-38f));
}

// Pair (t, t + 1)'s exchange decision: logv < dbeta_t * (logp_{t+1} -
// logp_t), strict, dbeta_t = beta_t - beta_{t+1}.
__device__ __forceinline__ bool swap_accepted(float logv, float dbeta,
                                              float logp_lo,
                                              float logp_hi) {
  return logv < dbeta * (logp_hi - logp_lo);
}

// A lane's part in the exchanges of one parity.
struct PairLane {
  int partner;  // the partner rung's lane of the same l, in the segment
  int lo;       // the pair's lower rung t: the swap uniform's tag
  bool active;  // both rungs of the pair are < T
  bool lower;   // this lane holds rung t of (t, t + 1)
  bool counts;  // this lane counts the pair's swaps (rung t, l = 0)
  float dbeta;  // beta_t - beta_{t+1}
};

// The part of lane l of rung `rung` (of T) at `parity`; `dbeta` holds the
// T - 1 pair differences.
template <int L>
__device__ __forceinline__ PairLane pair_lane(int rung, int l, int n_temps,
                                              int parity,
                                              const float* dbeta) {
  PairLane p;
  p.lower = ((rung ^ parity) & 1) == 0;
  const int other = p.lower ? rung + 1 : rung - 1;
  p.lo = p.lower ? rung : other;
  p.active = other >= 0 && other < n_temps && rung < n_temps;
  p.partner = (p.active ? other : rung) * L + l;
  p.counts = p.active && p.lower && l == 0;
  p.dbeta = p.active ? dbeta[p.lo] : 0.0f;
  if (!p.active) p.lo = 0;
  return p;
}

// This lane's exchange at one step: every lane of the segment of W lanes
// takes part in the shuffles; returns whether the lane's pair swapped.
// Under HMC (kGrad) the gradient at x swaps with it.
template <int W, int D, bool kIndep, bool kGrad = false>
__device__ __forceinline__ bool exchange(const PairLane& pr, float logv,
                                         float (&x)[D], float& logp,
                                         float& logq, float (&g)[D]) {
  const float logp_o = from_lane<W>(logp, pr.partner);
  float x_o[D], g_o[D];
#pragma unroll
  for (int j = 0; j < D; ++j) x_o[j] = from_lane<W>(x[j], pr.partner);
  if constexpr (kGrad) {
#pragma unroll
    for (int j = 0; j < D; ++j) g_o[j] = from_lane<W>(g[j], pr.partner);
  }
  const float logq_o = kIndep ? from_lane<W>(logq, pr.partner) : 0.0f;
  const bool swap =
      pr.active && swap_accepted(logv, pr.dbeta, pr.lower ? logp : logp_o,
                                 pr.lower ? logp_o : logp);
  if (swap) {
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = x_o[j];
    if constexpr (kGrad) {
#pragma unroll
      for (int j = 0; j < D; ++j) g[j] = g_o[j];
    }
    logp = logp_o;
    if (kIndep) logq = logq_o;
  }
  return swap;
}

// One lane's rung, as the step functors below move it.
template <int D>
struct Rung {
  float x[D];
  float logp, logq;
  float g[D];           // HMC's gradient at x (else unused)
  float beta;
  bool real;            // rung < T (not a padding lane)
  PairLane even, odd;   // its part in the exchanges of each parity
  float swaps;          // swaps this lane counts
};

template <int W, int D, bool kIndep, bool kGrad = false>
__device__ __forceinline__ void exchange_step(uint32_t i, float logv,
                                              Rung<D>& r) {
  const PairLane pr = (i & 1u) ? r.odd : r.even;
  if (exchange<W, D, kIndep, kGrad>(pr, logv, r.x, r.logp, r.logq, r.g) &&
      pr.counts) {
    r.swaps += 1.0f;
  }
}

// The step functor of a tempered independence phase: the rung's decision
// on its candidate, the exchange, then visit(x, accepted).
template <int W, int D, class Visit>
struct PtSelectStep {
  Rung<D>& r;
  Visit& visit;

  __device__ __forceinline__ void operator()(uint32_t i,
                                             const PtCandidate<D>& c) {
    const float la = tempered_log_alpha<true>(r.beta, c.c.logp, r.logp,
                                              c.c.logq, r.logq);
    const bool accept = r.real && c.c.logu < la;
    if (accept) {
#pragma unroll
      for (int j = 0; j < D; ++j) r.x[j] = c.c.x[j];
      r.logp = c.c.logp;
      r.logq = c.c.logq;
    }
    exchange_step<W, D, true>(i, c.logv, r);
    visit(r.x, accept);
  }
};

// The step functor of a tempered walk phase: x'_j = x_j + eps_j * z_j,
// or under HMC (kLeapfrog > 0) the trajectory of hmc_move from the
// momenta z under the force beta * grad (the gradient carried in r.g);
// the rung's decision, in the adaptive burn-in (kAdapt) the rung's
// Robbins-Monro move of its log scale (eps = expf(log_scale) * step before
// each move), the exchange (which under HMC swaps the gradient with x),
// then visit(x, accepted).  `target(x')` is the target's log density;
// under HMC `target(x', g)` also writes its gradient in g.
template <int W, int D, bool kAdapt, class Target, class Visit,
          int kLeapfrog = 0>
struct PtWalkStep {
  const Target& target;
  const float (&step)[D];
  float target_accept;
  float lo_scale, hi_scale;  // the log scale's clip
  Rung<D>& r;
  float (&eps)[D];
  float& log_scale;
  Visit& visit;

  __device__ __forceinline__ void operator()(uint32_t i,
                                             const PtWalkDraw<D>& w) {
    if (kAdapt) {
      const float scale = expf(log_scale);
#pragma unroll
      for (int j = 0; j < D; ++j) eps[j] = scale * step[j];
    }
    float la;
    bool accept;
    if constexpr (kLeapfrog > 0) {
      const HmcProposal<D> m = hmc_move<kLeapfrog, D>(
          r.x, r.logp, r.g, w.z, eps, r.beta, target);
      la = m.log_alpha;
      accept = r.real && w.logu < la;
      if (accept) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          r.x[j] = m.x[j];
          r.g[j] = m.g[j];
        }
        r.logp = m.logp;
      }
    } else {
      float xp[D];
#pragma unroll
      for (int j = 0; j < D; ++j) xp[j] = r.x[j] + eps[j] * w.z[j];
      const float logp_prop = target(xp);
      la = tempered_log_alpha<false>(r.beta, logp_prop, r.logp, 0.0f, 0.0f);
      accept = r.real && w.logu < la;
      if (accept) {
#pragma unroll
        for (int j = 0; j < D; ++j) r.x[j] = xp[j];
        r.logp = logp_prop;
      }
    }
    if (kAdapt) {
      const float alpha_p = expf(tmc_minimum(la, 0.0f));
      log_scale = tmc_minimum(
          tmc_maximum(log_scale + w.gamma * (alpha_p - target_accept),
                      lo_scale),
          hi_scale);
    }
    exchange_step<W, D, false, (kLeapfrog > 0)>(i, w.logv, r);
    visit(r.x, accept);
  }
};

#ifdef __CUDACC__
// The block's three rows of K + C floats from its 32 chains: the sums of
// acc_k and of the C counts (mcmc.cu, mcmc_nd.cu: the accept count;
// mcmc_pt.cu: the cold accept and the swap count); the SS of the chain
// means acc_k / n_steps; their centroid, shifted back by the pilot (0 in
// the count columns).  Each chain's values are those of its lane 0; with
// L > 1 lanes per chain they are staged in shared memory for the first
// warp, so the sums take the same fixed shuffle tree over the 32 chains
// whatever L is.  Lane 0 of the block writes the rows.  Called by every
// thread of the block, last: threads past the first warp return from it.
template <int K, int L, int C>
__device__ __forceinline__ void write_block_rows(const float (&acc)[K],
                                                 const float (&counts)[C],
                                                 const float* s_pilot,
                                                 int n_steps, float* out) {
  constexpr int kW = K + C;
  const auto warp_sum = [](float v) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
  };
  __shared__ float stage[L > 1 ? kW : 1][32];
  if constexpr (L > 1) {
    if (threadIdx.x % L == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) stage[k][threadIdx.x / L] = acc[k];
#pragma unroll
      for (int c = 0; c < C; ++c) stage[K + c][threadIdx.x / L] = counts[c];
    }
    __syncthreads();
  }
  // Chain threadIdx.x's acc_k (k < K) or count k - K (k >= K).
  const auto value = [&](int k) {
    if constexpr (L > 1) {
      return stage[k][threadIdx.x];
    } else {
      return k < K ? acc[k] : counts[k - K];
    }
  };
  if (threadIdx.x >= 32) return;
  const float inv_steps = 1.0f / float(n_steps);
  const float n_b = 32.0f;
  const bool lane0 = threadIdx.x == 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = value(k);
    const float cm = a * inv_steps;
    const float s = warp_sum(a);
    const float s1 = warp_sum(cm);
    const float s2 = warp_sum(cm * cm);
    if (lane0) {
      const float mbs = s1 / n_b;
      out[k] = s;
      out[kW + k] = tmc_maximum(s2 - n_b * mbs * mbs, 0.0f);
      out[2 * kW + k] = mbs + s_pilot[k];
    }
  }
#pragma unroll
  for (int c = K; c < kW; ++c) {
    const float total = warp_sum(value(c));
    if (lane0) {
      out[c] = total;
      out[kW + c] = 0.0f;
      out[2 * kW + c] = 0.0f;
    }
  }
}

// The block's diagnostic sums, 3 x K floats in shared memory: over its 32
// chains and the halves so far, of the half-sequence means m_k = s_k / n1,
// of m_k^2, and of the squares q_k.  Zeroed by zero_diag_sums.
template <int K>
__device__ __forceinline__ float* diag_sums() {
  __shared__ float sums[3 * K];
  return sums;
}

// Every thread calls it before the sampling phase, ahead of a
// __syncthreads().
template <int K>
__device__ __forceinline__ void zero_diag_sums() {
  float* sums = diag_sums<K>();
  for (int n = threadIdx.x; n < 3 * K; n += blockDim.x) sums[n] = 0.0f;
}

// Adds to sums[k], k < K, the sum over the block's 32 chains of value(k)
// on each chain's first lane: chains run on CL consecutive lanes, so a
// block of 32 * CL threads is CL warps, each of whose lanes 0, CL, 2 CL,
// ... holds a chain.  The warps' sums, in a fixed shuffle tree, are then
// added in warp order: no atomics.  Called by every thread of the block.
template <int K, int CL>
__device__ __forceinline__ float* chain_stage() {
  __shared__ float stage[CL * K];
  return stage;
}

template <int K, int CL, class Value>
__device__ __forceinline__ void add_chain_sums(const Value& value,
                                               float* sums) {
  float* stage = chain_stage<K, CL>();
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = value(k);
#pragma unroll
    for (int off = 16; off >= CL; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (threadIdx.x % 32 == 0) stage[warp * K + k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < CL; ++w) total += stage[w * K + k];
    sums[k] += total;
  }
  __syncthreads();
}

// The end of a diagnostic half: the block's sums of m_k = s_k / n1, of
// m_k^2 and of q_k, added to diag_sums in that order; the chain's halves
// then start again from 0.
template <int K, int CL, class Out>
__device__ __forceinline__ void end_half(Out& out, int n_steps) {
  if constexpr (Out::kHalves) {  // else never called
    const float inv_n1 = 1.0f / float(n_steps / 2);
    float* sums = diag_sums<K>();
    add_chain_sums<K, CL>([&](int k) { return out.s[k] * inv_n1; }, sums);
    add_chain_sums<K, CL>(
        [&](int k) {
          const float m = out.s[k] * inv_n1;
          return m * m;
        },
        sums + K);
    add_chain_sums<K, CL>([&](int k) { return out.q[k]; }, sums + 2 * K);
    out.reset();
  }
}

// The block's four diagnostic rows of K + C floats, rows 3-6 of the JAX
// kernels' stat block (mcmc_pallas.py:312-340) over its 64 half-chain
// sequences: the sum of their means (pilot restored), the SS of the means
// around the block's centroid, that centroid, and the summed
// within-sequence variance (sum q - n1 * sum m^2) / max(n1 - 1, 1); 0 in
// the count columns.  Called by every thread after the last end_half.
template <int K, int C>
__device__ __forceinline__ void write_diag_rows(const float* s_pilot,
                                                int n_steps, float* out) {
  constexpr int kW = K + C;
  const float* sums = diag_sums<K>();
  const int n1 = n_steps / 2;
  const float n1f = float(n1 > 1 ? n1 : 1);
  const float denom_w = float(n1 - 1 > 1 ? n1 - 1 : 1);
  const float n_seq = 64.0f;  // 2 x 32 chains
  for (int c = threadIdx.x; c < kW; c += blockDim.x) {
    float seq_sum = 0.0f, ss = 0.0f, mb = 0.0f, w = 0.0f;
    if (c < K) {
      const float s_m = sums[c], s_msq = sums[K + c], s_q = sums[2 * K + c];
      w = (s_q - n1f * s_msq) / denom_w;
      const float mbs = s_m / n_seq;
      ss = tmc_maximum(s_msq - n_seq * mbs * mbs, 0.0f);
      mb = mbs + s_pilot[c];
      seq_sum = n_seq * mb;
    }
    out[c] = seq_sum;
    out[kW + c] = ss;
    out[2 * kW + c] = mb;
    out[3 * kW + c] = w;
  }
}

// The rows of K + 1 floats of a kernel whose one count is n_acc.
template <int K, int L>
__device__ __forceinline__ void write_block_rows(const float (&acc)[K],
                                                 float n_acc,
                                                 const float* s_pilot,
                                                 int n_steps, float* out) {
  const float counts[1] = {n_acc};
  write_block_rows<K, L, 1>(acc, counts, s_pilot, n_steps, out);
}
#endif  // __CUDACC__

}  // namespace tmc
