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
// Everything here but the block rows is plain C++ that also compiles on
// the host with `g++ -D__device__= -D__forceinline__=inline`, so the
// decisions, the grouping and the exchange (lanes run as threads) are
// tested on the CPU against a float32 loop.
#pragma once

#include <cstdint>

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

#ifdef __CUDACC__
// The block's three rows of K + 1 floats (mcmc.cu's output) from its 32
// chains: the sums of acc_k and the accept counts; the SS of the chain
// means acc_k / n_steps; their centroid, shifted back by the pilot.  Each
// chain's values are those of its lane 0; with L > 1 they are staged in
// shared memory for the first warp, so the sums take the same fixed
// shuffle tree over the 32 chains whatever L is.  Lane 0 of the block
// writes the rows.  Called by every thread of the block, last: threads
// past the first warp return from it.
template <int K, int L>
__device__ __forceinline__ void write_block_rows(const float (&acc)[K],
                                                 float n_acc,
                                                 const float* s_pilot,
                                                 int n_steps, float* out) {
  constexpr int kW = K + 1;
  const auto warp_sum = [](float v) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
  };
  __shared__ float stage[L > 1 ? K + 1 : 1][32];
  if constexpr (L > 1) {
    if (threadIdx.x % L == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) stage[k][threadIdx.x / L] = acc[k];
      stage[K][threadIdx.x / L] = n_acc;
    }
    __syncthreads();
  }
  // Chain threadIdx.x's acc_k (k < K) or accept count (k == K).
  const auto value = [&](int k) {
    if constexpr (L > 1) {
      return stage[k][threadIdx.x];
    } else {
      return k < K ? acc[k] : n_acc;
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
  const float accepted = warp_sum(value(K));
  if (lane0) {
    out[K] = accepted;
    out[kW + K] = 0.0f;
    out[2 * kW + K] = 0.0f;
  }
}
#endif  // __CUDACC__

}  // namespace tmc
