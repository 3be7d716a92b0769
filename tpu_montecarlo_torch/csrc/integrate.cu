// Fused 1-D Monte Carlo integrate kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_integrate_fn_pallas
// (tpu_montecarlo/ops/integrate_pallas.py:969-1147, pallas_call at :1180)
// in its mc, antithetic and qmc modes, with and without error bars, for
// the uniform, normal and exponential families, the seven extended
// families and CUSTOM tables, and for importance-sampling sets weighted by traced densities, pdf tables or the
// CUSTOM sampler's own density.  It draws the very samples that kernel
// draws under the interpreter's CounterRng (integrate_pallas.py:107-133)
// or radical inverse at 256-row blocks:
//
// * mc: per (seed, program) a PCG state, per (program, block counter,
//   tag) a PCG base, per position pos = row * 128 + lane the bits
//   pcg(base + pos * 2654435761), uniforms from bits >> 8, then the
//   family transform (the normal family's two half blocks take tags 0
//   and 1);
// * antithetic: the same uniforms, each mapped at u and at its mirror
//   1 - u (the normal pair reflects z about the mean);
// * qmc: position pos of tile t is point g = t * 2^15 + pos of the radical
//   inverse, its uniform the top 24 bits of bitrev32(g) + shift with
//   shift = derive_shift(seed, 1) (the normal family's half blocks are
//   the tile's two contiguous halves of g, so every family takes the
//   tile's 2^15 points); from 2^32 points on, seg = t >> 17 re-mixes the
//   rotation (derive_segment_shift) and t & (2^17 - 1) is the block;
// * CUSTOM (TMC_CUSTOM, compiled in only for CUSTOM libraries): one block
//   of tag-0 [0, 1) uniforms w (one radical-inverse point per position
//   under qmc), each through the tables of tmc::Tables
//   (integrate_draw.cuh): route 1, the row-stratified inverse CDF
//   (integrate_pallas.py:367-477, 32 strata of 8 rows; the stratum comes
//   from the position's row in its tile, not from the thread), or the
//   gap-respecting tables of the same shape; route 2, the knot-exact
//   inverse by binary search over the CDF knots, for heavy-tailed tables
//   (the JAX package's XLA searchsorted route; the reference's own device
//   search, src/distribution.rs:128-158).  Antithetic mirrors w and 1 - w.
// * an extended family (TMC_FAMILY, its DistKind code 4-10, compiled in
//   only for that family's libraries, as TMC_CUSTOM is): one block of
//   tag-0 [0, 1) uniforms (one radical-inverse point per position under
//   qmc) through the family's inverse CDF (tmc::ext_inv,
//   integrate_pallas.py:592-600); antithetic evaluates the inverse at
//   1 - u afresh (:665-674).
//
// It evaluates the K integrands that ops/lower.py generated
// (tmc_integrands.inc; with TMC_WEIGHTED, each times
// the JAX kernel's weight where(q > 0, p / q, 0), p a traced density or a
// pdf table, q one of those or the sampler's density read with the draw,
// integrate_pallas.py:1009-1029) on every sample and keeps K
// float32 sums in registers, and with error bars (TMC_STDERR) K sums of
// (value - pilot)^2, of the pair's mean under antithetic.  The mode is
// compiled in (TMC_METHOD, TMC_STDERR): each is a library of its own, and
// plain mc compiles to the same code as without the modes.
//
// What bounds it on the card: issue.  Outside the CUSTOM family and table
// weights nothing is read from device memory in the sample loop (their
// table reads are L1-resident loads), and each CUDA block writes one row
// of K (2K) partial
// sums, so the time is the instructions each sample costs (the hash or
// the radical inverse, the conversion, the transform with erfinvf for the
// normal family, the K integrands with libdevice sinf, expf, ...) over the
// four schedulers of each SM: at the bench set (K = 8, N(0, 1)) issuing
// them takes most of the kernel's time on an H100.  chip_smoke.py counts
// them from this kernel's SASS (PERF.md section 6).
//
// What the design does about it:
// * The TPU grid has at most 512 blocks per program, so 1e9 samples are
//   only ~64 programs, too few for 132 SMs.  Here the unit of work is one
//   (program, block) tile of 256 x 128 positions; the counter stream and
//   the radical inverse let any CUDA block take any tile, so a grid-stride
//   loop spreads the programs x blocks tiles over up to `grid` CUDA blocks
//   of 256 threads.  A block steps its (program, block) pair without
//   64-bit division and seeds a program's stream only when the program
//   changes (tmc::TileWalk).
// * Thread t takes positions t, t + 256, ... of a block: their hashes
//   start from one cursor word stepped by a constant (tmc::cursor), so a
//   sample costs the hash's finish, not its two affine steps and the
//   position.  Under qmc the thread takes its 128 positions in the order
//   t + 256 * bitrev7(j), j = 0 .. 127, whose bit-reversed words are the
//   tile's word plus j << 17 (bit reversal maps the tile, thread and j
//   parts of g to disjoint bits), so a sample costs an add and a mask.
//   Trip counts are compile-time (64 or 128 per thread), the normal
//   family's two half blocks (tags 0 and 1) share one loop, and a loop
//   body holds kUnroll samples (tmc::default_unroll: 8 for a few
//   integrands, fewer for more, whose bodies would outgrow the instruction
//   cache; an antithetic position is two samples).  Sets of 17 integrands
//   or more keep a loop that counts positions at run time (sweep_wide);
//   every loop draws through one transform, so a sample does not depend
//   on the loop that drew it.
// * The transforms are integrate_draw.cuh's: the same uniforms, affine
//   steps as one fused multiply-add, the exponential's division as a
//   multiply by -1 / p1 made once per thread.
// * Accumulators stay in registers for the whole run (the error bars'
//   pilots too, up to 16 integrands; wider sets read them from shared
//   memory); the block reduces them once, with warp shuffles and a fixed
//   order, and writes its row.  No atomics: the result is deterministic
//   for a given plan.  A second pass (torch.sum over the rows, as the JAX
//   package sums its program rows at integrate_pallas.py:1214) finishes
//   the reduction.
// * The gradient build (TMC_GRAD, a library of its own: expectation_fn's
//   autograd estimator; the JAX package differentiates its XLA sweep,
//   tpu_montecarlo/api/integrate.py:301-405, with jax.grad) draws the
//   value build's samples, adds each f_k(x) to the value build's sums in
//   its order (the same loop: a set whose value build takes sweep_wide
//   compiles TMC_WIDE_K 1), and beside them 2K pathwise sums f_k'(x) *
//   dx/dp1 and f_k'(x) * dx/dp2 (integrate_draw.cuh transform_top_grad;
//   f_k' from ops/grad.py's IR gradient): K + 2K floats a row, values
//   first, then (k, parameter) pairs.  No error bars, CUSTOM tables or
//   weights: expectation_fn takes the analytic families only.
// * Built without --use_fast_math, so sinf, expf, logf and erfinvf keep
//   full float32 accuracy, and with --fmad=false, so the only fused
//   multiply-adds are those written out (tmc_fma).
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "integrate_draw.cuh"
#include "rows_sum.cuh"
#include "sobol.cuh"
#include "tmc_integrands.inc"  // TMC_K, f_0 .. f_{K-1}, the entries

// The mode, from the integrand source (IntegrateConfig.defines): 0 mc,
// 1 antithetic, 2 qmc; error bars or not.
#ifndef TMC_METHOD
#define TMC_METHOD 0
#endif
#ifndef TMC_STDERR
#define TMC_STDERR 0
#endif
#ifndef TMC_GRAD
#define TMC_GRAD 0
#endif
// tools/integrate_sweep.py may set TMC_UNROLL (samples per loop body) and
// TMC_WIDE_K (the first integrand count that takes sweep_wide) to time
// other values; the package sets TMC_WIDE_K only to 1, in a gradient build
// whose set's value build takes sweep_wide (IntegrateConfig.wide_loop).
#ifndef TMC_WIDE_K
#define TMC_WIDE_K 17
#endif
// The CUSTOM route (IntegrateConfig.custom): 0 none, 1 strata, 2 knots.
#ifndef TMC_CUSTOM
#define TMC_CUSTOM 0
#endif
// The extended family a library draws (IntegrateProgram.library): 0 none
// (the library takes the uniform, normal and exponential families), else
// its DistKind code, 4-10.
#ifndef TMC_FAMILY
#define TMC_FAMILY 0
#endif
#ifndef TMC_WEIGHTED
#define TMC_WEIGHTED 0
#endif

namespace {

using tmc::kExponential;
using tmc::kNormal;
using tmc::kUniform;

enum Method { kMc = 0, kAntithetic = 1, kQmc = 2 };
constexpr int kMethod = TMC_METHOD;
constexpr bool kStderr = TMC_STDERR != 0;
constexpr bool kGrad = TMC_GRAD != 0;
static_assert(kMethod >= kMc && kMethod <= kQmc, "TMC_METHOD is 0, 1 or 2");
static_assert(!kGrad || (!kStderr && TMC_CUSTOM == 0 && TMC_WEIGHTED == 0),
              "a gradient build takes no error bars, tables or weights");
constexpr int kCustomRoute = TMC_CUSTOM;
enum CustomRoute { kNoCustom = 0, kStrataRoute = 1, kKnotRoute = 2 };
static_assert(kCustomRoute >= kNoCustom && kCustomRoute <= kKnotRoute,
              "TMC_CUSTOM is 0, 1 or 2");
constexpr int kFamily = TMC_FAMILY;
static_assert(kFamily == 0 ||
                  (kFamily >= tmc::kLognormal && kFamily <= tmc::kPareto),
              "TMC_FAMILY is 0 or an extended family's code, 4-10");
static_assert(kFamily == 0 || kCustomRoute == kNoCustom,
              "a library draws one of CUSTOM tables or an extended family");
#if TMC_WEIGHTED
constexpr bool kSampler = TMC_Q_MODE == 2;
#else
constexpr bool kSampler = false;
#endif
static_assert(!kSampler || kCustomRoute == kStrataRoute,
              "a sampler-mode weight reads the strata tables' density");

constexpr int kLanes = tmc::kLanes;
constexpr int kBlockRows = 256;
constexpr int kThreads = 256;
constexpr int kTilePositions = kBlockRows * kLanes;  // 2^15
constexpr int kPosBits = 15;
// Samples one position gives.
constexpr int kPerPosition = kMethod == kAntithetic ? 2 : 1;
#ifdef TMC_UNROLL
constexpr int kUnroll = TMC_UNROLL;
#else
// Samples per body; a gradient build's body carries 3K sums.
constexpr int kUnroll = tmc::default_unroll(kGrad ? 3 * TMC_K : TMC_K, 1);
#endif
// Positions per loop body.
constexpr int kPosUnroll = kUnroll > kPerPosition ? kUnroll / kPerPosition : 1;
// Integrand sets from this size on take sweep_wide.
constexpr int kWideK = TMC_WIDE_K;
constexpr bool kWide = TMC_K >= kWideK;
constexpr int kOut = kStderr ? 2 * TMC_K : (kGrad ? 3 * TMC_K : TMC_K);
// The second accumulator array: the error bars' K squares, or a gradient
// build's 2K pathwise sums.
constexpr int kSq = kGrad ? 2 * TMC_K : (kStderr ? TMC_K : 1);
// The cursor's step between a thread's positions t, t + 256, ...
constexpr uint32_t kStep = uint32_t(kThreads) * tmc::kCursorStride;
// The step of a thread's bit-reversed point word under qmc:
// bitrev32(256 * bitrev7(j)) = j << 17.
constexpr uint32_t kQmcStep = 1u << 17;

// The sample of position pos (in its tile) from its top-24 word; *q gets
// the sampler's density under a sampler-mode weight.
template <int KIND>
__device__ __forceinline__ float draw(uint32_t top, uint32_t pos,
                                      const tmc::Family& f,
                                      const tmc::Tables& tb, float* q) {
  if constexpr (KIND == tmc::kCustom) {
    if constexpr (kCustomRoute == kKnotRoute) {
      return tmc::knot_interp(tmc::halfopen_top(top), tb.ck, tb.xk, tb.m);
    } else {
      return tmc::strata_x<kSampler>(tb, pos, float(top) * tmc::kW127, q);
    }
  } else {
    return tmc::transform_top(KIND, top, f);
  }
}

// The antithetic pair of position pos: at w and at 1 - w.
template <int KIND>
__device__ __forceinline__ void draw_pair(uint32_t top, uint32_t pos,
                                          const tmc::Family& f,
                                          const tmc::Tables& tb, float& a,
                                          float& b, float* qa, float* qb) {
  if constexpr (KIND == tmc::kCustom) {
    const float w = tmc::halfopen_top(top);
    const float v = 1.0f - w;  // exact
    if constexpr (kCustomRoute == kKnotRoute) {
      a = tmc::knot_interp(w, tb.ck, tb.xk, tb.m);
      b = tmc::knot_interp(v, tb.ck, tb.xk, tb.m);
    } else {
      a = tmc::strata_x<kSampler>(tb, pos, w * 127.0f, qa);
      b = tmc::strata_x<kSampler>(tb, pos, v * 127.0f, qb);
    }
  } else {
    tmc::transform_pair_top(KIND, top, f, a, b);
  }
}

#if TMC_WEIGHTED
// The JAX kernel's importance weight at x: where(q > 0, p / q, 0), p and
// q each from its mode (TMC_P_MODE, TMC_Q_MODE: 0 traced, 1 uniform-grid
// table, 2 the sampler's density q_samp, 3 irregular-grid table).
__device__ __forceinline__ float kernel_weight(float x, float q_samp,
                                               const tmc::Tables& tb) {
#if TMC_P_MODE == 0
  const float p = tmc_pdf_p(x);
#elif TMC_P_MODE == 1
  const float p = tmc::uniform_table_value(x, tb.p);
#else
  const float p = tmc::knot_table_value(x, tb.p);
#endif
#if TMC_Q_MODE == 0
  const float q = tmc_pdf_q(x);
#elif TMC_Q_MODE == 1
  const float q = tmc::uniform_table_value(x, tb.q);
#elif TMC_Q_MODE == 2
  const float q = q_samp;
#else
  const float q = tmc::knot_table_value(x, tb.q);
#endif
  const bool ok = q > 0.0f;
  const float safe_q = ok ? q : 1.0f;
  return ok ? p / safe_q : 0.0f;
}
#endif

// One position's top 24 bits and its place pos in the tile: its sample(s),
// and the integrands into the sums (and squares, or a gradient build's
// pathwise sums in sq).
template <int KIND>
__device__ __forceinline__ void take(uint32_t top, uint32_t pos,
                                     const tmc::Family& f,
                                     const tmc::Tables& tb,
                                     const float* pilot, float* acc,
                                     float* sq) {
#if TMC_GRAD
  if constexpr (kMethod == kAntithetic) {
    float a, b, da[2], db[2];
    tmc::transform_pair_top_grad(KIND, top, f, a, b, da, db);
    tmc_accumulate_grad(a, da[0], da[1], acc, sq);
    tmc_accumulate_grad(b, db[0], db[1], acc, sq);
  } else {
    float d[2];
    const float x = tmc::transform_top_grad(KIND, top, f, d);
    tmc_accumulate_grad(x, d[0], d[1], acc, sq);
  }
  return;
#endif
  if constexpr (kMethod == kAntithetic) {
    float a, b, qa = 0.0f, qb = 0.0f;
    draw_pair<KIND>(top, pos, f, tb, a, b, &qa, &qb);
#if TMC_WEIGHTED
    const float wa = kernel_weight(a, qa, tb);
    const float wb = kernel_weight(b, qb, tb);
    if constexpr (kStderr) {
      tmc_accumulate_pair_sq_w(a, b, wa, wb, pilot, acc, sq);
    } else {
      tmc_accumulate_w(a, wa, acc);
      tmc_accumulate_w(b, wb, acc);
    }
#else
    if constexpr (kStderr) {
      tmc_accumulate_pair_sq(a, b, pilot, acc, sq);
    } else {
      tmc_accumulate(a, acc);
      tmc_accumulate(b, acc);
    }
#endif
  } else {
    float q = 0.0f;
    const float x = draw<KIND>(top, pos, f, tb, &q);
#if TMC_WEIGHTED
    const float w = kernel_weight(x, q, tb);
    if constexpr (kStderr) {
      tmc_accumulate_sq_w(x, w, pilot, acc, sq);
    } else {
      tmc_accumulate_w(x, w, acc);
    }
#else
    if constexpr (kStderr) {
      tmc_accumulate_sq(x, pilot, acc, sq);
    } else {
      tmc_accumulate(x, acc);
    }
#endif
  }
}

// Draws positions t, t + 256, ... of the TAGS parts (tags 0 .. TAGS - 1)
// of one tile in one loop, transforms and accumulates the integrands,
// kUnroll samples per loop body (at least one position per part).  The
// positions a thread takes do not change the sums' values beyond float32
// summation order.
template <int KIND, int TAGS>
__device__ __forceinline__ void sweep(uint32_t state, uint32_t blk,
                                      const tmc::Family& f,
                                      const tmc::Tables& tb,
                                      const float* pilot, float* acc,
                                      float* sq) {
  constexpr int kPerThread = kTilePositions / TAGS / kThreads;
  uint32_t x0[TAGS];
#pragma unroll
  for (int t = 0; t < TAGS; ++t) {
    x0[t] = tmc::cursor(tmc::block_base(state, blk, uint32_t(t)),
                        threadIdx.x);
  }
#pragma unroll (kPosUnroll > TAGS ? kPosUnroll / TAGS : 1)
  for (int i = 0; i < kPerThread; ++i) {
#pragma unroll
    for (int t = 0; t < TAGS; ++t) {
      take<KIND>(tmc::cursor_top24(x0[t] + uint32_t(i) * kStep),
                 threadIdx.x + uint32_t(i) * kThreads, f, tb, pilot, acc,
                 sq);
    }
  }
}

// The sample loop of wide integrand sets (TMC_K >= kWideK): the position
// counted at run time, each sample's top 24 bits from tmc::mantissa, and
// sweep's transform.  Its body is mostly the integrands, and on an H100 it
// ran faster than the cursor loop at every count from 17 to 24 and at 32
// and 128, slower at 9 to 16 (tools/integrate_sweep.py, PERF.md
// section 6).
template <int KIND>
__device__ __forceinline__ void sweep_wide(uint32_t state, uint32_t blk,
                                           uint32_t tag, int n_pos,
                                           const tmc::Family& f,
                                           const tmc::Tables& tb,
                                           const float* pilot, float* acc,
                                           float* sq) {
  const uint32_t base = tmc::block_base(state, blk, tag);
  for (int pos = threadIdx.x; pos < n_pos; pos += kThreads) {
    take<KIND>(tmc::mantissa(base, uint32_t(pos)) << 8, uint32_t(pos), f, tb,
               pilot, acc, sq);
  }
}

// One tile under mc or antithetic: the normal family's two half blocks,
// tags 0 and 1 (integrate_pallas.py:571-581), in one loop; the others'
// one block, tag 0.
template <int KIND>
__device__ __forceinline__ void draw_tile(uint32_t state, uint32_t blk,
                                          const tmc::Family& f,
                                          const tmc::Tables& tb,
                                          const float* pilot, float* acc,
                                          float* sq) {
  constexpr int kTags = KIND == kNormal ? 2 : 1;
  if constexpr (!kWide) {
    sweep<KIND, kTags>(state, blk, f, tb, pilot, acc, sq);
  } else {
#pragma unroll
    for (int t = 0; t < kTags; ++t) {
      sweep_wide<KIND>(state, blk, uint32_t(t), kTilePositions / kTags, f,
                       tb, pilot, acc, sq);
    }
  }
}

// One tile under qmc: the 128 points of this thread from the tile's word
// `word` (bitrev32 of the thread's first point plus the rotation), j << 17
// apart; wide sets keep the loop rolled.
template <int KIND>
__device__ __forceinline__ void draw_tile_qmc(uint32_t word,
                                              const tmc::Family& f,
                                              const tmc::Tables& tb,
                                              const float* pilot, float* acc,
                                              float* sq) {
  constexpr int kPerThread = kTilePositions / kThreads;
#pragma unroll (kWide ? 1 : kPosUnroll)
  for (int j = 0; j < kPerThread; ++j) {
    // The position t + 256 * bitrev7(j) (CUSTOM reads its row).
    take<KIND>((word + uint32_t(j) * kQmcStep) & 0xFFFFFF00u,
               threadIdx.x + kThreads * (__brev(uint32_t(j)) >> 25), f, tb,
               pilot, acc, sq);
  }
}

// Every tile of this CUDA block's grid-stride walk.
template <int KIND>
__device__ __forceinline__ void draw_tiles(uint32_t seed, int loops,
                                           long long n_tiles, int seg_bits,
                                           const tmc::Family& f,
                                           const tmc::Tables& tb,
                                           const float* pilot, float* acc,
                                           float* sq) {
  if (kMethod == kQmc) {
    const uint32_t shift0 = tmc::derive_shift(seed, 1u);
    const uint32_t thread_word = __brev(threadIdx.x);
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      uint32_t b = uint32_t(tile);
      uint32_t seg = 0u;
      if (seg_bits >= 0) {
        seg = b >> seg_bits;
        b &= (1u << seg_bits) - 1u;
      }
      // bitrev32(b * 2^15 + t): the block's and the thread's bits land
      // on disjoint bits, so their words add.
      const uint32_t word = __brev(b << kPosBits) + thread_word +
                            tmc::derive_segment_shift(shift0, seg);
      draw_tile_qmc<KIND>(word, f, tb, pilot, acc, sq);
    }
  } else {
    tmc::TileWalk walk(seed, uint32_t(loops), blockIdx.x, gridDim.x);
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      draw_tile<KIND>(walk.stream(), walk.blk, f, tb, pilot, acc, sq);
      walk.next();
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Rep blockIdx.y of a batch is one job: its seed word (`seeds[rep]`, or
// `seed` without a seed vector), its (p1, p2) row and pilot row (shared
// where the strides are 0) and its gridDim.x x kOut partials.  The
// stream cursor sees only blockIdx.x and gridDim.x, so a rep draws what
// the unbatched launch with its seed draws.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
integrate_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
                 const float* __restrict__ params, int param_stride,
                 const float* __restrict__ pilots, int pilot_stride,
                 int loops, long long n_tiles, int seg_bits,
                 float* __restrict__ partials, const tmc::Tables tb) {
  const int rep = blockIdx.y;
  if (seeds != nullptr) seed = seeds[rep];
  params += rep * param_stride;
  pilots += rep * pilot_stride;
  partials += static_cast<long long>(rep) * gridDim.x * kOut;
  const tmc::Family f = tmc::family(params[0], params[1]);
  __shared__ float warp_sums[kThreads / 32][kOut];
  float acc[TMC_K];
  float sq[kSq];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < kSq; ++j) sq[j] = 0.0f;
  // Pilots: registers for narrow sets, shared memory for wide ones.
  if constexpr (kStderr && kWide) {
    __shared__ float s_pilot[TMC_K];
    for (int j = threadIdx.x; j < TMC_K; j += kThreads) s_pilot[j] = pilots[j];
    __syncthreads();
    draw_tiles<KIND>(seed, loops, n_tiles, seg_bits, f, tb, s_pilot, acc,
                     sq);
  } else if constexpr (kStderr) {
    float r_pilot[TMC_K];
#pragma unroll
    for (int j = 0; j < TMC_K; ++j) r_pilot[j] = pilots[j];
    draw_tiles<KIND>(seed, loops, n_tiles, seg_bits, f, tb, r_pilot, acc,
                     sq);
  } else {
    draw_tiles<KIND>(seed, loops, n_tiles, seg_bits, f, tb, nullptr, acc,
                     sq);
  }

  // Block reduction in a fixed order: warp shuffles, then one thread per
  // output sums the per-warp values in warp order.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) warp_sums[warp][j] = v;
    if constexpr (kStderr) {
      const float q = warp_sum(sq[j]);
      if (lane == 0) warp_sums[warp][TMC_K + j] = q;
    }
  }
  if constexpr (kGrad) {
#pragma unroll
    for (int j = 0; j < 2 * TMC_K; ++j) {
      const float g = warp_sum(sq[j]);
      if (lane == 0) warp_sums[warp][TMC_K + j] = g;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kOut; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][j];
    partials[blockIdx.x * kOut + j] = s;
  }
}

// Whether the tables a launch got are the ones its library reads.
bool tables_ok(const tmc::Tables& tb) {
  if (kCustomRoute == kStrataRoute &&
      (tb.ts == nullptr || tb.dts == nullptr || kSampler != (tb.qs != nullptr))) {
    return false;
  }
  if (kCustomRoute == kKnotRoute &&
      (tb.xk == nullptr || tb.ck == nullptr || tb.m < 2)) {
    return false;
  }
#if TMC_WEIGHTED
  const tmc::WeightTab* tabs[2] = {&tb.p, &tb.q};
  const int modes[2] = {TMC_P_MODE, TMC_Q_MODE};
  for (int i = 0; i < 2; ++i) {
    const tmc::WeightTab& t = *tabs[i];
    if (modes[i] == 1 && (t.vals == nullptr || t.dx == nullptr || t.n < 2)) {
      return false;
    }
    if (modes[i] == 3 && (t.keys == nullptr || t.vals == nullptr || t.n < 2)) {
      return false;
    }
  }
#endif
  return true;
}

// One launch's arguments besides the kind and the tables.
struct Launch {
  uint32_t seed;
  const uint32_t* seeds;
  int reps;
  const float* params;
  int param_stride;
  const float* pilots;
  int pilot_stride;
  int loops;
  long long n_tiles;
  int seg_bits;
  int grid;
  float* partials;
  float* sums;
};

template <int KIND>
void launch(const Launch& a, cudaStream_t s, const tmc::Tables& tb) {
  integrate_kernel<KIND><<<dim3(a.grid, a.reps), kThreads, 0, s>>>(
      a.seed, a.seeds, a.params, a.param_stride, a.pilots, a.pilot_stride,
      a.loops, a.n_tiles, a.seg_bits, a.partials, tb);
  tmc::rows_sum(a.partials, a.reps, a.grid, kOut, a.sums, s);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  `reps` jobs run in one launch, rep r with the
// seed word `seeds[r]` (a device array of `reps` words), or `seed` for
// every rep where `seeds` is null; its (p1, p2) at `params + r *
// param_stride` (stride 0: one pair for all, 2: a row each); with error
// bars its TMC_K pilots at `pilots + r * pilot_stride` (0 or TMC_K), else
// `pilots` is null; its partials the r-th of `reps` blocks of grid x
// TMC_K floats, or grid x 2 TMC_K (sums, then squares) with error bars,
// or grid x 3 TMC_K (sums, then the (k, parameter) pathwise sums) in a
// gradient build;
// their sums over the blocks, in rows_sum.cuh's order, the r-th of `reps`
// rows of kOut floats at `sums`.  `seg_bits` is the qmc segment bits, or -1 (a qmc run inside one
// 2^32-point segment, and every other mode); `tables` is a host
// tmc::Tables (copied into the launch), or null where the library reads
// no table.  A CUSTOM library launches only kind 3, an extended family's
// only its own kind (TMC_FAMILY), the others only kinds 0-2.
extern "C" int tmc_integrate(int kind, unsigned int seed,
                             const unsigned int* seeds, int reps,
                             const float* params, int param_stride,
                             const float* pilots, int pilot_stride, int loops,
                             long long n_tiles, int seg_bits, int grid,
                             float* partials, float* sums,
                             const void* tables, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tmc::Tables tb{};
  if (tables != nullptr) tb = *static_cast<const tmc::Tables*>(tables);
  if (kStderr != (pilots != nullptr) || seg_bits > 31 ||
      (kMethod != kQmc && seg_bits >= 0) || !tables_ok(tb) ||
      (kind == tmc::kCustom) != (kCustomRoute != kNoCustom) ||
      (kFamily != 0 && kind != kFamily) || reps < 1 || reps > 65535 ||
      (param_stride != 0 && param_stride != 2) ||
      (pilot_stride != 0 && pilot_stride != TMC_K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch a{seed, seeds, reps, params, param_stride, pilots,
                 pilot_stride, loops, n_tiles, seg_bits, grid,
                 partials, sums};
#if TMC_CUSTOM
  launch<tmc::kCustom>(a, s, tb);
#elif TMC_FAMILY
  launch<kFamily>(a, s, tb);
#else
  switch (kind) {
    case kUniform:
      launch<kUniform>(a, s, tb);
      break;
    case kNormal:
      launch<kNormal>(a, s, tb);
      break;
    case kExponential:
      launch<kExponential>(a, s, tb);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
