// Multi-dimensional fused Monte Carlo integrate kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_integrate_nd_pallas
// (tpu_montecarlo/ops/integrate_nd_pallas.py:373-675, pallas_call at :708)
// in its mc, antithetic and qmc modes, with and without error bars, for d
// dimensions of the uniform, normal and exponential families, the seven
// extended families and CUSTOM tables, and with its importance weights
// (is_weight_nd).  Under the JAX package's CounterRng it draws the very
// samples that kernel draws in interpret mode at 256-row blocks:
//
// * a tile is one (program pid, loop block blk) of 256 x 128 positions,
//   pos = row * 128 + lane; mc and antithetic seed the stream with
//   (seed, pid) and draw dimension j as one full block with counter blk
//   and tag j (tmc::block_base), uniforms from the top 24 bits;
// * antithetic maps each uniform at u and at its mirror 1 - u (the normal
//   pair reflects z about the mean) and evaluates both points;
// * qmc takes position pos of tile t as Sobol point t * 2^15 + pos of each
//   dimension, rotated by derive_shift(seed, j + 1); from 2^32 points on,
//   seg = t >> 17 re-mixes the rotation (derive_segment_shift) and
//   t & (2^17 - 1) is the block (sobol.cuh);
// * a CUSTOM dimension (kind 3) draws from its [0, 1) uniform w on its
//   route (TMC_ROUTES): the first CUSTOM dimension under mc and antithetic
//   through the row-stratified tables, stratum pos >> 10 of the tile's 32
//   (its mirror 1 - w in the same stratum); the others, and every one
//   under qmc, through the flat full inverse x = t[i0] + frac * dt[i0] at
//   pos = w * (m - 1); a gap-respecting table through the gapped strata
//   or the flat gapped slopes, a heavy-tailed one through the knot-exact
//   inverse (the JAX package sends those two to its XLA sweep);
// * an importance set (TMC_WEIGHTED) weighs every integrand by the product
//   prod_j where(q_j > 0, p_j / q_j, 0) in dimension order, each density
//   traced, a uniform- or irregular-grid table, or q the CUSTOM sampler's
//   own density (the strata tables' qs, or (1 / (m - 1)) / dt[i0]);
// * the K d-ary integrands that ops/lower.py generated (tmc_integrands.inc,
//   with TMC_D and the families TMC_KINDS) run on every point; K float32
//   sums stay in registers, plus with error bars K sums of (f - pilot)^2,
//   of the pair's mean under antithetic.
//
// What bounds it on the card: issue.  Per sample and dimension one PCG
// hash (or, under qmc, two XORs and a shared-memory read), the uint->float
// conversion, the transform (erfinvf for the normal family, logf for the
// exponential) and then the integrands; nothing is read from device memory
// in the loop and each CUDA block writes one row of K (2K) partial sums.
// chip_smoke.py counts each arithmetic pipe's instructions per sample on
// the cheapest path through this kernel's SASS sample loop (its bound is
// the busiest pipe's time) and the time to issue them all: at c9's shape
// (N(0,1) x U(0,1) x Exp(2), K = 2, mc) issue takes most of the kernel's
// time on an H100, so the instructions per sample set it (PERF.md
// section 6).
//
// What the design does about it:
// * The unit of work is one tile, which any CUDA block can draw (the
//   counter stream and the Sobol index are functions of the tile), so a
//   grid-stride loop spreads programs x loops tiles over up to `grid`
//   blocks of 256 threads: 1e9 samples are ~30,000 tiles for 132 SMs.
//   A block steps its (program, block) pair without 64-bit division and
//   seeds a program's stream only when the program changes
//   (tmc::TileWalk).
// * The families are compiled in (TMC_KINDS): each dimension's transform
//   is straight-line code, with no branch on the family in the loop.  The
//   JAX kernel is likewise traced per family tuple.
// * Under mc and antithetic, thread t's positions t + 256 i of dimension j
//   hash from one cursor word per tile stepped by a constant
//   (tmc::cursor), so a sample costs the hash's finish only; the
//   transforms are integrate_draw.cuh's (affine steps fused, the
//   exponential's division a multiply by -1 / p1 made once per thread).
// * The Sobol index of thread t's i-th position, pos = t + 256 i, splits
//   into tile, thread and i parts whose words XOR together: the tile word
//   is computed once per tile, the thread word once per thread, and the
//   words of i (128 x d) are staged in shared memory with the direction
//   numbers.  A sample then costs an XOR, a shared read and the add of the
//   rotation per dimension.
// * Sums are reduced once per block with warp shuffles in a fixed order,
//   and torch.sum over the rows finishes: no atomics, so a result is the
//   same on every run.
// * Tables are read at run time from an NdTables passed by value (one
//   tmc::NdDim per dimension), through the read-only cache from global
//   memory, as integrate.cu reads its tables: a (32, 128) strata table is
//   16 KB and stays in L1.  The routes and weight modes are compiled in
//   per library; a library with neither takes no table argument and
//   compiles no table code, so the closed-form libraries are unchanged.
// * The gradient build (TMC_GRAD, a library of its own: nd expectation_fn's
//   autograd estimator; the JAX package differentiates its XLA nd sweep)
//   draws the value build's points, adds each f_k(x) to the value build's
//   sums in its order, and beside them K x d x 2 pathwise sums
//   df_k/dx_j * dx_j/dp of each dimension's two parameters
//   (integrate_draw.cuh transform_top_grad): K + 2Kd floats a row, values
//   first, then (k, j, parameter) triples.  Analytic dimensions only, no
//   error bars or weights.
// * Built without --use_fast_math and with --fmad=false, as integrate.cu:
//   the only fused multiply-adds are those written out (tmc_fma).
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "integrate_draw.cuh"
#include "rows_sum.cuh"
#include "sobol.cuh"
#include "tmc_integrands.inc"  // TMC_K, TMC_D, TMC_KINDS, f_j, tmc_*_nd

// A library over CUSTOM dimensions compiles in each dimension's route
// (TMC_ROUTES, tmc::NdRoute: 0 for a closed-form family); an importance
// set (TMC_WEIGHTED, from the integrand source) each dimension's p and q
// modes (TMC_P_MODES, TMC_Q_MODES: 0 traced, 1 uniform-grid table, 2 the
// sampler's own density, 3 irregular-grid table).  Either takes the
// launch's tables (NdTables); a library with neither is built as before,
// with no table code and no table argument.
#ifndef TMC_WEIGHTED
#define TMC_WEIGHTED 0
#endif
#if defined(TMC_ROUTES) || TMC_WEIGHTED
#define TMC_ND_TABLES 1
#else
#define TMC_ND_TABLES 0
#endif
#ifndef TMC_GRAD
#define TMC_GRAD 0
#endif
static_assert(!TMC_GRAD || !TMC_ND_TABLES,
              "a gradient build draws analytic dimensions, unweighted");

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRows = 256;
constexpr int kTilePositions = kBlockRows * tmc::kLanes;  // 2^15
constexpr int kPerThread = kTilePositions / kThreads;     // 128
constexpr int kPosBits = 15;     // a position within a tile
constexpr int kThreadBits = 8;   // threadIdx.x, the low bits of pos
constexpr int kSobolBits = 32;
// Positions per loop body; tools/integrate_sweep.py may set TMC_UNROLL to
// time other values, the package builds without it.
constexpr bool kGrad = TMC_GRAD != 0;
// A gradient build's pathwise sums: K x d x 2.
constexpr int kGradSums = kGrad ? 2 * TMC_K * TMC_D : 1;
#ifdef TMC_UNROLL
constexpr int kUnroll = TMC_UNROLL;
#else
constexpr int kUnroll =
    tmc::default_unroll(kGrad ? TMC_K * (2 * TMC_D + 1) : TMC_K, TMC_D);
#endif
// The cursor's step between a thread's positions t, t + 256, ...
constexpr uint32_t kStep = uint32_t(kThreads) * tmc::kCursorStride;

enum Method { kMc = 0, kAntithetic = 1, kQmc = 2 };

// The family of dimension j.  Called with j unrolled, so it folds to a
// constant and each transform's family branch is resolved at compile time.
__device__ __forceinline__ int kind_of(int j) {
  const int kinds[TMC_D] = {TMC_KINDS};
  return kinds[j];
}

#if TMC_ND_TABLES
// Every table a launch reads, per dimension (ops/integrate_nd_kernel.py
// _NdTables): passed by value.
struct NdTables {
  tmc::NdDim dim[TMC_D];
};
#define TMC_TABLES_PARAM , const NdTables tb
#define TMC_TABLES_ARG , tb
#else
#define TMC_TABLES_PARAM
#define TMC_TABLES_ARG
#endif

// Dimension j's CUSTOM route and weight modes, folded at compile time as
// kind_of is (and read by the host's table check).
__host__ __device__ __forceinline__ int route_of(int j) {
#ifdef TMC_ROUTES
  const int routes[TMC_D] = {TMC_ROUTES};
  return routes[j];
#else
  return tmc::kNdAnalytic;
#endif
}

#if TMC_WEIGHTED
__host__ __device__ __forceinline__ int p_mode_of(int j) {
  const int modes[TMC_D] = {TMC_P_MODES};
  return modes[j];
}

__host__ __device__ __forceinline__ int q_mode_of(int j) {
  const int modes[TMC_D] = {TMC_Q_MODES};
  return modes[j];
}

constexpr int kSamplerMode = 2;

// A density of dimension j at x in its mode: traced (tmc_pdf_p_nd,
// tmc_pdf_q_nd from the integrand source), a uniform-grid table or an
// irregular-grid one.
template <bool P>
__device__ __forceinline__ float density(int j, int mode, float x,
                                         const tmc::WeightTab& t) {
  if (mode == 0) return P ? tmc_pdf_p_nd(j, x) : tmc_pdf_q_nd(j, x);
  if (mode == 1) return tmc::uniform_table_value(x, t);
  return tmc::knot_table_value(x, t);
}

// The product weight prod_j where(q_j > 0, p_j / q_j, 0) at the point x,
// in dimension order (the JAX nd kernel's `weight`); q_samp holds the
// sampler's density of sampler-mode dimensions.
__device__ __forceinline__ float nd_weight(const float* x,
                                           const float* q_samp,
                                           const NdTables& tb) {
  float w = 1.0f;  // 1 * r is r: the first factor is taken as it is
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    const float p = density<true>(j, p_mode_of(j), x[j], tb.dim[j].p);
    const float q = q_mode_of(j) == kSamplerMode
                        ? q_samp[j]
                        : density<false>(j, q_mode_of(j), x[j], tb.dim[j].q);
    w = w * tmc::weight_ratio(p, q);
  }
  return w;
}
#endif

// Whether dimension j's q is its sampler's own density.
__device__ __forceinline__ bool wants_q(int j) {
#if TMC_WEIGHTED
  return q_mode_of(j) == kSamplerMode;
#else
  return false;
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Rep blockIdx.y of a batch is one job: its seed word (`seeds[rep]`, or
// `seed` without a seed vector), its (d, 2) parameter rows and its pilot
// row (shared where the strides are 0) and its gridDim.x x kOut
// partials.  The stream cursor and the Sobol block words see only
// blockIdx.x and gridDim.x, and the rotations only the rep's seed, so a
// rep draws what the unbatched launch with its seed draws.
template <int METHOD, bool STDERR>
__global__ void __launch_bounds__(kThreads)
integrate_nd_kernel(uint32_t seed, const uint32_t* __restrict__ seeds,
                    const float* __restrict__ params, int param_stride,
                    const uint32_t* __restrict__ dirs,
                    const float* __restrict__ pilots, int pilot_stride,
                    int loops, long long n_tiles, int seg_bits,
                    float* __restrict__ partials TMC_TABLES_PARAM) {
  constexpr bool kSobol = METHOD == kQmc;
  constexpr int kOut = STDERR ? 2 * TMC_K : TMC_K + (kGrad ? kGradSums : 0);
  const int rep = blockIdx.y;
  if (seeds != nullptr) seed = seeds[rep];
  params += rep * param_stride;
  if (STDERR) pilots += rep * pilot_stride;
  partials += static_cast<long long>(rep) * gridDim.x * kOut;
  __shared__ uint32_t s_dirs[kSobol ? TMC_D * kSobolBits : 1];
  // s_high[i * TMC_D + j]: the Sobol word of index bits 8..14 = i.
  __shared__ uint32_t s_high[kSobol ? kPerThread * TMC_D : 1];
  __shared__ float warp_sums[kThreads / 32][kOut];

  tmc::Family fam[TMC_D];
#pragma unroll
  for (int j = 0; j < TMC_D; ++j) {
    fam[j] = tmc::family(params[2 * j], params[2 * j + 1]);
  }
  float acc[TMC_K], sq[TMC_K], pilot[TMC_K], grad[kGradSums];
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) {
    acc[k] = 0.0f;
    sq[k] = 0.0f;
    pilot[k] = STDERR ? pilots[k] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kGradSums; ++k) grad[k] = 0.0f;

  uint32_t shift0[TMC_D], low[TMC_D];
  if (kSobol) {
    for (int e = threadIdx.x; e < TMC_D * kSobolBits; e += kThreads) {
      s_dirs[e] = dirs[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kPerThread * TMC_D; e += kThreads) {
      s_high[e] = tmc::sobol_xor<kPosBits - kThreadBits>(
          &s_dirs[(e % TMC_D) * kSobolBits], uint32_t(e / TMC_D), kThreadBits);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TMC_D; ++j) {
      shift0[j] = tmc::derive_shift(seed, uint32_t(j + 1));
      low[j] = tmc::sobol_xor<kThreadBits>(&s_dirs[j * kSobolBits],
                                           threadIdx.x, 0);
    }
  }

  tmc::TileWalk walk(seed, uint32_t(loops), blockIdx.x, gridDim.x);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // Per dimension, the tile's word: this thread's first cursor word, or
    // its Sobol block word XOR this thread's word; and the rotation under
    // Sobol.
    uint32_t word[TMC_D], shift[TMC_D];
    if (kSobol) {
      uint32_t b = uint32_t(tile);
      uint32_t seg = 0u;
      if (seg_bits >= 0) {
        seg = b >> seg_bits;
        b &= (1u << seg_bits) - 1u;
      }
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) {
        shift[j] = tmc::derive_segment_shift(shift0[j], seg);
        word[j] = tmc::sobol_xor<kSobolBits - kPosBits>(
                      &s_dirs[j * kSobolBits], b, kPosBits) ^ low[j];
      }
    } else {
      const uint32_t state = walk.stream();
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) {
        word[j] = tmc::cursor(tmc::block_base(state, walk.blk, uint32_t(j)),
                              threadIdx.x);
      }
      walk.next();
    }
#pragma unroll (kUnroll)
    for (int i = 0; i < kPerThread; ++i) {
      float x[TMC_D], y[TMC_D];
      float qx[TMC_D], qy[TMC_D];  // sampler densities (sampler-mode q)
#if TMC_GRAD
      float dx1[TMC_D], dx2[TMC_D], dy1[TMC_D], dy2[TMC_D];
#endif
#pragma unroll
      for (int j = 0; j < TMC_D; ++j) {
        // Position threadIdx.x + 256 i of dimension j, its top 24 bits.
        const uint32_t top =
            kSobol ? tmc::sobol_top24(word[j] ^ s_high[i * TMC_D + j],
                                      shift[j])
                   : tmc::cursor_top24(word[j] + uint32_t(i) * kStep);
#if TMC_GRAD
        // The draws with their derivatives, parameter c of dimension j in
        // dx[c][j] (dy: the mirrors').
        float da[2], db[2];
        if (METHOD == kAntithetic) {
          tmc::transform_pair_top_grad(kind_of(j), top, fam[j], x[j], y[j],
                                       da, db);
          dy1[j] = db[0];
          dy2[j] = db[1];
        } else {
          x[j] = tmc::transform_top_grad(kind_of(j), top, fam[j], da);
        }
        dx1[j] = da[0];
        dx2[j] = da[1];
        continue;
#endif
#if TMC_ND_TABLES
        if (kind_of(j) == tmc::kCustom) {
          // w and its mirror 1 - w through the route's tables (a
          // stratified dimension's mirror stays in its row's stratum).
          const uint32_t pos = threadIdx.x + uint32_t(i) * kThreads;
          const float w = tmc::halfopen_top(top);
          if (wants_q(j)) {
            x[j] = tmc::nd_custom_x<true>(route_of(j), w,
                                          float(top) * tmc::kW127, pos,
                                          tb.dim[j], &qx[j]);
          } else {
            x[j] = tmc::nd_custom_x<false>(route_of(j), w,
                                           float(top) * tmc::kW127, pos,
                                           tb.dim[j], nullptr);
          }
          if (METHOD == kAntithetic) {
            const float v = 1.0f - w;  // exact
            if (wants_q(j)) {
              y[j] = tmc::nd_custom_x<true>(route_of(j), v, v * 127.0f, pos,
                                            tb.dim[j], &qy[j]);
            } else {
              y[j] = tmc::nd_custom_x<false>(route_of(j), v, v * 127.0f,
                                             pos, tb.dim[j], nullptr);
            }
          }
          continue;
        }
#endif
        if (METHOD == kAntithetic) {
          tmc::transform_pair_top(kind_of(j), top, fam[j], x[j], y[j]);
        } else {
          x[j] = tmc::transform_top(kind_of(j), top, fam[j]);
        }
      }
#if TMC_GRAD
      tmc_accumulate_nd_grad(x, dx1, dx2, acc, grad);
      if (METHOD == kAntithetic) tmc_accumulate_nd_grad(y, dy1, dy2, acc, grad);
#elif TMC_WEIGHTED
      // The product weight multiplies each integrand's value before the
      // sums and the pilot-shifted squares.
      const float wx = nd_weight(x, qx, tb);
      const float wy = METHOD == kAntithetic ? nd_weight(y, qy, tb) : 0.0f;
      if (METHOD == kAntithetic && STDERR) {
        float v1[TMC_K], v2[TMC_K];
        tmc_values_nd_w(x, wx, v1);
        tmc_values_nd_w(y, wy, v2);
#pragma unroll
        for (int k = 0; k < TMC_K; ++k) {
          acc[k] += v1[k];
          acc[k] += v2[k];
          const float dd = tmc_fma(0.5f, v1[k] + v2[k], -pilot[k]);
          sq[k] = tmc_fma(dd, dd, sq[k]);
        }
      } else if (METHOD == kAntithetic) {
        tmc_accumulate_nd_w(x, wx, acc);
        tmc_accumulate_nd_w(y, wy, acc);
      } else if (STDERR) {
        tmc_accumulate_nd_sq_w(x, wx, pilot, acc, sq);
      } else {
        tmc_accumulate_nd_w(x, wx, acc);
      }
#else
      if (METHOD == kAntithetic && STDERR) {
        // Squares of the pair's mean: pairs are the unit.
        float v1[TMC_K], v2[TMC_K];
        tmc_values_nd(x, v1);
        tmc_values_nd(y, v2);
#pragma unroll
        for (int k = 0; k < TMC_K; ++k) {
          acc[k] += v1[k];
          acc[k] += v2[k];
          const float dd = tmc_fma(0.5f, v1[k] + v2[k], -pilot[k]);
          sq[k] = tmc_fma(dd, dd, sq[k]);
        }
      } else if (METHOD == kAntithetic) {
        tmc_accumulate_nd(x, acc);
        tmc_accumulate_nd(y, acc);
      } else if (STDERR) {
        tmc_accumulate_nd_sq(x, pilot, acc, sq);
      } else {
        tmc_accumulate_nd(x, acc);
      }
#endif
    }
  }

  // Block reduction in a fixed order: warp shuffles, then one thread per
  // output sums the per-warp values in warp order.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < TMC_K; ++k) {
    const float s = warp_sum(acc[k]);
    if (lane == 0) warp_sums[warp][k] = s;
    if (STDERR) {
      const float q = warp_sum(sq[k]);
      if (lane == 0) warp_sums[warp][TMC_K + k] = q;
    }
  }
  if (kGrad) {
#pragma unroll
    for (int k = 0; k < kGradSums; ++k) {
      const float g = warp_sum(grad[k]);
      if (lane == 0) warp_sums[warp][TMC_K + k] = g;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kOut; k += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][k];
    partials[blockIdx.x * kOut + k] = s;
  }
}

#if TMC_ND_TABLES
// Whether every table the library reads is there, so that no lookup reads
// through a null pointer or before a table's start (a flat table needs two
// knots, a weight table two).  Which route and modes go with which
// Distribution, ops/integrate_nd_kernel.py's nd_routes and _check_program
// decide.
bool tables_ok(const NdTables& tb) {
  for (int j = 0; j < TMC_D; ++j) {
    const tmc::NdDim& d = tb.dim[j];
    const int route = route_of(j);
    if (route != tmc::kNdAnalytic && (d.t == nullptr || d.dt == nullptr)) {
      return false;
    }
    if (route != tmc::kNdStrata && route != tmc::kNdAnalytic && d.m < 2) {
      return false;
    }
#if TMC_WEIGHTED
    if (q_mode_of(j) == kSamplerMode && route == tmc::kNdStrata &&
        d.qs == nullptr) {
      return false;
    }
    const tmc::WeightTab* tabs[2] = {&d.p, &d.q};
    const int modes[2] = {p_mode_of(j), q_mode_of(j)};
    for (int i = 0; i < 2; ++i) {
      const tmc::WeightTab& t = *tabs[i];
      const bool table = modes[i] == 1 || modes[i] == 3;
      if (table && (t.vals == nullptr || t.n < 2 ||
                    (modes[i] == 1 ? t.dx : t.keys) == nullptr)) {
        return false;
      }
    }
#endif
  }
  return true;
}
#endif

// One launch's arguments besides the method and the tables.
struct Launch {
  uint32_t seed;
  const uint32_t* seeds;
  int reps;
  const float* params;
  int param_stride;
  const uint32_t* dirs;
  const float* pilots;
  int pilot_stride;
  int loops;
  long long n_tiles;
  int seg_bits;
  int grid;
  float* partials;
  float* sums;
};

template <int METHOD, bool STDERR>
cudaError_t launch(const Launch& a, cudaStream_t s, const void* tables) {
#if TMC_ND_TABLES
  const NdTables tb = *static_cast<const NdTables*>(tables);
#else
  (void)tables;
#endif
  integrate_nd_kernel<METHOD, STDERR><<<dim3(a.grid, a.reps), kThreads, 0,
                                        s>>>(
      a.seed, a.seeds, a.params, a.param_stride, a.dirs, a.pilots,
      a.pilot_stride, a.loops, a.n_tiles, a.seg_bits, a.partials
      TMC_TABLES_ARG);
  tmc::rows_sum(a.partials, a.reps, a.grid,
                STDERR ? 2 * TMC_K : TMC_K + (kGrad ? kGradSums : 0), a.sums,
                s);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  `reps` jobs run in one launch, rep r with the
// seed word `seeds[r]` (a device array of `reps` words), or `seed` for
// every rep where `seeds` is null; its TMC_D x 2 parameter floats at
// `params + r * param_stride` (0, or 2 TMC_D: a block each); with error
// bars its TMC_K pilots at `pilots + r * pilot_stride` (0 or TMC_K), else
// `pilots` is null; its partials the r-th of `reps` blocks of grid x
// TMC_K floats, or grid x 2 TMC_K (sums, then squares) with error bars,
// or grid x (TMC_K + 2 TMC_K TMC_D) (sums, then the (k, j, parameter)
// pathwise sums) in a gradient build, which takes no error bars;
// their sums over the blocks, in rows_sum.cuh's order, the r-th of `reps`
// rows of as many floats at `sums`.  `dirs` holds TMC_D x 32 Sobol direction numbers (qmc only, else null);
// `seg_bits` is -1 for a qmc run inside one 2^32-point segment; `tables`
// a host NdTables (copied into the launch) where the library reads tables
// (TMC_ROUTES or TMC_WEIGHTED), else null.
extern "C" int tmc_integrate_nd(int method, int with_stderr, unsigned int seed,
                                const unsigned int* seeds, int reps,
                                const float* params, int param_stride,
                                const unsigned int* dirs, const float* pilots,
                                int pilot_stride, int loops,
                                long long n_tiles, int seg_bits, int grid,
                                float* partials, float* sums,
                                const void* tables, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((method == kQmc) != (dirs != nullptr) ||
      (with_stderr != 0) != (pilots != nullptr) || seg_bits > 31 ||
      (kGrad && with_stderr != 0) ||
      TMC_ND_TABLES != (tables != nullptr) || reps < 1 || reps > 65535 ||
      (param_stride != 0 && param_stride != 2 * TMC_D) ||
      (pilot_stride != 0 && pilot_stride != TMC_K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#if TMC_ND_TABLES
  if (!tables_ok(*static_cast<const NdTables*>(tables))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The stratified route only under mc and antithetic.
  for (int j = 0; j < TMC_D; ++j) {
    if (method == kQmc && route_of(j) == tmc::kNdStrata) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#endif
  const Launch a{seed, seeds, reps, params, param_stride, dirs, pilots,
                 pilot_stride, loops, n_tiles, seg_bits, grid,
                 partials, sums};
  if (method == kMc && !with_stderr) {
    return static_cast<int>(launch<kMc, false>(a, s, tables));
  }
  if (method == kAntithetic && !with_stderr) {
    return static_cast<int>(launch<kAntithetic, false>(a, s, tables));
  }
  if (method == kQmc && !with_stderr) {
    return static_cast<int>(launch<kQmc, false>(a, s, tables));
  }
#if !TMC_GRAD
  // Error bars: a gradient build compiles none.
  if (method == kMc) {
    return static_cast<int>(launch<kMc, true>(a, s, tables));
  }
  if (method == kAntithetic) {
    return static_cast<int>(launch<kAntithetic, true>(a, s, tables));
  }
  if (method == kQmc) {
    return static_cast<int>(launch<kQmc, true>(a, s, tables));
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
