// Fused 1-D Monte Carlo integrate kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside build_integrate_fn_pallas
// (tpu_montecarlo/ops/integrate_pallas.py:969-1147, pallas_call at :1180)
// in its plain-MC mode for the uniform, normal and exponential families.
// It draws the very samples that kernel draws under the interpreter's
// CounterRng (integrate_pallas.py:107-133): per (seed, program) a PCG
// state, per (program, block counter, tag) a PCG base, per position
// pos = row * 128 + lane the bits pcg(base + pos * 2654435761), uniforms
// from bits >> 8, then the family transform.  It evaluates the K
// integrands that ops/lower.py generated (tmc_integrands.inc) on every
// sample and keeps K float32 sums in registers.
//
// What bounds it on the card: issue.  Nothing is read from device memory
// in the sample loop and each CUDA block writes one row of K partial sums,
// so the time is the instructions each sample costs (the hash, the
// conversion, the transform with erfinvf for the normal family, the K
// integrands with libdevice sinf, expf, ...) over the four schedulers of
// each SM: at the bench set (K = 8, N(0, 1)) issuing them takes most of
// the kernel's time on an H100.  chip_smoke.py counts them from this
// kernel's SASS (PERF.md section 6).
//
// What the design does about it:
// * The TPU grid has at most 512 blocks per program, so 1e9 samples are
//   only ~64 programs, too few for 132 SMs.  Here the unit of work is one
//   (program, block) tile of 256 x 128 samples; the counter stream lets
//   any CUDA block take any tile, so a grid-stride loop spreads the
//   programs x blocks tiles over up to `grid` CUDA blocks of 256 threads.
//   A block steps its (program, block) pair without 64-bit division and
//   seeds a program's stream only when the program changes
//   (tmc::TileWalk).
// * Thread t takes positions t, t + 256, ... of a block: their hashes
//   start from one cursor word stepped by a constant (tmc::cursor), so a
//   sample costs the hash's finish, not its two affine steps and the
//   position.  Trip counts are compile-time (64 or 128 per thread), the
//   normal family's two half blocks (tags 0 and 1) share one loop, and a
//   loop body holds kUnroll samples (tmc::default_unroll: 8 for a few
//   integrands, fewer for more, whose bodies would outgrow the instruction
//   cache).  Sets of 17 integrands or more keep a loop that counts
//   positions at run time (sweep_wide); both loops draw through one
//   transform, so a sample does not depend on the loop that drew it.
// * The transforms are integrate_draw.cuh's: the same uniforms, affine
//   steps as one fused multiply-add, the exponential's division as a
//   multiply by -1 / p1 made once per thread.
// * Accumulators stay in registers for the whole run; the block reduces
//   them once, with warp shuffles and a fixed order, and writes its row.
//   No atomics: the result is deterministic for a given plan.  A second
//   pass (torch.sum over the rows, as the JAX package sums its program
//   rows at integrate_pallas.py:1214) finishes the reduction.
// * Built without --use_fast_math, so sinf, expf, logf and erfinvf keep
//   full float32 accuracy, and with --fmad=false, so the only fused
//   multiply-adds are those written out (tmc_fma).
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "integrate_draw.cuh"
#include "tmc_integrands.inc"  // TMC_K, f_0 .. f_{K-1}, tmc_accumulate

// tools/integrate_sweep.py may set TMC_UNROLL (samples per loop body) and
// TMC_WIDE_K (the first integrand count that takes sweep_wide) to time
// other values; the package builds with neither.
#ifndef TMC_WIDE_K
#define TMC_WIDE_K 17
#endif

namespace {

using tmc::kExponential;
using tmc::kNormal;
using tmc::kUniform;

constexpr int kLanes = tmc::kLanes;
constexpr int kBlockRows = 256;
constexpr int kThreads = 256;
#ifdef TMC_UNROLL
constexpr int kUnroll = TMC_UNROLL;
#else
constexpr int kUnroll = tmc::default_unroll(TMC_K, 1);  // samples per body
#endif
// Integrand sets from this size on take sweep_wide.
constexpr int kWideK = TMC_WIDE_K;
// The cursor's step between a thread's positions t, t + 256, ...
constexpr uint32_t kStep = uint32_t(kThreads) * tmc::kCursorStride;

// Draws positions t, t + 256, ... of the TAGS parts (tags 0 .. TAGS - 1)
// of one tile in one loop, transforms and accumulates the integrands,
// kUnroll samples per loop body (at least one per part).  The positions a
// thread takes do not change the sums' values beyond float32 summation
// order.
template <int KIND, int TAGS>
__device__ __forceinline__ void sweep(uint32_t state, uint32_t blk,
                                      const tmc::Family& f, float* acc) {
  constexpr int kPerThread = kBlockRows * kLanes / TAGS / kThreads;
  uint32_t x0[TAGS];
#pragma unroll
  for (int t = 0; t < TAGS; ++t) {
    x0[t] = tmc::cursor(tmc::block_base(state, blk, uint32_t(t)),
                        threadIdx.x);
  }
#pragma unroll (kUnroll > TAGS ? kUnroll / TAGS : 1)
  for (int i = 0; i < kPerThread; ++i) {
#pragma unroll
    for (int t = 0; t < TAGS; ++t) {
      const uint32_t top = tmc::cursor_top24(x0[t] + uint32_t(i) * kStep);
      tmc_accumulate(tmc::transform_top(KIND, top, f), acc);
    }
  }
}

// One tile: the normal family's two half blocks, tags 0 and 1
// (integrate_pallas.py:571-581), in one loop; the others' one block, tag 0.
template <int KIND>
__device__ __forceinline__ void draw_tile(uint32_t state, uint32_t blk,
                                          const tmc::Family& f, float* acc) {
  if (KIND == kNormal) {
    sweep<KIND, 2>(state, blk, f, acc);
  } else {
    sweep<KIND, 1>(state, blk, f, acc);
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
                                           const tmc::Family& f, float* acc) {
  const uint32_t base = tmc::block_base(state, blk, tag);
  for (int pos = threadIdx.x; pos < n_pos; pos += kThreads) {
    const uint32_t top = tmc::mantissa(base, uint32_t(pos)) << 8;
    tmc_accumulate(tmc::transform_top(KIND, top, f), acc);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
integrate_kernel(uint32_t seed, const float* __restrict__ params, int loops,
                 long long n_tiles, float* __restrict__ partials) {
  const tmc::Family f = tmc::family(params[0], params[1]);
  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;

  tmc::TileWalk walk(seed, uint32_t(loops), blockIdx.x, gridDim.x);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const uint32_t state = walk.stream();
    if (TMC_K < kWideK) {
      draw_tile<KIND>(state, walk.blk, f, acc);
    } else if (KIND == kNormal) {
      sweep_wide<KIND>(state, walk.blk, 0u, kBlockRows * kLanes / 2, f, acc);
      sweep_wide<KIND>(state, walk.blk, 1u, kBlockRows * kLanes / 2, f, acc);
    } else {
      sweep_wide<KIND>(state, walk.blk, 0u, kBlockRows * kLanes, f, acc);
    }
    walk.next();
  }

  // Block reduction in a fixed order: warp shuffles, then warp 0's
  // threads sum the per-warp values of one integrand each.
  __shared__ float warp_sums[kThreads / 32][TMC_K];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) warp_sums[warp][j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < TMC_K; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][j];
    partials[blockIdx.x * TMC_K + j] = s;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  `partials` holds grid x TMC_K floats.
extern "C" int tmc_integrate(int kind, unsigned int seed, const float* params,
                             int loops, long long n_tiles, int grid,
                             float* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kUniform:
      integrate_kernel<kUniform><<<grid, kThreads, 0, s>>>(
          seed, params, loops, n_tiles, partials);
      break;
    case kNormal:
      integrate_kernel<kNormal><<<grid, kThreads, 0, s>>>(
          seed, params, loops, n_tiles, partials);
      break;
    case kExponential:
      integrate_kernel<kExponential><<<grid, kThreads, 0, s>>>(
          seed, params, loops, n_tiles, partials);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
