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
// What bounds it on the card: arithmetic only.  Each sample costs two PCG
// hashes, the transform (erfinvf for the normal family) and the K
// integrands (libdevice sinf, expf, ...); nothing is read from device
// memory and each CUDA block writes one row of K partial sums.  So the
// limit is the SMs' FP32/INT32 and SFU throughput and how many warps keep
// them busy.
//
// What the design does about it:
// * The TPU grid has at most 512 blocks per program, so 1e9 samples are
//   only ~64 programs, too few for 132 SMs.  Here the unit of work is one
//   (program, block) tile of 256 x 128 samples; the counter stream lets
//   any CUDA block take any tile, so a grid-stride loop spreads the
//   programs x blocks tiles over up to `grid` CUDA blocks of 256 threads.
// * Accumulators stay in registers for the whole run; the block reduces
//   them once, with warp shuffles and a fixed order, and writes its row.
//   No atomics: the result is deterministic for a given plan.  A second
//   pass (torch.sum over the rows, as the JAX package sums its program
//   rows at integrate_pallas.py:1214) finishes the reduction.
// * Built without --use_fast_math, so sinf, expf, logf and erfinvf keep
//   full float32 accuracy, and with --fmad=false, so each float32 add and
//   multiply rounds as in the plain PyTorch version and the JAX package.
#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "integrand_math.cuh"
#include "tmc_integrands.inc"  // TMC_K, f_0 .. f_{K-1}, tmc_accumulate

namespace {

using tmc::kExponential;
using tmc::kNormal;
using tmc::kUniform;

constexpr int kLanes = tmc::kLanes;
constexpr int kBlockRows = 256;
constexpr int kThreads = 256;

// Draws `n_pos` positions of one (state, blk, tag) stream, transforms
// them and accumulates the integrands.  Thread t takes positions
// t, t + 256, ...; the positions a thread takes do not change the sums'
// values beyond float32 summation order.
template <int KIND>
__device__ __forceinline__ void sweep(uint32_t state, uint32_t blk,
                                      uint32_t tag, int n_pos, float p1,
                                      float p2, float* acc) {
  const uint32_t base = tmc::block_base(state, blk, tag);
  for (int pos = threadIdx.x; pos < n_pos; pos += kThreads) {
    const float x = tmc::transform(KIND, tmc::mantissa(base, uint32_t(pos)),
                                   p1, p2);
    tmc_accumulate(x, acc);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
integrate_kernel(uint32_t seed, const float* __restrict__ params, int loops,
                 long long n_tiles, float* __restrict__ partials) {
  const float p1 = params[0];
  const float p2 = params[1];
  float acc[TMC_K];
#pragma unroll
  for (int j = 0; j < TMC_K; ++j) acc[j] = 0.0f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const uint32_t pid = uint32_t(tile / loops);
    const uint32_t blk = uint32_t(tile % loops);
    const uint32_t state = tmc::seed_state(seed, pid);
    if (KIND == kNormal) {
      // Two half blocks, tags 0 and 1 (integrate_pallas.py:571-581).
      sweep<KIND>(state, blk, 0u, (kBlockRows / 2) * kLanes, p1, p2, acc);
      sweep<KIND>(state, blk, 1u, (kBlockRows / 2) * kLanes, p1, p2, acc);
    } else {
      sweep<KIND>(state, blk, 0u, kBlockRows * kLanes, p1, p2, acc);
    }
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
