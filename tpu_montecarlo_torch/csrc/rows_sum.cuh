// The integrate kernels' second pass (integrate.cu, integrate_nd.cu): the
// sums of each rep's partials over the blocks of its launch.
//
// The order is the same for every launch, whatever its number of reps, so
// a rep of a batch gives its unbatched launch's sums bit for bit: block
// (column, rep) has thread t add rows t, t + 256, ... of its column in
// turn, then adds its 256 sums in a pairwise tree (tests/test_torch_cuda.py's
// _rows_sum is this order in torch).
#pragma once

#include <cuda_runtime.h>

namespace tmc {

constexpr int kRowsSumThreads = 256;

__global__ void __launch_bounds__(kRowsSumThreads)
rows_sum_kernel(const float* __restrict__ partials, int rows, int cols,
                float* __restrict__ sums) {
  __shared__ float part[kRowsSumThreads];
  const float* p =
      partials + static_cast<long long>(blockIdx.y) * rows * cols + blockIdx.x;
  float s = 0.0f;
  for (int i = threadIdx.x; i < rows; i += kRowsSumThreads) {
    s += p[static_cast<long long>(i) * cols];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kRowsSumThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[static_cast<long long>(blockIdx.y) * cols + blockIdx.x] = part[0];
  }
}

// Enqueues the pass over `reps` blocks of rows x cols floats on `s`.
inline void rows_sum(const float* partials, int reps, int rows, int cols,
                     float* sums, cudaStream_t s) {
  rows_sum_kernel<<<dim3(cols, reps), kRowsSumThreads, 0, s>>>(
      partials, rows, cols, sums);
}

}  // namespace tmc
