// Sobol points of method="qmc", shared by the port's kernels
// (integrate_nd.cu).
//
// Port of tpu_montecarlo/ops/qmc.py: the Sobol word of index g in one
// dimension is the XOR of the dimension's direction numbers v[k] over the
// set bits k of g (sobol_bits); the JAX kernels split g = b * 2^15 + pos
// into a block and a position, whose words XOR together (GF(2)
// linearity), so either form gives the same bits.  A dimension is rotated
// by derive_shift(seed, tag) (uint32 add before the 24-bit mantissa), and
// a run past 2^32 points splits into segments, each rotated by
// derive_segment_shift.  ops/qmc.py in the port computes the same words
// with torch.
#pragma once

#include <cstdint>

#include "counter_rng.cuh"

namespace tmc {

// The seed-derived rotation of the QMC dimension with tag `tag`.
__device__ __forceinline__ uint32_t derive_shift(uint32_t seed, uint32_t tag) {
  return pcg(seed ^ 0x9E3779B9u ^ (tag * 0x85EBCA6Bu));
}

// The rotation of segment `seg` of a run past one 2^32-point cycle:
// segment 0 keeps `base`, later ones re-mix it with the segment index.
__device__ __forceinline__ uint32_t derive_segment_shift(uint32_t base,
                                                         uint32_t seg) {
  return seg == 0u ? base : pcg(base ^ (seg * 0x9E3779B9u));
}

// XOR of v[first + i] over the set bits i < COUNT of idx (branch-free, so
// threads with different idx do not diverge).
template <int COUNT>
__device__ __forceinline__ uint32_t sobol_xor(const uint32_t* v, uint32_t idx,
                                              int first) {
  uint32_t x = 0u;
#pragma unroll
  for (int i = 0; i < COUNT; ++i) {
    x ^= v[first + i] & (0u - ((idx >> i) & 1u));
  }
  return x;
}

// The top 24 bits of a Sobol word under its rotation, in place (the
// 24-bit mantissa << 8), as integrate_draw.cuh's transforms take them.
__device__ __forceinline__ uint32_t sobol_top24(uint32_t word,
                                                uint32_t shift) {
  return (word + shift) & 0xFFFFFF00u;
}

}  // namespace tmc
