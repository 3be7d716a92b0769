// Helpers for the integrand device functions that ops/lower.py generates.
//
// The generated source calls C math functions (sinf, expf, ...) and the
// helpers below, and nothing else, so it compiles both as CUDA (included
// by integrate.cu) and as host C++ with -D__device__= (the CPU tests
// compile it with g++ and hold it against the torch lowering).
#pragma once

#ifdef __CUDACC__
#define TMC_INF __int_as_float(0x7f800000)
#define TMC_NAN __int_as_float(0x7fffffff)
#else
#include <math.h>
#define TMC_INF INFINITY
#define TMC_NAN NAN
#endif

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.
static __device__ inline float tmc_minimum(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

static __device__ inline float tmc_maximum(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// a * b + c rounded once.  Kernels are built with --fmad=false, so this is
// the only contraction: the integrate kernels' sums (acc += a * b,
// sq += dd * dd) and their transforms' affine steps.  The MCMC kernels
// call neither.  TMC_CONTRACT=0 rounds after the multiply and after the
// add, for the host tests (tests/test_torch_integrate_stream.py) and
// tools/integrate_sweep.py; the package always builds with 1.
#ifndef TMC_CONTRACT
#define TMC_CONTRACT 1
#endif

static __device__ inline float tmc_fma(float a, float b, float c) {
#if TMC_CONTRACT
  return fmaf(a, b, c);
#else
  return a * b + c;
#endif
}
