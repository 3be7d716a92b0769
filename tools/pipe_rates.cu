// Throughput probe of the SM's arithmetic pipes, for chip_smoke.py's bounds.
//
// Not a kernel of the port: tools/pipe_probe.py times every mix to learn
// which SASS instructions share a pipe, and chip_smoke.py's phase 23 times
// one against the bounds' model.  Each thread runs 16 independent chains
// of one mix of PTX operations (mad.lo.u32 -> IMAD, mul.lo.u32 -> IMUL,
// add.u32 -> IADD3, lop3.b32 -> LOP3, fma.rn.f32 -> FFMA, max.f32 ->
// FMNMX) for `iters` rounds; what ptxas made of them is counted from the
// library's SASS, so the rate is the counted instructions per SM per
// clock.  Two instructions on one pipe halve each other's rate in a mix;
// on two pipes they do not.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;

enum Op { kImad = 1, kImul = 2, kIadd = 4, kLop = 8, kFfma = 16, kFmnmx = 32 };

template <int OPS>
__global__ void __launch_bounds__(kThreads)
pipe_kernel(int iters, uint32_t a, uint32_t b, float fa, float fb,
            uint32_t* __restrict__ out) {
  uint32_t r[kChains], s[kChains];
  float f[kChains], g[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    // Every chain starts from the thread's index, so that ptxas keeps it
    // in the vector pipes and not in the warp-uniform datapath.
    r[c] = threadIdx.x + c;
    s[c] = threadIdx.x * 7u + c;
    f[c] = float(threadIdx.x) + c;
    g[c] = float(threadIdx.x) - c;
  }
  // One SASS iteration per round, so its instructions are counted once.
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (OPS & kImad) {
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(r[c]) : "r"(a), "r"(b));
      }
      if (OPS & kImul) {
        asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(s[c]) : "r"(a));
      }
      if (OPS & kIadd) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(s[c]) : "r"(b));
      }
      if (OPS & kLop) {
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x6a;"
                     : "+r"(r[c]) : "r"(a), "r"(b));
      }
      if (OPS & kFfma) {
        asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(f[c]) : "f"(fa), "f"(fb));
      }
      if (OPS & kFmnmx) {
        asm volatile("max.f32 %0, %0, %1;" : "+f"(g[c]) : "f"(fa));
      }
    }
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    acc += r[c] ^ s[c] ^ __float_as_uint(f[c]) ^ __float_as_uint(g[c]);
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

template <int OPS>
int launch(int blocks, int iters, uint32_t* out, cudaStream_t s) {
  pipe_kernel<OPS><<<blocks, kThreads, 0, s>>>(iters, 0x9E3779B9u, 12345u,
                                               1.0000001f, 1e-7f, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mixes, by number: each a set of Op bits.
extern "C" int tmc_pipe_mix(int mix) {
  constexpr int kMixes[] = {kImad, kImul, kIadd, kLop, kFfma, kFmnmx,
                            kImad | kIadd, kImad | kLop, kImul | kLop,
                            kImad | kFfma, kLop | kFfma, kFmnmx | kLop,
                            kFmnmx | kFfma};
  constexpr int kCount = sizeof(kMixes) / sizeof(kMixes[0]);
  return mix >= 0 && mix < kCount ? kMixes[mix] : -1;
}

// Launches mix `mix` (tmc_pipe_mix) on `blocks` blocks of 256 threads;
// `out` holds blocks x 256 words.  Returns cudaGetLastError().
extern "C" int tmc_pipe_rates(int mix, int blocks, int iters, uint32_t* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tmc_pipe_mix(mix)) {
    case kImad: return launch<kImad>(blocks, iters, out, s);
    case kImul: return launch<kImul>(blocks, iters, out, s);
    case kIadd: return launch<kIadd>(blocks, iters, out, s);
    case kLop: return launch<kLop>(blocks, iters, out, s);
    case kFfma: return launch<kFfma>(blocks, iters, out, s);
    case kFmnmx: return launch<kFmnmx>(blocks, iters, out, s);
    case kImad | kIadd: return launch<kImad | kIadd>(blocks, iters, out, s);
    case kImad | kLop: return launch<kImad | kLop>(blocks, iters, out, s);
    case kImul | kLop: return launch<kImul | kLop>(blocks, iters, out, s);
    case kImad | kFfma: return launch<kImad | kFfma>(blocks, iters, out, s);
    case kLop | kFfma: return launch<kLop | kFfma>(blocks, iters, out, s);
    case kFmnmx | kLop: return launch<kFmnmx | kLop>(blocks, iters, out, s);
    case kFmnmx | kFfma: return launch<kFmnmx | kFfma>(blocks, iters, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
