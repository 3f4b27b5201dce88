// FP32 fused-multiply-add peak probe on Hopper (sm_90a).
//
// Replaces the TPU kernel inside raptor_tpu/apps/roofline.py:measure_vpu_peak
// (inner `kernel`): every element of an f32 array goes through `depth`
// iterations of `nfma` dependent y = fmaf(y, a, b) in registers, and the
// result is stored.
//
// What bounds it: FP32 FMA issue, by construction. Each element is read once
// and written once (8 bytes) for 2 * nfma * depth operations.
//
// Design: the TPU kernel held one (256, 128) tile, 32,768 chains, in its fast
// memory. Here the element count is the caller's; its default fills every SM
// with its full count of resident threads. A thread carries kChains
// independent chains (its own elements, strided by the grid so that a warp's
// loads and stores are contiguous), interleaved inside the unrolled body: a
// dependent FFMA has a latency of several cycles, and the independent chains
// of a thread plus the other warps of its scheduler keep an FFMA issuing every
// cycle. `a` and `b` are arguments, so the compiler cannot fold the chain; the
// store of every element keeps the loop alive. The ragged edge is masked.
#include <cuda_runtime.h>

#include "fma_chain.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int NFMA>
__global__ void __launch_bounds__(kThreads, 8)
    fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                    unsigned n, int depth, float a, float b) {
  // 32-bit indices (the wrapper refuses n >= 2^31 - 2^20): 64-bit ones for
  // eight chains would not fit beside the chains in 32 registers
  const unsigned stride = gridDim.x * kThreads;
  const unsigned i0 = blockIdx.x * kThreads + threadIdx.x;
  float y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const unsigned i = i0 + c * stride;
    y[c] = i < n ? x[i] : 0.0f;
  }
  raptor::fma_chains<NFMA, kChains>(y, depth, a, b);
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const unsigned i = i0 + c * stride;
    if (i < n) out[i] = y[c];
  }
}

}  // namespace

// x [n] in, out [n] out. geometry[3] receives (chains a thread, threads a
// block, blocks). Launches on `stream` and returns cudaGetLastError(), or 1
// (cudaErrorInvalidValue) for an `nfma` the probe is not built for or an n
// that 32-bit indices cannot cover.
extern "C" int raptor_fma_peak(const float* x, float* out, long n, int depth,
                               int nfma, float a, float b, int* geometry,
                               void* stream) {
  if (n < 0 || n >= (1L << 31) - (1L << 20)) return 1;
  const long per_block = static_cast<long>(kThreads) * kChains;
  const int blocks = static_cast<int>((n + per_block - 1) / per_block);
  geometry[0] = kChains;
  geometry[1] = kThreads;
  geometry[2] = blocks;
  if (n > 0) {
#define RAPTOR_LAUNCH(NFMA)                                           \
  fma_peak_kernel<NFMA><<<blocks, kThreads, 0,                        \
                          static_cast<cudaStream_t>(stream)>>>(       \
      x, out, static_cast<unsigned>(n), depth, a, b)
    RAPTOR_FMA_DISPATCH(nfma, RAPTOR_LAUNCH)
#undef RAPTOR_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
