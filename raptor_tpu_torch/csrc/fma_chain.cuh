// The per-element function of the FP32 FMA peak probe, shared by the CUDA
// kernel (fma_peak.cu) and the host shim (host_shim.cpp) that the CPU tests
// build with g++: `depth` iterations of NFMA dependent fused multiply-adds
// y = fmaf(y, a, b) on each of CHAINS independent values. One rounding a step
// (fmaf), on both sides. The chains are interleaved inside the unrolled body so
// that consecutive instructions do not depend on each other.
#pragma once

#include <cmath>

#ifdef __CUDACC__
#define RAPTOR_FMA_HD __host__ __device__ __forceinline__
#else
#define RAPTOR_FMA_HD inline
#endif

namespace raptor {

template <int NFMA, int CHAINS>
RAPTOR_FMA_HD void fma_chains(float (&y)[CHAINS], int depth, float a, float b) {
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int j = 0; j < NFMA; ++j) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) y[c] = fmaf(y[c], a, b);
    }
  }
}

// The FMAs per loop iteration the probe is built for (the body is unrolled at
// compile time); any other count is refused. CALL(NFMA) is expanded for the
// matching case.
#define RAPTOR_FMA_DISPATCH(nfma, CALL) \
  switch (nfma) {                       \
    case 1: CALL(1); break;             \
    case 2: CALL(2); break;             \
    case 4: CALL(4); break;             \
    case 8: CALL(8); break;             \
    case 16: CALL(16); break;           \
    case 32: CALL(32); break;           \
    case 64: CALL(64); break;           \
    default: return 1; /* cudaErrorInvalidValue */ \
  }

}  // namespace raptor
