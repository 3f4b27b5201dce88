// DAgger collect rollout of N airframes on Hopper (sm_90a): T closed-loop
// steps of the student policy (obs -> Dense -> GRU -> Dense -> clip -> RK4 ->
// termination) with in-kernel episode auto-reset from a counter-hash PRNG,
// streaming every pre-step observation and the done flag to device memory,
// for a student of hidden width 8, 16, 24, 32 or 48.
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_collect.py:_collect_kernel.
//
// What bounds it: FP32 operations, as for eval.cu (about 5.3k per env-step at
// H = 16, plus the GRU's 48 expf/tanhf on the special-function unit): 0.22 ms
// at N = 5,528, T = 500 at the H100 SXM's 67 TFLOP/s. The bytes are the output
// stream, 23 floats per env-step (254 MB at that shape, 0.08 ms at 3.35 TB/s),
// under the arithmetic. Measured there by chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W: 4.7 ms, so it is bound by the latency of one warp per
// scheduler, not by either rate.
//
// Design: one thread per env with state, hidden state, previous action and
// step count in registers for all T steps; weights staged into shared memory
// per block and read as a broadcast, so one build serves the student of every
// round of an instantiated width (48 wide: 61.8 KB, over the 48 KB static
// limit, so dynamic shared memory there). The output is channel-major, [T, 23, N]: at each step
// the 32 threads of a warp write 23 runs of 128 contiguous bytes, where an
// [T, N, 22] layout would stride neighbouring threads by 88 bytes; the
// wrapper hands out [T, N, 22] and [T, N] as views of it. The reset is a
// branch per thread: only a done env computes a fresh sample, and a
// non-finite state is replaced, not blended. The TPU kernel's (rows, 128)
// tiles, time-chunk grid, VMEM carry and lane padding have no counterpart: T
// is a loop inside the thread and the ragged edge is an i < n mask. Blocks
// are one warp, so that the distillation round's few thousand envs spread
// over all SMs.
#include <cuda_runtime.h>

#include "quad_step.cuh"

namespace {

constexpr int kThreads = 32;  // 173 blocks at N = 5,528, 30 at N = 944

template <int H>
constexpr bool kStatic = raptor::Layout<H>::TOTAL * 4 <= 48 * 1024;

template <int H>
__global__ void __launch_bounds__(kThreads)
    collect_kernel(const float* __restrict__ weights,
                   const float* __restrict__ params,
                   const float* __restrict__ state, float* __restrict__ out,
                   int n, int n_steps, float dt, float episode_length,
                   raptor::Bounds b, raptor::InitSpec init, uint32_t seed,
                   uint32_t env_offset) {
  // static shared memory where the weights fit its 48 KB (the code of the
  // one-width build at H = 16), dynamic above it (H = 48)
  constexpr int kTotal = raptor::Layout<H>::TOTAL;
  __shared__ float w_static[kStatic<H> ? kTotal : 1];
  extern __shared__ float w_dynamic[];
  float* w = kStatic<H> ? w_static : w_dynamic;
  for (int k = threadIdx.x; k < kTotal; k += blockDim.x) {
    w[k] = weights[k];
  }
  __syncthreads();
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  raptor::collect_env<H>(i, n, w, params, state, out, n_steps, dt,
                         episode_length, b, init, seed, env_offset);
}

template <int H>
int launch(const float* weights, const float* params, const float* state,
           float* out, int n, int n_steps, float dt, float episode_length,
           raptor::Bounds b, raptor::InitSpec init, uint32_t seed,
           uint32_t env_offset, cudaStream_t stream) {
  constexpr int bytes = kStatic<H> ? 0 : raptor::Layout<H>::TOTAL * 4;
  if (!kStatic<H>) {
    const cudaError_t err = cudaFuncSetAttribute(
        collect_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  collect_kernel<H><<<blocks, kThreads, bytes, stream>>>(
      weights, params, state, out, n, n_steps, dt, episode_length, b, init,
      seed, env_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One object a hidden width: nvcc compiles this file once for each width with
// -DRAPTOR_HIDDEN=H (ops/build.py), all in parallel, and each object exports
// raptor_collect_<H>.
#ifndef RAPTOR_HIDDEN
#define RAPTOR_HIDDEN 16
#endif

// weights (flat policy layout of hidden width RAPTOR_HIDDEN), params [42, n],
// state [17, n] in; out [n_steps, 23, n] (22 observation channels, then the
// done flag). Launches on `stream` and returns cudaGetLastError().
extern "C" int RAPTOR_PASTE(raptor_collect_, RAPTOR_HIDDEN)(
    const float* weights, const float* params, const float* state, float* out,
    int n, int n_steps, float dt, float episode_length, float pos_bound,
    float linvel_bound, float angvel_bound, float position_range,
    float max_angle, float angle_power, float linear_velocity_std,
    float angular_velocity_std, int rpm_at_hover, unsigned int seed,
    unsigned int env_offset, void* stream) {
  if (n <= 0 || n_steps <= 0) return static_cast<int>(cudaGetLastError());
  return launch<RAPTOR_HIDDEN>(
      weights, params, state, out, n, n_steps, dt, episode_length,
      raptor::Bounds{pos_bound, linvel_bound, angvel_bound},
      raptor::InitSpec{position_range, max_angle, angle_power,
                       linear_velocity_std, angular_velocity_std, rpm_at_hover},
      seed, env_offset, static_cast<cudaStream_t>(stream));
}

// threads that fly one env: one, the kernel's env index is its thread index
extern "C" int RAPTOR_PASTE(raptor_collect_threads_per_env_, RAPTOR_HIDDEN)() {
  return 1;
}
