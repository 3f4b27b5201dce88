// Constant-action RK4 rollout of N airframes on Hopper (sm_90a).
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_rollout.py:_rollout_kernel.
//
// What bounds it: FP32 FMA issue. An env-step is about 1.1k FP32 operations
// (four derivative evaluations, the RK4 combination, renormalize, clip,
// termination) on 17 state floats and 42 parameters; the bytes moved are the
// initial and final state and the parameters, (42 + 17 + 4 + 17 + 2) x 4 B per
// env, about 5 MB at N = 16,384, against ~9 GFLOP for 512 steps.
//
// Design: one thread per env, structure of arrays in device memory
// ([42, N] params, [17, N] state, [4, N] action), so neighbouring threads read
// neighbouring addresses. The whole T-step loop runs in registers and the
// result is written once. Parameters are re-read through the read-only cache
// inside the derivative instead of being pinned in registers. The ragged edge
// is masked with i < n; the TPU kernel's padding to 1024 envs, and with it its
// padding hazards (a unit quaternion and unit parameters in dead lanes,
// pallas_rollout.py:79-82 and :117-118), do not exist here. A terminated env
// keeps its pre-step state by a select and its thread leaves the loop.
#include <cuda_runtime.h>

#include "quad_step.cuh"

namespace {

constexpr int kThreads = 64;  // 256 blocks at N = 16,384: every SM gets work

__global__ void __launch_bounds__(kThreads)
    rollout_kernel(const float* __restrict__ params,
                   const float* __restrict__ state,
                   const float* __restrict__ action,
                   float* __restrict__ state_out, float* __restrict__ stats,
                   int n, int n_steps, float dt, raptor::Bounds b) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  raptor::rollout_env(i, n, params, state, action, state_out, stats, n_steps,
                      dt, b);
}

}  // namespace

// params [42, n], state [17, n], action [4, n] in; state_out [17, n],
// stats [2, n] (alive, length) out. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int raptor_rollout(const float* params, const float* state,
                              const float* action, float* state_out,
                              float* stats, int n, int n_steps, float dt,
                              float pos_bound, float linvel_bound,
                              float angvel_bound, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    rollout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        params, state, action, state_out, stats, n, n_steps, dt,
        raptor::Bounds{pos_bound, linvel_bound, angvel_bound});
  }
  return static_cast<int>(cudaGetLastError());
}
