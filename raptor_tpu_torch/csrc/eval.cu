// Closed-loop policy evaluation of N airframes on Hopper (sm_90a): whole
// episodes of obs -> Dense -> GRU -> Dense -> clip -> RK4 -> reward ->
// termination in one kernel.
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_eval.py:_eval_kernel.
//
// What bounds it: FP32 FMA issue (about 1.1k operations of physics plus
// 22*16 + 6*16*16 + 4*16 = 1,952 policy FMAs per env-step) and, beside it, the
// special-function unit for the 48 expf/tanhf of the GRU gates. The bytes
// moved are the initial and final state, the parameters, the stats and the
// 8.3 KB of weights, about 5 MB at N = 16,384.
//
// Design: one thread per env with the state, hidden state and previous
// action in registers for the whole episode; structure-of-arrays inputs
// ([42, N] params, [17, N] state) so neighbouring threads read neighbouring
// addresses. The 2,084 weights come in as a device array and are staged into
// shared memory at block start; every thread of a warp then reads the same
// weight address, a shared-memory broadcast. Unlike the TPU kernel, which
// baked the weights in as constants and compiled once per checkpoint, one
// build serves every checkpoint. The ragged edge is masked with i < n; the
// TPU padding to 1024 envs and its dead-lane hazards do not exist here.
// A terminated env keeps its pre-step state, hidden state and previous action
// by a select and its thread leaves the loop.
#include <cuda_runtime.h>

#include "quad_step.cuh"

namespace {

constexpr int kThreads = 64;  // 256 blocks at N = 16,384: every SM gets work

__global__ void __launch_bounds__(kThreads)
    eval_kernel(const float* __restrict__ weights,
                const float* __restrict__ params,
                const float* __restrict__ state, float* __restrict__ state_out,
                float* __restrict__ stats, int n, int n_steps, float dt,
                raptor::Bounds b, raptor::RewardWeights rw) {
  __shared__ float w[raptor::W_TOTAL];
  for (int k = threadIdx.x; k < raptor::W_TOTAL; k += blockDim.x) {
    w[k] = weights[k];
  }
  __syncthreads();
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  raptor::eval_env(i, n, w, params, state, state_out, stats, n_steps, dt, b,
                   rw);
}

}  // namespace

// weights [2084] (flat policy layout), params [42, n], state [17, n] in;
// state_out [17, n], stats [3, n] (alive, length, return) out. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int raptor_eval(const float* weights, const float* params,
                           const float* state, float* state_out, float* stats,
                           int n, int n_steps, float dt, float pos_bound,
                           float linvel_bound, float angvel_bound,
                           float r_scale, float r_constant, float r_position,
                           float r_orientation, float r_linear_velocity,
                           float r_angular_velocity, float r_action,
                           void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    eval_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        weights, params, state, state_out, stats, n, n_steps, dt,
        raptor::Bounds{pos_bound, linvel_bound, angvel_bound},
        raptor::RewardWeights{r_scale, r_constant, r_position, r_orientation,
                              r_linear_velocity, r_angular_velocity,
                              r_action});
  }
  return static_cast<int>(cudaGetLastError());
}
