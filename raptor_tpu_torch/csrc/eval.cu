// Closed-loop policy evaluation of N airframes on Hopper (sm_90a): whole
// episodes of obs -> Dense -> GRU -> Dense -> clip -> RK4 -> reward ->
// termination in one kernel, for a policy of hidden width 8, 16, 24, 32 or 48.
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_eval.py:_eval_kernel.
//
// What bounds it: on paper FP32 FMA issue (about 1.1k operations of physics
// plus 22*16 + 6*16*16 + 4*16 = 1,952 policy FMAs per env-step at H = 16: a
// 0.653 ms bound at N = 16,384 x T = 500), beside it the special-function unit
// for the 48 expf/tanhf of the GRU gates. In practice shared memory: every
// env-step reads all 8.3 KB of weights from shared memory into registers, and
// an SM delivers 128 B a clock, about 2.0 ms at that shape on an H100 SXM
// whatever the lanes an env (PERF.md). The bytes moved in device memory are
// the state, the parameters, the stats and the weights, about 5 MB.
//
// Design: a team of EVAL_TEAM lanes of one warp an env (team_step.cuh; 2,
// the fastest of 1, 2, 4 and 8 on the card, PERF.md). The policy is split by
// hidden unit and the rotor work by rotor, the exchange is shuffles under the
// team's mask; state, hidden state, previous action and the parameters a lane uses
// stay in registers for the whole episode. The weights come in as a device
// array in the flat layout and are restaged at block start, in dynamic shared
// memory, into the team-lane layout: a lane reads its rows with 16-byte
// loads, and the K lanes of a team hit distinct banks. One build serves every
// checkpoint of an instantiated width. Blocks are 1 to 4 warps, chosen so the
// grid covers the SMs at small N; the ragged edge is masked by env index, a
// whole team at a time. A terminated env keeps its pre-step state, hidden
// state and previous action by a select and its team leaves the loop.
#include <cuda_runtime.h>

#include "team_step.cuh"

namespace {

constexpr int K = raptor::EVAL_TEAM;
constexpr int kMaxThreads = 128;

template <int H>
__global__ void __launch_bounds__(kMaxThreads)
    eval_kernel(const float* __restrict__ weights,
                const float* __restrict__ params,
                const float* __restrict__ state, float* __restrict__ state_out,
                float* __restrict__ stats, int n, int n_steps, float dt,
                raptor::Bounds b, raptor::RewardWeights rw) {
  extern __shared__ __align__(16) float smem[];
  raptor::stage_team_weights<H, K>(weights, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / K;
  if (i >= n) return;
  const int lane = threadIdx.x % K;
  const raptor::DeviceTeam<K> tm{((1u << K) - 1u) << ((threadIdx.x % 32) - lane), lane};
  raptor::team_eval_env<raptor::DeviceTeam<K>, H>(
      tm, i, n, reinterpret_cast<const raptor::Vec4*>(smem), weights, params,
      state, state_out, stats, n_steps, dt, b, rw);
}

template <int H>
int launch(const float* weights, const float* params, const float* state,
           float* state_out, float* stats, int n, int n_steps, float dt,
           raptor::Bounds b, raptor::RewardWeights rw, cudaStream_t stream) {
  constexpr int bytes = raptor::TeamLayout<H, K>::FLOATS * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      eval_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n_threads = static_cast<long>(n) * K;
  const int threads = raptor::team_block_threads(n_threads);
  const int blocks = static_cast<int>((n_threads + threads - 1) / threads);
  eval_kernel<H><<<blocks, threads, bytes, stream>>>(
      weights, params, state, state_out, stats, n, n_steps, dt, b, rw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One object a hidden width: nvcc compiles this file once for each width with
// -DRAPTOR_HIDDEN=H (ops/build.py), all in parallel, and each object exports
// raptor_eval_<H>.
#ifndef RAPTOR_HIDDEN
#define RAPTOR_HIDDEN 16
#endif

// weights (flat policy layout of hidden width RAPTOR_HIDDEN), params [42, n],
// state [17, n] in; state_out [17, n], stats [3, n] (alive, length, return)
// out. Launches on `stream` and returns cudaGetLastError().
extern "C" int RAPTOR_PASTE(raptor_eval_, RAPTOR_HIDDEN)(
    const float* weights, const float* params, const float* state,
    float* state_out, float* stats, int n, int n_steps, float dt,
    float pos_bound, float linvel_bound, float angvel_bound, float r_scale,
    float r_constant, float r_position, float r_orientation,
    float r_linear_velocity, float r_angular_velocity, float r_action,
    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch<RAPTOR_HIDDEN>(
      weights, params, state, state_out, stats, n, n_steps, dt,
      raptor::Bounds{pos_bound, linvel_bound, angvel_bound},
      raptor::RewardWeights{r_scale, r_constant, r_position, r_orientation,
                            r_linear_velocity, r_angular_velocity, r_action},
      static_cast<cudaStream_t>(stream));
}
