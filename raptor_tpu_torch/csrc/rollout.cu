// Constant-action RK4 rollout of N airframes on Hopper (sm_90a).
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_rollout.py:_rollout_kernel.
//
// What bounds it: FP32 FMA issue. An env-step is about 1.1k FP32 operations
// (four derivative evaluations, the RK4 combination, renormalize, clip,
// termination) on 17 state floats and 42 parameters; the bytes moved are the
// initial and final state and the parameters, (42 + 17 + 4 + 17 + 2) x 4 B per
// env, about 5 MB at N = 16,384, against ~9 GFLOP for 512 steps. One thread an
// env (the design before this one) reached 20 % of that bound: one warp a
// scheduler hid little latency, and the parameters were re-read inside every
// derivative.
//
// Design: the physics half of team_step.cuh on a team of ROLLOUT_TEAM lanes
// an env, which is one: of 1, 2, 4 and 8 lanes, one was the fastest with
// termination off (PERF.md), because every added lane repeats the 13-float
// common state's arithmetic, which is most of an env-step. A team of one
// exchanges nothing; what it gains over the design before it is the
// parameters, read into registers once an episode instead of inside every
// derivative. The action maps to an rpm setpoint once. Structure of arrays in device memory ([42, N] params,
// [17, N] state, [4, N] action); the T-step loop runs in registers and the
// result is written once. The ragged edge is masked by env index, a whole team
// at a time; the TPU kernel's padding to 1024 envs and its hazards
// (pallas_rollout.py:79-82, :117-118) do not exist here. A terminated env keeps
// its pre-step state by a select and its team leaves the loop.
#include <cuda_runtime.h>

#include "team_step.cuh"

namespace {

constexpr int K = raptor::ROLLOUT_TEAM;
constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
    rollout_kernel(const float* __restrict__ params,
                   const float* __restrict__ state,
                   const float* __restrict__ action,
                   float* __restrict__ state_out, float* __restrict__ stats,
                   int n, int n_steps, float dt, raptor::Bounds b) {
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / K;
  if (i >= n) return;
  const int lane = threadIdx.x % K;
  const raptor::DeviceTeam<K> tm{((1u << K) - 1u) << ((threadIdx.x % 32) - lane), lane};
  raptor::team_rollout_env(tm, i, n, params, state, action, state_out, stats,
                           n_steps, dt, b);
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
    const long n_threads = static_cast<long>(n) * K;
    const int threads = raptor::team_block_threads(n_threads);
    const int blocks = static_cast<int>((n_threads + threads - 1) / threads);
    rollout_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        params, state, action, state_out, stats, n, n_steps, dt,
        raptor::Bounds{pos_bound, linvel_bound, angvel_bound});
  }
  return static_cast<int>(cudaGetLastError());
}

// lanes an env of the rollout kernel
extern "C" int raptor_rollout_threads_per_env() { return K; }
