// DAgger collect rollout of N airframes on Hopper (sm_90a): T closed-loop
// steps of the student policy (obs -> Dense -> GRU -> Dense -> clip -> RK4 ->
// termination) with in-kernel episode auto-reset from a counter-hash PRNG,
// streaming every pre-step observation and the done flag to device memory,
// for a student of hidden width 8, 16, 24, 32 or 48.
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_collect.py:_collect_kernel.
//
// What bounds it: on paper FP32 operations, as for eval.cu (about 5.3k per
// env-step at H = 16, plus the GRU's 48 expf/tanhf on the special-function
// unit): 0.22 ms at N = 5,528, T = 500 at the H100 SXM's 67 TFLOP/s. The
// bytes are the output stream, 23 floats per env-step (254 MB at that shape,
// 0.08 ms at 3.35 TB/s). Below those, as for eval.cu, shared memory: every
// env-step reads all of the weights from shared memory into registers, about
// 0.7 ms at that shape on an H100 SXM (PERF.md). Measured there on an NVIDIA
// H100 80GB HBM3 at 700 W: 1.5 to 1.6 ms on four lanes an env, so with a
// few thousand envs (691 warps, 1.3 a scheduler; 118 at a distillation
// round's 944) the latency of few warps is what is left.
//
// Design: eval.cu's, a team of COLLECT_TEAM lanes of one warp an env
// (team_step.cuh `team_collect_env`): the policy is split by hidden unit and
// the rotor work by rotor, the exchange is shuffles under the team's mask;
// state, hidden state, previous action, step count and the parameters a lane
// uses stay in registers for all T steps. The weights come in as a device
// array in the flat layout and are restaged at block start, in dynamic shared
// memory, into the team-lane layout (16-byte loads, the K lanes of a team on
// distinct banks); one build serves the student of every round of an
// instantiated width. The output is channel-major, [T, 23, N]: each lane
// stores the observation channels c with c % K == its lane, so a warp writes
// runs of contiguous floats a channel, and lane 0 the done flag; the wrapper
// hands out [T, N, 22] and [T, N] as views of it. The done flag is broadcast
// from lane 0 and the reset is a branch of the whole team: only a done env
// draws a fresh sample, and a non-finite state is replaced, not blended. The
// TPU kernel's (rows, 128) tiles, time-chunk grid, VMEM carry and lane padding
// have no counterpart: T is a loop inside the team. Blocks are 1 to 4 warps,
// chosen so the grid covers the SMs at a distillation round's few hundred
// envs; the ragged edge is masked by env index, a whole team at a time.
// COLLECT_TEAM is 4, the fastest of 1, 2, 4 and 8 at 5,528 envs
// (apps/team_sweep.py).
#include <cuda_runtime.h>

#include "team_step.cuh"

namespace {

constexpr int K = raptor::COLLECT_TEAM;
constexpr int kMaxThreads = 128;

template <int H>
__global__ void __launch_bounds__(kMaxThreads)
    collect_kernel(const float* __restrict__ weights,
                   const float* __restrict__ params,
                   const float* __restrict__ state, float* __restrict__ out,
                   int n, int n_steps, float dt, float episode_length,
                   raptor::Bounds b, raptor::InitSpec init, uint32_t seed,
                   uint32_t env_offset) {
  extern __shared__ __align__(16) float smem[];
  raptor::stage_team_weights<H, K>(weights, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / K;
  if (i >= n) return;
  const int lane = threadIdx.x % K;
  const raptor::DeviceTeam<K> tm{((1u << K) - 1u) << ((threadIdx.x % 32) - lane), lane};
  raptor::team_collect_env<raptor::DeviceTeam<K>, H>(
      tm, i, n, reinterpret_cast<const raptor::Vec4*>(smem), weights, params,
      state, out, n_steps, dt, episode_length, b, init, seed, env_offset);
}

template <int H>
int launch(const float* weights, const float* params, const float* state,
           float* out, int n, int n_steps, float dt, float episode_length,
           raptor::Bounds b, raptor::InitSpec init, uint32_t seed,
           uint32_t env_offset, cudaStream_t stream) {
  constexpr int bytes = raptor::TeamLayout<H, K>::FLOATS * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      collect_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n_threads = static_cast<long>(n) * K;
  const int threads = raptor::team_block_threads(n_threads);
  const int blocks = static_cast<int>((n_threads + threads - 1) / threads);
  collect_kernel<H><<<blocks, threads, bytes, stream>>>(
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

// lanes of a team that fly one env: COLLECT_TEAM
extern "C" int RAPTOR_PASTE(raptor_collect_threads_per_env_, RAPTOR_HIDDEN)() {
  return K;
}
