// Closed-loop policy evaluation of N airframes on Hopper (sm_90a): whole
// episodes of obs -> Dense -> GRU -> Dense -> clip -> RK4 -> reward ->
// termination in one kernel, for a policy of hidden width 8, 16, 24, 32 or 48.
//
// Replaces the TPU kernel raptor_tpu/ops/pallas_eval.py:_eval_kernel.
//
// What bounds it: on paper FP32 FMA issue (about 1.1k operations of physics
// plus 22*16 + 6*16*16 + 4*16 = 1,952 policy FMAs per env-step at H = 16: a
// 0.653 ms bound at N = 16,384 x T = 500), beside it the special-function unit
// for the 48 expf/tanhf of the GRU gates. Measured on an H100 (PERF.md), with
// one env on a team of two lanes two things held it at 4.4 x that bound: the
// 8.3 KB of weights every env-step reads from shared memory (LDS.128 at 128 B
// a clock an SM, about 2.0 ms of the 2.9), and latency: ptxas' own schedule
// waits about 1.8 cycles an instruction, so a scheduler needs several warps
// to issue every cycle, and N = 16,384 gives it two. Flying two envs a team
// halves the weight traffic; on eight lanes a team keeps four warps a
// scheduler (two envs on two lanes halves the warps and loses more than it
// gains: the sweep of K and E in PERF.md). The bytes moved in device memory
// are the state, the parameters, the stats and the weights, about 5 MB.
//
// Design: a team of K lanes of one warp flies E envs (team_step.cuh
// `EvalTeam<H>`, chosen per width by measurement, PERF.md). With E = 1
// (team_eval_env) the policy is split by hidden unit and the rotor work by
// rotor; with E > 1 (team_eval_envs) each env's physics runs so on a
// sub-team of K / E lanes, the policy of the E envs is split by hidden unit
// over all K lanes, and every weight a lane loads serves the E envs. Each
// env's sums keep the order of one env on two lanes, so its bits do not
// depend on K or E. Each env's state, hidden state, previous action and the
// parameters a lane uses stay in registers for the whole episode. Team t
// flies envs t, t + n_teams, ... (n_teams = ceil(N / E)), so a warp's state
// and parameter accesses stay coalesced for each env. The weights come in as
// a device array in the flat layout and are restaged at block start, in
// dynamic shared memory, into the team-lane layout: a lane reads its rows
// with 16-byte loads, and the K lanes of a team hit distinct banks. One build
// serves every checkpoint of an instantiated width. Blocks are 1 to 4 warps,
// chosen so the grid covers the SMs at small N. With E = 1 the ragged edge is
// masked a team at a time and a team leaves the loop when its env is done;
// with E > 1 the whole warp flies every step together, so its exchange needs
// no convergence check: a terminated env, and a slot past N, keeps its state
// by a select and rides along until every env of the warp is done, and the
// GRU's r and z gates take a reciprocal without a branch (recip_fast).
#include <cuda_runtime.h>

#include "team_step.cuh"

// One object a hidden width: nvcc compiles this file once for each width with
// -DRAPTOR_HIDDEN=H (ops/build.py), all in parallel, and each object exports
// raptor_eval_<H>, raptor_eval_lanes_<H> and raptor_eval_envs_<H>.
#ifndef RAPTOR_HIDDEN
#define RAPTOR_HIDDEN 16
#endif

namespace {

constexpr int K = raptor::EvalTeam<RAPTOR_HIDDEN>::K;
constexpr int E = raptor::EvalTeam<RAPTOR_HIDDEN>::E;
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
  const long n_teams = (n + E - 1) / E;
  const long thread = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long team = thread / K;
  const int lane = threadIdx.x % K;
  const auto* wt = reinterpret_cast<const raptor::Vec4*>(smem);
  if constexpr (E == 1) {
    if (team >= n_teams) return;
    const raptor::DeviceTeam<K> tm{((1u << K) - 1u) << ((threadIdx.x % 32) - lane), lane};
    raptor::team_eval_env<raptor::DeviceTeam<K>, H>(
        tm, team, n, wt, weights, params, state, state_out, stats, n_steps, dt, b, rw);
  } else {
    // the whole warp runs every step together, so the team's exchange is
    // under the full warp's mask (no convergence check a shuffle); a team
    // past the last flies as done
    if ((thread & ~31L) / K >= n_teams) return;
    const raptor::DeviceTeam<K> tm{0xffffffffu, lane};
    raptor::team_eval_envs<raptor::DeviceTeam<K>, H, E>(
        tm, team, n_teams, n, wt, weights, params, state, state_out, stats, n_steps, dt,
        b, rw);
  }
}

template <int H>
int launch(const float* weights, const float* params, const float* state,
           float* state_out, float* stats, int n, int n_steps, float dt,
           raptor::Bounds b, raptor::RewardWeights rw, cudaStream_t stream) {
  constexpr int bytes = raptor::TeamLayout<H, K>::FLOATS * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      eval_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the threads the launch has: K a team, one team for every E envs
  const long n_threads = (static_cast<long>(n) + E - 1) / E * K;
  const int threads = raptor::team_block_threads(n_threads);
  const int blocks = static_cast<int>((n_threads + threads - 1) / threads);
  eval_kernel<H><<<blocks, threads, bytes, stream>>>(
      weights, params, state, state_out, stats, n, n_steps, dt, b, rw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

// the eval kernel's team at this width: K lanes, which fly E envs
extern "C" int RAPTOR_PASTE(raptor_eval_lanes_, RAPTOR_HIDDEN)() { return K; }
extern "C" int RAPTOR_PASTE(raptor_eval_envs_, RAPTOR_HIDDEN)() { return E; }
