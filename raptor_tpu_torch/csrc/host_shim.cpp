// The kernels' per-env code (quad_step.cuh) looped over envs on the CPU, with
// the same C interface as rollout.cu and eval.cu minus the stream. Built with
// g++ so the CPU tests can hold the arithmetic the kernels run to the JAX
// package and to the plain PyTorch versions.
#include "quad_step.cuh"

extern "C" int raptor_rollout_host(const float* params, const float* state,
                                   const float* action, float* state_out,
                                   float* stats, int n, int n_steps, float dt,
                                   float pos_bound, float linvel_bound,
                                   float angvel_bound) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  for (long i = 0; i < n; ++i) {
    raptor::rollout_env(i, n, params, state, action, state_out, stats, n_steps,
                        dt, b);
  }
  return 0;
}

extern "C" int raptor_eval_host(const float* weights, const float* params,
                                const float* state, float* state_out,
                                float* stats, int n, int n_steps, float dt,
                                float pos_bound, float linvel_bound,
                                float angvel_bound, float r_scale,
                                float r_constant, float r_position,
                                float r_orientation, float r_linear_velocity,
                                float r_angular_velocity, float r_action) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  const raptor::RewardWeights rw{r_scale,           r_constant,
                                 r_position,        r_orientation,
                                 r_linear_velocity, r_angular_velocity,
                                 r_action};
  for (long i = 0; i < n; ++i) {
    raptor::eval_env(i, n, weights, params, state, state_out, stats, n_steps,
                     dt, b, rw);
  }
  return 0;
}
