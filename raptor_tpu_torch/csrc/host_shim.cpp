// The kernels' per-env code (quad_step.cuh) looped over envs on the CPU, with
// the same C interface as rollout.cu, eval.cu and collect.cu minus the stream,
// plus the collect kernel's PRNG and sampler on arrays of counters and the FMA
// peak probe's chain (fma_chain.cuh) on an array. Built with
// g++ so the CPU tests can hold the arithmetic the kernels run to the JAX
// package and to the plain PyTorch versions.
#include "fma_chain.cuh"
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

extern "C" int raptor_collect_host(const float* weights, const float* params,
                                   const float* state, float* out, int n,
                                   int n_steps, float dt, float episode_length,
                                   float pos_bound, float linvel_bound,
                                   float angvel_bound, float position_range,
                                   float max_angle, float angle_power,
                                   float linear_velocity_std,
                                   float angular_velocity_std, int rpm_at_hover,
                                   unsigned int seed, unsigned int env_offset) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  const raptor::InitSpec init{position_range,      max_angle,
                              angle_power,         linear_velocity_std,
                              angular_velocity_std, rpm_at_hover};
  for (long i = 0; i < n; ++i) {
    raptor::collect_env(i, n, weights, params, state, out, n_steps, dt,
                        episode_length, b, init, seed, env_offset);
  }
  return 0;
}

// hashed[k] = lowbias32(counters[k]); uniforms[k] = uniform01(counters[k], draw)
extern "C" int raptor_hash_host(const unsigned int* counters,
                                unsigned int* hashed, float* uniforms, int n,
                                unsigned int draw) {
  for (int k = 0; k < n; ++k) {
    hashed[k] = raptor::lowbias32(counters[k]);
    uniforms[k] = raptor::uniform01(counters[k], draw);
  }
  return 0;
}

// state_out[:, k] = sample_state(params[:, k], counters[k]); [17, n]
extern "C" int raptor_sample_state_host(const float* params,
                                        const unsigned int* counters,
                                        float* state_out, int n,
                                        float position_range, float max_angle,
                                        float angle_power,
                                        float linear_velocity_std,
                                        float angular_velocity_std,
                                        int rpm_at_hover) {
  const raptor::InitSpec init{position_range,      max_angle,
                              angle_power,         linear_velocity_std,
                              angular_velocity_std, rpm_at_hover};
  for (long i = 0; i < n; ++i) {
    float s[raptor::N_STATE];
    raptor::sample_state(raptor::ParamColumn{params + i, n}, counters[i], init, s);
    for (int j = 0; j < raptor::N_STATE; ++j) state_out[j * n + i] = s[j];
  }
  return 0;
}

// out[i] = the FMA peak probe's chain on x[i] (fma_peak.cu's per-element
// function, one chain at a time)
extern "C" int raptor_fma_peak_host(const float* x, float* out, long n,
                                    int depth, int nfma, float a, float b) {
#define RAPTOR_LOOP(NFMA)                               \
  for (long i = 0; i < n; ++i) {                        \
    float y[1] = {x[i]};                                \
    raptor::fma_chains<NFMA, 1>(y, depth, a, b);        \
    out[i] = y[0];                                      \
  }
  RAPTOR_FMA_DISPATCH(nfma, RAPTOR_LOOP)
#undef RAPTOR_LOOP
  return 0;
}
