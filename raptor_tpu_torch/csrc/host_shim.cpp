// The kernels' per-env code (quad_step.cuh, team_step.cuh) looped over envs
// on the CPU, with the same C interface as rollout.cu, eval.cu and collect.cu
// minus the stream, plus the collect kernel's PRNG and sampler on arrays of
// counters, the FMA peak probe's chain (fma_chain.cuh) on an array, and
// bptt.cu's forward, backward and sum of the sequences' gradient rows
// (bptt_step.cuh) looped over sequences. The kernels' teams run as HostTeam:
// the K lanes of a team in one thread, phase by phase between the exchanges;
// the BPTT's blocks as HostBlock, likewise between the barriers. Built with g++ so the CPU tests can hold the
// arithmetic the kernels run to the JAX package and to the plain PyTorch
// versions.
#include <vector>

#include "bptt_step.cuh"
#include "fma_chain.cuh"
#include "quad_step.cuh"
#include "team_step.cuh"

extern "C" int raptor_rollout_host(const float* params, const float* state,
                                   const float* action, float* state_out,
                                   float* stats, int n, int n_steps, float dt,
                                   float pos_bound, float linvel_bound,
                                   float angvel_bound) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  const raptor::HostTeam<raptor::ROLLOUT_TEAM> tm;
  for (long i = 0; i < n; ++i) {
    raptor::team_rollout_env(tm, i, n, params, state, action, state_out, stats,
                             n_steps, dt, b);
  }
  return 0;
}

namespace {

// The eval kernel's teams at hidden width H: K lanes, each team flying E envs
template <int H, int K, int E>
int eval_host(const float* weights, const float* params, const float* state,
              float* state_out, float* stats, int n, int n_steps, float dt,
              raptor::Bounds b, raptor::RewardWeights rw) {
  std::vector<raptor::Vec4> wt(raptor::TeamLayout<H, K>::FLOATS / 4);
  raptor::stage_team_weights<H, K>(weights, &wt[0].x, 0, 1);
  const raptor::HostTeam<K> tm;
  const long n_teams = (static_cast<long>(n) + E - 1) / E;
  for (long team = 0; team < n_teams; ++team) {
    if constexpr (E == 1) {
      raptor::team_eval_env<raptor::HostTeam<K>, H>(tm, team, n, wt.data(), weights,
                                                    params, state, state_out, stats,
                                                    n_steps, dt, b, rw);
    } else {
      raptor::team_eval_envs<raptor::HostTeam<K>, H, E>(tm, team, n_teams, n, wt.data(),
                                                        weights, params, state, state_out,
                                                        stats, n_steps, dt, b, rw);
    }
  }
  return 0;
}

template <int H, int K>
int collect_host(const float* weights, const float* params, const float* state,
                 float* out, int n, int n_steps, float dt, float episode_length,
                 raptor::Bounds b, raptor::InitSpec init, unsigned int seed,
                 unsigned int env_offset) {
  std::vector<raptor::Vec4> wt(raptor::TeamLayout<H, K>::FLOATS / 4);
  raptor::stage_team_weights<H, K>(weights, &wt[0].x, 0, 1);
  const raptor::HostTeam<K> tm;
  for (long i = 0; i < n; ++i) {
    raptor::team_collect_env<raptor::HostTeam<K>, H>(
        tm, i, n, wt.data(), weights, params, state, out, n_steps, dt,
        episode_length, b, init, seed, env_offset);
  }
  return 0;
}

template <int H>
int bptt_host(const raptor::StudentLeaves& w, const float* obs, const float* reset,
              const float* d_actions, float* actions, float* grad, int n_steps, int batch) {
  using S = raptor::Bptt<H>;
  std::vector<float> sm(S::SHARED);
  for (int i = 0; i < S::FWD_THREADS; ++i) raptor::stage_student<H>(w, sm.data(), i, S::FWD_THREADS);
  std::vector<float> saved(static_cast<size_t>(n_steps) * batch * S::SAVED);
  const raptor::HostBlock<S::FWD_THREADS> fwd;
  for (long b = 0; b < batch; ++b) {
    raptor::bptt_forward_seq<raptor::HostBlock<S::FWD_THREADS>, H>(
        fwd, sm.data(), obs, reset, actions, saved.data(), n_steps, batch, b);
  }
  if (d_actions == nullptr) return 0;
  std::vector<float> partial(static_cast<size_t>(batch) * S::TOTAL);
  const raptor::HostBlock<S::BWD_THREADS> bwd;
  for (long b = 0; b < batch; ++b) {
    raptor::bptt_backward_seq<raptor::HostBlock<S::BWD_THREADS>, H>(
        bwd, sm.data(), obs, reset, saved.data(), d_actions, partial.data(), n_steps, batch, b);
  }
  for (int f = 0; f < S::TOTAL; ++f) {
    raptor::bptt_reduce_entry(partial.data(), grad, batch, S::TOTAL, f);
  }
  return 0;
}

}  // namespace

#define RAPTOR_EVAL_ARGS                                                          \
  const float *weights, const float *params, const float *state,                \
      float *state_out, float *stats, int n, int n_steps, int hidden, float dt, \
      float pos_bound, float linvel_bound, float angvel_bound, float r_scale,   \
      float r_constant, float r_position, float r_orientation,                  \
      float r_linear_velocity, float r_angular_velocity, float r_action
#define RAPTOR_EVAL_RUN(H, K, E)                                                \
  return eval_host<H, K, E>(weights, params, state, state_out, stats, n, n_steps, \
                         dt, raptor::Bounds{pos_bound, linvel_bound, angvel_bound}, \
                         raptor::RewardWeights{r_scale, r_constant, r_position,     \
                                               r_orientation, r_linear_velocity,    \
                                               r_angular_velocity, r_action})

// The eval kernel's teams at a hidden width (EvalTeam<hidden>: K lanes fly E
// envs); -1 for a hidden width that is not instantiated
extern "C" int raptor_eval_host(RAPTOR_EVAL_ARGS) {
#define RAPTOR_RUN(H) RAPTOR_EVAL_RUN(H, raptor::EvalTeam<H>::K, raptor::EvalTeam<H>::E)
  RAPTOR_HIDDEN_DISPATCH(hidden, RAPTOR_RUN)
#undef RAPTOR_RUN
}

// raptor_eval_host with one env on each team of two lanes, whatever team the
// width takes: the order of every sum of every width's kernel, so what every
// env's bits are held to
extern "C" int raptor_eval_unblocked_host(RAPTOR_EVAL_ARGS) {
#define RAPTOR_RUN(H) RAPTOR_EVAL_RUN(H, 2, 1)
  RAPTOR_HIDDEN_DISPATCH(hidden, RAPTOR_RUN)
#undef RAPTOR_RUN
}
#undef RAPTOR_EVAL_RUN
#undef RAPTOR_EVAL_ARGS

// the eval kernel's envs a team at a hidden width (EvalTeam<hidden>::E); -1
// for a width that is not instantiated
extern "C" int raptor_eval_envs_host(int hidden) {
#define RAPTOR_RUN(H) return raptor::EvalTeam<H>::E
  RAPTOR_HIDDEN_DISPATCH(hidden, RAPTOR_RUN)
#undef RAPTOR_RUN
}

// -1 for a hidden width that is not instantiated
extern "C" int raptor_collect_host(const float* weights, const float* params,
                                   const float* state, float* out, int n,
                                   int n_steps, int hidden, float dt,
                                   float episode_length, float pos_bound,
                                   float linvel_bound, float angvel_bound,
                                   float position_range, float max_angle,
                                   float angle_power, float linear_velocity_std,
                                   float angular_velocity_std, int rpm_at_hover,
                                   unsigned int seed, unsigned int env_offset) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  const raptor::InitSpec init{position_range,      max_angle,
                              angle_power,         linear_velocity_std,
                              angular_velocity_std, rpm_at_hover};
#define RAPTOR_RUN(H)                                                    \
  return collect_host<H, raptor::COLLECT_TEAM>(weights, params, state, out, \
                                               n, n_steps, dt, episode_length, \
                                               b, init, seed, env_offset)
  RAPTOR_HIDDEN_DISPATCH(hidden, RAPTOR_RUN)
#undef RAPTOR_RUN
}

// raptor_collect_host at hidden width 16 on a team of `team` lanes (1, 2, 4
// or 8, the sizes apps/team_sweep.py measures), whatever COLLECT_TEAM is; -1
// for another team size
extern "C" int raptor_collect_team_host(const float* weights, const float* params,
                                        const float* state, float* out, int n,
                                        int n_steps, int team, float dt,
                                        float episode_length, float pos_bound,
                                        float linvel_bound, float angvel_bound,
                                        float position_range, float max_angle,
                                        float angle_power, float linear_velocity_std,
                                        float angular_velocity_std, int rpm_at_hover,
                                        unsigned int seed, unsigned int env_offset) {
  const raptor::Bounds b{pos_bound, linvel_bound, angvel_bound};
  const raptor::InitSpec init{position_range,      max_angle,
                              angle_power,         linear_velocity_std,
                              angular_velocity_std, rpm_at_hover};
#define RAPTOR_RUN(K)                                                      \
  return collect_host<16, K>(weights, params, state, out, n, n_steps, dt, \
                             episode_length, b, init, seed, env_offset)
  switch (team) {
    case 1: RAPTOR_RUN(1);
    case 2: RAPTOR_RUN(2);
    case 4: RAPTOR_RUN(4);
    case 8: RAPTOR_RUN(8);
    default: return -1;
  }
#undef RAPTOR_RUN
}

// bptt.cu's three kernels in one call: the nine leaves, obs [T, B, 22],
// reset [T, B] in; actions [T, B, 4] out; with d_actions [T, B, 4] also the
// gradient of the flat policy layout, grad [n_weights(hidden)] (d_actions
// null: the forward alone, grad untouched). -1 for a hidden width that is not
// instantiated.
extern "C" int raptor_bptt_host(const float* w0, const float* b0, const float* wi,
                                const float* wh, const float* bi, const float* bh,
                                const float* h0, const float* w2, const float* b2,
                                const float* obs, const float* reset,
                                const float* d_actions, float* actions, float* grad,
                                int n_steps, int batch, int hidden) {
  const raptor::StudentLeaves w{w0, b0, wi, wh, bi, bh, h0, w2, b2};
#define RAPTOR_RUN(H) \
  return bptt_host<H>(w, obs, reset, d_actions, actions, grad, n_steps, batch)
  RAPTOR_HIDDEN_DISPATCH(hidden, RAPTOR_RUN)
#undef RAPTOR_RUN
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
