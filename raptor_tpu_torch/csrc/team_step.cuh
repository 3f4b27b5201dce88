// One env flown by a team of K lanes of one warp: the per-env loops of the
// rollout (rollout.cu), eval (eval.cu) and collect (collect.cu) kernels, shared
// with the host shim (host_shim.cpp) that the CPU tests build with g++. The
// one copy of the physics of all three is body_derivative and team_rk4. The
// eval kernel can also fly several envs on one team (team_eval_envs): each
// env's physics on a sub-team of the team's lanes, the envs' policy over all
// of them.
//
// How the work of an env-step is split over the team:
// - policy, by hidden unit: lane l owns units l*H/K .. (l+1)*H/K - 1 (their
//   rows of w0, the three gate rows of wi and wh, their biases, h0 and their
//   columns of w2). It computes their input projection, their GRU gates and
//   their new hidden values, and its partial sums of the 4 actions. x and h
//   reach every lane of the team by shuffles; the action sums by a butterfly.
// - physics, by rotor: lane l owns rotor l (for K = 4; rotors 2l and 2l + 1
//   for K = 2; all four for K = 1; rotor l % 4 for K = 8): its thrust and
//   its lag state. The four thrusts reach every lane by shuffles (one
//   exchange, none for K = 1), and every lane
//   forms the force and torque from per-rotor coefficients computed once an
//   episode (thrust direction d, and r x d + s kappa d). The rest (p, q, v, w:
//   13 floats; the force rotation, the quaternion rate, Euler's equation, the
//   RK4 combination, the renormalisation, observation, reward and
//   termination) runs redundantly on every lane: same inputs, same
//   instructions, so the same bits on every lane.
// - parameters: each lane reads the ones it uses into registers once an
//   episode (LaneParams), with 1/m and 1/tau computed once.
//
// The exchange goes through a Team. DeviceTeam<K> is one lane a thread and
// exchanges with __shfl_xor_sync / __shfl_sync under the team's mask.
// HostTeam<K> runs the K lanes of a team in one thread, phase by phase, with
// the same butterfly order. Values a lane holds are arrays [Team::N]: one
// entry on the card, K on the host. The butterfly leaves the same sum on
// every lane (a + b == b + a in IEEE arithmetic), and `done` is broadcast from
// lane 0, so a team cannot split.
//
// Sums differ in order from the Pallas kernels: the 4 actions add the lanes'
// partial sums in a butterfly, then the bias; the torque is the sum of each
// rotor's thrust times its coefficient r x d + s kappa d, where
// pallas_rollout.py:134-193 adds r x (t d) and s kappa t d term by term.
#pragma once

#include "quad_step.cuh"

namespace raptor {

// Lanes an env of the rollout and the collect kernel, chosen by measurement
// over 1, 2, 4 and 8 (apps/team_sweep.py, PERF.md); compile-time, one value a
// build. The rollout flies fastest on one lane: a team of one exchanges
// nothing and keeps only the parameters in registers. The collect, with a few
// thousand envs or fewer, flies fastest on four: there the warps in flight,
// not the weights' shared-memory traffic, set its time.
constexpr int ROLLOUT_TEAM = 1;
constexpr int COLLECT_TEAM = 4;

// The eval kernel's team at hidden width H: K lanes fly E envs, E dividing K.
// With E = 1 (team_eval_env) the K lanes split one env's policy by hidden
// unit and its rotor work by rotor; with E > 1 (team_eval_envs) each env's
// physics runs so on a sub-team of K / E lanes, and the policy of the E envs
// is split by hidden unit over all K, so every weight a lane loads serves the
// E envs. Chosen per width by measurement over K in {1, 2, 4, 8, 16} and E in
// {1, 2, 4} (apps/team_sweep.py, PERF.md): 8 lanes for 2 envs wherever that
// fits without a spill, else the 2 lanes for 1 env of the kernel before.
template <int H>
struct EvalTeam {
  static constexpr int K = H <= 32 ? 8 : 2;
  static constexpr int E = H <= 32 ? 2 : 1;
  static_assert(K % E == 0, "E envs split the team into sub-teams of K / E lanes");
};

constexpr int COMMON = 13;  // p(3) q(4) v(3) w(3): the state every lane holds

struct alignas(16) Vec4 {
  float x, y, z, w;
};

// one 16-byte load (LDS.128 from shared memory on the card)
RAPTOR_HD Vec4 load4(const Vec4* p) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return Vec4{v.x, v.y, v.z, v.w};
#else
  return *p;
#endif
}

RAPTOR_HD float comp(const Vec4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// a[idx] for a runtime idx < 4, by selects (no local-memory array on the card)
RAPTOR_HD float pick4(const float* a, int idx) {
  return idx == 0 ? a[0] : (idx == 1 ? a[1] : (idx == 2 ? a[2] : a[3]));
}

// ---------------------------------------------------------------------------
// the team primitive
// ---------------------------------------------------------------------------

// This thread is lane `l` of a team of K neighbouring lanes of its warp.
template <int K>
struct DeviceTeam {
  static constexpr int N = 1;  // lanes this thread runs
  static constexpr int SIZE = K;
  unsigned mask;  // the team's lanes in the warp
  int l;
  RAPTOR_HD int lane(int) const { return l; }
  // v[0] <- the sum of v over the aligned group of W lanes (xor butterfly)
  template <int W>
  RAPTOR_HD void sum(float* v) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int m = 1; m < W; m <<= 1) v[0] += __shfl_xor_sync(mask, v[0], m, K);
#endif
  }
  // v[0] <- lane 0's v[0]
  RAPTOR_HD void bcast0(int* v) const {
#ifdef __CUDA_ARCH__
    if (K > 1) v[0] = __shfl_sync(mask, v[0], 0, K);
#endif
  }
  // whether v[0] is nonzero on every lane of the mask
  RAPTOR_HD bool all(const int* v) const {
#ifdef __CUDA_ARCH__
    return K == 1 ? v[0] != 0 : __all_sync(mask, v[0]) != 0;
#else
    return v[0] != 0;
#endif
  }
  // v[0] <- 0 on lanes l % G == 0, else lane l - 1's v[0]: hands a chained
  // sum on to the next lane of each group of G
  template <int G>
  RAPTOR_HD void hand_on(float* v) const {
#ifdef __CUDA_ARCH__
    const float prev = __shfl_up_sync(mask, v[0], 1, K);
    v[0] = l % G == 0 ? 0.f : prev;
#endif
  }
  // v[0] <- lane G - 1's v[0] + lane 2G - 1's v[0] (K = 2G): the sum of two
  // halves' chains, as a two-lane butterfly adds them
  template <int G>
  RAPTOR_HD void halves(float* v) const {
#ifdef __CUDA_ARCH__
    const float lo = __shfl_sync(mask, v[0], G - 1, K), hi = __shfl_sync(mask, v[0], 2 * G - 1, K);
    v[0] = lo + hi;
#endif
  }
  // this lane in its sub-team of the aligned Q lanes that hold it
  template <int Q>
  RAPTOR_HD DeviceTeam<Q> sub() const { return DeviceTeam<Q>{mask, l % Q}; }
  // all[0][i] <- own[0][i % U] of lane (i / U) * S
  template <int U, int M = U * K, int S = 1>
  RAPTOR_HD void gather(const float (*own)[U], float (*all)[M]) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < M; ++i) {
      all[0][i] = K == 1 ? own[0][i % U] : __shfl_sync(mask, own[0][i % U], (i / U) * S, K);
    }
#endif
  }
};

// The K lanes of a team run by one host thread: each exchange is a phase
// boundary between the lanes' arithmetic.
template <int K>
struct HostTeam {
  static constexpr int N = K;
  static constexpr int SIZE = K;
  int lane(int j) const { return j; }
  template <int W>
  void sum(float* v) const {
    for (int m = 1; m < W; m <<= 1) {
      float t[K];
      for (int l = 0; l < K; ++l) t[l] = v[l] + v[l ^ m];
      for (int l = 0; l < K; ++l) v[l] = t[l];
    }
  }
  void bcast0(int* v) const {
    for (int l = 1; l < K; ++l) v[l] = v[0];
  }
  bool all(const int* v) const {
    for (int l = 0; l < K; ++l) {
      if (!v[l]) return false;
    }
    return true;
  }
  template <int G>
  void hand_on(float* v) const {
    for (int l = K - 1; l >= 0; --l) v[l] = l % G == 0 ? 0.f : v[l - 1];
  }
  template <int G>
  void halves(float* v) const {
    const float s = v[G - 1] + v[2 * G - 1];
    for (int l = 0; l < K; ++l) v[l] = s;
  }
  template <int Q>
  HostTeam<Q> sub() const { return HostTeam<Q>{}; }
  template <int U, int M = U * K, int S = 1>
  void gather(const float (*own)[U], float (*all)[M]) const {
    for (int l = 0; l < K; ++l) {
      for (int i = 0; i < M; ++i) all[l][i] = own[(i / U) * S][i % U];
    }
  }
};

#ifdef __CUDACC__
// Threads a block for n_threads lanes: 1 to 4 warps, fewer where the grid
// would not give every SM two blocks.
inline int team_block_threads(long n_threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long per_block = (n_threads + 31) / 32 / (2L * sms);
  return 32 * static_cast<int>(per_block < 1 ? 1 : (per_block > 4 ? 4 : per_block));
}
#endif

// ---------------------------------------------------------------------------
// physics of one lane
// ---------------------------------------------------------------------------

template <int K>
struct TeamShape {
  static constexpr int RL = K < 4 ? K : 4;  // lanes that own rotors
  static constexpr int R = 4 / RL;          // rotors a lane owns
  RAPTOR_HD static int rotor(int l, int k) { return (l % RL) * R + k; }
};

// The parameters one lane uses, in registers for the episode.
struct LaneParams {
  float inv_m, J[3], Jinv[3], c0, c1, c2, kappa, rpm_min, rpm_max, inv_tm;
  // every rotor's thrust direction d and torque per unit thrust r x d + s kappa d
  float d[4][3], c[4][3];
};

RAPTOR_HD LaneParams lane_params(const ParamColumn& P) {
  LaneParams lp;
  lp.inv_m = 1.f / P[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lp.J[c] = P[1 + c];
    lp.Jinv[c] = P[4 + c];
  }
  lp.c0 = P[35];
  lp.c1 = P[36];
  lp.c2 = P[37];
  lp.kappa = P[38];
  lp.rpm_min = P[39];
  lp.rpm_max = P[40];
  lp.inv_tm = 1.f / P[41];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float rx = P[7 + 3 * i], ry = P[8 + 3 * i], rz = P[9 + 3 * i];
    const float dx = P[19 + 3 * i], dy = P[20 + 3 * i], dz = P[21 + 3 * i];
    const float sk = P[31 + i] * lp.kappa;
    lp.d[i][0] = dx;
    lp.d[i][1] = dy;
    lp.d[i][2] = dz;
    lp.c[i][0] = (ry * dz - rz * dy) + sk * dx;
    lp.c[i][1] = (rz * dx - rx * dz) + sk * dy;
    lp.c[i][2] = (rx * dy - ry * dx) + sk * dz;
  }
  return lp;
}

RAPTOR_HD float lane_setpoint(const LaneParams& lp, float action) {
  return lp.rpm_min + (clip(action, -1.f, 1.f) + 1.f) * 0.5f * (lp.rpm_max - lp.rpm_min);
}

// d/dt of p, q, v, w under the summed wrench f (pallas_rollout.py:134-193
// term for term)
RAPTOR_HD void body_derivative(const LaneParams& lp, const float* s,
                               const float* f, float* d) {
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float wx = s[10], wy = s[11], wz = s[12];
  const float fx = f[0], fy = f[1], fz = f[2], tx = f[3], ty = f[4], tz = f[5];
  const float t2x = 2.f * (qy * fz - qz * fy);
  const float t2y = 2.f * (qz * fx - qx * fz);
  const float t2z = 2.f * (qx * fy - qy * fx);
  const float fwx = fx + qw * t2x + (qy * t2z - qz * t2y);
  const float fwy = fy + qw * t2y + (qz * t2x - qx * t2z);
  const float fwz = fz + qw * t2z + (qx * t2y - qy * t2x);
  d[0] = s[7];
  d[1] = s[8];
  d[2] = s[9];
  d[3] = 0.5f * (-qx * wx - qy * wy - qz * wz);
  d[4] = 0.5f * (qw * wx + qy * wz - qz * wy);
  d[5] = 0.5f * (qw * wy - qx * wz + qz * wx);
  d[6] = 0.5f * (qw * wz + qx * wy - qy * wx);
  d[7] = fwx * lp.inv_m;
  d[8] = fwy * lp.inv_m;
  d[9] = fwz * lp.inv_m - 9.81f;
  const float hx = lp.J[0] * wx, hy = lp.J[1] * wy, hz = lp.J[2] * wz;
  d[10] = lp.Jinv[0] * (tx - (wy * hz - wz * hy));
  d[11] = lp.Jinv[1] * (ty - (wz * hx - wx * hz));
  d[12] = lp.Jinv[2] * (tz - (wx * hy - wy * hx));
}

// ds/dt of the team: the common state's on every lane, the own rotors' lag.
// The thrusts of the R rotors a lane owns are gathered so every lane holds
// all four.
template <class Team, int R>
RAPTOR_HD void team_derivative(const Team& tm, const LaneParams (&lp)[Team::N],
                               const float (&s)[Team::N][COMMON],
                               const float (&u)[Team::N][R],
                               const float (&sp)[Team::N][R],
                               float (&d)[Team::N][COMMON],
                               float (&du)[Team::N][R]) {
  constexpr int N = Team::N;
  float t[N][R], all[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      t[j][k] = lp[j].c0 + lp[j].c1 * u[j][k] + lp[j].c2 * u[j][k] * u[j][k];
    }
  }
  tm.template gather<R, 4>(t, all);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w[c] += all[j][i] * lp[j].d[i][c];
        w[3 + c] += all[j][i] * lp[j].c[i][c];
      }
    }
    body_derivative(lp[j], s[j], w, d[j]);
#pragma unroll
    for (int k = 0; k < R; ++k) du[j][k] = (sp[j][k] - u[j][k]) * lp[j].inv_tm;
  }
}

// One RK4 step of the team, then quaternion renormalize and rpm clip to
// [0, rpm_max] (pallas_rollout.py:220-238).
template <class Team, int R>
RAPTOR_HD void team_rk4(const Team& tm, const LaneParams (&lp)[Team::N],
                        const float (&s)[Team::N][COMMON],
                        const float (&u)[Team::N][R],
                        const float (&sp)[Team::N][R], float dt,
                        float (&out)[Team::N][COMMON], float (&uout)[Team::N][R]) {
  constexpr int N = Team::N;
  float k[N][COMMON], ku[N][R], acc[N][COMMON], accu[N][R], tmp[N][COMMON],
      tmpu[N][R];
  team_derivative(tm, lp, s, u, sp, k, ku);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < COMMON; ++c) {
      acc[j][c] = k[j][c];
      tmp[j][c] = s[j][c] + dt * 0.5f * k[j][c];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      accu[j][c] = ku[j][c];
      tmpu[j][c] = u[j][c] + dt * 0.5f * ku[j][c];
    }
  }
  team_derivative(tm, lp, tmp, tmpu, sp, k, ku);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < COMMON; ++c) {
      acc[j][c] = acc[j][c] + 2.f * k[j][c];
      tmp[j][c] = s[j][c] + dt * 0.5f * k[j][c];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      accu[j][c] = accu[j][c] + 2.f * ku[j][c];
      tmpu[j][c] = u[j][c] + dt * 0.5f * ku[j][c];
    }
  }
  team_derivative(tm, lp, tmp, tmpu, sp, k, ku);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < COMMON; ++c) {
      acc[j][c] = acc[j][c] + 2.f * k[j][c];
      tmp[j][c] = s[j][c] + dt * k[j][c];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      accu[j][c] = accu[j][c] + 2.f * ku[j][c];
      tmpu[j][c] = u[j][c] + dt * ku[j][c];
    }
  }
  team_derivative(tm, lp, tmp, tmpu, sp, k, ku);
  const float dt6 = dt / 6.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < COMMON; ++c) out[j][c] = s[j][c] + dt6 * (acc[j][c] + k[j][c]);
    const float inv_norm =
        1.f / sqrtf(out[j][3] * out[j][3] + out[j][4] * out[j][4] +
                    out[j][5] * out[j][5] + out[j][6] * out[j][6]);
#pragma unroll
    for (int c = 3; c < 7; ++c) out[j][c] *= inv_norm;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      uout[j][c] = clip(u[j][c] + dt6 * (accu[j][c] + ku[j][c]), 0.f, lp[j].rpm_max);
    }
  }
}

// ---------------------------------------------------------------------------
// policy of one lane
// ---------------------------------------------------------------------------

// The weights of hidden width H in team-lane order. Each lane's weights are a
// stream of 16-byte slots in the order it reads them; slot q of lane l lives
// at Vec4 index q * K + l, so a warp-wide 16-byte load reads K neighbouring
// 16-byte words (4K distinct banks, K <= 8) and the teams of a warp share
// them (a broadcast).
template <int H, int K>
struct TeamLayout {
  static_assert(H % K == 0 && H % 4 == 0, "hidden width must split into float4 rows");
  static constexpr int U = H / K;            // hidden units a lane owns
  static constexpr int C = H / 4;            // slots of a GRU row
  static constexpr int OC = (OBS + 3) / 4;   // slots of a w0 row (22 -> 24, zero pad)
  static constexpr int W0 = 0;               // [U][OC]
  static constexpr int BIAS = W0 + U * OC;   // [U][2]: (b0, bi r z n), (bh r z n, 0)
  static constexpr int GRU = BIAS + 2 * U;   // [U][C][6]: wi_r wh_r wi_z wh_z wi_n wh_n
  static constexpr int W2 = GRU + U * C * 6; // [U]: w2[0..3] of the unit
  static constexpr int B2 = W2 + U;          // b2[0..3]
  static constexpr int SLOTS = B2 + 1;       // a lane
  static constexpr int FLOATS = SLOTS * K * 4;
};

// Component e of slot q of lane l, from the flat layout W.
template <int H, int K>
RAPTOR_HD float team_weight(const float* W, int l, int q, int e) {
  using T = TeamLayout<H, K>;
  using L = Layout<H>;
  if (q < T::BIAS) {
    const int i = l * T::U + q / T::OC, j = 4 * (q % T::OC) + e;
    return j < OBS ? W[L::W0 + i * OBS + j] : 0.f;
  }
  if (q < T::GRU) {
    const int i = l * T::U + (q - T::BIAS) / 2;
    if ((q - T::BIAS) % 2 == 0) return e == 0 ? W[L::B0 + i] : W[L::BI + (e - 1) * H + i];
    return e < 3 ? W[L::BH + e * H + i] : 0.f;
  }
  if (q < T::W2) {
    const int r = q - T::GRU, g = r % 6;
    const int i = l * T::U + r / (6 * T::C), j = 4 * ((r / 6) % T::C) + e;
    const int row = (g / 2) * H + i;
    return W[(g % 2 ? L::WH : L::WI) + row * H + j];
  }
  if (q < T::B2) return W[L::W2 + e * H + l * T::U + (q - T::W2)];
  return W[L::B2 + e];
}

// out[k] for k = first, first + step, ... < FLOATS: the team layout of W
template <int H, int K>
RAPTOR_HD void stage_team_weights(const float* W, float* out, int first, int step) {
  for (int k = first; k < TeamLayout<H, K>::FLOATS; k += step) {
    out[k] = team_weight<H, K>(W, (k / 4) % K, k / (4 * K), k % 4);
  }
}

// x_own[u] = relu(b0 + w0 obs) for the lane's units
template <int H, int K>
RAPTOR_HD void dense0_lane(const Vec4* Wt, int l, const float* obs, float* x_own) {
  using T = TeamLayout<H, K>;
#pragma unroll
  for (int u = 0; u < T::U; ++u) {
    float acc = load4(Wt + (T::BIAS + 2 * u) * K + l).x;
#pragma unroll
    for (int c = 0; c < T::OC; ++c) {
      const Vec4 w = load4(Wt + (T::W0 + u * T::OC + c) * K + l);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e < OBS) acc += comp(w, e) * obs[4 * c + e];
      }
    }
    x_own[u] = max_nan(acc, 0.f);
  }
}

// The GRU's new hidden values of the lane's units from the whole x and h
template <int H, int K>
RAPTOR_HD void gru_lane(const Vec4* Wt, int l, const float* x, const float* h,
                        const float* h_own, float* h_new_own) {
  using T = TeamLayout<H, K>;
#pragma unroll
  for (int u = 0; u < T::U; ++u) {
    const Vec4 bi = load4(Wt + (T::BIAS + 2 * u) * K + l);
    const Vec4 bh = load4(Wt + (T::BIAS + 2 * u + 1) * K + l);
    float gi_r = bi.y, gi_z = bi.z, gi_n = bi.w;
    float gh_r = bh.x, gh_z = bh.y, gh_n = bh.z;
#pragma unroll
    for (int c = 0; c < T::C; ++c) {
      const Vec4* row = Wt + (T::GRU + (u * T::C + c) * 6) * K + l;
      const Vec4 wir = load4(row), whr = load4(row + K);
      const Vec4 wiz = load4(row + 2 * K), whz = load4(row + 3 * K);
      const Vec4 win = load4(row + 4 * K), whn = load4(row + 5 * K);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xj = x[4 * c + e], hj = h[4 * c + e];
        gi_r += comp(wir, e) * xj;
        gh_r += comp(whr, e) * hj;
        gi_z += comp(wiz, e) * xj;
        gh_z += comp(whz, e) * hj;
        gi_n += comp(win, e) * xj;
        gh_n += comp(whn, e) * hj;
      }
    }
    const float r = sigmoid(gi_r + gh_r);
    const float z = sigmoid(gi_z + gh_z);
    const float n = tanhf(gi_n + r * gh_n);
    h_new_own[u] = (1.f - z) * n + z * h_own[u];
  }
}

// One policy step of the team's envs, shared by team_eval_env and
// team_collect_env: from each lane's x_own = relu(dense_0 obs) of its units,
// the GRU's new hidden state (h_new whole, h_new_own the lane's units), the
// head's partial sums added over the team, the clipped action and the rpm
// setpoints of the lane's rotors.
template <class Team, int H>
RAPTOR_HD void team_policy_step(const Team& tm, const Vec4* Wt, const LaneParams* lp,
                                const float (*x_own)[TeamLayout<H, Team::SIZE>::U],
                                const float (*h)[H],
                                const float (*h_own)[TeamLayout<H, Team::SIZE>::U],
                                float (*x)[H],
                                float (*h_new_own)[TeamLayout<H, Team::SIZE>::U],
                                float (*h_new)[H], float (*act)[ACT],
                                float (*sp)[TeamShape<Team::SIZE>::R]) {
  constexpr int N = Team::N, K = Team::SIZE;
  using S = TeamShape<K>;
  using T = TeamLayout<H, K>;
  constexpr int R = S::R, U = T::U;
  float part[ACT][N];
  tm.template gather<U>(x_own, x);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    gru_lane<H, K>(Wt, l, x[j], h[j], h_own[j], h_new_own[j]);
#pragma unroll
    for (int a = 0; a < ACT; ++a) part[a][j] = 0.f;
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const Vec4 w2 = load4(Wt + (T::W2 + c) * K + l);
      part[0][j] += w2.x * h_new_own[j][c];
      part[1][j] += w2.y * h_new_own[j][c];
      part[2][j] += w2.z * h_new_own[j][c];
      part[3][j] += w2.w * h_new_own[j][c];
    }
  }
  tm.template gather<U>(h_new_own, h_new);
#pragma unroll
  for (int a = 0; a < ACT; ++a) tm.template sum<K>(part[a]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    const Vec4 b2 = load4(Wt + T::B2 * K + l);
#pragma unroll
    for (int a = 0; a < ACT; ++a) act[j][a] = clip(comp(b2, a) + part[a][j], -1.f, 1.f);
#pragma unroll
    for (int k = 0; k < R; ++k) sp[j][k] = lane_setpoint(lp[j], pick4(act[j], S::rotor(l, k)));
  }
}

// The policy of E envs of a team (team_eval_envs): value arrays are
// [E][Team::N][...] (env, lane this thread runs, entries), and every 16-byte
// weight load serves the E envs before the next. Each env's sums run in the
// order of the functions above on a team of two lanes, whatever the team's K:
// the bias first, then the columns in order; the head's partial sums chained
// over the lanes that a lane of a two-lane team stands for, then the
// butterfly, then the bias. So an env's bits do not depend on K or E.

// x_own[e][j][u] = relu(b0 + w0 obs[e]) for the units of lane l (entry j);
// obs is [E][OBS]
template <int H, int K, int E, int N>
RAPTOR_HD void dense0_envs(const Vec4* Wt, int l, int j, const float* obs,
                           float (*x_own)[N][TeamLayout<H, K>::U]) {
  using T = TeamLayout<H, K>;
#pragma unroll
  for (int u = 0; u < T::U; ++u) {
    const float b0 = load4(Wt + (T::BIAS + 2 * u) * K + l).x;
    float acc[E];
#pragma unroll
    for (int v = 0; v < E; ++v) acc[v] = b0;
#pragma unroll
    for (int c = 0; c < T::OC; ++c) {
      const Vec4 w = load4(Wt + (T::W0 + u * T::OC + c) * K + l);
#pragma unroll
      for (int v = 0; v < E; ++v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * c + e < OBS) acc[v] += comp(w, e) * obs[v * OBS + 4 * c + e];
        }
      }
    }
#pragma unroll
    for (int v = 0; v < E; ++v) x_own[v][j][u] = max_nan(acc[v], 0.f);
  }
}

// The GRU's new hidden values of lane l's units (entry j) from each env's
// whole x and h. The r and z gates take their reciprocal from recip_fast, and
// a unit whose gate left its range takes sigmoid's 1.f / d: the same bits as
// gru_lane's.
template <int H, int K, int E, int N>
RAPTOR_HD void gru_envs(const Vec4* Wt, int l, int j, const float (*x)[N][H],
                        const float (*h)[N][H], const float (*h_own)[N][TeamLayout<H, K>::U],
                        float (*h_new_own)[N][TeamLayout<H, K>::U]) {
  using T = TeamLayout<H, K>;
#pragma unroll
  for (int u = 0; u < T::U; ++u) {
    const Vec4 bi = load4(Wt + (T::BIAS + 2 * u) * K + l);
    const Vec4 bh = load4(Wt + (T::BIAS + 2 * u + 1) * K + l);
    float gi_r[E], gi_z[E], gi_n[E], gh_r[E], gh_z[E], gh_n[E];
#pragma unroll
    for (int v = 0; v < E; ++v) {
      gi_r[v] = bi.y;
      gi_z[v] = bi.z;
      gi_n[v] = bi.w;
      gh_r[v] = bh.x;
      gh_z[v] = bh.y;
      gh_n[v] = bh.z;
    }
#pragma unroll
    for (int c = 0; c < T::C; ++c) {
      const Vec4* row = Wt + (T::GRU + (u * T::C + c) * 6) * K + l;
      const Vec4 wir = load4(row), whr = load4(row + K);
      const Vec4 wiz = load4(row + 2 * K), whz = load4(row + 3 * K);
      const Vec4 win = load4(row + 4 * K), whn = load4(row + 5 * K);
#pragma unroll
      for (int v = 0; v < E; ++v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xj = x[v][j][4 * c + e], hj = h[v][j][4 * c + e];
          gi_r[v] += comp(wir, e) * xj;
          gh_r[v] += comp(whr, e) * hj;
          gi_z[v] += comp(wiz, e) * xj;
          gh_z[v] += comp(whz, e) * hj;
          gi_n[v] += comp(win, e) * xj;
          gh_n[v] += comp(whn, e) * hj;
        }
      }
    }
    // sigmoid(x) = 1.f / d, d = 1.f + expf(-x)
    float dr[E], dz[E], r[E], z[E];
    bool rare = false;
#pragma unroll
    for (int v = 0; v < E; ++v) {
      dr[v] = 1.f + expf(-(gi_r[v] + gh_r[v]));
      dz[v] = 1.f + expf(-(gi_z[v] + gh_z[v]));
      r[v] = recip_fast(dr[v], rare);
      z[v] = recip_fast(dz[v], rare);
    }
    if (rare) {
#pragma unroll
      for (int v = 0; v < E; ++v) {
        r[v] = 1.f / dr[v];
        z[v] = 1.f / dz[v];
      }
    }
#pragma unroll
    for (int v = 0; v < E; ++v) {
      const float n = tanhf(gi_n[v] + r[v] * gh_n[v]);
      h_new_own[v][j][u] = (1.f - z[v]) * n + z[v] * h_own[v][j][u];
    }
  }
}

// One policy step of E envs of the team: from each lane's x_own =
// relu(dense_0 obs) of its units, the GRU's new hidden state (h_new whole,
// h_new_own the lane's units) and every env's clipped action on every lane.
// The head sums as a team of two lanes does: the K / 2 lanes of each half of
// the team chain their partial sums in order (a lane continues the sum of the
// lane before it), then the halves' sums are added, then the bias.
template <class Team, int H, int E>
RAPTOR_HD void team_policy_envs(const Team& tm, const Vec4* Wt,
                                const float (*x_own)[Team::N][TeamLayout<H, Team::SIZE>::U],
                                const float (*h)[Team::N][H],
                                const float (*h_own)[Team::N][TeamLayout<H, Team::SIZE>::U],
                                float (*x)[Team::N][H],
                                float (*h_new_own)[Team::N][TeamLayout<H, Team::SIZE>::U],
                                float (*h_new)[Team::N][H], float (*act)[Team::N][ACT]) {
  constexpr int N = Team::N, K = Team::SIZE, G = K / 2;
  static_assert(K % 2 == 0, "the head sums as a team of two lanes");
  using T = TeamLayout<H, K>;
  constexpr int U = T::U;
  float part[E][ACT][N];
#pragma unroll
  for (int v = 0; v < E; ++v) tm.template gather<U>(x_own[v], x[v]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    gru_envs<H, K, E, N>(Wt, tm.lane(j), j, x, h, h_own, h_new_own);
#pragma unroll
    for (int v = 0; v < E; ++v) {
#pragma unroll
      for (int a = 0; a < ACT; ++a) part[v][a][j] = 0.f;
    }
  }
  // round g: lane l with l % G == g continues the chain its predecessor
  // handed on (lanes at 0 start from 0); the other lanes' work is redone
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g > 0) {
#pragma unroll
      for (int v = 0; v < E; ++v) {
#pragma unroll
        for (int a = 0; a < ACT; ++a) tm.template hand_on<G>(part[v][a]);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int l = tm.lane(j);
#pragma unroll
      for (int c = 0; c < U; ++c) {
        const Vec4 w2 = load4(Wt + (T::W2 + c) * K + l);
#pragma unroll
        for (int v = 0; v < E; ++v) {
          part[v][0][j] += w2.x * h_new_own[v][j][c];
          part[v][1][j] += w2.y * h_new_own[v][j][c];
          part[v][2][j] += w2.z * h_new_own[v][j][c];
          part[v][3][j] += w2.w * h_new_own[v][j][c];
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < E; ++v) tm.template gather<U>(h_new_own[v], h_new[v]);
#pragma unroll
  for (int v = 0; v < E; ++v) {
#pragma unroll
    for (int a = 0; a < ACT; ++a) tm.template halves<G>(part[v][a]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const Vec4 b2 = load4(Wt + T::B2 * K + tm.lane(j));
#pragma unroll
    for (int v = 0; v < E; ++v) {
#pragma unroll
      for (int a = 0; a < ACT; ++a) act[v][j][a] = clip(comp(b2, a) + part[v][a][j], -1.f, 1.f);
    }
  }
}

// The rpm setpoints of each lane's rotors from one env's action
template <class Team>
RAPTOR_HD void team_setpoints(const Team& tm, const LaneParams* lp, const float (*act)[ACT],
                              float (*sp)[TeamShape<Team::SIZE>::R]) {
  using S = TeamShape<Team::SIZE>;
#pragma unroll
  for (int j = 0; j < Team::N; ++j) {
#pragma unroll
    for (int k = 0; k < S::R; ++k) {
      sp[j][k] = lane_setpoint(lp[j], pick4(act[j], S::rotor(tm.lane(j), k)));
    }
  }
}

// ---------------------------------------------------------------------------
// the per-env loops
// ---------------------------------------------------------------------------

// Env i of n, flown by the team `tm`: n_steps RK4 steps under its constant
// action. A terminated env keeps its pre-step state and its team leaves the
// loop; the step it dies on counts toward its length. stats is [2, n]:
// alive, length.
template <class Team>
RAPTOR_HD void team_rollout_env(const Team& tm, long i, long n, const float* params,
                                const float* state, const float* action,
                                float* state_out, float* stats, int n_steps,
                                float dt, Bounds b) {
  constexpr int N = Team::N;
  using S = TeamShape<Team::SIZE>;
  constexpr int R = S::R;
  const ParamColumn P{params + i, n};
  LaneParams lp[N];
  float s[N][COMMON], u[N][R], sp[N][R], s2[N][COMMON], u2[N][R];
  int done[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    lp[j] = lane_params(P);
#pragma unroll
    for (int c = 0; c < COMMON; ++c) s[j][c] = load_ro(state + c * n + i);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int rot = S::rotor(l, k);
      u[j][k] = load_ro(state + (COMMON + rot) * n + i);
      sp[j][k] = lane_setpoint(lp[j], load_ro(action + rot * n + i));
    }
  }
  float alive = 1.f, length = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    team_rk4(tm, lp, s, u, sp, dt, s2, u2);
    length += 1.f;
#pragma unroll
    for (int j = 0; j < N; ++j) done[j] = terminated(s2[j], b);
    tm.bcast0(done);
    if (done[0]) {
      alive = 0.f;
      break;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int c = 0; c < COMMON; ++c) s[j][c] = s2[j][c];
#pragma unroll
      for (int k = 0; k < R; ++k) u[j][k] = u2[j][k];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    if (l == 0) {
#pragma unroll
      for (int c = 0; c < COMMON; ++c) state_out[c * n + i] = s[j][c];
      stats[i] = alive;
      stats[n + i] = length;
    }
    if (l < S::RL) {
#pragma unroll
      for (int k = 0; k < R; ++k) state_out[(COMMON + S::rotor(l, k)) * n + i] = u[j][k];
    }
  }
}

// Env i of n, flown by the team `tm` (the eval kernel where E = 1): a whole
// closed-loop episode of n_steps (obs -> policy -> clip -> setpoint -> RK4 ->
// reward -> termination). Wt is
// the team layout of the weights, W the flat layout (for h0). Reward and
// length accrue while alive at step start; a terminated env keeps its
// pre-step state, hidden state and previous action, and its team leaves the
// loop. stats is [3, n]: alive, length, return.
template <class Team, int H>
RAPTOR_HD void team_eval_env(const Team& tm, long i, long n, const Vec4* Wt,
                             const float* W, const float* params,
                             const float* state, float* state_out, float* stats,
                             int n_steps, float dt, Bounds b, RewardWeights rw) {
  constexpr int N = Team::N, K = Team::SIZE;
  using S = TeamShape<K>;
  using T = TeamLayout<H, K>;
  constexpr int R = S::R, U = T::U;
  const ParamColumn P{params + i, n};
  LaneParams lp[N];
  float s[N][COMMON], u[N][R], sp[N][R], s2[N][COMMON], u2[N][R];
  float h[N][H], h_new[N][H], h_own[N][U], h_new_own[N][U], x_own[N][U], x[N][H];
  float prev[N][ACT], act[N][ACT], hover[N], ret[N];
  int done[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    lp[j] = lane_params(P);
#pragma unroll
    for (int c = 0; c < COMMON; ++c) s[j][c] = load_ro(state + c * n + i);
#pragma unroll
    for (int k = 0; k < R; ++k) u[j][k] = load_ro(state + (COMMON + S::rotor(l, k)) * n + i);
#pragma unroll
    for (int c = 0; c < H; ++c) h[j][c] = load_ro(W + Layout<H>::H0 + c);
#pragma unroll
    for (int c = 0; c < U; ++c) h_own[j][c] = load_ro(W + Layout<H>::H0 + l * U + c);
#pragma unroll
    for (int c = 0; c < ACT; ++c) prev[j][c] = 0.f;
    hover[j] = hover_action(P);
    ret[j] = 0.f;
  }
  float alive = 1.f, length = 0.f;
  for (int t = 0; t < n_steps; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float obs[OBS];
      observe22(s[j], prev[j], obs);
      dense0_lane<H, K>(Wt, tm.lane(j), obs, x_own[j]);
    }
    team_policy_step<Team, H>(tm, Wt, lp, x_own, h, h_own, x, h_new_own, h_new, act, sp);
    team_rk4(tm, lp, s, u, sp, dt, s2, u2);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ret[j] += reward(s2[j], act[j], hover[j], rw);
      done[j] = terminated(s2[j], b);
    }
    length += 1.f;
    tm.bcast0(done);
    if (done[0]) {
      alive = 0.f;
      break;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int c = 0; c < COMMON; ++c) s[j][c] = s2[j][c];
#pragma unroll
      for (int k = 0; k < R; ++k) u[j][k] = u2[j][k];
#pragma unroll
      for (int c = 0; c < H; ++c) h[j][c] = h_new[j][c];
#pragma unroll
      for (int c = 0; c < U; ++c) h_own[j][c] = h_new_own[j][c];
#pragma unroll
      for (int a = 0; a < ACT; ++a) prev[j][a] = act[j][a];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    if (l == 0) {
#pragma unroll
      for (int c = 0; c < COMMON; ++c) state_out[c * n + i] = s[j][c];
      stats[i] = alive;
      stats[n + i] = length;
      stats[2 * n + i] = ret[j];
    }
    if (l < S::RL) {
#pragma unroll
      for (int k = 0; k < R; ++k) state_out[(COMMON + S::rotor(l, k)) * n + i] = u[j][k];
    }
  }
}

// The E envs team, team + n_teams, ... (those below n) of n, flown by the
// team `tm` of K lanes (the eval kernel where E > 1; n_teams = ceil(n / E), so
// the teams of a warp read neighbouring columns for each env): whole
// closed-loop episodes of n_steps, as team_eval_env flies one. Env v's
// physics runs on the sub-team of lanes v * Q .. v * Q + Q - 1 (Q = K / E),
// split by rotor as team_eval_env splits it over a team of Q; each lane
// holds its env's state, rotor lag, parameters and previous action, and
// every env's hidden state. The policy of all E envs is split by hidden unit
// over the K lanes, so every weight a lane loads serves the E envs. Each
// sub-team observes its env and the observations reach every lane by the
// team's shuffles; every lane then holds every env's action. A terminated env
// keeps its pre-step state by a select and rides along; the team leaves the
// loop when every env of its lanes is done, by `tm.all` (on the card the
// team's mask is the whole warp's: the warp runs every step together). A slot
// past n, and every slot of a team past the last (team >= n_teams), flies
// env 0 from the start as done and is never stored. stats is [3, n]: alive,
// length, return.
template <class Team, int H, int E>
RAPTOR_HD void team_eval_envs(const Team& tm, long team, long n_teams, long n,
                              const Vec4* Wt, const float* W, const float* params,
                              const float* state, float* state_out, float* stats,
                              int n_steps, float dt, Bounds b, RewardWeights rw) {
  constexpr int N = Team::N, K = Team::SIZE, Q = K / E;
  static_assert(K % E == 0, "E envs split the team into sub-teams of K / E lanes");
  const auto sub = tm.template sub<Q>();
  using Sub = decltype(sub);
  using S = TeamShape<Q>;
  using T = TeamLayout<H, K>;
  constexpr int U = T::U, R = S::R, NS = Sub::N, G = N / NS;
  // this thread's lane j = g * NS + js is lane lane(j) % Q of the sub-team of
  // env lane(j) / Q: one sub-team on the card, all E on the host
  long idx[G];
  int dead[G], done[G][NS];
  LaneParams lp[G][NS];
  float s[G][NS][COMMON], u[G][NS][R], sp[G][NS][R], s2[G][NS][COMMON], u2[G][NS][R];
  float a[G][NS][ACT], prev[G][NS][ACT], hover[G][NS], ret[G][NS], length[G];
  // every env's policy state
  float h[E][N][H], h_new[E][N][H], h_own[E][N][U], h_new_own[E][N][U], x_own[E][N][U],
      x[E][N][H], act[E][N][ACT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    idx[g] = team + tm.lane(g * NS) / Q * n_teams;
    dead[g] = team >= n_teams || idx[g] >= n;
    length[g] = 0.f;
    const long i = dead[g] ? 0 : idx[g];
    const ParamColumn P{params + i, n};
#pragma unroll
    for (int js = 0; js < NS; ++js) {
      const int ls = sub.lane(js);
      lp[g][js] = lane_params(P);
#pragma unroll
      for (int c = 0; c < COMMON; ++c) s[g][js][c] = load_ro(state + c * n + i);
#pragma unroll
      for (int k = 0; k < R; ++k) u[g][js][k] = load_ro(state + (COMMON + S::rotor(ls, k)) * n + i);
#pragma unroll
      for (int c = 0; c < ACT; ++c) prev[g][js][c] = 0.f;
      hover[g][js] = hover_action(P);
      ret[g][js] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const float h0 = load_ro(W + Layout<H>::H0 + c);
#pragma unroll
      for (int v = 0; v < E; ++v) h[v][j][c] = h0;
    }
#pragma unroll
    for (int c = 0; c < U; ++c) {
      const float h0 = load_ro(W + Layout<H>::H0 + tm.lane(j) * U + c);
#pragma unroll
      for (int v = 0; v < E; ++v) h_own[v][j][c] = h0;
    }
  }
  for (int t = 0; t < n_steps; ++t) {
    float own[N][OBS], obs[N][E * OBS];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int js = 0; js < NS; ++js) observe22(s[g][js], prev[g][js], own[g * NS + js]);
    }
    tm.template gather<OBS, E * OBS, Q>(own, obs);  // obs[j] is [E][OBS]: env v from lane v * Q
#pragma unroll
    for (int j = 0; j < N; ++j) dense0_envs<H, K, E, N>(Wt, tm.lane(j), j, obs[j], x_own);
    team_policy_envs<Team, H, E>(tm, Wt, x_own, h, h_own, x, h_new_own, h_new, act);
    int all_dead[N];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int js = 0; js < NS; ++js) {
        const int j = g * NS + js, v = tm.lane(j) / Q;
#pragma unroll
        for (int c = 0; c < ACT; ++c) {  // the action of the lane's env, by selects
          a[g][js][c] = act[0][j][c];
#pragma unroll
          for (int w = 1; w < E; ++w) a[g][js][c] = v == w ? act[w][j][c] : a[g][js][c];
        }
      }
      team_setpoints(sub, lp[g], a[g], sp[g]);
      team_rk4(sub, lp[g], s[g], u[g], sp[g], dt, s2[g], u2[g]);
      const bool was = dead[g] != 0;
#pragma unroll
      for (int js = 0; js < NS; ++js) {
        const float r = reward(s2[g][js], a[g][js], hover[g][js], rw);
        ret[g][js] = was ? ret[g][js] : ret[g][js] + r;
        done[g][js] = terminated(s2[g][js], b);
      }
      sub.bcast0(done[g]);
      length[g] = was ? length[g] : length[g] + 1.f;
      dead[g] = was || done[g][0];
#pragma unroll
      for (int js = 0; js < NS; ++js) {
#pragma unroll
        for (int c = 0; c < COMMON; ++c) s[g][js][c] = dead[g] ? s[g][js][c] : s2[g][js][c];
#pragma unroll
        for (int k = 0; k < R; ++k) u[g][js][k] = dead[g] ? u[g][js][k] : u2[g][js][k];
#pragma unroll
        for (int c = 0; c < ACT; ++c) prev[g][js][c] = a[g][js][c];
        all_dead[g * NS + js] = dead[g];
      }
    }
    // an env that ended flies on with what no output reads
#pragma unroll
    for (int v = 0; v < E; ++v) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int c = 0; c < H; ++c) h[v][j][c] = h_new[v][j][c];
#pragma unroll
        for (int c = 0; c < U; ++c) h_own[v][j][c] = h_new_own[v][j][c];
      }
    }
    if (tm.all(all_dead)) break;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long i = idx[g];
    if (team >= n_teams || i >= n) continue;
#pragma unroll
    for (int js = 0; js < NS; ++js) {
      const int ls = sub.lane(js);
      if (ls == 0) {
#pragma unroll
        for (int c = 0; c < COMMON; ++c) state_out[c * n + i] = s[g][js][c];
        stats[i] = dead[g] ? 0.f : 1.f;
        stats[n + i] = length[g];
        stats[2 * n + i] = ret[g][js];
      }
      if (ls < S::RL) {
#pragma unroll
        for (int k = 0; k < R; ++k) state_out[(COMMON + S::rotor(ls, k)) * n + i] = u[g][js][k];
      }
    }
  }
}

constexpr int COLLECT_CH = OBS + 1;  // 22 observation channels + done flag

// Env i of n, flown by the team `tm`: n_steps closed-loop steps of the student
// with auto-reset (pallas_collect.py:291-359). Wt is the team layout of the
// weights, W the flat layout (for h0). out is channel-major [n_steps, 23, n]:
// row t holds the observation before step t (channels 0-21; lane l stores the
// channels c with c % K == l, every lane holds the whole observation) and the
// done flag after it (channel 22, from lane 0). On done (the full termination
// predicate, or the env's own step count reaching episode_length; broadcast
// from lane 0, so a team cannot split) the whole team takes the reset branch:
// each lane draws the whole fresh state from (seed, env_offset + i, t), a
// deterministic counter, and keeps the common state and its own rotors; h and
// h_own go back to h0, the previous action and the step count to 0. The state
// is replaced, never blended, so a non-finite terminated state is really
// gone. The airframe is fixed across resets, so each lane keeps its
// LaneParams.
template <class Team, int H>
RAPTOR_HD void team_collect_env(const Team& tm, long i, long n, const Vec4* Wt,
                                const float* W, const float* params,
                                const float* state, float* out, int n_steps,
                                float dt, float episode_length, Bounds b,
                                InitSpec init, uint32_t seed, uint32_t env_offset) {
  constexpr int N = Team::N, K = Team::SIZE;
  using S = TeamShape<K>;
  using T = TeamLayout<H, K>;
  constexpr int R = S::R, U = T::U, W_H0 = Layout<H>::H0;
  const ParamColumn P{params + i, n};
  LaneParams lp[N];
  float s[N][COMMON], u[N][R], sp[N][R], s2[N][COMMON], u2[N][R];
  float h[N][H], h_new[N][H], h_own[N][U], h_new_own[N][U], x_own[N][U], x[N][H];
  float prev[N][ACT], act[N][ACT];
  int done[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int l = tm.lane(j);
    lp[j] = lane_params(P);
#pragma unroll
    for (int c = 0; c < COMMON; ++c) s[j][c] = load_ro(state + c * n + i);
#pragma unroll
    for (int k = 0; k < R; ++k) u[j][k] = load_ro(state + (COMMON + S::rotor(l, k)) * n + i);
#pragma unroll
    for (int c = 0; c < H; ++c) h[j][c] = load_ro(W + W_H0 + c);
#pragma unroll
    for (int c = 0; c < U; ++c) h_own[j][c] = load_ro(W + W_H0 + l * U + c);
#pragma unroll
    for (int c = 0; c < ACT; ++c) prev[j][c] = 0.f;
  }
  const uint32_t env_id = env_offset + static_cast<uint32_t>(i);
  float tcount = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    float* row = out + static_cast<long>(t) * COLLECT_CH * n + i;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int l = tm.lane(j);
      float obs[OBS];
      observe22(s[j], prev[j], obs);
#pragma unroll
      for (int c = 0; c < OBS; ++c) {
        if (c % K == l) row[c * n] = obs[c];
      }
      dense0_lane<H, K>(Wt, l, obs, x_own[j]);
    }
    team_policy_step<Team, H>(tm, Wt, lp, x_own, h, h_own, x, h_new_own, h_new, act, sp);
    team_rk4(tm, lp, s, u, sp, dt, s2, u2);
    const float t2 = tcount + 1.f;
#pragma unroll
    for (int j = 0; j < N; ++j) done[j] = terminated(s2[j], b) || t2 > episode_length - 0.5f;
    tm.bcast0(done);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (tm.lane(j) == 0) row[OBS * n] = done[j] ? 1.f : 0.f;
    }
    if (done[0]) {
      const uint32_t ctr = reset_counter(env_id, seed, static_cast<uint32_t>(t));
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int l = tm.lane(j);
        float fresh[N_STATE];
        sample_state(P, ctr, init, fresh);
#pragma unroll
        for (int c = 0; c < COMMON; ++c) s[j][c] = fresh[c];
#pragma unroll
        for (int k = 0; k < R; ++k) u[j][k] = pick4(fresh + COMMON, S::rotor(l, k));
#pragma unroll
        for (int c = 0; c < H; ++c) h[j][c] = load_ro(W + W_H0 + c);
#pragma unroll
        for (int c = 0; c < U; ++c) h_own[j][c] = load_ro(W + W_H0 + l * U + c);
#pragma unroll
        for (int c = 0; c < ACT; ++c) prev[j][c] = 0.f;
      }
      tcount = 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int c = 0; c < COMMON; ++c) s[j][c] = s2[j][c];
#pragma unroll
        for (int k = 0; k < R; ++k) u[j][k] = u2[j][k];
#pragma unroll
        for (int c = 0; c < H; ++c) h[j][c] = h_new[j][c];
#pragma unroll
        for (int c = 0; c < U; ++c) h_own[j][c] = h_new_own[j][c];
#pragma unroll
        for (int a = 0; a < ACT; ++a) prev[j][a] = act[j][a];
      }
      tcount = t2;
    }
  }
}

}  // namespace raptor
