// Backpropagation through time of the student over one [T]-step sequence:
// the forward (Dense(22->H, ReLU) -> GRU(H) -> Dense(H->4), the hidden state
// restarting at the learned h0 where the sequence entered a reset) and its
// backward in reverse, shared by the CUDA kernels (bptt.cu) and the host shim
// (host_shim.cpp) that the CPU tests build with g++.
//
// One sequence is one block of threads. A step runs in two phases with a
// block barrier after each; every vector a phase hands on (x, the gate
// pre-activations, h, the gradients of a step) goes through shared memory,
// where the staged weights also live. A barrier waits for every load its
// threads have in flight, so no phase of a step reads device memory: the
// inputs of CHUNK steps at a time come into a window in shared memory in one
// phase of their own. The block goes through a Block: DeviceBlock<NT> is one
// thread a slot and its sync() is __syncthreads(); HostBlock<NT> runs the NT
// slots of a phase one after another in one host thread, so a phase boundary
// is the barrier. Values a thread holds across phases are arrays
// [Block::N]: one entry on the card, NT on the host.
//
// Forward, step t (thread roles: Bptt<H>::A_X and the like), the work off the
// recurrence one step ahead:
//   A. gh = wh h_in + bh (3H threads); x of step t + 1 = relu(w0 obs + b0);
//      the action of step t - 1 from h (the head, no clip);
//   B. the gates r, z, n and h_i of step t (H threads, h_in in a register),
//      then h entering step t + 1 (h0 where reset[t] != 0; h0 also enters
//      step 0); gi = wi x + bi of step t + 1.
// The chain of a step is one H-long dot product, the gates and two barriers.
// It saves, a step and sequence, h entering, x, r, z, n and wh_n h + bh_n
// (6H floats) for the backward.
//
// Backward, t = T - 1 ... 0, with dh (the gradient of h after step t) in
// thread i < H's register; threads [0, CHAIN) run the chain, the others own
// the gradient entries:
//   P. i < H: the step's saved values from the window, h recomputed from
//      them, dh += w2^T dA, then the gradients of the gate pre-activations
//      dgi = (dr, dz, dn) and dgh = (dr, dz, dn * r);
//   Q. i < H: the carry dh_in = wh^T dgh + z * dh, which goes to h0's
//      gradient where the step entered a reset (and dh becomes 0), else to
//      dh; in the next warps, dx = wi^T dgi through the ReLU's mask;
//   R. after Q's barrier, while the chain goes on to step t - 1, each
//      gradient thread adds the step's share to the entries it owns: every
//      entry of the flat gradient is u * v for one u of
//      (dx | dgi | dgh | dh0 | dA) and one v of (obs | x | h_in | h | 1)
//      (operand_pair, a table in shared memory); thread CHAIN + j owns
//      entries j, j + NT - CHAIN, ... and sums them in registers.
// The operands of a step live in one of two buffers by the step's parity, so
// R needs no barrier of its own. Each sequence writes its own row of the
// gradient; bptt_reduce_entry sums the rows of all sequences in a fixed
// order. No atomics: the same inputs give the same bits.
#pragma once

#include <cstring>

#include "quad_step.cuh"

namespace raptor {

// the student's nine leaves (policy.network): w0 [H, 22], b0 [H], wi [3H, H],
// wh [3H, H], bi [3H], bh [3H], h0 [H], w2 [4, H], b2 [4]
struct StudentLeaves {
  const float *w0, *b0, *wi, *wh, *bi, *bh, *h0, *w2, *b2;
};

constexpr int round_warp(int n) { return (n + 31) / 32 * 32; }

template <int H>
struct Bptt {
  static constexpr int CHUNK = 32;  // steps a window of inputs holds
  // shared memory, in floats: the weights, rows of w0 padded to 23 and rows
  // of wi, wh, w2 to H + 1 (odd strides: a row a thread and a column a thread
  // both read without bank conflicts)
  static constexpr int OP = OBS + 1;
  static constexpr int HP = H + 1;
  static constexpr int W0 = 0;
  static constexpr int B0 = W0 + H * OP;
  static constexpr int WI = B0 + H;
  static constexpr int WH = WI + 3 * H * HP;
  static constexpr int BI = WH + 3 * H * HP;
  static constexpr int BH = BI + 3 * H;
  static constexpr int H0 = BH + 3 * H;
  static constexpr int W2 = H0 + H;
  static constexpr int B2 = W2 + ACT * HP;
  static constexpr int WEIGHTS = B2 + ACT;
  // the forward: a window of CHUNK + 1 steps, a row obs [22] | reset; x,
  // wi x + bi (two, by the step's parity), wh h_in + bh, h entering, h after
  static constexpr int F_WIN = WEIGHTS;
  static constexpr int F_X = F_WIN + (CHUNK + 1) * OP;
  static constexpr int F_GI = F_X + H;
  static constexpr int F_GH = F_GI + 6 * H;
  static constexpr int F_HIN = F_GH + 3 * H;
  static constexpr int F_H = F_HIN + H;
  static constexpr int FORWARD = F_H + H;
  // saved a step and sequence: rows h_in, x, r, z, n, ghn of H
  static constexpr int SAVED = 6 * H;
  // the backward: a window of CHUNK steps, a row saved [6H] | obs [22] |
  // dA [4] | entered a reset; the operands of a step, two buffers of each:
  // U = dx | dgi [3H] | dgh [3H] | dh0 | dA [4] | 0 and
  // V = obs [22] | x | h_in | h | 1
  static constexpr int R_OBS = SAVED;
  static constexpr int R_DA = R_OBS + OBS;
  static constexpr int R_FRESH = R_DA + ACT;
  static constexpr int ROW = R_FRESH + 1;
  static constexpr int U_DX = 0;
  static constexpr int U_DGI = H;
  static constexpr int U_DGH = 4 * H;
  static constexpr int U_DH0 = 7 * H;
  static constexpr int U_DA = 8 * H;
  static constexpr int U_ZERO = U_DA + ACT;
  static constexpr int U_SIZE = U_ZERO + 1;
  static constexpr int V_OBS = 0;
  static constexpr int V_X = OBS;
  static constexpr int V_HIN = V_X + H;
  static constexpr int V_H = V_HIN + H;
  static constexpr int V_ONE = V_H + H;
  static constexpr int V_SIZE = V_ONE + 1;
  static constexpr int B_WIN = WEIGHTS;
  static constexpr int B_U = B_WIN + CHUNK * ROW;
  static constexpr int B_V = B_U + 2 * U_SIZE;
  static constexpr int B_IDX = B_V + 2 * V_SIZE;  // operand_pair of each owned entry
  static constexpr int TOTAL = Layout<H>::TOTAL;
  // the forward's threads by role, each role from a warp's start: in phase
  // A wh h_in + bh [0, 3H), x [A_X, A_X + H), the head [A_HEAD, A_HEAD + 4);
  // in phase B the gates [0, H), wi x + bi [B_GI, B_GI + 3H)
  static constexpr int A_X = round_warp(3 * H);
  static constexpr int A_HEAD = round_warp(A_X + H);
  static constexpr int B_GI = round_warp(H);
  static constexpr int FWD_THREADS =
      round_warp(A_HEAD + ACT > B_GI + 3 * H ? A_HEAD + ACT : B_GI + 3 * H);
  // the backward's threads: dh's H [0, H) and dx's H [B_DX, B_DX + H), each
  // from a warp's start, then enough warps that a gradient thread owns at
  // most MAX_ACC entries: 32 up to H = 24, where the step's chain sets the
  // pace and more warps hide the entries behind it; 64 above, where the
  // entries' shared-memory reads do and fewer warps contend (PERF.md, B5)
  static constexpr int B_DX = round_warp(H);
  static constexpr int CHAIN = B_DX + round_warp(H);
  static constexpr int MAX_ACC = H <= 24 ? 32 : 64;
  static constexpr int GRAD_THREADS = round_warp((TOTAL + MAX_ACC - 1) / MAX_ACC);
  static constexpr int BWD_THREADS = CHAIN + GRAD_THREADS;
  static constexpr int ACC = (TOTAL + GRAD_THREADS - 1) / GRAD_THREADS;
  // entry m of gradient thread j's operand pair at B_IDX + m * GRAD_THREADS + j
  static constexpr int BACKWARD = B_IDX + ACC * GRAD_THREADS;
  static constexpr int SHARED = FORWARD > BACKWARD ? FORWARD : BACKWARD;
  static_assert(GRAD_THREADS >= OBS + ACT, "the gradient threads copy obs and dA");
  static_assert(U_SIZE < 65536 && V_SIZE < 65536, "operand_pair packs 16 bits each");
};

template <int NT>
struct DeviceBlock {
  static constexpr int N = 1;  // slots this thread runs
  static constexpr int THREADS = NT;
  int t;
  RAPTOR_HD int tid(int) const { return t; }
  RAPTOR_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

template <int NT>
struct HostBlock {
  static constexpr int N = NT;
  static constexpr int THREADS = NT;
  int tid(int s) const { return s; }
  void sync() const {}
};

// an operand pair kept in shared memory as the bits of a float
RAPTOR_HD float bits_float(unsigned u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
#endif
}

RAPTOR_HD unsigned float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
#endif
}

// init + sum_k a[k * SA] * b[k], k < NTERM, in four interleaved partial sums
template <int NTERM, int SA>
RAPTOR_HD float dot(float init, const float* a, const float* b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NTERM; ++k) p[k % 4] += a[k * SA] * b[k];
  return init + ((p[0] + p[1]) + (p[2] + p[3]));
}

// the weights into their shared-memory layout (Bptt<H>), thread tid of nt
template <int H>
RAPTOR_HD void stage_student(const StudentLeaves& w, float* sm, int tid, int nt) {
  using S = Bptt<H>;
  for (int e = tid; e < H * OBS; e += nt) sm[S::W0 + e / OBS * S::OP + e % OBS] = w.w0[e];
  for (int e = tid; e < 3 * H * H; e += nt) {
    sm[S::WI + e / H * S::HP + e % H] = w.wi[e];
    sm[S::WH + e / H * S::HP + e % H] = w.wh[e];
  }
  for (int e = tid; e < ACT * H; e += nt) sm[S::W2 + e / H * S::HP + e % H] = w.w2[e];
  for (int e = tid; e < 3 * H; e += nt) {
    sm[S::BI + e] = w.bi[e];
    sm[S::BH + e] = w.bh[e];
  }
  for (int e = tid; e < H; e += nt) {
    sm[S::B0 + e] = w.b0[e];
    sm[S::H0 + e] = w.h0[e];
  }
  for (int e = tid; e < ACT; e += nt) sm[S::B2 + e] = w.b2[e];
}

// The forward's window from step t0: CHUNK + 1 rows of obs [22] | reset
// (zeros past the last step), then the barrier.
template <class Blk, int H>
RAPTOR_HD void forward_window(const Blk& blk, float* sm, const float* obs, const float* reset,
                              int t0, int T, int B, long b) {
  using S = Bptt<H>;
  for (int s = 0; s < Blk::N; ++s) {
    for (int e = blk.tid(s); e < (S::CHUNK + 1) * S::OP; e += Blk::THREADS) {
      const int t = t0 + e / S::OP, c = e % S::OP;
      const long row = static_cast<long>(t) * B + b;
      sm[S::F_WIN + e] = t >= T ? 0.f : c < OBS ? obs[row * OBS + c] : reset[row];
    }
  }
  blk.sync();
}

// Forward of sequence b of the [T, B] batch (the weights staged in sm):
// actions [T, B, 4]; saved [T, B, 6, H], or nullptr to save nothing.
template <class Blk, int H>
RAPTOR_HD void bptt_forward_seq(const Blk& blk, float* sm, const float* obs,
                                const float* reset, float* actions, float* saved,
                                int T, int B, long b) {
  using S = Bptt<H>;
  constexpr int N = Blk::N;
  if (T <= 0) return;
  float hin[N];
  forward_window<Blk, H>(blk, sm, obs, reset, 0, T, B, b);
  // x of step 0; h entering step 0 is h0
  for (int s = 0; s < N; ++s) {
    const int i = blk.tid(s);
    if (i >= S::A_X && i < S::A_X + H) {
      const int j = i - S::A_X;
      const float pre = dot<OBS, 1>(sm[S::B0 + j], sm + S::W0 + j * S::OP, sm + S::F_WIN);
      sm[S::F_X + j] = pre > 0.f ? pre : 0.f;
      if (saved) saved[b * S::SAVED + H + j] = sm[S::F_X + j];
    }
    if (i < H) {
      hin[s] = sm[S::H0 + i];
      sm[S::F_HIN + i] = hin[s];
    }
  }
  blk.sync();
  // wi x + bi of step 0
  for (int s = 0; s < N; ++s) {
    const int i = blk.tid(s);
    if (i >= S::B_GI && i < S::B_GI + 3 * H) {
      const int r = i - S::B_GI;
      sm[S::F_GI + r] = dot<H, 1>(sm[S::BI + r], sm + S::WI + r * S::HP, sm + S::F_X);
    }
  }
  blk.sync();
  for (int t = 0; t < T; ++t) {
    const int t0 = t - t % S::CHUNK;
    if (t > 0 && t == t0) forward_window<Blk, H>(blk, sm, obs, reset, t0, T, B, b);
    // A. wh h_in + bh of step t; x of step t + 1; the action of step t - 1
    for (int s = 0; s < N; ++s) {
      const int i = blk.tid(s);
      if (i < 3 * H) {
        sm[S::F_GH + i] = dot<H, 1>(sm[S::BH + i], sm + S::WH + i * S::HP, sm + S::F_HIN);
      } else if (i >= S::A_X && i < S::A_X + H && t + 1 < T) {
        const int j = i - S::A_X;
        const float pre = dot<OBS, 1>(sm[S::B0 + j], sm + S::W0 + j * S::OP,
                                      sm + S::F_WIN + (t + 1 - t0) * S::OP);
        const float x = pre > 0.f ? pre : 0.f;
        sm[S::F_X + j] = x;
        if (saved) saved[((t + 1L) * B + b) * S::SAVED + H + j] = x;
      } else if (i >= S::A_HEAD && i < S::A_HEAD + ACT && t > 0) {
        const int k = i - S::A_HEAD;
        actions[((t - 1L) * B + b) * ACT + k] =
            dot<H, 1>(sm[S::B2 + k], sm + S::W2 + k * S::HP, sm + S::F_H);
      }
    }
    blk.sync();
    // B. the gates and h of step t, and h entering step t + 1; wi x + bi of
    // step t + 1
    for (int s = 0; s < N; ++s) {
      const int i = blk.tid(s);
      if (i < H) {
        const float* gi = sm + S::F_GI + (t & 1) * 3 * H;
        const float* gh = sm + S::F_GH;
        const float r = sigmoid(gi[i] + gh[i]);
        const float z = sigmoid(gi[H + i] + gh[H + i]);
        const float ghn = gh[2 * H + i];
        const float n = tanhf(gi[2 * H + i] + r * ghn);
        const float h = (1.f - z) * n + z * hin[s];
        sm[S::F_H + i] = h;
        if (saved) {
          float* sv = saved + (static_cast<long>(t) * B + b) * S::SAVED;
          sv[i] = hin[s];
          sv[2 * H + i] = r;
          sv[3 * H + i] = z;
          sv[4 * H + i] = n;
          sv[5 * H + i] = ghn;
        }
        const bool fresh = sm[S::F_WIN + (t - t0) * S::OP + OBS] != 0.f;  // reset[t]
        hin[s] = fresh ? sm[S::H0 + i] : h;
        sm[S::F_HIN + i] = hin[s];
      } else if (i >= S::B_GI && i < S::B_GI + 3 * H && t + 1 < T) {
        const int r = i - S::B_GI;
        sm[S::F_GI + ((t + 1) & 1) * 3 * H + r] =
            dot<H, 1>(sm[S::BI + r], sm + S::WI + r * S::HP, sm + S::F_X);
      }
    }
    blk.sync();
  }
  for (int s = 0; s < N; ++s) {
    const int i = blk.tid(s);
    if (i >= S::A_HEAD && i < S::A_HEAD + ACT) {
      const int k = i - S::A_HEAD;
      actions[((T - 1L) * B + b) * ACT + k] =
          dot<H, 1>(sm[S::B2 + k], sm + S::W2 + k * S::HP, sm + S::F_H);
    }
  }
}

// The operands of flat gradient entry f (the flat policy layout, Layout<H>):
// its offset in U | its offset in V << 16. Past the layout: 0 * 1.
template <int H>
RAPTOR_HD unsigned operand_pair(int f) {
  using S = Bptt<H>;
  using L = Layout<H>;
  int u = S::U_ZERO, v = S::V_ONE;
  if (f < L::B0) {
    u = S::U_DX + f / OBS;
    v = S::V_OBS + f % OBS;
  } else if (f < L::WI) {
    u = S::U_DX + f - L::B0;
  } else if (f < L::WH) {
    u = S::U_DGI + (f - L::WI) / H;
    v = S::V_X + (f - L::WI) % H;
  } else if (f < L::BI) {
    u = S::U_DGH + (f - L::WH) / H;
    v = S::V_HIN + (f - L::WH) % H;
  } else if (f < L::BH) {
    u = S::U_DGI + f - L::BI;
  } else if (f < L::H0) {
    u = S::U_DGH + f - L::BH;
  } else if (f < L::W2) {
    u = S::U_DH0 + f - L::H0;
  } else if (f < L::B2) {
    u = S::U_DA + (f - L::W2) / H;
    v = S::V_H + (f - L::W2) % H;
  } else if (f < L::TOTAL) {
    u = S::U_DA + f - L::B2;
  }
  return static_cast<unsigned>(u) | static_cast<unsigned>(v) << 16;
}

// The backward's window of steps [t1, t1 + CHUNK): a row saved | obs | dA |
// entered a reset (t == 0 or reset[t - 1] != 0), then the barrier.
template <class Blk, int H>
RAPTOR_HD void backward_window(const Blk& blk, float* sm, const float* obs, const float* reset,
                               const float* saved, const float* d_actions, int t1, int T,
                               int B, long b) {
  using S = Bptt<H>;
  for (int s = 0; s < Blk::N; ++s) {
#pragma unroll 8
    for (int e = blk.tid(s); e < S::CHUNK * S::ROW; e += Blk::THREADS) {
      const int t = t1 + e / S::ROW, c = e % S::ROW;
      const long row = static_cast<long>(t) * B + b;
      float v = 0.f;
      if (t < T) {
        if (c < S::R_OBS) {
          v = saved[row * S::SAVED + c];
        } else if (c < S::R_DA) {
          v = obs[row * OBS + c - S::R_OBS];
        } else if (c < S::R_FRESH) {
          v = d_actions[row * ACT + c - S::R_DA];
        } else {
          v = t == 0 ? 1.f : reset[row - B];
        }
      }
      sm[S::B_WIN + e] = v;
    }
  }
  blk.sync();
}

// Backward of sequence b (the weights staged in sm, saved from the
// forward): its row of the flat gradient, partial[b, :].
template <class Blk, int H>
RAPTOR_HD void bptt_backward_seq(const Blk& blk, float* sm, const float* obs,
                                 const float* reset, const float* saved,
                                 const float* d_actions, float* partial, int T, int B,
                                 long b) {
  using S = Bptt<H>;
  constexpr int N = Blk::N, ACC = S::ACC, CHAIN = S::CHAIN, NG = S::GRAD_THREADS;
  float acc[N][ACC];
  float dh[N], zg[N];
  for (int s = 0; s < N; ++s) {
    const int i = blk.tid(s);
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      if (i >= CHAIN) sm[S::B_IDX + m * NG + i - CHAIN] = bits_float(operand_pair<H>(i - CHAIN + m * NG));
      acc[s][m] = 0.f;
    }
    dh[s] = zg[s] = 0.f;
    if (i < 2) {
      sm[S::B_U + i * S::U_SIZE + S::U_ZERO] = 0.f;
      sm[S::B_V + i * S::V_SIZE + S::V_ONE] = 1.f;
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    const int t1 = t - t % S::CHUNK;
    if (t == T - 1 || t % S::CHUNK == S::CHUNK - 1) {
      backward_window<Blk, H>(blk, sm, obs, reset, saved, d_actions, t1, T, B, b);
    }
    const float* row = sm + S::B_WIN + (t - t1) * S::ROW;
    float* U = sm + S::B_U + (t & 1) * S::U_SIZE;
    float* V = sm + S::B_V + (t & 1) * S::V_SIZE;
    // P. the step's operands; the gradients of the gate pre-activations
    for (int s = 0; s < N; ++s) {
      const int i = blk.tid(s);
      if (i < H) {
        const float hin = row[i], x = row[H + i], r = row[2 * H + i], z = row[3 * H + i];
        const float n = row[4 * H + i], ghn = row[5 * H + i];
        V[S::V_X + i] = x;
        V[S::V_HIN + i] = hin;
        V[S::V_H + i] = (1.f - z) * n + z * hin;
        dh[s] = dot<ACT, S::HP>(dh[s], sm + S::W2 + i, row + S::R_DA);
        const float dn = dh[s] * (1.f - z) * (1.f - n * n);
        const float dz = dh[s] * (hin - n) * z * (1.f - z);
        const float dr = dn * ghn * r * (1.f - r);
        U[S::U_DGI + i] = dr;
        U[S::U_DGI + H + i] = dz;
        U[S::U_DGI + 2 * H + i] = dn;
        U[S::U_DGH + i] = dr;
        U[S::U_DGH + H + i] = dz;
        U[S::U_DGH + 2 * H + i] = dn * r;
        zg[s] = z;
      } else if (i >= CHAIN && i < CHAIN + OBS) {
        V[S::V_OBS + i - CHAIN] = row[S::R_OBS + i - CHAIN];
      } else if (i >= CHAIN + OBS && i < CHAIN + OBS + ACT) {
        U[S::U_DA + i - CHAIN - OBS] = row[S::R_DA + i - CHAIN - OBS];
      }
    }
    blk.sync();
    // Q. the carry into step t - 1, or into h0 at a reset; dx
    for (int s = 0; s < N; ++s) {
      const int i = blk.tid(s);
      if (i < H) {
        const float dhin = dot<3 * H, S::HP>(dh[s] * zg[s], sm + S::WH + i, U + S::U_DGH);
        const bool at_reset = row[S::R_FRESH] != 0.f;
        U[S::U_DH0 + i] = at_reset ? dhin : 0.f;
        dh[s] = at_reset ? 0.f : dhin;
      } else if (i >= S::B_DX && i < S::B_DX + H) {
        const int k = i - S::B_DX;
        const float dxp = dot<3 * H, S::HP>(0.f, sm + S::WI + k, U + S::U_DGI);
        U[S::U_DX + k] = V[S::V_X + k] > 0.f ? dxp : 0.f;
      }
    }
    blk.sync();
    // R. the step's share of every gradient entry
    for (int s = 0; s < N; ++s) {
      const int j = blk.tid(s) - CHAIN;
      if (j < 0) continue;
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        const unsigned uv = float_bits(sm[S::B_IDX + m * NG + j]);
        acc[s][m] += U[uv & 0xffffu] * V[uv >> 16];
      }
    }
  }
  for (int s = 0; s < N; ++s) {
    const int j = blk.tid(s) - CHAIN;
    if (j < 0) continue;
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      const int f = j + m * NG;
      if (f < S::TOTAL) partial[b * S::TOTAL + f] = acc[s][m];
    }
  }
}

// grad[f] = sum over b = 0, 1, ..., B - 1 of partial[b, f], in that order
RAPTOR_HD void bptt_reduce_entry(const float* partial, float* grad, int B, int total, int f) {
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += partial[static_cast<long>(b) * total + f];
  grad[f] = sum;
}

}  // namespace raptor
