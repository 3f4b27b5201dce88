// The distillation step's backpropagation through time on Hopper (sm_90a):
// the student's forward over all T steps of B sequences in one kernel, its
// backward over the T steps in reverse in a second, and a fixed-order sum of
// the sequences' gradient rows in a third; for a student of hidden width 8,
// 16, 24, 32 or 48.
//
// Replaces no Pallas kernel: the JAX package compiles the same function as
// one lax.scan under jax.value_and_grad (raptor_tpu/distill/post_training.py
// bptt_actions), which XLA fuses. Eager PyTorch ran it as a Python loop of T
// apply_step calls under autograd: 25 launches a time step forward and 57
// backward, 41,021 a gradient step at T = 500, the card idle 96 % of it.
//
// What bounds it: the dependent chain of each sequence. A step of the forward
// waits on h of the step before: one H-long dot product (wh h), the gates'
// expf and tanhf, and two block barriers; the backward's carry is one
// 3H-long dot product (wh^T dgh) and two barriers. About 200-300 clocks a
// step, 0.12-0.18 us at 1.755 GHz: 0.06-0.09 ms for the forward at T = 500,
// 2 to 3 times that for the backward. The operations (0.41 GFLOP a gradient
// step at H = 16, B = 64) take 6 us at 67 TFLOP/s and the bytes (the
// observations, resets and actions, 64 x 500 x 27 floats, and the 12 MB of
// saved activations written and read once) under 10 us.
//
// Design (bptt_step.cuh): one block a sequence, B blocks, so each sequence's
// chain runs on its own SM. The weights are staged once a block into shared
// memory in padded rows; the vectors a phase hands on go through shared
// memory. A block barrier waits for the loads in flight, so the inputs come
// into shared memory 32 steps at a time, and the work off the chain (x and
// wi x of the next step, the head, the gradient entries) runs beside it in
// other warps. The backward keeps each gradient thread's entries in
// registers (at most Bptt<H>::MAX_ACC, so wider students get more warps)
// and writes one row a sequence; the third kernel sums the rows in a fixed
// order. No atomics, no TF32, no fast math.
#include <cuda_runtime.h>

#include "bptt_step.cuh"

namespace {

template <int H>
__global__ void __launch_bounds__(raptor::Bptt<H>::FWD_THREADS)
    bptt_forward(raptor::StudentLeaves w, const float* obs, const float* reset,
                 float* actions, float* saved, int n_steps, int batch) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = raptor::Bptt<H>::FWD_THREADS;
  raptor::stage_student<H>(w, smem, threadIdx.x, NT);  // the first window's barrier follows
  const raptor::DeviceBlock<NT> blk{static_cast<int>(threadIdx.x)};
  raptor::bptt_forward_seq<raptor::DeviceBlock<NT>, H>(blk, smem, obs, reset, actions, saved,
                                                       n_steps, batch, blockIdx.x);
}

template <int H>
__global__ void __launch_bounds__(raptor::Bptt<H>::BWD_THREADS)
    bptt_backward(raptor::StudentLeaves w, const float* obs, const float* reset,
                  const float* saved, const float* d_actions, float* partial, int n_steps,
                  int batch) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = raptor::Bptt<H>::BWD_THREADS;
  raptor::stage_student<H>(w, smem, threadIdx.x, NT);  // the first window's barrier follows
  const raptor::DeviceBlock<NT> blk{static_cast<int>(threadIdx.x)};
  raptor::bptt_backward_seq<raptor::DeviceBlock<NT>, H>(blk, smem, obs, reset, saved, d_actions,
                                                        partial, n_steps, batch, blockIdx.x);
}

__global__ void bptt_reduce(const float* partial, float* grad, int batch, int total) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < total) raptor::bptt_reduce_entry(partial, grad, batch, total, f);
}

template <class Kernel>
int set_shared(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// One object a hidden width: nvcc compiles this file once for each width with
// -DRAPTOR_HIDDEN=H (ops/build.py), and each object exports
// raptor_bptt_forward_<H> and raptor_bptt_backward_<H>.
#ifndef RAPTOR_HIDDEN
#define RAPTOR_HIDDEN 16
#endif

namespace {
constexpr int H = RAPTOR_HIDDEN;
using S = raptor::Bptt<H>;
constexpr int kSharedBytes = S::SHARED * 4;
}  // namespace

// The nine leaves, obs [T, B, 22], reset [T, B] in; actions [T, B, 4] out, and
// saved [T, B, 6, H] unless it is null. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int RAPTOR_PASTE(raptor_bptt_forward_, RAPTOR_HIDDEN)(
    const float* w0, const float* b0, const float* wi, const float* wh, const float* bi,
    const float* bh, const float* h0, const float* w2, const float* b2, const float* obs,
    const float* reset, float* actions, float* saved, int n_steps, int batch, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const int err = set_shared(bptt_forward<H>, kSharedBytes);
  if (err != 0) return err;
  bptt_forward<H><<<batch, S::FWD_THREADS, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      raptor::StudentLeaves{w0, b0, wi, wh, bi, bh, h0, w2, b2}, obs, reset, actions, saved,
      n_steps, batch);
  return static_cast<int>(cudaGetLastError());
}

// The nine leaves, obs, reset, the forward's saved and d_actions [T, B, 4] in;
// partial [B, n_weights(H)] scratch; grad [n_weights(H)], the gradient of the
// flat policy layout, out. Two launches on `stream`; returns
// cudaGetLastError().
extern "C" int RAPTOR_PASTE(raptor_bptt_backward_, RAPTOR_HIDDEN)(
    const float* w0, const float* b0, const float* wi, const float* wh, const float* bi,
    const float* bh, const float* h0, const float* w2, const float* b2, const float* obs,
    const float* reset, const float* saved, const float* d_actions, float* partial,
    float* grad, int n_steps, int batch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch > 0) {
    const int err = set_shared(bptt_backward<H>, kSharedBytes);
    if (err != 0) return err;
    bptt_backward<H><<<batch, S::BWD_THREADS, kSharedBytes, st>>>(
        raptor::StudentLeaves{w0, b0, wi, wh, bi, bh, h0, w2, b2}, obs, reset, saved, d_actions,
        partial, n_steps, batch);
    const int launch = static_cast<int>(cudaGetLastError());
    if (launch != 0) return launch;
  }
  constexpr int threads = 256;
  bptt_reduce<<<(S::TOTAL + threads - 1) / threads, threads, 0, st>>>(partial, grad, batch,
                                                                      S::TOTAL);
  return static_cast<int>(cudaGetLastError());
}
