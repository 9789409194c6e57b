// Fused STDP passes over the flat [E] synapse arrays, one thread per
// synapse.
//
// Replace the Pallas TPU kernels of `repro/kernels/stdp.py`:
//   stdp_arrival (body `_arrival_kernel`): LTD against the nearest post
//     spike where the synapse arrived and is plastic, the last-arrival
//     refresh, and the pre-LTD weight as the current contribution;
//   stdp_ltp (body `_ltp_kernel`): LTP against the last arrival where the
//     target spiked and the synapse is plastic and valid.
// The TPU versions walk (8, 128) VMEM tiles; here each thread reads its
// synapse's inputs once and writes its outputs once, with consecutive
// threads on consecutive addresses.
//
// Bound: memory.  stdp_arrival moves 26 bytes per synapse (arr, plastic
// bool; w, last_post, last_arr fp32 in; w, last_arr, contrib fp32 out),
// stdp_ltp 15 (post, plastic, valid bool; w, last_arr fp32 in; w out).  At
// E = 12.8 M (an 8x8 grid) that is 333 MB and 192 MB, 99 us and 57 us at
// 3.35 TB/s; the ~25 flops of exp per synapse are far below the fp32 peak.
// The gathers last_post[syn_tgt] and spiked[syn_tgt] stay outside, as
// torch indexing.
//
// Bits: exp is XLA-CPU's polynomial (xla_exp.cuh), (x - t) / tau is
// multiplied by the fp32 reciprocal 1/tau as XLA rewrites it, and the
// library is built with -fmad=false -ftz=true.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_exp.cuh"

namespace {

__global__ void arrival_kernel(
    const uint8_t* __restrict__ arr, const float* __restrict__ w,
    const float* __restrict__ last_post, const float* __restrict__ last_arr,
    const uint8_t* __restrict__ plastic, float* __restrict__ w_out,
    float* __restrict__ last_arr_out, float* __restrict__ contrib,
    int64_t n, float t, float a_minus, float inv_tau_minus, float w_min,
    float w_max, float half_neg_time) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool arrived = arr[i] != 0;
  const float wi = w[i];
  const float lp = last_post[i];
  const float ltd = a_minus * xla_exp((lp - t) * inv_tau_minus);
  const bool apply = arrived && plastic[i] != 0 && lp > half_neg_time;
  const float clipped = fminf(fmaxf(wi - ltd, w_min), w_max);
  w_out[i] = apply ? clipped : wi;
  last_arr_out[i] = arrived ? t : last_arr[i];
  contrib[i] = arrived ? wi : 0.0f;
}

__global__ void ltp_kernel(
    const uint8_t* __restrict__ post, const float* __restrict__ w,
    const float* __restrict__ last_arr, const uint8_t* __restrict__ plastic,
    const uint8_t* __restrict__ valid, float* __restrict__ w_out, int64_t n,
    float t, float a_plus, float inv_tau_plus, float w_min, float w_max,
    float half_neg_time) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wi = w[i];
  const float la = last_arr[i];
  const float ltp = a_plus * xla_exp((la - t) * inv_tau_plus);
  const bool apply = post[i] != 0 && plastic[i] != 0 && valid[i] != 0 &&
                     la > half_neg_time;
  const float clipped = fminf(fmaxf(wi + ltp, w_min), w_max);
  w_out[i] = apply ? clipped : wi;
}

}  // namespace

extern "C" int repro_stdp_arrival(
    const void* arr, const void* w, const void* last_post,
    const void* last_arr, const void* plastic, void* w_out,
    void* last_arr_out, void* contrib, int64_t n, float t, float a_minus,
    float inv_tau_minus, float w_min, float w_max, float half_neg_time,
    void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  arrival_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)arr, (const float*)w, (const float*)last_post,
      (const float*)last_arr, (const uint8_t*)plastic, (float*)w_out,
      (float*)last_arr_out, (float*)contrib, n, t, a_minus, inv_tau_minus,
      w_min, w_max, half_neg_time);
  return (int)cudaGetLastError();
}

extern "C" int repro_stdp_ltp(
    const void* post, const void* w, const void* last_arr,
    const void* plastic, const void* valid, void* w_out, int64_t n, float t,
    float a_plus, float inv_tau_plus, float w_min, float w_max,
    float half_neg_time, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  ltp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)post, (const float*)w, (const float*)last_arr,
      (const uint8_t*)plastic, (const uint8_t*)valid, (float*)w_out, n, t,
      a_plus, inv_tau_plus, w_min, w_max, half_neg_time);
  return (int)cudaGetLastError();
}
