// Attention for a few query rows over a long key range (decode), forward
// only: o = softmax(mask(softcap(scale * q k^T))) v over q [BH, T, D] and
// k, v [BH, S, D] with T < 64, fp32 or bf16 in and out, fp32 arithmetic.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (src/repro/kernels/flash_attention.py:92) where the
// queries are few; `csrc/flash_attention_sm90.cu` takes bf16 prefill and
// `csrc/flash_attention.cu` what neither takes.
//
// Bound: bytes.  Each key and value row is read once for each query row,
// and at decode (T = 1) the scores are 2 D operations a key, so the card
// can do nothing faster than stream k and v: at RecurrentGemma-2B's batch-4
// decode (BH 40, S 2048, D 256, bf16) 84 MB, 0.025 ms at 3.35 TB/s.  One
// block for each (bh, row) walking all keys in series, as the sequential
// kernel does, runs 40 blocks on 132 SMs and is bound by its latency.  So
// the keys are split:
//
//   split    grid (BH * n_splits, T): one block of kWarps warps for each
//            (bh, split of `split` keys, query row).  It walks only the
//            keys of its split that the row can see (a contiguous range);
//            each warp takes a contiguous quarter of them, kBatch keys at
//            a time, a key's row spread over the lanes in 16-byte vectors
//            (neighbouring lanes on neighbouring addresses), and keeps the
//            row's online-softmax state (m, l, acc) in registers.  The
//            warps' states are merged in warp order (ascending keys) and
//            the split's (m, l, acc[D]) written to fp32 scratch.
//   combine  one block for each (bh, row) merges the splits in ascending
//            order, each weighed by exp(m_split - m), and writes o.
//
// Masking follows the reference: q_pos = i + (S - T), causal k_pos <=
// q_pos, window k_pos > q_pos - window (one-sided).  A key the row cannot
// see is not visited.  That gives the reference's result exactly: there a
// masked score is -1e30, whose weight exp(-1e30 - m) is exactly 0 next to
// any visible key, and a row that sees a key first after masked ones
// clears their exp(0) terms the same way.  A split that sees no key writes
// m = -1e30, l = 0, acc = 0, and weighs exactly 0 in the combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // warps per split block
constexpr int kBatch = 8;            // keys a warp loads and scores at once
constexpr float kMasked = -1.0e30f;  // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 16 bytes of T as fp32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(uint4 u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
  }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(uint4 u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // round to nearest even, as torch.Tensor.to(torch.bfloat16)
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// VL: 16-byte vectors of a row each lane holds (a row has VR = D *
// sizeof(T) / 16 <= 32 VL of them; vector vi is lane vi % 32's).
template <typename T, int VL>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int64_t T_len,
                       int64_t S, int D, int64_t split, int64_t n_splits,
                       int causal, int64_t window, float softcap,
                       float scale) {
  constexpr int N = Vec<T>::kN;
  __shared__ float acc_s[kWarps][256];
  __shared__ float m_s[kWarps], l_s[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bh = blockIdx.x / n_splits;
  const int64_t sp = blockIdx.x - bh * n_splits;
  const int64_t row = blockIdx.y;
  const int64_t q_pos = row + S - T_len;
  const int64_t r = bh * T_len + row;  // scratch and output row
  float* acc_out = part_acc + (r * n_splits + sp) * D;
  float* ml_out = part_ml + (r * n_splits + sp) * 2;

  // the keys of this split the row can see: [v_lo, v_hi]
  int64_t v_lo = sp * split;
  int64_t v_hi = (S < v_lo + split ? S : v_lo + split) - 1;
  if (causal && q_pos < v_hi) v_hi = q_pos;
  if (window > 0 && q_pos - window + 1 > v_lo) v_lo = q_pos - window + 1;
  if (v_lo > v_hi) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) acc_out[d] = 0.0f;
    if (threadIdx.x == 0) {
      ml_out[0] = kMasked;
      ml_out[1] = 0.0f;
    }
    return;
  }
  // this warp's contiguous share of them: [w_lo, w_hi]
  const int64_t per = (v_hi - v_lo + kWarps) / kWarps;
  const int64_t w_lo = v_lo + warp * per;
  const int64_t w_hi = (v_lo + (warp + 1) * per - 1 < v_hi)
                           ? v_lo + (warp + 1) * per - 1 : v_hi;

  const int VR = D * (int)sizeof(T) / 16;
  const uint4* qr = reinterpret_cast<const uint4*>(q + r * D);
  const uint4* kb = reinterpret_cast<const uint4*>(k + bh * S * D);
  const uint4* vb = reinterpret_cast<const uint4*>(v + bh * S * D);
  float qf[VL][N], acc[VL][N];
#pragma unroll
  for (int c = 0; c < VL; ++c) {
    const int vi = lane + 32 * c;
    const uint4 u = vi < VR ? __ldg(qr + vi) : make_uint4(0, 0, 0, 0);
    Vec<T>::unpack(u, qf[c]);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[c][e] = 0.0f;
  }
  float m = kMasked, l = 0.0f;

  for (int64_t j0 = w_lo; j0 <= w_hi; j0 += kBatch) {
    const int nb = (int)(w_hi - j0 + 1 < kBatch ? w_hi - j0 + 1 : kBatch);
    uint4 kr[kBatch][VL], vr[kBatch][VL];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int c = 0; c < VL; ++c) {
        const int vi = lane + 32 * c;
        const bool live = b < nb && vi < VR;
        const int64_t off = (j0 + b) * VR + vi;
        kr[b][c] = live ? __ldg(kb + off) : make_uint4(0, 0, 0, 0);
        vr[b][c] = live ? __ldg(vb + off) : make_uint4(0, 0, 0, 0);
      }
    }
    float x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < VL; ++c) {
        float kf[N];
        Vec<T>::unpack(kr[b][c], kf);
#pragma unroll
        for (int e = 0; e < N; ++e) s += qf[c][e] * kf[e];
      }
      s = warp_sum(s) * scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      x[b] = s;
    }
    float m_new = m;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (b < nb) m_new = fmaxf(m_new, x[b]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < VL; ++c)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[c][e] *= corr;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const float p = b < nb ? expf(x[b] - m_new) : 0.0f;
      l += p;
#pragma unroll
      for (int c = 0; c < VL; ++c) {
        float vf[N];
        Vec<T>::unpack(vr[b][c], vf);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[c][e] += p * vf[e];
      }
    }
    m = m_new;
  }

  // merge the warps' states in warp order (ascending keys); a warp that
  // saw no key has m = -1e30, l = 0 and weighs 0
#pragma unroll
  for (int c = 0; c < VL; ++c) {
    const int vi = lane + 32 * c;
    if (vi < VR) {
#pragma unroll
      for (int e = 0; e < N; ++e) acc_s[warp][vi * N + e] = acc[c][e];
    }
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  float mb = m_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, m_s[w]);
  float wt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wt[w] = expf(m_s[w] - mb);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wt[w] * acc_s[w][d];
    acc_out[d] = a;
  }
  if (threadIdx.x == 0) {
    float lb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lb += wt[w] * l_s[w];
    ml_out[0] = mb;
    ml_out[1] = lb;
  }
}

// One block for each (bh, row): the splits merged in ascending order.
template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc,
                                     T* __restrict__ o, int D,
                                     int64_t n_splits) {
  const int64_t r = blockIdx.x;
  const float* ml = part_ml + r * n_splits * 2;
  const float* acc = part_acc + r * n_splits * D;
  float m = kMasked;
  for (int64_t sp = 0; sp < n_splits; ++sp) m = fmaxf(m, ml[2 * sp]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.0f, a = 0.0f;
    for (int64_t sp = 0; sp < n_splits; ++sp) {
      const float w = expf(ml[2 * sp] - m);
      l += w * ml[2 * sp + 1];
      a += w * acc[sp * D + d];
    }
    o[r * D + d] = Vec<T>::from_float(a / (l == 0.0f ? 1.0f : l));
  }
}

template <typename T, int VL>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_ml, float* part_acc, int64_t BH, int64_t T_len,
           int64_t S, int D, int64_t split, int causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  const int64_t n_splits = (S + split - 1) / split;
  if (n_splits > 0) {
    flash_decode_split<T, VL>
        <<<dim3((unsigned)(BH * n_splits), (unsigned)T_len), kWarps * 32, 0,
           stream>>>((const T*)q, (const T*)k, (const T*)v, part_ml,
                     part_acc, T_len, S, D, split, n_splits, causal, window,
                     softcap, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (D + 31) / 32 * 32;
  flash_decode_combine<T><<<(unsigned)(BH * T_len), threads, 0, stream>>>(
      part_ml, part_acc, (T*)o, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16.  T in [1, 63]; D * sizeof(T) a multiple of 16
// and at most 256 values; q, k, v 16-byte aligned.  part_ml [BH * T,
// n_splits, 2] and part_acc [BH * T, n_splits, D] fp32 scratch, n_splits =
// ceil(S / split); split a positive multiple of kBatch.
extern "C" int repro_flash_decode(const void* q, const void* k,
                                  const void* v, void* o, void* part_ml,
                                  void* part_acc, int64_t BH, int64_t T,
                                  int64_t S, int64_t D, int64_t split,
                                  int dtype, int causal, int64_t window,
                                  float softcap, float scale, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || D < 1 || D > 256 ||
      (D * esize) % 16 != 0 || T < 0 || T > 63 || split < kBatch ||
      split % kBatch != 0 || ((uintptr_t)q | (uintptr_t)k |
                              (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  if (dtype == 1)
    return launch<__nv_bfloat16, 1>(q, k, v, o, ml, acc, BH, T, S, (int)D,
                                    split, causal, window, softcap, scale,
                                    st);
  if (D <= 128)
    return launch<float, 1>(q, k, v, o, ml, acc, BH, T, S, (int)D, split,
                            causal, window, softcap, scale, st);
  return launch<float, 2>(q, k, v, o, ml, acc, BH, T, S, (int)D, split,
                          causal, window, softcap, scale, st);
}
