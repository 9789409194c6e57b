// Blockwise online-softmax attention, forward only: o = softmax(mask(
// softcap(scale * q k^T))) v over q [BH, T, D] and k, v [BH, S, D], fp32 or
// bf16 in and out, fp32 arithmetic on the CUDA cores.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (body `_attn_kernel`).  There the grid's kv axis runs in
// order on one core and the running max m, sum l and accumulator live in
// VMEM scratch across it.  CUDA blocks run in no order, so nothing is
// carried between blocks: one block owns kRows * kWarps query rows of one
// (bh) slice and walks the kv tiles itself, in ascending order, with each
// row's m, l and accumulator in registers.
//
// A block: kWarps warps, each owning kRows query rows.  The block stages a
// tile of kTile = 32 keys and values in shared memory in their input dtype
// (rows padded so that the 16-byte reads of the score loop hit distinct
// banks), and each warp keeps its rows' q in shared memory as fp32.
//   scores   lane j computes the kRows scores of key j of the tile (a dot
//            product over D from shared memory), then scale, softcap, mask;
//   softmax  per row, a warp max and a warp sum give the tile's update of
//            m and l, as the Pallas body does per block;
//   p @ v    lane j's weights are broadcast by shuffle, and each lane
//            accumulates its own pairs of output columns (2 * (lane + 32c)).
// Tiles that no query row of the block can see are not visited; a warp
// skips the tiles that none of its rows can see.
//
// Masking follows the reference exactly: absolute positions q_pos = i +
// (S - T) and k_pos, causal k_pos <= q_pos, window k_pos > q_pos - window
// (one-sided, also when not causal), masked scores set to -1e30 (never
// -inf).  A row whose first visited tile is fully masked for it (a tile
// another row of the warp needs) keeps m = -1e30 and accumulates exp(0) = 1
// per masked key; its first visible key, in a later tile since tiles go in
// ascending order, has correction exp(-1e30 - m) = 0 and clears that.  With
// -inf the correction would be NaN, and out of order the clearing would be
// lost.  Every row must see at least one key (the caller refuses causal T >
// S); a row that sees none writes 0, since acc / (l == 0 ? 1 : l).
//
// Bound, at RecurrentGemma-2B's local attention (BH 10, T = S = 2048, D
// 256, bf16, causal, window 2048): 4 D operations per visible (q, k) pair,
// 21.5 GFLOP, against 41.9 MB of q, k, v and o; on the bf16 tensor cores
// that is operation-bound (0.022 ms at 989 TFLOP/s).  This kernel runs on
// the fp32 SIMT cores, with multiply and add apart (the library is built
// with -fmad=false), so it is far from that bound; wgmma with TMA-fed
// tiles is the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;            // warps per block
constexpr int kRows = 4;             // query rows per warp
constexpr int kTile = 32;            // keys per kv tile: one per lane
constexpr float kMasked = -1.0e30f;  // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;      // devices the shared-memory opt-in tracks

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  // 8 values at a 16-byte-aligned shared address
  __device__ static void load8(const unsigned char* p, float (&x)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static float2 load2(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float to_float(__nv_bfloat16 x) {
    return __uint_as_float((uint32_t)__bfloat16_as_ushort(x) << 16);
  }
  // round to nearest even, as torch.Tensor.to(torch.bfloat16)
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static void load8(const unsigned char* p, float (&x)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
    x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
    x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
  }
  __device__ static float2 load2(const unsigned char* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(bf16_lo(w), bf16_hi(w));
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

// Shared memory: the K tile, the V tile (kTile rows of `stride` bytes each,
// D values then zeros up to Dp, a multiple of 8), then q as fp32
// [kWarps * kRows, Dp].  NC = ceil(Dp / 64): column pairs per lane.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int64_t T_len, int64_t S, int D, int Dp,
                           int stride, int64_t q_tiles, int causal,
                           int64_t window, float softcap, float scale,
                           int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = smem + kTile * stride;
  float* qs = reinterpret_cast<float*>(smem + 2 * kTile * stride);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bh = blockIdx.x / q_tiles;
  const int64_t row0 = (blockIdx.x - bh * q_tiles) * (kWarps * kRows);
  const int64_t q_off = S - T_len;
  const T* qb = q + bh * T_len * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;
  T* ob = o + bh * T_len * D;

  // zero the pad columns [D, Dp) of every kv row once: tiles never write
  // them, and the score loop reads them (0 * 0 adds nothing)
  const int pad_bytes = (Dp - D) * (int)sizeof(T);
  for (int i = threadIdx.x; i < kTile * pad_bytes; i += blockDim.x) {
    const int r = i / pad_bytes, b = i - r * pad_bytes;
    ks[r * stride + D * (int)sizeof(T) + b] = 0;
    vs[r * stride + D * (int)sizeof(T) + b] = 0;
  }
  // this warp's rows of q, as fp32 (zeros past D and past T)
  const int64_t wr0 = row0 + warp * kRows;
  float* qw = qs + warp * kRows * Dp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = wr0 + r;
    for (int d = lane; d < Dp; d += 32)
      qw[r * Dp + d] = (row < T_len && d < D)
                           ? Elem<T>::to_float(qb[row * D + d]) : 0.0f;
  }

  // the keys any row of the block can see, and those of this warp's rows
  const int64_t rows_end = imin(row0 + kWarps * kRows, T_len);
  int64_t k_lo = 0, k_hi = S - 1;
  if (causal) k_hi = imin(k_hi, rows_end - 1 + q_off);
  if (window > 0) k_lo = imax(k_lo, row0 + q_off - window + 1);
  const bool warp_live = wr0 < T_len;
  int64_t w_lo = 0, w_hi = S - 1;
  if (causal) w_hi = imin(w_hi, imin(wr0 + kRows, T_len) - 1 + q_off);
  if (window > 0) w_lo = imax(w_lo, wr0 + q_off - window + 1);

  float m[kRows], l[kRows], acc[kRows][2 * NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 2 * NC; ++e) acc[r][e] = 0.0f;
  }

  for (int64_t k0 = k_lo; k0 <= k_hi; k0 += kTile) {
    const int n = (int)imin(kTile, k_hi - k0 + 1);
    __syncthreads();  // the previous tile is consumed (first: q and pads)
    if (vec) {        // rows of D * sizeof(T) bytes, a multiple of 16
      const int cpr = D * (int)sizeof(T) / 16;
      const uint4* kg = reinterpret_cast<const uint4*>(kb + k0 * D);
      const uint4* vg = reinterpret_cast<const uint4*>(vb + k0 * D);
      for (int i = threadIdx.x; i < n * cpr; i += blockDim.x) {
        const int r = i / cpr, c = i - r * cpr;
        *reinterpret_cast<uint4*>(ks + r * stride + c * 16) = kg[i];
        *reinterpret_cast<uint4*>(vs + r * stride + c * 16) = vg[i];
      }
    } else {
      for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
        const int r = i / D, c = i - r * D;
        reinterpret_cast<T*>(ks + r * stride)[c] = kb[k0 * D + i];
        reinterpret_cast<T*>(vs + r * stride)[c] = vb[k0 * D + i];
      }
    }
    __syncthreads();
    if (!warp_live || k0 > w_hi || k0 + n - 1 < w_lo) continue;

    // scores of key k0 + lane for each of the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    if (lane < n) {
      const unsigned char* kr = ks + lane * stride;
      for (int c = 0; c < Dp; c += 8) {
        float kx[8];
        Elem<T>::load8(kr + c * (int)sizeof(T), kx);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(qw + r * Dp + c);
          const float4 b =
              *reinterpret_cast<const float4*>(qw + r * Dp + c + 4);
          float x = s[r];
          x = x + a.x * kx[0]; x = x + a.y * kx[1];
          x = x + a.z * kx[2]; x = x + a.w * kx[3];
          x = x + b.x * kx[4]; x = x + b.y * kx[5];
          x = x + b.z * kx[6]; x = x + b.w * kx[7];
          s[r] = x;
        }
      }
    }
    const int64_t key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t q_pos = wr0 + r + q_off;
      float x = s[r] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      bool seen = lane < n;
      if (causal) seen = seen && key <= q_pos;
      if (window > 0) seen = seen && key > q_pos - window;
      x = seen ? x : kMasked;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - m_new);
      const float p = lane < n ? expf(x - m_new) : 0.0f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 2 * NC; ++e) acc[r][e] = acc[r][e] * corr;
      s[r] = p;
    }
    // acc += p @ v, lane's columns 2 * (lane + 32 c) and the next
    for (int j = 0; j < n; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
      const unsigned char* vr = vs + j * stride;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 2 * (lane + 32 * c);
        if (col < Dp) {
          const float2 w = Elem<T>::load2(vr + col * (int)sizeof(T));
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][2 * c] = acc[r][2 * c] + pj[r] * w.x;
            acc[r][2 * c + 1] = acc[r][2 * c + 1] + pj[r] * w.y;
          }
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = wr0 + r;
    if (row >= T_len) break;
    const float safe = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * (lane + 32 * c) + e;
        if (col < D)
          ob[row * D + col] = Elem<T>::from_float(acc[r][2 * c + e] / safe);
      }
    }
  }
}

// A row of the shared K and V tiles, in bytes: Dp values and, where that
// is an even number of 16-byte units, 16 more, so that the 8 lanes of one
// phase of a 16-byte shared load read 8 different bank groups.
inline int tile_stride(int Dp, int esize) {
  const int stride = Dp * esize;
  return (stride / 16) % 2 == 0 ? stride + 16 : stride;
}

inline size_t smem_bytes(int Dp, int esize) {
  return (size_t)2 * kTile * tile_stride(Dp, esize) +
         (size_t)kWarps * kRows * Dp * sizeof(float);
}

// Opts this instantiation in, on the current device, to the dynamic shared
// memory its widest D takes (Dp = 64 NC).  The driver call is made once
// per (instantiation, device); a race makes the same call twice, which is
// harmless.
template <typename T, int NC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];  // false: not yet set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(64 * NC, (int)sizeof(T)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH,
           int64_t T_len, int64_t S, int D, int causal, int64_t window,
           float softcap, float scale, cudaStream_t stream) {
  const int esize = (int)sizeof(T);
  const int Dp = (D + 7) / 8 * 8;
  const size_t smem = smem_bytes(Dp, esize);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem<T, NC>();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t rows = kWarps * kRows;
  const int64_t q_tiles = (T_len + rows - 1) / rows;
  const int vec = (D * esize) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  flash_attention_kernel<T, NC>
      <<<(unsigned)(BH * q_tiles), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, T_len, S, D, Dp,
      tile_stride(Dp, esize), q_tiles, causal, window, softcap, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t BH,
             int64_t T_len, int64_t S, int D, int causal, int64_t window,
             float softcap, float scale, cudaStream_t stream) {
  switch (((D + 7) / 8 * 8 + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, BH, T_len, S, D, causal, window,
                                softcap, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, BH, T_len, S, D, causal, window,
                                softcap, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, BH, T_len, S, D, causal, window,
                                softcap, scale, stream);
    default: return launch<T, 4>(q, k, v, o, BH, T_len, S, D, causal, window,
                                 softcap, scale, stream);
  }
}

}  // namespace

// dtype 0: fp32, 1: bf16.  window < 1: none; softcap <= 0: none.  D in
// [1, 256]; T, S, BH >= 0.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int64_t BH,
                                     int64_t T, int64_t S, int64_t D,
                                     int dtype, int causal, int64_t window,
                                     float softcap, float scale,
                                     void* stream) {
  if (D < 1 || D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, BH, T, S, (int)D, causal, window,
                           softcap, scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, BH, T, S, (int)D, causal,
                                 window, softcap, scale, st);
}
