// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over [B, T, D] fp32.
//
// Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py::rg_lru_scan`
// (body `_kernel`), which walks T chunks in order on one core with the
// carry in VMEM scratch.  Here blocks run in parallel in no order, so
// nothing is carried between them: one lane owns one (b, d) channel and
// walks t = 0 .. T-1 with the carry in a register, a multiply then an add
// per step.  A chunked or associative scan across T would round in
// another order; this keeps the serial chain of each channel and takes
// the loads off it.
//
// Design: a block is one warp and owns 32 neighbouring channels of one
// batch row (80 blocks at B=1, D=2560).  The warp stages T-chunks of a
// and b (kSteps steps x 32 channels) into shared memory with cp.async,
// kStages - 1 chunks ahead of the one it walks, so the chain waits on
// shared memory and not on device memory.  Each lane copies, reads and
// walks its own channel's column only (word `lane` of every staged row:
// no bank conflicts, and no lane reads what another copied, so the warp
// needs no barrier); a step's 32 copies and its store of h are 128 B,
// coalesced across the warp.  The copies are 4 bytes each, so any fp32
// view runs (no alignment beyond fp32's own), any D (lanes past D idle)
// and any T >= 0 (the last chunk ragged).  Up to kDirect steps (decode,
// T = 1) there is nothing to overlap: a branch of the same kernel, chosen
// by T, loads all of a lane's steps straight from device memory at once,
// with the same arithmetic; the launch is what such a call costs.
//
// Bound: bytes.  Read a and b, write h (12 B per element) and read h0:
// at prefill B=1, T=512, D=2560 that is 15.7 MB, 4.7 us at 3.35 TB/s; at
// decode B=4, T=1 it is 164 KB (0.05 us), so the launch sets the pace.
// 2 flops per element are nothing beside the bytes.  The serial chain is
// T x (mul + add), about 3 us at T = 512; kStages - 1 chunks of 16 KB in
// flight per block keep about 3.8 MB in flight over 80 SMs.
//
// Bits: the multiply and the add are separate operations (the library is
// built with -fmad=false), as in the plain version `kernels/ref.py::
// rg_lru_scan` and in the Pallas body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // channels a block
constexpr int kSteps = 64;   // steps a staged chunk
constexpr int kStages = 4;   // chunks staged at once
constexpr int kDirect = 8;   // up to this T, no staging

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest kStages - 1 has landed
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__global__ void __launch_bounds__(kLanes) rg_lru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h, int64_t T,
    int64_t D, int steps) {
  // [kStages][steps][kLanes] of a, then of b
  extern __shared__ float stage[];
  float* sa = stage;
  float* sb = stage + kStages * steps * kLanes;
  const int lane = threadIdx.x;
  const int64_t bi = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * kLanes + lane;
  const bool live = d < D;
  const int64_t col = bi * T * D + d;   // (bi, 0, d)
  if (T <= kDirect) {
    if (!live) return;
    float xa[kDirect], xb[kDirect];
#pragma unroll
    for (int i = 0; i < kDirect; ++i) {
      xa[i] = i < T ? a[col + i * D] : 0.0f;
      xb[i] = i < T ? b[col + i * D] : 0.0f;
    }
    float carry = h0[bi * D + d];
#pragma unroll
    for (int i = 0; i < kDirect; ++i) {
      if (i >= T) break;
      const float prod = xa[i] * carry;
      carry = prod + xb[i];
      h[col + i * D] = carry;
    }
    return;
  }
  const int64_t chunks = (T + steps - 1) / steps;

  // chunk c into stage c % kStages, one commit group per chunk (an empty
  // group past the last chunk keeps the count that wait_oldest reads)
  auto issue = [&](int64_t c) {
    if (c < chunks && live) {
      const int64_t t0 = c * steps;
      const int n = (int)(T - t0 < steps ? T - t0 : steps);
      const int s = (int)(c % kStages) * steps;
      const float* pa = a + col + t0 * D;
      const float* pb = b + col + t0 * D;
      for (int i = 0; i < n; ++i) {
        copy4(sa + (s + i) * kLanes + lane, pa + i * D);
        copy4(sb + (s + i) * kLanes + lane, pb + i * D);
      }
    }
    commit();
  };

  for (int c = 0; c < kStages - 1; ++c) issue(c);
  float carry = live ? h0[bi * D + d] : 0.0f;
  float* out = h + col;
  for (int64_t c = 0; c < chunks; ++c) {
    issue(c + kStages - 1);   // into the stage walked at c - 1
    wait_oldest();            // chunk c has landed
    if (!live) continue;
    const int64_t t0 = c * steps;
    const int n = (int)(T - t0 < steps ? T - t0 : steps);
    const float* xa = sa + (int)(c % kStages) * steps * kLanes + lane;
    const float* xb = sb + (int)(c % kStages) * steps * kLanes + lane;
    float* o = out + t0 * D;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float prod = xa[i * kLanes] * carry;
      carry = prod + xb[i * kLanes];
      o[i * D] = carry;
    }
  }
}

// The backward of the scan: given gh = dL/dh, walk t = T-1 .. 0 with
// g = gh_t + a_{t+1} * g (g = gh_t at t = T-1), and write db_t = g and
// da_t = g * h_{t-1} (h_{-1} = h0); then dh0 = a_0 * g.  The same design
// as the forward, walking chunks from the last: a block is one warp of 32
// channels of one batch row, staging T-chunks of gh, a and h (the h rows
// one step back, so that h_{t-1} lands beside gh_t; row -1 is h0) with
// cp.async, kStages - 1 chunks ahead of the one it walks.  a_{t+1} is the
// a of the step walked before, kept in a register.  Each product and sum
// is its own rounding (-fmad=false), in the order of the plain version
// `kernels/ref.py::rg_lru_scan_bwd`.
//
// Bound: bytes.  Read gh, a and h, write da and db (20 B per element) and
// h0 / dh0: at B = 4, T = 512, D = 2560 that is 105 MB, 31 us at
// 3.35 TB/s.  Chunks of kBwdSteps = 32 steps keep the three staged arrays
// at 48 KB a block.
constexpr int kBwdSteps = 32;

__global__ void __launch_bounds__(kLanes) rg_lru_scan_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ h0,
    const float* __restrict__ h, const float* __restrict__ gh,
    float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
    int64_t T, int64_t D) {
  // [kStages][kBwdSteps][kLanes] of gh, of a, then of h one step back
  __shared__ float sg[kStages * kBwdSteps * kLanes];
  __shared__ float sa[kStages * kBwdSteps * kLanes];
  __shared__ float sh[kStages * kBwdSteps * kLanes];
  const int lane = threadIdx.x;
  const int64_t bi = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * kLanes + lane;
  const bool live = d < D;
  const int64_t col = bi * T * D + d;   // (bi, 0, d)
  const int64_t chunks = (T + kBwdSteps - 1) / kBwdSteps;

  // the k-th chunk from the end into stage k % kStages, one commit group
  // per chunk (an empty group past the first chunk keeps the count)
  auto issue = [&](int64_t k) {
    if (k < chunks && live) {
      const int64_t t0 = (chunks - 1 - k) * kBwdSteps;
      const int n = (int)(T - t0 < kBwdSteps ? T - t0 : kBwdSteps);
      const int s = (int)(k % kStages) * kBwdSteps;
      for (int i = 0; i < n; ++i) {
        const int64_t t = t0 + i;
        copy4(sg + (s + i) * kLanes + lane, gh + col + t * D);
        copy4(sa + (s + i) * kLanes + lane, a + col + t * D);
        copy4(sh + (s + i) * kLanes + lane,
              t ? h + col + (t - 1) * D : h0 + bi * D + d);
      }
    }
    commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  float g = 0.0f, a_next = 0.0f;
  for (int64_t k = 0; k < chunks; ++k) {
    issue(k + kStages - 1);   // into the stage walked at k - 1
    wait_oldest();            // chunk k has landed
    if (!live) continue;
    const int64_t t0 = (chunks - 1 - k) * kBwdSteps;
    const int n = (int)(T - t0 < kBwdSteps ? T - t0 : kBwdSteps);
    const int s = (int)(k % kStages) * kBwdSteps * kLanes + lane;
    const float* xg = sg + s;
    const float* xa = sa + s;
    const float* xh = sh + s;
    float* oa = da + col + t0 * D;
    float* ob = db + col + t0 * D;
    for (int i = n - 1; i >= 0; --i) {
      if (k == 0 && i == n - 1) {
        g = xg[i * kLanes];
      } else {
        const float prod = a_next * g;
        g = xg[i * kLanes] + prod;
      }
      ob[i * D] = g;
      oa[i * D] = g * xh[i * kLanes];
      a_next = xa[i * kLanes];
    }
  }
  if (live) dh0[bi * D + d] = T ? a_next * g : 0.0f;
}

}  // namespace

extern "C" int repro_rg_lru_scan_bwd(const void* a, const void* h0,
                                     const void* h, const void* gh, void* da,
                                     void* db, void* dh0, int64_t B,
                                     int64_t T, int64_t D, void* stream) {
  const dim3 grid((unsigned)((D + kLanes - 1) / kLanes), (unsigned)B);
  rg_lru_scan_bwd_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h0, (const float*)h, (const float*)gh,
      (float*)da, (float*)db, (float*)dh0, T, D);
  return (int)cudaGetLastError();
}

extern "C" int repro_rg_lru_scan(const void* a, const void* b,
                                 const void* h0, void* h, int64_t B,
                                 int64_t T, int64_t D, void* stream) {
  // steps a staged chunk (none up to kDirect)
  const int steps = T <= kDirect ? 0 : (int)(T < kSteps ? T : kSteps);
  const size_t smem = sizeof(float) * 2 * kStages * steps * kLanes;
  // the most any launch takes (64 KB, past the default 48 KB)
  cudaError_t err = cudaFuncSetAttribute(
      rg_lru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * 2 * kStages * kSteps * kLanes));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((D + kLanes - 1) / kLanes), (unsigned)B);
  rg_lru_scan_kernel<<<grid, kLanes, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h, T, D,
      steps);
  return (int)cudaGetLastError();
}
