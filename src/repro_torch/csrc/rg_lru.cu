// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over [B, T, D] fp32.
//
// Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py::rg_lru_scan`
// (body `_kernel`), which walks T chunks in order on one core with the
// carry in VMEM scratch.  Here blocks run in parallel in no order, so
// nothing is carried between them: one thread owns one (b, d) channel and
// walks t = 0 .. T-1 with the carry in a register.  Neighbouring threads
// hold neighbouring d, so each step's loads of a and b and store of h are
// coalesced across the warp.  Any D (no lane padding), any T >= 0.
//
// Bound: bytes.  Read a and b, write h (12 B per element) and read h0:
// at prefill B=1, T=512, D=2560 that is 15.7 MB, 4.7 us at 3.35 TB/s; at
// decode B=4, T=1 it is 164 KB (0.05 us), so the launch sets the pace.
// 2 flops per element are nothing beside the bytes.  Known weakness: at
// B=1 there are only B*D = 2,560 threads (20 blocks of 128 for 132 SMs)
// and each walks T steps serially, so at long T the kernel is latency
// bound far above its byte bound; a chunked scan across T is the redesign.
//
// Bits: the multiply and the add are separate operations (the library is
// built with -fmad=false), as in the plain version `kernels/ref.py::
// rg_lru_scan` and in the Pallas body.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rg_lru_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const float* __restrict__ h0,
                                   float* __restrict__ h, int64_t B,
                                   int64_t T, int64_t D) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  const int64_t bi = i / D;
  const int64_t d = i - bi * D;
  float carry = h0[i];
  int64_t off = bi * T * D + d;
#pragma unroll 4
  for (int64_t t = 0; t < T; ++t, off += D) {
    const float prod = a[off] * carry;
    carry = prod + b[off];
    h[off] = carry;
  }
}

}  // namespace

extern "C" int repro_rg_lru_scan(const void* a, const void* b,
                                 const void* h0, void* h, int64_t B,
                                 int64_t T, int64_t D, void* stream) {
  const int threads = 128;
  const int64_t blocks = (B * D + threads - 1) / threads;
  rg_lru_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h, B, T, D);
  return (int)cudaGetLastError();
}
