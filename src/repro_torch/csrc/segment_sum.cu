// Per-target synaptic current: an in-order fp32 sum of each target's
// incoming contributions, one thread per target row.
//
// Replaces the sorted `jax.ops.segment_sum` at `repro/core/engine.py:230`
// (not a Pallas kernel).  XLA-CPU adds a sorted segment sequentially from
// +0.0 in synapse order; atomics (torch `index_add_` on the card) add in
// whatever order the threads land, so they cannot give the reference's
// bits.  Each thread here walks its row of a per-shard CSR
// (row_ptr [H, N + 1] over the valid synapses, which `build` lays out in
// canonical (target, source, slot) order) and adds in that order.
// Padded synapse slots contribute +0.0 and lie outside every row.
//
// Bound: memory, about 4 bytes per synapse (contrib) plus 8 bytes per
// target (row_ptr, out): 52 MB at E = 12.8 M, 15 us at 3.35 TB/s.  Neighbour
// threads read different rows, so the reads do not coalesce; making it
// fast (staging each block's rows through shared memory with coalesced
// loads, then summing each row in order) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ contrib,
                                   const int32_t* __restrict__ row_ptr,
                                   float* __restrict__ out, int64_t n_shards,
                                   int64_t n_rows, int64_t n_syn) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_shards * n_rows) return;
  const int64_t h = g / n_rows;
  const int64_t i = g - h * n_rows;
  const int32_t* rp = row_ptr + h * (n_rows + 1);
  const float* c = contrib + h * n_syn;
  const int32_t end = rp[i + 1];
  float acc = 0.0f;
  for (int32_t p = rp[i]; p < end; ++p) acc = acc + c[p];
  out[g] = acc;
}

}  // namespace

extern "C" int repro_segment_sum_ordered(const void* contrib,
                                         const void* row_ptr, void* out,
                                         int64_t n_shards, int64_t n_rows,
                                         int64_t n_syn, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n_shards * n_rows + threads - 1) / threads;
  segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)contrib, (const int32_t*)row_ptr, (float*)out, n_shards,
      n_rows, n_syn);
  return (int)cudaGetLastError();
}
