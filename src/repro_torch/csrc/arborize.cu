// Phase B of the DPSNN step (deferred axonal arborization) over the stacked
// shards: ring[h, (t + delay) mod D, e] = 1 for every valid synapse e of
// shard h whose source spiked, in place.
//
// Replaces `repro/core/engine.py::phase_b` (plain jnp, no Pallas kernel: a
// broadcast-compare of each synapse's slot against the D ring slots, ORed
// into the ring).  The port's phase B before it gathered `syn_src` in
// full, compacted the active synapses with `torch.nonzero` (which waits
// for the device to size its output: the step's one host
// synchronisation) and set the flags by index.  This kernel does the same
// work in one launch, reads nothing back, and has no branch the host must
// see.
//
// Layout: blockIdx.y is the shard, and each thread of a block owns
// kPer synapses kThreads apart, so every load is a coalesced scalar load
// of its natural width (any view of the tensors' dtypes is aligned enough)
// and the kPer independent loads of valid and syn_src are in flight
// together before the dependent ones.
//
// Bound: memory.  What the function must move is every valid flag (1 B),
// the source index of every valid synapse (8 B, int64: the plan's own
// table, no second copy), the spike flags of the shard's sources (1 B
// each, once), and for the ~2% of synapses whose source spiked their delay
// (4 B) and the ring flag they set (1 B): about 9.1 B a synapse, 116 MB
// at the 8x8 grid (E = 12.8 M), 0.035 ms at 3.35 TB/s.  The delays of
// silent sources are never read.  The spike flags (64 KB at 8x8) stay in
// L1/L2.  The ring slot is the floor modulo of `jnp.mod`, computed from
// t mod D and delay mod D in 32 bits; t mod D is given by the host, or
// read from the device step counter `ctr[0]` when one is given (so that a
// captured CUDA graph advances it).
//
// Bits: the ring holds bools that are only ever set, so the result is
// exact and does not depend on the order of the writes; no two synapses
// write one flag (each synapse owns its column e of the ring).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;

__global__ void arborize_kernel(uint8_t* __restrict__ ring,
                                const uint8_t* __restrict__ spiked_src,
                                const int64_t* __restrict__ syn_src,
                                const int32_t* __restrict__ syn_delay,
                                const uint8_t* __restrict__ syn_valid,
                                int64_t D, int64_t E, int64_t S, int t_mod,
                                const int64_t* __restrict__ ctr) {
  const int64_t h = blockIdx.y;
  if (ctr != nullptr) t_mod = (int)(((ctr[0] % D) + D) % D);
  const int64_t base = (int64_t)blockIdx.x * (kThreads * kPer) + threadIdx.x;
  const uint8_t* valid = syn_valid + h * E;
  const int64_t* src = syn_src + h * E;
  const uint8_t* spiked = spiked_src + h * S;
  uint8_t v[kPer];
  int64_t s[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t e = base + k * kThreads;
    v[k] = e < E ? valid[e] : 0;
    s[k] = e < E ? src[e] : 0;
  }
  bool act[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) act[k] = v[k] && spiked[s[k]];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!act[k]) continue;
    const int64_t e = base + k * kThreads;
    const int d = (int)D;
    int slot = syn_delay[h * E + e] % d;
    if (slot < 0) slot += d;
    slot += t_mod;
    if (slot >= d) slot -= d;
    ring[(h * D + slot) * E + e] = 1;
  }
}

}  // namespace

extern "C" int repro_arborize(void* ring, const void* spiked_src,
                              const void* syn_src, const void* syn_delay,
                              const void* syn_valid, int64_t H, int64_t D,
                              int64_t E, int64_t S, int64_t t,
                              const void* ctr, void* stream) {
  const int64_t per_block = (int64_t)kThreads * kPer;
  const int64_t blocks = (E + per_block - 1) / per_block;
  int64_t t_mod = t % D;
  if (t_mod < 0) t_mod += D;
  arborize_kernel<<<dim3((unsigned)blocks, (unsigned)H), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (uint8_t*)ring, (const uint8_t*)spiked_src, (const int64_t*)syn_src,
      (const int32_t*)syn_delay, (const uint8_t*)syn_valid, D, E, S,
      (int)t_mod, (const int64_t*)ctr);
  return (int)cudaGetLastError();
}
