// Phase B of the DPSNN step (deferred axonal arborization) over the stacked
// shards: ring[h, (t + delay) mod D, e] = 1 for every valid synapse e of
// shard h whose source spiked, in place.
//
// Replaces `repro/core/engine.py::phase_b` (plain jnp, no Pallas kernel: a
// broadcast-compare of each synapse's slot against the D ring slots, ORed
// into the ring).  One launch, nothing read back, no branch the host must
// see, so a captured CUDA graph holds it.
//
// What the work needs: the spike flags of the shard's sources, and for
// each source that spiked its row of synapses: their ids and delays in,
// one ring flag out each.  About 2% of the sources spike at the main
// density, so the synapses to set are ~2% of E (281,200 of 12.8 M at the
// 8x8 grid).
//
// `arborize_rows` (the path's kernel) walks only those rows, source-major,
// over the forward CSR the plan builds once (`core/engine.py::
// make_fwd_csr`): fwd_ptr [H, S + 1], and per shard its valid synapses
// grouped by source with their delays copied beside them (fwd_ids,
// fwd_delay [H, E] int32), so a row's ids and delays are two coalesced
// reads and no delay is loaded at a random synapse.
//   block  blockIdx.y is the shard; a block owns kRowSources = 32
//          sources, one spike flag a lane of its first warp, and compacts
//          the spiking ones with a ballot: the exclusive scan of their row
//          lengths (shuffles) places each listed row in the block's
//          concatenated list, in shared memory (first entry, offset).
//          Spikes come in bursts of neighbouring sources (a column), so a
//          block of 256 sources would hold a whole burst while most blocks
//          hold none: 32 sources a block (2,000 blocks of 8 warps at the
//          8x8 grid) spread a burst over many blocks.
//   walk   the block's threads take the concatenated entries kRowThreads
//          apart, kRowPer at a time: each finds its row by a binary
//          search of the offsets (shared memory), loads the entry's id and
//          delay (neighbouring threads, neighbouring entries) and stores
//          the flag.  A block's work is balanced however its rows' lengths
//          differ; a row of any length works.
//   bound  bytes: the spike flags (1 B a source), two row pointers a
//          spiking source, and per listed synapse 4 + 4 B in and 1 B out:
//          2.9 MB at the main density, 0.0009 ms at 3.35 TB/s.  Each flag
//          lands in its own 32-B sector of a ring far larger than L2, so
//          counted by sectors the stores alone take 9 MB (0.0027 ms).
//   dense  each scattered flag store costs about a whole sector, while the
//          element-major walk below writes each sector of the ring once
//          for all its synapses.  So every block first counts the same
//          fixed sample of kRowThreads spike flags (sources k * S /
//          kRowThreads), and where kDensePercent or more of them spiked,
//          the whole grid walks the shard's synapses element-major instead,
//          grid-stride over a grid sized for the rows (8 blocks an SM; a
//          grid of one block a chunk, as `arborize_elements` launches, is
//          faster there, but its surplus blocks would cost the sparse
//          launches more than the walk itself).  On the H100 at the 8x8
//          grid the rows are the faster walk at 10.75% of the sources
//          spiking and the element-major one at 21.5% (`chip_smoke.py`'s
//          rows; PERF.md).  Every block sees the same sample, so all take
//          the same walk, and both walks set the same flags.
//
// `arborize_elements` (the element-major kernel of the port's first phase
// B, kept as the yardstick `chip_smoke.py` times beside it; off the path)
// is that walk alone: it reads every synapse's valid flag and source (9.1
// B a synapse, 116 MB at 8x8); each thread owns kPer synapses kThreads
// apart and loads the delay only where the source spiked.
//
// Both take the ring slot as the floor modulo of `jnp.mod`, computed from
// t mod D and delay mod D in 32 bits; t mod D is given by the host, or read
// from the device step counter `ctr[0]` when one is given (so that a
// captured CUDA graph advances it).  Every tensor is read an element at a
// time, so any view of the tensors' dtypes is aligned enough.
//
// Bits: the ring holds bools that are only ever set, and each synapse owns
// its column e of the ring, so the result is exact whatever the order of
// the writes and whichever walk sets them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int ring_slot(int delay, int t_mod, int d) {
  int slot = delay % d;
  if (slot < 0) slot += d;
  slot += t_mod;
  return slot >= d ? slot - d : slot;
}

__device__ __forceinline__ int step_mod(const int64_t* ctr, int t_mod,
                                        int64_t D) {
  return ctr != nullptr ? (int)(((ctr[0] % D) + D) % D) : t_mod;
}

// ---------------------------------------------------------------------------
// element-major: every synapse's valid flag and source
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int64_t kChunk = kThreads * kPer;  // synapses a block a round

struct Elements {
  const int64_t* syn_src;
  const int32_t* syn_delay;
  const uint8_t* syn_valid;
};

// Chunks c0, c0 + stride, ... of kChunk synapses of shard h (kThreads
// threads a block).
__device__ __forceinline__ void element_walk(uint8_t* ring,
                                             const uint8_t* spiked_src,
                                             const Elements& el, int64_t h,
                                             int64_t D, int64_t E, int64_t S,
                                             int t_mod, int64_t c0,
                                             int64_t stride) {
  const uint8_t* valid = el.syn_valid + h * E;
  const int64_t* src = el.syn_src + h * E;
  const uint8_t* spiked = spiked_src + h * S;
  for (int64_t c = c0; c * kChunk < E; c += stride) {
    const int64_t base = c * kChunk + threadIdx.x;
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
      const int slot = ring_slot(el.syn_delay[h * E + e], t_mod, (int)D);
      ring[(h * D + slot) * E + e] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads) arborize_elements(
    uint8_t* __restrict__ ring, const uint8_t* __restrict__ spiked_src,
    Elements el, int64_t D, int64_t E, int64_t S, int t_mod,
    const int64_t* __restrict__ ctr) {
  element_walk(ring, spiked_src, el, blockIdx.y, D, E, S,
               step_mod(ctr, t_mod, D), blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// source-major: the rows of the sources that spiked
// ---------------------------------------------------------------------------

constexpr int kRowThreads = kThreads;  // threads a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowSources = 32;        // sources a block: one warp's flags
constexpr int kRowPer = 4;             // entries a thread has in flight
constexpr int kDensePercent = 18;      // sampled spiking share: element-major

__global__ void __launch_bounds__(kRowThreads) arborize_rows(
    uint8_t* __restrict__ ring, const uint8_t* __restrict__ spiked_src,
    const int32_t* __restrict__ fwd_ptr, const int32_t* __restrict__ fwd_ids,
    const int32_t* __restrict__ fwd_delay, Elements el, int64_t D, int64_t E,
    int64_t S, int t_mod, const int64_t* __restrict__ ctr) {
  __shared__ int32_t first[kRowSources];    // listed row k's first entry
  __shared__ int32_t offset[kRowSources];   // its place in the block's list
  __shared__ int32_t warp_sample[kRowWarps];
  __shared__ int32_t rows_s, total_s;
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* spiked_h = spiked_src + h * S;
  const int tm = step_mod(ctr, t_mod, D);
  // the shard's spiking share, from the sample every block reads alike
  const unsigned sampled = __ballot_sync(
      kFull, spiked_h[(int64_t)threadIdx.x * S / kRowThreads] != 0);
  if (lane == 0) warp_sample[warp] = __popc(sampled);
  if (warp == 0) {
    // the block's sources: the spiking ones listed in source order, each
    // row placed at the exclusive sum of the lengths before it
    const int64_t s = (int64_t)blockIdx.x * kRowSources + lane;
    const bool spiked = s < S && spiked_h[s];
    int32_t beg = 0, len = 0;
    if (spiked) {
      const int32_t* ptr = fwd_ptr + h * (S + 1) + s;
      beg = ptr[0];
      len = ptr[1] - beg;
    }
    const unsigned listed = __ballot_sync(kFull, spiked);
    int incl = len;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, k);
      if (lane >= k) incl += v;
    }
    if (spiked) {
      const int k = __popc(listed & ((1u << lane) - 1));
      first[k] = beg;
      offset[k] = incl - len;
    }
    if (lane == 31) {
      rows_s = __popc(listed);
      total_s = incl;
    }
  }
  __syncthreads();
  int sample = 0;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) sample += warp_sample[w];
  if (sample * 100 >= kDensePercent * kRowThreads) {
    element_walk(ring, spiked_src, el, h, D, E, S, tm, blockIdx.x,
                 gridDim.x);
    return;
  }
  const int rows = rows_s, total = total_s;
  if (total == 0) return;
  const int d = (int)D;
  const int32_t* ids = fwd_ids + h * E;
  const int32_t* delays = fwd_delay + h * E;
  uint8_t* ring_h = ring + h * D * E;
  for (int f0 = threadIdx.x; f0 < total; f0 += kRowThreads * kRowPer) {
    int32_t id[kRowPer], delay[kRowPer];
#pragma unroll
    for (int q = 0; q < kRowPer; ++q) {
      const int f = f0 + q * kRowThreads;
      id[q] = -1;
      if (f < total) {
        // the last listed row whose offset is <= f (rows of length 0
        // share their successor's offset and are passed over)
        int lo = 0, hi = rows - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (offset[mid] <= f) lo = mid; else hi = mid - 1;
        }
        const int32_t j = first[lo] + (f - offset[lo]);
        id[q] = ids[j];
        delay[q] = delays[j];
      }
    }
#pragma unroll
    for (int q = 0; q < kRowPer; ++q)
      if (id[q] >= 0)
        ring_h[(int64_t)ring_slot(delay[q], tm, d) * E + id[q]] = 1;
  }
}

int host_t_mod(int64_t t, int64_t D) {
  int64_t m = t % D;
  return (int)(m < 0 ? m + D : m);
}

// Blocks of arborize_rows a shard: one a kRowSources sources, and at least
// enough to fill every SM (8 blocks an SM) in the element-major walk, or
// one a chunk where there are fewer chunks.
int64_t rows_blocks(int64_t S, int64_t E) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t by_src = (S + kRowSources - 1) / kRowSources;
  int64_t by_chunk = (E + kChunk - 1) / kChunk;
  if (by_chunk > 8 * (int64_t)sms) by_chunk = 8 * (int64_t)sms;
  return by_src > by_chunk ? by_src : by_chunk;
}

}  // namespace

// ring [H, D, E] bool, spiked_src [H, S] bool, fwd_ptr [H, S + 1], fwd_ids
// and fwd_delay [H, E] int32 (the source-major walk), syn_src [H, E]
// int64, syn_delay [H, E] int32, syn_valid [H, E] bool (the element-major
// walk); ctr the step counter or null.
extern "C" int repro_arborize(void* ring, const void* spiked_src,
                              const void* fwd_ptr, const void* fwd_ids,
                              const void* fwd_delay, const void* syn_src,
                              const void* syn_delay, const void* syn_valid,
                              int64_t H, int64_t D, int64_t E, int64_t S,
                              int64_t t, const void* ctr, void* stream) {
  if (S == 0) return 0;  // no source, no flag
  const Elements el{(const int64_t*)syn_src, (const int32_t*)syn_delay,
                    (const uint8_t*)syn_valid};
  arborize_rows<<<dim3((unsigned)rows_blocks(S, E), (unsigned)H),
                  kRowThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)ring, (const uint8_t*)spiked_src, (const int32_t*)fwd_ptr,
      (const int32_t*)fwd_ids, (const int32_t*)fwd_delay, el, D, E, S,
      host_t_mod(t, D), (const int64_t*)ctr);
  return (int)cudaGetLastError();
}

// The element-major walk alone; arguments as repro_arborize's without the
// forward CSR.
extern "C" int repro_arborize_elements(void* ring, const void* spiked_src,
                                       const void* syn_src,
                                       const void* syn_delay,
                                       const void* syn_valid, int64_t H,
                                       int64_t D, int64_t E, int64_t S,
                                       int64_t t, const void* ctr,
                                       void* stream) {
  const int64_t blocks = (E + kChunk - 1) / kChunk;
  const Elements el{(const int64_t*)syn_src, (const int32_t*)syn_delay,
                    (const uint8_t*)syn_valid};
  arborize_elements<<<dim3((unsigned)blocks, (unsigned)H), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (uint8_t*)ring, (const uint8_t*)spiked_src, el, D, E, S,
      host_t_mod(t, D), (const int64_t*)ctr);
  return (int)cudaGetLastError();
}
