// The event backend's delivery (`repro/core/event_engine.py`, plain jnp in
// the JAX package, no Pallas kernel) over the stacked shards: the arrivals
// of one ring slot, and the emission of the spiking sources' forward rows
// into the ring.  LTP of the event backend is `event_ltp_kernel` in
// stdp.cu, beside the LTP walk it shares with the dense path.
//
// The ring holds EVENT LISTS: ev_ring [H, D, cap] int32 synapse ids, -1
// past the list, and ev_count [H, D] int32 the list lengths.  Invariant:
// slot d of shard h holds its events in [0, ev_count[h, d]) and -1 after
// them (phase B appends from ev_count, phase A clears what it consumed).
// The kernels read only the first ev_count entries, so their work follows
// the events, not cap (a quarter of E).  A -1 inside the list is skipped.
//
// The step t is read from a device counter (`ctr[0]`, int64) when `ctr`
// is given, so a captured CUDA graph advances it; else from the launch
// argument `t`.  Slots are the floor modulo of `jnp.mod`, also for the
// pipelined prologue's t = -1.
//
// Arrival (`repro_event_arrival`), two launches on the stream:
//   place  a thread per event (grid-stride over the slot's list): an int
//          atomic on its target's fill count gives it a place in the
//          target's bucket, where it writes its list index.  Target n's
//          bucket is its CSR row [row_ptr[n], row_ptr[n + 1]) of an [E]
//          scratch: its events are distinct synapses of that row, so the
//          bucket never overflows and needs no count or scan first.  The
//          places within a bucket depend on timing; the arrivals per shard
//          are added up by int atomics;
//   sum    a thread per target: it orders its bucket by list index
//          (insertion sort, in a local array up to 32 entries: ~4 events a
//          target at the main density, ~43 at 10x), then in that order
//          adds each event's pre-LTD weight to
//          the current from +0.0, applies LTD against the target's last
//          spike (loaded once) where the synapse is plastic, sets last_arr
//          = t, and writes -1 over the list entry; it writes i_syn[h, n]
//          and leaves its fill count zero for the next launch.
// So each target's sum runs in list order, as XLA-CPU's scatter-add
// walks its updates, with no float atomic and no sort of the list: the
// bits do not depend on the schedule.  Each synapse is in a slot at most
// once (a source spikes once a step, each synapse has one delay), so the
// LTD and last_arr writes never meet.  Work: O(events + N).
//
// Emission (`repro_event_emit`), two launches; block b owns the listed
// sources [64 b, 64 b + 64) (src_ids: the first C spiking sources
// ascending, then the fill S), each of its 8 warps 8 of them in order, and
// a warp walks a source's row 256 entries at a time (every entry's id
// loaded, then every delay, then the slots counted or written):
//   count  each warp's events per slot go to warp_sum[h, b, w, :];
//   write  a warp's first position in each slot is the slot's old count
//          plus the warp sums before it (the blocks before: added up by
//          the block's threads; then the warps before in the block); each
//          source starts after the sources before it, and each row entry
//          after the entries of its slot before it in the row and the
//          lanes below it in its round (a ballot); entries at or past cap
//          are dropped.  A block with no listed source does no work.  The
//          last block of a shard to finish (a ticket) writes ev_count =
//          min(old + added, cap) and sat[h] += n_dropped[h] + the events
//          past cap.
// Ranks follow (source rank, row position), the order of the reference's
// flattened [C, Kf] list, so the ring is the reference's bit for bit.
//
// Bound: memory.  Arrival must read the slot's list (4 B an event),
// each event's target (8 B), plastic (1 B) and w (4 B), write last_arr
// and the cleared entry (8 B) and w where LTD applies (4 B), and read
// last_post and write i_syn (8 B a neuron).  Emission must read the spike
// list's rows (4 B an entry of the listed sources' rows), each event's
// delay (4 B) and write its id (4 B).  The scratch (fill counts,
// buckets, block sums) is what this design adds on top.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 16;     // D the emission kernels take at most
constexpr int kLocalSort = 32;    // bucket entries arrival_sum sorts in L1
// loads issued together: arrival_sum's events, emit_*'s 32-entry rounds
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t step_t(const int64_t* ctr, int64_t t) {
  return ctr != nullptr ? ctr[0] : t;
}

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t d) {
  const int64_t m = x % d;
  return m < 0 ? m + d : m;
}

// The events of slot r of shard h: [0, min(ev_count, cap)).
__device__ __forceinline__ int64_t list_len(const int32_t* count, int64_t h,
                                            int64_t D, int64_t r,
                                            int64_t cap) {
  const int64_t n = count[h * D + r];
  return n < 0 ? 0 : n > cap ? cap : n;
}

// ---------------------------------------------------------------------------
// arrival
// ---------------------------------------------------------------------------

struct ArrivalArgs {
  int32_t* ring;               // [H, D, cap]
  int32_t* count;              // [H, D]
  const int64_t* tgt;          // [H, E]
  const int32_t* row_ptr;      // [H, N + 1] the per-target CSR
  const uint8_t* plastic;      // [H, E]
  const float* last_post;      // [H, N]
  float* w;                    // [H, E]
  float* last_arr;             // [H, E]
  float* i_syn;                // [H, N]
  int64_t* n_arrived;          // [H]
  int32_t* fill;               // [H, N] scratch, zero between launches
  int32_t* bucket;             // [H, E] scratch: row n's bucket is its CSR row
  unsigned long long* total;   // [H] scratch, zero between launches
  const int64_t* ctr;          // step counter or nullptr
  int64_t t, D, cap, E, N;
  float a_minus, inv_tau_minus, w_min, w_max, half_neg_time;
};

__global__ void __launch_bounds__(kThreads) arrival_place(ArrivalArgs a) {
  const int64_t h = blockIdx.y;
  const int64_t r = floor_mod(step_t(a.ctr, a.t), a.D);
  const int64_t n_ev = list_len(a.count, h, a.D, r, a.cap);
  const int32_t* list = a.ring + (h * a.D + r) * a.cap;
  const int32_t* rp = a.row_ptr + h * (a.N + 1);
  int placed = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_ev;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t e = list[i];
    if (e < 0) continue;
    const int64_t n = a.tgt[h * a.E + e];
    const int p = atomicAdd(a.fill + h * a.N + n, 1);
    // a target's events are distinct synapses of its row: p < its length
    if (rp[n] + p < rp[n + 1]) {
      a.bucket[h * a.E + rp[n] + p] = (int32_t)i;
      ++placed;
    }
  }
  placed = __reduce_add_sync(kFull, placed);
  if ((threadIdx.x & 31) == 0 && placed != 0)
    atomicAdd(a.total + h, (unsigned long long)placed);
}

__global__ void __launch_bounds__(kThreads) arrival_sum(ArrivalArgs a) {
  const int64_t h = blockIdx.y;
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t tt = step_t(a.ctr, a.t);
  const int64_t r = floor_mod(tt, a.D);
  if (n == 0) {  // the place kernel has ended: its count is complete
    a.n_arrived[h] = (int64_t)a.total[h];
    a.total[h] = 0;
    a.count[h * a.D + r] = 0;
  }
  if (n >= a.N) return;
  const float t = (float)tt;
  int32_t* list = a.ring + (h * a.D + r) * a.cap;
  int32_t* b = a.bucket + h * a.E + a.row_ptr[h * (a.N + 1) + n];
  const int32_t* rp = a.row_ptr + h * (a.N + 1);
  const int k_n = min(a.fill[h * a.N + n], rp[n + 1] - rp[n]);
  // the bucket in list order (its places came from atomics): a bucket of
  // up to kLocalSort entries is sorted in a local array (L1), a longer one
  // where it lies
  int32_t local[kLocalSort];
  int32_t* v = k_n <= kLocalSort ? local : b;
  if (k_n <= kLocalSort)
    for (int k = 0; k < k_n; ++k) local[k] = b[k];
  for (int k = 1; k < k_n; ++k) {
    const int32_t x = v[k];
    int j = k - 1;
    while (j >= 0 && v[j] > x) {
      v[j + 1] = v[j];
      --j;
    }
    v[j + 1] = x;
  }
  const float lp = a.last_post[h * a.N + n];
  const bool ltd_on = lp > a.half_neg_time;
  const float ltd =
      ltd_on ? a.a_minus * xla_exp((lp - t) * a.inv_tau_minus) : 0.0f;
  float acc = 0.0f;
  // kBatch events at a time: their synapse ids, then their weights and
  // plastic flags, are loaded together before the ordered adds and writes
  for (int k0 = 0; k0 < k_n; k0 += kBatch) {
    int64_t e[kBatch];
    float wv[kBatch];
    uint8_t pl[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      e[q] = k0 + q < k_n ? h * a.E + list[v[k0 + q]] : -1;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      wv[q] = e[q] >= 0 ? a.w[e[q]] : 0.0f;
      pl[q] = e[q] >= 0 ? a.plastic[e[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (e[q] < 0) break;
      acc = acc + wv[q];
      if (ltd_on && pl[q] != 0)
        a.w[e[q]] = fminf(fmaxf(wv[q] - ltd, a.w_min), a.w_max);
      a.last_arr[e[q]] = t;
      list[v[k0 + q]] = -1;
    }
  }
  a.i_syn[h * a.N + n] = acc;
  a.fill[h * a.N + n] = 0;
}

// ---------------------------------------------------------------------------
// emission
// ---------------------------------------------------------------------------

constexpr int kRowsPerWarp = 8;  // listed sources a warp of emit_* owns
constexpr int kEmitWarps = kThreads / 32;
constexpr int kEmitRows = kEmitWarps * kRowsPerWarp;  // a block's

struct EmitArgs {
  const int32_t* src_ids;      // [H, C] ascending, then the fill S
  const int32_t* n_dropped;    // [H]
  const int32_t* fwd;          // [H, S, Kf] synapse ids, -1 pad
  const int32_t* delay;        // [H, E]
  int32_t* ring;               // [H, D, cap]
  int32_t* count;              // [H, D]
  int32_t* sat;                // [H]
  int32_t* warp_sum;           // [H, blocks, kEmitWarps, D] scratch
  unsigned int* ticket;        // [H] scratch, zero between launches
  const int64_t* ctr;          // step counter or nullptr
  int64_t t, D, cap, E, S, Kf, C;
};

// kBatch rounds of a row from entry j0 on: every entry first, then every
// delay (a pad's slot is -1 and its delay is not read), so the row's loads
// are in flight together.
__device__ __forceinline__ void load_rounds(const EmitArgs& a, int64_t h,
                                            const int32_t* row, int64_t j0,
                                            int64_t t, int lane,
                                            int32_t (&id)[kBatch],
                                            int (&slot)[kBatch]) {
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int64_t j = j0 + 32 * q + lane;
    id[q] = j < a.Kf ? row[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q)
    slot[q] = id[q] < 0 ? -1
                        : (int)floor_mod(t + a.delay[h * a.E + id[q]], a.D);
}

// The listed source of warp `warp`'s r-th row in block b, or -1.
__device__ __forceinline__ int32_t row_source(const EmitArgs& a, int64_t h,
                                              int warp, int r) {
  const int64_t k =
      (int64_t)blockIdx.x * kEmitRows + warp * kRowsPerWarp + r;
  if (k >= a.C) return -1;
  const int32_t s = a.src_ids[h * a.C + k];
  return s < a.S ? s : -1;  // the fill follows the listed sources
}

// Block b owns the listed sources [b * kEmitRows, (b + 1) * kEmitRows),
// warp w of it kRowsPerWarp of them in order: each warp's events in each
// slot go to warp_sum[h, b, w, :].
__global__ void __launch_bounds__(kThreads) emit_count(EmitArgs a) {
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = step_t(a.ctr, a.t);
  int tot[kMaxSlots];
#pragma unroll
  for (int d = 0; d < kMaxSlots; ++d) tot[d] = 0;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int32_t s = row_source(a, h, warp, r);
    if (s < 0) break;
    const int32_t* row = a.fwd + (h * a.S + s) * a.Kf;
    bool done = false;
    for (int64_t j0 = 0; j0 < a.Kf && !done; j0 += 32 * kBatch) {
      int32_t id[kBatch];
      int slot[kBatch];
      load_rounds(a, h, row, j0, t, lane, id, slot);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int d = 0; d < kMaxSlots; ++d)
          if (d < a.D) tot[d] += __popc(__ballot_sync(kFull, slot[q] == d));
      }
      done = __ballot_sync(kFull, id[kBatch - 1] < 0) != 0;  // pads follow
    }
  }
  if (lane == 0) {
    int* out = a.warp_sum + ((h * gridDim.x + blockIdx.x) * kEmitWarps +
                             warp) * a.D;
    for (int d = 0; d < a.D; ++d) out[d] = tot[d];
  }
}

// The sums of warps [0, n) of `sums` ([n, D], L2-coherent loads), a slot
// at a time in one pass: each thread adds a stride of the warps, then each
// warp of the block reduces its lanes into part[warp][d].
__device__ __forceinline__ void warp_sums_before(
    const int* sums, int64_t n, int64_t D, int lane, int warp,
    int (&part)[kEmitWarps][kMaxSlots]) {
  int acc[kMaxSlots];
#pragma unroll
  for (int d = 0; d < kMaxSlots; ++d) acc[d] = 0;
  for (int64_t w = threadIdx.x; w < n; w += kThreads) {
#pragma unroll
    for (int d = 0; d < kMaxSlots; ++d)
      if (d < D) acc[d] += __ldcg(sums + w * D + d);
  }
#pragma unroll
  for (int d = 0; d < kMaxSlots; ++d) {
    if (d >= D) break;
    const int sum = __reduce_add_sync(kFull, acc[d]);
    if (lane == 0) part[warp][d] = sum;
  }
}

// Each warp starts its slots at the old count plus the events of every
// warp before it (in the blocks before, then in its block), each source
// after the sources before it, and each row entry after the entries of
// its slot in the rounds before and the lanes below it; the last block to
// finish writes the new counts and sat.
__global__ void __launch_bounds__(kThreads) emit_write(EmitArgs a) {
  __shared__ int part[kEmitWarps][kMaxSlots];
  __shared__ bool last;
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const int64_t t = step_t(a.ctr, a.t);
  const int* sums = a.warp_sum + h * gridDim.x * kEmitWarps * a.D;
  const bool active = row_source(a, h, 0, 0) >= 0;  // the block has rows
  if (active)  // the warps of the blocks before this one
    warp_sums_before(sums, (int64_t)blockIdx.x * kEmitWarps, a.D, lane,
                     warp, part);
  __syncthreads();
  if (active) {
    int next[kMaxSlots];
#pragma unroll
    for (int d = 0; d < kMaxSlots; ++d) {
      if (d >= a.D) break;
      int base = a.count[h * a.D + d];
      for (int w = 0; w < kEmitWarps; ++w) base += part[w][d];
      const int* mine = sums + (int64_t)blockIdx.x * kEmitWarps * a.D + d;
      for (int w = 0; w < warp; ++w) base += mine[w * a.D];
      next[d] = base;
    }
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int32_t s = row_source(a, h, warp, r);
      if (s < 0) break;
      const int32_t* row = a.fwd + (h * a.S + s) * a.Kf;
      bool done = false;
      for (int64_t j0 = 0; j0 < a.Kf && !done; j0 += 32 * kBatch) {
        int32_t id[kBatch];
        int slot[kBatch];
        load_rounds(a, h, row, j0, t, lane, id, slot);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          int at = 0;
#pragma unroll
          for (int d = 0; d < kMaxSlots; ++d) {
            if (d >= a.D) break;
            const unsigned in_d = __ballot_sync(kFull, slot[q] == d);
            if (slot[q] == d) at = next[d] + __popc(in_d & below);
            next[d] += __popc(in_d);
          }
          if (slot[q] >= 0 && at < a.cap)
            a.ring[(h * a.D + slot[q]) * a.cap + at] = id[q];
        }
        done = __ballot_sync(kFull, id[kBatch - 1] < 0) != 0;
      }
    }
  }
  // the last block of the shard: every block has read the old counts
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.ticket + h, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every warp's sums, by all the block's threads
  warp_sums_before(sums, (int64_t)gridDim.x * kEmitWarps, a.D, lane, warp,
                   part);
  __syncthreads();
  if (threadIdx.x == 0) {
    long long overflow = 0;
    for (int d = 0; d < a.D; ++d) {
      long long total = a.count[h * a.D + d];
      for (int w = 0; w < kEmitWarps; ++w) total += part[w][d];
      a.count[h * a.D + d] = (int32_t)(total < a.cap ? total : a.cap);
      if (total > a.cap) overflow += total - a.cap;
    }
    a.sat[h] += a.n_dropped[h] + (int32_t)overflow;
    a.ticket[h] = 0;
  }
}

// Blocks for a grid-stride kernel: enough for `items` (`per_block` each),
// at most four per SM across the H shards.
int64_t stride_blocks(int64_t items, int64_t per_block, int64_t H) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int64_t blocks = (items + per_block - 1) / per_block;
  int64_t cap = 4 * (int64_t)sms / (H > 0 ? H : 1);
  cap = cap < 1 ? 1 : cap;
  blocks = blocks > cap ? cap : blocks;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// ptrs: ring, count, tgt, row_ptr, plastic, last_post, w, last_arr,
// i_syn, n_arrived, fill, bucket, total, ctr (or null).
// ints: H, D, cap, E, N, t.
// floats: a_minus, inv_tau_minus, w_min, w_max, half_neg_time.
extern "C" int repro_event_arrival(void* const* ptrs, const int64_t* ints,
                                   const float* floats, void* stream) {
  ArrivalArgs a;
  a.ring = (int32_t*)ptrs[0];
  a.count = (int32_t*)ptrs[1];
  a.tgt = (const int64_t*)ptrs[2];
  a.row_ptr = (const int32_t*)ptrs[3];
  a.plastic = (const uint8_t*)ptrs[4];
  a.last_post = (const float*)ptrs[5];
  a.w = (float*)ptrs[6];
  a.last_arr = (float*)ptrs[7];
  a.i_syn = (float*)ptrs[8];
  a.n_arrived = (int64_t*)ptrs[9];
  a.fill = (int32_t*)ptrs[10];
  a.bucket = (int32_t*)ptrs[11];
  a.total = (unsigned long long*)ptrs[12];
  a.ctr = (const int64_t*)ptrs[13];
  const int64_t H = ints[0];
  a.D = ints[1];
  a.cap = ints[2];
  a.E = ints[3];
  a.N = ints[4];
  a.t = ints[5];
  a.a_minus = floats[0];
  a.inv_tau_minus = floats[1];
  a.w_min = floats[2];
  a.w_max = floats[3];
  a.half_neg_time = floats[4];
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 events((unsigned)stride_blocks(a.cap, kThreads, H), (unsigned)H);
  const dim3 targets((unsigned)((a.N + kThreads - 1) / kThreads), (unsigned)H);
  arrival_place<<<events, kThreads, 0, s>>>(a);
  arrival_sum<<<targets, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: src_ids, n_dropped, fwd, delay, ring, count, sat, warp_sum,
// ticket, ctr (or null).  ints: H, D, cap, E, S, Kf, C, t.
extern "C" int repro_event_emit(void* const* ptrs, const int64_t* ints,
                                void* stream) {
  EmitArgs a;
  a.src_ids = (const int32_t*)ptrs[0];
  a.n_dropped = (const int32_t*)ptrs[1];
  a.fwd = (const int32_t*)ptrs[2];
  a.delay = (const int32_t*)ptrs[3];
  a.ring = (int32_t*)ptrs[4];
  a.count = (int32_t*)ptrs[5];
  a.sat = (int32_t*)ptrs[6];
  a.warp_sum = (int32_t*)ptrs[7];
  a.ticket = (unsigned int*)ptrs[8];
  a.ctr = (const int64_t*)ptrs[9];
  const int64_t H = ints[0];
  a.D = ints[1];
  a.cap = ints[2];
  a.E = ints[3];
  a.S = ints[4];
  a.Kf = ints[5];
  a.C = ints[6];
  a.t = ints[7];
  if (a.D > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // kEmitRows listed sources a block (kernels/event.py sizes warp_sum)
  const dim3 grid((unsigned)(a.C > 0 ? (a.C + kEmitRows - 1) / kEmitRows : 1),
                  (unsigned)H);
  emit_count<<<grid, kThreads, 0, s>>>(a);
  emit_write<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
