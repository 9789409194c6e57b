// The event backend's delivery (`repro/core/event_engine.py`, plain jnp in
// the JAX package, no Pallas kernel) over the stacked shards: the arrivals
// of one ring slot, and the emission of the spiking sources' forward rows
// into the ring.  The rest of the event backend's phase A, the neurons
// and LTP, is in event_phase_a.cu.
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
// Arrival (`repro_event_arrival`), two launches on the stream.
//   What bounds it: each event's scattered loads and stores at a random
//   synapse (w in and out, plastic, last_arr out: a 32-B sector each of
//   arrays far larger than L2, and a partial-sector write costs a read
//   too); the sum of a target's events must follow list order, which the
//   places (atomics) do not.
//   place  a thread per list entry (grid-stride, coalesced along the
//          list) does every per-event job that does not depend on order:
//          it reads the synapse e, w[e], plastic[e], its target n and
//          last_post[n]; writes LTD into w[e] where plastic and n has
//          spiked (the same xla_exp factor per event, so the same bits),
//          last_arr[e] = t and -1 over the entry; then takes a place in
//          n's bucket with an int atomic and writes one 8-byte pair there:
//          the list index and the PRE-LTD weight's bits.  The target is
//          found as REPRO_ARRIVAL_TARGET says: 0 reads syn_tgt[e] (8 B at
//          the random synapse), 1 searches row_ptr (which stays in L2) for
//          the CSR row holding e; the row invariant of stdp.cu makes them
//          equal for a valid synapse.  `chip_smoke.py` builds the other
//          one and times the two on the same inputs.  Target n's
//          bucket is its CSR row [row_ptr[n], row_ptr[n + 1]) of an
//          [H, E] scratch of pairs (8 B a synapse: 102 MB at 8x8, twice
//          what list indices alone would take): its events are distinct
//          synapses of that row, so the bucket never overflows and needs
//          no count or scan first.  Each synapse is in a slot at most once
//          (a source spikes once a step, each synapse has one delay), so
//          the weight read here is the one the reference sums, and no two
//          events write the same w or last_arr.  The arrivals per shard
//          are added up by int atomics.
//   sum    a group of kLanes = 8 lanes a target (4 targets a warp: most
//          buckets hold a few events; a warp a target was 4-20% slower)
//          reads its bucket's pairs in one coalesced pass (kChunk = 64
//          pairs in registers) and loads nothing else per event.  The
//          keys (list indices) are distinct, so a pair's rank in list
//          order is the count of smaller keys, found by shuffles.  The
//          weights go to the group's staging row in shared memory at
//          their rank, and one lane adds them in rank order from +0.0,
//          one fp32 add at a time, writes i_syn[h, n] and leaves the fill
//          count zero.  A bucket longer than kChunk is ranked chunk
//          against chunk (every read contiguous), and one longer than the
//          staging row (kStage = 128 weights) is summed a window of ranks
//          at a time: any row length works, with no global-memory sort
//          and no limit.
// So each target's sum runs in list order, as XLA-CPU's scatter-add
// walks its updates, with no float atomic: the bits do not depend on the
// schedule.  Work: O(events) loads, O(sum of bucket^2 / kLanes)
// comparisons.
//
// Emission (`repro_event_emit`), one launch: a single-pass scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016) over tiles of kEmitWarps listed
// sources (src_ids: the first C spiking sources ascending, then the
// fill S), in source-rank order.
//   What bounds it: each event's delay, loaded at a random synapse (a
//   sector an event), and the order: an event's place in its slot is the
//   count of the slot's events of every source before it.
//   grid   persistent, a few blocks an SM (not sized to C); a block takes
//          its tiles in order from an atomic tile counter, so a tile waits
//          only on tiles that are already running, and leaves at the first
//          tile whose first row is the fill.  Work follows the listed
//          sources: at c_src = S the fill's tiles are never walked.
//   row    a warp a listed source: it loads the row's ids and their delays
//          once into registers (kRowRegs rounds of 32: 256 entries; a
//          longer row is read again for the writes), counts them per slot
//          with ballots, and keeps each entry's place among its row's
//          entries of its slot.
//   groups the per-slot work (counts, tile words, look-back, writes) runs
//          kSlotGroup = 16 slots at a time, a lane a slot, in registers;
//          a slot's scan depends on no other slot, so any D >= 1 runs in
//          ceil(D / 16) passes over the tile (one at the default D = 6;
//          a longer row is then read again each pass).
//   tile   the warps' counts add up to the tile's per-slot aggregate; the
//          tile reads the old counts, publishes the aggregate (per slot a
//          status and the value in one 64-bit word), looks back a warp of
//          32 tiles at a time for its exclusive prefix, and publishes its
//          inclusive prefix.  Each entry's place is then old count +
//          prefix + the warps before it in the tile + its place in the
//          row, from the same registers; entries at or past cap are
//          dropped.
//   end    the tile that holds the last listed source (tile 0 when none
//          is listed) writes ev_count = min(old + total, cap) and sat +=
//          n_dropped + the events past cap, after its look-back has seen
//          every earlier tile publish: each tile reads the old counts
//          before it publishes, so none reads a rewritten count.  The
//          last block to leave clears the tile words and counters, so the
//          tile state is zero between launches (graph replays, repeated
//          calls at one t).  A look-back that waits ~10 s of clock on a
//          tile that never publishes traps rather than hang the card.
// Ranks follow (source rank, row position), the order of the reference's
// flattened [C, Kf] list, so the ring is the reference's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_exp.cuh"

namespace {

constexpr int kThreads = 256;
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

// The place pass's target: 0 reads syn_tgt, 1 searches row_ptr.
#ifndef REPRO_ARRIVAL_TARGET
#define REPRO_ARRIVAL_TARGET 1
#endif

constexpr int kLanes = 8;    // lanes of the sum a target
constexpr int kChunk = 64;   // pairs a group of the sum holds in registers
constexpr int kStage = 128;  // weights a group stages in shared memory

struct ArrivalArgs {
  int32_t* ring;               // [H, D, cap]
  int32_t* count;              // [H, D]
  const int64_t* syn_tgt;      // [H, E]
  const int32_t* row_ptr;      // [H, N + 1] the per-target CSR
  const uint8_t* plastic;      // [H, E]
  const float* last_post;      // [H, N]
  float* w;                    // [H, E]
  float* last_arr;             // [H, E]
  float* i_syn;                // [H, N]
  int64_t* n_arrived;          // [H]
  int32_t* fill;               // [H, N] scratch, zero between launches
  int2* pairs;                 // [H, E] scratch: (list index, weight bits)
  unsigned long long* total;   // [H] scratch, zero between launches
  const int64_t* ctr;          // step counter or nullptr
  int64_t t, D, cap, E, N;
  float a_minus, inv_tau_minus, w_min, w_max, half_neg_time;
};

__global__ void __launch_bounds__(kThreads) arrival_place(ArrivalArgs a) {
  const int64_t h = blockIdx.y;
  const int64_t tt = step_t(a.ctr, a.t);
  const int64_t r = floor_mod(tt, a.D);
  const float t = (float)tt;
  const int64_t n_ev = list_len(a.count, h, a.D, r, a.cap);
  int32_t* list = a.ring + (h * a.D + r) * a.cap;
  const int32_t* rp = a.row_ptr + h * (a.N + 1);
  int placed = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_ev;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t e = list[i];
    if (e < 0) continue;
    const int64_t se = h * a.E + e;
    const float wv = a.w[se];
#if REPRO_ARRIVAL_TARGET
    // the CSR row holding e (rp[n] <= e < rp[n + 1])
    int32_t n = 0, end = (int32_t)a.N;
    while (end - n > 1) {
      const int32_t mid = (n + end) >> 1;
      if (rp[mid] <= e)
        n = mid;
      else
        end = mid;
    }
#else
    const int32_t n = (int32_t)a.syn_tgt[se];
#endif
    const uint8_t pl = a.plastic[se];
    const float lp = a.last_post[h * a.N + n];
    const int32_t lo = rp[n], hi = rp[n + 1];
    if (pl != 0 && lp > a.half_neg_time) {
      const float ltd = a.a_minus * xla_exp((lp - t) * a.inv_tau_minus);
      a.w[se] = fminf(fmaxf(wv - ltd, a.w_min), a.w_max);
    }
    a.last_arr[se] = t;
    list[i] = -1;
    const int p = atomicAdd(a.fill + h * a.N + n, 1);
    // a target's events are distinct synapses of its row: p < its length
    if (lo + p < hi) {
      a.pairs[h * a.E + lo + p] = make_int2((int)i, __float_as_int(wv));
      ++placed;
    }
  }
  placed = __reduce_add_sync(kFull, placed);
  if ((threadIdx.x & 31) == 0 && placed != 0)
    atomicAdd(a.total + h, (unsigned long long)placed);
}

// kLanes lanes (a group) a target; the loops run to the longest bucket of
// the warp, so every shuffle is warp-wide.  A lane holds kR pairs of a
// chunk: pair a0 + g + kLanes * q.
__global__ void __launch_bounds__(kThreads) arrival_sum(ArrivalArgs a) {
  constexpr int kR = kChunk / kLanes;
  constexpr int kGroups = kThreads / kLanes;
  __shared__ float stage[kGroups][kStage];
  const int64_t h = blockIdx.y;
  const int grp = threadIdx.x / kLanes, g = threadIdx.x % kLanes;
  const int64_t n = (int64_t)blockIdx.x * kGroups + grp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the place kernel has ended: its count is complete
    a.n_arrived[h] = (int64_t)a.total[h];
    a.total[h] = 0;
    a.count[h * a.D + floor_mod(step_t(a.ctr, a.t), a.D)] = 0;
  }
  const int32_t* rp = a.row_ptr + h * (a.N + 1);
  int k = 0;
  const int2* b = a.pairs + h * a.E;
  if (n < a.N) {
    const int32_t lo = rp[n];
    k = min(a.fill[h * a.N + n], rp[n + 1] - lo);
    b += lo;
  }
  const int kmax = __reduce_max_sync(kFull, k);
  float acc = 0.0f;
  for (int ws = 0; ws < kmax; ws += kStage) {      // a window of ranks
    for (int a0 = 0; a0 < kmax; a0 += kChunk) {    // the chunk ranked
      int key[kR], rank[kR];
      float wv[kR];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int j = a0 + g + kLanes * q;
        const int2 p = j < k ? b[j] : make_int2(INT32_MAX, 0);
        key[q] = p.x;
        wv[q] = __int_as_float(p.y);
        rank[q] = 0;
      }
      for (int b0 = 0; b0 < kmax; b0 += kChunk) {  // against every chunk
        int other[kR];
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          const int j = b0 + g + kLanes * q;
          other[q] = b0 == a0 ? key[q] : j < k ? b[j].x : INT32_MAX;
        }
#pragma unroll
        for (int q2 = 0; q2 < kR; ++q2) {
          if (b0 + kLanes * q2 >= kmax) break;
#pragma unroll
          for (int s = 0; s < kLanes; ++s) {
            const int o = __shfl_sync(kFull, other[q2], s, kLanes);
#pragma unroll
            for (int q = 0; q < kR; ++q) rank[q] += o < key[q];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kR; ++q)
        if (key[q] != INT32_MAX && rank[q] >= ws && rank[q] < ws + kStage)
          stage[grp][rank[q] - ws] = wv[q];
    }
    __syncwarp();
    if (g == 0) {
      const int m = min(kStage, k - ws);
      for (int i = 0; i < m; ++i) acc = acc + stage[grp][i];
    }
    __syncwarp();
  }
  if (n < a.N && g == 0) {
    a.i_syn[h * a.N + n] = acc;
    a.fill[h * a.N + n] = 0;
  }
}

// ---------------------------------------------------------------------------
// emission
// ---------------------------------------------------------------------------

constexpr int kEmitThreads = 256;
constexpr int kEmitWarps = kEmitThreads / 32;  // listed sources (rows) a tile
constexpr int kEmitBlocksPerSM = 4;
constexpr int kRowRegs = 8;  // 32-entry rounds of a row kept in registers
constexpr int kSlotGroup = 16;  // slots a pass of the tile scans at once
constexpr unsigned long long kAggregate = 1ull << 32;  // tile word status
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr long long kLookBackCycles = 1ll << 34;

struct EmitArgs {
  const int32_t* src_ids;      // [H, C] ascending, then the fill S
  const int32_t* n_dropped;    // [H]
  const int32_t* fwd;          // [H, S, Kf] synapse ids, -1 pad
  const int32_t* delay;        // [H, E]
  int32_t* ring;               // [H, D, cap]
  int32_t* count;              // [H, D]
  int32_t* sat;                // [H]
  // [H, tiles, D] scratch: status << 32 | value per tile and slot
  unsigned long long* words;
  unsigned int* ctrl;          // [H, 2] scratch: tile counter, blocks out
  const int64_t* ctr;          // step counter or nullptr
  int64_t t, D, cap, E, S, Kf, C, tiles;
};

// The source listed at rank k of shard h, or -1 (past C, or the fill).
__device__ __forceinline__ int32_t listed(const EmitArgs& a, int64_t h,
                                          int64_t k) {
  if (k >= a.C) return -1;
  const int32_t s = a.src_ids[h * a.C + k];
  return s < a.S ? s : -1;
}

// kRowRegs rounds of a row from entry j0 on, into registers: the ids, then
// their slots (every delay load in flight together; a pad's slot is -1).
__device__ __forceinline__ void row_load(const EmitArgs& a, int64_t h,
                                         const int32_t* row, int64_t j0,
                                         int64_t t, int lane,
                                         int32_t (&id)[kRowRegs],
                                         int (&slot)[kRowRegs]) {
#pragma unroll
  for (int q = 0; q < kRowRegs; ++q) {
    const int64_t j = j0 + 32 * q + lane;
    id[q] = j < a.Kf ? row[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < kRowRegs; ++q)
    slot[q] = id[q] < 0 ? -1
                        : (int)floor_mod(t + a.delay[h * a.E + id[q]], a.D);
}

// For the G slots g0, g0 + 1, ... of a slot group: each loaded entry's
// place among the row's entries of its slot from j0 on, added to the
// running per-slot counts `cnt` (slot g0 + d in cnt[d], the same in every
// lane).  An entry of another group gets no place.
__device__ __forceinline__ void row_count(int64_t Kf, int64_t j0, int64_t g0,
                                          int G, int lane,
                                          const int (&slot)[kRowRegs],
                                          int (&off)[kRowRegs],
                                          int (&cnt)[kSlotGroup]) {
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int q = 0; q < kRowRegs; ++q) {
    off[q] = 0;
    if (j0 + 32 * q >= Kf) continue;  // the same in every lane
    const int rel = slot[q] - (int)g0;
#pragma unroll
    for (int d = 0; d < kSlotGroup; ++d) {
      if (d >= G) break;
      const unsigned in_d = __ballot_sync(kFull, rel == d);
      if (rel == d) off[q] = cnt[d] + __popc(in_d & below);
      cnt[d] += __popc(in_d);
    }
  }
}

// The ring writes of a row's rounds whose slot lies in the group: entry at
// place base[slot - g0] + off, dropped at or past cap.
__device__ __forceinline__ void row_write(const EmitArgs& a, int64_t h,
                                          int64_t g0, int G,
                                          const int64_t* base,
                                          const int32_t (&id)[kRowRegs],
                                          const int (&slot)[kRowRegs],
                                          const int (&off)[kRowRegs]) {
#pragma unroll
  for (int q = 0; q < kRowRegs; ++q) {
    const int rel = slot[q] - (int)g0;  // a pad's is < 0
    if (rel < 0 || rel >= G) continue;
    const int64_t at = base[rel] + off[q];
    if (at < a.cap) a.ring[(h * a.D + slot[q]) * a.cap + at] = id[q];
  }
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long status,
                                        unsigned value) {
  __threadfence();  // what the tile read or wrote before, then the word
  *(volatile unsigned long long*)p = status | value;
}

// Warp-wide look-back of tile `tile` (> 0) over the G slots from g0: lane
// j reads the words of tile p - j, 32 tiles a round from p = tile - 1; per
// slot, the events of the tiles up to the nearest one that has published
// its inclusive prefix.  Lane d returns slot g0 + d's exclusive prefix.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* words, int64_t D, int64_t g0, int G,
    int64_t tile, int lane) {
  const long long start = clock64();
  unsigned excl = 0;
  unsigned open = (1u << G) - 1;  // slots still looking back
  for (int64_t p = tile - 1; open != 0; p -= 32) {
    const int64_t j = p - lane;  // before tile 0: a prefix of 0
    const unsigned long long* w = words + j * D + g0;
    unsigned long long v[kSlotGroup];
#pragma unroll
    for (int d = 0; d < kSlotGroup; ++d)
      v[d] = d < G && (open >> d & 1) && j >= 0 ? peek(w + d) : kPrefix;
#pragma unroll
    for (int d = 0; d < kSlotGroup; ++d)
      while ((v[d] >> 32) == 0) {
        // every tile before this one was taken by a running block; one
        // that has not published after ~10 s of clock is a fault: trap
        // rather than hang the card
        if (clock64() - start > kLookBackCycles) __trap();
        v[d] = peek(w + d);
      }
#pragma unroll
    for (int d = 0; d < kSlotGroup; ++d) {
      if (d >= G) break;
      if (!(open >> d & 1)) continue;
      const unsigned pre = __ballot_sync(kFull, (v[d] >> 32) == 2);
      const int stop = pre != 0 ? __ffs(pre) - 1 : 31;
      const unsigned sum =
          __reduce_add_sync(kFull, lane <= stop ? (unsigned)v[d] : 0u);
      if (lane == d) excl += sum;
      if (pre != 0) open &= ~(1u << d);
    }
  }
  __threadfence();  // the words seen, then what the tile does next
  return excl;
}

// The last listed source's tile, for the G slots from g0 (warp 0; lane d:
// slot g0 + d's old count plus its events): ev_count = min(total, cap),
// sat += the events past cap, and n_dropped with the first group.
__device__ __forceinline__ void finish(const EmitArgs& a, int64_t h,
                                       int64_t g0, int G, int lane,
                                       long long total) {
  long long over = 0;
  if (lane < G) {
    a.count[h * a.D + g0 + lane] = (int32_t)(total < a.cap ? total : a.cap);
    over = total > a.cap ? total - a.cap : 0;
  }
  over = __reduce_add_sync(kFull, (unsigned)over);
  if (lane == 0)
    a.sat[h] += (g0 == 0 ? a.n_dropped[h] : 0) + (int32_t)over;
}

__device__ __forceinline__ int group_size(int64_t D, int64_t g0) {
  return (int)(D - g0 < kSlotGroup ? D - g0 : kSlotGroup);
}

// kGroups: D may exceed kSlotGroup, so the slots run a group at a time;
// without it (D <= kSlotGroup) the one pass is compiled alone, with the
// registers of a single group.
template <bool kGroups>
__global__ void __launch_bounds__(kEmitThreads) emit_scan(EmitArgs a) {
  __shared__ int warp_cnt[kEmitWarps][kSlotGroup];
  __shared__ int64_t base[kEmitWarps][kSlotGroup];
  __shared__ int64_t tile_s;
  __shared__ bool last;
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = step_t(a.ctr, a.t);
  unsigned long long* words = a.words + h * a.tiles * a.D;
  unsigned int* ctrl = a.ctrl + 2 * h;
  for (;;) {
    // a block takes a tile only when it can walk it: a tile taken early
    // would keep the tiles after it waiting in their look-back
    if (threadIdx.x == 0) tile_s = atomicAdd(ctrl, 1u);
    __syncthreads();
    const int64_t tile = tile_s;
    const int64_t row0 = tile * kEmitWarps;
    if (listed(a, h, row0) < 0) {
      // the fill: no tile from here on.  No source listed at all: the
      // counts as they are, the drops
      if (tile == 0 && warp == 0)
        for (int64_t g0 = 0; g0 < a.D; g0 += kSlotGroup) {
          const int G = group_size(a.D, g0);
          finish(a, h, g0, G, lane,
                 lane < G ? a.count[h * a.D + g0 + lane] : 0);
        }
      break;
    }
    // the warp's row, and whether this tile holds the last listed source
    const int32_t s = listed(a, h, row0 + warp);
    const bool ends = listed(a, h, row0 + kEmitWarps) < 0;
    const int32_t* row = a.fwd + (h * a.S + (s < 0 ? 0 : s)) * a.Kf;
    // the row's first kRowRegs rounds in registers, kept for every group
    int32_t id[kRowRegs];
    int slot[kRowRegs], off[kRowRegs];
#pragma unroll
    for (int q = 0; q < kRowRegs; ++q) slot[q] = -1;
    if (s >= 0) row_load(a, h, row, 0, t, lane, id, slot);
    // the slots a group at a time: each group's counts, scan and writes
    // depend on no other group's
    for (int64_t g0 = 0; g0 < (kGroups ? a.D : 1); g0 += kSlotGroup) {
      const int G = group_size(a.D, g0);
      // warp 0 reads the group's old counts before the tile publishes it
      long long old = 0;
      if (warp == 0 && lane < G) old = a.count[h * a.D + g0 + lane];
      // a row a warp: counts per slot and each entry's place in its row
      int cnt[kSlotGroup];
#pragma unroll
      for (int d = 0; d < kSlotGroup; ++d) cnt[d] = 0;
      if (s >= 0) {
        row_count(a.Kf, 0, g0, G, lane, slot, off, cnt);
        for (int64_t j0 = 32 * kRowRegs; j0 < a.Kf; j0 += 32 * kRowRegs) {
          int32_t id2[kRowRegs];
          int slot2[kRowRegs], off2[kRowRegs];
          row_load(a, h, row, j0, t, lane, id2, slot2);
          row_count(a.Kf, j0, g0, G, lane, slot2, off2, cnt);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int d = 0; d < kSlotGroup; ++d)
          if (d < G) warp_cnt[warp][d] = cnt[d];
      }
      __syncthreads();
      if (warp == 0) {
        // lane d: slot g0 + d's aggregate
        unsigned agg = 0;
        if (lane < G)
          for (int w = 0; w < kEmitWarps; ++w) agg += warp_cnt[w][lane];
        unsigned long long* mine = words + tile * a.D + g0;
        if (lane < G) publish(mine + lane, tile == 0 ? kPrefix : kAggregate,
                              agg);
        unsigned excl = 0;
        if (tile > 0) {
          excl = look_back(words, a.D, g0, G, tile, lane);
          if (lane < G) publish(mine + lane, kPrefix, excl + agg);
        }
        long long b0 = old + excl;
        for (int w = 0; w < kEmitWarps; ++w) {
          if (lane < G) base[w][lane] = b0;
          if (lane < G) b0 += warp_cnt[w][lane];
        }
        // the last listed source's tile: every earlier tile has published
        // the group, so every one has read its old counts
        if (ends) finish(a, h, g0, G, lane, old + excl + agg);
      }
      __syncthreads();
      if (s >= 0) {
        if (a.Kf <= 32 * kRowRegs) {
          row_write(a, h, g0, G, base[warp], id, slot, off);
        } else {  // a long row: read again, a segment at a time
#pragma unroll
          for (int d = 0; d < kSlotGroup; ++d) cnt[d] = 0;
          for (int64_t j0 = 0; j0 < a.Kf; j0 += 32 * kRowRegs) {
            int32_t id2[kRowRegs];
            int slot2[kRowRegs], off2[kRowRegs];
            row_load(a, h, row, j0, t, lane, id2, slot2);
            row_count(a.Kf, j0, g0, G, lane, slot2, off2, cnt);
            row_write(a, h, g0, G, base[warp], id2, slot2, off2);
          }
        }
      }
      __syncthreads();  // before the next group's or tile's shared state
    }
  }
  // the last block of the shard to leave clears the tile state: every
  // tile of the launch has ended, and the counter ends at the tiles with
  // work + one empty tile a block
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ctrl + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t used = (int64_t)*(volatile unsigned int*)ctrl - gridDim.x;
  for (int64_t i = threadIdx.x; i < used * a.D; i += kEmitThreads)
    words[i] = 0;
  if (threadIdx.x == 0) {
    ctrl[0] = 0;
    ctrl[1] = 0;
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

// ptrs: ring, count, syn_tgt, row_ptr, plastic, last_post, w, last_arr,
// i_syn, n_arrived, fill, pairs, total, ctr (or null).
// ints: H, D, cap, E, N, t.
// floats: a_minus, inv_tau_minus, w_min, w_max, half_neg_time.
extern "C" int repro_event_arrival(void* const* ptrs, const int64_t* ints,
                                   const float* floats, void* stream) {
  ArrivalArgs a;
  a.ring = (int32_t*)ptrs[0];
  a.count = (int32_t*)ptrs[1];
  a.syn_tgt = (const int64_t*)ptrs[2];
  a.row_ptr = (const int32_t*)ptrs[3];
  a.plastic = (const uint8_t*)ptrs[4];
  a.last_post = (const float*)ptrs[5];
  a.w = (float*)ptrs[6];
  a.last_arr = (float*)ptrs[7];
  a.i_syn = (float*)ptrs[8];
  a.n_arrived = (int64_t*)ptrs[9];
  a.fill = (int32_t*)ptrs[10];
  a.pairs = (int2*)ptrs[11];
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
  const int64_t groups = kThreads / kLanes;
  const dim3 events((unsigned)stride_blocks(a.cap, kThreads, H), (unsigned)H);
  const dim3 targets((unsigned)((a.N + groups - 1) / groups), (unsigned)H);
  arrival_place<<<events, kThreads, 0, s>>>(a);
  arrival_sum<<<targets, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of emit_scan<kGroups> a shard: a few an SM across the H shards,
// at most one a tile; returns a cudaError_t.
template <bool kGroups>
static int emit_blocks(int64_t H, int64_t tiles, int64_t* out) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < 64 ? cache[dev] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, emit_scan<kGroups>, kEmitThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm < kEmitBlocksPerSM ? per_sm : kEmitBlocksPerSM);
    if (dev < 64) cache[dev] = resident;
  }
  int64_t blocks = resident / (H > 0 ? H : 1);
  blocks = blocks > tiles ? tiles : blocks;
  *out = blocks < 1 ? 1 : blocks;
  return 0;
}

// ptrs: src_ids, n_dropped, fwd, delay, ring, count, sat, words, ctrl,
// ctr (or null).  ints: H, D, cap, E, S, Kf, C, t, tiles (the words'
// tiles a shard: ceil(C / 8), at least 1).
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
  a.words = (unsigned long long*)ptrs[7];
  a.ctrl = (unsigned int*)ptrs[8];
  a.ctr = (const int64_t*)ptrs[9];
  const int64_t H = ints[0];
  a.D = ints[1];
  a.cap = ints[2];
  a.E = ints[3];
  a.S = ints[4];
  a.Kf = ints[5];
  a.C = ints[6];
  a.t = ints[7];
  a.tiles = ints[8];
  if (a.D < 1 || a.tiles * kEmitWarps < a.C || a.tiles < 1)
    return (int)cudaErrorInvalidValue;
  const bool groups = a.D > kSlotGroup;
  int64_t blocks = 0;
  const int err = groups ? emit_blocks<true>(H, a.tiles, &blocks)
                         : emit_blocks<false>(H, a.tiles, &blocks);
  if (err != 0) return err;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  if (groups)
    emit_scan<true><<<grid, kEmitThreads, 0, (cudaStream_t)stream>>>(a);
  else
    emit_scan<false><<<grid, kEmitThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
