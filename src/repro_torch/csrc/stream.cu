// Chunk regeneration for streamed connectivity: one chunk of every shard's
// incoming synapses, rebuilt from the counter-based draw lanes, in
// canonical (tgt, src, j) order.
//
// Replaces `repro/core/stream_engine.py::make_chunk_tables` (plain jnp, no
// Pallas kernel: uint32-limb splitmix64 over every generation slot of the
// chunk's k_cap = c_cap * M window, ring selection by integer threshold,
// ownership and range filter, then a stable argsort of all k_cap slots on
// the target).  The streamed phases then run the dense kernels' chunk
// windows on the tables this writes (`csrc/stdp.cu`, `csrc/arborize.cu`).
//
// Output, for chunk c (a launch argument, so a captured CUDA graph holds
// one node a chunk): row_ptr [H, q + 1] int32, the chunk's per-target CSR
// in absolute state positions (row_ptr[h, 0] = e_start[h, c]), and per kept
// synapse in canonical order its source-table row, delay and plastic flag
// ([H, K], K the largest chunk's kept count, known at plan time; entries
// past a shard's kept count are left as they were).
//
// Three launches:
//   gen    a block a group of G candidates (about kGroupSlots slots; every
//          gridDim.x-th, so the inhibitory ones, whose slots all go on to
//          lane 2, spread over the blocks), a warp a candidate at a time,
//          its lanes over the slots.  What belongs to a candidate is found
//          once, in shared memory: its gid, column, excitatory flag,
//          counter base gid * M, and the set of rings holding an offset
//          whose target column lies in the chunk's column interval (every
//          target gid of chunk c lies in one gid interval under either
//          placement, so in one column interval).  Then the draws go in
//          order of need, no barrier among the warps:
//            1. excitatory slots draw lane 0 (the ring, by the thresholds
//               U[k] = ceil(fr[k] * 2^53) on the top 53 bits); a slot whose
//               ring is not in the candidate's set stops here (about 92%
//               at 8x8, K = 1).  Where the set is one ring, a lane keeps a
//               bit a slot over kBatch passes and the warp queues the
//               slots left once a batch.  Inhibitory slots of a candidate
//               whose own column is in the interval go on without a draw;
//            2. each time the warp's first queue holds 32 slots, it draws
//               lane 1 for them (the ring's member, so the target column);
//               a slot whose column is outside the interval stops, the
//               others enter the second queue;
//            3. each time that holds 32, lane 2 (the target neuron), then
//               the reference's exact ownership and range test.
//          A kept synapse's key (ci << jbits | j, ci its source-table
//          row: unique, and ordered as generation order, which is
//          canonical, since a chunk's candidate rows ascend with their
//          gids) goes into its target's bucket at a slot taken from the
//          target's counter (each counter on its own 128-B line).  The
//          bucket's width B is the plan's longest row of any chunk; a key
//          past it is not written, and the scan flags the row.
//   scan   a block a shard: the exclusive scan of the per-target counts
//          gives row_ptr; the kept count is held against the plan's e_start
//          difference and K, a mismatch sets a bit of `status` (bit 0: a
//          count other than e_start's, bit 1: more than K, or a row longer
//          than B; read by the caller after the card has finished, never
//          in the step).  The counts are left zero for the next call.
//   sort   a warp a target row: its bucket's keys sorted in registers by
//          a bitonic network (shuffles between lanes); a row over 32 x
//          kSortRegs keys ranks each key by counting the bucket's keys
//          below it instead.  Each entry's lane decodes its
//          key, draws lane 3 (the delay) for an excitatory source alone
//          and writes the entry.  The keys are unique, so the order the
//          atomics ran in never reaches the tables.
//
// Modulus: every remainder in the slot path is by a modulus m < 2^16 and
// goes through host constants (`fastmod`: 2^32 mod m and c = ceil(2^64 /
// m), Lemire's exact 32-bit remainder (c * a mod 2^64) * m >> 64 and
// quotient c * a >> 64): (hi * 2^32 + lo) mod m = ((hi mod m) (2^32 mod m)
// + lo mod m) mod m, every term below 2^32.  No 64-bit division is left;
// wrap-around is a compare and an add.
//
// Bits: splitmix64 on native uint64 (wrapping) is the limbs' arithmetic,
// the remainders are exact, the ring is the count of thresholds at or
// below the top 53 bits, and the ring, column and exact tests only drop
// slots the reference drops, so the tables are the plain version's
// (`kernels/ref.py::chunk_tables`) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGenThreads = 256;
constexpr int kGroupSlots = 12800;  // slots a block, about
constexpr int kMaxGroup = 64;      // candidates a block
constexpr int kBatch = 8;          // lane-0 passes of 32 slots a batch
constexpr int kQueueA = 512;       // a warp's queues (powers of two)
constexpr int kQueueB = 64;
constexpr int kScanThreads = 1024;
constexpr int kSortThreads = 128;  // a warp a row
constexpr int kSortRegs = 16;      // a row of up to 32 x 16 keys in registers
constexpr int kMaskRings = 64;  // rings a candidate's ring set can name
// fastmod rows: npc, nexc, dspan, n_shards, then ring r's size at
// kModRing + r
enum { kModNpc, kModNexc, kModDspan, kModH, kModRing };

struct Gen {
  const int64_t* src_gid;  // [H, S] the plan's source table
  const int32_t* cand;     // [H, n_chunks, c_cap] source rows, -1 pad
  const int32_t* e_start;  // [H, n_chunks + 1]
  const int32_t* off;      // [n_off, 2] ring offsets (dx, dy)
  const int32_t* start;    // [reach + 2] ring starts in off
  const int64_t* thresh;   // [reach + 1] U
  const int64_t* bounds;   // [H + 1] block bounds
  const int64_t* fastmod;  // [kModRing + reach + 1, 3] m, 2^32 mod m, c
  const int64_t* shard_id; // [H] the rows' shards (scatter's residues)
  int32_t* row_ptr;        // [H, q + 1]
  int32_t* out_src;        // [H, K]
  int32_t* out_delay;      // [H, K]
  uint8_t* out_plastic;    // [H, K]
  int32_t* status;         // [1]
  uint32_t* bucket;        // [H, q, B] keys
  int32_t* count;          // [H, q, cstride] (element 0 used)
  int64_t H, S, n_chunks, c_cap, M, npc, nexc, gx, gy, delay_min, q, K, c,
      reach, scatter, n_neurons, B, cstride, jbits, n_shards, group;
  uint64_t lane[4];
};

struct FastMod {
  uint32_t m, r32;
  uint64_t mul;
};

__device__ __forceinline__ FastMod fastmod(const Gen& g, int64_t i) {
  FastMod f;
  f.m = (uint32_t)__ldg(g.fastmod + 3 * i);
  f.r32 = (uint32_t)__ldg(g.fastmod + 3 * i + 1);
  f.mul = (uint64_t)__ldg(g.fastmod + 3 * i + 2);
  return f;
}

// a mod m, exact for every 32-bit a (m = 1: mul 0, so 0)
__device__ __forceinline__ uint32_t fm_mod(uint32_t a, const FastMod& f) {
  return (uint32_t)__umul64hi(f.mul * a, f.m);
}

// a / m, exact for every 32-bit a (m = 1: mul wrapped to 0)
__device__ __forceinline__ uint32_t fm_div(uint32_t a, const FastMod& f) {
  return f.mul ? (uint32_t)__umul64hi(f.mul, a) : a;
}

// x mod m for a 64-bit x, m < 2^16
__device__ __forceinline__ uint32_t fm_mod64(uint64_t x, const FastMod& f) {
  return fm_mod(fm_mod((uint32_t)(x >> 32), f) * f.r32 +
                    fm_mod((uint32_t)x, f),
                f);
}

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// floor mod m of v, for v within a few m of [0, m)
__device__ __forceinline__ int32_t wrap(int32_t v, int32_t m) {
  while (v < 0) v += m;
  while (v >= m) v -= m;
  return v;
}

__device__ __forceinline__ const int32_t* cand_row(const Gen& g, int64_t h) {
  return g.cand + (h * g.n_chunks + g.c) * g.c_cap;
}

// The chunk's target gids of row h lie in [lo, hi] (hi < lo: none).  Under
// scatter row h is shard shard_id[h] of n_shards: its local index k is gid
// shard_id[h] + n_shards * k.
__device__ __forceinline__ void chunk_gids(const Gen& g, int64_t h,
                                           int64_t* lo, int64_t* hi) {
  const int64_t first = g.c * g.q;
  if (g.scatter) {
    const int64_t s = g.shard_id[h];
    *lo = s + g.n_shards * first;
    const int64_t last = s + g.n_shards * (first + g.q - 1);
    *hi = last < g.n_neurons - 1 ? last : g.n_neurons - 1;
  } else {
    *lo = g.bounds[h] + first;
    const int64_t end = *lo + g.q < g.bounds[h + 1] ? *lo + g.q
                                                    : g.bounds[h + 1];
    *hi = end - 1;
  }
}

enum { kDead = 0, kExc = 1, kInh = 2 };

// The block's view of its candidates and of the profile's small tables.
struct GenShared {
  // per candidate of the block's group
  uint64_t base[kMaxGroup];   // counter base gid * M
  uint64_t lo64[kMaxGroup];   // the ring set's hull [a, b] as the range
  uint64_t span64[kMaxGroup]; //   [lo64, lo64 + span64] of a lane-0 draw
  unsigned long long mask[kMaxGroup];
  int32_t col[kMaxGroup], cx[kMaxGroup], cy[kMaxGroup];
  int16_t a[kMaxGroup], b[kMaxGroup];
  uint8_t kind[kMaxGroup];
  uint32_t ci[kMaxGroup];     // its source-table row
  // the profile's tables, where reach < kMaskRings
  uint64_t U[kMaskRings];
  int32_t start[kMaskRings + 1];
  FastMod ring_mod[kMaskRings];
  // each warp's queues: the slots lane 0 left, (candidate << 16 | j) and
  // ring, and those lane 1 left, with their target column
  uint32_t qa_item[kGenThreads / 32][kQueueA];
  uint16_t qa_ring[kGenThreads / 32][kQueueA];
  uint32_t qb_item[kGenThreads / 32][kQueueB];
  int32_t qb_col[kGenThreads / 32][kQueueB];
  int64_t gid_lo, gid_hi;
  int32_t col_lo, col_hi;
};

// Lane 1 for a slot that lane 0 left: its target column (an inhibitory
// source's own column, without a draw), or -1 where the column is outside
// the chunk's interval.
__device__ __forceinline__ int32_t draw_column(const Gen& g,
                                               const GenShared& sh,
                                               bool masked, uint32_t item,
                                               int ring) {
  const uint32_t t = item >> 16, j = item & 0xFFFFu;
  if (sh.kind[t] != kExc) return sh.col[t];
  const int32_t st = masked ? sh.start[ring] : __ldg(g.start + ring);
  const uint32_t member =
      fm_mod64(splitmix64((sh.base[t] + j) ^ g.lane[1]),
               masked ? sh.ring_mod[ring] : fastmod(g, kModRing + ring));
  const int32_t dx = __ldg(g.off + 2 * (st + member));
  const int32_t dy = __ldg(g.off + 2 * (st + member) + 1);
  const int32_t tc = wrap(sh.cy[t] + dy, (int32_t)g.gy) * (int32_t)g.gx +
                     wrap(sh.cx[t] + dx, (int32_t)g.gx);
  return tc < sh.col_lo || tc > sh.col_hi ? -1 : tc;
}

// Lane 2 and the exact test for a slot in target column tc; a kept
// synapse's key goes to its target's bucket (none past B: the scan flags
// the row).
__device__ __forceinline__ void draw_target(const Gen& g, const GenShared& sh,
                                            int64_t h, uint32_t item,
                                            int32_t tc, const FastMod& f_npc,
                                            const FastMod& f_nexc,
                                            const FastMod& f_h) {
  const uint32_t t = item >> 16, j = item & 0xFFFFu;
  const int64_t tgt =
      (int64_t)tc * g.npc +
      fm_mod64(splitmix64((sh.base[t] + j) ^ g.lane[2]),
               sh.kind[t] == kExc ? f_npc : f_nexc);
  // ownership and the chunk's range, exactly the reference's test
  if (tgt < sh.gid_lo || tgt > sh.gid_hi) return;
  uint32_t rel = (uint32_t)(tgt - sh.gid_lo);
  if (g.scatter) {
    if (fm_mod(rel, f_h) != 0u) return;
    rel = fm_div(rel, f_h);
  }
  const uint32_t key = sh.ci[t] << g.jbits | j;
  const int64_t row = h * g.q + rel;
  const int32_t slot = atomicAdd(g.count + row * g.cstride, 1);
  if (slot < g.B) g.bucket[row * g.B + slot] = key;
}

// Shard h's row pointers: the exclusive scan of its per-target counts (read
// at L2, where the counters' atomics landed), by a block of NT threads;
// leaves the counts zero and flags the shard's status.
template <int NT>
__device__ __forceinline__ void scan_shard(const Gen& g, int64_t h) {
  __shared__ int32_t warp_sum[NT / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t e0 = g.e_start[h * (g.n_chunks + 1) + g.c];
  const int32_t e1 = g.e_start[h * (g.n_chunks + 1) + g.c + 1];
  int32_t* cnt = g.count + h * g.q * g.cstride;
  int32_t* rp = g.row_ptr + h * (g.q + 1);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < g.q; base += NT) {
    const int64_t k = base + threadIdx.x;
    const int32_t v = k < g.q ? __ldcg(cnt + k * g.cstride) : 0;
    int32_t incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < NT / 32 ? warp_sum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < NT / 32) warp_sum[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) +
                         incl - v;
    if (k < g.q) {
      rp[k] = e0 + excl;
      cnt[k * g.cstride] = 0;
      if (v > g.B) atomicOr(g.status, 2);
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[NT / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    rp[g.q] = e0 + carry;
    if (carry != e1 - e0) atomicOr(g.status, 1);
    if (carry > g.K) atomicOr(g.status, 2);
  }
}

__global__ void __launch_bounds__(kGenThreads) gen_kernel(const Gen g) {
  __shared__ GenShared sh;
  const int64_t h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = (int)g.group;
  const int32_t* cr = cand_row(g, h);
  const FastMod f_npc = fastmod(g, kModNpc), f_nexc = fastmod(g, kModNexc),
                f_h = fastmod(g, kModH);
  const int reach = (int)g.reach;
  const bool masked = reach < kMaskRings;

  if (tid == 0) {
    int64_t lo, hi;
    chunk_gids(g, h, &lo, &hi);
    sh.gid_lo = lo;
    sh.gid_hi = hi;
    // gids < 2^32 (checked by the wrapper)
    sh.col_lo = lo <= hi ? (int32_t)fm_div((uint32_t)lo, f_npc) : 1;
    sh.col_hi = lo <= hi ? (int32_t)fm_div((uint32_t)hi, f_npc) : 0;
  }
  if (masked) {
    for (int i = tid; i <= reach + 1; i += kGenThreads) {
      sh.start[i] = __ldg(g.start + i);
      if (i <= reach) {
        sh.U[i] = (uint64_t)__ldg(g.thresh + i);
        sh.ring_mod[i] = fastmod(g, kModRing + i);
      }
    }
  }
  __syncthreads();
  const int32_t col_lo = sh.col_lo, col_hi = sh.col_hi;
  if (tid < G) {
    // the block's candidates are every gridDim.x-th, so that each block
    // gets its share of the few whose slots all go on to lane 2
    const int64_t cp = blockIdx.x + (int64_t)tid * gridDim.x;
    const int32_t ci = cp < g.c_cap ? cr[cp] : -1;
    uint8_t kind = kDead;
    if (ci >= 0 && col_lo <= col_hi) {
      const int64_t gid = g.src_gid[h * g.S + ci];
      const uint32_t col = fm_div((uint32_t)gid, f_npc);
      const bool exc = (uint32_t)gid - col * (uint32_t)g.npc <
                       (uint32_t)g.nexc;
      sh.base[tid] = (uint64_t)gid * (uint64_t)g.M;
      sh.ci[tid] = (uint32_t)ci;
      sh.col[tid] = (int32_t)col;
      sh.cx[tid] = (int32_t)(col % (uint32_t)g.gx);
      sh.cy[tid] = (int32_t)(col / (uint32_t)g.gx);
      kind = exc ? kExc
                 : ((int32_t)col >= col_lo && (int32_t)col <= col_hi ? kInh
                                                                     : kDead);
    }
    sh.kind[tid] = kind;
    sh.mask[tid] = 0ull;
  }
  __syncthreads();
  // each candidate's ring set: the rings of the offsets (dx, dy), |dx|,
  // |dy| <= reach, that wrap its column onto a column of the interval (a
  // displacement and its aliases a target column)
  const int gx = (int)g.gx, gy = (int)g.gy;
  const int n_tc = masked && col_lo <= col_hi ? col_hi - col_lo + 1 : 0;
  for (int i = tid; i < G * n_tc; i += kGenThreads) {
    const int t = i / n_tc, tc = col_lo + (i - t * n_tc);
    if (sh.kind[t] != kExc) continue;
    int32_t dx0 = wrap(tc % gx - sh.cx[t], gx);
    int32_t dy0 = wrap(tc / gx - sh.cy[t], gy);
    while (dx0 - gx >= -reach) dx0 -= gx;
    while (dy0 - gy >= -reach) dy0 -= gy;
    unsigned long long bits = 0ull;
    for (int32_t dx = dx0; dx <= reach; dx += gx)
      for (int32_t dy = dy0; dy <= reach; dy += gy) {
        const int32_t ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
        bits |= 1ull << (ax > ay ? ax : ay);
      }
    if (bits) atomicOr(&sh.mask[t], bits);
  }
  __syncthreads();
  if (tid < G && sh.kind[tid] == kExc) {
    unsigned long long m = masked ? sh.mask[tid] : ~0ull;
    int a = 0, b = reach;
    if (masked) {
      if (m == 0ull) {
        sh.kind[tid] = kDead;
      } else {
        a = __ffsll((long long)m) - 1;
        b = 63 - __clzll((long long)m);
      }
    }
    // ring >= a iff bits53 >= U[a - 1]; ring <= b iff bits53 < U[b]; and
    // bits53 = x >> 11 lies in [lo, hi) iff x lies in [lo << 11, (hi <<
    // 11) - 1], which fits 64 bits (hi = 2^53 wraps to 2^64 - 1)
    const uint64_t lo = a > 0 ? (uint64_t)__ldg(g.thresh + a - 1) : 0ull;
    const uint64_t hi = b < reach ? (uint64_t)__ldg(g.thresh + b)
                                  : (1ull << 53);
    if (hi <= lo) sh.kind[tid] = kDead;  // the rings hold no mass
    sh.mask[tid] = m;
    sh.a[tid] = (int16_t)a;
    sh.b[tid] = (int16_t)b;
    sh.lo64[tid] = lo << 11;
    sh.span64[tid] = ((hi << 11) - 1ull) - (lo << 11);
  }
  __syncthreads();

  // The walk: each warp its candidates' slots and its two queues of the
  // slots lanes 0 and 1 left.  No barrier.
  const uint32_t M = (uint32_t)g.M;
  uint32_t* qa_item = sh.qa_item[warp];
  uint16_t* qa_ring = sh.qa_ring[warp];
  uint32_t* qb_item = sh.qb_item[warp];
  int32_t* qb_col = sh.qb_col[warp];
  int qa_head = 0, qa_n = 0, qb_head = 0, qb_n = 0;  // warp-uniform
  const uint64_t* U = masked ? sh.U : (const uint64_t*)g.thresh;
  const unsigned below = (1u << lane) - 1u;

  // lane 2 on the second queue's oldest 32
  auto drain_b = [&]() {
    __syncwarp();
    const int p = (qb_head + lane) & (kQueueB - 1);
    const uint32_t item = qb_item[p];
    const int32_t tc = qb_col[p];
    __syncwarp();
    qb_head = (qb_head + 32) & (kQueueB - 1);
    qb_n -= 32;
    draw_target(g, sh, h, item, tc, f_npc, f_nexc, f_h);
  };
  // lane 1 on the first queue's oldest min(32, qa_n), into the second
  auto drain_a = [&]() {
    __syncwarp();
    const int p = (qa_head + lane) & (kQueueA - 1);
    const bool live = lane < qa_n;
    const uint32_t item = live ? qa_item[p] : 0u;
    const int ring = live ? qa_ring[p] : 0;
    __syncwarp();
    const int took = qa_n < 32 ? qa_n : 32;
    qa_head = (qa_head + took) & (kQueueA - 1);
    qa_n -= took;
    const int32_t tc = live ? draw_column(g, sh, masked, item, ring) : -1;
    const unsigned act = __ballot_sync(0xffffffffu, tc >= 0);
    if (tc >= 0) {
      const int q = (qb_head + qb_n + __popc(act & below)) & (kQueueB - 1);
      qb_item[q] = item;
      qb_col[q] = tc;
    }
    qb_n += __popc(act);
    if (qb_n >= 32) drain_b();
  };
  // a candidate's lane-0 view, in registers for its walk
  struct Cand {
    uint64_t base, lo64, span64;
    unsigned long long mask;
    int a, b;
    uint32_t t, kind;
  };
  auto cand = [&](int t) {
    Cand c;
    c.t = (uint32_t)t;
    c.kind = t < G ? sh.kind[t] : (uint32_t)kDead;
    if (c.kind != kDead) {
      c.base = sh.base[t];
      c.lo64 = sh.lo64[t];
      c.span64 = sh.span64[t];
      c.mask = sh.mask[t];
      c.a = sh.a[t];
      c.b = sh.b[t];
    }
    return c;
  };
  // lane 0 on slot j of a candidate; pushes a slot it leaves
  auto lane0 = [&](const Cand& c, uint32_t j) {
    bool pass;
    int ring = c.a;
    if (c.kind == kExc) {
      const uint64_t x = splitmix64((c.base + j) ^ g.lane[0]);
      pass = j < M && x - c.lo64 <= c.span64;
      if (pass && c.a < c.b) {
        // more than one ring in the hull: which, and is it in the set
        const uint64_t bits53 = x >> 11;
        for (int k = c.a; k < c.b; ++k) ring += bits53 >= U[k];
        pass = ring >= 64 || ((c.mask >> ring) & 1ull);
      }
    } else {
      pass = j < M && c.kind == kInh;
    }
    const unsigned act = __ballot_sync(0xffffffffu, pass);
    if (pass) {
      const int q = (qa_head + qa_n + __popc(act & below)) & (kQueueA - 1);
      qa_item[q] = c.t << 16 | j;
      qa_ring[q] = (uint16_t)ring;
    }
    qa_n += __popc(act);
  };

  // A warp a candidate; lane 0 in batches of kBatch x 32 slots.  Where the
  // hull of the candidate's ring set is that set (one ring; or an
  // inhibitory candidate), a lane keeps a bit a slot of the batch and the
  // warp queues the slots left after the batch (a scan of the lanes'
  // counts); otherwise each pass of 32 queues its own.
  for (int t = warp; t < G; t += kGenThreads / 32) {
    const Cand c = cand(t);
    if (c.kind == kDead) continue;
    const bool exc = c.kind == kExc;
    const bool one_ring = !exc || c.a == c.b;
    const uint16_t ring_a = exc ? (uint16_t)c.a : (uint16_t)0;
    for (uint32_t j0 = 0; j0 < M; j0 += 32 * kBatch) {
      if (one_ring) {
        uint32_t bits = 0;
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const uint32_t j = j0 + r * 32 + lane;
          bool pass = j < M;
          if (exc) {
            const uint64_t x = splitmix64((c.base + j) ^ g.lane[0]);
            pass = pass && x - c.lo64 <= c.span64;
          }
          bits |= (uint32_t)pass << r;
        }
        const int n = __popc(bits);
        int incl = n;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        int q = qa_head + qa_n + incl - n;
        qa_n += __shfl_sync(0xffffffffu, incl, 31);
        while (bits) {
          const int r = __ffs(bits) - 1;
          bits &= bits - 1u;
          qa_item[q & (kQueueA - 1)] = c.t << 16 | (j0 + r * 32 + lane);
          qa_ring[q & (kQueueA - 1)] = ring_a;
          ++q;
        }
      } else {
        for (int r = 0; r < kBatch && j0 + r * 32 < M; ++r)
          lane0(c, j0 + r * 32 + lane);
      }
      while (qa_n >= 32) drain_a();
    }
  }
  while (qa_n > 0) drain_a();
  // the second queue's last slots (fewer than 32)
  __syncwarp();
  const int p = (qb_head + lane) & (kQueueB - 1);
  const bool live = lane < qb_n;
  const uint32_t item = live ? qb_item[p] : 0u;
  const int32_t tc = live ? qb_col[p] : 0;
  if (live) draw_target(g, sh, h, item, tc, f_npc, f_nexc, f_h);
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Gen g) {
  scan_shard<kScanThreads>(g, blockIdx.x);
}

// Writes the entry at chunk position pos (< K) of shard h from its key.
__device__ __forceinline__ void put_entry(const Gen& g, int64_t h,
                                          int64_t pos, uint32_t key,
                                          const FastMod& f_npc,
                                          const FastMod& f_dspan) {
  const int32_t ci = (int32_t)(key >> g.jbits);
  const uint32_t j = key & ((1u << g.jbits) - 1u);
  const int64_t gid = g.src_gid[h * g.S + ci];
  const uint32_t gl = (uint32_t)gid;
  const bool exc = gl - fm_div(gl, f_npc) * (uint32_t)g.npc <
                   (uint32_t)g.nexc;
  int32_t delay = (int32_t)g.delay_min;
  if (exc)
    delay += (int32_t)fm_mod64(
        splitmix64(((uint64_t)gid * (uint64_t)g.M + j) ^ g.lane[3]), f_dspan);
  const int64_t out = h * g.K + pos;
  g.out_src[out] = ci;
  g.out_delay[out] = delay;
  g.out_plastic[out] = exc ? 1 : 0;
}

// One step of a bitonic network over 32 R keys, x[r] being element r * 32
// + lane: blocks of K sorted up where element & K is 0, compare-exchange at
// distance J (between lanes by a shuffle below 32, else within a lane's
// registers), then the steps at J / 2 .. 1.
template <int R, int K, int J>
__device__ __forceinline__ void bitonic_step(uint32_t (&x)[R], int lane) {
  if constexpr (J >= 32) {
    constexpr int rr = J >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & rr) continue;
      const bool up = (((r << 5) | lane) & K) == 0;
      const uint32_t u = x[r], v = x[r | rr];
      x[r] = up ? min(u, v) : max(u, v);
      x[r | rr] = up ? max(u, v) : min(u, v);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t u = x[r];
      const uint32_t v = __shfl_xor_sync(0xffffffffu, u, J);
      const bool up = (((r << 5) | lane) & K) == 0;
      x[r] = (((lane & J) == 0) == up) ? min(u, v) : max(u, v);
    }
  }
  if constexpr (J > 1) bitonic_step<R, K, J / 2>(x, lane);
}

template <int R, int K>
__device__ __forceinline__ void bitonic_sort(uint32_t (&x)[R], int lane) {
  bitonic_step<R, K, K / 2>(x, lane);
  if constexpr (K < 32 * R) bitonic_sort<R, K * 2>(x, lane);
}

// Sorts a row of up to 32 R keys, ascending (padding 0xFFFFFFFF, above
// every key), then writes each entry below m at chunk position b + its
// place.
template <int R>
__device__ __forceinline__ void sort_row(const Gen& g, int64_t h, int64_t b,
                                         int m, const uint32_t* keys,
                                         int lane, const FastMod& f_npc,
                                         const FastMod& f_dspan) {
  uint32_t x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    x[r] = e < m ? keys[e] : 0xFFFFFFFFu;
  }
  bitonic_sort<R, 2>(x, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < m && b + e < g.K) put_entry(g, h, b + e, x[r], f_npc, f_dspan);
  }
}

__global__ void __launch_bounds__(kSortThreads) sort_kernel(const Gen g) {
  __shared__ uint32_t s_keys[kSortThreads / 32][32 * kSortRegs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t rel = (int64_t)blockIdx.x * (kSortThreads / 32) + warp;
  const int64_t h = blockIdx.y;
  if (rel >= g.q) return;  // the whole warp (no block barrier here)
  const int32_t* rp = g.row_ptr + h * (g.q + 1);
  const int64_t b = rp[rel] - rp[0];
  const int n = rp[rel + 1] - rp[rel];
  // a row past B kept no key past it (the scan flagged it)
  if (n == 0 || b >= g.K || n > g.B) return;
  const uint32_t* bk = g.bucket + (h * g.q + rel) * g.B;
  const FastMod f_npc = fastmod(g, kModNpc), f_dspan = fastmod(g, kModDspan);
  if (n > 32 * kSortRegs) {
    // a long row: each key's rank is the number of the row's keys below it
    for (int i = lane; i < n; i += 32) {
      const uint32_t key = bk[i];
      int64_t pos = b;
      for (int k = 0; k < n; ++k) pos += bk[k] < key;
      if (pos < g.K) put_entry(g, h, pos, key, f_npc, f_dspan);
    }
    return;
  }
  uint32_t* keys = s_keys[warp];
  for (int i = lane; i < n; i += 32) keys[i] = bk[i];
  __syncwarp();
  if (n <= 8 * 32)
    sort_row<8>(g, h, b, n, keys, lane, f_npc, f_dspan);
  else
    sort_row<16>(g, h, b, n, keys, lane, f_npc, f_dspan);
}

}  // namespace

// ptrs: src_gid, cand, e_start, off, start, thresh, bounds, fastmod,
// row_ptr, src, delay, plastic, status, bucket, count, shard_id.  ints: H,
// S, n_chunks, c_cap, M, npc, nexc, gx, gy, delay_min, q, K, c, reach,
// scatter, n_neurons, B, cstride, jbits, n_shards.  lanes: the four draw
// lanes' seeds.
extern "C" int repro_chunk_tables(void* const* ptrs, const int64_t* ints,
                                  const uint64_t* lanes, void* stream) {
  Gen g;
  g.src_gid = (const int64_t*)ptrs[0];
  g.cand = (const int32_t*)ptrs[1];
  g.e_start = (const int32_t*)ptrs[2];
  g.off = (const int32_t*)ptrs[3];
  g.start = (const int32_t*)ptrs[4];
  g.thresh = (const int64_t*)ptrs[5];
  g.bounds = (const int64_t*)ptrs[6];
  g.fastmod = (const int64_t*)ptrs[7];
  g.row_ptr = (int32_t*)ptrs[8];
  g.out_src = (int32_t*)ptrs[9];
  g.out_delay = (int32_t*)ptrs[10];
  g.out_plastic = (uint8_t*)ptrs[11];
  g.status = (int32_t*)ptrs[12];
  g.bucket = (uint32_t*)ptrs[13];
  g.count = (int32_t*)ptrs[14];
  g.shard_id = (const int64_t*)ptrs[15];
  int64_t* const f[] = {&g.H,         &g.S,   &g.n_chunks, &g.c_cap,
                        &g.M,         &g.npc, &g.nexc,     &g.gx,
                        &g.gy,        &g.delay_min, &g.q,  &g.K,
                        &g.c,         &g.reach,     &g.scatter,
                        &g.n_neurons, &g.B,   &g.cstride,  &g.jbits,
                        &g.n_shards};
  for (int i = 0; i < (int)(sizeof(f) / sizeof(f[0])); ++i) *f[i] = ints[i];
  for (int k = 0; k < 4; ++k) g.lane[k] = lanes[k];
  // about kGroupSlots slots a block, as many candidates for each warp
  g.group = kGroupSlots / g.M < 1
                ? 1
                : (kGroupSlots / g.M > kMaxGroup ? kMaxGroup
                                                 : kGroupSlots / g.M);
  if (g.group >= kGenThreads / 32) g.group -= g.group % (kGenThreads / 32);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned H = (unsigned)g.H;
  gen_kernel<<<dim3((unsigned)((g.c_cap + g.group - 1) / g.group), H),
               kGenThreads, 0, s>>>(g);
  scan_kernel<<<H, kScanThreads, 0, s>>>(g);
  sort_kernel<<<dim3((unsigned)((g.q + kSortThreads / 32 - 1) /
                               (kSortThreads / 32)),
                    H),
                kSortThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}
