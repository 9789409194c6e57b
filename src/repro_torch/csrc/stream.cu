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
// Four launches:
//   gen    a thread a generation slot (candidate cp, forward slot j) of a
//          shard draws lane 2 (the target neuron) and, for an excitatory
//          source, lanes 0 (the ring, by the thresholds U[k] = ceil(fr[k] *
//          2^53) on the top 53 bits) and 1 (the ring's member), exactly as
//          `core/connectivity.py::forward_synapses`; a synapse whose target
//          the shard owns at a local index in [c*q, c*q + q) is appended
//          to the shard's scratch list as (key = cp * M + j, target) and
//          counted for its target (atomics: their order reaches nothing).
//          About 2.5% of the slots are kept at 8x8, K = 1.
//   scan   a block a shard: the exclusive scan of the per-target counts
//          gives row_ptr and each target's cursor; the kept count is held
//          against the plan's e_start difference and the list against K,
//          a mismatch sets a bit of `status` (read by the caller after the
//          card has finished, never in the step).
//   place  a thread a listed synapse puts its key at its target's cursor.
//   rank   a block a target row: each key's rank in the row is the number
//          of the row's keys below it (the row staged in shared memory).
//          Keys are unique and in generation order, which is canonical (the
//          candidates are ascending gids), so the atomics' order never
//          reaches the output.  The rank's thread decodes its key, draws
//          lane 3 (the delay) for the kept synapse alone and writes the
//          entry; it also leaves the row's count zero for the next call.
//
// The scratch (list [H, K] of key << 32 | target, placed keys [H, K], per-
// target counts [H, q], the list fill [H] and length [H]) comes from the
// wrapper; the counts and the fill are zero between calls.
//
// Bound: operations.  Each slot of a valid candidate draws one or three
// splitmix64 lanes (about 24 integer instructions each: the seed's xor, a
// 64-bit add, three shift-xors and two 64-bit multiplies) and each kept
// excitatory synapse a fourth; the tables it writes are ~9 B a kept
// synapse.  Simple first: a thread a slot, modulus by 32-bit remainders.
//
// Bits: splitmix64 on native uint64 (wrapping) is the limbs' arithmetic,
// and (hi * 2^32 + lo) mod m is taken as ((hi mod m) (2^32 mod m) + lo mod
// m) mod m, m < 2^16, the reference's `_mod64`: integer-exact, so the
// tables are the plain version's (`kernels/ref.py::chunk_tables`) bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kRankThreads = 256;
constexpr int kRankTile = 2048;  // a row's keys staged a pass

struct Gen {
  const int64_t* src_gid;  // [H, S] the plan's source table
  const int32_t* cand;     // [H, n_chunks, c_cap] source rows, -1 pad
  const int32_t* e_start;  // [H, n_chunks + 1]
  const int32_t* off;      // [n_off, 2] ring offsets (dx, dy)
  const int32_t* start;    // [reach + 2] ring starts in off
  const int64_t* thresh;   // [reach + 1] U
  const int64_t* bounds;   // [H + 1] block bounds
  int32_t* row_ptr;        // [H, q + 1]
  int32_t* out_src;        // [H, K]
  int32_t* out_delay;      // [H, K]
  uint8_t* out_plastic;    // [H, K]
  int32_t* status;         // [1]
  unsigned long long* list;  // [H, K]
  uint32_t* keys;          // [H, K]
  int32_t* count;          // [H, q]
  int32_t* fill;           // [H]
  int32_t* n_list;         // [H]
  int64_t H, S, n_chunks, c_cap, M, npc, nexc, gx, gy, delay_min, dspan, q,
      K, c, reach;
  int scatter;
  uint64_t lane[4];
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// x mod m for 0 < m < 2^16, in 32-bit remainders (every term fits 32 bits).
__device__ __forceinline__ uint32_t mod64(uint64_t x, uint32_t m) {
  const uint32_t r16 = 65536u % m;
  const uint32_t r32 = (r16 * r16) % m;
  return (((uint32_t)(x >> 32) % m) * r32 + (uint32_t)x % m) % m;
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t m) {
  const int64_t r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ const int32_t* cand_row(const Gen& g, int64_t h) {
  return g.cand + (h * g.n_chunks + g.c) * g.c_cap;
}

__global__ void __launch_bounds__(kThreads) gen_kernel(const Gen g) {
  const int64_t h = blockIdx.y;
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= g.c_cap * g.M) return;
  const int64_t cp = s / g.M, j = s - cp * g.M;
  const int32_t ci = cand_row(g, h)[cp];
  if (ci < 0) return;
  const int64_t gid = g.src_gid[h * g.S + ci];
  const uint64_t counter = (uint64_t)gid * (uint64_t)g.M + (uint64_t)j;
  const int64_t col = gid / g.npc;
  const bool exc = gid - col * g.npc < g.nexc;
  const uint64_t b2 = splitmix64(counter ^ g.lane[2]);
  int64_t tgt;
  if (exc) {
    const int64_t bits53 = (int64_t)(splitmix64(counter ^ g.lane[0]) >> 11);
    int64_t ring = 0;
    for (int64_t k = 0; k <= g.reach; ++k) ring += bits53 >= g.thresh[k];
    ring = ring < g.reach ? ring : g.reach;
    const int32_t st = g.start[ring];
    const uint32_t member = mod64(splitmix64(counter ^ g.lane[1]),
                                  (uint32_t)(g.start[ring + 1] - st));
    const int64_t ox = g.off[2 * (st + member)];
    const int64_t oy = g.off[2 * (st + member) + 1];
    const int64_t cx = col % g.gx, cy = col / g.gx;
    tgt = (floor_mod(cy + oy, g.gy) * g.gx + floor_mod(cx + ox, g.gx)) *
              g.npc +
          mod64(b2, (uint32_t)g.npc);
  } else {
    tgt = col * g.npc + mod64(b2, (uint32_t)g.nexc);
  }
  int64_t tloc;
  if (g.scatter) {
    if (tgt % g.H != h) return;
    tloc = tgt / g.H;
  } else {
    if (tgt < g.bounds[h] || tgt >= g.bounds[h + 1]) return;
    tloc = tgt - g.bounds[h];
  }
  const int64_t rel = tloc - g.c * g.q;
  if (rel < 0 || rel >= g.q) return;
  const int32_t idx = atomicAdd(g.fill + h, 1);
  if (idx < g.K)
    g.list[h * g.K + idx] =
        ((unsigned long long)(cp * g.M + j) << 32) | (uint32_t)rel;
  atomicAdd(g.count + h * g.q + rel, 1);
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Gen g) {
  const int64_t h = blockIdx.x;
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t e0 = g.e_start[h * (g.n_chunks + 1) + g.c];
  const int32_t e1 = g.e_start[h * (g.n_chunks + 1) + g.c + 1];
  int32_t* cnt = g.count + h * g.q;
  int32_t* rp = g.row_ptr + h * (g.q + 1);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < g.q; base += kScanThreads) {
    const int64_t k = base + threadIdx.x;
    const int32_t v = k < g.q ? cnt[k] : 0;
    int32_t incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) +
                         incl - v;
    if (k < g.q) {
      rp[k] = e0 + excl;
      cnt[k] = excl;  // the target's cursor for `place`
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    rp[g.q] = e0 + carry;
    const int32_t n = g.fill[h];
    g.n_list[h] = n;
    g.fill[h] = 0;
    if (carry != e1 - e0) atomicOr(g.status, 1);
    if (n > g.K) atomicOr(g.status, 2);
  }
}

__global__ void __launch_bounds__(kThreads) place_kernel(const Gen g) {
  const int64_t h = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t n = g.n_list[h];
  if (i >= (n < g.K ? n : g.K)) return;
  const unsigned long long e = g.list[h * g.K + i];
  const int32_t slot = atomicAdd(g.count + h * g.q + (uint32_t)e, 1);
  if (slot < g.K) g.keys[h * g.K + slot] = (uint32_t)(e >> 32);
}

__global__ void __launch_bounds__(kRankThreads) rank_kernel(const Gen g) {
  __shared__ uint32_t tile[kRankTile];
  const int64_t rel = blockIdx.x, h = blockIdx.y;
  const int32_t* rp = g.row_ptr + h * (g.q + 1);
  const int64_t e0 = rp[0];
  int64_t b = rp[rel] - e0, e = rp[rel + 1] - e0;
  if (threadIdx.x == 0) g.count[h * g.q + rel] = 0;
  b = b < g.K ? b : g.K;
  e = e < g.K ? e : g.K;
  const int64_t len = e - b;
  if (len <= 0) return;  // the whole block
  const uint32_t* row = g.keys + h * g.K + b;
  const int32_t* cr = cand_row(g, h);
  for (int64_t i0 = 0; i0 < len; i0 += kRankThreads) {
    const int64_t i = i0 + threadIdx.x;
    const uint32_t key = i < len ? row[i] : 0u;
    int64_t rank = 0;
    for (int64_t t0 = 0; t0 < len; t0 += kRankTile) {
      const int64_t tl = len - t0 < kRankTile ? len - t0 : kRankTile;
      __syncthreads();
      for (int64_t k = threadIdx.x; k < tl; k += kRankThreads)
        tile[k] = row[t0 + k];
      __syncthreads();
      if (i < len)
        for (int64_t k = 0; k < tl; ++k) rank += tile[k] < key;
    }
    if (i >= len) continue;
    const int64_t cp = key / g.M, j = key - cp * g.M;
    const int32_t ci = cr[cp];
    const int64_t gid = g.src_gid[h * g.S + ci];
    const bool exc = gid % g.npc < g.nexc;
    int32_t delay = (int32_t)g.delay_min;
    if (exc) {
      const uint64_t counter = (uint64_t)gid * (uint64_t)g.M + (uint64_t)j;
      delay += (int32_t)mod64(splitmix64(counter ^ g.lane[3]),
                              (uint32_t)g.dspan);
    }
    const int64_t out = h * g.K + b + rank;
    g.out_src[out] = ci;
    g.out_delay[out] = delay;
    g.out_plastic[out] = exc ? 1 : 0;
  }
}

}  // namespace

// ptrs: src_gid, cand, e_start, off, start, thresh, bounds, row_ptr, src,
// delay, plastic, status, list, keys, count, fill, n_list.
// ints: H, S, n_chunks, c_cap, M, npc, nexc, gx, gy, delay_min, dspan, q, K,
// c, reach, scatter.  lanes: the four draw lanes' seeds.
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
  g.row_ptr = (int32_t*)ptrs[7];
  g.out_src = (int32_t*)ptrs[8];
  g.out_delay = (int32_t*)ptrs[9];
  g.out_plastic = (uint8_t*)ptrs[10];
  g.status = (int32_t*)ptrs[11];
  g.list = (unsigned long long*)ptrs[12];
  g.keys = (uint32_t*)ptrs[13];
  g.count = (int32_t*)ptrs[14];
  g.fill = (int32_t*)ptrs[15];
  g.n_list = (int32_t*)ptrs[16];
  int64_t* const f[] = {&g.H,  &g.S,         &g.n_chunks, &g.c_cap,
                        &g.M,  &g.npc,       &g.nexc,     &g.gx,
                        &g.gy, &g.delay_min, &g.dspan,    &g.q,
                        &g.K,  &g.c,         &g.reach};
  for (int i = 0; i < (int)(sizeof(f) / sizeof(f[0])); ++i) *f[i] = ints[i];
  g.scatter = (int)ints[15];
  for (int k = 0; k < 4; ++k) g.lane[k] = lanes[k];
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned H = (unsigned)g.H;
  const int64_t slots = g.c_cap * g.M;
  gen_kernel<<<dim3((unsigned)((slots + kThreads - 1) / kThreads), H),
               kThreads, 0, s>>>(g);
  scan_kernel<<<H, kScanThreads, 0, s>>>(g);
  place_kernel<<<dim3((unsigned)((g.K + kThreads - 1) / kThreads), H),
                 kThreads, 0, s>>>(g);
  rank_kernel<<<dim3((unsigned)g.q, H), kRankThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}
