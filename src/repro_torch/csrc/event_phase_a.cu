// Event phase A after the arrivals (`repro/core/event_engine.py`,
// `phase_a_dynamics` from the stimulus on, and `phase_a_plasticity`; plain
// jnp in the JAX package, whose neuron update is the Pallas kernel
// `repro/kernels/izhikevich.py::izhikevich_update`): two kernels over the
// stacked shards (grid y = H).
//
// neuron_scan<true> (`repro_event_neurons` with integrate 1;
//   `kernels.event.event_neurons`): per neuron, the step's
//   stimulus, i_syn + ext, the Izhikevich update written back into v and
//   u (pads integrate and reset; only their flag is masked), the spike
//   masked by neuron_valid; then the spiking neurons are ranked in index
//   order by a single-pass scan with decoupled look-back (Merrill &
//   Garland 2016), as csrc/event.cu's emission ranks its sources: the
//   first C are listed in ids [H, C] with the fill N after them, the
//   spike count goes to count [H], and with bookkeeping on, last_post = t
//   of every spiking neuron and sat += max(0, count - C).
// neuron_scan<false> (`repro_event_neurons` with integrate 0;
//   `kernels.event.event_compact`): the same scan from a given spike mask
//   (the split schedule's plasticity half: the mask came out of the
//   dynamics half and the exchange).
// ltp_synapses (`repro_event_ltp`; `kernels.event.event_ltp`): LTP on the
//   listed rows, a warp a row over a grid sized to the card (see below).
//
// The step t and the stimulus row come from the device step counter
// (ctr[0], ctr[1]) when it is given, so nothing of the step is a launch
// argument and a captured CUDA graph replays the launches; else t is the
// launch argument and the stimulus is the step's own [H, K] row.
//
// What bounds them.  The neuron pass moves ~23 bytes a neuron (v, u in
// and out, i_syn, the two flags, the spike) and the list: 1.5 MB at 8x8,
// about 0.5 us; what it saves is the ~20 PyTorch operations it replaces.
// Its tiles: 256 threads, 4 neurons a thread (neuron n0 + q * 256 + i of
// thread i: every load and store coalesced), 1,024 neurons a tile.  The
// stimulus list of the shard (C*K entries, 64 at 8x8) is walked by warp
// 0 a ballot of 32 at a time; the entries that fall in the tile are
// added, in list order, by one lane into a shared array of the tile's
// currents (from +0.0: what a scatter_add_ into zeros gives).  The scan
// carries one 64-bit word a tile: 2 status bits and the spike count.  A
// persistent grid takes tiles in order from an atomic counter,
// so a tile looks back only at tiles that running blocks hold; a look-back
// that waits ~10 s of clock traps rather than hang the card.  A block that
// finds no tile left waits for the last tile's inclusive word (held by a
// running block) and writes its share of the fill; the last block to leave
// clears the tile words and counters, so the scratch is zero between
// launches (graph replays, repeated calls at one t).
//
// LTP.  The kernel it replaces (`stdp.cu::event_ltp_kernel`) gave a warp
// to each listed row in a grid of 2 blocks an SM, so in a burst (spikes
// cluster by column) each warp walked several rows one after another, 32
// dependent loads a round.  Here the grid is every block the card holds
// at once and the launch reads the list's length L = min(count, C) on the
// device: warp k takes listed rows k, k + warps, ..., the first of them
// loaded beside the count, so a sparse step's row costs three dependent
// loads (ids, row_ptr, the synapses), and a lane issues the loads of
// kUnroll synapses (plastic, last_arr, w: consecutive synapses of a row,
// coalesced) before it uses any.  Rows are not split over warps: the
// plan's rows are of about one length (in-degree), and a split by synapse
// measured no faster on them (PERF.md §6, row E2).  Bound: memory, ~13 bytes
// a synapse of a listed row (plastic and last_arr in, w in and out) and
// the list: 2.4 MB at the 8x8 main density, under 1 us, so the chain of
// dependent loads and the launch are what it costs.
//
// Bits: the same operations on the same elements as the plain versions
// (`kernels/ref.py::event_neurons`, `::event_ltp`): the Izhikevich update
// in the reference's literal order with fp32 literals, exp as XLA-CPU's
// polynomial (xla_exp.cuh), (x - t) / tau as a product with the fp32
// reciprocal 1/tau, and the library built with -fmad=false -ftz=true.
// Row n of the CSR, [row_ptr[n], row_ptr[n + 1]), holds exactly the valid
// synapses whose target is n (`core/engine.py::make_row_ptr`; the JAX
// plan's in_rows[n], valid first and sorted by target), so LTP needs
// neither syn_tgt nor syn_valid.
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                  // neurons a thread a tile
constexpr int kTile = kThreads * kPerThread;   // neurons a tile
constexpr int kUnroll = 8;                     // LTP synapses a lane a round
constexpr int kNeuronBlocksPerSM = 4;
constexpr int kLtpBlocksPerSM = 8;
constexpr unsigned kFull = 0xffffffffu;
// a tile word: status << 62 | spike count
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr long long kLookBackCycles = 1ll << 34;

static_assert(kPerThread * kWarps == 32,
              "a tile's (q, warp) parts are scanned by one warp");

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// A tile's word, one 64-bit store.  No fence: a word carries its value
// itself, and nothing a tile writes is read by another block of the
// launch (the list, count and sat are the next kernel's; the clearing of
// the words waits on the blocks' tickets, which are fenced).
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long status,
                                        unsigned long long value) {
  *(volatile unsigned long long*)p = status | value;
}

// The word at p once published (status != 0; with `inclusive`, once it
// holds the inclusive prefix); traps after ~10 s of clock from `start`.
__device__ __forceinline__ unsigned long long wait_word(
    const unsigned long long* p, long long start, bool inclusive = false) {
  unsigned long long w = peek(p);
  while ((w >> 62) == 0 || (inclusive && (w >> 62) != 2)) {
    if (clock64() - start > kLookBackCycles) __trap();
    w = peek(p);
  }
  return w;
}

// Warp-wide look-back of tile `tile` (> 0): lane j reads the word of tile
// p - j, 32 tiles a round from p = tile - 1, and the warp adds the values
// up to the nearest tile that has published its inclusive prefix.  Every
// lane returns the tile's exclusive prefix.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* words, int64_t tile, int lane) {
  const long long start = clock64();
  unsigned long long excl = 0;
  for (int64_t p = tile - 1;; p -= 32) {
    const int64_t j = p - lane;  // before tile 0: a prefix of 0
    const unsigned long long w = j >= 0 ? wait_word(words + j, start)
                                        : kPrefix;
    const unsigned pre = __ballot_sync(kFull, (w >> 62) == 2);
    const int stop = pre != 0 ? __ffs(pre) - 1 : 31;
    unsigned long long v = lane <= stop ? (w & kValueMask) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (pre != 0) break;
  }
  return excl;
}

struct NeuronArgs {
  const float* i_syn;          // [H, N]
  const int64_t* stim_idx;     // [rows, K]: the window, or the step's row
  const float* stim_amp;       // [rows, K]
  const uint8_t* exc;          // [H, N]
  const uint8_t* valid;        // [H, N] neuron_valid
  float* v;                    // [H, N]
  float* u;                    // [H, N]
  uint8_t* spiked;             // [H, N]: written (integrate) or read
  float* last_post;            // [H, N], or nullptr: not written
  int32_t* sat;                // [H], or nullptr: not written
  int64_t* count;              // [H] spike count
  int32_t* ids;                // [H, C]
  unsigned long long* words;   // [H, tiles] scratch, zero between launches
  unsigned int* ctrl;          // [H, 2] scratch: tile counter, blocks out
  const int64_t* ctr;          // step counter, or nullptr
  int64_t t, N, C, K, tiles;
  float a_exc, a_inh, b_exc, b_inh, c_exc, c_inh, d_exc, d_inh, v_peak, h,
      dt;
  int substeps;
};

template <bool kIntegrate>
__global__ void __launch_bounds__(kThreads) neuron_scan(NeuronArgs a) {
  // the tile's stimulus currents
  __shared__ float ext[kIntegrate ? kTile : 1];
  // the (q, warp) parts' inclusive totals, then their exclusive prefixes
  __shared__ unsigned long long part[32];
  __shared__ unsigned long long tile_excl;
  __shared__ int64_t tile_s;
  __shared__ bool last;
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t N = a.N, C = a.C;
  const int64_t tt = a.ctr != nullptr ? a.ctr[0] : a.t;
  const float t = (float)tt;
  const int64_t srow = a.ctr != nullptr ? a.ctr[1] : 0;
  const int64_t* sidx = a.stim_idx + (srow * gridDim.y + h) * a.K;
  const float* samp = a.stim_amp + (srow * gridDim.y + h) * a.K;
  unsigned long long* words = a.words + h * a.tiles;
  unsigned int* ctrl = a.ctrl + 2 * h;
  int32_t* ids = a.ids + h * C;
  for (;;) {
    // a block takes a tile only when it can work it: a tile taken early
    // would keep the tiles after it waiting in their look-back
    if (threadIdx.x == 0) tile_s = atomicAdd(ctrl, 1u);
    __syncthreads();
    const int64_t tile = tile_s;
    if (tile >= a.tiles) break;
    const int64_t n0 = tile * kTile;
    // the thread's neurons: their loads issued first, the stimulus staged
    // while they are in flight
    bool fired[kPerThread];
    float vv[kPerThread], uu[kPerThread], drive[kPerThread];
    bool ex[kPerThread], nv[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int64_t n = n0 + q * kThreads + threadIdx.x;
      const int64_t i = h * N + n;
      const bool in = n < N;
      fired[q] = false;
      if (kIntegrate) {
        vv[q] = in ? a.v[i] : 0.0f;
        uu[q] = in ? a.u[i] : 0.0f;
        drive[q] = in ? a.i_syn[i] : 0.0f;
        ex[q] = in && a.exc[i] != 0;
        nv[q] = in && a.valid[i] != 0;
      } else {
        fired[q] = in && a.spiked[i] != 0;
      }
    }
    if (kIntegrate) {
      for (int i = threadIdx.x; i < kTile; i += kThreads) ext[i] = 0.0f;
      __syncthreads();
      if (warp == 0) {
        // the list's entries in the tile, in list order, by lane 0
        for (int64_t j0 = 0; j0 < a.K; j0 += 32) {
          const int64_t j = j0 + lane;
          int p = -1;
          float amp = 0.0f;
          if (j < a.K) {
            const int64_t n = sidx[j];
            if (n >= n0 && n < n0 + kTile) {
              p = (int)(n - n0);
              amp = samp[j];
            }
          }
          for (unsigned hit = __ballot_sync(kFull, p >= 0); hit != 0;
               hit &= hit - 1) {
            const int src = __ffs(hit) - 1;
            const int pp = __shfl_sync(kFull, p, src);
            const float am = __shfl_sync(kFull, amp, src);
            if (lane == 0) ext[pp] = ext[pp] + am;
          }
        }
      }
      __syncthreads();
    }
    if (kIntegrate) {
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int64_t n = n0 + q * kThreads + threadIdx.x;
        if (n >= N) continue;
        const int64_t i = h * N + n;
        // i_tot = i_syn + i_ext; csrc/izhikevich.cu's update, literally
        const float cur = drive[q] + ext[q * kThreads + threadIdx.x];
        const float aa = ex[q] ? a.a_exc : a.a_inh;
        const float bb = ex[q] ? a.b_exc : a.b_inh;
        const float cc = ex[q] ? a.c_exc : a.c_inh;
        const float dd = ex[q] ? a.d_exc : a.d_inh;
        float x = vv[q], y = uu[q];
        for (int s = 0; s < a.substeps; ++s)
          x = x + a.h * (((((0.04f * x) * x + 5.0f * x) + 140.0f) - y) + cur);
        y = y + (a.dt * aa) * (bb * x - y);
        const bool spk = x >= a.v_peak;
        a.v[i] = spk ? cc : x;
        a.u[i] = spk ? y + dd : y;
        fired[q] = spk && nv[q];
        a.spiked[i] = fired[q] ? 1 : 0;
      }
    }
    // the spiking neurons' last_post
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int64_t n = n0 + q * kThreads + threadIdx.x;
      if (fired[q] && a.last_post != nullptr) a.last_post[h * N + n] = t;
    }
    // per q a warp-inclusive scan of the spikes; the tile's order is
    // (q, thread)
    unsigned long long val[kPerThread], incl[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      val[q] = fired[q] ? 1ull : 0ull;
      unsigned long long x = val[q];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      incl[q] = x;
      if (lane == 31) part[q * kWarps + warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
      // the parts' exclusive prefixes, the tile's aggregate, the look-back
      const unsigned long long mine = part[lane];
      unsigned long long x = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      part[lane] = x - mine;
      const unsigned long long agg = __shfl_sync(kFull, x, 31);
      unsigned long long excl = 0;
      if (lane == 0) publish(words + tile, tile == 0 ? kPrefix : kAggregate,
                             agg);
      if (tile > 0) {
        excl = look_back(words, tile, lane);
        if (lane == 0) publish(words + tile, kPrefix, excl + agg);
      }
      if (lane == 0) {
        tile_excl = excl;
        if (tile == a.tiles - 1) {
          // the last tile: the shard's spike count and the overflow
          const int64_t total = (int64_t)(excl + agg);
          a.count[h] = total;
          if (a.sat != nullptr && total > C) a.sat[h] += (int32_t)(total - C);
        }
      }
    }
    __syncthreads();
    // each spiking neuron's rank: listed below C
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (!fired[q]) continue;
      const int64_t rank = (int64_t)(tile_excl + part[q * kWarps + warp] +
                                     (incl[q] - val[q]));
      if (rank < C) ids[rank] = (int32_t)(n0 + q * kThreads + threadIdx.x);
    }
    __syncthreads();  // before the next tile's shared state
  }
  // no tile left, so every tile is held by a running block: wait for the
  // last one's inclusive word, then write this block's share of the fill
  // (ids N after the listed)
  if (threadIdx.x == 0)
    tile_excl = wait_word(words + a.tiles - 1, clock64(), true) & kValueMask;
  __syncthreads();
  const int64_t total = (int64_t)tile_excl;
  for (int64_t i = total + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < C; i += (int64_t)gridDim.x * kThreads)
    ids[i] = (int32_t)N;
  // the last block of the shard to leave clears the tile state: every
  // block has read the last tile's word
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ctrl + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t i = threadIdx.x; i < a.tiles; i += kThreads) words[i] = 0;
  if (threadIdx.x == 0) {
    ctrl[0] = 0;
    ctrl[1] = 0;
  }
}

struct LtpArgs {
  const int32_t* ids;          // [H, C]
  const int64_t* count;        // [H]
  const int32_t* row_ptr;      // [H, N + 1]
  const uint8_t* plastic;      // [H, E]
  const float* last_arr;       // [H, E]
  float* w;                    // [H, E]
  const int64_t* ctr;          // step counter, or nullptr
  int64_t t, N, E, C;
  float a_plus, inv_tau_plus, w_min, w_max, half_neg_time;
};

// LTP on the synapses syn[q] (-1: none) of one round: every load issued
// before any use.
__device__ __forceinline__ void ltp_round(const LtpArgs& a,
                                          const int64_t (&syn)[kUnroll],
                                          float t) {
  uint8_t p[kUnroll];
  float la[kUnroll], wv[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    const bool in = syn[q] >= 0;
    p[q] = in ? a.plastic[syn[q]] : 0;
    la[q] = in ? a.last_arr[syn[q]] : a.half_neg_time;
    wv[q] = in ? a.w[syn[q]] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (p[q] == 0 || !(la[q] > a.half_neg_time)) continue;
    const float ltp = a.a_plus * xla_exp((la[q] - t) * a.inv_tau_plus);
    a.w[syn[q]] = fminf(fmaxf(wv[q] + ltp, a.w_min), a.w_max);
  }
}

__global__ void __launch_bounds__(kThreads) ltp_synapses(LtpArgs a) {
  const int64_t h = blockIdx.y;
  const int64_t C = a.C;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int32_t* ids = a.ids + h * C;
  const int32_t* rp = a.row_ptr + h * (a.N + 1);
  // the warp's first row, loaded beside the count
  const int32_t mine = wid < C ? ids[wid] : (int32_t)a.N;
  const int64_t count = a.count[h];
  const int64_t L = count < C ? count : C;
  if (L <= 0) return;
  const float t = (float)(a.ctr != nullptr ? a.ctr[0] : a.t);
  const int64_t base = h * a.E;
  for (int64_t k = wid; k < L; k += warps) {
    const int32_t n = k == wid ? mine : ids[k];
    const int64_t beg = base + rp[n], end = base + rp[n + 1];
    for (int64_t e0 = beg; e0 < end; e0 += 32 * kUnroll) {
      int64_t syn[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int64_t e = e0 + 32 * q + lane;
        syn[q] = e < end ? e : -1;
      }
      ltp_round(a, syn, t);
    }
  }
}

// Blocks a shard of a kernel: up to `per_sm` of its resident blocks an
// SM, over the H shards, at most `most` and at least 1; the resident count
// cached per device and kernel (`slot`).  Returns a cudaError_t.
int grid_blocks(const void* kernel, int slot, int per_sm, int64_t H,
                int64_t most, int64_t* out) {
  static int cache[3][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < 64 ? cache[slot][dev] : 0;
  if (resident == 0) {
    int sms = 0, fit = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (fit < per_sm ? fit : per_sm);
    if (dev < 64) cache[slot][dev] = resident;
  }
  int64_t blocks = resident / (H > 0 ? H : 1);
  blocks = blocks > most ? most : blocks;
  *out = blocks < 1 ? 1 : blocks;
  return 0;
}

}  // namespace

// ptrs: i_syn, stim_idx, stim_amp, exc, valid, v, u, spiked, last_post
// (or null), sat (or null), count, ids, words, ctrl, ctr (or null).  ints: H, N, C, K, tiles, t, substeps, integrate (1: the
// neuron pass; 0: the scan of the given spike mask alone), blocks (a
// shard; 0: as many as the card holds at once, at most a tile each).
// floats: a_exc, a_inh, b_exc, b_inh, c_exc, c_inh, d_exc, d_inh, v_peak,
// h, dt.
extern "C" int repro_event_neurons(void* const* ptrs, const int64_t* ints,
                                   const float* floats, void* stream) {
  NeuronArgs a;
  a.i_syn = (const float*)ptrs[0];
  a.stim_idx = (const int64_t*)ptrs[1];
  a.stim_amp = (const float*)ptrs[2];
  a.exc = (const uint8_t*)ptrs[3];
  a.valid = (const uint8_t*)ptrs[4];
  a.v = (float*)ptrs[5];
  a.u = (float*)ptrs[6];
  a.spiked = (uint8_t*)ptrs[7];
  a.last_post = (float*)ptrs[8];
  a.sat = (int32_t*)ptrs[9];
  a.count = (int64_t*)ptrs[10];
  a.ids = (int32_t*)ptrs[11];
  a.words = (unsigned long long*)ptrs[12];
  a.ctrl = (unsigned int*)ptrs[13];
  a.ctr = (const int64_t*)ptrs[14];
  const int64_t H = ints[0];
  a.N = ints[1];
  a.C = ints[2];
  a.K = ints[3];
  a.tiles = ints[4];
  a.t = ints[5];
  a.substeps = (int)ints[6];
  const bool integrate = ints[7] != 0;
  const int64_t want = ints[8];
  float* const f[] = {&a.a_exc, &a.a_inh, &a.b_exc, &a.b_inh, &a.c_exc,
                      &a.c_inh, &a.d_exc, &a.d_inh, &a.v_peak, &a.h, &a.dt};
  for (int i = 0; i < (int)(sizeof(f) / sizeof(f[0])); ++i) *f[i] = floats[i];
  if (a.tiles < 1 || a.tiles * kTile < a.N || a.C < 0)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = 0;
  const int err =
      integrate ? grid_blocks((const void*)neuron_scan<true>, 0,
                              kNeuronBlocksPerSM, H, a.tiles, &blocks)
                : grid_blocks((const void*)neuron_scan<false>, 1,
                              kNeuronBlocksPerSM, H, a.tiles, &blocks);
  if (err != 0) return err;
  if (want > 0) blocks = want < blocks ? want : blocks;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  if (integrate)
    neuron_scan<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    neuron_scan<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: ids, count, row_ptr, plastic, last_arr, w, ctr (or null).
// ints: H, N, E, C, t, blocks (a shard; 0: every block the card holds at
// once).  floats: a_plus, inv_tau_plus, w_min, w_max, half_neg_time.
extern "C" int repro_event_ltp(void* const* ptrs, const int64_t* ints,
                               const float* floats, void* stream) {
  LtpArgs a;
  a.ids = (const int32_t*)ptrs[0];
  a.count = (const int64_t*)ptrs[1];
  a.row_ptr = (const int32_t*)ptrs[2];
  a.plastic = (const uint8_t*)ptrs[3];
  a.last_arr = (const float*)ptrs[4];
  a.w = (float*)ptrs[5];
  a.ctr = (const int64_t*)ptrs[6];
  const int64_t H = ints[0];
  a.N = ints[1];
  a.E = ints[2];
  a.C = ints[3];
  a.t = ints[4];
  const int64_t want = ints[5];
  a.a_plus = floats[0];
  a.inv_tau_plus = floats[1];
  a.w_min = floats[2];
  a.w_max = floats[3];
  a.half_neg_time = floats[4];
  // every resident block of the card: the work is read on the device
  int64_t blocks = 0;
  const int err = grid_blocks((const void*)ltp_synapses, 2,
                              kLtpBlocksPerSM, H, INT32_MAX, &blocks);
  if (err != 0) return err;
  if (want > 0) blocks = want;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  ltp_synapses<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
