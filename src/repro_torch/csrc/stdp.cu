// The STDP passes of a step, each over the engine's own plan and state
// arrays, gathering what it needs itself and updating state in place.
//
// Replace the Pallas TPU kernels of `repro/kernels/stdp.py`:
//   stdp_arrival (body `_arrival_kernel`): LTD against the target's last
//     spike where a synapse arrived and is plastic, the last-arrival
//     refresh, and the pre-LTD weight as the current contribution, on
//     arr = ring[:, r] & valid and lp = last_post[syn_tgt];
//   stdp_ltp (body `_ltp_kernel`): LTP against the last arrival where the
//     target spiked and the synapse is plastic, on post = spiked[syn_tgt].
// and, with the arrival pass, the sorted `jax.ops.segment_sum` of the
// contributions at `repro/core/engine.py:230` (not a Pallas kernel).
// The TPU kernels walk (8, 128) VMEM tiles of every synapse, with the
// gathers and the ring clear outside them.  At the paper's rates only a
// few percent of the synapses arrive or see their target spike in a step,
// so here each kernel reads of most synapses only what tells it that
// nothing happens there.
//
// Three kernels:
//   arrival_current_kernel (the main path): the arrival pass and the
//     ordered per-target sum in one, writing i_syn [H, N] and no
//     contributions;
//   arrival_kernel: the arrival pass alone, writing contrib [H, E] for
//     `csrc/segment_sum.cu` to sum; kept as the yardstick of the first;
//   ltp_kernel.
//
// In place: the arrival kernels write w and last_arr where a synapse
// arrived and clear the ring bytes they found set; i_syn or contrib, and
// n_arrived [H], are new.  LTP writes w on the synapses of spiking targets
// and last_post of those targets.  The caller keeps the state it wants
// unchanged (the engine's `run` copies its input state once).
//
// Row invariant (`core/engine.py::make_row_ptr` checks it when it builds
// row_ptr): row n of shard h, [row_ptr[h, n], row_ptr[h, n + 1]), holds
// exactly the valid synapses whose local target is n; pads lie past
// row_ptr[h, N], outside every row.  So LTP and arrival_current need
// neither syn_tgt nor syn_valid.
//
// Pad invariant: no ring flag of a pad is ever set (phase B sets flags
// only `& plan.syn_valid`, `core/engine.py::phase_b`).  arrival_current
// reads and clears the flags inside rows only; were a pad flag set, it
// would stay set where the plain version (`kernels/ref.py::
// stdp_arrival_current`) clears it.
//
// arrival_current_kernel: 8 lanes per target row (h, n), 4 rows a warp,
// 32 rows (a tile) a block.  As many blocks as fit on the card at once
// walk the tiles, gridDim.x apart.  A row's bounds and last_post[h, n]
// come in one round of loads; each lane reads 4 consecutive aligned 8-byte
// flag words, so a group covers 256 synapses a round (a row of the 8x8
// grid, ~200 synapses starting at any byte, takes one round); bytes
// outside the row are masked.  The bounds of the row after next and the
// first flag words of the next row are loaded before the current row is
// worked, so the row's own chain of loads starts at its flags.  At the
// main path's 2.15% a row has ~4.3 arrivals: a lane loads plastic and w
// of up to 8 of its flagged synapses at once, writes w where LTD applies
// (the row's one LTD step, exp of (last_post - t), computed once),
// last_arr = t, and clears each flagged byte with a byte store (two rows
// can share a word, so no word is written back).  The pre-LTD weights of
// a round go to shared memory in synapse order (a prefix over the
// group's lanes gives each lane its place), and the group's first lane
// adds them to the row's sum in that order, from +0.0, one rounding per
// add.  That is the plain version's sum bit for bit: there every synapse
// of the row is added, +0.0 where it did not arrive, and adding +0.0
// leaves a sum that started at +0.0 (so is never -0.0) unchanged.  A row
// with no arrival writes +0.0.  The arrivals per shard go to n_arrived[h]
// through the same self-resetting (accumulator, ticket) scratch as
// arrival_kernel's, one ticket a block.  (A warp per row and a word per
// lane, one tile per block, spent most of its time waiting on each row's
// three dependent rounds of loads; PERF.md has its times.)
//
// arrival_kernel: one thread per 8 consecutive synapses of one shard
// (E % 8 == 0, so each reads its 8 ring flags in one 8-byte load and
// writes its 8 contributions as two float4).  A thread whose flags are all
// zero (about 84% at the main path's 2.15% arrivals) writes zeros and is
// done.  The others are bound by the latency of dependent loads, so each
// issues its loads in three rounds for all 8 synapses at once: valid and
// plastic as one 8-byte load each, w as two float4, syn_tgt of the flagged
// ones; then last_post[h, tgt] (N-sized, held in L2) of the plastic
// arrivals; then it writes w where LTD applies, last_arr, contrib, and
// clears the 8 flags.  The arrival count of a row of blocks goes to
// n_arrived[h] through a scratch pair (accumulator, ticket) per shard that
// the last block of the row reads and resets, so the output needs no
// zeroing launch and the scratch is zero again after every launch.
//
// ltp_kernel: one warp per target (h, n).  The warp reads spiked[h, n]
// with the row's bounds and leaves if it is false (about 98% at the main
// path's 21.5 Hz); otherwise lane 0 writes last_post and each lane loads
// plastic, last_arr and w of up to 8 synapses of the row (stride 32,
// coalesced across the warp) before it uses any: a row of up to 256
// synapses takes one round of loads.
//
// Bound: memory.  arrival_current must read every ring byte of the slot,
// the row pointers and last_post, write i_syn, and touch about 10 bytes
// per arrival (plastic, w in, last_arr out, the flag cleared) and 4 per
// LTD: about 17 MB at 8x8 (E = 12.8 M, N = 64,000, 275 k arrivals),
// 0.005 ms at 3.35 TB/s.  The pair it replaces writes and re-reads contrib
// (4 + 4 bytes a synapse): arrival's 72 MB bound and the sum's 52 MB.
// LTP must read 1 spike byte a neuron, 8 row-pointer bytes a spiking
// neuron and up to 13 bytes per synapse of a spiking target: under 4 MB,
// about 1 us, so it is bound by its launch.
// The ~25 flops of exp per update are far below the fp32 peak.
//
// Bits: exp is XLA-CPU's polynomial (xla_exp.cuh), (x - t) / tau is
// multiplied by the fp32 reciprocal 1/tau as XLA rewrites it, and the
// library is built with -fmad=false -ftz=true: the same operations on the
// same elements as the plain versions (`kernels/ref.py`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_exp.cuh"

namespace {

constexpr int kArrivalThreads = 256;
constexpr int kRowThreads = 256;  // 8 warps a block
constexpr int kGroup = 8;         // lanes a target row: 4 rows a warp
constexpr int kRowsPerBlock = kRowThreads / kGroup;
constexpr int kLaneWords = 4;     // flag words a lane reads a round
constexpr int kRoundWords = kGroup * kLaneWords;   // a row's round:
constexpr int kRoundSynapses = kRoundWords * 8;    // 256 synapses
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLtpThreads = 256;  // 8 warps: 8 targets a block
constexpr int kLtpUnroll = 8;     // synapses a lane loads at once: 256 a warp

__device__ __forceinline__ bool byte_set(uint64_t bytes, int j) {
  return ((bytes >> (8 * j)) & 0xff) != 0;  // byte j, little-endian
}

// Bytes 0 .. k-1 of a word (k clipped to [0, 8]).
__device__ __forceinline__ uint64_t bytes_below(int64_t k) {
  return k >= 8 ? ~0ull : k <= 0 ? 0ull : (1ull << (8 * k)) - 1;
}

// The last block of shard h's row of blocks to finish writes the shard's
// total to n_arrived[h]; the (accumulator, ticket) pair is left zero.
__device__ __forceinline__ void add_arrivals(
    unsigned long long total, int64_t h, int64_t* __restrict__ n_arrived,
    unsigned long long* __restrict__ scratch) {
  unsigned long long* acc = scratch + 2 * h;
  unsigned long long* ticket = acc + 1;
  if (total != 0) atomicAdd(acc, total);
  __threadfence();  // this block's add before its ticket
  if (atomicAdd(ticket, 1ull) == gridDim.x - 1) {
    // the last block of row h: every other block's add has landed
    n_arrived[h] = (int64_t)atomicExch(acc, 0ull);
    atomicExch(ticket, 0ull);
  }
}

// One round of a target row in arrival_current_kernel: the group's lanes
// hold `flags`, kLaneWords consecutive words each, from word w0 on; adds
// the round's arrived pre-LTD weights to `acc` (lane g == 0) in synapse
// order and returns their count (the same in the group's lanes).
__device__ __forceinline__ int row_round(
    const uint64_t (&flags)[kLaneWords], int64_t w0, int64_t beg, int64_t end,
    int g, float* __restrict__ list, uint8_t* __restrict__ flag,
    const uint8_t* __restrict__ plastic, float* __restrict__ w,
    float* __restrict__ last_arr, int64_t base, float t, bool ltd_on,
    float ltd, float w_min, float w_max, float& acc) {
  const int64_t s0 = w0 * 8;
  uint32_t mine = 0;  // bit 8k + j: synapse s0 + 8k + j arrived
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    const int64_t e0 = s0 + 8 * k;
    const uint64_t bits =
        flags[k] & bytes_below(end - e0) & ~bytes_below(beg - e0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mine |= (uint32_t)byte_set(bits, j) << (8 * k + j);
  }
  if (__ballot_sync(kFull, mine != 0) == 0) return 0;  // the whole warp
  // each lane's place in its row's synapse order: a prefix over the
  // group's lanes
  const int c = __popc(mine);
  int upto = c;
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) {
    const int v = __shfl_up_sync(kFull, upto, o, kGroup);
    if (g >= o) upto += v;
  }
  const int total = __shfl_sync(kFull, upto, kGroup - 1, kGroup);
  int pos = upto - c;
  // the flagged synapses in batches of 8: all loads of a batch, then its
  // writes
  while (mine != 0) {
    int off[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      off[q] = mine != 0 ? __ffs(mine) - 1 : -1;
      mine &= mine - 1;  // 0 stays 0
    }
    float wv[8];
    uint8_t pl[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      wv[q] = off[q] >= 0 ? w[base + s0 + off[q]] : 0.0f;
      pl[q] = off[q] >= 0 ? plastic[base + s0 + off[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (off[q] < 0) continue;
      const int64_t e = base + s0 + off[q];
      list[pos++] = wv[q];
      if (pl[q] != 0 && ltd_on) w[e] = fminf(fmaxf(wv[q] - ltd, w_min), w_max);
      last_arr[e] = t;
      flag[s0 + off[q]] = 0;
    }
  }
  __syncwarp();
  if (g == 0)
    for (int k = 0; k < total; ++k) acc = acc + list[k];
  __syncwarp();
  return total;
}

__global__ void __launch_bounds__(kRowThreads) arrival_current_kernel(
    uint8_t* __restrict__ ring, const int32_t* __restrict__ row_ptr,
    const uint8_t* __restrict__ plastic, const float* __restrict__ last_post,
    float* __restrict__ w, float* __restrict__ last_arr,
    float* __restrict__ i_syn, int64_t* __restrict__ n_arrived,
    unsigned long long* __restrict__ scratch, int64_t D, int64_t E,
    int64_t N, int64_t r, float t, float a_minus, float inv_tau_minus,
    float w_min, float w_max, float half_neg_time) {
  // a round's pre-LTD weights of each of the block's rows, in synapse order
  __shared__ float pre[kRowsPerBlock][kRoundSynapses];
  __shared__ int warp_count[kRowThreads / 32];
  const int64_t h = blockIdx.y;
  const int lane = threadIdx.x & 31, g = threadIdx.x & (kGroup - 1);
  const int slot = threadIdx.x / kGroup;  // the group's row of each tile
  const int32_t* rp = row_ptr + h * (N + 1);
  const float* lps = last_post + h * N;
  const uint64_t* words =
      reinterpret_cast<const uint64_t*>(ring + (h * D + r) * E);
  uint8_t* flag = ring + (h * D + r) * E;
  const int64_t base = h * E;
  float* list = pre[slot];
  // the block walks tiles of kRowsPerBlock rows, gridDim.x apart; the
  // bounds of the tile after next and the first flag words of the next
  // are loaded before the current row is worked
  const int64_t tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t stride = gridDim.x;
  auto load_bounds = [&](int64_t tile, int64_t& beg, int64_t& end,
                         float& lp) {
    const int64_t n = tile * kRowsPerBlock + slot;
    beg = end = 0;
    lp = half_neg_time;
    if (tile < tiles && n < N) {
      beg = rp[n];
      end = rp[n + 1];
      lp = lps[n];
    }
  };
  auto load_flags = [&](int64_t w0, int64_t end,
                        uint64_t (&flags)[kLaneWords]) {
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k)
      flags[k] = (w0 + k) * 8 < end ? words[w0 + k] : 0ull;
  };
  int64_t beg, end, nbeg, nend;
  float lp, nlp;
  uint64_t cur[kLaneWords];
  load_bounds(blockIdx.x, beg, end, lp);
  load_bounds(blockIdx.x + stride, nbeg, nend, nlp);
  load_flags((beg >> 3) + g * kLaneWords, end, cur);
  int count = 0;  // arrivals of the group's rows
  for (int64_t tile = blockIdx.x; tile < tiles; tile += stride) {
    int64_t beg2, end2;
    float lp2;
    load_bounds(tile + 2 * stride, beg2, end2, lp2);
    uint64_t nxt[kLaneWords];
    load_flags((nbeg >> 3) + g * kLaneWords, nend, nxt);

    const bool ltd_on = lp > half_neg_time;
    const float ltd =
        ltd_on ? a_minus * xla_exp((lp - t) * inv_tau_minus) : 0.0f;
    const int words_in_row =
        end > beg ? (int)(((end - 1) >> 3) - (beg >> 3)) + 1 : 0;
    const int rounds = __reduce_max_sync(
        kFull, (words_in_row + kRoundWords - 1) / kRoundWords);
    float acc = 0.0f;  // the in-order sum, in lane g == 0
    for (int round = 0; round < rounds; ++round) {
      const int64_t w0 =
          (beg >> 3) + (int64_t)round * kRoundWords + g * kLaneWords;
      if (round > 0) load_flags(w0, end, cur);  // rows past 256 synapses
      count += row_round(cur, w0, beg, end, g, list, flag, plastic, w,
                         last_arr, base, t, ltd_on, ltd, w_min, w_max, acc);
    }
    const int64_t n = tile * kRowsPerBlock + slot;
    if (n < N && g == 0) i_syn[h * N + n] = acc;

    beg = nbeg;
    end = nend;
    lp = nlp;
    nbeg = beg2;
    nend = end2;
    nlp = lp2;
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) cur[k] = nxt[k];
  }
  count = __reduce_add_sync(kFull, g == 0 ? count : 0);
  if (lane == 0) warp_count[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long total = 0;
  for (int i = 0; i < kRowThreads / 32; ++i) total += warp_count[i];
  add_arrivals(total, h, n_arrived, scratch);
}

__global__ void __launch_bounds__(kArrivalThreads) arrival_kernel(
    uint8_t* __restrict__ ring, const uint8_t* __restrict__ valid,
    const int64_t* __restrict__ tgt, const uint8_t* __restrict__ plastic,
    const float* __restrict__ last_post, float* __restrict__ w,
    float* __restrict__ last_arr, float* __restrict__ contrib,
    int64_t* __restrict__ n_arrived, unsigned long long* __restrict__ scratch,
    int64_t D, int64_t E, int64_t N, int64_t r, float t, float a_minus,
    float inv_tau_minus, float w_min, float w_max, float half_neg_time) {
  const int64_t h = blockIdx.y;
  const int64_t e0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  int count = 0;
  if (e0 < E) {
    uint64_t* flags_at =
        reinterpret_cast<uint64_t*>(ring + (h * D + r) * E + e0);
    const uint64_t flags = *flags_at;
    float c[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (flags != 0) {
      // Three dependent rounds of loads, each issued for all 8 synapses
      // at once: (valid, plastic, w, syn_tgt of the flagged), then
      // last_post of the plastic arrivals, then the stores.
      const int64_t base = h * E + e0;
      const uint64_t vbits = *reinterpret_cast<const uint64_t*>(valid + base);
      const uint64_t pbits =
          *reinterpret_cast<const uint64_t*>(plastic + base);
      const float4 wa = reinterpret_cast<const float4*>(w + base)[0];
      const float4 wb = reinterpret_cast<const float4*>(w + base)[1];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      int64_t tg[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tg[j] = byte_set(flags, j) ? tgt[base + j] : 0;
      float lp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lp[j] = byte_set(flags & vbits & pbits, j)
                    ? last_post[h * N + tg[j]]
                    : half_neg_time;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!byte_set(flags & vbits, j)) continue;
        ++count;
        c[j] = wv[j];
        // lp > half_neg_time only for a plastic arrival with a post spike
        if (lp[j] > half_neg_time) {
          const float ltd = a_minus * xla_exp((lp[j] - t) * inv_tau_minus);
          w[base + j] = fminf(fmaxf(wv[j] - ltd, w_min), w_max);
        }
        last_arr[base + j] = t;
      }
      *flags_at = 0;
    }
    float4* out = reinterpret_cast<float4*>(contrib + h * E + e0);
    out[0] = make_float4(c[0], c[1], c[2], c[3]);
    out[1] = make_float4(c[4], c[5], c[6], c[7]);
  }

  __shared__ int warp_count[kArrivalThreads / 32];
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long total = 0;
  for (int i = 0; i < kArrivalThreads / 32; ++i) total += warp_count[i];
  add_arrivals(total, h, n_arrived, scratch);
}

__global__ void __launch_bounds__(kLtpThreads) ltp_kernel(
    const uint8_t* __restrict__ spiked, const int32_t* __restrict__ row_ptr,
    const uint8_t* __restrict__ plastic, const float* __restrict__ last_arr,
    float* __restrict__ w, float* __restrict__ last_post, int64_t H,
    int64_t N, int64_t E, float t, float a_plus, float inv_tau_plus,
    float w_min, float w_max, float half_neg_time) {
  const int64_t target =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (target >= H * N) return;  // the whole warp
  const int64_t h = target / N;
  const int32_t* row = row_ptr + target + h;  // row_ptr[h, n], [H, N + 1]
  // the spike flag and the row's bounds in one round of loads
  const bool fired = spiked[target] != 0;
  const int64_t beg = h * E + row[0], end = h * E + row[1];
  if (!fired) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  if (lane == 0) last_post[target] = t;
  for (int64_t e0 = beg + lane; e0 < end; e0 += 32 * kLtpUnroll) {
    // all of a lane's loads for up to kLtpUnroll synapses before any use
    uint8_t p[kLtpUnroll];
    float la[kLtpUnroll], wv[kLtpUnroll];
#pragma unroll
    for (int k = 0; k < kLtpUnroll; ++k) {
      const int64_t e = e0 + 32 * k;
      const bool in = e < end;
      p[k] = in ? plastic[e] : 0;
      la[k] = in ? last_arr[e] : half_neg_time;
      wv[k] = in ? w[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kLtpUnroll; ++k) {
      if (p[k] == 0 || !(la[k] > half_neg_time)) continue;
      const float ltp = a_plus * xla_exp((la[k] - t) * inv_tau_plus);
      w[e0 + 32 * k] = fminf(fmaxf(wv[k] + ltp, w_min), w_max);
    }
  }
}

}  // namespace

extern "C" int repro_stdp_arrival(
    void* ring, const void* valid, const void* tgt, const void* plastic,
    const void* last_post, void* w, void* last_arr, void* contrib,
    void* n_arrived, void* scratch, int64_t H, int64_t D, int64_t E,
    int64_t N, int64_t r, float t, float a_minus, float inv_tau_minus,
    float w_min, float w_max, float half_neg_time, void* stream) {
  const int64_t groups = E / 8;
  const dim3 grid((unsigned)((groups + kArrivalThreads - 1) / kArrivalThreads),
                  (unsigned)H);
  arrival_kernel<<<grid, kArrivalThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)ring, (const uint8_t*)valid, (const int64_t*)tgt,
      (const uint8_t*)plastic, (const float*)last_post, (float*)w,
      (float*)last_arr, (float*)contrib, (int64_t*)n_arrived,
      (unsigned long long*)scratch, D, E, N, r, t, a_minus, inv_tau_minus,
      w_min, w_max, half_neg_time);
  return (int)cudaGetLastError();
}

// Blocks of arrival_current_kernel resident on the current device at once
// (SMs x blocks an SM), cached per device; returns a cudaError_t.
static int resident_blocks(int* out) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cache[dev] != 0) {
    *out = cache[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, arrival_current_kernel, kRowThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  if (dev < 64) cache[dev] = *out;
  return 0;
}

extern "C" int repro_stdp_arrival_current(
    void* ring, const void* row_ptr, const void* plastic,
    const void* last_post, void* w, void* last_arr, void* i_syn,
    void* n_arrived, void* scratch, int64_t H, int64_t D, int64_t E,
    int64_t N, int64_t r, float t, float a_minus, float inv_tau_minus,
    float w_min, float w_max, float half_neg_time, void* stream) {
  // as many blocks as fit on the card at once (each walks several tiles),
  // split among the shards
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  const int64_t tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  int64_t blocks = resident / H;
  blocks = blocks < 1 ? 1 : blocks > tiles ? tiles : blocks;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  arrival_current_kernel<<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)ring, (const int32_t*)row_ptr, (const uint8_t*)plastic,
      (const float*)last_post, (float*)w, (float*)last_arr, (float*)i_syn,
      (int64_t*)n_arrived, (unsigned long long*)scratch, D, E, N, r, t,
      a_minus, inv_tau_minus, w_min, w_max, half_neg_time);
  return (int)cudaGetLastError();
}

extern "C" int repro_stdp_ltp(
    const void* spiked, const void* row_ptr, const void* plastic,
    const void* last_arr, void* w, void* last_post, int64_t H, int64_t N,
    int64_t E, float t, float a_plus, float inv_tau_plus, float w_min,
    float w_max, float half_neg_time, void* stream) {
  const int64_t per_block = kLtpThreads / 32;
  const int64_t blocks = (H * N + per_block - 1) / per_block;
  ltp_kernel<<<(unsigned)blocks, kLtpThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)spiked, (const int32_t*)row_ptr,
      (const uint8_t*)plastic, (const float*)last_arr, (float*)w,
      (float*)last_post, H, N, E, t, a_plus, inv_tau_plus, w_min, w_max,
      half_neg_time);
  return (int)cudaGetLastError();
}
