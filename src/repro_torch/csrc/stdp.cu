// The STDP passes of a step, each over the engine's own plan and state
// arrays, gathering what it needs itself and updating state in place, and
// phase A of the step as one kernel.
//
// Replace the Pallas TPU kernels of `repro/kernels/stdp.py`:
//   stdp_arrival (body `_arrival_kernel`): LTD against the target's last
//     spike where a synapse arrived and is plastic, the last-arrival
//     refresh, and the pre-LTD weight as the current contribution, on
//     arr = ring[:, r] & valid and lp = last_post[syn_tgt];
//   stdp_ltp (body `_ltp_kernel`): LTP against the last arrival where the
//     target spiked and the synapse is plastic, on post = spiked[syn_tgt].
// with the arrival pass the sorted `jax.ops.segment_sum` of the
// contributions at `repro/core/engine.py:230` (not a Pallas kernel), and,
// in phase A, `repro/kernels/izhikevich.py::izhikevich_update` (body
// `_kernel`; its own port, `csrc/izhikevich.cu`, stays off the main path).
// The TPU kernels walk (8, 128) VMEM tiles of every synapse, with the
// gathers and the ring clear outside them.  At the paper's rates only a
// few percent of the synapses arrive or see their target spike in a step,
// so here each kernel reads of most synapses only what tells it that
// nothing happens there.
//
// Four kernels:
//   row_kernel<true> (the main path, `stdp_phase_a`): phase A of the step,
//     repro/core/engine.py's phase_a_dynamics then phase_a_plasticity:
//     the arrival pass and each target's ordered sum, the stimulus, the
//     Izhikevich update and the spike, and LTP of the targets that spiked;
//   row_kernel<false> (`stdp_arrival_current`): the arrival pass and the
//     ordered sum alone, writing i_syn [H, N]; off the main path, the
//     yardstick of the first and the arrival half of a split phase A;
//   arrival_kernel: the arrival pass alone, writing contrib [H, E] for
//     `csrc/segment_sum.cu` to sum; the yardstick of row_kernel<false>;
//   ltp_kernel: LTP alone (a split phase A).
//
// In place: the arrival passes write w and last_arr where a synapse
// arrived and clear the ring bytes they found set; phase A also writes v
// and u, and with LTP w on the synapses of spiking targets and last_post
// of those targets.  i_syn, contrib, spiked, and the counts n_arrived [H]
// and n_spikes [H], are new.  The caller keeps the state it wants
// unchanged (the engine's `run` copies its input state once).
//
// Row invariant (`core/engine.py::make_row_ptr` checks it when it builds
// row_ptr): row n of shard h, [row_ptr[h, n], row_ptr[h, n + 1]), holds
// exactly the valid synapses whose local target is n; pads lie past
// row_ptr[h, N], outside every row.  So the row kernels and LTP need
// neither syn_tgt nor syn_valid.
//
// Pad invariant: no ring flag of a pad is ever set (phase B sets flags
// only `& plan.syn_valid`, `core/engine.py::phase_b`).  The row kernels
// read and clear the flags inside rows only; were a pad flag set, it
// would stay set where the plain versions (`kernels/ref.py::
// stdp_arrival_current`, `::stdp_phase_a`) clear it.
//
// row_kernel: 8 lanes per target row (h, n), 4 rows a warp, 32 rows (a
// tile) a block.  As many blocks as fit on the card at once walk the
// tiles, gridDim.x apart (more where a block would otherwise walk over
// kMaxTilesPerBlock tiles).  A row's bounds and last_post[h, n] come in
// one round of loads; each lane reads 4 consecutive aligned 8-byte flag
// words, so a group covers 256 synapses a round (a row of the 8x8 grid,
// ~200 synapses starting at any byte, takes one round); bytes outside the
// row are masked.  The bounds of the row after next and the first flag
// words of the next row are loaded before the current row is worked, so
// the row's own chain of loads starts at its flags.  At the main path's
// 2.15% a row has ~4.3 arrivals: a lane loads plastic and w of up to 8 of
// its flagged synapses at once, writes w where LTD applies (the row's one
// LTD step, exp of (last_post - t), computed once), last_arr = t, and
// clears each flagged byte with a byte store (two rows can share a word,
// so no word is written back).  The pre-LTD weights of a round go to
// shared memory in synapse order (a prefix over the group's lanes gives
// each lane its place), and the group's first lane adds them to the row's
// sum in that order, from +0.0, one rounding per add.  That is the plain
// version's sum bit for bit: there every synapse of the row is added,
// +0.0 where it did not arrive, and adding +0.0 leaves a sum that started
// at +0.0 (so is never -0.0) unchanged.  A row with no arrival sums to
// +0.0.  The arrivals (and phase A's spikes) per shard go to n_arrived[h]
// (n_spikes[h]) through a self-resetting (arrivals, spikes, ticket)
// scratch, one ticket a block.  (A warp per row and a word per lane, one
// tile per block, spent most of its time waiting on each row's three
// dependent rounds of loads; PERF.md has its times.)
//
// Phase A (row_kernel<true>) adds to each row, in its group, before the
// rounds (their loads do not wait on the row's flags): lane 0 loads v, u
// and the neuron's two flags, and the group's lanes test 8 entries each
// of the step's stimulus list (C*K entries a shard, 64 at 8x8, read
// through L1) for the row, lane 0 adding the hits' amplitudes in list
// order from +0.0 (what a scatter_add_ into zeros gives; every amplitude
// is stim_amplitude or +0.0, so any order would do).  After the rounds
// lane 0 takes i_tot = i_syn + i_ext, csrc/izhikevich.cu's update with a,
// b, c, d picked by exc_mask from launch arguments, and the spike masked
// by neuron_valid, and writes v, u and spiked.  Nothing of another row is
// read or written.  With LTP on, lane 0 of a spiking row sets its bit in
// the block's shared spike mask; after the walk and a __syncthreads
// (which orders the block's LTD writes before LTP reads them: only this
// block wrote these rows), each warp takes every 8th spiking row of the
// block and walks it as ltp_kernel does, 32 lanes with up to 8 synapses'
// loads in flight each, and sets last_post = t; then the block adds its
// counts.  LTD used the old last_post, loaded with the row's bounds.  At
// the main path's ~21.5 Hz a block finds ~5 spiking rows among its ~8
// tiles: one round of LTP a warp, where LTP in the row's own group would
// hold the other 3 rows of its warp while 8 lanes walk ~200 synapses.
// (Testing the stimulus after the rounds, and adding the counts before
// LTP, was 12% slower at the main density; PERF.md has the times.)
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
// Bound: memory.  The arrival pass must read every ring byte of the slot,
// the row pointers and last_post, write i_syn, and touch about 10 bytes
// per arrival (plastic, w in, last_arr out, the flag cleared) and 4 per
// LTD: about 17 MB at 8x8 (E = 12.8 M, N = 64,000, 275 k arrivals),
// 0.005 ms at 3.35 TB/s.  The pair it replaces writes and re-reads contrib
// (4 + 4 bytes a synapse): arrival's 72 MB bound and the sum's 52 MB.
// Phase A adds 19 bytes a neuron (v and u in and out, two flags, the
// spike) less i_syn's 4, the stimulus list, and for each of the ~1,400
// spiking targets its row pointers and last_post and up to 13 bytes per
// synapse: about 21 MB at 8x8, 0.0064 ms.  LTP alone must read 1 spike
// byte a neuron, 8 row-pointer bytes a spiking neuron and up to 13 bytes
// per synapse of a spiking target: under 4 MB, about 1 us, so it is bound
// by its launch.  The ~25 flops of exp per update and ~20 of the neuron
// are far below the fp32 peak.
//
// Bits: exp is XLA-CPU's polynomial (xla_exp.cuh), (x - t) / tau is
// multiplied by the fp32 reciprocal 1/tau as XLA rewrites it, the
// Izhikevich update keeps the reference's order with fp32 literals, and
// the library is built with -fmad=false -ftz=true: the same operations on
// the same elements as the plain versions (`kernels/ref.py`).
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
// tiles a block of row_kernel<true> walks at most (its spike bits)
constexpr int64_t kMaxTilesPerBlock = 64;

__device__ __forceinline__ bool byte_set(uint64_t bytes, int j) {
  return ((bytes >> (8 * j)) & 0xff) != 0;  // byte j, little-endian
}

// Bytes 0 .. k-1 of a word (k clipped to [0, 8]).
__device__ __forceinline__ uint64_t bytes_below(int64_t k) {
  return k >= 8 ? ~0ull : k <= 0 ? 0ull : (1ull << (8 * k)) - 1;
}

// The last block of shard h's row of blocks to finish writes the shard's
// totals to n_arrived[h] (and n_spikes[h] where given); the scratch triple
// (arrivals, spikes, ticket) is left zero.
__device__ __forceinline__ void add_counts(
    unsigned long long arrivals, unsigned long long spikes, int64_t h,
    int64_t* __restrict__ n_arrived, int64_t* __restrict__ n_spikes,
    unsigned long long* __restrict__ scratch) {
  unsigned long long* acc = scratch + 3 * h;
  unsigned long long* ticket = acc + 2;
  if (arrivals != 0) atomicAdd(acc, arrivals);
  if (spikes != 0) atomicAdd(acc + 1, spikes);
  __threadfence();  // this block's adds before its ticket
  if (atomicAdd(ticket, 1ull) == gridDim.x - 1) {
    // the last block of row h: every other block's adds have landed
    n_arrived[h] = (int64_t)atomicExch(acc, 0ull);
    const unsigned long long s = atomicExch(acc + 1, 0ull);
    if (n_spikes != nullptr) n_spikes[h] = (int64_t)s;
    atomicExch(ticket, 0ull);
  }
}

// One round of a target row in row_kernel: the group's lanes
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

// The amplitudes of the step's stimulus list addressed to row n, added in
// list order from +0.0, in lane g == 0 (the other lanes return 0).  The
// group's lanes test 8 entries each of a 64-entry chunk and OR their hits
// into one mask, which lane 0 walks in order.
__device__ __forceinline__ float stim_sum(const int64_t* __restrict__ idx,
                                         const float* __restrict__ amp,
                                         int64_t n_stim, int64_t n, int g) {
  float ext = 0.0f;
  for (int64_t c0 = 0; c0 < n_stim; c0 += 8 * kGroup) {
    uint64_t hit = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t j = c0 + 8 * g + k;
      if (j < n_stim && __ldg(idx + j) == n) hit |= 1ull << (8 * g + k);
    }
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      const unsigned lo = __shfl_xor_sync(kFull, (unsigned)hit, o, kGroup);
      const unsigned hi =
          __shfl_xor_sync(kFull, (unsigned)(hit >> 32), o, kGroup);
      hit |= ((uint64_t)hi << 32) | lo;
    }
    if (g != 0) continue;
    for (; hit != 0; hit &= hit - 1)
      ext = ext + __ldg(amp + c0 + __ffsll((long long)hit) - 1);
  }
  return ext;
}

// LTP on synapses [beg, end) of one target that spiked, by the calling
// lanes (`lanes` of them, `lane` the caller's rank): each loads plastic,
// last_arr and w of up to kLtpUnroll synapses (stride `lanes`) before it
// uses any.
__device__ __forceinline__ void ltp_walk(
    int64_t beg, int64_t end, int lane, int lanes,
    const uint8_t* __restrict__ plastic, const float* __restrict__ last_arr,
    float* __restrict__ w, float t, float a_plus, float inv_tau_plus,
    float w_min, float w_max, float half_neg_time) {
  for (int64_t e0 = beg + lane; e0 < end; e0 += lanes * kLtpUnroll) {
    uint8_t p[kLtpUnroll];
    float la[kLtpUnroll], wv[kLtpUnroll];
#pragma unroll
    for (int k = 0; k < kLtpUnroll; ++k) {
      const int64_t e = e0 + (int64_t)lanes * k;
      const bool in = e < end;
      p[k] = in ? plastic[e] : 0;
      la[k] = in ? last_arr[e] : half_neg_time;
      wv[k] = in ? w[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kLtpUnroll; ++k) {
      if (p[k] == 0 || !(la[k] > half_neg_time)) continue;
      const float ltp = a_plus * xla_exp((la[k] - t) * inv_tau_plus);
      w[e0 + (int64_t)lanes * k] = fminf(fmaxf(wv[k] + ltp, w_min), w_max);
    }
  }
}

// The row kernels' scalars (passed by value).
struct RowConsts {
  int64_t D, E, N, r, n_stim;
  float t, a_minus, inv_tau_minus, a_plus, inv_tau_plus, w_min, w_max,
      half_neg_time;
  float a_exc, a_inh, b_exc, b_inh, c_exc, c_inh, d_exc, d_inh, v_peak, h,
      dt;
  int substeps, with_ltp;
  // step counter (t, stimulus row) on the device, or nullptr: then t and
  // r above, and the stimulus list is the step's own [H, n_stim] row
  const int64_t* ctr;
};

template <bool kPhaseA>
__global__ void __launch_bounds__(kRowThreads, 2) row_kernel(
    uint8_t* __restrict__ ring, const int32_t* __restrict__ row_ptr,
    const uint8_t* __restrict__ plastic, float* __restrict__ last_post,
    float* __restrict__ w, float* __restrict__ last_arr,
    float* __restrict__ i_syn, int64_t* __restrict__ n_arrived,
    int64_t* __restrict__ n_spikes, unsigned long long* __restrict__ scratch,
    const uint8_t* __restrict__ exc, const uint8_t* __restrict__ neuron_valid,
    const int64_t* __restrict__ stim_idx, const float* __restrict__ stim_amp,
    float* __restrict__ v, float* __restrict__ u,
    uint8_t* __restrict__ spiked, const RowConsts p) {
  // a round's pre-LTD weights of each of the block's rows, in synapse order
  __shared__ float pre[kRowsPerBlock][kRoundSynapses];
  __shared__ int warp_count[kRowThreads / 32][2];
  // bit `slot` of word k: row `slot` of the block's k-th tile spiked
  __shared__ unsigned spiking[kPhaseA ? kMaxTilesPerBlock : 1];
  const int64_t h = blockIdx.y;
  const int64_t N = p.N;
  // the step from the device counter (t, row of the stimulus window) when
  // given, else from the launch arguments
  const int64_t tt = p.ctr != nullptr ? p.ctr[0] : 0;
  const int64_t r = p.ctr != nullptr ? ((tt % p.D) + p.D) % p.D : p.r;
  const float t = p.ctr != nullptr ? (float)tt : p.t;
  const int64_t srow = p.ctr != nullptr ? p.ctr[1] : 0;
  const int lane = threadIdx.x & 31, g = threadIdx.x & (kGroup - 1);
  const int slot = threadIdx.x / kGroup;  // the group's row of each tile
  const int32_t* rp = row_ptr + h * (N + 1);
  const float* lps = last_post + h * N;
  const uint64_t* words =
      reinterpret_cast<const uint64_t*>(ring + (h * p.D + r) * p.E);
  uint8_t* flag = ring + (h * p.D + r) * p.E;
  const int64_t base = h * p.E;
  float* list = pre[slot];
  if (kPhaseA && threadIdx.x < kMaxTilesPerBlock) spiking[threadIdx.x] = 0;
  // the block walks tiles of kRowsPerBlock rows, gridDim.x apart; the
  // bounds of the tile after next and the first flag words of the next
  // are loaded before the current row is worked
  const int64_t tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t stride = gridDim.x;
  auto load_bounds = [&](int64_t tile, int64_t& beg, int64_t& end,
                         float& lp) {
    const int64_t n = tile * kRowsPerBlock + slot;
    beg = end = 0;
    lp = p.half_neg_time;
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
  int count = 0, spikes = 0;  // arrivals and spikes of the group's rows
  if (kPhaseA) __syncthreads();  // `spiking` zeroed
  for (int64_t tile = blockIdx.x, k = 0; tile < tiles; tile += stride, ++k) {
    int64_t beg2, end2;
    float lp2;
    load_bounds(tile + 2 * stride, beg2, end2, lp2);
    uint64_t nxt[kLaneWords];
    load_flags((nbeg >> 3) + g * kLaneWords, nend, nxt);
    const int64_t n = tile * kRowsPerBlock + slot;
    const bool first = g == 0 && n < N;  // the lane that ends the row
    // phase A: the row's neuron and its stimulus, before the rounds (their
    // loads do not wait on the row's flags)
    float vv = 0.0f, uu = 0.0f, ext = 0.0f;
    bool ex = false, nv = false;
    if (kPhaseA && first) {
      vv = v[h * N + n];
      uu = u[h * N + n];
      ex = exc[h * N + n] != 0;
      nv = neuron_valid[h * N + n] != 0;
    }
    if (kPhaseA)
      ext = stim_sum(stim_idx + (srow * gridDim.y + h) * p.n_stim,
                     stim_amp + (srow * gridDim.y + h) * p.n_stim,
                     p.n_stim, n, g);

    const bool ltd_on = lp > p.half_neg_time;
    const float ltd =
        ltd_on ? p.a_minus * xla_exp((lp - t) * p.inv_tau_minus) : 0.0f;
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
                         last_arr, base, t, ltd_on, ltd, p.w_min,
                         p.w_max, acc);
    }
    if (kPhaseA) {
      if (first) {
        // i_tot = i_syn + i_ext; csrc/izhikevich.cu's update, literally
        const float drive = acc + ext;
        const float a = ex ? p.a_exc : p.a_inh, b = ex ? p.b_exc : p.b_inh;
        const float c = ex ? p.c_exc : p.c_inh, d = ex ? p.d_exc : p.d_inh;
        for (int s = 0; s < p.substeps; ++s)
          vv = vv + p.h * (((((0.04f * vv) * vv + 5.0f * vv) + 140.0f) - uu)
                           + drive);
        uu = uu + (p.dt * a) * (b * vv - uu);
        const bool spk = vv >= p.v_peak;
        v[h * N + n] = spk ? c : vv;
        u[h * N + n] = spk ? uu + d : uu;
        const bool fired = spk && nv;
        spiked[h * N + n] = fired ? 1 : 0;
        if (fired) {
          ++spikes;
          if (p.with_ltp) atomicOr(&spiking[k], 1u << slot);
        }
      }
    } else if (first) {
      i_syn[h * N + n] = acc;
    }

    beg = nbeg;
    end = nend;
    lp = nlp;
    nbeg = beg2;
    nend = end2;
    nlp = lp2;
#pragma unroll
    for (int k2 = 0; k2 < kLaneWords; ++k2) cur[k2] = nxt[k2];
  }
  count = __reduce_add_sync(kFull, g == 0 ? count : 0);
  spikes = __reduce_add_sync(kFull, spikes);
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_count[warp][0] = count;
    warp_count[warp][1] = spikes;
  }
  // the block's LTD writes, spike bits and counts before they are read
  __syncthreads();
  if (kPhaseA && p.with_ltp) {
    // LTP of the block's spiking rows, a warp a row (the i-th spiking row,
    // in walk order, to warp i mod 8).  Only this block wrote these rows'
    // w and last_arr in this launch, before the barrier above.
    const int64_t my_tiles = (tiles - blockIdx.x + stride - 1) / stride;
    int i = 0;
    for (int64_t k = 0; k < my_tiles; ++k) {
      for (unsigned bits = spiking[k]; bits != 0; bits &= bits - 1, ++i) {
        if ((i & (kRowThreads / 32 - 1)) != warp) continue;
        const int64_t n =
            (blockIdx.x + k * stride) * kRowsPerBlock + __ffs(bits) - 1;
        if (lane == 0) last_post[h * N + n] = t;
        ltp_walk(base + rp[n], base + rp[n + 1], lane, 32, plastic,
                 last_arr, w, t, p.a_plus, p.inv_tau_plus, p.w_min,
                 p.w_max, p.half_neg_time);
      }
    }
  }
  if (threadIdx.x == 0) {
    unsigned long long arrivals = 0, fired = 0;
    for (int i = 0; i < kRowThreads / 32; ++i) {
      arrivals += warp_count[i][0];
      fired += warp_count[i][1];
    }
    add_counts(arrivals, fired, h, n_arrived, n_spikes, scratch);
  }
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
  add_counts(total, 0, h, n_arrived, nullptr, scratch);
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
  ltp_walk(beg, end, lane, 32, plastic, last_arr, w, t, a_plus, inv_tau_plus,
           w_min, w_max, half_neg_time);
}

// The event backend's LTP (`repro/core/event_engine.py::
// phase_a_plasticity`) as the event path first ran it, off the path since
// `event_phase_a.cu::ltp_synapses` replaced it and kept as its yardstick
// (`kernels.event.event_ltp_rows`): a warp per entry of ids [H, C] (the
// first C spiking neurons of each shard, ascending, then the fill N) walks
// the neuron's CSR row as ltp_kernel does (row n is the JAX plan's
// in_rows[n]: valid synapses first, sorted by target); every thread also
// sets last_post = t of the spiking neurons of a stride of the shard
// (listed or not), and the first thread adds the compaction's overflow to
// sat.
__global__ void __launch_bounds__(kLtpThreads) event_ltp_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ n_dropped,
    const uint8_t* __restrict__ spiked, const int32_t* __restrict__ row_ptr,
    const uint8_t* __restrict__ plastic, const float* __restrict__ last_arr,
    float* __restrict__ w, float* __restrict__ last_post,
    int32_t* __restrict__ sat, const int64_t* __restrict__ ctr, int64_t t_arg,
    int64_t N, int64_t E, int64_t C, float a_plus, float inv_tau_plus,
    float w_min, float w_max, float half_neg_time) {
  const int64_t h = blockIdx.y;
  const float t = (float)(ctr != nullptr ? ctr[0] : t_arg);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  if (tid == 0) sat[h] += n_dropped[h];
  for (int64_t n = tid; n < N; n += threads)
    if (spiked[h * N + n] != 0) last_post[h * N + n] = t;
  const int lane = threadIdx.x & 31;
  const int32_t* rp = row_ptr + h * (N + 1);
  for (int64_t k = tid >> 5; k < C; k += threads >> 5) {
    const int32_t n = ids[h * C + k];
    if (n >= N) break;  // the fill follows the listed neurons
    ltp_walk(h * E + rp[n], h * E + rp[n + 1], lane, 32, plastic, last_arr,
             w, t, a_plus, inv_tau_plus, w_min, w_max, half_neg_time);
  }
}

}  // namespace

extern "C" int repro_event_ltp_rows(
    const void* ids, const void* n_dropped, const void* spiked,
    const void* row_ptr, const void* plastic, const void* last_arr, void* w,
    void* last_post, void* sat, const void* ctr, int64_t t, int64_t H,
    int64_t N, int64_t E, int64_t C, float a_plus, float inv_tau_plus,
    float w_min, float w_max, float half_neg_time, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a warp per listed neuron, up to two blocks an SM across the shards
  const int64_t per_block = kLtpThreads / 32;
  int64_t blocks = (C + per_block - 1) / per_block;
  int64_t most = 2 * (int64_t)(sms > 0 ? sms : 132) / (H > 0 ? H : 1);
  most = most < 1 ? 1 : most;
  blocks = blocks > most ? most : blocks < 1 ? 1 : blocks;
  event_ltp_kernel<<<dim3((unsigned)blocks, (unsigned)H), kLtpThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)n_dropped, (const uint8_t*)spiked,
      (const int32_t*)row_ptr, (const uint8_t*)plastic,
      (const float*)last_arr, (float*)w, (float*)last_post, (int32_t*)sat,
      (const int64_t*)ctr, t, N, E, C, a_plus, inv_tau_plus, w_min, w_max,
      half_neg_time);
  return (int)cudaGetLastError();
}

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

// Blocks of row_kernel<kPhaseA> resident on the current device at once
// (SMs x blocks an SM), cached per device; returns a cudaError_t.
template <bool kPhaseA>
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
        &per_sm, row_kernel<kPhaseA>, kRowThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  if (dev < 64) cache[dev] = *out;
  return 0;
}

// The row kernels' pointers, as the launchers gather them (nullptr where
// a variant does not use one).
struct RowPtrs {
  uint8_t* ring;
  const int32_t* row_ptr;
  const uint8_t* plastic;
  float* last_post;
  float* w;
  float* last_arr;
  float* i_syn;
  int64_t* n_arrived;
  int64_t* n_spikes;
  unsigned long long* scratch;
  const uint8_t* exc;
  const uint8_t* neuron_valid;
  const int64_t* stim_idx;
  const float* stim_amp;
  float* v;
  float* u;
  uint8_t* spiked;
};

// As many blocks as fit on the card at once (each walks several tiles),
// split among the shards, but enough that none walks more than
// kMaxTilesPerBlock tiles.
template <bool kPhaseA>
static int launch_rows(const RowPtrs& a, const RowConsts& c, int64_t H,
                       void* stream) {
  int resident = 0;
  const int err = resident_blocks<kPhaseA>(&resident);
  if (err != 0) return err;
  const int64_t tiles = (c.N + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t least = (tiles + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  int64_t blocks = resident / H;
  blocks = blocks < least ? least : blocks;
  blocks = blocks < 1 ? 1 : blocks > tiles ? tiles : blocks;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  row_kernel<kPhaseA><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
      a.ring, a.row_ptr, a.plastic, a.last_post, a.w, a.last_arr, a.i_syn,
      a.n_arrived, a.n_spikes, a.scratch, a.exc, a.neuron_valid, a.stim_idx,
      a.stim_amp, a.v, a.u, a.spiked, c);
  return (int)cudaGetLastError();
}

extern "C" int repro_stdp_arrival_current(
    void* ring, const void* row_ptr, const void* plastic,
    const void* last_post, void* w, void* last_arr, void* i_syn,
    void* n_arrived, void* scratch, int64_t H, int64_t D, int64_t E,
    int64_t N, int64_t r, float t, float a_minus, float inv_tau_minus,
    float w_min, float w_max, float half_neg_time, void* stream) {
  RowPtrs a = {};
  a.ring = (uint8_t*)ring;
  a.row_ptr = (const int32_t*)row_ptr;
  a.plastic = (const uint8_t*)plastic;
  a.last_post = (float*)last_post;  // read only
  a.w = (float*)w;
  a.last_arr = (float*)last_arr;
  a.i_syn = (float*)i_syn;
  a.n_arrived = (int64_t*)n_arrived;
  a.scratch = (unsigned long long*)scratch;
  RowConsts c = {};
  c.D = D;
  c.E = E;
  c.N = N;
  c.r = r;
  c.t = t;
  c.a_minus = a_minus;
  c.inv_tau_minus = inv_tau_minus;
  c.w_min = w_min;
  c.w_max = w_max;
  c.half_neg_time = half_neg_time;
  return launch_rows<false>(a, c, H, stream);
}

// ptrs: ring, row_ptr, plastic, exc, neuron_valid, stim_idx, stim_amp, v,
// u, last_post, w, last_arr, spiked, n_arrived, n_spikes, scratch, ctr (the
// step counter, or null: then t and r are the launch arguments and the
// stimulus is the step's row; else the stimulus is a window [W, H, n_stim]
// read at row ctr[1]).
// ints: H, D, E, N, r, n_stim, substeps, with_ltp.
// floats: t, a_minus, inv_tau_minus, a_plus, inv_tau_plus, w_min, w_max,
// half_neg_time, a_exc, a_inh, b_exc, b_inh, c_exc, c_inh, d_exc, d_inh,
// v_peak, h, dt.
extern "C" int repro_stdp_phase_a(void* const* ptrs, const int64_t* ints,
                                  const float* floats, void* stream) {
  RowPtrs a = {};
  a.ring = (uint8_t*)ptrs[0];
  a.row_ptr = (const int32_t*)ptrs[1];
  a.plastic = (const uint8_t*)ptrs[2];
  a.exc = (const uint8_t*)ptrs[3];
  a.neuron_valid = (const uint8_t*)ptrs[4];
  a.stim_idx = (const int64_t*)ptrs[5];
  a.stim_amp = (const float*)ptrs[6];
  a.v = (float*)ptrs[7];
  a.u = (float*)ptrs[8];
  a.last_post = (float*)ptrs[9];
  a.w = (float*)ptrs[10];
  a.last_arr = (float*)ptrs[11];
  a.spiked = (uint8_t*)ptrs[12];
  a.n_arrived = (int64_t*)ptrs[13];
  a.n_spikes = (int64_t*)ptrs[14];
  a.scratch = (unsigned long long*)ptrs[15];
  RowConsts c = {};
  c.ctr = (const int64_t*)ptrs[16];
  const int64_t H = ints[0];
  c.D = ints[1];
  c.E = ints[2];
  c.N = ints[3];
  c.r = ints[4];
  c.n_stim = ints[5];
  c.substeps = (int)ints[6];
  c.with_ltp = (int)ints[7];
  float* const f[] = {&c.t, &c.a_minus, &c.inv_tau_minus, &c.a_plus,
                      &c.inv_tau_plus, &c.w_min, &c.w_max, &c.half_neg_time,
                      &c.a_exc, &c.a_inh, &c.b_exc, &c.b_inh, &c.c_exc,
                      &c.c_inh, &c.d_exc, &c.d_inh, &c.v_peak, &c.h, &c.dt};
  for (int i = 0; i < (int)(sizeof(f) / sizeof(f[0])); ++i) *f[i] = floats[i];
  return launch_rows<true>(a, c, H, stream);
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
