// The two STDP passes of a step, each over the engine's own plan and
// state arrays, gathering what it needs itself and updating state in
// place.
//
// Replace the Pallas TPU kernels of `repro/kernels/stdp.py`:
//   stdp_arrival (body `_arrival_kernel`): LTD against the target's last
//     spike where a synapse arrived and is plastic, the last-arrival
//     refresh, and the pre-LTD weight as the current contribution, on
//     arr = ring[:, r] & valid and lp = last_post[syn_tgt];
//   stdp_ltp (body `_ltp_kernel`): LTP against the last arrival where the
//     target spiked and the synapse is plastic, on post = spiked[syn_tgt].
// The TPU kernels walk (8, 128) VMEM tiles of every synapse, with the
// gathers and the ring clear outside them.  At the paper's rates only a
// few percent of the synapses arrive or see their target spike in a step,
// so here each kernel reads of most synapses only what tells it that
// nothing happens there.
//
// In place: arrival writes w and last_arr where a synapse arrived and
// clears the ring bytes it found set; contrib [H, E] and n_arrived [H] are
// new.  LTP writes w on the synapses of spiking targets and last_post of
// those targets.  The caller keeps the state it wants unchanged (the
// engine's `run` copies its input state once).
//
// Row invariant (`core/engine.py::make_row_ptr` checks it when it builds
// row_ptr): row n of shard h, [row_ptr[h, n], row_ptr[h, n + 1]), holds
// exactly the valid synapses whose local target is n; pads lie past
// row_ptr[h, N], outside every row.  So LTP needs neither syn_tgt nor
// syn_valid.
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
// Bound: memory.  Arrival must read 1 ring byte and write 4 contrib bytes
// per synapse, plus about 27 bytes per arrival: 72 MB at 8x8 (E = 12.8 M,
// 275 k arrivals), 0.022 ms at 3.35 TB/s.  LTP must read 1 spike byte a
// neuron, 8 row-pointer bytes a spiking neuron and up to 13 bytes per
// synapse of a spiking target: under 4 MB, about 1 us, so it is bound by
// its launch.
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
constexpr int kLtpThreads = 256;  // 8 warps: 8 targets a block
constexpr int kLtpUnroll = 8;     // synapses a lane loads at once: 256 a warp

__device__ __forceinline__ bool byte_set(uint64_t bytes, int j) {
  return ((bytes >> (8 * j)) & 0xff) != 0;  // byte j, little-endian
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
