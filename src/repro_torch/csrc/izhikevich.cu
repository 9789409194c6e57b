// Fused Izhikevich neuron update over [N] fp32, one thread per neuron.
//
// Replaces the Pallas TPU kernel `repro/kernels/izhikevich.py::
// izhikevich_update` (body `_kernel`).  The TPU version tiles [N] as
// (8, 128) blocks of VMEM; here each thread reads its neuron's seven
// inputs once and writes v', u' and the spike flag once.
//
// Bound: memory.  37 bytes per neuron (7 fp32 in, 2 fp32 + 1 bool out) and
// about 20 flops; at N = 64,000 (an 8x8 grid) that is 2.4 MB, under a
// microsecond at 3.35 TB/s, so the launch latency is what it costs.  The
// main path runs this update inside the phase-A kernel
// (`stdp.cu::row_kernel<true>`), and the event path inside its neuron pass
// (`event_phase_a.cu::neuron_scan`), neither with a launch of its own;
// this kernel is their yardstick.
//
// Bits: the reference order is kept literally, every literal is fp32 (a
// bare 0.04 would make the sum double), and the library is built with
// -fmad=false so no multiply-add is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void izhikevich_kernel(
    const float* __restrict__ v, const float* __restrict__ u,
    const float* __restrict__ cur, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ d, float* __restrict__ v_out,
    float* __restrict__ u_out, uint8_t* __restrict__ spiked, int64_t n,
    float v_peak, float h, float dt, int substeps) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vv = v[i];
  float uu = u[i];
  const float drive = cur[i];
  for (int s = 0; s < substeps; ++s) {
    vv = vv + h * (((((0.04f * vv) * vv + 5.0f * vv) + 140.0f) - uu) + drive);
  }
  uu = uu + (dt * a[i]) * (b[i] * vv - uu);
  const bool spk = vv >= v_peak;
  v_out[i] = spk ? c[i] : vv;
  u_out[i] = spk ? uu + d[i] : uu;
  spiked[i] = spk ? 1 : 0;
}

}  // namespace

extern "C" int repro_izhikevich_update(
    const void* v, const void* u, const void* cur, const void* a,
    const void* b, const void* c, const void* d, void* v_out, void* u_out,
    void* spiked, int64_t n, float v_peak, float h, float dt, int substeps,
    void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  izhikevich_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)u, (const float*)cur, (const float*)a,
      (const float*)b, (const float*)c, (const float*)d, (float*)v_out,
      (float*)u_out, (uint8_t*)spiked, n, v_peak, h, dt, substeps);
  return (int)cudaGetLastError();
}
