// Attention on the tensor cores, forward only, for bf16 prefill: o =
// softmax(mask(softcap(scale * q k^T))) v over q [BH, T, D] and k, v [BH,
// S, D], bf16 in and out, T >= 64, D a multiple of 8 up to 256, q, k and v
// 16-byte aligned.  Products on the bf16 tensor cores (wgmma) with fp32
// accumulators; softmax in fp32 registers.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention` (src/repro/kernels/flash_attention.py:92) for these
// shapes; `csrc/flash_decode.cu` takes T < 64 and `csrc/flash_attention.cu`
// (fp32 SIMT) what neither takes.
//
// Bound: operations.  At RecurrentGemma-2B's local attention (BH 10, T = S
// = 2048, D 256, causal) the visible pairs need 4 D operations each, 21.5
// GFLOP (0.022 ms at 989 TFLOP/s), against 42 MB of q, k, v and o (0.0125
// ms at 3.35 TB/s).  The design keeps the tensor cores fed:
//
//   block    64 query rows of one (bh) slice (the wgmma M) and 3
//            warpgroups: one producer and two consumers.  The block's kv
//            tiles are cut in two contiguous halves, one for each
//            consumer, and merged in key order at the end (below).  A
//            causal q tile sees up to T / 64 tiles, so a block that owned
//            them all serially would bound the kernel; halving the chain
//            of the heaviest block is what beat 128 rows a block (two
//            consumers on one kv tile) at the prefill shapes (PERF.md).
//            Heavy causal q tiles come first (the q-tile order in
//            blockIdx is reversed).
//   loads    the producer's one thread loads the block's q once and each
//            kv tile of kBlockN = 64 keys through a ring of 3 or 4 stages
//            in shared memory, alternating between the consumers, by TMA
//            (cp.async.bulk.tensor, 128-byte swizzle, 64-column boxes),
//            completed on mbarriers; a consumer frees a stage on another
//            mbarrier.  Past the end of T or S (and of D, up to a multiple
//            of 64) TMA fills zeros.  The producer gives its registers to
//            the consumers (setmaxnreg 24 / 240).
//   S = QK^T wgmma m64n64k16, q and k from shared memory (both K-major),
//            fp32 accumulators: every bf16 product is exact, only the
//            order of the sum differs from the plain version.
//   softmax  online, in fp32 registers, with exp2f on log2(e)-scaled
//            differences; each thread holds 2 rows, a quad shares a row.
//   O += PV  p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and
//            two wgmma m64n(Dp)k16 with A = p from registers and B = v
//            from shared memory (N-major: the transpose bit set) add both
//            into the same fp32 accumulator: the weight's residual error
//            is about 2^-17 of it, so the output stays within one bf16 ulp
//            of the plain version, at 1.5x the bound's operations.
//   tiles    kv tiles that no row of the block can see (causal, window,
//            past S) are not computed; the mask is applied only on tiles
//            that some rows see in part.
//   merge    consumer 1 hands its (m, l, acc) to consumer 0 through the
//            ring once every load is consumed; consumer 0 weighs each half
//            by exp(m_half - m), lower keys first.
//   output   acc / l rounded to bf16 (to nearest even) once, stored from
//            registers.
//
// Masking follows the reference exactly: q_pos = i + (S - T), causal
// k_pos <= q_pos, window k_pos > q_pos - window (one-sided, also when not
// causal), masked scores -1e30 (never -inf), each half's tiles in
// ascending order.  A row whose first computed tile is fully masked for it
// keeps m = -1e30 and sums exp(0) = 1 per masked key; its first visible
// key has weight exp2((-1e30 - m) log2 e) = 0 on all of that and clears it,
// as the sequential kernel does, and a half that saw only masked keys of a
// row is cleared the same way by the merge.  A tile skipped for every row
// would have added exactly 0 or been cleared, so skipping it changes no
// bit of the rule.
//
// Shared memory: q 8 KB and each stage 16 KB per 64 columns of D, plus the
// barriers and 1 KB for alignment: 230,456 bytes at D = 256 (3 stages).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kConsumers = 2;          // consumer warpgroups per block
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBlockM = 64;            // query rows per block (wgmma M)
constexpr int kBlockN = 64;            // keys per kv tile
constexpr int kBox = 64 * 64 * 2;      // bytes of one 64 x 64 bf16 box
constexpr float kMasked = -1.0e30f;    // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;  // devices the shared-memory opt-in tracks

// kv ring stages for NC 64-column chunks of D: as many as fit
template <int NC>
__host__ __device__ constexpr int stages() { return NC == 4 ? 3 : 4; }

template <int NC>
__host__ __device__ constexpr size_t smem_bytes() {
  // q, the ring of k and v tiles, the barriers, 1024 for alignment
  return (size_t)NC * kBox + (size_t)stages<NC>() * 2 * NC * kBox +
         8 * (2 * stages<NC>() + 1) + 1024;
}

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one 64 x 64 box of a [BH, rows, D] tensor at (column c, row r, slice b)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c), "r"(r), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulators across the
// asynchronous wgmma that writes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A[64 x 16] B[16 x 64], A in registers, B N-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64 x 16] B[16 x 128], A in registers, B N-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[96] += A[64 x 16] B[16 x 192], A in registers, B N-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A[64 x 16] B[16 x 256], A in registers, B N-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int NC>
__device__ __forceinline__ void wgmma_pv(float (&d)[32 * NC],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NC == 1) wgmma_rs_n64(d, a, db);
  else if constexpr (NC == 2) wgmma_rs_n128(d, a, db);
  else if constexpr (NC == 3) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// two values as bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// O += P V over a tile of kBlockN keys, 16 keys a step, p_hi then p_lo
// (A fragments: registers 4 kk .. 4 kk + 3 are k-step kk); v_s: the
// tile's v boxes
template <int NC>
__device__ __forceinline__ void pv(float (&acc)[32 * NC],
                                   const uint32_t (&ph)[16],
                                   const uint32_t (&pl)[16], uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ahi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                             ph[4 * kk + 3]};
    const uint32_t alo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                             pl[4 * kk + 3]};
    const uint64_t dv = gmma_desc(v_s + kk * 16 * 128, kBox, 1024);
    wgmma_pv<NC>(acc, ahi, dv);
    wgmma_pv<NC>(acc, alo, dv);
  }
}

// ------------------------------------------------------------- kernel ----

// NC: 64-column chunks of D (D <= 64 NC).  One block: the query rows
// [row0, row0 + 64) of one (bh) slice; its kv tiles split in two halves,
// one for each consumer warpgroup.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int T_len,
                                int S, int D, int BH, int q_tiles,
                                int causal, int window, float softcap,
                                float scale) {
  constexpr int ST = stages<NC>();
  extern __shared__ unsigned char smem_raw[];
  // shared addresses, 1024-aligned for the 128-byte swizzle: q boxes [NC],
  // then per stage k boxes [NC] and v boxes [NC], then the barriers
  // full[ST], empty[ST], q_full
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + NC * kBox;
  const uint32_t bars = kv_s + ST * 2 * NC * kBox;
  const uint32_t q_full = bars + 8 * 2 * ST;

  const int bh = blockIdx.x % BH;
  const int row0 = (q_tiles - 1 - (int)blockIdx.x / BH) * kBlockM;
  const int q_off = S - T_len;
  const int last = min(row0 + kBlockM, T_len) - 1;
  // the kv tiles some row of the block can see, from an aligned start
  int k_lo = 0, k_hi = S - 1;
  if (causal) k_hi = min(k_hi, last + q_off);
  if (window > 0) k_lo = max(k_lo, row0 + q_off - window + 1);
  const int k_first = k_lo / kBlockN * kBlockN;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_first) / kBlockN + 1 : 0;
  // consumer 0 takes tiles [0, half), consumer 1 [half, n_tiles); the
  // loads alternate between them: load p is consumer p % 2's tile p / 2
  const int half = (n_tiles + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (ST + s), 128);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, NC * kBox);
      for (int ch = 0; ch < NC; ++ch)
        tma_load(q_s + ch * kBox, &tq, q_full, ch * 64, row0, bh);
      for (int p = 0; p < n_tiles; ++p) {
        const int s = p % ST;
        mbar_wait(bars + 8 * (ST + s), ((p / ST) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, 2 * NC * kBox);
        const uint32_t k_s = kv_s + s * 2 * NC * kBox;
        const int key = k_first + ((p & 1) ? half : 0) * kBlockN +
                        (p >> 1) * kBlockN;
        for (int ch = 0; ch < NC; ++ch) {
          tma_load(k_s + ch * kBox, &tk, bars + 8 * s, ch * 64, key, bh);
          tma_load(k_s + (NC + ch) * kBox, &tv, bars + 8 * s, ch * 64, key,
                   bh);
        }
      }
    }
  } else {
    // ---- consumer wg: the block's 64 rows over its half of the tiles;
    // this thread's rows are my_row and my_row + 8 (the wgmma
    // accumulator layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int ra = row0, rb = last;
    const int my_row = ra + 16 * warp + lane / 4;
    const int qp0 = my_row + q_off, qp1 = qp0 + 8;

    float acc[32 * NC];
#pragma unroll
    for (int e = 0; e < 32 * NC; ++e) acc[e] = 0.0f;
    float m0 = kMasked, m1 = kMasked, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(q_full, 0);

    for (int p = wg; p < n_tiles; p += 2) {
      const int s = p % ST;
      mbar_wait(bars + 8 * s, (p / ST) & 1);
      const int k0 = k_first + ((p & 1) ? half : 0) * kBlockN +
                     (p >> 1) * kBlockN;
      const int k1 = k0 + kBlockN - 1;
      // does some row see a key of the tile; do all rows see all
      const bool live = k0 < S && !(causal && k0 > rb + q_off) &&
                        !(window > 0 && k1 <= ra + q_off - window);
      if (live) {
        const bool masked = k1 >= S || (causal && k1 > ra + q_off) ||
                            (window > 0 && k0 <= rb + q_off - window);
        const uint32_t k_s = kv_s + s * 2 * NC * kBox;
        const uint32_t v_s = k_s + NC * kBox;

        // S = Q K^T over D, 16 columns a wgmma
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int ch = 0; ch < NC; ++ch)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(sc, gmma_desc(q_s + ch * kBox + kk * 32, 16, 1024),
                         gmma_desc(k_s + ch * kBox + kk * 32, 16, 1024),
                         (ch | kk) != 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, softcap, mask; sc[4j + e] is row (e < 2 ? my_row :
        // my_row + 8), key k0 + 8j + 2 t4 + (e & 1)
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale;
            if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
            if (masked) {
              const int key = k0 + 8 * j + 2 * t4 + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              bool seen = key < S;
              if (causal) seen = seen && key <= qp;
              if (window > 0) seen = seen && key > qp - window;
              x = seen ? x : kMasked;
            }
            sc[4 * j + e] = x;
            if (e < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float c0 = exp2f((m0 - mx0) * kLog2e);
        const float c1 = exp2f((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;

        // p, its row sums, and p = p_hi + p_lo as bf16 A fragments: pair
        // (sc[2n], sc[2n + 1]) is register n % 4 of k-step n / 4
        uint32_t ph[16], pl[16];
        float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const float mrow = (n & 1) ? m1 : m0;
          const float pa = exp2f((sc[2 * n] - mrow) * kLog2e);
          const float pb = exp2f((sc[2 * n + 1] - mrow) * kLog2e);
          if (n & 1) ps1 += pa + pb;
          else ps0 += pa + pb;
          ph[n] = pack_bf16(pa, pb);
          pl[n] = pack_bf16(pa - round_bf16(pa), pb - round_bf16(pb));
        }
        l0 = l0 * c0 + ps0;
        l1 = l1 * c1 + ps1;
        fence_regs(acc);
#pragma unroll
        for (int e = 0; e < 32 * NC; ++e) acc[e] *= ((e >> 1) & 1) ? c1 : c0;

        // O += P V over the tile's keys
        fence_regs(acc);
        wgmma_fence();
        pv<NC>(acc, ph, pl, v_s);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(bars + 8 * (ST + s));
    }

    // merge the two halves in key order: consumer 1 hands (m, l, acc) to
    // consumer 0 through the ring, free once every load has been consumed;
    // thread tid of both holds the same rows and columns.  A half that saw
    // no key of a row has m = -1e30 and weighs exactly 0.
    float* xs = reinterpret_cast<float*>(smem_raw + (kv_s - raw));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 32 * NC; ++e) xs[e * 128 + tid] = acc[e];
      xs[(32 * NC) * 128 + tid] = m0;
      xs[(32 * NC + 1) * 128 + tid] = m1;
      xs[(32 * NC + 2) * 128 + tid] = l0;
      xs[(32 * NC + 3) * 128 + tid] = l1;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) return;
    const float mb0 = xs[(32 * NC) * 128 + tid];
    const float mb1 = xs[(32 * NC + 1) * 128 + tid];
    const float n0 = fmaxf(m0, mb0), n1 = fmaxf(m1, mb1);
    const float wa0 = exp2f((m0 - n0) * kLog2e);
    const float wb0 = exp2f((mb0 - n0) * kLog2e);
    const float wa1 = exp2f((m1 - n1) * kLog2e);
    const float wb1 = exp2f((mb1 - n1) * kLog2e);
    l0 = wa0 * l0 + wb0 * xs[(32 * NC + 2) * 128 + tid];
    l1 = wa1 * l1 + wb1 * xs[(32 * NC + 3) * 128 + tid];
#pragma unroll
    for (int e = 0; e < 32 * NC; ++e) {
      const bool r1 = (e >> 1) & 1;
      acc[e] = (r1 ? wa1 : wa0) * acc[e] + (r1 ? wb1 : wb0) * xs[e * 128 + tid];
    }

    // o = acc / l, rounded once to bf16; a quad shares a row's l
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = my_row + 8 * h;
      if (row <= rb) {
        const float lh = h ? l1 : l0;
        const float safe = lh == 0.0f ? 1.0f : lh;
        __nv_bfloat16* orow = o + ((int64_t)bh * T_len + row) * D;
#pragma unroll
        for (int j = 0; j < 8 * NC; ++j) {
          const int col = 8 * j + 2 * t4;
          if (col < D)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(acc[4 * j + 2 * h] / safe,
                          acc[4 * j + 2 * h + 1] / safe);
        }
      }
    }
  }
}

// --------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once (null if missing)
EncodeTiled encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    return nullptr;
  }
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f);
  return f;
}

// a [BH, rows, D] bf16 tensor in 64 x 64 boxes, 128-byte swizzle, zeros
// past every edge
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t BH, int64_t rows,
                int64_t D) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)(D * 2),
                                 (cuuint64_t)(rows * D * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opts this instantiation in, on the current device, to its dynamic shared
// memory, once per (instantiation, device); a race makes the same call
// twice, which is harmless.
template <int NC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];  // false: not yet set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_sm90_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<NC>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH,
           int64_t T_len, int64_t S, int64_t D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, BH, T_len, D) || !tensor_map(&mk, k, BH, S, D) ||
      !tensor_map(&mv, v, BH, S, D))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<NC>();
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (int)((T_len + kBlockM - 1) / kBlockM);
  flash_attention_sm90_kernel<NC>
      <<<(unsigned)(BH * q_tiles), kThreads, smem_bytes<NC>(), stream>>>(
          mq, mk, mv, (__nv_bfloat16*)o, (int)T_len, (int)S, (int)D,
          (int)BH, q_tiles, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only.  window < 1: none; softcap <= 0: none.  D a multiple of 8 in
// [8, 256]; 64 <= T < 2^30; 1 <= S < 2^30; q, k, v 16-byte aligned.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o, int64_t BH,
                                          int64_t T, int64_t S, int64_t D,
                                          int causal, int64_t window,
                                          float softcap, float scale,
                                          void* stream) {
  const int64_t kMax = int64_t(1) << 30;
  if (D < 8 || D > 256 || D % 8 != 0 || T < 64 || T >= kMax || S < 1 ||
      S >= kMax || BH < 0 || BH * ((T + kBlockM - 1) / kBlockM) >= kMax ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return (int)cudaSuccess;
  // a window wider than every distance is no window
  const int w = window < 1 ? 0 : (int)(window < S + T ? window : S + T);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 63) / 64) {
    case 1: return launch<1>(q, k, v, o, BH, T, S, D, causal, w, softcap,
                             scale, st);
    case 2: return launch<2>(q, k, v, o, BH, T, S, D, causal, w, softcap,
                             scale, st);
    case 3: return launch<3>(q, k, v, o, BH, T, S, D, causal, w, softcap,
                             scale, st);
    default: return launch<4>(q, k, v, o, BH, T, S, D, causal, w, softcap,
                              scale, st);
  }
}
