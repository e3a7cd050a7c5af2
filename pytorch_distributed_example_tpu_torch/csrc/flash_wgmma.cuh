// Flash forward, dK/dV and dQ for bf16 operands at head dims 32, 64, 128 and
// 256, on the tensor cores: wgmma on bf16 tiles that TMA brings into shared
// memory. Included by flash_attention.cu, whose note says what bounds these
// kernels and what the design does about it; ops/flash_attention.py routes
// every bf16 head dim here and float32 to the SIMT kernels.
//
// Layout. q, k, v, dO, o, dK, dV are contiguous (B*H, L, D); lse and delta
// (B*H, L) float32. Each operand is read through a 3-D tensor map
// (D, L, B*H), so a box that runs past L is zero-filled instead of reading the
// next head's rows. A tile of R rows lives in shared memory as D / kPanel
// panels of R rows of kSwizzle bytes, each TMA-swizzled over its own width: at
// D >= 64 panels of 64 columns with the 128-byte swizzle (a box's inner extent
// is at most 128 bytes), at D 32 one panel of 32 columns with the 64-byte
// swizzle. The wgmma descriptors below read both layouts; the width is a
// property of D (`Shape`), not a second copy of a kernel.
//
// Roles. A block is two consumer warpgroups and one producer warpgroup, of
// which one warp works. The producer keeps a ring of stages of the streamed
// operands in flight with full/empty mbarriers; the consumers wait on full,
// run their products and release the stage. A 384-thread block gets at most
// 168 registers a thread at launch; setmaxnreg then hands the producer's to
// the consumers (kProducerRegs / kConsumerRegs), whose accumulators need them.
// The forward and dQ give each consumer warpgroup 64 of the block's 128 rows;
// dK/dV does too up to D 128, holding dK and dV (2 x D/2 floats a thread).
// At D 256 one warpgroup cannot hold both 64 x 256 accumulators (256 floats a
// thread), so the block owns 64 keys and splits the work by output: warpgroup
// 0 computes S^T and P^T and accumulates dV, warpgroup 1 computes dP^T and
// accumulates dK, taking P^T from warpgroup 0 through shared memory (16 KiB
// of f32 a q-tile, behind two named barriers) to form dS^T. Each product runs
// once, each warpgroup does two of the four; the cost is the exchange and
// twice the blocks, each reading every q-tile it reaches.
//
// Shapes at D 256, against 232,448 bytes of shared memory a block and 232
// registers a consumer thread: the forward streams 64-key stages (O 128 + S
// 32 + P 16 registers), dQ 32-key stages in a ring of three (dQ 128 + S 16 +
// dP 16 + dS 8; 2 x 64 KiB of Q and dO resident), dK/dV the split above.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_wgmma {

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kProducerWarp = 4 * kConsumers;       // first warp of the producer warpgroup
constexpr int kThreads = (kProducerWarp + 4) * 32;  // 384
constexpr int kProducerRegs = 40;                   // 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kRows = 64 * kConsumers;              // rows of the forward's and dQ's own tile
constexpr int kBlockQ = 64;                         // dK/dV: q/dO rows per stage
constexpr int kStages = 2;                          // forward and dK/dV ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// named barriers of the split dK/dV (0 is __syncthreads): P^T written by
// warpgroup 0, and read by warpgroup 1
constexpr int kBarPFull = 1;
constexpr int kBarPEmpty = 2;

// What an instance's head dim fixes.
template <int D>
struct Shape {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "no wgmma instance for this head dim");
  static constexpr int kPanel = D < 64 ? D : 64;  // columns of a TMA box and a swizzled panel
  static constexpr int kSwizzle = 2 * kPanel;     // bytes of a panel row: the swizzle span
  // forward: k/v rows per stage. At D 256 two stages of 128 would take
  // 256 KiB beside Q's 64 KiB, and O, S and P 224 registers.
  static constexpr int kBlockKV = D > 128 ? 64 : 128;
  // dQ: k/v rows per stage and stages. 128 rows would put S, dP and dS's A
  // fragments at 64 + 64 + 32 registers beside dQ's 64 at D 128; the smaller
  // tiles ride a deeper ring, the same bytes in flight as the forward's two
  // stages of 128. At D 256 a 64-row stage takes 64 KiB beside Q and dO's
  // 128: stages of 32 rows, three of them.
  static constexpr int kBlockK = D > 128 ? 32 : 64;
  static constexpr int kDqStages = D > 128 ? 3 : 4;
  // dK/dV: one accumulator a warpgroup over 64 keys (see the top of the file)
  static constexpr bool kKvSplit = D > 128;
  static constexpr int kKvRows = kKvSplit ? 64 : kRows;  // keys a dK/dV block owns
};

// bytes of an R-row bf16 tile at head dim D
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * D * 2;
}

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows row0 .. row0+rows of head bh, all D columns, as D / kPanel swizzled panels
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows, int row0, int bh) {
  constexpr int kPanel = Shape<D>::kPanel;
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p)
    tma_load_3d(dst + p * rows * Shape<D>::kSwizzle, map, bar, kPanel * p, row0, bh);
}

// Shared-memory matrix descriptor for D's swizzle (layout type 1: 128 bytes,
// 2: 64 bytes). A K-major operand (rows of K contiguous) steps 8-row groups
// by SBO = 8 panel rows and takes LBO = 1 (unused); an MN-major one (rows of N
// contiguous) also steps 8-row groups of K by SBO and steps panels of N by
// LBO, the panel stride.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes) {
  constexpr uint32_t kSwizzle = Shape<D>::kSwizzle;
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((8 * kSwizzle) >> 4) << 32 | kLayout << 62;
}

// K-step kk (16 columns, 32 bytes) of the 64 rows from row `row` of an R-row
// tile, K-major: a panel row holds kSwizzle / 32 K-steps
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int row, int kk) {
  constexpr int kSwizzle = Shape<D>::kSwizzle;
  constexpr int kSteps = kSwizzle / 32;
  return smem_desc<D>(tile + (kk / kSteps) * rows * kSwizzle + row * kSwizzle + (kk % kSteps) * 32,
                      16);
}

// K-step kk (16 rows) of an R-row tile read as an MN-major operand [k = row][n = column]
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return smem_desc<D>(tile + kk * 16 * Shape<D>::kSwizzle, rows * Shape<D>::kSwizzle);
}

// named barrier `id` over the two consumer warpgroups: arrive without
// waiting, or arrive and wait for the other's arrival
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16. wgmma_ss: A and B from shared memory,
// both K-major. wgmma_rs: A from registers (four bf16 pairs a thread, the
// layout of an accumulator fragment), B from shared memory, MN-major. The
// accumulator's size picks N: N / 2 floats a thread (n32 .. n256).
// `accumulate` 0 overwrites d.

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments for the K-steps of P.V from P's accumulator: accumulator
// columns 16kk .. 16kk+15 are exactly the A operand of K-step kk
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t align_1024(uint32_t a) { return (a + 1023u) & ~1023u; }

// Fragment coordinates. In an m64nN accumulator, thread t of a warpgroup holds
// rows r = 16 (warp % 4) + lane / 4 and r + 8, at columns 8j + c and 8j + c + 1
// (c = 2 (lane % 4)) of every 8-column block j: element i is block i / 4, row
// r + 8 ((i / 2) % 2), column c + i % 2.

// ---------------------------------------------------------------------------
// forward: o = softmax(q k^T * scale) v, lse = logsumexp of the same logits
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  constexpr int kBlockKV = Shape<D>::kBlockKV;
  return 1024                                          // alignment slack
         + tile_bytes<D>(kRows)                        // q
         + 2 * kStages * tile_bytes<D>(kBlockKV)       // k, v ring
         + 8 * (1 + 2 * kStages);                      // mbarriers
}

template <typename TO, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, TO* __restrict__ o,
                       float* __restrict__ lse, int L, float scale, int causal) {
  constexpr int kBlockKV = Shape<D>::kBlockKV;
  constexpr uint32_t kQBytes = tile_bytes<D>(kRows);
  constexpr uint32_t kKVBytes = tile_bytes<D>(kBlockKV);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = align_1024(smem_u32(smem_raw));
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;
  const uint32_t bar_full = bar_q + 8;               // one per stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // one per stage

  const int bh = blockIdx.x;
  // the last q-tiles see the most k-tiles under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = causal ? min(L, q0 + kRows) : L;
  const int num_kv = (kv_end + kBlockKV - 1) / kBlockKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_arrive_expect_tx(bar_q, kQBytes);
      load_tile<D>(sQ, &tm_q, bar_q, kRows, q0, bh);
      for (int t = 0; t < num_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
        load_tile<D>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, kBlockKV, t * kBlockKV, bh);
        load_tile<D>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, kBlockKV, t * kBlockKV, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int c = 2 * (lane % 4);
  const int row_lo = q0 + 64 * wg;  // first row of this warpgroup
  const int rows[2] = {row_lo + r, row_lo + r + 8};
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the running row sum

  mbar_wait(bar_q, 0);
  for (int t = 0; t < num_kv; ++t) {
    const int s = t % kStages;
    const uint32_t sKs = sK + s * kKVBytes;
    const uint32_t sVs = sV + s * kKVBytes;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

    // S = Q K^T for this warpgroup's 64 rows and the stage's kBlockKV keys
    float sc[kBlockKV / 2];
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor_desc<D>(sQ, kRows, 64 * wg, kk), kmajor_desc<D>(sKs, kBlockKV, 0, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale in f32 after the product; mask only tiles that cross the diagonal or L
    const int k0 = t * kBlockKV;
    const bool edge = k0 + kBlockKV > L || (causal && k0 + kBlockKV - 1 > row_lo);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) {
      const int h = (i / 2) % 2;
      const int col = k0 + 8 * (i / 4) + c + i % 2;
      float x = sc[i] * scale_log2;
      if (edge && (col >= L || (causal && col > rows[h]))) x = kNegInf;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      m_safe[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - m_new);  // both -1e30 -> 1, and acc is 0
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    // l sums the f32 probabilities; P is rounded to bf16 only as the wgmma operand
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) {
      const int h = (i / 2) % 2;
      const float p = exp2f(sc[i] - m_safe[h]);
      l[h] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    uint32_t pa[kBlockKV / 16][4];
    to_a_frags(sc, pa);

    // O += P V, V read MN-major from the stage
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk)
      wgmma_rs(acc, pa[kk], mnmajor_desc<D>(sVs, kBlockKV, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = rows[h];
    if (row >= L) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    TO* orow = o + (static_cast<size_t>(bh) * L + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j + c, acc[4 * j + 2 * h] / l_safe, acc[4 * j + 2 * h + 1] / l_safe);
    if (lane % 4 == 0) {
      const float m_nat = m[h] <= kNegInf / 2 ? kNegInf : m[h] * kLn2;
      lse[static_cast<size_t>(bh) * L + row] = m_nat + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV for one tile of keys, given lse and delta = rowsum(dO*O) - dlse,
// computed transposed so that each result is the next product's A operand:
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T * scale - lse[col]),
//   dS^T = P^T (dP^T - delta[col]), dV += P^T dO, dK += dS^T Q (* scale at the end)
// Up to D 128 each warpgroup runs all four products for its 64 of the
// block's 128 keys; at D 256 (kKvSplit) both take the block's 64 keys, one
// accumulator each (see the top of the file).
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int kKeys = Shape<D>::kKvRows;
  return 1024                                                        // alignment slack
         + 2 * tile_bytes<D>(kKeys)                                  // k, v
         + kStages * (2 * tile_bytes<D>(kBlockQ) + 2 * 4 * kBlockQ)  // q, dO, lse, delta ring
         + (Shape<D>::kKvSplit ? 4 * 64 * kBlockQ : 0)               // P^T handed over, f32
         + 8 * (1 + 2 * kStages);                                    // mbarriers
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int L, float scale, int causal) {
  constexpr bool kSplit = Shape<D>::kKvSplit;
  constexpr int kKeys = Shape<D>::kKvRows;
  constexpr uint32_t kKBytes = tile_bytes<D>(kKeys);
  constexpr uint32_t kQBytes = tile_bytes<D>(kBlockQ);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align_1024(raw);
  const uint32_t sV = sK + kKBytes;
  const uint32_t sQ = sV + kKBytes;              // one q tile per stage
  const uint32_t sG = sQ + kStages * kQBytes;    // one dO tile per stage
  const uint32_t sRows = sG + kStages * kQBytes;  // per stage: lse then delta, kBlockQ each
  const uint32_t sP = sRows + kStages * 2 * 4 * kBlockQ;  // split: P^T, [element][thread]
  const uint32_t bar_kv = sP + (kSplit ? 4 * 64 * kBlockQ : 0);
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  float* rows_smem = reinterpret_cast<float*>(smem_raw + (sRows - raw));

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int num_q = (L + kBlockQ - 1) / kBlockQ;
  // the first q-tile that reaches this k-tile under the causal mask
  const int first_q = causal ? k0 / kBlockQ : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // every producer lane, after its lse/delta stores
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kKBytes);
      load_tile<D>(sK, &tm_k, bar_kv, kKeys, k0, bh);
      load_tile<D>(sV, &tm_v, bar_kv, kKeys, k0, bh);
    }
    const float* lse_bh = lse + static_cast<size_t>(bh) * L;
    const float* delta_bh = delta + static_cast<size_t>(bh) * L;
    for (int qt = first_q, t = 0; qt < num_q; ++qt, ++t) {
      const int s = t % kStages;
      const int q0 = qt * kBlockQ;
      mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
      float* lse_s = rows_smem + s * 2 * kBlockQ;
      for (int i = lane; i < kBlockQ; i += 32) {
        const int row = q0 + i;
        lse_s[i] = row < L ? lse_bh[row] : 0.f;
        lse_s[kBlockQ + i] = row < L ? delta_bh[row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kQBytes);
        load_tile<D>(sQ + s * kQBytes, &tm_q, bar_full + 8 * s, kBlockQ, q0, bh);
        load_tile<D>(sG + s * kQBytes, &tm_do, bar_full + 8 * s, kBlockQ, q0, bh);
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int c = 2 * (lane % 4);
  const int key_lo = k0 + (kSplit ? 0 : 64 * wg);  // first key of this warpgroup
  const int keys[2] = {key_lo + r, key_lo + r + 8};
  const float scale_log2 = scale * kLog2e;

  if constexpr (kSplit) {
    // warpgroup 0: S^T, P^T, dV += P^T dO; warpgroup 1: dP^T, dS^T, dK += dS^T Q.
    // Both hold the same fragment of the 64 x kBlockQ score tile, so P^T
    // crosses over element for element: thread t writes and reads its
    // element i at p_smem[i * 128 + t], a warp's 32 words side by side.
    float* p_smem = reinterpret_cast<float*>(smem_raw + (sP - raw)) + threadIdx.x % 128;
    const uint32_t sA = wg == 0 ? sK : sV;  // A of the score product
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    if (wg == 1) named_arrive(kBarPEmpty);  // the buffer starts empty
    for (int qt = first_q, t = 0; qt < num_q; ++qt, ++t) {
      const int s = t % kStages;
      const int q0 = qt * kBlockQ;
      const uint32_t sQs = sQ + s * kQBytes;
      const uint32_t sGs = sG + s * kQBytes;
      const float* lse_s = rows_smem + s * 2 * kBlockQ;
      const float* delta_s = lse_s + kBlockQ;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
      float x[kBlockQ / 2];
#pragma unroll
      for (int i = 0; i < kBlockQ / 2; ++i) x[i] = 0.f;
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(x, kmajor_desc<D>(sA, kKeys, 0, kk),
                 kmajor_desc<D>(wg == 0 ? sQs : sGs, kBlockQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);

      const bool edge = q0 + kBlockQ > L || (causal && q0 < key_lo + 63);
      if (wg == 0) {
        // P^T in f32, masked where the tile crosses the diagonal or L
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
          const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + c);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = q0 + 8 * j + c + e;
            const float lse2 = (e ? lz.y : lz.x) * kLog2e;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const bool live = !edge || (col < L && !(causal && col < keys[h]));
              x[i] = live ? exp2f(fmaf(x[i], scale_log2, -lse2)) : 0.f;
            }
          }
        }
        named_sync(kBarPEmpty);  // warpgroup 1 has read the last tile's P^T
#pragma unroll
        for (int i = 0; i < kBlockQ / 2; ++i) p_smem[i * 128] = x[i];
        named_arrive(kBarPFull);
      } else {
        named_sync(kBarPFull);
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
          const float2 dz = *reinterpret_cast<const float2*>(delta_s + 8 * j + c);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              x[i] = p_smem[i * 128] * (x[i] - (e ? dz.y : dz.x));
            }
          }
        }
        if (qt + 1 < num_q) named_arrive(kBarPEmpty);
      }
      uint32_t xa[kBlockQ / 16][4];
      to_a_frags(x, xa);

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), MN-major from the stage
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        wgmma_rs(acc, xa[kk], mnmajor_desc<D>(wg == 0 ? sGs : sQs, kBlockQ, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
    }

    __nv_bfloat16* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = keys[h];
      if (key >= L) continue;
      const size_t at = (static_cast<size_t>(bh) * L + key) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(out + at + 8 * j + c, acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  } else {
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    for (int qt = first_q, t = 0; qt < num_q; ++qt, ++t) {
      const int s = t % kStages;
      const int q0 = qt * kBlockQ;
      const uint32_t sQs = sQ + s * kQBytes;
      const uint32_t sGs = sG + s * kQBytes;
      const float* lse_s = rows_smem + s * 2 * kBlockQ;
      const float* delta_s = lse_s + kBlockQ;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys by the stage's kBlockQ rows
      float st[kBlockQ / 2], dpt[kBlockQ / 2];
#pragma unroll
      for (int i = 0; i < kBlockQ / 2; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.f;
      }
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, kmajor_desc<D>(sK, kKeys, 64 * wg, kk), kmajor_desc<D>(sQs, kBlockQ, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, kmajor_desc<D>(sV, kKeys, 64 * wg, kk), kmajor_desc<D>(sGs, kBlockQ, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in f32, masked where the tile crosses the diagonal or L
      // (a masked logit is -1e30, and exp(-1e30 - lse) is 0)
      const bool edge = q0 + kBlockQ > L || (causal && q0 < key_lo + 63);
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
        const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + c);
        const float2 dz = *reinterpret_cast<const float2*>(delta_s + 8 * j + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = q0 + 8 * j + c + e;
          const float lse2 = (e ? lz.y : lz.x) * kLog2e;
          const float del = e ? dz.y : dz.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const bool live = !edge || (col < L && !(causal && col < keys[h]));
            const float p = live ? exp2f(fmaf(st[i], scale_log2, -lse2)) : 0.f;
            dpt[i] = p * (dpt[i] - del);
            st[i] = p;
          }
        }
      }
      uint32_t pa[kBlockQ / 16][4], da[kBlockQ / 16][4];
      to_a_frags(st, pa);
      to_a_frags(dpt, da);

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major from the stage
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        wgmma_rs(dva, pa[kk], mnmajor_desc<D>(sGs, kBlockQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk)
        wgmma_rs(dka, da[kk], mnmajor_desc<D>(sQs, kBlockQ, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = keys[h];
      if (key >= L) continue;
      const size_t at = (static_cast<size_t>(bh) * L + key) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store2(dk + at + 8 * j + c, dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
        store2(dv + at + 8 * j + c, dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for one 128-row q tile, given lse and delta = rowsum(dO*O) - dlse:
//   S = Q K^T, dP = dO V^T, P = exp(S * scale - lse[row]),
//   dS = P (dP - delta[row]), dQ += dS K (* scale at the end)
// The forward's shape with one more score-sized product: Q and dO stay
// resident, K and V stream, and dS's accumulator is the A operand of dS K.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int kBlockK = Shape<D>::kBlockK;
  constexpr int kDqStages = Shape<D>::kDqStages;
  return 1024                                          // alignment slack
         + 2 * tile_bytes<D>(kRows)                    // q, dO
         + 2 * kDqStages * tile_bytes<D>(kBlockK)      // k, v ring
         + 8 * (1 + 2 * kDqStages);                    // mbarriers
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int L,
                      float scale, int causal) {
  constexpr int kBlockK = Shape<D>::kBlockK;
  constexpr int kDqStages = Shape<D>::kDqStages;
  constexpr uint32_t kQBytes = tile_bytes<D>(kRows);
  constexpr uint32_t kKVBytes = tile_bytes<D>(kBlockK);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = align_1024(smem_u32(smem_raw));
  const uint32_t sG = sQ + kQBytes;  // dO
  const uint32_t sK = sG + kQBytes;
  const uint32_t sV = sK + kDqStages * kKVBytes;
  const uint32_t bar_q = sV + kDqStages * kKVBytes;
  const uint32_t bar_full = bar_q + 8;                 // one per stage
  const uint32_t bar_empty = bar_full + 8 * kDqStages;  // one per stage

  const int bh = blockIdx.x;
  // the last q-tiles see the most k-tiles under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = causal ? min(L, q0 + kRows) : L;
  const int num_kv = (kv_end + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * kQBytes);
      load_tile<D>(sQ, &tm_q, bar_q, kRows, q0, bh);
      load_tile<D>(sG, &tm_do, bar_q, kRows, q0, bh);
      for (int t = 0; t < num_kv; ++t) {
        const int s = t % kDqStages;
        mbar_wait(bar_empty + 8 * s, ((t / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
        load_tile<D>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
        load_tile<D>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int c = 2 * (lane % 4);
  const int row_lo = q0 + 64 * wg;  // first row of this warpgroup
  const int rows[2] = {row_lo + r, row_lo + r + 8};
  const float scale_log2 = scale * kLog2e;
  // keys this warpgroup's rows reach: a k-tile wholly above its diagonal
  // adds nothing to dQ, and the warpgroup only releases its stage
  const int wg_end = causal ? min(kv_end, row_lo + 64) : kv_end;

  // lse (in log2 units) and delta of this thread's two rows; 0 past L, where
  // the zero-filled q and dO rows give dS = 0 and nothing is stored
  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = static_cast<size_t>(bh) * L + rows[h];
    lse2[h] = rows[h] < L ? lse[at] * kLog2e : 0.f;
    del[h] = rows[h] < L ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < num_kv; ++t) {
    const int s = t % kDqStages;
    const int k0 = t * kBlockK;
    const uint32_t sKs = sK + s * kKVBytes;
    const uint32_t sVs = sV + s * kKVBytes;
    mbar_wait(bar_full + 8 * s, (t / kDqStages) & 1);
    if (k0 < wg_end) {  // uniform over the warpgroup
      // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows and the stage's keys
      float sc[kBlockK / 2], dp[kBlockK / 2];
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        sc[i] = 0.f;
        dp[i] = 0.f;
      }
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, kmajor_desc<D>(sQ, kRows, 64 * wg, kk), kmajor_desc<D>(sKs, kBlockK, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor_desc<D>(sG, kRows, 64 * wg, kk), kmajor_desc<D>(sVs, kBlockK, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P and dS in f32, masked where the tile crosses the diagonal or L
      // (a masked logit is -1e30, and exp(-1e30 - lse) is 0)
      const bool edge = k0 + kBlockK > L || (causal && k0 + kBlockK - 1 > row_lo);
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        const int h = (i / 2) % 2;
        const int col = k0 + 8 * (i / 4) + c + i % 2;
        const bool live = !edge || (col < L && !(causal && col > rows[h]));
        const float p = live ? exp2f(fmaf(sc[i], scale_log2, -lse2[h])) : 0.f;
        dp[i] = p * (dp[i] - del[h]);
      }
      uint32_t da[kBlockK / 16][4];
      to_a_frags(dp, da);

      // dQ += dS K, K read MN-major from the stage
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        wgmma_rs(acc, da[kk], mnmajor_desc<D>(sKs, kBlockK, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= L) continue;
    __nv_bfloat16* dqrow = dq + (static_cast<size_t>(bh) * L + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dqrow + 8 * j + c, acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launchers
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API call. It is reached through the
// runtime's cudaGetDriverEntryPointByVersion, so the library links against
// nothing beyond the runtime nvcc already links, and loads wherever PyTorch
// has a driver.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A (B*H, L, D) bf16 tensor as a 3-D map (D, L, B*H) read in boxes of one
// panel (Shape<D>::kPanel columns, swizzled over its width) by `rows` rows of
// one head; rows past L zero-fill
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int L, int D, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(L) * D * 2};
  const int panel = D < 64 ? D : 64;
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(panel), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             panel == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TO, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int L, float scale, int causal, cudaStream_t stream) {
  constexpr int kBlockKV = Shape<D>::kBlockKV;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, kRows)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, kBlockKV)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, kBlockKV)) != cudaSuccess) return err;
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_wgmma_kernel<TO, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<TO*>(o),
                                           static_cast<float*>(lse), L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH, int L,
                        float scale, int causal, cudaStream_t stream) {
  constexpr int kKeys = Shape<D>::kKvRows;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, kBlockQ)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, kKeys)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, kKeys)) != cudaSuccess) return err;
  if ((err = make_map(&tg, dout, BH, L, D, kBlockQ)) != cudaSuccess) return err;
  constexpr size_t smem = dkdv_smem_bytes<D>();
  auto kernel = flash_dkdv_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + kKeys - 1) / kKeys);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int L, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int kBlockK = Shape<D>::kBlockK;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, kRows)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tg, dout, BH, L, D, kRows)) != cudaSuccess) return err;
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tg, static_cast<const float*>(lse),
                                           static_cast<const float*>(delta),
                                           static_cast<__nv_bfloat16*>(dq), L, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_wgmma
