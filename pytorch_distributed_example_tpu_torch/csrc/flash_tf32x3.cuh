// Flash forward, dK/dV and dQ for float32 operands at head dims 32, 64, 128
// and 256, on the tensor cores at float32 accuracy. Included by
// flash_attention.cu, whose note says what bounds these kernels;
// ops/flash_attention.py routes every float32 role here ("tf32x3").
//
// Three TF32 passes. x = big + small, big = x rounded to nearest TF32 (the
// top 19 bits, low 13 mantissa bits cleared) and small = x - big, exact in
// float32, of which the tensor core reads the top 19 bits. Every product
// runs as small*big + big*small + big*big, in that order; what is lost is
// ~2^-21 of |x*y| (small's low bits and the dropped small*small term). How
// the passes are summed, against the tensor core's truncating adds, is
// above `mma3_score`. One pass (~2^-11) would miss the float32 tolerance by
// orders of magnitude.
//
// Why mma.sync and not wgmma. wgmma takes .tf32 operands from shared memory
// K-major only (no transpose bits), and every shared-memory operand of a
// three-pass product needs its big and small planes there. A float32 row is
// 4*D bytes: at D 128 the resident K and V of a 64-key tile with their small
// planes are 128 KiB, and a 32-row stage of Q and dO read both ways (d-major
// for S^T, q-major for P^T dO), each with its planes, another 128 KiB: 256
// KiB against the 227 KiB a block may use, before a second stage. mma.sync
// m16n8k8 takes its fragments from registers, which threads load from one
// raw float32 copy of each tile in any order and split in registers, so
// shared memory holds each tile once, as TMA lands it, and no transposed
// copies exist:
//   * A row-major (K-major) fragment, A[g][t], A[g+8][t], A[g][t+4],
//     A[g+8][t+4] (g = lane / 4, t = lane % 4), and a K-major B fragment,
//     B[n = g][k = t], B[g][t+4], are read from the tiles as they lie.
//   * The accumulation products (O += P V, dV += P^T dO, dK += dS^T Q,
//     dQ += dS K)
//     take their A operand from the score accumulator, whose thread holds
//     columns 2t and 2t+1 of each 8-column block, where the A fragment wants
//     columns t and t+4. The sum over k does not care about its order, so
//     each K-step is read in the permuted order (t, t+4) -> (2t, 2t+1): the
//     accumulator's four values are the fragment, and the B fragment is read
//     at rows 2t and 2t+1 of the row-major tile (an MN-major read, which
//     mma.sync allows because the threads do the loading).
// Tiles land by TMA with the 128-byte swizzle (panels of 32 floats), under
// which each of the fragment reads above hits 32 distinct banks.
//
// Roles. 4 or 8 warps, each owning 16 rows of the block's output tile (the
// m16 of mma.sync). The forward holds its Q rows resident and streams K and
// V; dQ holds its Q and dO rows resident and streams K and V; dK/dV holds
// its K and V rows resident and streams Q, dO, lse and delta through a ring
// of two stages. The loads are TMA's, behind full/empty mbarriers: when
// every warp has released a stage, thread 0 (warp 0 in dK/dV, whose lanes
// also copy lse and delta) issues the tile after next into it, so the next
// stage is in flight while the warps compute. There is no producer warp: 8
// warps get 255 registers a thread, where 9 get 168 (a third warp on one of
// the SM's four register files) and a producer warpgroup's setmaxnreg does
// not lift what ptxas allocates. The numerics: every score product is
// scaled after it (the forward's logits are the bits the backward
// recomputes), with the accurate expf; masked logits are -1e30 and give p =
// 0; the forward's online softmax keeps each row's max and sum in the
// registers of the quad (four lanes) that holds the row, reduced over the
// quad by two xor shuffles; no atomics, and every sum runs in a fixed
// order, so a result is bitwise the same from run to run.
//
// Shapes (`FwdShape`, `DqShape`, `KvShape`), against 232,448 bytes of
// shared memory a block and 255 registers a thread:
//   forward: 8 warps (128 rows) at every head dim, streaming 64 keys a
//     stage at D 32 and 64, 32 at D 128 and 16 at D 256 (Q alone takes 128
//     KiB there, beside O's 128 accumulators a thread); with no dO it holds
//     twice dQ's rows at D 256.
//   dQ: 8 warps (128 rows) up to D 128, streaming 64 keys a stage at D 32
//     and 32 at D 64 and 128 (Q and dO take 128 KiB there; S, dP and their
//     cross-term halves are 4 x kBlockK/2 floats a thread); at D 256, 4
//     warps (64 rows: Q and dO 128 KiB) and 16-key stages beside dQ's 128
//     accumulators a thread.
//   dK/dV: 32-row q stages up to D 128. At D 32 and 64, 8 warps (128
//     keys), each warp holding dK and dV (2 x D/2 floats a thread) beside
//     its score tiles. From D 128 the block owns 64 keys and splits by
//     output as the bf16 D 256 kernel does: warps 0-3 compute S^T and P^T
//     and accumulate dV, warps 4-7 compute dP^T and accumulate dK, taking
//     P^T from their partner warp through shared memory; one accumulator of
//     D/2 floats a thread. At D 256, where K and V alone take 128 KiB, the
//     q stages are 16 rows. Larger stages spill: 64 or 48 rows at D 128
//     left ptxas 8-12 bytes short of 255 registers.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_wgmma.cuh"

namespace flash_tf32x3 {

using flash_wgmma::align_1024;
using flash_wgmma::encode_tiled;
using flash_wgmma::fence_barrier_init;
using flash_wgmma::mbar_arrive;
using flash_wgmma::mbar_arrive_expect_tx;
using flash_wgmma::mbar_init;
using flash_wgmma::mbar_wait;
using flash_wgmma::named_arrive;
using flash_wgmma::named_sync;
using flash_wgmma::smem_u32;
using flash_wgmma::tma_load_3d;

constexpr int kPanel = 32;  // floats of a TMA box row and a swizzled panel: 128 bytes
constexpr int kStages = 2;  // ring depth of the streamed tiles
constexpr float kNegInf = -1e30f;  // a masked logit
// named barriers of the split dK/dV (0 is __syncthreads)
constexpr int kBarPFull = flash_wgmma::kBarPFull;
constexpr int kBarPEmpty = flash_wgmma::kBarPEmpty;

template <int D>
struct FwdShape {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "no tf32x3 instance for this head dim");
  static constexpr int kWarps = 8;                                 // warps, 16 query rows each
  static constexpr int kRows = 16 * kWarps;                        // query rows a block owns
  static constexpr int kBlockK = D > 128 ? 16 : D > 64 ? 32 : 64;  // keys a stage
};

template <int D>
struct DqShape {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "no tf32x3 instance for this head dim");
  static constexpr int kWarps = D > 128 ? 4 : 8;  // warps, 16 query rows each
  static constexpr int kRows = 16 * kWarps;       // query rows a block owns
  static constexpr int kBlockK = D > 128 ? 16 : D > 32 ? 32 : 64;  // keys a stage
};

template <int D>
struct KvShape {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "no tf32x3 instance for this head dim");
  static constexpr bool kSplit = D > 64;  // dK and dV on different warps
  static constexpr int kWarps = 8;
  static constexpr int kKeys = kSplit ? 64 : 128;  // keys a block owns
  static constexpr int kBlockQ = D > 128 ? 16 : 32;  // query rows a stage
};

// bytes of an R-row float32 tile at head dim D
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * D * 4;
}

// An R-row tile lies in shared memory as D/32 panels of R rows of 128
// bytes, element (r, c) at byte (c / 32) * R * 128 + r * 128 + 16 * (((c /
// 4) % 8) ^ (r % 8)) + 4 * (c % 4): TMA's 128-byte swizzle. A thread's
// reads differ from one another only by a row and panel known at compile
// time and by one of 8 offsets that depend on its lane, made where a phase
// needs them (`lanes` keeps the compiler from hoisting them out of the tile
// loop, where they would hold 16 registers through both phases):
//   Kmaj::o[m]: row g, column 4m + t of a panel, for the K-major reads of
//     fragment rows g and g + 8 (m = 2q + h: K-step q of the panel, half h);
//   Perm::o[m]: row 2t + e, column 8c + g of a panel (m = 2c + e), for the
//     permuted B reads.
struct Kmaj {
  uint32_t o[8];
};
struct Perm {
  uint32_t o[8];
};

// g and t, opaque to the compiler
__device__ __forceinline__ void lanes(int& g, int& t) {
  g = threadIdx.x % 32 / 4;
  t = threadIdx.x % 4;
  asm volatile("" : "+r"(g), "+r"(t));
}

__device__ __forceinline__ Kmaj kmaj_offsets() {
  int g, t;
  lanes(g, t);
  Kmaj z;
#pragma unroll
  for (int m = 0; m < 8; ++m) z.o[m] = g * 128 + ((m ^ g) << 4) + (t << 2);
  return z;
}

__device__ __forceinline__ Perm perm_offsets() {
  int g, t;
  lanes(g, t);
  Perm z;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = 2 * t + m % 2;
    z.o[m] = r * 128 + (((m - m % 2 + (g >> 2)) ^ r) << 4) + ((g & 3) << 2);
  }
  return z;
}

__device__ __forceinline__ float lds(const unsigned char* p, uint32_t off) {
  return *reinterpret_cast<const float*>(p + off);
}

// rows row0 .. row0+rows of head bh, all D columns, as D/32 swizzled panels
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p)
    tma_load_3d(dst + p * rows * 128, map, bar, kPanel * p, row0, bh);
}

// x rounded to nearest TF32 (ties away from zero): the low 13 mantissa bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big is x rounded to TF32, small the float32 remainder,
// exact, of which the tensor core reads the top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct Frag4 {
  uint32_t big[4], small[4];
};
struct Frag2 {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ Frag4 split4(float a0, float a1, float a2, float a3) {
  Frag4 f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ Frag2 split2(float b0, float b1) {
  Frag2 f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// d += a * b, m16n8k8, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor core sums each mma's products into its float32 accumulator
// with truncation, up to an ulp of the accumulator each time. Left alone
// over a long K that bias adds up (three truncations a K-step, hundreds
// over L 1000, all toward zero), so no big*big sum runs long in one
// accumulator:
//   * A score product (S, dP, S^T, dP^T; K = D, from 0 each tile) takes
//     each two K-steps' big*big into a partial from 0 and adds it to the
//     score with a float32 add, which rounds to nearest; the cross terms,
//     ~2^-11 of the score, accumulate over all of D beside it.
//   * An accumulation over the sequence (dV, dK, dQ) sums one tile's K-steps
//     in two partials from 0, big*big and the cross terms, and adds both to
//     its accumulator with a float32 add.
// Each product's passes run in the order small*big, big*small, big*big.

// s += a0 * b0 + a1 * b1 for a score, two K-steps: their big*big through a
// partial, the cross terms into x
__device__ __forceinline__ void mma3_score(float (&s)[4], float (&x)[4], const Frag4& a0,
                                           const Frag2& b0, const Frag4& a1, const Frag2& b1) {
  float bb[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(x, a0.small, b0.big);
  mma_tf32(x, a0.big, b0.small);
  mma_tf32(bb, a0.big, b0.big);
  mma_tf32(x, a1.small, b1.big);
  mma_tf32(x, a1.big, b1.small);
  mma_tf32(bb, a1.big, b1.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] += bb[e];
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc[n] += sum over j of a[j] * B(j, n), the B fragment of K-step j and
// column block n read by `load`: a big*big and a cross-term partial a
// column block
template <int N, int J, typename Load>
__device__ __forceinline__ void accumulate(float (&acc)[N][4], const Frag4 (&a)[J], Load load) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float bb[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const Frag2 b = load(j, n);
      mma_tf32(x, a[j].small, b.big);
      mma_tf32(x, a[j].big, b.small);
      mma_tf32(bb, a[j].big, b.big);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += bb[e] + x[e];
  }
}

// The A fragment of rows row0 .. row0+15 (row0 % 8 == 0), K-step q of a
// panel, read K-major; `panel` is the tile plus the panel's offset
__device__ __forceinline__ Frag4 load_a(const unsigned char* panel, int row0, int q,
                                        const Kmaj& z) {
  const unsigned char* r = panel + row0 * 128;
  return split4(lds(r, z.o[2 * q]), lds(r + 8 * 128, z.o[2 * q]), lds(r, z.o[2 * q + 1]),
                lds(r + 8 * 128, z.o[2 * q + 1]));
}

// The B fragment of n-block rows row0 .. row0+7, K-step q of a panel, read
// K-major (n = tile row, k = tile column)
__device__ __forceinline__ Frag2 load_b(const unsigned char* panel, int row0, int q,
                                        const Kmaj& z) {
  const unsigned char* r = panel + row0 * 128;
  return split2(lds(r, z.o[2 * q]), lds(r, z.o[2 * q + 1]));
}

// The B fragment of columns 8n .. 8n+7 of an R-row tile, K-step over its
// rows row0 .. row0+7 in the permuted order (k = t -> row 2t, t+4 -> 2t+1)
template <int R>
__device__ __forceinline__ Frag2 load_b_perm(const unsigned char* tile, int row0, int n,
                                             const Perm& z) {
  const unsigned char* r = tile + (n / 4) * R * 128 + row0 * 128;
  return split2(lds(r, z.o[2 * (n % 4)]), lds(r, z.o[2 * (n % 4) + 1]));
}

// The A fragment of K-step j from an accumulator block (element e at row
// g + 8 (e / 2), column 2t + e % 2), in the permuted order
__device__ __forceinline__ Frag4 acc_to_a(const float (&c)[4]) {
  return split4(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------------------
// The forward for one tile of query rows, an online softmax over the keys:
//   S = Q K^T (* scale after the product), m = running row max,
//   P = exp(S - m), l = l * exp(m_old - m) + rowsum(P), O = O * exp(m_old - m) + P V,
//   o = O / l, lse = m + log l
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  using S = FwdShape<D>;
  return 1024                                         // alignment slack
         + tile_bytes<D>(S::kRows)                    // q
         + 2 * kStages * tile_bytes<D>(S::kBlockK)    // k, v ring
         + 8 * (1 + 2 * kStages);                     // mbarriers
}

template <int D>
__global__ void __launch_bounds__(FwdShape<D>::kWarps * 32, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                        float* __restrict__ lse, int L, float scale, int causal) {
  using S = FwdShape<D>;
  constexpr int kRows = S::kRows;
  constexpr int kBlockK = S::kBlockK;
  constexpr uint32_t kQBytes = tile_bytes<D>(kRows);
  constexpr uint32_t kKVBytes = tile_bytes<D>(kBlockK);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = align_1024(raw);
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;
  const uint32_t bar_full = bar_q + 8;               // one per stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // one per stage

  const int bh = blockIdx.x;
  // the last q-tiles see the most k-tiles under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = causal ? min(L, q0 + kRows) : L;
  const int num_kv = (kv_end + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // k-tile t into its stage, completing on the stage's full barrier
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
    load_tile<D>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
    load_tile<D>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 32 * S::kWarps);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, kQBytes);
    load_tile<D>(sQ, &tm_q, bar_q, kRows, q0, bh);
    for (int t = 0; t < min(kStages, num_kv); ++t) load_kv(t);
  }
  __syncthreads();

  const unsigned char* Qs = smem_raw + (sQ - raw);
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row_lo = q0 + 16 * warp;  // first row of this warp
  const int rows[2] = {row_lo + g, row_lo + g + 8};
  // keys this warp's rows reach: a k-tile wholly above its diagonal would
  // leave m, l and O as they are (p = 0, alpha = 1), and the warp only
  // releases its stage
  const int warp_end = causal ? min(kv_end, row_lo + 16) : kv_end;

  // running max and sum of this thread's two rows, and their O columns
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  mbar_wait(bar_q, 0);
  for (int t = 0; t < num_kv; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockK;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    if (k0 < warp_end) {  // uniform over the warp
      const unsigned char* Ks = smem_raw + (sK + s * kKVBytes - raw);
      const unsigned char* Vs = smem_raw + (sV + s * kKVBytes - raw);

      // S = Q K^T for this warp's 16 rows and the stage's keys
      float sc[kBlockK / 8][4], scx[kBlockK / 8][4];
      zero(sc);
      zero(scx);
      const Kmaj z = kmaj_offsets();
#pragma unroll 1
      for (int p = 0; p < D / kPanel; ++p) {
        const unsigned char* Qp = Qs + p * kRows * 128;
        const unsigned char* Kp = Ks + p * kBlockK * 128;
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const Frag4 qa0 = load_a(Qp, 16 * warp, q, z), qa1 = load_a(Qp, 16 * warp, q + 1, z);
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j)
            mma3_score(sc[j], scx[j], qa0, load_b(Kp, 8 * j, q, z), qa1,
                       load_b(Kp, 8 * j, q + 1, z));
        }
      }

      // logits, -1e30 where the tile crosses the diagonal or L, and each
      // row's max over the tile: this thread's columns, then its quad's
      // (the four lanes that hold one row)
      const bool edge = k0 + kBlockK > L || (causal && k0 + kBlockK - 1 > row_lo);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int col = k0 + 8 * j + 2 * t4 + e % 2;
          const bool live = !edge || (col < L && !(causal && col > rows[h]));
          sc[j][e] = live ? (sc[j][e] + scx[j][e]) * scale : kNegInf;
          mx[h] = fmaxf(mx[h], sc[j][e]);
        }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        m_safe[h] = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[h] = expf(m[h] - m_new);  // both -1e30 -> 1, and O is 0
        m[h] = m_new;
      }

      // P, its row sums (this thread's columns in order, then the quad's),
      // and O rescaled
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = expf(sc[j][e] - m_safe[e / 2]);
          ps[e / 2] += sc[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l[h] = l[h] * alpha[h] + ps[h];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

      // O += P V, K-steps over the stage's keys in the permuted order
      Frag4 pa[kBlockK / 8];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) pa[j] = acc_to_a(sc[j]);
      const Perm zp = perm_offsets();
      accumulate(acc, pa, [&](int j, int n) { return load_b_perm<kBlockK>(Vs, 8 * j, n, zp); });
    }
    // every warp is done with the stage: thread 0 refills it
    mbar_arrive(bar_empty + 8 * s);
    if (threadIdx.x == 0 && t + kStages < num_kv) {
      mbar_wait(bar_empty + 8 * s, (t / kStages) & 1);
      load_kv(t + kStages);
    }
    __syncwarp();
  }

  // o = O / l and lse = m + log l, l clamped at 1e-30; one lane of a quad
  // writes its row's lse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= L) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    float* orow = o + (static_cast<size_t>(bh) * L + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * h] / l_safe, acc[n][2 * h + 1] / l_safe);
    if (t4 == 0) lse[static_cast<size_t>(bh) * L + row] = m[h] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dQ for one tile of query rows, given lse and delta = rowsum(dO*O) - dlse:
//   S = Q K^T, dP = dO V^T, P = exp(S * scale - lse[row]),
//   dS = P (dP - delta[row]), dQ += dS K (* scale at the end)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  using S = DqShape<D>;
  return 1024                                         // alignment slack
         + 2 * tile_bytes<D>(S::kRows)                // q, dO
         + 2 * kStages * tile_bytes<D>(S::kBlockK)    // k, v ring
         + 8 * (1 + 2 * kStages);                     // mbarriers
}

template <int D>
__global__ void __launch_bounds__(DqShape<D>::kWarps * 32, 1)
flash_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq, int L,
                       float scale, int causal) {
  using S = DqShape<D>;
  constexpr int kRows = S::kRows;
  constexpr int kBlockK = S::kBlockK;
  constexpr uint32_t kQBytes = tile_bytes<D>(kRows);
  constexpr uint32_t kKVBytes = tile_bytes<D>(kBlockK);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = align_1024(raw);
  const uint32_t sG = sQ + kQBytes;  // dO
  const uint32_t sK = sG + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;
  const uint32_t bar_full = bar_q + 8;               // one per stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // one per stage

  const int bh = blockIdx.x;
  // the last q-tiles see the most k-tiles under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = causal ? min(L, q0 + kRows) : L;
  const int num_kv = (kv_end + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // k-tile t into its stage, completing on the stage's full barrier
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(bar_full + 8 * s, 2 * kKVBytes);
    load_tile<D>(sK + s * kKVBytes, &tm_k, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
    load_tile<D>(sV + s * kKVBytes, &tm_v, bar_full + 8 * s, kBlockK, t * kBlockK, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 32 * S::kWarps);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, 2 * kQBytes);
    load_tile<D>(sQ, &tm_q, bar_q, kRows, q0, bh);
    load_tile<D>(sG, &tm_do, bar_q, kRows, q0, bh);
    for (int t = 0; t < min(kStages, num_kv); ++t) load_kv(t);
  }
  __syncthreads();

  const unsigned char* Qs = smem_raw + (sQ - raw);
  const unsigned char* Gs = smem_raw + (sG - raw);
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row_lo = q0 + 16 * warp;  // first row of this warp
  const int rows[2] = {row_lo + g, row_lo + g + 8};
  // keys this warp's rows reach: a k-tile wholly above its diagonal adds
  // nothing to dQ, and the warp only releases its stage
  const int warp_end = causal ? min(kv_end, row_lo + 16) : kv_end;

  // lse and delta of this thread's two rows; 0 past L, where the zero-filled
  // q and dO rows give dS = 0 and nothing is stored
  float lse_r[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = static_cast<size_t>(bh) * L + rows[h];
    lse_r[h] = rows[h] < L ? lse[at] : 0.f;
    del[h] = rows[h] < L ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < num_kv; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockK;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    if (k0 < warp_end) {  // uniform over the warp
      const unsigned char* Ks = smem_raw + (sK + s * kKVBytes - raw);
      const unsigned char* Vs = smem_raw + (sV + s * kKVBytes - raw);

      // S = Q K^T and dP = dO V^T for this warp's 16 rows and the stage's keys
      float sc[kBlockK / 8][4], scx[kBlockK / 8][4], dp[kBlockK / 8][4], dpx[kBlockK / 8][4];
      zero(sc);
      zero(scx);
      zero(dp);
      zero(dpx);
      const Kmaj z = kmaj_offsets();
#pragma unroll 1
      for (int p = 0; p < D / kPanel; ++p) {
        const unsigned char* Qp = Qs + p * kRows * 128;
        const unsigned char* Gp = Gs + p * kRows * 128;
        const unsigned char* Kp = Ks + p * kBlockK * 128;
        const unsigned char* Vp = Vs + p * kBlockK * 128;
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const Frag4 qa0 = load_a(Qp, 16 * warp, q, z), qa1 = load_a(Qp, 16 * warp, q + 1, z);
          const Frag4 ga0 = load_a(Gp, 16 * warp, q, z), ga1 = load_a(Gp, 16 * warp, q + 1, z);
#pragma unroll
          for (int j = 0; j < kBlockK / 8; ++j) {
            mma3_score(sc[j], scx[j], qa0, load_b(Kp, 8 * j, q, z), qa1,
                       load_b(Kp, 8 * j, q + 1, z));
            mma3_score(dp[j], dpx[j], ga0, load_b(Vp, 8 * j, q, z), ga1,
                       load_b(Vp, 8 * j, q + 1, z));
          }
        }
      }

      // P and dS, masked where the tile crosses the diagonal or L (a masked
      // logit is -1e30, and exp(-1e30 - lse) is 0)
      const bool edge = k0 + kBlockK > L || (causal && k0 + kBlockK - 1 > row_lo);
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int col = k0 + 8 * j + 2 * t4 + e % 2;
          const bool live = !edge || (col < L && !(causal && col > rows[h]));
          const float p = live ? expf((sc[j][e] + scx[j][e]) * scale - lse_r[h]) : 0.f;
          dp[j][e] = p * (dp[j][e] + dpx[j][e] - del[h]);
        }

      // dQ += dS K, K-steps over the stage's keys in the permuted order
      Frag4 da[kBlockK / 8];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) da[j] = acc_to_a(dp[j]);
      const Perm zp = perm_offsets();
      accumulate(acc, da, [&](int j, int n) { return load_b_perm<kBlockK>(Ks, 8 * j, n, zp); });
    }
    // every warp is done with the stage: thread 0 refills it
    mbar_arrive(bar_empty + 8 * s);
    if (threadIdx.x == 0 && t + kStages < num_kv) {
      mbar_wait(bar_empty + 8 * s, (t / kStages) & 1);
      load_kv(t + kStages);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= L) continue;
    float* dqrow = dq + (static_cast<size_t>(bh) * L + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dqrow + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV for one tile of keys, given lse and delta, computed transposed so
// that each score result is the next product's A operand:
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T * scale - lse[col]),
//   dS^T = P^T (dP^T - delta[col]), dV += P^T dO, dK += dS^T Q (* scale at the end)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkdv_smem_bytes() {
  using S = KvShape<D>;
  return 1024                                                              // alignment slack
         + 2 * tile_bytes<D>(S::kKeys)                                     // k, v
         + kStages * (2 * tile_bytes<D>(S::kBlockQ) + 2 * 4 * S::kBlockQ)  // q, dO, lse, delta
         + (S::kSplit ? 4 * 128 * (S::kBlockQ / 2) : 0)                    // P^T handed over
         + 8 * (1 + 2 * kStages);                                          // mbarriers
}

template <int D>
__global__ void __launch_bounds__(KvShape<D>::kWarps * 32, 1)
flash_dkdv_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int L, float scale, int causal) {
  using S = KvShape<D>;
  constexpr bool kSplit = S::kSplit;
  constexpr int kKeys = S::kKeys;
  constexpr int kBlockQ = S::kBlockQ;
  constexpr int kWarps = S::kWarps;
  constexpr uint32_t kKBytes = tile_bytes<D>(kKeys);
  constexpr uint32_t kQBytes = tile_bytes<D>(kBlockQ);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align_1024(raw);
  const uint32_t sV = sK + kKBytes;
  const uint32_t sQ = sV + kKBytes;               // one q tile per stage
  const uint32_t sG = sQ + kStages * kQBytes;     // one dO tile per stage
  const uint32_t sRows = sG + kStages * kQBytes;  // per stage: lse then delta, kBlockQ each
  const uint32_t sP = sRows + kStages * 2 * 4 * kBlockQ;  // split: P^T, [element][thread]
  const uint32_t bar_kv = sP + (kSplit ? 4 * 128 * (kBlockQ / 2) : 0);
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

  // Warp 0 fills stage t % kStages with q-tile first_q + t: lse and delta
  // by its lanes, Q and dO by TMA, completing on the stage's full barrier
  const float* lse_bh = lse + static_cast<size_t>(bh) * L;
  const float* delta_bh = delta + static_cast<size_t>(bh) * L;
  auto load_q = [&](int t) {
    const int s = t % kStages;
    const int q0 = (first_q + t) * kBlockQ;
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
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // every lane of warp 0, after its lse/delta stores
      mbar_init(bar_empty + 8 * s, 32 * kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int num_t = num_q - first_q;  // q-tiles this block visits
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kKBytes);
      load_tile<D>(sK, &tm_k, bar_kv, kKeys, k0, bh);
      load_tile<D>(sV, &tm_v, bar_kv, kKeys, k0, bh);
    }
    for (int t = 0; t < min(kStages, num_t); ++t) load_q(t);
  }
  // every warp is done with stage t % kStages: warp 0 refills it
  auto release = [&](int t) {
    const int s = t % kStages;
    mbar_arrive(bar_empty + 8 * s);
    if (warp == 0 && t + kStages < num_t) {
      mbar_wait(bar_empty + 8 * s, (t / kStages) & 1);
      load_q(t + kStages);
    }
  };

  const unsigned char* Ks = smem_raw + (sK - raw);
  const unsigned char* Vs = smem_raw + (sV - raw);
  const int g = lane / 4;
  const int t4 = lane % 4;
  // split: warps w and w + 4 share keys, w (warpgroup 0) for dV, w + 4 for dK
  const int wk = kSplit ? warp % 4 : warp;  // this warp's 16 keys within the tile
  const int key_lo = k0 + 16 * wk;
  const int keys[2] = {key_lo + g, key_lo + g + 8};

  if constexpr (kSplit) {
    const bool dv_warp = warp < 4;
    const unsigned char* As = dv_warp ? Ks : Vs;  // A of the score product
    // thread t of a warpgroup keeps its element i at p_smem[i * 128 + t]
    float* p_smem = reinterpret_cast<float*>(smem_raw + (sP - raw)) + threadIdx.x % 128;
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    mbar_wait(bar_kv, 0);
    if (!dv_warp) named_arrive(kBarPEmpty);  // the buffer starts empty
    for (int qt = first_q, t = 0; qt < num_q; ++qt, ++t) {
      const int s = t % kStages;
      const int q0 = qt * kBlockQ;
      const unsigned char* Qs = smem_raw + (sQ + s * kQBytes - raw);
      const unsigned char* Gs = smem_raw + (sG + s * kQBytes - raw);
      const float* lse_s = rows_smem + s * 2 * kBlockQ;
      const float* delta_s = lse_s + kBlockQ;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      // both warps of a pair take the same branch, and both pass the barriers
      const bool live_tile = !causal || q0 + kBlockQ - 1 >= key_lo;
      const bool edge = q0 + kBlockQ > L || (causal && q0 < key_lo + 15);

      // S^T = K Q^T (dV warps) or dP^T = V dO^T (dK warps)
      float x[kBlockQ / 8][4], xx[kBlockQ / 8][4];
      zero(x);
      zero(xx);
      if (live_tile) {
        const unsigned char* Bs = dv_warp ? Qs : Gs;
        const Kmaj z = kmaj_offsets();
#pragma unroll 1
        for (int p = 0; p < D / kPanel; ++p) {
          const unsigned char* Ap = As + p * kKeys * 128;
          const unsigned char* Bp = Bs + p * kBlockQ * 128;
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const Frag4 a0 = load_a(Ap, 16 * wk, q, z), a1 = load_a(Ap, 16 * wk, q + 1, z);
#pragma unroll
            for (int j = 0; j < kBlockQ / 8; ++j)
              mma3_score(x[j], xx[j], a0, load_b(Bp, 8 * j, q, z), a1,
                         load_b(Bp, 8 * j, q + 1, z));
          }
        }
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] += xx[j][e];
      }
      if (dv_warp) {
        if (live_tile) {
#pragma unroll
          for (int j = 0; j < kBlockQ / 8; ++j) {
            const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = q0 + 8 * j + 2 * t4 + e % 2;
              const bool live = !edge || (col < L && !(causal && col < keys[e / 2]));
              x[j][e] = live ? expf(x[j][e] * scale - (e % 2 ? lz.y : lz.x)) : 0.f;
            }
          }
        }
        named_sync(kBarPEmpty);  // the dK warps have read the last tile's P^T
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p_smem[(4 * j + e) * 128] = x[j][e];
        named_arrive(kBarPFull);
      } else {
        named_sync(kBarPFull);
        if (live_tile) {
#pragma unroll
          for (int j = 0; j < kBlockQ / 8; ++j) {
            const float2 dz = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[j][e] = p_smem[(4 * j + e) * 128] * (x[j][e] - (e % 2 ? dz.y : dz.x));
          }
        }
        if (qt + 1 < num_q) named_arrive(kBarPEmpty);
      }

      // dV += P^T dO (dV warps) or dK += dS^T Q (dK warps), K-steps over the
      // stage's rows in the permuted order
      if (live_tile) {
        const unsigned char* Bs = dv_warp ? Gs : Qs;
        Frag4 xa[kBlockQ / 8];
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) xa[j] = acc_to_a(x[j]);
        const Perm zp = perm_offsets();
        accumulate(acc, xa, [&](int j, int n) { return load_b_perm<kBlockQ>(Bs, 8 * j, n, zp); });
      }
      release(t);
    }

    float* out = dv_warp ? dv : dk;
    const float mul = dv_warp ? 1.f : scale;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = keys[h];
      if (key >= L) continue;
      float* orow = out + (static_cast<size_t>(bh) * L + key) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  } else {
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[n][e] = 0.f;
        dva[n][e] = 0.f;
      }

    mbar_wait(bar_kv, 0);
    for (int qt = first_q, t = 0; qt < num_q; ++qt, ++t) {
      const int s = t % kStages;
      const int q0 = qt * kBlockQ;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      if (!causal || q0 + kBlockQ - 1 >= key_lo) {  // uniform over the warp
        const unsigned char* Qs = smem_raw + (sQ + s * kQBytes - raw);
        const unsigned char* Gs = smem_raw + (sG + s * kQBytes - raw);
        const float* lse_s = rows_smem + s * 2 * kBlockQ;
        const float* delta_s = lse_s + kBlockQ;

        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by the stage's rows
        float st[kBlockQ / 8][4], stx[kBlockQ / 8][4], dpt[kBlockQ / 8][4], dptx[kBlockQ / 8][4];
        zero(st);
        zero(stx);
        zero(dpt);
        zero(dptx);
        const Kmaj z = kmaj_offsets();
#pragma unroll 1
        for (int p = 0; p < D / kPanel; ++p) {
          const unsigned char* Kp = Ks + p * kKeys * 128;
          const unsigned char* Vp = Vs + p * kKeys * 128;
          const unsigned char* Qp = Qs + p * kBlockQ * 128;
          const unsigned char* Gp = Gs + p * kBlockQ * 128;
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const Frag4 ka0 = load_a(Kp, 16 * wk, q, z), ka1 = load_a(Kp, 16 * wk, q + 1, z);
            const Frag4 va0 = load_a(Vp, 16 * wk, q, z), va1 = load_a(Vp, 16 * wk, q + 1, z);
#pragma unroll
            for (int j = 0; j < kBlockQ / 8; ++j) {
              mma3_score(st[j], stx[j], ka0, load_b(Qp, 8 * j, q, z), ka1,
                         load_b(Qp, 8 * j, q + 1, z));
              mma3_score(dpt[j], dptx[j], va0, load_b(Gp, 8 * j, q, z), va1,
                         load_b(Gp, 8 * j, q + 1, z));
            }
          }
        }

        // P^T and dS^T, masked where the tile crosses the diagonal or L
        const bool edge = q0 + kBlockQ > L || (causal && q0 < key_lo + 15);
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
          const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
          const float2 dz = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + 8 * j + 2 * t4 + e % 2;
            const bool live = !edge || (col < L && !(causal && col < keys[e / 2]));
            const float p =
                live ? expf((st[j][e] + stx[j][e]) * scale - (e % 2 ? lz.y : lz.x)) : 0.f;
            dpt[j][e] = p * (dpt[j][e] + dptx[j][e] - (e % 2 ? dz.y : dz.x));
            st[j][e] = p;
          }
        }

        // dV += P^T dO and dK += dS^T Q, K-steps over the stage's rows in the
        // permuted order
        Frag4 pa[kBlockQ / 8], da[kBlockQ / 8];
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
          pa[j] = acc_to_a(st[j]);
          da[j] = acc_to_a(dpt[j]);
        }
        const Perm zp = perm_offsets();
        accumulate(dva, pa, [&](int j, int n) { return load_b_perm<kBlockQ>(Gs, 8 * j, n, zp); });
        accumulate(dka, da, [&](int j, int n) { return load_b_perm<kBlockQ>(Qs, 8 * j, n, zp); });
      }
      release(t);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = keys[h];
      if (key >= L) continue;
      const size_t at = (static_cast<size_t>(bh) * L + key) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(dk + at + 8 * n + 2 * t4) =
            make_float2(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + at + 8 * n + 2 * t4) =
            make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launchers
// ---------------------------------------------------------------------------

// A (B*H, L, D) float32 tensor as a 3-D map (D, L, B*H) read in boxes of one
// 32-float panel, 128-byte swizzled, by `rows` rows of one head; rows past L
// zero-fill
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int L, int D, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(L) * D * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kPanel), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int L, float scale, int causal, cudaStream_t stream) {
  using S = FwdShape<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, S::kRows)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, S::kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, S::kBlockK)) != cudaSuccess) return err;
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_tf32x3_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + S::kRows - 1) / S::kRows);
  kernel<<<grid, S::kWarps * 32, smem, stream>>>(tq, tk, tv, static_cast<float*>(o),
                                                 static_cast<float*>(lse), L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH, int L,
                        float scale, int causal, cudaStream_t stream) {
  using S = KvShape<D>;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, S::kBlockQ)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, S::kKeys)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, S::kKeys)) != cudaSuccess) return err;
  if ((err = make_map(&tg, dout, BH, L, D, S::kBlockQ)) != cudaSuccess) return err;
  constexpr size_t smem = dkdv_smem_bytes<D>();
  auto kernel = flash_dkdv_tf32x3_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + S::kKeys - 1) / S::kKeys);
  kernel<<<grid, S::kWarps * 32, smem, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), L, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int L, float scale,
                      int causal, cudaStream_t stream) {
  using S = DqShape<D>;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err;
  if ((err = make_map(&tq, q, BH, L, D, S::kRows)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, BH, L, D, S::kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, BH, L, D, S::kBlockK)) != cudaSuccess) return err;
  if ((err = make_map(&tg, dout, BH, L, D, S::kRows)) != cudaSuccess) return err;
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_tf32x3_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + S::kRows - 1) / S::kRows);
  kernel<<<grid, S::kWarps * 32, smem, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), L, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_tf32x3
