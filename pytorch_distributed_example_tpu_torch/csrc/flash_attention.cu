// Flash attention for Hopper (sm_90a): the forward, the dK/dV and the dQ kernel.
//
// These replace the Pallas TPU kernels of
// pytorch_distributed_example_tpu/ops/flash_attention.py, one kernel per role:
//
//   flash_fwd_kernel   <- _fwd_kernel (:79) and _fwd_kernel_streamed (:207)
//   flash_dkdv_kernel  <- _bwd_dkdv_kernel (:306) and _bwd_dkdv_kernel_streamed (:379)
//   flash_dq_kernel    <- _bwd_dq_kernel (:347) and _bwd_dq_kernel_streamed (:432)
//
// with flash_fwd_wgmma_kernel, flash_dkdv_wgmma_kernel and flash_dq_wgmma_kernel
// (flash_wgmma.cuh) as the tensor-core design of all three (see "Two designs"
// below).
//
// Layout is the reference's: q, k, v, o, dO, dQ, dK, dV are contiguous
// (B*H, L, D); lse and delta are contiguous (B*H, L) float32.
//
// Work split. One block owns one TILE-row tile of its output
// ((bh, q-tile) for the forward and dQ, (bh, k-tile) for dK/dV) and keeps the
// tile's accumulators in registers. It walks the counterpart tiles through
// shared memory in a loop bounded by the causal diagonal; tiles strictly above
// the diagonal are never visited. The loop inside the block takes the place of
// the TPU's sequential grid axis, so nothing is carried between blocks: no
// atomics, no scratch. Streaming the counterpart tiles covers both Pallas
// regimes (whole operand resident in VMEM, or blocks riding the grid), which
// is why six Pallas kernels become three.
//
// Thread map (SIMT). Thread (ty, tx) = (tid / 16, tid % 16) owns rows R*ty .. R*ty+R-1
// of the tile (R = TILE/16), score columns tx + 16*j (j < R) and output columns
// tx + 16*c (c < D/16). A row's 16 owners are 16 neighbouring lanes of one
// warp, so a row reduction is four xor shuffles. Shared tiles carry one extra
// 32-bit word per row, so 16 lanes reading 16 rows at one column hit 16 banks.
//
// Head dims (SIMT). Instances exist for D = 32, 64, 128 and 256; the Python wrapper
// zero-pads any other D <= 256 up to the next one (zero columns leave QK^T and
// the kept output columns unchanged, and it passes the true 1/sqrt(D)). TILE is
// 64 rows up to D = 128 and 32 rows at D = 256: four f32 operand tiles of
// 64 x 257 words (263 KB) would not fit the 227 KB of shared memory a block may
// use, and dK/dV's register accumulators (2 * R * D/16 floats a thread) would
// double past what 255 registers hold.
//
// Two designs, routed by ops/flash_attention.py (`kernel_route`), one
// instance per (dtype, head dim) and no fallback between them:
//
//   wgmma (flash_wgmma.cuh): F, KV and Q for bf16 operands at D 64 and 128,
//     the trainer's and the ring's case (CFG_1B is 16 heads of dim 128).
//     Products on the tensor cores, bf16 tiles fed by TMA.
//   SIMT (this file): F, KV and Q for float32 operands and for D 32 and 256.
//     Float32 FMAs on the SIMT cores from bf16 or f32 loads, in the Pallas
//     kernels' order: the forward scales q before QK^T, the backward scales
//     QK^T after.
//
// Both keep the Pallas numerics: masked logits are -1e30, never -inf, with the
// m_safe guard and the l >= 1e-30 clamp; lse is float32; l sums the float32
// probabilities. The wgmma route differs in two places: the forward scales S
// in f32 after the product (rounding q*scale to bf16 would add error), and P
// (forward, dV) and dS (dK, dQ) are rounded to bf16 as wgmma operands. Its
// tolerance is declared in
// ops/flash_attention.py (WGMMA_BF16_TOL). It takes exp in base 2 on prescaled
// logits (exp2f), the SIMT route the accurate expf.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s). At the ~1B train step's
// shapes (BH 64, L 1024, D 128, bf16, causal) the forward moves 67 MB and does
// 1.7e10 FLOPs: about 20 us by bytes, 17 us by operations. dK/dV does four
// products over the triangle (3.4e10 FLOPs, 35 us) and dQ three (2.6e10 FLOPs,
// 26 us), so the backward is bound by operations; in the streamed regime (BH 16,
// L 16384) all three are: 1.1, 2.2 and 1.7 ms. Every operand crosses HBM once
// per visiting tile and the score tile never leaves the SM, so what bounds a
// kernel is how fast it multiplies and exponentiates.
//
// The SIMT route runs its products as f32 FMAs (67 TFLOP/s peak; it reaches
// 21-26) from tiles that all 256 threads load with scalar loads, a barrier
// between load and compute, and the score tile round-tripping through shared
// memory as f32. The wgmma route answers each of those: the products are
// wgmma.mma_async on bf16 tiles (989 TFLOP/s), one producer warp keeps TMA
// loads of the next tiles in flight behind full/empty mbarriers while two
// consumer warpgroups compute, and the score tile stays in registers: the
// accumulator fragment of S (or S^T, or dS) is, rounded to bf16, exactly the
// register A operand of the next product. dQ runs the forward's shape (Q and dO
// resident, K and V streamed, dQ += dS K with K read MN-major) on 64-key
// tiles, since S, dP and dQ together fill a consumer's registers at 128.
// What is left in its way: the exponentials
// (MUFU, 16 a clock per SM) run while the tensor cores idle, as nothing yet
// overlaps one warpgroup's softmax with its own next product, and both
// warpgroups wait for each product to finish before the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr float kNegInf = -1e30f;

// rows of the owned tile and of each streamed tile, by head dim
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D > 128 ? 32 : 64;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row stride, in elements, of a shared (TILE, D) tile of S: D plus one 32-bit word.
template <typename S, int D>
struct Stride {
  static constexpr int value = D + static_cast<int>(4 / sizeof(S));
};

// Max and sum over the 16 lanes that own one row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows row0 .. row0+TILE of a (L, D) slice into a shared tile, times
// `mul`; rows at or past L read as zero.
template <typename T, typename S, int D, int TILE>
__device__ __forceinline__ void load_tile(S* dst, const T* __restrict__ src, int row0, int L,
                                          float mul) {
  constexpr int kStride = Stride<S, D>::value;
  for (int idx = threadIdx.x; idx < TILE * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    const float x = row < L ? to_f32(src[static_cast<size_t>(row) * D + c]) * mul : 0.f;
    dst[r * kStride + c] = from_f32<S>(x);
  }
}

// rows row0 .. row0+TILE of a (L,) float vector; rows at or past L read as zero
template <int TILE>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int L) {
  if (threadIdx.x < TILE) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < L ? src[row] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: o = softmax(q k^T * scale) v, lse = logsumexp of the same logits
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  constexpr int kTile = tile_rows<D>();
  return sizeof(float) * kTile * Stride<float, D>::value     // q, f32, pre-scaled
         + 2 * sizeof(T) * kTile * Stride<T, D>::value       // k, v
         + sizeof(float) * kTile * (kTile + 1);               // p
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 TO* __restrict__ o, float* __restrict__ lse, int L, float scale, int causal) {
  constexpr int kTile = tile_rows<D>();
  constexpr int kRows = kTile / 16;      // tile rows per thread
  constexpr int kCols = kTile / 16;      // score columns per thread
  constexpr int kPStride = kTile + 1;    // row stride of a float score tile
  constexpr int kQS = Stride<float, D>::value;
  constexpr int kKS = Stride<T, D>::value;
  constexpr int kDC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + kTile * kQS);
  T* Vs = Ks + kTile * kKS;
  float* Ps = reinterpret_cast<float*>(Vs + kTile * kKS);

  const int bh = blockIdx.x;
  // the last q-tiles see the most k-tiles under the causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  // q is scaled in f32 before QK^T, as _fwd_kernel does
  load_tile<T, float, D, kTile>(Qs, q + base, q0, L, scale);

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int num_k = (k_end + kTile - 1) / kTile;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps
    load_tile<T, T, D, kTile>(Ks, k + base, k0, L, 1.f);
    load_tile<T, T, D, kTile>(Vs, v + base, k0, L, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = to_f32(Ks[(tx + 16 * j) * kKS + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float m_blk = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= L || (causal && col > row)) s[i][j] = kNegInf;
        m_blk = fmaxf(m_blk, s[i][j]);
      }
      m_blk = row_max(m_blk);
      const float m_new = fmaxf(m[i], m_blk);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_safe);
        Ps[(ty * kRows + i) * kPStride + tx + 16 * j] = p;
        p_sum += p;
      }
      p_sum = row_sum(p_sum);
      const float alpha = expf(m[i] - m_new);  // both -1e30 -> 1, and acc is 0
      l[i] = l[i] * alpha + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kRows], vv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vv[c] = to_f32(Vs[kk * kKS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= L) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      o[base + static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<TO>(acc[i][c] / l_safe);
    if (tx == 0) lse[static_cast<size_t>(bh) * L + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dK/dV for one k-tile, given lse and delta = rowsum(dO*O) - dlse
//   p = exp(q k^T * scale - lse), dV += p^T dO, dK += (p * (dO v^T - delta))^T q * scale
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int kTile = tile_rows<D>();
  return 4 * sizeof(T) * kTile * Stride<T, D>::value   // k, v, q, dO
         + 2 * sizeof(float) * kTile * (kTile + 1)      // p^T, dlogits^T
         + 2 * sizeof(float) * kTile;                   // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L,
                  float scale, int causal) {
  constexpr int kTile = tile_rows<D>();
  constexpr int kRows = kTile / 16;      // tile rows per thread
  constexpr int kCols = kTile / 16;      // score columns per thread
  constexpr int kPStride = kTile + 1;    // row stride of a float score tile
  constexpr int kS = Stride<T, D>::value;
  constexpr int kDC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * kS;
  T* Qs = Vs + kTile * kS;
  T* Gs = Qs + kTile * kS;  // dO
  float* Pt = reinterpret_cast<float*>(Gs + kTile * kS);
  float* St = Pt + kTile * kPStride;  // dlogits^T
  float* lse_s = St + kTile * kPStride;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * L;
  const float* delta_bh = delta + static_cast<size_t>(bh) * L;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, T, D, kTile>(Ks, k + base, k0, L, 1.f);
  load_tile<T, T, D, kTile>(Vs, v + base, k0, L, 1.f);

  float dka[kRows][kDC], dva[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }

  const int num_q = (L + kTile - 1) / kTile;
  // the first q-tile that reaches this k-tile under the causal mask
  const int first_q = causal ? k0 / kTile : 0;
  for (int qt = first_q; qt < num_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done with Qs, Gs, Pt, St
    load_tile<T, T, D, kTile>(Qs, q + base, q0, L, 1.f);
    load_tile<T, T, D, kTile>(Gs, dout + base, q0, L, 1.f);
    load_rows<kTile>(lse_s, lse_bh, q0, L);
    load_rows<kTile>(delta_s, delta_bh, q0, L);
    __syncthreads();

    // transposed tiles: row = this block's k position, column = q position
    float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        st[i][j] = 0.f;
        dpt[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[kCols], gv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = to_f32(Ks[(ty * kRows + i) * kS + d]);
        vv[i] = to_f32(Vs[(ty * kRows + i) * kS + d]);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = to_f32(Qs[(tx + 16 * j) * kS + d]);
        gv[j] = to_f32(Gs[(tx + 16 * j) * kS + d]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int krow = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qc = tx + 16 * j;
        const int qrow = q0 + qc;
        // a masked logit is -1e30, and exp(-1e30 - lse) is 0
        const bool live = qrow < L && !(causal && qrow < krow);
        const float p = live ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        Pt[(ty * kRows + i) * kPStride + qc] = p;
        St[(ty * kRows + i) * kPStride + qc] = p * (dpt[i][j] - delta_s[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[kRows], sv[kRows], gv[kDC], qv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = Pt[(ty * kRows + i) * kPStride + qq];
        sv[i] = St[(ty * kRows + i) * kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        gv[c] = to_f32(Gs[qq * kS + tx + 16 * c]);
        qv[c] = to_f32(Qs[qq * kS + tx + 16 * c]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          dva[i][c] = fmaf(pv[i], gv[c], dva[i][c]);
          dka[i][c] = fmaf(sv[i], qv[c], dka[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int krow = k0 + ty * kRows + i;
    if (krow >= L) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const size_t at = base + static_cast<size_t>(krow) * D + tx + 16 * c;
      dk[at] = from_f32<T>(dka[i][c] * scale);
      dv[at] = from_f32<T>(dva[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for one q-tile, given lse and delta
//   dQ += (p * (dO v^T - delta)) k * scale
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  constexpr int kTile = tile_rows<D>();
  return 4 * sizeof(T) * kTile * Stride<T, D>::value   // q, dO, k, v
         + sizeof(float) * kTile * (kTile + 1)          // dlogits
         + 2 * sizeof(float) * kTile;                   // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int L, float scale,
                int causal) {
  constexpr int kTile = tile_rows<D>();
  constexpr int kRows = kTile / 16;      // tile rows per thread
  constexpr int kCols = kTile / 16;      // score columns per thread
  constexpr int kPStride = kTile + 1;    // row stride of a float score tile
  constexpr int kS = Stride<T, D>::value;
  constexpr int kDC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + kTile * kS;  // dO
  T* Ks = Gs + kTile * kS;
  T* Vs = Ks + kTile * kS;
  float* Ss = reinterpret_cast<float*>(Vs + kTile * kS);  // dlogits
  float* lse_s = Ss + kTile * kPStride;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, T, D, kTile>(Qs, q + base, q0, L, 1.f);
  load_tile<T, T, D, kTile>(Gs, dout + base, q0, L, 1.f);
  load_rows<kTile>(lse_s, lse + static_cast<size_t>(bh) * L, q0, L);
  load_rows<kTile>(delta_s, delta + static_cast<size_t>(bh) * L, q0, L);

  float dqa[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dqa[i][c] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int num_k = (k_end + kTile - 1) / kTile;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ss
    load_tile<T, T, D, kTile>(Ks, k + base, k0, L, 1.f);
    load_tile<T, T, D, kTile>(Vs, v + base, k0, L, 1.f);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], gv[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = to_f32(Qs[(ty * kRows + i) * kS + d]);
        gv[i] = to_f32(Gs[(ty * kRows + i) * kS + d]);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = to_f32(Ks[(tx + 16 * j) * kS + d]);
        vv[j] = to_f32(Vs[(tx + 16 * j) * kS + d]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < L && !(causal && col > row);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        Ss[r * kPStride + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[kRows], kv[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = Ss[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) kv[c] = to_f32(Ks[kk * kS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) dqa[i][c] = fmaf(sv[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      dq[base + static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<T>(dqa[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1 };

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, typename TO, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int L, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  auto kernel = flash_fwd_kernel<T, TO, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + tile_rows<D>() - 1) / tile_rows<D>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<TO*>(o), static_cast<float*>(lse), L, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH, int L,
                        float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<T, D>();
  auto kernel = flash_dkdv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + tile_rows<D>() - 1) / tile_rows<D>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int L, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (L + tile_rows<D>() - 1) / tile_rows<D>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), L, scale, causal);
  return cudaGetLastError();
}

// The SIMT kernels serve bf16 only where the wgmma route does not
// (flash_wgmma.cuh: D 64 and 128).
constexpr bool simt_serves_bf16(int D) { return D != 64 && D != 128; }

// Calls f(std::integral_constant<int, D>) for a head dim that has an instance.
template <typename F>
cudaError_t by_head_dim(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface, loaded with ctypes. Every function returns a cudaError_t:
// cudaSuccess (0), the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for a dtype or head dim that has no instance on that route (the Python
// wrapper pads the head dim, picks the route and rejects the rest before it
// gets here).
extern "C" {

const char* flash_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int L,
              int D, float scale, int causal, int dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (simt_serves_bf16(kD)) {
      if (dtype == kBF16 && out_dtype == kBF16)
        return launch_fwd<__nv_bfloat16, __nv_bfloat16, kD>(q, k, v, o, lse, BH, L, scale, causal, st);
      if (dtype == kBF16 && out_dtype == kF32)
        return launch_fwd<__nv_bfloat16, float, kD>(q, k, v, o, lse, BH, L, scale, causal, st);
    }
    if (dtype == kF32 && out_dtype == kF32)
      return launch_fwd<float, float, kD>(q, k, v, o, lse, BH, L, scale, causal, st);
    return cudaErrorInvalidValue;
  });
}

int flash_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, int D, float scale,
               int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (simt_serves_bf16(kD)) {
      if (dtype == kBF16)
        return launch_dkdv<__nv_bfloat16, kD>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale, causal, st);
    }
    if (dtype == kF32)
      return launch_dkdv<float, kD>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale, causal, st);
    return cudaErrorInvalidValue;
  });
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int BH, int L, int D, float scale, int causal,
             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (simt_serves_bf16(kD)) {
      if (dtype == kBF16)
        return launch_dq<__nv_bfloat16, kD>(q, k, v, dout, lse, delta, dq, BH, L, scale, causal, st);
    }
    if (dtype == kF32)
      return launch_dq<float, kD>(q, k, v, dout, lse, delta, dq, BH, L, scale, causal, st);
    return cudaErrorInvalidValue;
  });
}

// The wgmma route (flash_wgmma.cuh): bf16 operands at D 64 and 128 only, the
// forward's output bf16 or float32. The same arguments as flash_fwd /
// flash_dkdv / flash_dq.
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                    int L, int D, float scale, int causal, int dtype, int out_dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64 && out_dtype == kBF16)
    return flash_wgmma::launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, BH, L, scale, causal, st);
  if (D == 64 && out_dtype == kF32)
    return flash_wgmma::launch_fwd<float, 64>(q, k, v, o, lse, BH, L, scale, causal, st);
  if (D == 128 && out_dtype == kBF16)
    return flash_wgmma::launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, BH, L, scale, causal, st);
  if (D == 128 && out_dtype == kF32)
    return flash_wgmma::launch_fwd<float, 128>(q, k, v, o, lse, BH, L, scale, causal, st);
  return cudaErrorInvalidValue;
}

int flash_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int L, int D,
                     float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64)
    return flash_wgmma::launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale, causal, st);
  if (D == 128)
    return flash_wgmma::launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale, causal, st);
  return cudaErrorInvalidValue;
}

int flash_dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int BH, int L, int D, float scale, int causal,
                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if (D == 64)
    return flash_wgmma::launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, L, scale, causal, st);
  if (D == 128)
    return flash_wgmma::launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, L, scale, causal, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a wgmma instance asks for at launch (role 0 the
// forward, 1 dK/dV, 2 dQ), in bytes, or -1 for a role or head dim without
// one: ptxas -v reports static shared memory only.
int flash_wgmma_smem_bytes(int role, int D) {
  if (D != 64 && D != 128) return -1;
  size_t bytes;
  switch (role) {
    case 0: bytes = D == 64 ? flash_wgmma::fwd_smem_bytes<64>() : flash_wgmma::fwd_smem_bytes<128>(); break;
    case 1: bytes = D == 64 ? flash_wgmma::dkdv_smem_bytes<64>() : flash_wgmma::dkdv_smem_bytes<128>(); break;
    case 2: bytes = D == 64 ? flash_wgmma::dq_smem_bytes<64>() : flash_wgmma::dq_smem_bytes<128>(); break;
    default: return -1;
  }
  return static_cast<int>(bytes);
}

}  // extern "C"
