// Flash attention for Hopper (sm_90a): the forward, the dK/dV and the dQ kernel.
//
// These replace the Pallas TPU kernels of
// pytorch_distributed_example_tpu/ops/flash_attention.py, one kernel per role
// and operand type:
//
//   forward <- _fwd_kernel (:79) and _fwd_kernel_streamed (:207):
//     flash_fwd_wgmma_kernel (bf16, flash_wgmma.cuh), flash_fwd_tf32x3_kernel (float32,
//     flash_tf32x3.cuh)
//   dK/dV   <- _bwd_dkdv_kernel (:306) and _bwd_dkdv_kernel_streamed (:379):
//     flash_dkdv_wgmma_kernel (bf16), flash_dkdv_tf32x3_kernel (float32)
//   dQ      <- _bwd_dq_kernel (:347) and _bwd_dq_kernel_streamed (:432):
//     flash_dq_wgmma_kernel (bf16), flash_dq_tf32x3_kernel (float32)
//
// This file holds the C interface that ops/flash_attention.py loads with
// ctypes; the kernels are in the two headers.
//
// Layout is the reference's: q, k, v, o, dO, dQ, dK, dV are contiguous
// (B*H, L, D); lse and delta are contiguous (B*H, L) float32.
//
// Work split. One block owns one tile of its output ((bh, q-tile) for the
// forward and dQ, (bh, k-tile) for dK/dV) and keeps the tile's accumulators
// in registers. It walks the counterpart tiles through shared memory in a
// loop bounded by the causal diagonal; tiles strictly above the diagonal are
// never visited, and the last q-tiles, which see the most k-tiles, start
// first. The loop inside the block takes the place of the TPU's sequential
// grid axis, so nothing is carried between blocks: no atomics, no scratch.
// Streaming the counterpart tiles covers both Pallas regimes (whole operand
// resident in VMEM, or blocks riding the grid), which is why six Pallas
// kernels become three roles.
//
// Head dims. Instances exist for D = 32, 64, 128 and 256 on both routes; the
// Python wrapper zero-pads any other D <= 256 up to the next one (zero columns
// leave QK^T and the kept output columns unchanged, and it passes the true
// 1/sqrt(D)).
//
// Two designs, routed by ops/flash_attention.py (`kernel_route`) by dtype,
// one instance per (dtype, role, head dim) and no fallback between them:
//
//   wgmma (flash_wgmma.cuh): F, KV and Q for bf16 operands. Products on the
//     tensor cores, bf16 tiles fed by TMA.
//   tf32x3 (flash_tf32x3.cuh): F, KV and Q for float32 operands. Each product
//     as three TF32 passes on the tensor cores (mma.sync.m16n8k8), which keep
//     float32 accuracy; float32 tiles fed by TMA.
//
// Both keep the Pallas numerics: masked logits are -1e30, never -inf, with
// the m_safe guard and the l >= 1e-30 clamp; lse is float32; l sums the
// float32 probabilities. Both scale QK^T after the product, where the Pallas
// forward scales q before it, so that the forward's logits are the ones the
// backward recomputes. The tf32x3 route takes the accurate expf and holds to
// the float32 tolerance. The wgmma route rounds P (forward, dV) and dS (dK,
// dQ) to bf16 as wgmma operands, and takes exp in base 2 on prescaled logits
// (exp2f); its tolerance is declared in ops/flash_attention.py
// (WGMMA_BF16_TOL).
//
// Bound on the H100 (989 TFLOP/s bf16, 495 TF32, 67 float32 off the tensor
// cores, 3.35 TB/s). At the ~1B train step's shapes (BH 64, L 1024, D 128,
// bf16, causal) the forward moves 67 MB and does 1.7e10 FLOPs: about 20 us
// by bytes, 17 us by operations. dK/dV does four products over the triangle
// (3.4e10 FLOPs, 35 us) and dQ three (2.6e10 FLOPs, 26 us), so the backward
// is bound by operations; in the streamed regime (BH 16, L 16384) all three
// are: 1.1, 2.2 and 1.7 ms. In float32 the same products take 0.26 ms (F),
// 0.51 ms (KV) and 0.39 ms (Q) at the 67 TFLOP/s FMA peak, and 0.10, 0.21
// and 0.16 ms at the three-pass ceiling (three TF32 products at 495
// TFLOP/s). Every operand crosses HBM once per visiting tile and the score
// tile never leaves the SM, so what bounds a kernel is how fast it
// multiplies and exponentiates.
//
// The wgmma route: the products are wgmma.mma_async on bf16 tiles (989
// TFLOP/s), one producer warp keeps TMA loads of the next tiles in flight
// behind full/empty mbarriers while two consumer warpgroups compute, and the
// score tile stays in registers: the accumulator fragment of S (or S^T, or
// dS) is, rounded to bf16, exactly the register A operand of the next
// product. dQ runs the forward's shape (Q and dO resident, K and V streamed,
// dQ += dS K with K read MN-major) on 64-key tiles, since S, dP and dQ
// together fill a consumer's registers at 128. At D 256 the forward and dQ
// stream smaller tiles and dK/dV splits dK and dV between the warpgroups
// (flash_wgmma.cuh); at D 32 the same kernels read 64-byte swizzled rows.
// What is left in its way: the exponentials (MUFU, 16 a clock per SM) run
// while the tensor cores idle, as nothing yet overlaps one warpgroup's
// softmax with its own next product, and both warpgroups wait for each
// product to finish before the next step. The tf32x3 kernels keep a
// two-stage TMA ring and the score tile in registers, but have no producer
// warp (thread 0 refills the ring, so that 8 warps get 255 registers a
// thread), and trade wgmma for mma.sync, whose operands come from
// registers: the reason, and what it costs, are at the top of
// flash_tf32x3.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tf32x3.cuh"
#include "flash_wgmma.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

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

// The wgmma route (flash_wgmma.cuh): bf16 operands at every head dim, the
// forward's output bf16 or float32.
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                    int L, int D, float scale, int causal, int dtype, int out_dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (out_dtype == kBF16)
      return flash_wgmma::launch_fwd<__nv_bfloat16, kD>(q, k, v, o, lse, BH, L, scale, causal, st);
    if (out_dtype == kF32)
      return flash_wgmma::launch_fwd<float, kD>(q, k, v, o, lse, BH, L, scale, causal, st);
    return cudaErrorInvalidValue;
  });
}

int flash_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int L, int D,
                     float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    return flash_wgmma::launch_dkdv<decltype(d)::value>(q, k, v, dout, lse, delta, dk, dv, BH, L,
                                                        scale, causal, st);
  });
}

int flash_dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int BH, int L, int D, float scale, int causal,
                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    return flash_wgmma::launch_dq<decltype(d)::value>(q, k, v, dout, lse, delta, dq, BH, L, scale,
                                                      causal, st);
  });
}

// The tf32x3 route (flash_tf32x3.cuh): float32 operands at every head dim,
// the forward's output float32. The same arguments as the wgmma route's.
int flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int L, int D, float scale, int causal, int dtype, int out_dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 || out_dtype != kF32) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    return flash_tf32x3::launch_fwd<decltype(d)::value>(q, k, v, o, lse, BH, L, scale, causal,
                                                        st);
  });
}

int flash_dkdv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int BH, int L,
                      int D, float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    return flash_tf32x3::launch_dkdv<decltype(d)::value>(q, k, v, dout, lse, delta, dk, dv, BH,
                                                         L, scale, causal, st);
  });
}

int flash_dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int BH, int L, int D,
                    float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    return flash_tf32x3::launch_dq<decltype(d)::value>(q, k, v, dout, lse, delta, dq, BH, L,
                                                       scale, causal, st);
  });
}

// Dynamic shared memory a tf32x3 instance asks for at launch (role 0 the
// forward, 1 dK/dV, 2 dQ), in bytes, or -1 for a role or head dim without
// one.
int flash_tf32x3_smem_bytes(int role, int D) {
  size_t bytes = 0;
  const cudaError_t found = by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    switch (role) {
      case 0: bytes = flash_tf32x3::fwd_smem_bytes<kD>(); return cudaSuccess;
      case 1: bytes = flash_tf32x3::dkdv_smem_bytes<kD>(); return cudaSuccess;
      case 2: bytes = flash_tf32x3::dq_smem_bytes<kD>(); return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  });
  return found == cudaSuccess ? static_cast<int>(bytes) : -1;
}

// Dynamic shared memory a wgmma instance asks for at launch (role 0 the
// forward, 1 dK/dV, 2 dQ), in bytes, or -1 for a role or head dim without
// one: ptxas -v reports static shared memory only.
int flash_wgmma_smem_bytes(int role, int D) {
  size_t bytes = 0;
  const cudaError_t found = by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    switch (role) {
      case 0: bytes = flash_wgmma::fwd_smem_bytes<kD>(); return cudaSuccess;
      case 1: bytes = flash_wgmma::dkdv_smem_bytes<kD>(); return cudaSuccess;
      case 2: bytes = flash_wgmma::dq_smem_bytes<kD>(); return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  });
  return found == cudaSuccess ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
