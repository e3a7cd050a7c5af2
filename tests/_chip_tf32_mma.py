"""How one `mma.sync.m16n8k8` with TF32 operands and a float32 accumulator
rounds on the card: the arithmetic that `csrc/flash_tf32x3.cuh` and the
tensor-core emulation in `tests/test_torch_flash_routes.py` build on.

Prints one line a finding (`MMA {...}`):
  * operand: what the mma makes of a float32 operand whose low 13 mantissa
    bits are set (read truncated, or rounded to nearest);
  * sum: 1 + x and 1 - x for x = 2^-22 .. 2^-26, as two products and as
    accumulator plus one product, beside their float32 values rounded to
    nearest;
  * random: 4096 mma of TF32 randn operands, with and without a randn
    accumulator, against the exact sum: the share of results that equal
    the exact sum rounded to nearest, the share no larger in magnitude than
    it (truncation), and the largest error in float32 ulps of the largest
    addend (a product or the accumulator).

Run from the root of a tree, on a machine with a card:
    PYTHONPATH=. python3 tests/_chip_tf32_mma.py
The kernel builds into the package's build directory.
"""

import ctypes
import json
import subprocess

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch.ops import _build

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// P problems: A (P, 16, 8), B (P, 8, 8) as [k][n], C and D (P, 16, 8); a warp each
__global__ void mma_kernel(const float* A, const float* B, const float* C, float* D, int P) {
  const int p = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (p >= P) return;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* a = A + p * 128;
  const float* b = B + p * 64;
  const float* c = C + p * 128;
  float* d = D + p * 128;
  const uint32_t a0 = __float_as_uint(a[g * 8 + t]), a1 = __float_as_uint(a[(g + 8) * 8 + t]);
  const uint32_t a2 = __float_as_uint(a[g * 8 + t + 4]);
  const uint32_t a3 = __float_as_uint(a[(g + 8) * 8 + t + 4]);
  const uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  float d0 = c[g * 8 + 2 * t], d1 = c[g * 8 + 2 * t + 1];
  float d2 = c[(g + 8) * 8 + 2 * t], d3 = c[(g + 8) * 8 + 2 * t + 1];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = d0;
  d[g * 8 + 2 * t + 1] = d1;
  d[(g + 8) * 8 + 2 * t] = d2;
  d[(g + 8) * 8 + 2 * t + 1] = d3;
}
extern "C" int run_mma(const float* A, const float* B, const float* C, float* D, int P) {
  mma_kernel<<<(P + 3) / 4, 128>>>(A, B, C, D, P);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def build():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tf32_mma_probe.cu"
    lib = _build.BUILD_DIR / "libtf32_mma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.run_mma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    return dll


def tf32_nearest(x):
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def main():
    dll = build()

    def mma(A, B, C):
        A, B, C = (torch.tensor(np.asarray(x, np.float32), device="cuda") for x in (A, B, C))
        D = torch.empty_like(C)
        assert dll.run_mma(A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(), A.shape[0]) == 0
        return D.cpu().numpy().astype(np.float64)

    def one(avals, bvals, c=0.0):
        A, B, C = np.zeros((1, 16, 8)), np.zeros((1, 8, 8)), np.zeros((1, 16, 8))
        A[0, 0, :len(avals)], B[0, :len(bvals), 0], C[0, 0, 0] = avals, bvals, c
        return float(mma(A, B, C)[0, 0, 0])

    x = np.float32(1.0 + 2 ** -10 + 2 ** -11 + 2 ** -20)
    print("MMA " + json.dumps({"operand": float(x), "read_as": one([x], [1.0]),
                               "truncated": float(np.float32(1.0 + 2 ** -10)),
                               "nearest": float(tf32_nearest(x))}))
    for k in range(22, 27):
        e = 2.0 ** -k
        print("MMA " + json.dumps({
            "sum": f"1 +- 2^-{k}",
            "products: 1 + x, 1 - x": [one([1.0, e], [1.0, 1.0]) - 1,
                                       one([1.0, -e], [1.0, 1.0]) - 1],
            "accumulator: 1 + x, 1 - x": [one([e], [1.0], 1.0) - 1, one([-e], [1.0], 1.0) - 1],
            "float32 nearest": [float(np.float32(1 + e)) - 1, float(np.float32(1 - e)) - 1]}))
    rng = np.random.default_rng(0)
    for c_scale in (0.0, 8.0):
        A = tf32_nearest(rng.standard_normal((4096, 16, 8))).astype(np.float64)
        B = tf32_nearest(rng.standard_normal((4096, 8, 8))).astype(np.float64)
        C = np.float32(rng.standard_normal((4096, 16, 8)) * c_scale).astype(np.float64)
        D, exact = mma(A, B, C), C + A @ B
        top = np.maximum(np.abs(A[..., None] * B[:, None]).max(2), np.abs(C))
        ulp = 2.0 ** (np.floor(np.log2(top)) - 23)
        print("MMA " + json.dumps({
            "random": f"TF32 randn operands, accumulator randn x {c_scale:g}",
            "equal to nearest": float((D == exact.astype(np.float32)).mean()),
            "no larger than exact": float((np.abs(D) <= np.abs(exact)).mean()),
            "max error, float32 ulps of the largest addend":
                float(np.abs((D - exact) / ulp).max())}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print("MMA " + json.dumps({"card": card}))


if __name__ == "__main__":
    main()
