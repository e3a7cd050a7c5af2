"""Time the flash kernels F, KV and Q of the package on PYTHONPATH at the
shapes of `PERF.md`'s kernel table on one card, and print one line a case
(`PROBE {...}`: the route each role took and its mean ms by CUDA events).

At L 1024, causal, the same work as the table's first row (B*H*D 8192):
bf16 at D 32 (B*H 256), 128 (B*H 64) and 256 (B*H 32), float32 at D 128
(B*H 64) and 32 (B*H 256). Only the kernel wrappers `_fwd_cuda`,
`_dkdv_cuda` and `_dq_cuda` and `kernel_route` are called, so the script
times any tree of the port, whichever route it gives a case.

Run from the root of a tree, on a machine with a card:
    PYTHONPATH=. python3 tests/_chip_flash_headdims.py TAG [ITERS]
To compare two trees, unpack one under a gitignored directory and run the
script from each root in one call, in the order A, B, B, A.
"""

import importlib
import json
import subprocess
import sys

import torch

CASES = ((torch.bfloat16, 32, 256), (torch.bfloat16, 128, 64), (torch.bfloat16, 256, 32),
         (torch.float32, 128, 64), (torch.float32, 32, 256))
L = 1024


def time_ms(fn, iters):
    """Mean device time of fn() over `iters` calls after 2 warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(tag: str, iters: int = 20) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for dtype, D, BH in CASES:
        gen = torch.Generator(device="cuda").manual_seed(D)
        q, k, v, do = (torch.randn((BH, L, D), device="cuda", generator=gen, dtype=dtype)
                       for _ in range(4))
        scale = D ** -0.5
        o, lse = fa._fwd_cuda(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        calls = {
            "flash_fwd": lambda: fa._fwd_cuda(q, k, v, scale, True),
            "flash_dkdv": lambda: fa._dkdv_cuda(q, k, v, do, lse, delta, scale, True),
            "flash_dq": lambda: fa._dq_cuda(q, k, v, do, lse, delta, scale, True),
        }
        ms = {name: time_ms(fn, iters) for name, fn in calls.items()}
        print("PROBE " + json.dumps({
            "tree": tag, "dtype": str(dtype)[6:], "D": D, "BH": BH, "L": L, "causal": True,
            "route": fa.kernel_route(dtype, D), "ms": ms, "card": card}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
