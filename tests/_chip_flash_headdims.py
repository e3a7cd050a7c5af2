"""Time the flash kernels F, KV and Q of the package on PYTHONPATH at the
shapes of `PERF.md`'s kernel table on one card, and print one line a case
(`PROBE {...}`: the route each role took, read from the package's
`ROUTE_LAUNCHES`, and its mean ms by CUDA events).

At L 1024, causal, the same work as the table's first row (B*H*D 8192):
bf16 at D 32 (B*H 256), 128 (B*H 64) and 256 (B*H 32), float32 at D 128
(B*H 64), 32 (B*H 256), 64 (B*H 128) and 256 (B*H 32). For each float32
case one more line (`ACC {...}`) gives F's (o, lse), KV's and Q's error
against the plain versions, as max|err| / max|plain| and the count of
entries past the float32 tolerance (rtol 1e-4, atol 1e-5 of max|plain|;
lse's rtol 1e-5, atol 1e-6), at B*H 8 on inputs drawn as the timed ones and
on inputs whose heads are scaled by 1 to 4 (logits up to 16 times as
large); and F's o and lse against a float64 copy of the plain forward
(`o_f64`, `lse_f64`: the kernel's and the plain forward's max|err| /
max|f64|, and the count of the kernel's entries past the float32 tolerance
of the copy). Only the kernel wrappers `_fwd_cuda`, `_dkdv_cuda` and
`_dq_cuda`, the plain versions and the launch counts are called, so the
script times and checks any tree of the port, whichever route it gives a
case: run this file from one tree with PYTHONPATH at the other's root to
measure the other.

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
         (torch.float32, 128, 64), (torch.float32, 32, 256), (torch.float32, 64, 128),
         (torch.float32, 256, 32))
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


def routes(fa, fn):
    """{role: route} of the launches fn() makes."""
    fa.reset_launch_counts()
    fn()
    return {key.split(":")[0]: key.split(":")[1] for key, n in fa.ROUTE_LAUNCHES.items() if n}


def f64_forward(fa, q, k, v, scale):
    """o and lse by the plain forward's arithmetic in float64, causal, over
    the whole sequence at once."""
    s = (q.double() * scale) @ k.double().transpose(1, 2)
    s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1), fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return p @ v.double() / l, m + torch.log(l)


def past(err, want, rtol, atol_frac):
    """Entries of err past rtol * |want| + atol_frac * max|want|."""
    return int((err > atol_frac * float(want.abs().max()) + rtol * want.abs()).sum())


def accuracy(fa, D, head_scales):
    """F's, KV's and Q's error against the plain versions at B*H 8, L 1024,
    causal, float32: {output: (max|err| / max|plain|, entries past the
    float32 tolerance)}, and F's against a float64 copy of the plain
    forward: {"o_f64" / "lse_f64": (the kernel's max|err| / max|f64|, the
    plain forward's, the kernel's entries past the float32 tolerance of
    the copy)}."""
    BH, blk = 8, 128
    gen = torch.Generator(device="cuda").manual_seed(D + head_scales)
    hs = (torch.arange(BH, device="cuda", dtype=torch.float32) % head_scales + 1).view(BH, 1, 1)
    q, k, v, do = (torch.randn((BH, L, D), device="cuda", generator=gen) * hs for _ in range(4))
    scale = D ** -0.5
    o, lse = fa._fwd_plain(q, k, v, scale, True, blk, blk)
    delta = (do * o).sum(-1, keepdim=True)
    got = dict(zip(("o", "lse"), fa._fwd_cuda(q, k, v, scale, True)))
    got.update(zip(("dk", "dv"), fa._dkdv_cuda(q, k, v, do, lse, delta, scale, True)))
    got["dq"] = fa._dq_cuda(q, k, v, do, lse, delta, scale, True)
    want = {"o": o, "lse": lse}
    want.update(zip(("dk", "dv"), fa._dkdv_plain(q, k, v, do, lse, delta, scale, True, blk, blk)))
    want["dq"] = fa._dq_plain(q, k, v, do, lse, delta, scale, True, blk, blk)
    out = {}
    for name, w in want.items():
        err, top = (got[name] - w).abs(), float(w.abs().max())
        tol = (1e-5, 1e-6) if name == "lse" else (1e-4, 1e-5)
        out[name] = (float(err.max()) / top, past(err, w, *tol))
    for name, e in zip(("o", "lse"), f64_forward(fa, q, k, v, scale)):
        kerr, perr = ((t.double() - e).abs() for t in (got[name], want[name]))
        top = float(e.abs().max())
        out[f"{name}_f64"] = (float(kerr.max()) / top, float(perr.max()) / top,
                              past(kerr, e, 1e-4, 1e-5))
    return out


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
        route = {name: routes(fa, fn)[name] for name, fn in calls.items()}
        print("PROBE " + json.dumps({
            "tree": tag, "dtype": str(dtype)[6:], "D": D, "BH": BH, "L": L, "causal": True,
            "route": route, "ms": ms, "card": card, "package": fa.__file__}), flush=True)
        del q, k, v, do, o, lse, delta
        if dtype == torch.float32:
            print("ACC " + json.dumps({
                "tree": tag, "D": D, "route": route,
                "err_over_max_and_count": {f"heads x1..{n}": accuracy(fa, D, n) for n in (1, 4)},
                "card": card}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
