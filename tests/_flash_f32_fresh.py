"""One fresh process's float32 card-vs-CPU flash check, beside a float64
reference, to tell which side is off when the check fails.

    PYTHONPATH=. python tests/_flash_f32_fresh.py flash   # on a card
    PYTHONPATH=. python tests/_flash_f32_fresh.py exp     # CPU only

`flash` runs the body of tests/test_torch_cuda.py::
test_flash_attention_goes_through_the_kernels (the CPU path first, then
the card), then float64 dense attention on the CPU, and prints one JSON
line: each side's largest error against float64 as a share of the
output's largest entry, and the entries the test's check finds off.
`exp` runs a float32 batched matmul and then the process's first float32
`torch.exp`, and prints that exp's largest relative error against
float64. Run either in a loop of fresh processes: what it looks for
happens in some processes and not in others."""
import importlib
import json
import sys

import numpy as np
import torch

NAMES = ("o", "dq", "dk", "dv")


def flash():
    tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")
    gen = np.random.default_rng(9)
    q, k, v, do = (gen.standard_normal((2, 128, 2, 64)).astype(np.float32) for _ in range(4))
    sides = {}
    for device in ("cpu", "cuda"):
        ts = [torch.tensor(x, device=device, requires_grad=True) for x in (q, k, v)]
        o = tfa.flash_attention(*ts, causal=True)
        o.backward(torch.tensor(do, device=device))
        sides[device] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    ts = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    qq, kk, vv = (t.transpose(1, 2) for t in ts)
    s = (qq @ kk.transpose(-1, -2)) / 8.0
    s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1), float("-inf"))
    o = (s.softmax(-1) @ vv).transpose(1, 2)
    o.backward(torch.tensor(do, dtype=torch.float64))
    truth = [o.detach()] + [t.grad for t in ts]
    out = {"threads": torch.get_num_threads()}
    for device, got in sides.items():
        out[f"{device}_err_vs_f64"] = {
            n: float((g.double() - t).abs().max() / t.abs().max()) for n, g, t in zip(NAMES, got, truth)}
    off = {}
    for n, got, want in zip(NAMES, sides["cuda"], sides["cpu"]):
        top = float(want.abs().max())
        bad = (got - want).abs() > 1e-5 * top + 1e-4 * want.abs()
        if bool(bad.any()):
            off[n] = int(bad.sum())
    out["check_off"] = off
    return out


def exp():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 128, 64, generator=g), torch.randn(4, 64, 128, generator=g)
    a @ b
    x = -torch.rand(4, 128, 128, generator=g) * 30
    p = torch.exp(x)
    r = torch.exp(x.double())
    err = (p.double() - r).abs() / r
    return {"threads": torch.get_num_threads(), "exp_rel_err": float(err.max()),
            "entries_off_1e-6": int((err > 1e-6).sum())}


if __name__ == "__main__":
    print(json.dumps({"flash": flash, "exp": exp}[sys.argv[1]]()))
