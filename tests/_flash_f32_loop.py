"""Loop the float32 card-vs-CPU flash check (tests/test_torch_cuda.py::
test_flash_attention_goes_through_the_kernels) many times in one process,
with the caching allocator's free blocks dirtied with NaN between
iterations, and over many seeds; keep every failing entry.

On a card, from the root of a checkout:
    PYTHONPATH=. python tests/_flash_f32_loop.py ITERS SEEDS TAG OUT.json
It prints a JSON summary and writes it, with every failing iteration's
entries, to OUT.json."""
import importlib
import json
import sys
import time

import numpy as np
import torch

tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
N, SEEDS, tag, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
NAMES = ("o", "dq", "dk", "dv")


def inputs(seed):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal((2, 128, 2, 64)).astype(np.float32) for _ in range(4)]


def run(device, arrs):
    q, k, v, do = arrs
    ts = [torch.tensor(x, device=device, requires_grad=True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=True)
    o.backward(torch.tensor(do, device=device))
    return [o.detach().cpu()] + [t.grad.cpu() for t in ts]


def check(got, want):
    res = {}
    for name, g, w in zip(NAMES, got, want):
        top = float(w.abs().max())
        err = (g - w).abs()
        lim = 1e-5 * top + 1e-4 * w.abs()
        bad = err > lim
        res[name] = {"n_off": int(bad.sum()), "max_err": float(err.max()),
                     "max_err_over_limit": float((err / lim).max()),
                     "first_off": bad.nonzero()[:16].tolist()}
    return res


def dirty():
    junk = [torch.full((n,), float("nan"), device="cuda") for n in (32768, 32768, 32768, 512, 1 << 20)]
    del junk


t0 = time.perf_counter()
arrs = inputs(9)
cpu = run("cpu", arrs)
cpu_steady = all(torch.equal(a, b) for a, b in zip(cpu, run("cpu", arrs)))
first, fails, changed = None, [], []
worst = dict.fromkeys(NAMES, 0.0)
for i in range(N):
    if i % 2:
        dirty()
    if i % 10 == 5:
        torch.cuda.empty_cache()
        dirty()
    got = run("cuda", arrs)
    if first is None:
        first = got
    else:
        diff = [n for n, a, b in zip(NAMES, got, first) if not torch.equal(a, b)]
        if diff:
            changed.append({"iter": i, "outputs": diff})
    res = check(got, cpu)
    for n in NAMES:
        worst[n] = max(worst[n], res[n]["max_err_over_limit"])
    if any(r["n_off"] for r in res.values()):
        fails.append({"iter": i, "check": res})
seed_fails, seed_worst = [], dict.fromkeys(NAMES, 0.0)
for s in range(SEEDS):
    a = inputs(1000 + s)
    res = check(run("cuda", a), run("cpu", a))
    for n in NAMES:
        seed_worst[n] = max(seed_worst[n], res[n]["max_err_over_limit"])
    if any(r["n_off"] for r in res.values()):
        seed_fails.append({"seed": 1000 + s, "check": res})
summary = {"tree": tag, "iters": N, "cpu_steady": cpu_steady, "fails": len(fails),
           "changed_bits": len(changed), "worst_err_over_limit": worst, "seeds": SEEDS,
           "seed_fails": len(seed_fails), "seed_worst_err_over_limit": seed_worst,
           "launches": dict(tfa.LAUNCHES), "s": round(time.perf_counter() - t0, 1)}
with open(out, "w") as f:
    json.dump({"summary": summary, "fails": fails, "changed": changed, "seed_fails": seed_fails}, f,
              indent=1)
print(json.dumps(summary))
