"""Post-local SGD's float32 runs on the card and on the CPU, step by step,
beside a float64 run on the CPU; and one vmapped gradient with
replica-batched params (the grouped convolutions of local SGD's rank
`vmap`) on each side against float64, with cuDNN's default and its
deterministic algorithms.

    PYTHONPATH=. python tests/_localsgd_f64.py      # on a card

The DDP-MNIST ConvNet at world 8 x 64 on the fixed batch of the reference
`bench.py`, sgd 0.01 momentum 0.5, period 4, warmup 2, 16 steps (as
chip_smoke.py's `[train_utils]`). Prints each gradient leaf's largest
error as a share of its largest entry, then each step's loss and params
errors: card vs CPU, card vs float64, CPU vs float64."""
import numpy as np
import torch
from torch.func import functional_call, grad, vmap

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.examples import mnist
from pytorch_distributed_example_tpu_torch.models import ConvNet
from pytorch_distributed_example_tpu_torch.utils.cpu_reference import cpu_reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
W, B = 8, 64
gen = np.random.default_rng(0)
X = gen.standard_normal((B * W, 28, 28, 1)).astype(np.float32)
Y = gen.integers(0, 10, B * W).astype(np.int32)


def run(device, dtype=torch.float32, steps=16):
    tdx.init_process_group(world_size=W, device=None if device == "cuda" else device)
    try:
        model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)).to(device, dtype)
        x, y = mnist.to_device(X, Y, device)
        x = x.to(dtype)
        opt = optim.PostLocalSGDOptimizer(optim.sgd(0.01, momentum=0.5),
                                          lambda p, xx: functional_call(model, p, (xx,)),
                                          mnist.loss_fn, period=4, warmup_steps=2)
        p, o = opt.init({n: t.detach() for n, t in model.named_parameters()})
        hist = []
        for _ in range(steps):
            p, o, loss = opt.step(p, o, x, y)
            hist.append((loss.double().cpu(), {n: t.double().cpu() for n, t in p.items()}))
        return hist
    finally:
        tdx.destroy_process_group()


def grads1(device, dtype=torch.float32):
    """One vmapped grad with replica-batched params (grouped convs)."""
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)).to(device, dtype)
    x, y = mnist.to_device(X, Y, device)
    x = x.to(dtype).reshape(W, B, 1, 28, 28)
    y = y.reshape(W, B)
    p = {n: t.detach().unsqueeze(0).expand(W, *t.shape).clone() for n, t in model.named_parameters()}
    g = vmap(grad(lambda pp, xx, yy: mnist.loss_fn(functional_call(model, pp, (xx,)), yy)))(p, x, y)
    return {n: t.double().cpu() for n, t in g.items()}


for det in (False, True):
    torch.backends.cudnn.deterministic = det
    gc, gf = grads1("cuda"), None
    with cpu_reference():
        gf = grads1("cpu")
    g64 = grads1("cpu", torch.float64)
    for n in g64:
        top = float(g64[n].abs().max())
        print(f"det={det} grad {n}: card {float((gc[n] - g64[n]).abs().max()) / top:.3e} "
              f"cpu {float((gf[n] - g64[n]).abs().max()) / top:.3e} of max")
torch.backends.cudnn.deterministic = False
card = run("cuda")
with cpu_reference():
    cpu = run("cpu")
f64 = run("cpu", torch.float64)
for i, ((lc, pc), (lf, pf), (l6, p6)) in enumerate(zip(card, cpu, f64)):
    def rel(a, b):
        return max(float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b)
    print(f"step {i + 1}: loss card/cpu {float(((lc - lf).abs() / lf.abs()).max()):.2e} "
          f"card/f64 {float(((lc - l6).abs() / l6.abs()).max()):.2e} cpu/f64 "
          f"{float(((lf - l6).abs() / l6.abs()).max()):.2e}; params card/cpu {rel(pc, pf):.2e} "
          f"card/f64 {rel(pc, p6):.2e} cpu/f64 {rel(pf, p6):.2e}")
