"""DDP-MNIST throughput of the port: the reference `bench.py`'s first phase.

`bench_ddp_mnist` mirrors the reference's `_bench_ddp_mnist`
(`bench.py:371-565`): the ConvNet under `DistributedDataParallel` (ZeRO
weight-update sharding at world > 1), SGD with lr 0.01 and momentum 0.5,
dropout on, one fixed batch made from `np.random.default_rng(0)` and kept
on the device (as the reference keeps its batch device-resident), warm-up
steps, then timed windows of steps between two device synchronizations.
The rate reported is the median of the windows after the first, in samples
a second per device: the samples of every rank this process holds on its
one device (all W in driver mode, one in multiproc mode) over the window's
seconds. The result names its device; `main` runs on the card in float32
(TF32 off) and raises without one.

Run on the card:  python -m pytorch_distributed_example_tpu_torch.bench --world-size 8
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import distributed as dist
from . import optim
from .models import ConvNet
from .parallel.ddp import DistributedDataParallel

BATCH_PER_RANK = 64
WARMUP = 20  # steps
STEPS = 200  # a window
WINDOWS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _steady_rate(rates: List[float]) -> float:
    """The median of the windows after the first (the first pays for the
    ramp), as the reference reports."""
    return statistics.median(rates[1:]) if len(rates) > 1 else rates[0]


def bench_ddp_mnist(batch_per_rank: int = BATCH_PER_RANK, warmup: int = WARMUP,
                    steps: int = STEPS, windows: int = WINDOWS, steps_per_call: int = 1) -> dict:
    """Train-step throughput over the default group (initialize it first)."""
    g = dist._get_default_group()
    device, world = g.device, g.size()
    n_local = len(dist._local_rows(g))  # ranks on this process's device
    K = steps_per_call
    if K > 1:  # whole calls of K steps, as the reference rounds them
        steps = (steps // K) * K or K
        warmup = max(warmup // K, 1) * K

    model = ConvNet(device=device, generator=torch.Generator(device=device).manual_seed(0))
    ddp = DistributedDataParallel(model)
    opt = optim.sgd(0.01, momentum=0.5)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=True,
                               **({"steps_per_call": K, "unroll_steps": True} if K > 1 else {}))
    params, opt_state = ddp.params, opt.init(ddp.params)

    gen = np.random.default_rng(0)
    batch = batch_per_rank * world
    x = gen.standard_normal((batch, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, 10, batch).astype(np.int32)
    # this process's ranks' rows, on the device, NCHW
    rows = slice(dist._local_rows(g)[0] * batch_per_rank,
                 (dist._local_rows(g)[-1] + 1) * batch_per_rank)
    x = torch.from_numpy(x[rows]).to(device).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(y[rows]).to(device).long()
    if K > 1:
        x = x.expand((K,) + tuple(x.shape))
        y = y.expand((K,) + tuple(y.shape))

    calls = iter(range(10 ** 9))

    def call():
        nonlocal params, opt_state
        i = next(calls)
        seeds = [i * K + j for j in range(K)] if K > 1 else i
        params, opt_state, loss = step(params, opt_state, x, y, seeds)
        return loss

    for _ in range(warmup // K):
        loss = call()
    _sync(device)
    rates, window_s = [], []
    for _ in range(max(windows, 1)):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps // K):
            loss = call()
        _sync(device)
        dt = time.perf_counter() - t0
        window_s.append(dt)
        rates.append(steps * batch_per_rank * n_local / dt)
    final = loss[-1] if K > 1 else loss
    return {
        "samples_per_s_per_device": _steady_rate(rates),
        "windows": rates,
        "window_s": window_s,
        "world": world,
        "ranks_on_device": n_local,
        "batch_per_rank": batch_per_rank,
        "warmup": warmup,
        "steps": steps,
        "steps_per_call": K,
        "weight_update_sharded": step.weight_update_sharded,
        "final_loss": float(final),
        "memory": step.memory_report(params, opt_state),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--world-size", type=int, default=8,
                   help="ranks stacked on the card (driver mode)")
    p.add_argument("--steps-per-call", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card")
    # float32, as the reference computes: no TF32 in cuDNN's convolutions or the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(world_size=args.world_size)
    try:
        out = bench_ddp_mnist(steps_per_call=args.steps_per_call)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
