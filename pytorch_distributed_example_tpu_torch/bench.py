"""DDP throughput of the port: DDP-MNIST (the reference `bench.py`'s first
phase), and the BASELINE's ResNet-18/CIFAR-10 and BERT-base fine-tune
workloads (the reference's `benchmarks/resnet_ddp.py` and
`benchmarks/bert_finetune.py`).

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

`bench_resnet_ddp`: ResNet-18 with SyncBatchNorm through
`examples/cifar.py`'s train step, SGD 0.1 with momentum 0.9, batch 128 a
rank, one fixed batch from `np.random.default_rng(0)` (the reference's),
float32 or bfloat16. `bench_bert_finetune`: BERT for sequence
classification (the "base" preset: vocab 30522, d 768, 12 layers, 12
heads, d_ff 3072) under `DistributedDataParallel` with `adamw(2e-5)` and
dropout 0.1 on, batch 16 a rank at seq 128; it also reports tokens a
second per device, and takes any comm hook. Both time windows as
`bench_ddp_mnist` does, and run in driver mode at world 8 from `main`.

Run on the card:  python -m pytorch_distributed_example_tpu_torch.bench --world-size 8
                  [--workload resnet|bert] [--bf16]
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
from .models import BertConfig, BertForSequenceClassification, ConvNet
from .parallel.ddp import DistributedDataParallel

BATCH_PER_RANK = 64
WARMUP = 20  # steps
STEPS = 200  # a window
WINDOWS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steady_rate(rates: List[float]) -> float:
    """The median of the windows after the first (the first pays for the
    ramp), as the reference reports."""
    return statistics.median(rates[1:]) if len(rates) > 1 else rates[0]


def timed_windows(call, device, warmup: int, steps: int, windows: int, samples: int):
    """Warm-up calls, then `windows` timed windows of `steps` calls between
    device synchronizations, `samples` a call: (rates in samples a second,
    window seconds, the last call's result)."""
    out = None
    for _ in range(warmup):
        out = call()
    _sync(device)
    rates, window_s = [], []
    for _ in range(max(windows, 1)):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = call()
        _sync(device)
        dt = time.perf_counter() - t0
        window_s.append(dt)
        rates.append(steps * samples / dt)
    return rates, window_s, out


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


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

    rates, window_s, loss = timed_windows(call, device, warmup // K, steps // K, windows,
                                     K * batch_per_rank * n_local)
    final = loss[-1] if K > 1 else loss
    return {
        "samples_per_s_per_device": steady_rate(rates),
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
        "device": _device_name(device),
    }


RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 128, 10, 50
BERT_PRESETS = {
    "small": dict(vocab_size=30522, d_model=256, n_layers=4, n_heads=8, d_ff=1024),
    "base": dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12, d_ff=3072),
}
BERT_BATCH, BERT_SEQ, BERT_WARMUP, BERT_STEPS = 16, 128, 5, 30


def resnet_ddp_call(batch_per_rank: int = RESNET_BATCH, dtype: torch.dtype = torch.float32,
                    model=None):
    """The ResNet bench's set-up over the default group: (call, samples a
    call on this device); `call()` runs one train step on the fixed batch
    and returns its loss. `model` replaces ResNet-18 with SyncBatchNorm."""
    from .examples import cifar

    g = dist._get_default_group()
    device, world = g.device, g.size()
    ranks = dist._local_rows(g)
    model = cifar.build(device, dtype) if model is None else model
    params, stats = model.params_and_stats()
    opt = optim.sgd(0.1, momentum=0.9)
    opt_state = opt.init(params)
    step = cifar.make_train_step(model, opt, g)
    gen = np.random.default_rng(0)
    gb = batch_per_rank * world
    x = gen.standard_normal((gb, 32, 32, 3))
    y = gen.integers(0, 10, gb)
    rows = slice(ranks[0] * batch_per_rank, (ranks[-1] + 1) * batch_per_rank)
    x = torch.from_numpy(x[rows]).to(device, dtype)
    y = torch.from_numpy(y[rows]).to(device).long()

    def call():
        nonlocal params, stats, opt_state
        params, stats, opt_state, loss = step(params, stats, opt_state, x, y)
        return loss

    return call, batch_per_rank * len(ranks)


def bench_resnet_ddp(batch_per_rank: int = RESNET_BATCH, warmup: int = RESNET_WARMUP,
                     steps: int = RESNET_STEPS, windows: int = WINDOWS,
                     dtype: torch.dtype = torch.float32, model=None) -> dict:
    """ResNet-18/CIFAR-10 DDP train-step throughput over the default group
    (initialize it first): `examples/cifar.py`'s step with SyncBatchNorm."""
    g = dist._get_default_group()
    call, samples = resnet_ddp_call(batch_per_rank, dtype, model)
    rates, window_s, loss = timed_windows(call, g.device, warmup, steps, windows, samples)
    return {
        "samples_per_s_per_device": steady_rate(rates),
        "windows": rates,
        "window_s": window_s,
        "world": g.size(),
        "ranks_on_device": len(dist._local_rows(g)),
        "batch_per_rank": batch_per_rank,
        "dtype": str(dtype).replace("torch.", ""),
        "final_loss": float(loss),
        "device": _device_name(g.device),
    }


def bert_finetune_call(preset: str = "base", batch_per_rank: int = BERT_BATCH,
                       seq: int = BERT_SEQ, dtype: torch.dtype = torch.float32,
                       comm_hook=None, preset_overrides: Optional[dict] = None):
    """The BERT bench's set-up over the default group: (call, samples a
    call on this device, the train step); `call()` runs one step on the
    fixed batch (its own dropout seed each call) and returns its loss."""
    g = dist._get_default_group()
    device, world = g.device, g.size()
    ranks = dist._local_rows(g)
    cfg = BertConfig(max_seq_len=seq, dtype=dtype, dropout=0.1,
                     **{**BERT_PRESETS[preset], **(preset_overrides or {})})
    model = BertForSequenceClassification(cfg, num_labels=2, device="cpu",
                                          generator=torch.Generator().manual_seed(0)).to(device)
    ddp = DistributedDataParallel(model)
    if comm_hook is not None:
        ddp.register_comm_hook(None, comm_hook)
    opt = optim.adamw(2e-5)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=True)
    params, opt_state = ddp.params, opt.init(ddp.params)
    hook_state = step.init_hook_state(params) if hasattr(step, "init_hook_state") else None
    gen = np.random.default_rng(0)
    gb = batch_per_rank * world
    x = gen.integers(0, cfg.vocab_size, (gb, seq))
    y = gen.integers(0, 2, gb)
    rows = slice(ranks[0] * batch_per_rank, (ranks[-1] + 1) * batch_per_rank)
    x = torch.from_numpy(x[rows]).to(device)
    y = torch.from_numpy(y[rows]).to(device)
    calls = iter(range(10 ** 9))

    def call():
        nonlocal params, opt_state, hook_state
        i = next(calls)
        if hook_state is not None:
            params, opt_state, hook_state, loss = step(params, opt_state, hook_state, x, y, i)
        else:
            params, opt_state, loss = step(params, opt_state, x, y, i)
        call.params, call.opt_state = params, opt_state
        return loss

    return call, batch_per_rank * len(ranks), step


def bench_bert_finetune(preset: str = "base", batch_per_rank: int = BERT_BATCH,
                        seq: int = BERT_SEQ, warmup: int = BERT_WARMUP, steps: int = BERT_STEPS,
                        windows: int = WINDOWS, dtype: torch.dtype = torch.float32,
                        comm_hook=None, preset_overrides: Optional[dict] = None) -> dict:
    """BERT fine-tune DDP train-step throughput over the default group
    (initialize it first): `DistributedDataParallel.make_train_step(
    adamw(2e-5), has_rng=True)`, dropout 0.1, with `comm_hook` if given
    (a stateful hook's state is carried)."""
    g = dist._get_default_group()
    call, samples, step = bert_finetune_call(preset, batch_per_rank, seq, dtype, comm_hook,
                                             preset_overrides)
    rates, window_s, loss = timed_windows(call, g.device, warmup, steps, windows, samples)
    rate = steady_rate(rates)
    return {
        "samples_per_s_per_device": rate,
        "tokens_per_s_per_device": rate * seq,
        "windows": rates,
        "window_s": window_s,
        "world": g.size(),
        "ranks_on_device": len(dist._local_rows(g)),
        "preset": preset,
        "batch_per_rank": batch_per_rank,
        "seq": seq,
        "dtype": str(dtype).replace("torch.", ""),
        "hook": getattr(comm_hook, "__name__", type(comm_hook).__name__) if comm_hook else None,
        "weight_update_sharded": step.weight_update_sharded,
        "final_loss": float(loss),
        "memory": step.memory_report(call.params, call.opt_state),
        "device": _device_name(g.device),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--world-size", type=int, default=8,
                   help="ranks stacked on the card (driver mode)")
    p.add_argument("--steps-per-call", type=int, default=1)
    p.add_argument("--workload", choices=["mnist", "resnet", "bert"], default="mnist")
    p.add_argument("--bf16", action="store_true", help="resnet and bert: bfloat16 compute")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card")
    # float32, as the reference computes: no TF32 in cuDNN's convolutions or the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(world_size=args.world_size)
    try:
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        if args.workload == "resnet":
            out = bench_resnet_ddp(dtype=dtype)
        elif args.workload == "bert":
            out = bench_bert_finetune(dtype=dtype)
        else:
            out = bench_ddp_mnist(steps_per_call=args.steps_per_call)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
