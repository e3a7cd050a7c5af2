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

`bench_transformer_mfu` mirrors the reference's `_bench_mfu`
(`bench.py:568-733`): the single-card TransformerLM bf16 train step (vocab
32000, d 512, 8 layers, 8 heads of 64, L 512, B 8, AdamW 1e-3 with optax's
defaults) through `examples/lm.py`'s `train_step`, its analytic model FLOPs
over the card's peak (`calibrated_peak`: the spec sheet's dense bf16 rate,
or a chain of bf16 products where that is higher). Its attention runs the
bf16 D 64 wgmma kernels, F, KV and Q eight times each a step. Where it
parts from the reference, on purpose:
* no dense fallback: a failure of the flash path raises;
* hfu counts the products `FlopCounterMode` sees in one extra, untimed
  step (the flash kernels launch outside aten and are not counted; nor is
  elementwise work, which XLA's cost analysis counts);
* `flash_block_q` / `flash_block_k` are the tiles the CUDA kernels use
  (their own, whatever `resolved_block_sizes` says); on the CPU, the plain
  versions' blocks;
* `steps_per_call` K runs K eager steps a timed call (one program of K
  steps on the TPU).

`main` with no `--workload` prints the reference's one-line report: the
DDP-MNIST rate at `--world-size` (driver mode) with `vs_baseline` against
`benchmarks/baseline_measured.json`, then the MFU phase's keys. It reads
the reference's variables (BENCH_MFU_BATCH, BENCH_MFU_SEQ,
BENCH_MFU_WARMUP, BENCH_MFU_STEPS, BENCH_MFU_SCAN, BENCH_BREAKDOWN,
BENCH_TRACE) and nothing below it reads the environment. A failed phase
prints the partial line with `error` and `phase` and exits 1 (the
reference writes mfu 0 and exits 0).

Run on the card:  python -m pytorch_distributed_example_tpu_torch.bench [--world-size 8]
                  python -m pytorch_distributed_example_tpu_torch.bench --workload mfu
                  python -m pytorch_distributed_example_tpu_torch.bench --world-size 8
                  --workload mnist|resnet|bert [--bf16]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import distributed as dist
from . import optim
from .examples import lm
from .models import (BertConfig, BertForSequenceClassification, ConvNet, TransformerConfig,
                     TransformerLM)
from .ops.flash_attention import (ROUTE_LAUNCHES, _kernel_tile, kernel_head_dim, kernel_route,
                                  resolved_block_sizes)
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


class maybe_trace:
    """`torch.profiler.profile` of the host and, where there is one, the
    card around the block, its Chrome trace exported into `trace_dir`
    (made if missing) on exit; nothing at all when `trace_dir` is None
    (`main` passes BENCH_TRACE)."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.dir = trace_dir or None
        self._prof = None

    def __enter__(self):
        if self.dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.dir, f"bench_{os.getpid()}_{time.time_ns()}.json"))
        return False


def timed_windows(call, device, warmup: int, steps: int, windows: int, samples: int,
                  trace_dir: Optional[str] = None):
    """Warm-up calls, then `windows` timed windows of `steps` calls between
    device synchronizations, `samples` a call: (rates in samples a second,
    window seconds, the last call's result). With `trace_dir`, the windows
    run under `maybe_trace`."""
    out = None
    for _ in range(warmup):
        out = call()
    _sync(device)
    rates, window_s = [], []
    with maybe_trace(trace_dir):
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


# Dense bf16 rates of the card from its spec sheet, keyed by a substring of
# torch.cuda.get_device_name(), most specific first
PEAK_BF16 = [
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
]


def peak_flops(device_name: str) -> float:
    """The spec sheet's dense bf16 FLOP/s of the card named `device_name`;
    0.0 for a name the table does not know."""
    name = device_name.lower()
    for key, peak in PEAK_BF16:
        if key.lower() in name:
            return peak
    return 0.0


_CALIBRATION_CACHE: dict = {}


def calibrated_peak(device=None, n: int = 4096, reps: int = 100):
    """(peak FLOP/s, meta): the MFU denominator, max(the spec sheet's rate,
    a measured one). The measurement is a chain of `reps` dependent bf16
    n x n products, each scaled by 1/sqrt(n) (folded into the right-hand
    factor once, so the chain stays at unit scale and only products run),
    reduced to one float32 scalar on the device; four cycles, each between
    a synchronization and the scalar's readback, the fastest kept. Any rate
    observed is a lower bound on the peak. `meta` holds `peak_source`
    ("spec_sheet", or "calibrated_matmul_lower_bound" where the measured
    rate wins), `nominal_peak_tflops`, `measured_matmul_tflops` or
    `calibration_error`. Cached by the device's name; the card by
    default."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    name = _device_name(device)
    if name in _CALIBRATION_CACHE:
        return _CALIBRATION_CACHE[name]
    nominal = peak_flops(name)
    meta = {"peak_source": "spec_sheet", "nominal_peak_tflops": nominal / 1e12}
    measured = 0.0
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        a, b = (torch.randn((n, n), generator=gen, device=device, dtype=torch.bfloat16)
                for _ in range(2))
        b = b * (1.0 / math.sqrt(n))

        def chain() -> float:
            c = a
            for _ in range(reps):
                c = c @ b
            return float(c.float().sum())

        chain()  # the first call pays for the library's set-up
        for _ in range(4):
            _sync(device)
            t0 = time.perf_counter()
            chain()
            measured = max(measured, 2 * n ** 3 * reps / (time.perf_counter() - t0))
        meta["measured_matmul_tflops"] = round(measured / 1e12, 1)
    except Exception as e:  # the spec sheet's rate stands alone
        meta["calibration_error"] = f"{type(e).__name__}: {str(e)[:120]}"
    if measured > nominal:
        meta["peak_source"] = "calibrated_matmul_lower_bound"
    _CALIBRATION_CACHE[name] = (max(nominal, measured), meta)
    return _CALIBRATION_CACHE[name]


def bench_ddp_mnist(batch_per_rank: int = BATCH_PER_RANK, warmup: int = WARMUP,
                    steps: int = STEPS, windows: int = WINDOWS, steps_per_call: int = 1,
                    trace_dir: Optional[str] = None) -> dict:
    """Train-step throughput over the default group (initialize it first).
    With `trace_dir`, the timed windows are profiled into it (`maybe_trace`)."""
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
                                          K * batch_per_rank * n_local, trace_dir)
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


# the reference's MFU model (`bench.py:600-609`): head dim 64, d_ff 1408,
# 58,466,816 params; its batch, length, warm-up and timed steps
MFU_MODEL = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8)
MFU_BATCH, MFU_SEQ, MFU_WARMUP, MFU_STEPS = 8, 512, 5, 30
MFU_LR = 1e-3
HFU_NOTE = ("FlopCounterMode counts aten's matrix products: the flash kernels launch "
            "outside aten and are not counted, nor is elementwise work")


def mfu_loss(model, tokens):
    """THE loss of the MFU step, shared by the timed step and the
    breakdown: `examples/lm.py`'s `loss_fn` (the one `lm.train_step` takes)
    of the model's logits."""
    return lm.loss_fn(model(tokens), tokens)


def mfu_config(seq: int = MFU_SEQ, model_overrides: Optional[dict] = None) -> TransformerConfig:
    """The MFU model: `MFU_MODEL` at max_seq_len `seq`, bf16 compute, flash
    attention, any field replaced by `model_overrides`."""
    return TransformerConfig(**{**MFU_MODEL, "max_seq_len": seq, "dtype": torch.bfloat16,
                                "use_flash": True, **(model_overrides or {})})


def mfu_setup(device, batch: int = MFU_BATCH, seq: int = MFU_SEQ,
              model_overrides: Optional[dict] = None):
    """(model, optimizer, tokens) of the MFU step: `mfu_config`'s model,
    its weights from a generator seeded 0 on `device`; `lm.adamw(1e-3)`;
    one fixed batch of (batch, seq) tokens from np.random.default_rng(0),
    on the device."""
    cfg = mfu_config(seq, model_overrides)
    model = TransformerLM(cfg, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    opt = lm.make_optimizer(model, MFU_LR)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq))
    return model, opt, torch.from_numpy(tokens).to(device)


def model_flops_per_step(n_params: int, cfg: TransformerConfig, batch: int, seq: int) -> float:
    """The reference's analytic model FLOPs of a train step (the PaLM form:
    6N a token for the forward and backward, plus attention's scores)."""
    return (6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * seq) * batch * seq


def _flash_tiles(cfg: TransformerConfig, seq: int, device: torch.device):
    """(block_q, block_k) the attention really runs at: on the card the
    kernels' own tiles (the forward's query rows, dK/dV's key rows), on the
    CPU the plain versions' blocks."""
    if device.type != "cuda":
        return resolved_block_sizes(seq)
    Dp = kernel_head_dim(cfg.head_dim)
    return tuple(_kernel_tile(role, Dp, kernel_route(cfg.dtype, cfg.head_dim, role))
                 for role in ("flash_fwd", "flash_dkdv"))


def mfu_breakdown(model, tokens, steps: int, step_s: float) -> dict:
    """{fwd, fwd_bwd, full_step} average ms: the forward under no_grad, the
    loss and its backward (gradients dropped after each), each over `steps`
    calls between synchronizations, beside the timed step's `step_s`."""
    device = tokens.device

    def fwd():
        with torch.no_grad():
            return model(tokens)

    def fwd_bwd():
        loss = mfu_loss(model, tokens)
        loss.backward()
        model.zero_grad(set_to_none=True)
        return loss.detach()

    out = {"full_step": step_s * 1e3}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(device)
        out[name] = (time.perf_counter() - t0) / steps * 1e3
    return out


def bench_transformer_mfu(device=None, batch: int = MFU_BATCH, seq: int = MFU_SEQ,
                          warmup: int = MFU_WARMUP, steps: int = MFU_STEPS,
                          steps_per_call: int = 1, breakdown: bool = False,
                          peak: Optional[float] = None,
                          model_overrides: Optional[dict] = None) -> dict:
    """The TransformerLM bf16 train step's MFU on one device (`mfu_setup`,
    `lm.train_step`): warm-up steps, one counted step (its flash launches by
    role and route), one untimed step under FlopCounterMode (hfu), then
    `steps // K` timed calls of K steps each, the clock stopped on a
    readback of the last loss. The card by default, which raises without
    one; the CPU only with an explicit `peak` (FLOP/s). Nothing falls back
    to dense attention: a failure raises. With `breakdown`, `mfu_breakdown`
    (its failure lands in `breakdown_error`)."""
    from torch.utils.flop_counter import FlopCounterMode

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the MFU phase measures the card")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if peak is None:
        if device.type != "cuda":
            raise ValueError(f"no peak rate for {device}: pass peak=")
        peak, peak_meta = calibrated_peak(device)
        if not peak:
            raise RuntimeError(f"no peak rate for {_device_name(device)}")
    else:
        peak_meta = {"peak_source": "caller", "nominal_peak_tflops": peak / 1e12}
    K = max(steps_per_call, 1)
    steps = max(steps // K, 1) * K

    model, opt, tokens = mfu_setup(device, batch, seq, model_overrides)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    flops = model_flops_per_step(n_params, cfg, batch, seq)

    def call():
        for _ in range(K):
            loss = lm.train_step(model, opt, tokens)
        return loss

    for _ in range(max(warmup // K, 1)):
        loss = call()
    float(loss)
    before = dict(ROUTE_LAUNCHES)  # the counts stay the caller's: a difference, no reset
    float(lm.train_step(model, opt, tokens))
    launches = {k: ROUTE_LAUNCHES[k] - before[k] for k in ROUTE_LAUNCHES}
    with FlopCounterMode(display=False) as counter:
        loss = lm.train_step(model, opt, tokens)
    hw_flops = counter.get_total_flops()

    float(loss)  # readback barrier
    t0 = time.perf_counter()
    for _ in range(steps // K):
        loss = call()
    final_loss = float(loss)
    dt = time.perf_counter() - t0

    achieved = flops * steps / dt
    block_q, block_k = _flash_tiles(cfg, seq, device)
    out = {
        "mfu": achieved / peak,
        "mfu_tflops": achieved / 1e12,
        "hfu": hw_flops * steps / dt / peak,
        "flash_used": cfg.use_flash,
        "flash_block_q": block_q,
        "flash_block_k": block_k,
        "peak_calibration": peak_meta,
        "mfu_final_loss": final_loss,
        "timing": "readback_barrier",
        "hfu_note": HFU_NOTE,
        "flash_launches": launches,
        "n_params": n_params,
        "model_flops_per_step": flops,
        "step_ms": dt / steps * 1e3,
        "device": _device_name(device),
    }
    if K > 1:
        out["mfu_steps_per_dispatch"] = K
    if breakdown:  # diagnostic only: it never costs the measured headline
        try:
            out["breakdown_ms"] = mfu_breakdown(model, tokens, steps, dt / steps)
        except Exception as e:
            out["breakdown_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


METRIC, UNIT = "ddp_mnist_samples_per_sec_per_chip", "samples/s/chip"
BASELINE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "benchmarks", "baseline_measured.json")
# the DDP-MNIST run's keys in the line, as the reference's per-step run meta
MNIST_META = ("warmup", "steps", "windows", "final_loss", "memory")


def _mnist_part(mnist: dict) -> dict:
    """The line's DDP-MNIST part: the rate per card and the run's meta."""
    device = mnist["device"]
    return {
        "metric": METRIC,
        "value": round(mnist["samples_per_s_per_device"], 1),
        "unit": UNIT,
        "world": mnist["world"],
        **{k: mnist[k] for k in MNIST_META},
        "reported": "median_after_ramp" if len(mnist["windows"]) > 1
                    else "single_window_with_ramp",
        "timing": "device_synchronize",
        "dispatch_mode": "per_step",
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "platform": "cpu" if device == "cpu" else "gpu",
        "device_kind": device,
    }


def headline_line(mnist: Optional[dict], mfu: Optional[dict], baseline_path: str,
                  fused: Optional[dict] = None, error: Optional[str] = None,
                  phase: Optional[str] = None) -> dict:
    """The reference's one-line report: DDP-MNIST's rate and meta,
    `vs_baseline` against `samples_per_sec_per_chip` in `baseline_path`
    (read only), the fused-steps row where `fused` ran, then the MFU phase's
    keys. With `error`, the partial line of the phases that ran, with
    `error` and `phase`."""
    line = _mnist_part(mnist) if mnist else {"metric": METRIC, "value": 0, "unit": UNIT}
    vs = 0.0
    if mnist and os.path.exists(baseline_path):
        with open(baseline_path) as f:
            ref = json.load(f).get("samples_per_sec_per_chip") or 0
        if ref:
            vs = mnist["samples_per_s_per_device"] / ref
    line["vs_baseline"] = round(vs, 3)
    if mfu:
        line.update(mfu=round(mfu["mfu"], 4), mfu_tflops=round(mfu["mfu_tflops"], 2),
                    hfu=round(mfu["hfu"], 4))
    if fused:
        line["fused_steps_samples_per_sec_per_chip"] = round(fused["samples_per_s_per_device"], 1)
        line["fused_steps_meta"] = {
            "steps_per_dispatch": fused["steps_per_call"],
            "steps_unrolled": True,
            "windows": fused["windows"],
            "reported": "median_after_ramp" if len(fused["windows"]) > 1
                        else "single_window_with_ramp",
        }
    if mfu:
        line.update({k: v for k, v in mfu.items() if k not in ("mfu", "mfu_tflops", "hfu")})
    if error:
        line.update(error=error, phase=phase)
    return line


class HeadlineError(RuntimeError):
    """A phase of the headline failed: `line` is the partial line, with
    `error` and `phase`."""

    def __init__(self, line: dict):
        super().__init__(f"{line['phase']}: {line['error']}")
        self.line = line


def run_headline(world_size: int = 8, steps_per_call: int = 1, mnist_kw: Optional[dict] = None,
                 mfu_kw: Optional[dict] = None, baseline_path: str = BASELINE_PATH,
                 device=None, trace_dir: Optional[str] = None) -> dict:
    """Both phases, as the reference's `main` runs them: DDP-MNIST at
    `world_size` in driver mode (per step; with `steps_per_call` > 1 also
    the fused row), its group destroyed, then the MFU phase on one device.
    Returns the line; raises `HeadlineError` with the partial line when a
    phase fails."""
    mnist = fused = None
    phase = "init_process_group"
    try:
        dist.init_process_group(world_size=world_size, device=device)
        try:
            phase = "ddp_mnist"
            mnist = bench_ddp_mnist(**(mnist_kw or {}), trace_dir=trace_dir)
            if steps_per_call > 1:
                phase = "ddp_mnist_fused"
                fused = bench_ddp_mnist(**(mnist_kw or {}), steps_per_call=steps_per_call)
        finally:
            dist.destroy_process_group()
        phase = "mfu"
        mfu = bench_transformer_mfu(device=device, **(mfu_kw or {}))
    except Exception as e:
        raise HeadlineError(headline_line(mnist, None, baseline_path, fused,
                                          error=f"{type(e).__name__}: {e}", phase=phase)) from e
    return headline_line(mnist, mfu, baseline_path, fused)


def _env_kwargs(env, names: dict) -> dict:
    """{kwarg: int(env[var])} for each variable of `names` ({var: kwarg}) that is set."""
    return {kw: int(env[var]) for var, kw in names.items() if env.get(var)}


def main(argv: Optional[List[str]] = None) -> dict:
    """The bench on the card: with no `--workload` the reference's one-line
    report of both phases (exit 1 after the partial line if a phase
    failed), `--workload mfu` the MFU phase alone, `--workload
    mnist|resnet|bert` that DDP workload alone. Prints the result as one
    JSON line and returns it."""
    p = argparse.ArgumentParser()
    p.add_argument("--world-size", type=int, default=8,
                   help="ranks stacked on the card (driver mode)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="DDP-MNIST: above 1, also the fused-steps row (or the mnist workload's K)")
    p.add_argument("--workload", choices=["mnist", "resnet", "bert", "mfu"], default=None,
                   help="one workload alone; none: both phases of the reference's report")
    p.add_argument("--bf16", action="store_true", help="resnet and bert: bfloat16 compute")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card")
    env = os.environ
    mfu_kw = _env_kwargs(env, {"BENCH_MFU_BATCH": "batch", "BENCH_MFU_SEQ": "seq",
                               "BENCH_MFU_WARMUP": "warmup", "BENCH_MFU_STEPS": "steps",
                               "BENCH_MFU_SCAN": "steps_per_call"})
    mfu_kw["breakdown"] = bool(env.get("BENCH_BREAKDOWN"))
    trace_dir = env.get("BENCH_TRACE") or None
    # float32, as the reference computes: no TF32 in cuDNN's convolutions or the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.workload is None:
        try:
            out = run_headline(args.world_size, args.steps_per_call, mfu_kw=mfu_kw,
                               trace_dir=trace_dir)
        except HeadlineError as e:
            print(json.dumps(e.line))
            raise SystemExit(1) from e
        print(json.dumps(out))
        return out
    if args.workload == "mfu":
        out = bench_transformer_mfu(**mfu_kw)
    else:
        dist.init_process_group(world_size=args.world_size)
        try:
            dtype = torch.bfloat16 if args.bf16 else torch.float32
            if args.workload == "resnet":
                out = bench_resnet_ddp(dtype=dtype)
            elif args.workload == "bert":
                out = bench_bert_finetune(dtype=dtype)
            else:
                out = bench_ddp_mnist(steps_per_call=args.steps_per_call, trace_dir=trace_dir)
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
