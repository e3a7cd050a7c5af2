#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: drives it on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no `ok` line):

1. card: name, count, power limit; TF32 off, so the plain versions
   compute in full float32.
2. build: nvcc builds csrc/flash_attention.cu (with csrc/flash_wgmma.cuh)
   for sm_90a; each instance's registers and spills from ptxas, and the
   wgmma instances' dynamic shared memory, are printed. A wgmma instance
   that spills fails the phase.
3. kernels: the forward (F), dK/dV (KV) and dQ (Q) kernels against their
   plain versions at the ~1B train step's shapes (B*H 64, L 1024, D 128,
   bf16, causal), plus a non-causal and a D=64 case; F also with float32
   output. `fa.kernel_route` names each kernel's instance: F, KV and Q
   take the wgmma route (bf16 at D 64 and 128), held to its declared
   tolerance; a float32 D 128 case holds the SIMT F, KV and Q. Time by
   CUDA events beside the plain version, the bound, and the
   library: for F `scaled_dot_product_attention`, for KV and Q together
   the flash backward behind it (timed here only; the port never calls
   either).
4. kernels-long: F (bf16 and float32 output), KV and Q against their plain
   versions in the reference's streamed regime (B*H 16, L 16384, D 128,
   bf16, causal; L*D = 2.1M elements), timed as in phase 3 except that
   each plain version is timed once, by the call that checks it; F with
   float32 output (ring attention's partials) at the same shape,
   non-causal; and the head dims without an instance of their own, D 32,
   96 (the wgmma route, padded to 128) and 256 (bf16 and, at 256,
   float32: the SIMT route), at L 512.
5. reference: a small float32 TransformerLM on the card against the same
   weights on the CPU (the plain versions): logits, loss and grads.
6. slice: the trainer (`examples/lm.py`) at the ~1B configuration's full
   width (vocab 32000, d 2048, 16 layers, 16 heads, d_ff 5504, seq 1024,
   batch 4, bf16, AdamW): the first step's loss and logits against the
   dense path on the same weights, two warm-up steps, then 3 timed steps
   after which F, KV and Q must each show n_layers * 3 launches, all on
   the wgmma route (step time, tokens/s, MFU as bench.py counts it, peak
   memory); then one
   step under torch.profiler: device time by kernel group and the
   device's busy share of the step.
7. ring: `make_cp_attention(4, mode="ring", causal=True)` (driver mode) over
   4 shards of 16384 tokens (B 1, H 16, D 128, bf16), forward and
   backward: one untimed warm-up call, then two timed calls (their mean
   printed), each of which must launch exactly 4 each of F (float32
   output), KV and Q, all on the wgmma route; output and dQ/dK/dV
   against `flash_with_lse` over the whole 65536-token sequence on the
   same kernels, timed the same way. Then a small float32 ring (the SIMT
   kernels) against dense attention.
8. long: the trainer at seq 16384, batch 1, at the same full width: the
   first-step check on a 2-layer model (flash against dense on the same
   weights), one warm-up step, 2 timed steps after which F, KV and Q
   must each show n_layers * 2 launches on the same routes as the slice,
   and one profiled step.
9. c10d: the c10d core (`distributed.py`). Driver mode at world 8 on
   cuda:0 (8 ranks stacked on the one card): every collective and ReduceOp
   against numpy on the host, exactly, on integer-valued inputs; the toy
   example through its `run()` at world 8; CUDA-event times (mean of 20
   calls after 2 warm-ups) of all_reduce(SUM), all_gather, reduce_scatter,
   broadcast and all_to_all at DDP's 25 MiB bucket a rank, world 8, bf16
   and float32, and of all_reduce of CFG_1B's whole float32 gradient
   (3.76 GB a rank) at world 4, each beside its HBM bound (bytes read plus
   written over 3.35 TB/s); then multiproc mode as a world-1 nccl group
   through `init_process_group(init_method="tcp://...")`, whose store must
   be the native one.
10. mnist: the reference workload (DDP-MNIST) on the port's data pipeline,
   ConvNet and DDP, in driver mode on cuda:0. Three steps of the DDP train
   step at world 8 (ZeRO auto, dropout off) against the same run on the
   CPU (float32, TF32 off); ZeRO auto against off, bitwise over 3 steps
   with cuDNN's deterministic algorithms; 20 steps at world 8, ZeRO auto,
   batch 64 a rank, on SyntheticMNIST through the port's
   DistributedSampler and DataLoader: the loss must fall, and every rank's
   row of each all-gather must be the ranks' shards in rank order. Then
   `bench.bench_ddp_mnist` (16 warm-up steps, 3 windows of 64, the median
   after the first) at world 1 and 8, steps_per_call 1 and 8, in samples/s
   per card; one profiled step at each world (device busy share,
   launches, top kernels) and the host's ms inside c10d dispatch over an
   unprofiled step; and the example, `examples.mnist.main(["--epochs",
   "1"])` (world 8 on the card).
11. fsdp_tp: the trainer over an ("fsdp", "tp") mesh of 2 x 2 in driver
   mode on cuda:0 (`examples/lm.py` with --tp 2 at 4 ranks: fully_shard by
   the reference's transformer rules, the batch split over fsdp, AdamW on
   the shards), at the slice's full width, depth and global work. Its
   first step's loss and every gathered gradient against the single-card
   step on the same weights and tokens (|dloss| <= 1e-2, rms(diff)/rms <=
   3e-2), three steps with a finite, falling loss, two warm-up steps, 3
   timed steps (step time, tokens/s, MFU as the slice counts it, peak
   memory, per-rank bytes of params and optimizer state), then one
   profiled step in which F, KV and Q must launch once a layer for all
   four ranks, on the wgmma route. The MoE (8 experts, top-1) with its
   depth cut to 4 layers: its first step against the single card in
   float32 (loss and gradients; bf16 rounding moves a few tokens to other
   experts), then the same run as the dense one in bf16 (loss against the
   single card), with the aux values; then `make_ep_moe` at 4 ranks
   against its single-rank computation at the same width.
12. serve: the serving path (the KV-cache decode path, generate() and
   the paged `ServeEngine`), after `[fsdp_tp]`, TF32 still off. A small
   float32 model (2 layers, d 64, 4 heads over 2 KV heads, vocab 64,
   max_seq_len 64) on the card against the same weights on the CPU:
   decode-path prefill logits (rtol 1e-5, atol 1e-5 of max|cpu|),
   generate() greedy and sampled (T 0.8, top-k 8) token for token, and a
   12-request engine trace (a pool that preempts, chunked prefill at 8,
   the prefix cache on; float and int8 pools) with equal completions.
   Then CFG_1B at full width, max_seq_len 2048, bf16: prefill logits of
   4 x 512 tokens through the decode path against the flash forward
   (rms(diff)/rms <= 3e-2); 48 requests of the bimodal new-token mix on
   prompts of 256 or 512 tokens with chunked prefill at 256, once with the
   full pool and once with 192 blocks, which must preempt, and every
   greedy stream identical across the two; the bimodal burst of
   `benchmarks/serve_bench.py` (48 requests, prompts 8-64, 8 slots,
   unchunked) timed with a float and an int8 pool (tokens/s, TTFT and TPOT
   p50/p99, peak memory, pool bytes; the int8 pool's greedy match rate
   reported); one steady 8-slot decode step by CUDA events and under
   torch.profiler (busy share, launches, top kernels, the paged gather's
   share) and the gather alone; and `examples.generate.main` on the card.
   No flash kernel launches on the serve path (the logits gate's flash
   forward is the comparison, before the counts are reset).
13. serve_fleet: serving across ranks and pools, after `[serve]`, TF32
   still off. The small float32 model on the card against the CPU: a tp 2
   engine (driver mode, `mesh=`) gives the single engine's and the CPU's
   greedy tokens, float and int8 pools; a 1 x 1 `DisaggRouter` over
   `HashStore` gives the colocated engine's completions, greedy and
   sampled, one migration a request; a republished migration is byte for
   byte the first (bf16 and int8 pools). Then CFG_1B at full width,
   max_seq_len 2048, bf16, block 16: tp 2 prefill logits (4 x 512 through
   the paged programs) against the single-card engine (rms(diff)/rms <=
   3e-2); the [serve] bimodal burst through tp 1 and tp 2 engines of 8
   slots (tokens/s, TTFT and TPOT p50/p99, pool bytes a rank, peak memory;
   the tp 2 greedy match rate reported); a steady tp 2 decode step by
   CUDA events and under torch.profiler with the tp seams annotated;
   `redistribute_for_serving` from the trainer's fsdp 2 x tp 2 layout
   into a tp 2 engine (the move's peak memory no more than the serve
   layout and one leaf; logits against the single card <= 3e-2).
   `serve_bench.py --trace disagg` at its defaults (16 steady requests
   decoding when 32 long-prompt requests arrive; chunk 32, 18 slots):
   colocated against a prefill and a decode engine on the card over
   HashStore, the decode steps' p99 under the burst, migrations, bytes
   and each part's ms a request, and the regimes' token match; on the
   determinism construct (16 requests, prompts 256/512, chunk 256) disagg
   must equal colocated token for token. `ServeRouter` over 2 replicas:
   the bimodal burst (tokens/s against one engine, rebinds), and a
   mid-flight `remove_replica` on the determinism construct, sealed into
   HashStore, whose greedy tokens must equal one unscaled engine's (the
   colocated run of the disagg construct). No flash kernel launches in
   the phase.
14. cifar: the BASELINE's ResNet-18/CIFAR-10 workload, after
   `[serve_fleet]`, TF32 still off: ResNet-18 at full width (11.2M params)
   with SyncBatchNorm through `examples/cifar.py`'s train step, driver
   mode at world 8 on cuda:0. Its first step (4 images a rank, float32)
   against the same step on the CPU: the loss, every leaf's SGD update and
   the running statistics; the synced statistics against BN over the
   global batch in one forward. Then `bench.bench_resnet_ddp` at 128 a
   rank (1024 images a step) in float32 and bf16 (samples/s per card, the
   median window after the first; step ms by CUDA events; one profiled
   step's busy share, launches and top kernels; peak memory), and the
   example for an epoch. No flash kernel may launch (ResNet has no
   attention).
15. bert: the BASELINE's BERT-base fine-tune workload, after `[cifar]`.
   float32 checks, dropout off, at full width with the depth cut to 2
   layers, 2 x 32 tokens a rank: the DDP step's first step card vs CPU;
   `grad_accum_steps=2` against one step of the same batch; remat against
   no remat with dropout on (the same masks); 3 adamw steps of each hook
   (bf16, fp16, block-quantized int8 with error feedback, PowerSGD rank 2)
   against `allreduce_hook`'s losses, and the int8 payload's wire dtype
   from the flight recorder. Then `bench.bench_bert_finetune` at the
   "base" preset, 16 x 128 a rank, adamw(2e-5), dropout 0.1: float32 and
   bf16 with the stock hook, and each compressing hook in bf16 (samples/s
   and tokens/s per card, step ms by CUDA events, a profiled step, peak
   memory, the hook alone on BERT-base's gradient by CUDA events beside
   its wire bytes a rank). No flash kernel may launch (BERT's attention is
   dense, as the reference's).
16. dryrun: the reference's multichip dry run (`dryrun.py`), after
   `[bert]`. (a) `dryrun_multichip(8)` on the card and on the CPU on the
   same weights (float32, TF32 off): every part finite, the all_reduce
   28, the card's values within rtol 1e-5 (atol 1e-5 of the largest) of
   the CPU's, part 5's DDP loss compared with dropout off (each device
   draws its own masks); the flash Function under `torch.func.vjp` of
   `vmap` over 4 stages at CFG_1B's attention: one launch each of F, KV
   and Q, bitwise the per-stage loop. (b) CFG_1B over dp 2 x fsdp 2 x tp
   2 (8 driver-mode ranks): the `[fsdp_tp]` checks, times, memory and
   launch counts on the 3-D mesh. (c) CFG_1B's 16 blocks as a pp 4
   pipeline (4 a stage, bf16, flash), M 8 microbatches of 1 x 1024
   tokens from the embedding, the loss the final norm, LM head and
   cross-entropy: 1F1B's loss and stage gradients against the
   unpipelined blocks and GPipe's against 1F1B (|dloss| <= 1e-2, rms
   ratio <= 3e-2), the timed 1F1B step (launches: 8 F, 4 KV, 4 Q a
   tick) and its profile, 1F1B's peak memory at M 8 and 16 within 10%,
   GPipe's at M 4 and 8 growing by more than 10%, and the interleaved
   schedule (V 2: 8 stages of 2 blocks over pp 4) against the sequential
   forward (rms ratio <= 3e-2).
17. report: one JSON line of kernels (each Hopper kernel once per Pallas
   lowering it replaces, with its design, "wgmma" or "simt", and its
   launches per phase, `serve_fleet`, `cifar`, `bert` and `dryrun` among
   them), the card's name and power limit, then the `ok` line.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import math
import re
import socket
import subprocess
import sys
import time

import numpy as np
import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import bench, dryrun, optim
from pytorch_distributed_example_tpu_torch.data import DataLoader, DistributedSampler, SyntheticMNIST
from pytorch_distributed_example_tpu_torch.examples import cifar, lm, mnist, toy
from pytorch_distributed_example_tpu_torch.models import (
    BertConfig,
    BertForSequenceClassification,
    ConvNet,
    TransformerConfig,
    TransformerLM,
    convert_sync_batchnorm,
    transformer_sharding_rules,
)
from pytorch_distributed_example_tpu_torch.models.transformer import Block, rope_freqs
from pytorch_distributed_example_tpu_torch.ops import _build, dense_attention, quant
from pytorch_distributed_example_tpu_torch.parallel import comm_hooks, fully_shard
from pytorch_distributed_example_tpu_torch.parallel import pipeline as pp
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.utils.flight_recorder import global_recorder
from pytorch_distributed_example_tpu_torch.dtensor import DTensor
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as cp
from pytorch_distributed_example_tpu_torch.parallel import expert_parallel as ep

# the module (its package exports the `flash_attention` function by that name)
fa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")

SLICE_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "16",
              "--n-heads", "16", "--seq", "1024", "--batch-size", "4", "--bf16",
              "--lr", "1e-3"]
# after a single warm-up step the next step ran ~20% slower than the ones
# after it on the H100, so two warm-up steps precede the timed ones
WARMUP_STEPS = 2
TIMED_STEPS = 3
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
LONG_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "16",
             "--n-heads", "16", "--seq", "16384", "--batch-size", "1", "--bf16",
             "--lr", "1e-3"]
LONG_CHECK_LAYERS = 2  # the dense path's f32 scores take 17.2 GB a layer at L 16384
LONG_WARMUP_STEPS = 1
LONG_TIMED_STEPS = 2
RING_WORLD, RING_SHARD = 4, 16384
# the sharded trainer: fsdp 2 x tp 2 in driver mode on cuda:0, the slice's
# global work; the MoE at the same width, its depth cut to 4 layers
FSDP_TP_WORLD, FSDP_TP_TP = 4, 2
FSDP_TP_ARGV = SLICE_ARGV + ["--tp", str(FSDP_TP_TP)]
MOE_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "4", "--n-heads", "16",
            "--seq", "1024", "--batch-size", "4", "--bf16", "--lr", "1e-3",
            "--tp", str(FSDP_TP_TP), "--n-experts", "8"]
FSDP_TP_STEPS = 3  # checked steps, which warm up the timed ones
# bf16 against the single card: o/down's partial products are summed over
# tp where the single card sums in one matmul
SHARDED_LOSS_TOL, SHARDED_GRAD_RMS = 1e-2, 3e-2
EP_WORLD, EP_EXPERTS = 4, 8
SOURCE = "pytorch_distributed_example_tpu_torch/csrc/flash_attention.cu"
WGMMA_SOURCE = "pytorch_distributed_example_tpu_torch/csrc/flash_wgmma.cuh"
PALLAS = "pytorch_distributed_example_tpu/ops/flash_attention.py"
# Each Hopper kernel streams its counterpart tiles through shared memory at
# every L, so it replaces both of the reference's lowerings: the resident
# one (whole K/V in VMEM) and the streamed one (L*D past 1.5M elements)
REPLACES = {
    "flash_fwd": {"resident": f"{PALLAS}:79", "streamed": f"{PALLAS}:207"},
    "flash_dkdv": {"resident": f"{PALLAS}:306", "streamed": f"{PALLAS}:379"},
    "flash_dq": {"resident": f"{PALLAS}:347", "streamed": f"{PALLAS}:432"},
}
# the phases that drive the port's main paths, by the regime they put the
# kernels in
PHASES = {"resident": ("slice", "fsdp_tp", "dryrun"), "streamed": ("ring", "long")}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kernel, BH, L, D, dtype, causal):
    """Least time on the card: each input read once, each output written
    once, over HBM; the products over the (causal) score matrix at the
    operands' peak rate. Returns (ms, "bytes" | "operations", flops)."""
    es = dtype.itemsize
    pairs = L * (L + 1) // 2 if causal else L * L
    tile, rows = BH * L * D * es, BH * L * 4
    nbytes, flops = {
        "flash_fwd": (4 * tile + rows, 4 * D * pairs * BH),      # q k v -> o lse; QK^T, PV
        "flash_dkdv": (6 * tile + 2 * rows, 8 * D * pairs * BH),  # + dO lse delta -> dk dv; 4 products
        "flash_dq": (5 * tile + 2 * rows, 6 * D * pairs * BH),    # -> dq; 3 products
    }[kernel]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            flops)


def compare(got, want, rtol, atol_frac):
    """(max |got - want|, that over max |want|, whether every entry is
    within atol + rtol * |want|, with atol = atol_frac * max |want|)."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    top = float(want.abs().max())
    ok = bool((err <= atol_frac * top + rtol * want.abs()).all())
    return float(err.max()), float(err.max()) / top, ok


def atol_used(got, want, rtol, atol_frac):
    """The least atol_frac that `compare` would pass at this rtol: how much
    of a tolerance's atol the entries use."""
    got, want = got.detach().float(), want.detach().float()
    over = ((got - want).abs() - rtol * want.abs()).clamp_min(0)
    return float(over.max()) / float(want.abs().max())


# bf16 outputs: the kernel and the plain version each round an f32 result
# once (2**-8 relative each), after summing in another order
BF16_TOL = dict(rtol=2 ** -7, atol_frac=1e-3)
# float32 outputs: the same f32 arithmetic in another order
F32_TOL = dict(rtol=1e-4, atol_frac=1e-5)
LSE_TOL = dict(rtol=1e-5, atol_frac=1e-6)
# the wgmma route (F, KV and Q, bf16 operands at D 64 and 128) also rounds P
# and dS to bf16: its tolerance is declared, with its reason, beside the route
WGMMA_TOL = fa.WGMMA_BF16_TOL


def tol_for(dtype, route="simt"):
    if route == "wgmma":
        return WGMMA_TOL
    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def tol_text(tol):
    rtol = "2^-7" if tol["rtol"] == 2 ** -7 else f"{tol['rtol']:g}"
    return f"rtol {rtol}, atol {tol['atol_frac']:g}*max|plain|"


def ptxas_entries(log):
    """(kernel, registers line, spill line) per entry function in a ptxas -v
    log, the kernel as name<template arguments>."""
    entries = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d(flash_[a-z_]+_kernel)I(\w*?)Li(\d+)E", mangled)
            name = mangled
            if m:
                types = ["bf16" if t != "f" else "f32"
                         for t in re.findall(r"13__nv_bfloat16|S\d*_|f", m.group(2))]
                name = f"{m.group(1)}<{', '.join(types + ['D ' + m.group(3)])}>"
            entries.append([name, "", ""])
        elif entries and "Used" in line and "registers" in line:
            entries[-1][1] = line.split("ptxas info    :")[-1].strip()
        elif entries and "spill stores" in line:
            entries[-1][2] = line.strip()
    return entries


def timed_once(fn):
    """(fn(), its device time in ms): one call between two CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_checks(BH, L, D, causal, timed, dtype=torch.bfloat16, B=4, iters=20,
                  plain_once=False):
    """Each kernel against its plain version on the same inputs. With
    `timed`, also each kernel's time (mean of `iters` launches), the plain
    version's (the checking call itself when `plain_once`, else a mean of
    5), the bound, and the library's call on (B, BH/B, L, D)."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + causal)
    q, k, v, do = (torch.randn((BH, L, D), device="cuda", generator=gen,
                               dtype=dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)
    design = {name: fa.kernel_route(dtype, D) for name in REPLACES}
    tol = {name: tol_for(dtype, route) for name, route in design.items()}
    plain_ms = {}
    o, lse = fa._fwd_cuda(q, k, v, scale, causal)
    o32, _ = fa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    # one plain call gives both outputs: its bf16 o is its float32 o rounded
    (po32, plse), plain_ms["flash_fwd"] = timed_once(
        lambda: fa._fwd_plain(q, k, v, scale, causal, bq, bk, out_dtype=torch.float32))
    po = po32.to(dtype)
    # float32 output from bf16 operands: the SIMT route keeps the f32 tolerance
    tol32 = tol_for(torch.float32, design["flash_fwd"])
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dk, dv = fa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal)
    (pdk, pdv), plain_ms["flash_dkdv"] = timed_once(
        lambda: fa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, bq, bk))
    dq = fa._dq_cuda(q, k, v, do, plse, delta, scale, causal)
    pdq, plain_ms["flash_dq"] = timed_once(
        lambda: fa._dq_plain(q, k, v, do, plse, delta, scale, causal, bq, bk))
    results = {}
    for name, pairs in (
        ("flash_fwd", [(o, po, tol["flash_fwd"]), (o32, po32, tol32), (lse, plse, LSE_TOL)]),
        ("flash_dkdv", [(dk, pdk, tol["flash_dkdv"]), (dv, pdv, tol["flash_dkdv"])]),
        ("flash_dq", [(dq, pdq, tol["flash_dq"])]),
    ):
        errs = [compare(g, w, **t) for g, w, t in pairs]
        err = max(e for e, _, _ in errs)
        rel = max(r for _, r, _ in errs)
        ok = all(good for _, _, good in errs)
        used = max(atol_used(g, w, **t) for g, w, t in pairs)
        extra = (f", float32 output {errs[1][1]:.3e} ({tol_text(tol32)})"
                 if name == "flash_fwd" else "")
        print(f"  {name} [{design[name]}] BH={BH} L={L} D={D} {str(dtype)[6:]} causal={causal}: "
              f"max_abs_err={err:.3e} max_abs_err/max|plain|={rel:.3e}{extra}; within "
              f"tolerance ({tol_text(tol[name])}): {ok}, using atol {used:.3e}*max|plain|")
        check(ok, f"{name} disagrees with its plain version at BH={BH} L={L} D={D} "
                  f"{dtype} causal={causal}")
        results[name] = {"design": design[name], "max_abs_err": err,
                         "tolerance": tol_text(tol[name]), "atol_used": used}
    if not timed:
        return results
    kern = {
        "flash_fwd": lambda: fa._fwd_cuda(q, k, v, scale, causal),
        "flash_dkdv": lambda: fa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal),
        "flash_dq": lambda: fa._dq_cuda(q, k, v, do, plse, delta, scale, causal),
    }
    plain = {
        "flash_fwd": lambda: fa._fwd_plain(q, k, v, scale, causal, bq, bk),
        "flash_dkdv": lambda: fa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, bq, bk),
        "flash_dq": lambda: fa._dq_plain(q, k, v, do, plse, delta, scale, causal, bq, bk),
    }
    H = BH // B
    q4, k4, v4, do4 = (x.view(B, H, L, D) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # The library has no dK/dV-only or dQ-only call: its flash backward
    # computes dQ, dK and dV together from its own forward's output and lse,
    # so that one call is the yardstick of KV and Q as a pair
    lib_fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=scale)
    lib_o, lib_lse, cum_q, cum_k, max_q, max_k, seed, offset = lib_fwd[:8]

    def sdpa_backward():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, lib_o, lib_lse, cum_q, cum_k, max_q, max_k, 0.0, causal,
            seed, offset, scale=scale)

    lib_grads = [g.reshape(BH, L, D) for g in sdpa_backward()]
    lib_rel = max(compare(g, w, **BF16_TOL)[1] for g, w in zip(lib_grads, (pdq, pdk, pdv)))
    print(f"  sdpa flash backward vs the plain versions: max_abs_err/max|plain| = "
          f"{lib_rel:.3e} (timed only)")
    del lib_grads
    library = {
        "flash_fwd": ("scaled_dot_product_attention",
                      lambda: sdpa(q4, k4, v4, is_causal=causal)),
        "flash_dkdv": ("aten._scaled_dot_product_flash_attention_backward (dQ, dK, dV)",
                       sdpa_backward),
        "flash_dq": ("aten._scaled_dot_product_flash_attention_backward (dQ, dK, dV)",
                     sdpa_backward),
    }
    lib_ms = {}
    for name in kern:
        r = results[name]
        r["shape"] = f"BH {BH}, L {L}, D {D}, {str(dtype)[6:]}, causal {causal}"
        r["ms"] = time_ms(kern[name], iters=iters, warmup=2 if iters > 5 else 1)
        r["plain_ms"] = (plain_ms[name] if plain_once
                         else time_ms(plain[name], iters=5, warmup=1))
        r["bound_ms"], r["bound_by"], flops = bound(name, BH, L, D, q.dtype, causal)
        r["library_call"], lib_fn = library[name]
        if lib_fn not in lib_ms:
            lib_ms[lib_fn] = time_ms(lib_fn, iters=iters, warmup=2 if iters > 5 else 1)
        r["library_ms"] = lib_ms[lib_fn]
        print(f"  {name}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain"
              f"{' (one call)' if plain_once else ''}, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['ms'] / r['bound_ms']:.1f}x the bound, {flops / r['ms'] / 1e9:.1f} TFLOP/s), "
              f"library {r['library_ms']:.4f} ms ({r['library_call']})")
    print(f"  backward pair: KV + Q {results['flash_dkdv']['ms'] + results['flash_dq']['ms']:.4f} "
          f"ms against the library's one call {lib_ms[sdpa_backward]:.4f} ms")
    return results


def fwd_f32_out_check(BH, L, D, causal):
    """F with float32 output from bf16 operands (the ring's per-step
    partials) against its plain version, at the tolerance of the route that
    serves it: the float32 one on the SIMT route (both keep the f32
    accumulator), the declared one on the wgmma route (P is rounded)."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + 2)
    q, k, v = (torch.randn((BH, L, D), device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)
    o, lse = fa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    (po, plse), plain_ms = timed_once(
        lambda: fa._fwd_plain(q, k, v, scale, causal, bq, bk, out_dtype=torch.float32))
    check(o.dtype == torch.float32, f"flash_fwd returned {o.dtype} for out_dtype float32")
    route = fa.kernel_route(torch.bfloat16, D)
    tol = tol_for(torch.float32, route)
    (err, rel, ok), (lerr, _, lok) = compare(o, po, **tol), compare(lse, plse, **LSE_TOL)
    print(f"  flash_fwd [{route}] bf16 -> float32 output, BH={BH} L={L} D={D} causal={causal}: "
          f"max_abs_err={err:.3e} max_abs_err/max|plain|={rel:.3e}, lse {lerr:.3e}; within "
          f"tolerance ({tol_text(tol)}): {ok and lok}; plain {plain_ms:.1f} ms (one call)")
    check(ok and lok, f"flash_fwd with float32 output disagrees with its plain version "
                      f"at BH={BH} L={L} D={D} causal={causal}")


def want_routes(n, design="wgmma"):
    """ROUTE_LAUNCHES after n launches of each role, all on `design`."""
    want = {name: 0 for name in fa.ROUTE_LAUNCHES}
    want.update({f"{name}:{design}": n for name in REPLACES})
    return want


KERNEL_GROUPS = (  # device kernels by what they serve, first match wins
    ("flash kernels (F, KV, Q)", ("flash_fwd", "flash_dkdv", "flash_dq")),
    ("matmuls (cuBLAS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("CatArrayBatchedCopy", "copy_kernel")),
)


def profile_step(step, step_ms):
    """One train step, `step()`, under torch.profiler: device time by
    kernel group and the top kernels, and the device's busy share of the
    profiled step and of an unprofiled one (`step_ms`). Only device
    kernels are summed: an operator's row and a `record_function` range on
    the device (the optimizer's step) repeat their kernels' time. One
    stream, so the kernels do not overlap."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    if not busy:
        print("  profiler saw no device time: busy share not measured")
        return
    print(f"  device busy {busy:.2f} ms per step: {busy / wall_ms:.1%} of the profiled "
          f"step's {wall_ms:.2f} ms, {busy / step_ms:.1%} of the {step_ms:.2f} ms timed "
          f"step; {sum(n for _, n, _ in rows)} kernel launches")
    groups = {}
    for ms, _, key in rows:
        group = next((g for g, words in KERNEL_GROUPS if any(w in key for w in words)),
                     "other (elementwise, reductions, norms, softmax, embedding)")
        groups[group] = groups.get(group, 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms {ms / busy:6.1%}  {group}")
    print("  top kernels:")
    for ms, n, key in rows[:12]:
        print(f"    {ms:9.3f} ms {ms / busy:6.1%} x{n:<4d} {key[:100]}")


def reference_check():
    """float32 model on the card vs the same weights on the CPU."""
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
                            max_seq_len=256)  # head dim 128
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, 256, (2, 256), generator=torch.Generator().manual_seed(0))
    out = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = toks.to(next(model.parameters()).device)
        logits = model(t)
        loss = lm.loss_fn(logits, t)
        loss.backward()
        out[name] = (logits.detach().cpu(), loss.item(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    (cl, closs, cg), (gl, gloss, gg) = out["cpu"], out["cuda"]
    check(gl.shape == (2, 256, 256) and torch.isfinite(gl).all(), "bad logits on the card")
    lerr = float((gl - cl).abs().max())
    gerr = max(float((gg[n] - cg[n]).abs().max()) / float(cg[n].abs().max()) for n in cg)
    print(f"  f32 card vs CPU: logits max_abs_err={lerr:.3e}, loss {gloss:.6f} vs "
          f"{closs:.6f}, grads max err / max|grad| = {gerr:.3e}")
    # float32 throughout (TF32 off): only summation order differs
    check(lerr <= 1e-4 and abs(gloss - closs) <= 1e-5 and gerr <= 1e-4,
          "the port on the card disagrees with the CPU reference")


def first_step_check(model, tokens):
    """The model's loss and logits on the flash path against the dense
    path on the same weights, no grad."""
    cfg = model.cfg
    with torch.no_grad():
        logits = model(tokens)
        loss = float(lm.loss_fn(logits, tokens))
        dense = TransformerLM(dataclasses.replace(cfg, use_flash=False), device="cuda")
        dense.load_state_dict(model.state_dict())
        torch.cuda.reset_peak_memory_stats()
        dlogits = dense(tokens)
        dense_peak = torch.cuda.max_memory_allocated()
        dloss = float(lm.loss_fn(dlogits, tokens))
        del dense
        diff = (logits - dlogits).float()
        rel_rms = float(diff.pow(2).mean().sqrt() / dlogits.pow(2).mean().sqrt())
        max_diff = float(diff.abs().max())
        del dlogits, diff
    check(logits.shape == (*tokens.shape, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "non-finite or misshapen logits")
    del logits
    print(f"  first step, flash vs dense on the same weights ({cfg.n_layers} layers): loss "
          f"{loss:.5f} vs {dloss:.5f}, logits rms diff / rms = {rel_rms:.3e}, max |diff| = "
          f"{max_diff:.3e}; the dense forward's peak memory {dense_peak / 2 ** 30:.2f} GiB")
    # bf16 activations round at other places on the two paths (dense rounds p
    # to bf16 before p@v, flash keeps it f32): ~2**-8 relative per layer
    check(abs(loss - dloss) <= 1e-2 and rel_rms <= 3e-2,
          "flash and dense paths disagree beyond the bf16 tolerance "
          "(|dloss| <= 1e-2, rms ratio <= 3e-2)")


def train_phase(argv, warmup_steps, timed_steps, card, check_layers=None):
    """The trainer (`examples/lm.py`) built from `argv`: the first-step
    check (on the model itself, or on a `check_layers`-layer model of the
    same width), warm-up steps, timed steps whose kernel launches are
    counted, then one profiled step. Returns the launches of the timed
    steps."""
    args = lm.parse_args(argv)
    model, opt, next_tokens = lm.build(args, world=1)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  config: vocab {cfg.vocab_size}, d {cfg.d_model}, layers {cfg.n_layers}, "
          f"heads {cfg.n_heads}, d_ff {cfg.ffn_dim}, seq {args.seq}, batch {args.batch_size}, "
          f"{cfg.dtype}; {n_params / 1e6:.1f}M params; no cuts")
    tokens = next_tokens()
    if check_layers is None:
        first_step_check(model, tokens)
    else:
        small = TransformerLM(dataclasses.replace(cfg, n_layers=check_layers), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
        first_step_check(small, tokens)
        del small

    for i in range(warmup_steps):
        t0 = time.perf_counter()
        warm = lm.train_step(model, opt, tokens if i == 0 else next_tokens())
        torch.cuda.synchronize()
        print(f"  warm-up step {i + 1}: loss {float(warm):.5f}, "
              f"{time.perf_counter() - t0:.3f} s")
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(timed_steps):
        batch = next_tokens()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(lm.train_step(model, opt, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    mean_s = sum(step_s) / len(step_s)
    tok_s = args.batch_size * args.seq / mean_s
    # bench.py's analytic model FLOPs per step (PaLM form), over the bf16 peak
    model_flops = ((6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * args.seq)
                   * args.batch_size * args.seq)
    mfu = model_flops / mean_s / PEAK_FLOPS[torch.bfloat16]
    print(f"  losses {losses}; step times (s) {step_s}")
    print(f"  mean step {mean_s * 1e3:.2f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f} "
          f"({model_flops:.4g} model FLOPs per step over 989 TFLOP/s), "
          f"peak memory {peak / 2 ** 30:.2f} GiB  [{card}]")
    print(f"  launches in the timed steps: {launches}; by route: {routes}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    want = cfg.n_layers * timed_steps
    check(all(launches[n] == want for n in REPLACES),
          f"each kernel should have launched {want} times: {launches}")
    check(routes == want_routes(want),
          f"F, KV and Q should have launched {want} times each on the wgmma route: {routes}")
    print("[profile] one more step under torch.profiler")
    tokens = next_tokens()
    profile_step(lambda: lm.train_step(model, opt, tokens), mean_s * 1e3)
    del model, opt
    torch.cuda.empty_cache()
    return routes


# The ring's gradients: each ring step's dQ/dK/dV partial leaves the kernels
# rounded to bf16 (half an ulp, 2**-9 relative) before the float32 sum over
# the W steps, and the sum rounds once more, where global flash rounds once.
# On these inputs no partial is larger than the largest gradient entry, so
# the two stay within (W + 2) * 2**-9 of max|grad| (plus the bf16 rtol).
RING_GRAD_TOL = dict(rtol=2 ** -7, atol_frac=(RING_WORLD + 2) * 2 ** -9)


def ring_call(attention, q, k, v, do):
    """One forward and backward of `attention` on fresh leaves of q, k, v:
    (o, the leaves, launches and routes after the forward and after the
    backward, forward ms, backward ms), on the host clock."""
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = attention(*xs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    o.backward(do)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    both = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    return o, xs, fwd, both, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def calls_text(times):
    return ", ".join(f"{f:.1f} / {b:.1f} ms" for f, b in times)


def ring_phase():
    """Ring attention over RING_WORLD shards in driver mode, forward and
    backward, against flash over the whole sequence: each one untimed
    warm-up call, then two timed calls. Returns the ring's launches."""
    W, Ls, B, H, D = RING_WORLD, RING_SHARD, 1, 16, 128
    L = W * Ls
    check(cp.auto_block_kernel(B, H, Ls, Ls) == "flash",
          "the ring's auto rule should pick the flash block kernel at these shards")
    gen = torch.Generator(device="cuda").manual_seed(L)
    q, k, v, do = (torch.randn((B, L, H, D), device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    attention = cp.make_cp_attention(W, mode="ring", causal=True)
    fwd_want = {name: 0 for name in fa.ROUTE_LAUNCHES}
    fwd_want["flash_fwd:wgmma"] = W
    ring_call(attention, q, k, v, do)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        o, xs, (fwd_launches, fwd_routes), (launches, routes), fwd_ms, bwd_ms = ring_call(
            attention, q, k, v, do)
        times.append((fwd_ms, bwd_ms))
        check(fwd_launches == {"flash_fwd": W, "flash_dkdv": 0, "flash_dq": 0}
              and launches == {n: W for n in REPLACES},
              f"the ring should launch each kernel exactly {W} times a call: {launches}")
        check(fwd_routes == fwd_want and routes == want_routes(W),
              f"the ring's F, KV and Q should all take the wgmma route: {fwd_routes}, {routes}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  ring, {W} shards of {Ls} (global L {L}), B {B}, H {H}, D {D}, bf16, causal, after "
          f"one warm-up call: forward {sum(f for f, _ in times) / 2:.1f} ms, backward "
          f"{sum(b for _, b in times) / 2:.1f} ms (mean of 2 calls; per call {calls_text(times)}), "
          f"peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches a call: forward {fwd_launches}, forward and "
          f"backward {launches}; by route {routes}")

    # flash over the whole sequence on the same kernels (not counted)
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)

    def global_flash(q_, k_, v_):
        out, _ = fa.flash_with_lse(*(fa._to_bh(x).contiguous() for x in (q_, k_, v_)),
                                   scale, True, bq, bk)
        return fa._from_bh(out, B, H)

    ring_call(global_flash, q, k, v, do)  # warm-up
    gtimes = []
    for _ in range(2):
        ro, rs, *_, fwd_ms, bwd_ms = ring_call(global_flash, q, k, v, do)
        gtimes.append((fwd_ms, bwd_ms))
    print(f"  global flash over L {L}, after one warm-up call: forward "
          f"{sum(f for f, _ in gtimes) / 2:.1f} ms, backward {sum(b for _, b in gtimes) / 2:.1f} "
          f"ms (mean of 2 calls; per call {calls_text(gtimes)})")
    check(o.shape == (B, L, H, D) and bool(torch.isfinite(o).all()),
          "non-finite or misshapen ring output")
    rows = [("o", o.detach(), ro.detach(), BF16_TOL)]
    rows += [(f"d{n}", x.grad, r.grad, RING_GRAD_TOL) for n, x, r in zip("qkv", xs, rs)]
    ok_all = True
    for name, got, want, tol in rows:
        err, rel, ok = compare(got, want, **tol)
        ok_all &= ok
        print(f"    {name}: max_abs_err={err:.3e} max_abs_err/max|global|={rel:.3e} within "
              f"tolerance ({tol_text(tol).replace('plain', 'global')}): {ok}")
    check(ok_all, "the ring disagrees with flash over the whole sequence")
    del q, k, v, do, xs, o, rs, ro, rows
    torch.cuda.empty_cache()
    small_ring_check()
    return routes


def small_ring_check():
    """A float32 ring on the kernels (4 shards of 512) against dense
    attention over the whole sequence: output and grads."""
    W, B, Ls, H, D = 4, 1, 512, 2, 64
    L = W * Ls
    gen = torch.Generator(device="cuda").manual_seed(L)
    q, k, v, do = (torch.randn((B, L, H, D), device="cuda", generator=gen) for _ in range(4))

    def shard(x):  # (B, L, H, D) -> (W, B, L/W, H, D)
        return x.reshape(B, W, Ls, H, D).transpose(0, 1).contiguous()

    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    o = cp.ring_attention(*(shard(x) for x in xs), causal=True, block_kernel="flash")
    o = o.transpose(0, 1).reshape(B, L, H, D)
    o.backward(do)
    check(dict(fa.ROUTE_LAUNCHES) == want_routes(W, "simt"),
          f"the small float32 ring did not run on the SIMT kernels: {fa.ROUTE_LAUNCHES}")
    rs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = dense_attention(*rs, causal=True)
    want.backward(do)
    results = [compare(g, w, **F32_TOL) for g, w in
               [(o, want)] + [(x.grad, r.grad) for x, r in zip(xs, rs)]]
    rel = max(r for _, r, _ in results)
    ok = all(good for _, _, good in results)
    print(f"  float32 ring, {W} shards of {Ls}, H {H}, D {D}, causal, against dense attention: "
          f"max_abs_err/max|dense| over o, dq, dk, dv = {rel:.3e} within tolerance "
          f"({tol_text(F32_TOL).replace('plain', 'dense')}): {ok}")
    check(ok, "the float32 ring disagrees with dense attention")


C10D_WORLD = 8
BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket_cap_mb=25, a rank
GRAD_WORLD = 4  # CFG_1B's gradient at world 4: 4 x 3.76 GB in, as much out
C10D_OPS = ("SUM", "AVG", "PRODUCT", "MIN", "MAX", "BAND", "BOR", "BXOR", "PREMUL_SUM(2.5)")


def _reduce_op(name):
    return tdx.ReduceOp.PREMUL_SUM(2.5) if name == "PREMUL_SUM(2.5)" else getattr(
        tdx.ReduceOp, name)


def _host_fold(name, g):
    """numpy's reduction over the rank axis, in the reference's dtypes."""
    if name == "AVG":
        return (g.sum(0, dtype=g.dtype if g.dtype.kind == "f" else np.int64)
                .astype(np.float32) / g.shape[0])
    if name == "PREMUL_SUM(2.5)":
        return (g * g.dtype.type(2.5)).sum(0)
    return {"SUM": np.sum, "PRODUCT": np.prod, "MIN": np.min, "MAX": np.max,
            "BAND": np.bitwise_and.reduce, "BOR": np.bitwise_or.reduce,
            "BXOR": np.bitwise_xor.reduce}[name](g, axis=0).astype(g.dtype)


def c10d_parity():
    """Driver mode at world 8 on the card: every collective and ReduceOp
    against numpy on the host on the same integer-valued inputs, exactly
    (sums of eight values in [-2, 2] and products of eight factors of 2
    are exact in float32 and bfloat16). Returns the number of checks."""
    W = C10D_WORLD
    rng = np.random.default_rng(0)
    checks = []

    def inputs(*shape, dtype=np.float32):
        return rng.integers(-2, 3, (W,) + shape).astype(dtype)

    def dist(x, dtype=None):
        t = torch.from_numpy(x)
        return tdx.DistTensor.from_stacked(t.to(dtype) if dtype is not None else t)

    def same(name, got, want):
        host = got.tensor.detach().cpu()
        host = host.float() if host.dtype == torch.bfloat16 else host
        checks.append(name)
        check(got.tensor.device.type == "cuda",
              f"c10d {name}: the result left the card ({got.tensor.device})")
        check(host.shape == want.shape and np.array_equal(host.numpy(), want),
              f"c10d {name}: disagrees with the host computation")

    def rows(r):  # W copies of one rank's value
        return np.broadcast_to(r, (W,) + r.shape)

    for name in C10D_OPS:
        dtype = np.int32 if name.startswith("B") else np.float32
        x = inputs(3, 5, dtype=dtype)
        t = dist(x)
        tdx.all_reduce(t, _reduce_op(name))
        same(f"all_reduce {name} {np.dtype(dtype).name}", t, rows(_host_fold(name, x)))
    for name in ("SUM", "AVG"):
        x = inputs(4, 3)
        t = dist(x, torch.bfloat16)
        tdx.all_reduce(t, _reduce_op(name))
        same(f"all_reduce {name} bfloat16", t, rows(_host_fold(name, x)))
        x = inputs(4, dtype=np.int32)
        t = dist(x)
        tdx.all_reduce(t, _reduce_op(name))
        same(f"all_reduce {name} int32", t, rows(_host_fold(name, x)))
    x = inputs(6)
    t = dist(x)
    tdx.reduce(t, 5, tdx.ReduceOp.MAX)
    want = x.copy()
    want[5] = x.max(0)
    same("reduce MAX dst 5", t, want)
    t = dist(x)
    tdx.broadcast(t, 3)
    same("broadcast src 3", t, rows(x[3]))
    x = inputs(2, 3)
    same("all_gather", tdx.all_gather(dist(x)), rows(x))
    want = np.zeros((W, W, 2, 3), np.float32)
    want[1] = x
    same("gather dst 1", tdx.gather(dist(x), 1), want)
    same("all_gather_into_tensor", tdx.all_gather_into_tensor(dist(x)),
         rows(x.reshape(W * 2, 3)))
    x = inputs(W, 4)
    same("scatter src 6", tdx.scatter(dist(x), 6), x[6])
    for name in ("SUM", "AVG", "MAX", "PRODUCT"):
        same(f"reduce_scatter {name}", tdx.reduce_scatter(dist(x), _reduce_op(name)),
             _host_fold(name, x))
    same("all_to_all", tdx.all_to_all(dist(x)), x.transpose(1, 0, 2))
    same("all_to_all_single", tdx.all_to_all_single(dist(x.reshape(W, W * 4))),
         x.transpose(1, 0, 2).reshape(W, W * 4))
    same("reduce_scatter_tensor", tdx.reduce_scatter_tensor(dist(x.reshape(W, W * 4))),
         x.sum(0))
    x = inputs(5)
    t = dist(x)
    tdx.send(t, 7, src=2)
    want = x.copy()
    want[7] = x[2]
    same("send 2 -> 7", t, want)
    t = dist(x)
    ring = [(r, (r + 1) % W) for r in range(W)]
    ops = [tdx.P2POp(tdx.isend, t, d, rank=s) for s, d in ring]
    ops += [tdx.P2POp(tdx.irecv, t, s, rank=d) for s, d in ring]
    for work in tdx.batch_isend_irecv(ops):
        work.wait()
    same("batch_isend_irecv ring", t, np.roll(x, 1, axis=0))
    return len(checks)


def c10d_bound_bytes(name, W, nbytes):
    """HBM bytes a driver-mode collective must move at world W, `nbytes` a
    rank: every input row read once, every output row written once."""
    return {
        "all_reduce": 2 * W * nbytes,        # W rows in, W rows out
        "all_gather": (W + W * W) * nbytes,  # W rows in, W x W out
        "reduce_scatter": (W + 1) * nbytes,  # W rows in, W chunks of 1/W out
        "broadcast": (1 + W) * nbytes,       # src's row in, W rows out
        "all_to_all": 2 * W * nbytes,        # W rows in, W rows out
    }[name]


def c10d_time(name, W, nbytes, dtype, card):
    """Mean device time of one collective over 20 calls after 2 warm-ups
    (CUDA events), beside its HBM bound. Returns (ms, bound ms)."""
    n = nbytes // dtype.itemsize
    chunked = name in ("reduce_scatter", "all_to_all")
    shape = (W, W, n // W) if chunked else (W, n)
    t = tdx.DistTensor.wrap(torch.randn(shape, device="cuda", dtype=dtype))
    call = {
        "all_reduce": lambda: tdx.all_reduce(t),
        "all_gather": lambda: tdx.all_gather(t),
        "reduce_scatter": lambda: tdx.reduce_scatter(t),
        "broadcast": lambda: tdx.broadcast(t, 0),
        "all_to_all": lambda: tdx.all_to_all(t),
    }[name]
    ms = time_ms(call, iters=20, warmup=2)
    moved = c10d_bound_bytes(name, W, nbytes)
    bound_ms = moved / HBM_BYTES_S * 1e3
    print(f"  {name} {str(dtype)[6:]}, world {W}, {nbytes / 2 ** 20:.1f} MiB a rank: "
          f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({moved / 1e9:.3f} GB over 3.35 TB/s; "
          f"{ms / bound_ms:.2f}x the bound, {moved / ms / 1e9:.3f} TB/s)  [{card}]")
    del t
    return ms, bound_ms


def c10d_phase(card, grad_params):
    """The c10d core on the card: parity, the toy example, timings, and a
    world-1 nccl group on the native store."""
    pg = tdx.init_process_group(world_size=C10D_WORLD)  # the card by default
    check(pg.device == torch.device("cuda", 0), f"the default group runs on {pg.device}")
    n = c10d_parity()
    print(f"  parity: {n} collectives and ReduceOps, world {C10D_WORLD} on {pg.device}, "
          f"each equal to numpy on the host (exact)")
    vals = toy.run(C10D_WORLD, 3)
    check(vals == [28.0, 36.0, 44.0], f"the toy example reduced to {vals}")
    for name in ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all"):
        for dtype in (torch.bfloat16, torch.float32):
            c10d_time(name, C10D_WORLD, BUCKET_BYTES, dtype, card)
    tdx.destroy_process_group()
    torch.cuda.empty_cache()

    tdx.init_process_group(world_size=GRAD_WORLD)
    print(f"  CFG_1B's float32 gradient: {grad_params} params, "
          f"{grad_params * 4 / 1e9:.3f} GB a rank")
    c10d_time("all_reduce", GRAD_WORLD, grad_params * 4, torch.float32, card)
    tdx.destroy_process_group()
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    pg = tdx.init_process_group(backend="nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1, timeout=120)
    native = pg.store.underlying.native
    print(f"  multiproc: world-1 nccl group over tcp://127.0.0.1:{port} up in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (nccl connects at the first "
          f"collective); store served by the "
          f"{'native' if native else 'python'} daemon")
    check(native, "the multiproc store is the Python daemon: the native store did not "
                  "build (the g++ error is in the log)")
    t = tdx.DistTensor.from_process_local(torch.arange(1024.0, device="cuda"))
    t0 = time.perf_counter()
    tdx.all_reduce(t)
    t.block_until_ready()
    print(f"  multiproc: first all_reduce (nccl's connection included) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(t.tensor.device.type == "cuda" and torch.equal(
        t.tensor[0], torch.arange(1024.0, device="cuda")),
        "the world-1 nccl all_reduce changed its input")
    tdx.destroy_process_group()
    check(not tdx.is_initialized(), "destroy_process_group left a group behind")
    print("  multiproc: all_reduce of a CUDA tensor through nccl, then destroyed")


MNIST_WORLD = 8
MNIST_BATCH = 64  # a rank, as the reference bench.py's
MNIST_STEPS = 20
MNIST_CHECK_STEPS = 3
# the bench's windows, shorter than its defaults (20 warm-up steps, windows
# of 200) so that the whole smoke keeps its time
MNIST_BENCH = dict(warmup=16, steps=64, windows=3)
# float32 with TF32 off on both sides, cuDNN's convolutions against
# oneDNN's: the same sums in other orders. Losses within 1e-5 relative,
# params within rtol 1e-4, atol 1e-6, as tests/test_torch_ddp.py holds the
# port against the reference.
MNIST_LOSS_RTOL = 1e-5
MNIST_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def mnist_model(device):
    """The ConvNet from seed 0, initialized on the CPU: the same params on
    every device."""
    return ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)).to(device)


def mnist_batch(world, device):
    """The reference bench.py's fixed batch (np.random.default_rng(0)), NCHW
    on `device`, labels int64."""
    gen = np.random.default_rng(0)
    x = gen.standard_normal((MNIST_BATCH * world, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, 10, MNIST_BATCH * world).astype(np.int32)
    return mnist.to_device(x, y, device)


def mnist_ddp_run(device, mode, has_rng):
    """MNIST_CHECK_STEPS steps of the port's DDP train step at world 8 in
    driver mode on `device`, on the fixed batch: (losses, params) on the
    host."""
    tdx.init_process_group(world_size=MNIST_WORLD, device=None if device == "cuda" else device)
    try:
        ddp = tdx.DistributedDataParallel(mnist_model(device))
        opt = optim.sgd(0.01, momentum=0.5)
        step = ddp.make_train_step(opt, mnist.loss_fn, has_rng=has_rng, shard_weight_update=mode)
        check(step.weight_update_sharded == (mode == "auto"),
              f"ZeRO should be {'on' if mode == 'auto' else 'off'} at world 8 under {mode}")
        x, y = mnist_batch(MNIST_WORLD, device)
        p, s, losses = ddp.params, opt.init(ddp.params), []
        for i in range(MNIST_CHECK_STEPS):
            p, s, loss = step(p, s, x, y, i) if has_rng else step(p, s, x, y)
            losses.append(loss)
        return torch.stack(losses).cpu(), {n: t.cpu() for n, t in p.items()}
    finally:
        tdx.destroy_process_group()


def mnist_step_check():
    """The DDP step itself (reduce-scatter, sharded update, all-gather) on
    the card against the CPU, dropout off; then ZeRO auto against off on
    the card, bitwise."""
    (gloss, gparams), (closs, cparams) = (mnist_ddp_run(d, "auto", False)
                                          for d in ("cuda", "cpu"))
    lerr = float(((gloss - closs).abs() / closs.abs()).max())
    perr = max(float(((gparams[n] - cparams[n]).abs()
                      - MNIST_PARAM_TOL["rtol"] * cparams[n].abs()).max())
               for n in cparams)
    print(f"  {MNIST_CHECK_STEPS} DDP steps at world {MNIST_WORLD}, ZeRO auto, card vs CPU: "
          f"losses max rel err {lerr:.3e} (limit {MNIST_LOSS_RTOL:g}); params max "
          f"(|err| - rtol*|cpu|) {perr:.3e} (rtol {MNIST_PARAM_TOL['rtol']:g}, atol "
          f"{MNIST_PARAM_TOL['atol']:g}); losses {gloss.tolist()}")
    check(lerr <= MNIST_LOSS_RTOL and perr <= MNIST_PARAM_TOL["atol"],
          "the DDP-MNIST step on the card disagrees with the CPU")

    # the contract is about the update given the same gradients: cuDNN's
    # default weight-gradient algorithms need not sum in the same order
    # from one run to the next, so it is held with deterministic ones
    torch.backends.cudnn.deterministic = True
    try:
        (aloss, aparams), (oloss, oparams) = (mnist_ddp_run("cuda", m, True)
                                              for m in ("auto", "off"))
    finally:
        torch.backends.cudnn.deterministic = False
    bitwise = torch.equal(aloss, oloss) and all(torch.equal(aparams[n], oparams[n])
                                                for n in aparams)
    print(f"  ZeRO auto vs off over {MNIST_CHECK_STEPS} steps, dropout on, deterministic "
          f"cuDNN, bitwise equal: {bitwise} (losses {aloss.tolist()})")
    check(bitwise, "ZeRO auto and off differ on the card")


def mnist_train_check():
    """20 DDP steps at world 8 (ZeRO auto) on SyntheticMNIST through the
    port's sampler and loader. Every rank's row of each all-gather must be
    the ranks' updated shards in rank order, so every replica holds the
    same params."""
    pg = tdx.init_process_group(world_size=MNIST_WORLD)
    real_gather = tdx.distributed.all_gather
    gathered = []

    def spy(tensor, group=None, async_op=False):
        shards = tensor.tensor.clone()
        res = real_gather(tensor, group, async_op)
        gathered.append((shards, res.tensor))
        return res

    try:
        data = SyntheticMNIST(4096)
        samplers = [DistributedSampler(data, MNIST_WORLD, r) for r in range(MNIST_WORLD)]
        loaders = [DataLoader(data, MNIST_BATCH, sampler=s) for s in samplers]
        ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
        opt = optim.sgd(0.01, momentum=0.5)
        step = ddp.make_train_step(opt, mnist.loss_fn, has_rng=True)
        check(step.weight_update_sharded, "ZeRO should be on at world 8 under auto")
        params, state, losses = ddp.params, opt.init(ddp.params), []
        tdx.distributed.all_gather = spy
        seq0, epoch = pg.status.last_enqueued_seq, 0
        t0 = time.perf_counter()
        while len(losses) < MNIST_STEPS:
            for s in samplers:
                s.set_epoch(epoch)
            for micro in zip(*loaders):
                if len(losses) == MNIST_STEPS:
                    break
                x, y = mnist.to_device(np.concatenate([a for a, _ in micro]),
                                       np.concatenate([b for _, b in micro]), "cuda")
                params, state, loss = step(params, state, x, y, len(losses))
                losses.append(loss)
            epoch += 1
        losses = [float(v) for v in losses]
        dt = time.perf_counter() - t0
        tdx.distributed.all_gather = real_gather
        collectives = pg.status.last_enqueued_seq - seq0
        in_order = all(len(out) == MNIST_WORLD and all(torch.equal(row, shards) for row in out)
                       for shards, out in gathered)
        print(f"  {MNIST_STEPS} steps at world {MNIST_WORLD}, ZeRO auto, batch {MNIST_BATCH} a "
              f"rank, SyntheticMNIST through the sampler and loader, in {dt:.2f} s (data "
              f"included); losses {[round(v, 4) for v in losses]}; {collectives} collectives; "
              f"every rank's row of all {len(gathered)} all-gathers is the {MNIST_WORLD} shards "
              f"in rank order: {in_order}")
        check(all(math.isfinite(v) for v in losses), "non-finite DDP-MNIST loss")
        check(sum(losses[-5:]) < sum(losses[:5]), "the DDP-MNIST loss did not fall")
        check(collectives == 3 * MNIST_STEPS, "each ZeRO step should make 3 collectives")
        check(len(gathered) == MNIST_STEPS and in_order,
              "the ranks' params disagree after the all-gather")
    finally:
        tdx.distributed.all_gather = real_gather
        tdx.destroy_process_group()


def mnist_profile(world, card):
    """One DDP step after 5 warm-up steps: the host's ms inside c10d
    dispatch over an unprofiled step, then a step under torch.profiler
    (device busy share, launches, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
    opt = optim.sgd(0.01, momentum=0.5)
    step = ddp.make_train_step(opt, mnist.loss_fn, has_rng=True)
    x, y = mnist_batch(world, "cuda")
    params, state = ddp.params, opt.init(ddp.params)
    for i in range(5):
        params, state, _ = step(params, state, x, y, i)
    torch.cuda.synchronize()
    real, spent = tdx.ProcessGroup._dispatch, []

    def timed(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return real(self, *args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t)

    tdx.ProcessGroup._dispatch = timed
    try:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, x, y, 5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        tdx.ProcessGroup._dispatch = real
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, x, y, 6)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    print(f"  world {world}: unprofiled step {wall:.3f} ms, of which {sum(spent) * 1e3:.3f} ms "
          f"on the host inside {len(spent)} c10d dispatches  [{card}]")
    if not busy:
        print("  profiler saw no device time: busy share not measured")
        return
    print(f"  world {world}: profiled step {pwall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / pwall:.1%}; {busy / wall:.1%} of the unprofiled step), "
          f"{sum(n for _, n, _ in rows)} kernel launches")
    for ms, n, key in rows[:8]:
        print(f"    {ms:8.4f} ms {ms / busy:6.1%} x{n:<4d} {key[:90]}")


def mnist_phase(card):
    mnist_step_check()
    mnist_train_check()
    for world in (1, MNIST_WORLD):
        tdx.init_process_group(world_size=world)
        try:
            for spc in (1, 8):
                r = bench.bench_ddp_mnist(batch_per_rank=MNIST_BATCH, steps_per_call=spc,
                                          **MNIST_BENCH)
                mem = r["memory"]
                print(f"  bench_ddp_mnist world {world} ({'ZeRO' if r['weight_update_sharded'] else 'replicated update'}), "
                      f"steps_per_call {spc}: {r['samples_per_s_per_device']:.1f} samples/s per "
                      f"card (windows {[round(v, 1) for v in r['windows']]}), final loss "
                      f"{r['final_loss']:.4f}, optimizer state {mem['opt_state_bytes_per_device']} "
                      f"bytes a rank ({mem['opt_state_reduction_x']}x less than replicated)  "
                      f"[{r['device']}; {card}]")
                check(math.isfinite(r["final_loss"]), "non-finite bench loss")
            mnist_profile(world, card)
        finally:
            tdx.destroy_process_group()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = mnist.main(["--epochs", "1"])
    text = buf.getvalue()
    print("  example: " + "\n  example: ".join(text.strip().splitlines()))
    check(f"world_size={MNIST_WORLD}" in text and "Epoch: 1/1, train loss:" in text,
          "the MNIST example did not print its epoch line at world 8")
    check(all(math.isfinite(v) for v in trainer.losses), "non-finite loss in the example")
    torch.cuda.empty_cache()


def rel_rms(got, want):
    return float((got.float() - want.float()).pow(2).mean().sqrt()
                 / want.float().pow(2).mean().sqrt().clamp_min(1e-30))


def shard_3d(model, lr, dims):
    """`model` fully sharded over a ("dp", "fsdp", "tp") mesh of `dims` on
    its device, as the reference's dry run shards it (the batch over dp and
    fsdp), with the trainer's AdamW step as `.step`; as `lm.shard`, the
    model's own weights move to the meta device."""
    device = next(model.parameters()).device
    mesh = tdx.DeviceMesh([device] * math.prod(dims), dims, ("dp", "fsdp", "tp"))
    mod = fully_shard(model, None, mesh, axis="fsdp",
                      rules=transformer_sharding_rules("tp", "fsdp"), data_axes=("dp", "fsdp"))
    model.to("meta")
    mod.step = mod.make_train_step(lm.adamw(lr), lm.loss_fn)
    return mod


def sharded_first_step(argv, grads=True, dims=None):
    """The trainer (`examples/lm.py`) over fsdp 2 x tp 2 (or the ("dp",
    "fsdp", "tp") mesh of `dims`) in driver mode on cuda:0, from the
    weights of a single-card model: its first step's loss and every
    gathered gradient against that model's, held to the bf16 tolerance
    (the gradients only with `grads`). Returns (the FSDPModule, its
    optimizer, next_tokens, args, param count, the first loss)."""
    args = lm.parse_args(argv)
    # the single-card model and token stream: the weights the sharded
    # trainer's own build would make (init seed 0)
    model, _, next_tokens = lm.build(lm.parse_args([*argv, "--tp", "1"]), world=1)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    tokens = next_tokens()
    loss1 = lm.loss_fn(model(tokens), tokens)
    loss1.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    loss1 = float(loss1.detach())
    for p in model.parameters():
        p.grad = None
    mod = (lm.shard(model, args.lr, FSDP_TP_WORLD, FSDP_TP_TP) if dims is None
           else shard_3d(model, args.lr, dims))
    opt = mod.step.init_opt_state(mod.params)
    mesh = " x ".join(f"{a} {n}" for a, n in zip(mod.mesh.axis_names, mod.mesh.shape))
    print(f"  config: vocab {cfg.vocab_size}, d {cfg.d_model}, layers {cfg.n_layers}, heads "
          f"{cfg.n_heads}, d_ff {cfg.ffn_dim}, experts {cfg.n_experts}, seq {args.seq}, global "
          f"batch {args.batch_size}, {cfg.dtype}; {n_params / 1e6:.1f}M params; mesh {mesh} "
          f"(driver mode on {mod.mesh.device})")
    loss = float(lm.train_step(mod, opt, tokens))
    worst, worst_name = 0.0, None
    for name, dt in mod.params.items():
        got = DTensor(dt._local.grad, dt.device_mesh, dt.placements).full_tensor()
        r = rel_rms(got, want[name])
        if r > worst:
            worst, worst_name = r, name
    del want
    print(f"  first step against the single card on the same weights and tokens: loss "
          f"{loss:.5f} vs {loss1:.5f}; largest rms(grad diff)/rms(grad) {worst:.3e} "
          f"({worst_name}){'' if grads else ', not checked'}")
    check(abs(loss - loss1) <= SHARDED_LOSS_TOL and (worst <= SHARDED_GRAD_RMS or not grads),
          f"the sharded step disagrees with the single card beyond the bf16 tolerance "
          f"(|dloss| <= {SHARDED_LOSS_TOL}, rms ratio <= {SHARDED_GRAD_RMS})")
    return mod, opt, next_tokens, args, n_params, loss


def sharded_train(argv, card, timed_steps, grads=True, dims=None):
    """`sharded_first_step`, then three steps with a finite, falling loss,
    `timed_steps` timed steps, and one profiled step whose launches are
    counted. Returns (routes of the profiled step, aux of the MoE layers or
    None)."""
    mod, opt, next_tokens, args, n_params, first = sharded_first_step(argv, grads, dims)
    cfg = mod.module.cfg
    losses = [first]
    for _ in range(FSDP_TP_STEPS - 1):
        losses.append(float(lm.train_step(mod, opt, next_tokens())))
    print(f"  losses of the first {FSDP_TP_STEPS} steps: {losses}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "the sharded trainer's loss is not finite and falling")
    # the step after the checked ones still ran ~40% slow on the H100
    for _ in range(WARMUP_STEPS):
        lm.train_step(mod, opt, next_tokens())
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(timed_steps):
        batch = next_tokens()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = lm.train_step(mod, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check(math.isfinite(float(loss)), "non-finite loss in a timed step")
    peak = torch.cuda.max_memory_allocated()
    mean_s = sum(step_s) / len(step_s)
    model_flops = ((6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * args.seq)
                   * args.batch_size * args.seq)
    mem = mod.step.memory_report(mod.params, opt)
    print(f"  step times (s) {step_s}; mean step {mean_s * 1e3:.2f} ms, "
          f"{args.batch_size * args.seq / mean_s:.0f} tokens/s, MFU "
          f"{model_flops / mean_s / PEAK_FLOPS[torch.bfloat16]:.4f} (as the slice counts it), "
          f"peak memory {peak / 2 ** 30:.2f} GiB  [{card}]")
    print(f"  per rank: params {mem['param_bytes_per_device']} bytes of "
          f"{mem['param_bytes']}, optimizer state {mem['opt_state_bytes_per_device']} of "
          f"{mem['opt_state_bytes']} ({mem['opt_state_reduction_x']}x less than replicated)")
    aux = getattr(mod.module, "sharded_aux", None)
    if cfg.n_experts:
        aux = [float(a.detach()) for a in aux]
        print(f"  MoE load-balance aux by layer (last step): {aux}")
        check(len(aux) == cfg.n_layers and all(math.isfinite(a) for a in aux), "bad MoE aux")
    print("[profile] one more step under torch.profiler; its launches counted")
    fa.reset_launch_counts()
    tokens = next_tokens()
    profile_step(lambda: lm.train_step(mod, opt, tokens), mean_s * 1e3)
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    print(f"  launches in the profiled step: {launches}; by route: {routes}")
    check(all(launches[n] == cfg.n_layers for n in REPLACES),
          f"F, KV and Q should launch once a layer for all {mod.mesh.size} ranks: {launches}")
    check(routes == want_routes(cfg.n_layers),
          f"F, KV and Q should all take the wgmma route: {routes}")
    del mod, opt
    torch.cuda.empty_cache()
    return routes, aux


def ep_moe_check(T_=4096, D=2048, F_=5504, E=EP_EXPERTS, device="cuda"):
    """`make_ep_moe` over EP_WORLD ranks in driver mode on cuda:0, at CFG_1B's
    width (the slice's 4096 tokens, d 2048, d_ff 5504, 8 experts, bf16),
    against its plain single-rank computation: each rank's tokens through
    `moe_mlp` over every expert, the aux the ranks' mean."""
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(T_, D, device=device, generator=gen).to(torch.bfloat16)
    up = (torch.randn(E, D, F_, device=device, generator=gen) / math.sqrt(D)).to(torch.bfloat16)
    down = (torch.randn(E, F_, D, device=device, generator=gen) / math.sqrt(F_)).to(
        torch.bfloat16)
    router = torch.randn(D, E, device=device, generator=gen) / math.sqrt(D)
    mesh = tdx.DeviceMesh([device] * EP_WORLD, (EP_WORLD,), ("ep",))
    y, aux = ep.make_ep_moe(mesh, "ep")(x, up, down, router)
    rows = [ep.moe_mlp(xr, up, down, router) for xr in x.chunk(EP_WORLD)]
    want = torch.cat([r[0] for r in rows])
    want_aux = sum(float(r[1]) for r in rows) / EP_WORLD
    r = rel_rms(y, want)
    print(f"  make_ep_moe at {EP_WORLD} ep ranks, {T_} tokens, d {D}, d_ff {F_}, {E} experts, "
          f"bf16: rms(diff)/rms {r:.3e}, max |diff| {float((y - want).abs().max()):.3e}; aux "
          f"{float(aux):.6f} vs {want_aux:.6f}")
    check(y.shape == (T_, D) and bool(torch.isfinite(y).all()) and r <= 1e-2
          and abs(float(aux) - want_aux) <= 1e-5,
          "make_ep_moe disagrees with its single-rank computation (rms ratio <= 1e-2, "
          "|daux| <= 1e-5)")


def fsdp_tp_phase(card):
    """The sharded trainer, dense at CFG_1B's full width and depth and MoE
    at full width with 4 layers, then the ep-sharded MoE. Returns the
    dense profiled step's routes."""
    print("  dense:")
    routes, _ = sharded_train(FSDP_TP_ARGV, card, TIMED_STEPS)
    print("  MoE (8 experts, top-1, capacity 1.25; depth cut to 4 layers), float32 first "
          "step:")
    # in bf16 the tp ranks' rounding can move a token to another expert (a
    # discrete choice), whose experts' gradients then differ by far more
    # than rounding; in float32 (TF32 off) the routing is the single
    # card's, and the step is held to it, gradients included
    sharded_first_step([a for a in MOE_ARGV if a != "--bf16"])
    torch.cuda.empty_cache()
    print("  MoE, bf16 (loss against the single card; timed):")
    sharded_train(MOE_ARGV, card, TIMED_STEPS, grads=False)
    ep_moe_check()
    return routes


# serving: the KV-cache decode path, generate() and the paged engine
SERVE_SMALL = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   max_seq_len=64, use_flash=False)
# CFG_1B (benchmarks/llama_scaled.py:33) at max_seq_len 2048, bf16
SERVE_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "16",
              "--n-heads", "16", "--seq", "2048", "--bf16"]
SERVE_SLOTS, SERVE_BLOCK = 8, 16
SERVE_GATE = (4, 512)  # prompts x tokens for the decode-path logits gate
SERVE_RMS_TOL = 3e-2  # the flash-vs-dense gate of PERF.md section 2
SERVE_REQUESTS = 48
# the preemption-determinism run: prompts of 256 or 512 tokens, so every
# prefill chunk is 256 wide whatever shares its step (equal program shapes
# in both runs), and 192 blocks (3072 tokens) against up to 8 x 640 tokens
DETERMINISM_CHUNK, DETERMINISM_POOL = 256, 192


def bimodal_traffic(n, seed=0, prompt_lens=None):
    """`benchmarks/serve_bench.py::make_traffic(n, 0.0, seed)` (one burst):
    prompts of 8-64 tokens, 70% of requests wanting 8-16 new tokens and
    30% 96-128; prompt tokens from the same numpy generator afterwards.
    `prompt_lens` replaces the prompt lengths."""
    gen = np.random.default_rng(seed)
    lens = gen.integers(8, 65, n)
    is_long = gen.random(n) < 0.3
    new = np.where(is_long, gen.integers(96, 129, n), gen.integers(8, 17, n))
    if prompt_lens is not None:
        lens = prompt_lens
    return [(gen.integers(0, 32000, int(lens[i])).astype(np.int32), int(new[i]), i)
            for i in range(n)]


def serve_run(model, traffic, **kw):
    """Submit every request at once and run the engine dry; returns the
    engine and the host seconds."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for prompt, budget, seed in traffic:
        eng.submit(prompt, budget, rid=f"r{seed}", seed=seed)
    eng.run(max_steps=100000)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def serve_small_check():
    """A small float32 model (GQA) on the card against the same weights on
    the CPU, TF32 off: decode-path prefill logits, generate() greedy and
    sampled, and a 12-request engine trace with preemptions, chunked
    prefill and the prefix cache, float and int8 pools."""
    from pytorch_distributed_example_tpu_torch.models import generate, init_cache

    cfg = TransformerConfig(**SERVE_SMALL)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = np.random.default_rng(0)
    prompts = torch.as_tensor(gen.integers(0, 64, (3, 24)))
    with torch.no_grad():
        want = cpu(prompts, decode=True, cache=init_cache(cpu, 3))
        got = card(prompts.cuda(), decode=True, cache=init_cache(card, 3)).cpu()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    print(f"  small f32 decode-path prefill: card vs CPU max_abs_err {err:.3e} (max|cpu| "
          f"{top:.3e})")
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top),
          "decode-path logits on the card disagree with the CPU")
    for kw in (dict(), dict(temperature=0.8, top_k=8)):
        a = generate(cpu, prompts[:, :10], 40, **kw)
        b = generate(card, prompts[:, :10].cuda(), 40, **kw).cpu()
        check(torch.equal(a, b), f"generate({kw}) on the card gives other tokens than the CPU")
    print("  generate() greedy and sampled (T 0.8, top-k 8): the card's tokens are the CPU's")
    preamble = gen.integers(0, 64, 12).astype(np.int32)
    traffic = [(np.concatenate([preamble, gen.integers(0, 64, int(gen.integers(2, 20)))])
                .astype(np.int32), int(gen.integers(4, 24)), i) for i in range(12)]
    for quant in (False, True):
        kw = dict(slots=4, block_size=8, pool_blocks=14, prefill_chunk_tokens=8,
                  min_bucket=8, prefix_cache=True, kv_quant=quant)
        runs = [serve_run(m, traffic, **kw)[0] for m in (cpu, card)]
        outs = [{r: c.tokens for r, c in e.completions.items()} for e in runs]
        pre = [e.metrics.preempted for e in runs]
        check(len(outs[1]) == len(traffic) and outs[0] == outs[1],
              f"engine (kv_quant={quant}) on the card gives other completions than the CPU")
        check(pre[0] == pre[1] and pre[1] > 0, f"preemptions {pre}: none, or unequal")
        print(f"  engine, 12 requests, chunk 8, prefix cache, kv_quant={quant}: card == CPU "
              f"token for token; {pre[1]} preemptions, {runs[1].prefix.stats()['hits']} "
              f"prefix hits")


def serve_logits_gate(model):
    """Prefill logits through the decode path (dense cache, dense attention)
    against the train path's forward (flash) on the same weights."""
    from pytorch_distributed_example_tpu_torch.models import init_cache

    B, L = SERVE_GATE
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 32000, (B, L)), device="cuda")
    with torch.no_grad():
        dec = model(toks, decode=True, cache=init_cache(model, B))
        ref = model(toks)
    r = rel_rms(dec, ref)
    check(bool(torch.isfinite(dec).all()) and dec.shape == (B, L, 32000), "bad decode logits")
    print(f"  logits gate: {B} prompts x {L}, decode path vs the flash forward: "
          f"rms(diff)/rms = {r:.4e} (<= {SERVE_RMS_TOL})")
    check(r <= SERVE_RMS_TOL, "decode-path logits stray from the train path")


def serve_profile(model, card):
    """One steady decode step of 8 slots: its time by CUDA events and on the
    host, then under torch.profiler (device busy share, launches, top
    kernels, and the paged gather's share), and the gather alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pytorch_distributed_example_tpu_torch.models import transformer as ttr
    from pytorch_distributed_example_tpu_torch.ops import gather_paged_kv
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, slots=SERVE_SLOTS, block_size=SERVE_BLOCK, min_bucket=8)
    gen = np.random.default_rng(2)
    for i in range(SERVE_SLOTS):
        eng.submit(gen.integers(0, 32000, 48).astype(np.int32), 200, rid=f"p{i}", seed=i)
    for _ in range(6):  # admit and prefill all 8, then decode
        eng.step()
    check(len(eng._decoding) == SERVE_SLOTS, "profile engine not at 8 decoding slots")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        eng.step()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    ev_ms = start.elapsed_time(end) / 10
    real = ttr.gather_paged_kv

    def annotated(*a, **k):
        with record_function("gather_paged_kv"):
            return real(*a, **k)

    ttr.gather_paged_kv = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
    finally:
        ttr.gather_paged_kv = real
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    gather = sum(e.device_time_total for e in prof.events()
                 if e.name == "gather_paged_kv"
                 and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    print(f"  decode step, 8 slots: {ev_ms:.4f} ms by CUDA events, {host_ms:.4f} ms on the "
          f"host (mean of 10 engine steps)  [{card}]")
    if not busy:
        print("  profiler saw no device time: busy share not measured")
    else:
        print(f"  profiled step {pwall:.4f} ms: device busy {busy:.4f} ms ({busy / pwall:.1%}), "
              f"{sum(n for _, n, _ in rows)} kernel launches; gather_paged_kv "
              f"{gather:.4f} ms ({gather / busy:.1%} of device time)")
        for ms, n, key in rows[:10]:
            print(f"    {ms:9.4f} ms {ms / busy:6.1%} x{n:<4d} {key[:90]}")
    attn = eng.cache.tree["layers_0"]["attn"]
    bt = torch.as_tensor(eng.cache.block_tables, device="cuda")
    g_ms = time_ms(lambda: gather_paged_kv(attn["k"], attn["v"], bt), iters=20)
    moved = 2 * 2 * bt.numel() * SERVE_BLOCK * attn["k"].shape[2] * attn["k"].shape[3] * 2
    print(f"  gather_paged_kv alone, one layer at (8, {bt.shape[1]}) tables: {g_ms:.4f} ms "
          f"({moved / g_ms / 1e6:.1f} GB/s over {moved / 1e6:.1f} MB read + written); "
          f"x{model.cfg.n_layers} = {g_ms * model.cfg.n_layers:.4f} ms a step")


def serve_timing(model, card, quant, want=None):
    """The bimodal burst through the engine, unchunked, 8 slots; returns
    the completions."""
    from pytorch_distributed_example_tpu_torch.serve.metrics import percentile

    traffic = bimodal_traffic(SERVE_REQUESTS)
    torch.cuda.reset_peak_memory_stats()
    eng, wall = serve_run(model, traffic, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                          min_bucket=8, kv_quant=quant)
    m = eng.metrics
    out = {r: c.tokens for r, c in eng.completions.items()}
    check(len(out) == SERVE_REQUESTS, "bimodal run lost requests")
    ms = {f"{name}_p{q}": percentile(values, q) * 1e3
          for name, values in (("ttft", m.ttft_s), ("tpot", m.tpot_s)) for q in (50, 99)}
    print(f"  bimodal, kv_quant={quant}: {SERVE_REQUESTS} requests, {m.tokens_completed} "
          f"tokens in {wall:.4f} s = {m.tokens_completed / wall:.2f} tok/s; {m.steps} steps; "
          f"TTFT p50 {ms['ttft_p50']:.3f} / p99 {ms['ttft_p99']:.3f} ms, TPOT p50 "
          f"{ms['tpot_p50']:.3f} / p99 {ms['tpot_p99']:.3f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; pool "
          f"{eng.cache.num_blocks} blocks x {eng.cache.bytes_per_block} B = "
          f"{eng.cache.num_blocks * eng.cache.bytes_per_block / 2**30:.3f} GiB  [{card}]")
    if want is not None:
        match = sum(a == b for r in want for a, b in zip(want[r], out[r]))
        total = sum(len(v) for v in want.values())
        print(f"  int8 pool against the float pool: {match} of {total} greedy tokens match "
              f"({match / total:.2%}; reported, not gated)")
    return out


def serve_phase(card):
    """Serving: small float32 card-against-CPU checks, then CFG_1B at full
    width in bf16: the logits gate, token-identical greedy streams between
    a full and a preemption-forcing pool, the bimodal timings, a profiled
    decode step, and the generate example. No flash kernel may launch on
    the serve path."""
    from pytorch_distributed_example_tpu_torch.examples import generate as gen_example

    serve_small_check()
    args = lm.parse_args(SERVE_ARGV)
    model = TransformerLM(lm.config_for(args), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    serve_logits_gate(model)
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    lens = 256 * np.random.default_rng(3).integers(1, 3, SERVE_REQUESTS)
    traffic = bimodal_traffic(SERVE_REQUESTS, prompt_lens=lens)
    runs = []
    for pool in (None, DETERMINISM_POOL):
        eng, wall = serve_run(model, traffic, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                              pool_blocks=pool, prefill_chunk_tokens=DETERMINISM_CHUNK,
                              min_bucket=8)
        runs.append(({r: c.tokens for r, c in eng.completions.items()}, eng.metrics.preempted))
        print(f"  determinism: {SERVE_REQUESTS} requests (prompts 256/512), chunk "
              f"{DETERMINISM_CHUNK}, pool {eng.cache.num_blocks} blocks: "
              f"{eng.metrics.preempted} preemptions, {eng.metrics.steps} steps, {wall:.2f} s")
    check(runs[0][1] == 0 and runs[1][1] > 0, "the cut pool did not preempt (or the full did)")
    check(len(runs[0][0]) == SERVE_REQUESTS and runs[0][0] == runs[1][0],
          "greedy streams differ between the full and the preemption-forcing pool")
    print("  every request's greedy tokens are identical across the two pools")
    want = serve_timing(model, card, quant=False)
    serve_timing(model, card, quant=True, want=want)
    serve_profile(model, card)
    del model
    torch.cuda.empty_cache()
    out = gen_example.main(["--steps", "60", "--new", "24"])
    check(len(out["tokens"]) == 24, "the generate example did not generate")
    launches = dict(fa.LAUNCHES)
    print(f"  flash launches on the serve path: {launches}")
    check(sum(launches.values()) == 0, "a flash kernel launched on the serve path")


# serving across ranks and pools: tensor-parallel decode, disaggregated
# prefill/decode with KV migration, and the replica router
FLEET_TP = 2
FLEET_DET_REQUESTS = 16  # the determinism construct's requests (prompts 256/512, chunk 256)
# benchmarks/serve_bench.py --trace disagg at its defaults (:703-800)
DISAGG_STEADY, DISAGG_BURST, DISAGG_CHUNK, DISAGG_SLOTS = 16, 32, 32, 18
ROUTER_REPLICAS = 2


def tp_mesh(T, device="cuda"):
    """A driver-mode ("tp", T) mesh: the one card T times."""
    return tdx.DeviceMesh([device] * T, (T,), ("tp",))


def sync():
    torch.cuda.synchronize()


def completions(eng):
    return {r: c.tokens for r, c in eng.completions.items()}


def match_rate(want, got):
    """(equal tokens, total tokens, equal requests) of `got` against `want`."""
    same = sum(a == b for r in want for a, b in zip(want[r], got.get(r, [])))
    return same, sum(len(v) for v in want.values()), sum(want[r] == got.get(r) for r in want)


def determinism_traffic(n):
    """The bimodal new-token mix on prompts of 256 or 512 tokens, so with
    prefill chunks of 256 every chunk is 256 wide whatever shares its step
    (the [serve] phase's construct for bf16 token equality)."""
    lens = 256 * np.random.default_rng(3).integers(1, 3, n)
    return bimodal_traffic(n, prompt_lens=lens)


@contextlib.contextmanager
def patched(owner, name, wrap):
    """Replace `owner.name` by `wrap(original)` for the block."""
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def fleet_small_check():
    """A small float32 model (GQA, 2 KV heads) on the card against the
    CPU, TF32 off: the tp 2 engine's greedy tokens equal the single
    engine's and the CPU's, float and int8 pools; a 1 x 1 DisaggRouter
    over the port's HashStore gives the colocated engine's completions,
    greedy and sampled, one migration a request; a republished migration
    is byte for byte the first (bf16 and int8 pools)."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine
    from pytorch_distributed_example_tpu_torch.serve.disagg import DisaggRouter, send_handoff
    from pytorch_distributed_example_tpu_torch.store import HashStore

    cfg = TransformerConfig(**SERVE_SMALL)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = np.random.default_rng(5)
    traffic = [(gen.integers(0, 64, int(gen.integers(4, 30))).astype(np.int32),
                int(gen.integers(4, 24)), i) for i in range(12)]
    for quant in (False, True):
        kw = dict(slots=4, block_size=8, pool_blocks=14, prefill_chunk_tokens=8, min_bucket=8,
                  kv_quant=quant)
        runs = [serve_run(cpu, traffic, **kw)[0], serve_run(card, traffic, **kw)[0],
                serve_run(card, traffic, mesh=tp_mesh(FLEET_TP), **kw)[0]]
        outs = [completions(e) for e in runs]
        check(len(outs[0]) == len(traffic) and outs[0] == outs[1] == outs[2],
              f"tp {FLEET_TP} engine (kv_quant={quant}) on the card gives other tokens than "
              f"the single engine or the CPU")
        print(f"  tp {FLEET_TP} engine, 12 requests, chunk 8, kv_quant={quant}: tokens == the "
              f"card's single engine == the CPU's; {runs[2].metrics.preempted} preemptions")
    kw = dict(slots=4, block_size=8, pool_blocks=64, prefill_chunk_tokens=8, min_bucket=8)
    for sampling in (dict(), dict(temperature=0.8, top_k=8)):
        colo = serve_run(card, traffic, **kw, **sampling)[0]
        router = DisaggRouter(HashStore(),
                              lambda i: ServeEngine(card, role="prefill", **kw, **sampling),
                              lambda i: ServeEngine(card, role="decode", **kw, **sampling),
                              chunk_blocks=2)
        for prompt, budget, seed in traffic:
            router.submit(prompt, budget, rid=f"r{seed}", seed=seed)
        got = {r: c.tokens for r, c in router.run(max_steps=100000).items()}
        check(got == completions(colo) and router.migrations == len(traffic),
              f"disagg 1 x 1 ({sampling or 'greedy'}) differs from the colocated engine, or "
              f"migrations {router.migrations} != {len(traffic)}")
        print(f"  disagg 1 x 1 over HashStore, {sampling or 'greedy'}: completions == the "
              f"colocated engine's; {router.migrations} migrations")
    bf16 = TransformerLM(dataclasses.replace(cfg, dtype=torch.bfloat16), device="cuda")
    bf16.load_state_dict(cpu.state_dict())
    for quant in (False, True):
        src = ServeEngine(bf16, role="prefill", kv_quant=quant, **kw)
        src.submit(traffic[0][0], 5, rid="m0", seed=0)
        handoffs = []
        while not handoffs:
            src.step()
            handoffs = src.pop_handoffs()
        store = HashStore()
        n = send_handoff(store, src, handoffs[0], chunk_blocks=1)
        keys = ["serve/migrate/m0"] + [f"serve/migrate/m0/chunk{i}" for i in range(n)]
        first = [store.get(k) for k in keys]
        check(send_handoff(store, src, handoffs[0], chunk_blocks=1) == n
              and [store.get(k) for k in keys] == first,
              f"a republished migration ({src.cache.wire_dtype} pool) is not byte-identical")
        print(f"  republished migration, {src.cache.wire_dtype} pool: {n} chunks and the "
              f"manifest byte-identical ({sum(map(len, first))} bytes)")


def engine_prefill_logits(eng, toks):
    """Each row of `toks` prefilled whole through `eng`'s own paged prefill
    program into a fresh slot; the (B, L, V) logits, float32."""
    out = []
    for row in toks:
        slot = eng.cache.allocate()
        check(eng.cache.ensure_blocks(slot, len(row) - 1), "logits gate: pool too small")
        _, logits = eng._prefill_chunk(eng.cache.tree, row[None],
                                       eng.cache.block_tables[slot:slot + 1], 0)
        out.append(logits.float())
        eng.cache.free(slot)
    return torch.stack(out)


def fleet_bimodal(model, card, mesh=None):
    """The [serve] phase's bimodal burst (48 requests, 8 slots, unchunked)
    through a tp 1 or a tp `mesh` engine: tok/s, TTFT and TPOT p50/p99,
    pool bytes a rank, peak memory. Returns (completions, tok/s)."""
    from pytorch_distributed_example_tpu_torch.serve.metrics import percentile

    T = 1 if mesh is None else mesh.shape[0]
    torch.cuda.reset_peak_memory_stats()
    eng, wall = serve_run(model, bimodal_traffic(SERVE_REQUESTS), slots=SERVE_SLOTS,
                          block_size=SERVE_BLOCK, min_bucket=8, mesh=mesh)
    m = eng.metrics
    out = completions(eng)
    check(len(out) == SERVE_REQUESTS, f"tp {T} bimodal run lost requests")
    ms = {f"{name}_p{q}": percentile(values, q) * 1e3
          for name, values in (("ttft", m.ttft_s), ("tpot", m.tpot_s)) for q in (50, 99)}
    rate = m.tokens_completed / wall
    print(f"  bimodal, tp {T}: {SERVE_REQUESTS} requests, {m.tokens_completed} tokens in "
          f"{wall:.4f} s = {rate:.2f} tok/s; {m.steps} steps; TTFT p50 {ms['ttft_p50']:.3f} / "
          f"p99 {ms['ttft_p99']:.3f} ms, TPOT p50 {ms['tpot_p50']:.3f} / p99 "
          f"{ms['tpot_p99']:.3f} ms; pool {eng.cache.num_blocks * eng.cache.bytes_per_block / T / 2**30:.3f} "
          f"GiB a rank ({T} rank{'s' if T > 1 else ''}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    return out, rate


TP_SPANS = ("tp.column", "tp.row_partials", "tp.row_sum", "tp.gather")


def fleet_tp_profile(model, card):
    """One steady 8-slot tp 2 decode step: CUDA events over 10 engine
    steps, then one step under torch.profiler with the tp seams annotated
    (the column products, the row-parallel float32 partials, their sum
    over the rank dim, the all-gathers of the embedding and the logits)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pytorch_distributed_example_tpu_torch.nn import functional as nnf
    from pytorch_distributed_example_tpu_torch.parallel import tensor_parallel as tpm
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    eng = ServeEngine(model, slots=SERVE_SLOTS, block_size=SERVE_BLOCK, min_bucket=8,
                      mesh=tp_mesh(FLEET_TP))
    gen = np.random.default_rng(2)
    for i in range(SERVE_SLOTS):
        eng.submit(gen.integers(0, 32000, 48).astype(np.int32), 200, rid=f"p{i}", seed=i)
    for _ in range(6):
        eng.step()
    check(len(eng._decoding) == SERVE_SLOTS, "tp profile engine not at 8 decoding slots")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        eng.step()
    end.record()
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    ev_ms = start.elapsed_time(end) / 10

    def span(label):
        def wrap(real):
            def annotated(*a, **k):
                with record_function(label):
                    return real(*a, **k)
            return annotated
        return wrap

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(tpm, "column_parallel", span("tp.column")))
        stack.enter_context(patched(tpm, "_bmm_f32", span("tp.row_partials")))
        stack.enter_context(patched(nnf, "all_reduce", span("tp.row_sum")))
        stack.enter_context(patched(nnf, "all_gather", span("tp.gather")))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            sync()
            pwall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    spans = {label: sum(e.device_time_total for e in prof.events()
                        if e.name == label and e.device_type == torch.autograd.DeviceType.CPU)
             / 1e3 for label in TP_SPANS}
    print(f"  tp {FLEET_TP} decode step, 8 slots: {ev_ms:.4f} ms by CUDA events, "
          f"{host_ms:.4f} ms on the host (mean of 10 engine steps)  [{card}]")
    if not busy:
        print("  profiler saw no device time: busy share not measured")
    else:
        print(f"  profiled step {pwall:.4f} ms: device busy {busy:.4f} ms ({busy / pwall:.1%}), "
              f"{sum(n for _, n, _ in rows)} kernel launches; by tp seam: "
              + ", ".join(f"{k} {v:.4f} ms ({v / busy:.1%})" for k, v in spans.items()))
        for ms, n, key in rows[:10]:
            print(f"    {ms:9.4f} ms {ms / busy:6.1%} x{n:<4d} {key[:90]}")
    del eng
    torch.cuda.empty_cache()


def fleet_redistribute(model, card, want_logits, toks):
    """`dtensor.redistribute_for_serving` from the trainer's fsdp 2 x tp 2
    layout (`lm.shard`, the [fsdp_tp] phase's, of the same seed-0 weights
    as `model`) to a tp 2 engine's: the move's peak memory above what was
    allocated before it may hold the serve layout (one copy of the
    weights) and one leaf more, no replicated copy; the engine's prefill
    logits match the single-card engine's (`want_logits`)."""
    from pytorch_distributed_example_tpu_torch.dtensor import redistribute_for_serving
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    args = lm.parse_args(SERVE_ARGV)
    trainer = TransformerLM(lm.config_for(args), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    mod = lm.shard(trainer, args.lr, FSDP_TP_WORLD, FSDP_TP_TP)
    params = mod.params
    param_bytes = sum(math.prod(p.shape) * p.dtype.itemsize for p in params.values())
    biggest = max(math.prod(p.shape) * p.dtype.itemsize for p in params.values())
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve_params = redistribute_for_serving(params, tp_mesh(FLEET_TP))
    sync()
    move_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    print(f"  redistribute_for_serving, fsdp {FSDP_TP_WORLD // FSDP_TP_TP} x tp {FSDP_TP_TP} -> "
          f"tp {FLEET_TP}: {move_s * 1e3:.1f} ms; peak {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB before the move, {held / 2**30:.3f} GiB held after; the "
          f"weights {param_bytes / 2**30:.3f} GiB, the largest leaf {biggest / 2**20:.1f} MiB  "
          f"[{card}]")
    check(peak <= param_bytes + biggest,
          "the move held more than the serve layout and one leaf: a replicated copy was made")
    del mod, params, trainer
    torch.cuda.empty_cache()
    eng = ServeEngine(model, slots=len(toks), block_size=SERVE_BLOCK, min_bucket=8,
                      mesh=tp_mesh(FLEET_TP), params=serve_params)
    del serve_params
    r = rel_rms(engine_prefill_logits(eng, toks), want_logits)
    print(f"  the redistributed tp {FLEET_TP} engine's prefill logits vs the single-card "
          f"engine's: rms(diff)/rms = {r:.4e} (<= {SERVE_RMS_TOL})")
    check(r <= SERVE_RMS_TOL, "the redistributed weights' logits stray from the single card")
    del eng
    torch.cuda.empty_cache()


def fleet_tp(model, card):
    """Tensor-parallel decode at CFG_1B, tp 2 in driver mode: the prefill
    logits gate against the single-card engine, the bimodal burst at tp 1
    and tp 2, a profiled tp 2 step, and the move from the trainer's
    layout. Returns the tp 1 tok/s."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    B, L = SERVE_GATE
    toks = np.random.default_rng(1).integers(0, 32000, (B, L)).astype(np.int32)
    kw = dict(slots=B, block_size=SERVE_BLOCK, min_bucket=8)
    single = engine_prefill_logits(ServeEngine(model, **kw), toks)
    tp2 = engine_prefill_logits(ServeEngine(model, mesh=tp_mesh(FLEET_TP), **kw), toks)
    r = rel_rms(tp2, single)
    check(bool(torch.isfinite(tp2).all()) and tp2.shape == (B, L, 32000), "bad tp logits")
    print(f"  logits gate: {B} prompts x {L}, tp {FLEET_TP} engine vs the single-card engine "
          f"(prefill through the paged programs): rms(diff)/rms = {r:.4e} (<= {SERVE_RMS_TOL})")
    check(r <= SERVE_RMS_TOL, "tp decode logits stray from the single card")
    del tp2
    torch.cuda.empty_cache()
    out1, rate1 = fleet_bimodal(model, card)
    out2, rate2 = fleet_bimodal(model, card, mesh=tp_mesh(FLEET_TP))
    same, total, reqs = match_rate(out1, out2)
    print(f"  tp {FLEET_TP} against tp 1: {same} of {total} greedy tokens match ({same / total:.2%}), "
          f"{reqs} of {len(out1)} requests whole (reported, not gated); tok/s tp {FLEET_TP} / "
          f"tp 1 = {rate2 / rate1:.3f}")
    fleet_tp_profile(model, card)
    fleet_redistribute(model, card, single, toks)
    return rate1


def disagg_traffic():
    """`serve_bench.py --trace disagg`'s requests at its defaults: 16 steady
    (prompts 12-20, budget 48) and 32 burst (prompts 96-128, budget 3)."""
    gen = np.random.default_rng(0)
    steady = [(int(gen.integers(12, 21)), 48) for _ in range(DISAGG_STEADY)]
    burst = [(int(gen.integers(96, 129)), 3) for _ in range(DISAGG_BURST)]
    s = [(gen.integers(0, 32000, p).astype(np.int32), b, f"s{i}", i)
         for i, (p, b) in enumerate(steady)]
    b = [(gen.integers(0, 32000, p).astype(np.int32), n, f"b{i}", 1000 + i)
         for i, (p, n) in enumerate(burst)]
    return s, b


def steady_decoding(eng):
    return any(r is not None and r.rid.startswith("s") and s in eng._decoding
               for s, r in enumerate(eng._slot_req))


class MigrationClock:
    """Host time of each part of a migration, by wrapping the migration
    plane's seams: export (the device gather and copy to the host),
    pack/seal (npz, CRC), store (sets and gets), unseal/import (CRC check,
    npz read, the copy up and the scatter). The device parts synchronize
    first, so their queue does not leak into another part."""

    PARTS = ("export", "pack/seal", "store", "unseal/import")

    def __init__(self):
        self.ms = dict.fromkeys(self.PARTS, 0.0)
        self.blocks = 0
        self.bytes = 0

    def timed(self, part, device=False):
        def wrap(real):
            def run(*a, **k):
                if device:
                    sync()
                t0 = time.perf_counter()
                out = real(*a, **k)
                if device:
                    sync()
                self.ms[part] += (time.perf_counter() - t0) * 1e3
                return out
            return run
        return wrap

    @contextlib.contextmanager
    def attached(self, store):
        from pytorch_distributed_example_tpu_torch.serve import cache
        from pytorch_distributed_example_tpu_torch.serve.disagg import migrate

        clock = self

        def export_counted(real):
            def run(pool, ids):
                clock.blocks += len(ids)
                clock.bytes += len(ids) * pool.bytes_per_block
                return real(pool, ids)
            return run

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(cache.PagedKVCache, "export_blocks",
                                        lambda r: export_counted(self.timed("export", True)(r))))
            stack.enter_context(patched(cache.PagedKVCache, "import_blocks",
                                        self.timed("unseal/import", True)))
            for name in ("_pack_tree", "_seal_chunk"):
                stack.enter_context(patched(migrate, name, self.timed("pack/seal")))
            for name in ("_unseal_chunk", "_unpack_tree"):
                stack.enter_context(patched(migrate, name, self.timed("unseal/import")))
            for name in ("set", "get"):
                stack.enter_context(patched(store, name, self.timed("store")))
            yield self


def fleet_disagg(model, card):
    """`serve_bench.py --trace disagg` at CFG_1B: the steady requests
    decode, then the burst arrives; colocated (one chunked-prefill engine)
    against disagg (a prefill and a decode engine on the one card, sharing
    the model, over HashStore). The figure of merit is the decode steps'
    p99 while the steady requests decode under the burst. Then the
    determinism construct, where the two must agree token for token.
    Returns the colocated engine's completions on that construct."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine
    from pytorch_distributed_example_tpu_torch.serve.disagg import DisaggRouter
    from pytorch_distributed_example_tpu_torch.serve.metrics import percentile
    from pytorch_distributed_example_tpu_torch.store import HashStore

    steady, burst = disagg_traffic()
    n = len(steady) + len(burst)

    def mk(role, **kw):
        kw = dict(dict(slots=DISAGG_SLOTS, min_bucket=8, prefill_chunk_tokens=DISAGG_CHUNK,
                       block_size=SERVE_BLOCK), **kw)
        return ServeEngine(model, role=role, **kw)

    def submit(fn, reqs):
        for prompt, budget, rid, seed in reqs:
            fn(prompt, budget, rid=rid, seed=seed)

    warm = DisaggRouter(HashStore(), lambda i: mk("prefill"), lambda i: mk("decode"))
    submit(warm.submit, [(steady[0][0], 3, "w0", 0), (burst[0][0], 2, "w1", 0)])
    warm.run(max_steps=10000)
    del warm
    regimes = {}
    # colocated: one chunked-prefill engine
    colo = mk("both")
    submit(colo.submit, steady)
    sync()
    t0 = time.perf_counter()
    for _ in range(100000):
        if steady_decoding(colo) and not colo._prefilling:
            break
        colo.step()
    submit(colo.submit, burst)
    lat = []
    while colo.pending:
        s0 = time.perf_counter()
        colo.step()
        dt = time.perf_counter() - s0
        if steady_decoding(colo) and len(colo.completions) < n:
            lat.append(dt)
    sync()
    regimes["colocated"] = (time.perf_counter() - t0, lat, dict(colo.completions))
    del colo
    torch.cuda.empty_cache()
    # disagg: the decode pool's step time under the same burst
    store = HashStore()
    router = DisaggRouter(store, lambda i: mk("prefill"), lambda i: mk("decode"))
    mig = MigrationClock()
    with mig.attached(store):
        submit(router.submit, steady)
        sync()
        t0 = time.perf_counter()
        for _ in range(100000):
            if router.migrations >= len(steady):
                break
            router.step()
        submit(router.submit, burst)
        lat = []
        real_step = router.decode.step

        def timed_decode_step():
            s0 = time.perf_counter()
            busy = real_step()
            dt = time.perf_counter() - s0
            if steady_decoding(router.decode.engines()[0][1]) and len(router.completions) < n:
                lat.append(dt)
            return busy

        router.decode.step = timed_decode_step
        router.run(max_steps=100000)
        sync()
        span = time.perf_counter() - t0
    regimes["disagg"] = (span, lat, dict(router.completions))
    check(len(regimes["disagg"][2]) == n and router.migrations == n,
          f"disagg lost requests or migrations ({router.migrations} of {n})")
    for name, (span, lat, comps) in regimes.items():
        toks = sum(len(c.tokens) for c in comps.values())
        ttft = [c.ttft_s for c in comps.values()]
        tpot = [c.tpot_s for c in comps.values()]
        print(f"  disagg trace, {name}: {n} requests, {toks} tokens in {span:.4f} s = "
              f"{toks / span:.2f} tok/s; TTFT p50 {percentile(ttft, 50) * 1e3:.3f} / p99 "
              f"{percentile(ttft, 99) * 1e3:.3f} ms, TPOT p50 {percentile(tpot, 50) * 1e3:.3f} "
              f"/ p99 {percentile(tpot, 99) * 1e3:.3f} ms; decode steps under the burst: "
              f"{len(lat)}, p50 {percentile(lat, 50) * 1e3:.3f} / p99 "
              f"{percentile(lat, 99) * 1e3:.3f} ms  [{card}]")
    p99 = {k: percentile(v[1], 99) for k, v in regimes.items()}
    per = {k: v / router.migrations for k, v in mig.ms.items()}
    print(f"  decode-step p99 during the burst, colocated / disagg = "
          f"{p99['colocated'] / p99['disagg']:.3f}; {router.migrations} migrations, "
          f"{mig.blocks} blocks, {mig.bytes / 2**20:.1f} MiB ({mig.bytes / mig.blocks / 2**20:.3f} "
          f"MiB a block); ms a request: " + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
          + f"; total {sum(per.values()):.3f}  [{card}]")
    same, total, reqs = match_rate(*({r: c.tokens for r, c in regimes[k][2].items()}
                                     for k in ("colocated", "disagg")))
    print(f"  disagg trace token match against colocated: {same} of {total} tokens "
          f"({same / total:.2%}), {reqs} of {n} requests whole (reported, not gated)")
    del router, regimes
    torch.cuda.empty_cache()
    # the determinism construct: equal program shapes in both regimes
    traffic = determinism_traffic(FLEET_DET_REQUESTS)
    kw = dict(slots=SERVE_SLOTS, prefill_chunk_tokens=DETERMINISM_CHUNK)
    colo = serve_run(model, traffic, block_size=SERVE_BLOCK, min_bucket=8, **kw)[0]
    router = DisaggRouter(HashStore(), lambda i: mk("prefill", **kw),
                          lambda i: mk("decode", **kw))
    for prompt, budget, seed in traffic:
        router.submit(prompt, budget, rid=f"r{seed}", seed=seed)
    got = {r: c.tokens for r, c in router.run(max_steps=100000).items()}
    check(got == completions(colo) and router.migrations == len(traffic),
          "disagg differs from colocated on the determinism construct")
    print(f"  determinism construct ({len(traffic)} requests, prompts 256/512, chunk "
          f"{DETERMINISM_CHUNK}): disagg == colocated token for token, "
          f"{router.migrations} migrations")
    return completions(colo)


def fleet_router(model, card, one_engine_rate, want):
    """`ServeRouter` over 2 replicas on the card: the bimodal burst (tok/s
    against one engine, rebinds), then a mid-flight `remove_replica` on
    the determinism construct, its snapshot sealed into HashStore: every
    request completes with the greedy tokens of the unscaled run (`want`,
    one engine of the same slots and chunk on the same traffic)."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine, ServeRouter
    from pytorch_distributed_example_tpu_torch.serve.elastic import load_serve_state
    from pytorch_distributed_example_tpu_torch.store import HashStore

    def router(store=None, **kw):
        return ServeRouter(lambda i: ServeEngine(model, slots=SERVE_SLOTS,
                                                 block_size=SERVE_BLOCK, min_bucket=8, **kw),
                           replicas=ROUTER_REPLICAS, store=store)

    def submit(r, traffic):
        for prompt, budget, seed in traffic:
            r.submit(prompt, budget, rid=f"r{seed}", seed=seed, tenant=f"t{seed % 8}")

    r = router()
    sync()
    t0 = time.perf_counter()
    submit(r, bimodal_traffic(SERVE_REQUESTS))
    out = r.run(max_steps=100000)
    sync()
    wall = time.perf_counter() - t0
    check(len(out) == SERVE_REQUESTS, "the router lost requests")
    toks = sum(len(c.tokens) for c in out.values())
    print(f"  router, {ROUTER_REPLICAS} replicas of 8 slots, bimodal: {toks} tokens in "
          f"{wall:.4f} s = {toks / wall:.2f} tok/s ({toks / wall / one_engine_rate:.3f}x one "
          f"engine's {one_engine_rate:.2f}); {r.rebinds} rebinds  [{card}]")
    del r
    torch.cuda.empty_cache()
    traffic = determinism_traffic(FLEET_DET_REQUESTS)
    store = HashStore()
    r = router(store=store, prefill_chunk_tokens=DETERMINISM_CHUNK)
    submit(r, traffic)
    for _ in range(12):
        r.step()
    victim = r.remove_replica()
    state, gen = load_serve_state(store, key_prefix=f"serve/replica{victim}")
    got = {k: c.tokens for k, c in r.run(max_steps=100000).items()}
    check(state is not None and len(got) == len(traffic) and got == want,
          "scale-in mid-flight lost requests or changed greedy tokens")
    print(f"  router scale-in mid-flight on the determinism construct: replica {victim} "
          f"drained after 12 steps ({len(state['requests'])} accepted and "
          f"{len(state['queued'])} queued requests sealed as generation {gen}); all "
          f"{len(got)} requests complete with the greedy tokens of one unscaled engine")


def serve_fleet_phase(card):
    """Serving across ranks and pools: small float32 card-against-CPU
    checks, then CFG_1B at full width in bf16: tensor-parallel decode,
    the disagg trace and the replica router. No flash kernel may launch.
    Returns the phase's launch counts by route."""
    t0 = time.perf_counter()
    fleet_small_check()
    print(f"  small checks in {time.perf_counter() - t0:.1f} s")
    args = lm.parse_args(SERVE_ARGV)
    model = TransformerLM(lm.config_for(args), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    rate1 = fleet_tp(model, card)
    print(f"  tp decode in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    unscaled = fleet_disagg(model, card)
    print(f"  disagg in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet_router(model, card, rate1, unscaled)
    print(f"  router in {time.perf_counter() - t0:.1f} s")
    routes = dict(fa.ROUTE_LAUNCHES)
    print(f"  flash launches on the serve_fleet path: {dict(fa.LAUNCHES)}")
    check(sum(fa.LAUNCHES.values()) == 0, "a flash kernel launched on the serve_fleet path")
    del model
    torch.cuda.empty_cache()
    return routes


# ---------------------------------------------------------------------------
# [cifar] and [bert]: the BASELINE's ResNet-18/CIFAR-10 and BERT-base
# fine-tune workloads under driver-mode DDP at world 8 on cuda:0
# ---------------------------------------------------------------------------

DDP8 = 8
CIFAR_BATCH = 128  # a rank, as the reference's benchmarks/resnet_ddp.py
CIFAR_CHECK_BATCH = 4  # a rank, for the card-vs-CPU step
CIFAR_BENCH = dict(warmup=3, steps=5, windows=3)
BERT_BATCH, BERT_SEQ = 16, 128  # a rank, as the reference's benchmarks/bert_finetune.py
BERT_BENCH = dict(warmup=2, steps=3, windows=3)
# the card-vs-CPU checks: BERT at full width, its depth cut to 2 layers,
# 1 sequence of 32 tokens a rank (the CPU side runs the same step)
BERT_CHECK = dict(n_layers=2)
BERT_CHECK_BATCH, BERT_CHECK_SEQ, BERT_CHECK_LR = 2, 32, 1e-2
# float32 card against CPU (TF32 off on both): the loss within rtol 1e-5;
# each leaf's update (SGD, so linear in its gradient) within 1e-3 of the
# larger of its own rms and 1e-3 of the whole update's rms: the attention
# key biases take a zero gradient in exact arithmetic, rounding noise on
# both sides; the running statistics within rms ratio 1e-4
CARD_LOSS_RTOL, CARD_UPDATE_RMS, CARD_STATS_RMS = 1e-5, 1e-3, 1e-4
# within the card: microbatching changes the order of the sums as the CPU
# does (LayerNorm scales' gradients, sums of many products that cancel,
# moved 1.6e-4 on the card, where the CPU was 1.8e-4 away); remat repeats
# the same ops
ACCUM_UPDATE_RMS, REMAT_UPDATE_RMS = CARD_UPDATE_RMS, 1e-6
# a compressing hook's loss over 3 adamw steps against the stock hook's;
# PowerSGD at rank 2 sends a rank-2 approximation of each matrix and
# carries the rest in its error feedback, so its first steps move less:
# its 3-step loss drop must be at least half the stock hook's (on the H100
# it made 0.76 of it; the other hooks stay within 1%)
HOOK_LOSS_RTOL, POWERSGD_PROGRESS = 1e-2, 0.5
HOOKS = ("bf16_compress_hook", "fp16_compress_hook", "blockwise_quant_hook", "powerSGD_hook")


def make_hook(name):
    if name == "blockwise_quant_hook":
        return comm_hooks.blockwise_quant_hook(bits=8, error_feedback=True)
    if name == "powerSGD_hook":
        return comm_hooks.powerSGD_hook(rank=2)
    return getattr(comm_hooks, name)


def update_errors(new_a, new_b, old):
    """Each leaf's rms(update_a - update_b) over max(rms(update_b), 1e-3 *
    the whole update's rms): the worst (value, name). BERT's attention key
    biases are left out: their gradient is zero in exact arithmetic (q . b
    adds one constant to every key's score, which the softmax cancels), so
    both sides step on rounding noise."""
    upd = {n: new_b[n].float() - old[n].float() for n in old if "attn.key.bias" not in n}
    total = math.sqrt(sum(float(u.pow(2).sum()) for u in upd.values())
                      / sum(u.numel() for u in upd.values()))
    worst = (-1.0, "")
    for n, u in upd.items():
        diff = (new_a[n].float() - old[n].float()) - u
        scale = max(float(u.pow(2).mean().sqrt()), 1e-3 * total, 1e-30)
        worst = max(worst, (float(diff.pow(2).mean().sqrt()) / scale, n))
    return worst


def timed_events(fn, iters):
    """Mean ms of fn() by CUDA events over `iters` calls (warm already)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, step_ms, card, label, top=5):
    """One call of fn() under torch.profiler: the device's busy ms, its
    share of the profiled call and of `step_ms`, the launches, the top
    kernels. Returns (busy ms, launches), or (None, None) when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    total = sum(ms for ms, _, _ in rows)
    if not total:
        print(f"  {label}: profiler saw no device time: busy share not measured")
        return None, None
    # busy: the union of the kernels' intervals (a sum would count kernels
    # that overlap on other streams twice)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.time_range.end > e.time_range.start)
    busy, cur = 0.0, None
    for s, t in spans:
        if cur is None or s > cur[1]:
            busy += (cur[1] - cur[0]) if cur else 0.0
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy = (busy + (cur[1] - cur[0])) / 1e3 if cur else total
    launches = sum(n for _, n, _ in rows)
    print(f"  {label}: profiled step {pwall:.2f} ms, device busy {busy:.2f} ms ({busy / pwall:.1%}"
          f"; {busy / step_ms:.1%} of the {step_ms:.2f} ms event-timed step; kernel time "
          f"summed {total:.2f} ms), {launches} kernel launches  [{card}]")
    for ms, n, key in rows[:top]:
        print(f"    {ms:9.3f} ms {ms / total:6.1%} x{n:<5d} {key[:90]}")
    return busy, launches


def cifar_batch(batch, device):
    x, y = cifar.synthetic_cifar(batch * DDP8, 0)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device).long()


def cifar_first_step(device):
    """One step of the CIFAR example's train step at world 8 (SyncBN, SGD
    0.1 momentum 0.9, float32) on `device`: (params before, after, stats
    after, loss), on the host."""
    tdx.init_process_group(world_size=DDP8, device=None if device == "cuda" else device)
    try:
        model = cifar.build(device)
        params, stats = model.params_and_stats()
        opt = optim.sgd(0.1, momentum=0.9)
        step = cifar.make_train_step(model, opt)
        x, y = cifar_batch(CIFAR_CHECK_BATCH, device)
        p, s, _, loss = step(params, stats, opt.init(params), x, y)
        host = lambda d: {n: t.detach().cpu() for n, t in d.items()}  # noqa: E731
        return host(params), host(p), host(s), float(loss)
    finally:
        tdx.destroy_process_group()


def cifar_checks():
    old, gp, gs, gloss = cifar_first_step("cuda")
    _, cp, cs, closs = cifar_first_step("cpu")
    lerr = abs(gloss - closs) / abs(closs)
    uerr, uname = update_errors(gp, cp, old)
    serr, sname = max((rel_rms(gs[n], cs[n]), n) for n in cs)
    print(f"  first step, ResNet-18 (SyncBN) at world {DDP8} x {CIFAR_CHECK_BATCH}, float32, card "
          f"vs CPU: loss {gloss:.6f} vs {closs:.6f} (rel err {lerr:.2e}, limit "
          f"{CARD_LOSS_RTOL:g}); worst update error {uerr:.2e} ({uname}, limit "
          f"{CARD_UPDATE_RMS:g}); worst running-statistics rms ratio {serr:.2e} ({sname}, limit "
          f"{CARD_STATS_RMS:g})")
    check(lerr <= CARD_LOSS_RTOL and uerr <= CARD_UPDATE_RMS and serr <= CARD_STATS_RMS,
          "the CIFAR step on the card disagrees with the CPU")

    # the synced statistics are BN's over the global batch, in one forward
    tdx.init_process_group(world_size=DDP8)
    try:
        model = cifar.build("cuda")
        params, stats = model.params_and_stats()
        x, y = cifar_batch(CIFAR_CHECK_BATCH, "cuda")
        _, synced, _, _ = cifar.make_train_step(model, optim.sgd(0.0))(params, stats, {}, x, y)
        whole = cifar.build("cuda")
        convert_sync_batchnorm(whole, None)
        with torch.no_grad():
            _, want = whole(x, train=True)
        err, name = max((rel_rms(synced[n], want[n]), n) for n in want)
    finally:
        tdx.destroy_process_group()
    print(f"  synced running statistics at world {DDP8} vs BN over the {DDP8 * CIFAR_CHECK_BATCH}-"
          f"image global batch in one forward: worst rms ratio {err:.2e} ({name}, limit "
          f"{CARD_STATS_RMS:g})")
    check(err <= CARD_STATS_RMS, "the synced statistics are not the global batch's")


def cifar_phase(card):
    """ResNet-18/CIFAR-10 with SyncBN under driver-mode DDP at world 8:
    card-vs-CPU checks, then batch 128 a rank in float32 and bf16. Returns
    the phase's flash launches by route (none may launch)."""
    t0 = time.perf_counter()
    cifar_checks()
    print(f"  checks in {time.perf_counter() - t0:.1f} s")
    fa.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        tdx.init_process_group(world_size=DDP8)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # the bench's set-up and windows (`bench.bench_resnet_ddp`), then
            # the same step by CUDA events and under the profiler
            call, samples = bench.resnet_ddp_call(CIFAR_BATCH, dtype)
            rates, _, loss = bench.timed_windows(call, torch.device("cuda"), samples=samples,
                                            **CIFAR_BENCH)
            ms = timed_events(call, 3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            name = str(dtype).replace("torch.", "")
            print(f"  ResNet-18 world {DDP8} x {CIFAR_BATCH} ({DDP8 * CIFAR_BATCH} images a step), "
                  f"{name}: {bench.steady_rate(rates):.1f} samples/s per card (median of "
                  f"windows 2-{CIFAR_BENCH['windows']}: {[round(v, 1) for v in rates]}), step "
                  f"{ms:.2f} ms by CUDA events, final loss {float(loss):.4f}, peak memory "
                  f"{peak:.2f} GiB  [{card}]")
            check(math.isfinite(float(loss)), "non-finite ResNet loss")
            device_profile(call, ms, card, f"ResNet-18 {name}")
        finally:
            tdx.destroy_process_group()
    routes = dict(fa.ROUTE_LAUNCHES)
    print(f"  flash launches on the cifar path: {dict(fa.LAUNCHES)} (ResNet runs no attention)")
    check(sum(fa.LAUNCHES.values()) == 0, "a flash kernel launched on the cifar path")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cifar.main(["--epochs", "1", "--train-size", "2048", "--test-size", "1024"])
    text = buf.getvalue()
    print("  example: " + "\n  example: ".join(text.strip().splitlines()))
    check(f"world_size={DDP8}" in text and "Epoch: 1/1" in text
          and all(math.isfinite(v) for v in out["losses"]), "the CIFAR example failed on the card")
    torch.cuda.empty_cache()
    return routes


def bert_check_run(device, steps=1, comm_hook=None, opt=None, has_rng=False, **kw):
    """`steps` steps of BERT (full width, BERT_CHECK depth, float32) under
    DDP at world 8 on `device`: (params before, after, losses), on the host."""
    tdx.init_process_group(world_size=DDP8, device=None if device == "cuda" else device)
    try:
        cfg = BertConfig(max_seq_len=BERT_CHECK_SEQ, **{**bench.BERT_PRESETS["base"],
                                                        **BERT_CHECK})
        model = BertForSequenceClassification(cfg, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
        ddp = tdx.DistributedDataParallel(model.to(device))
        if comm_hook is not None:
            ddp.register_comm_hook(None, comm_hook)
        opt = opt or optim.sgd(BERT_CHECK_LR)
        step = ddp.make_train_step(opt, torch.nn.functional.cross_entropy, has_rng=has_rng, **kw)
        gen = np.random.default_rng(0)
        x = torch.from_numpy(gen.integers(0, cfg.vocab_size, (DDP8 * BERT_CHECK_BATCH,
                                                               BERT_CHECK_SEQ))).to(device)
        y = torch.from_numpy(gen.integers(0, 2, DDP8 * BERT_CHECK_BATCH)).to(device)
        p, s = ddp.params, opt.init(ddp.params)
        hs = step.init_hook_state(p) if hasattr(step, "init_hook_state") else None
        losses = []
        for i in range(steps):
            args = (x, y, i) if has_rng else (x, y)
            if hs is not None:
                p, s, hs, loss = step(p, s, hs, *args)
            else:
                p, s, loss = step(p, s, *args)
            losses.append(float(loss))
        host = lambda d: {n: t.detach().cpu() for n, t in d.items()}  # noqa: E731
        return host(ddp.params), host(p), losses
    finally:
        tdx.destroy_process_group()


def bert_checks():
    old, gp, (gloss,) = bert_check_run("cuda")
    _, cp, (closs,) = bert_check_run("cpu")
    lerr = abs(gloss - closs) / abs(closs)
    uerr, uname = update_errors(gp, cp, old)
    print(f"  first step, BERT at d 768 / 2 layers, world {DDP8} x {BERT_CHECK_BATCH} x "
          f"{BERT_CHECK_SEQ}, float32, dropout off, SGD {BERT_CHECK_LR:g}, card vs CPU: loss "
          f"{gloss:.6f} vs {closs:.6f} (rel err {lerr:.2e}, limit {CARD_LOSS_RTOL:g}); worst "
          f"update error {uerr:.2e} ({uname}, limit {CARD_UPDATE_RMS:g})")
    check(lerr <= CARD_LOSS_RTOL and uerr <= CARD_UPDATE_RMS,
          "the BERT step on the card disagrees with the CPU")

    _, ap, (aloss,) = bert_check_run("cuda", grad_accum_steps=2)
    aerr, aname = update_errors(ap, gp, old)
    print(f"  grad_accum_steps=2 vs one step of the same global batch (card): loss {aloss:.6f} "
          f"vs {gloss:.6f}; worst update error {aerr:.2e} ({aname}, limit {ACCUM_UPDATE_RMS:g})")
    check(abs(aloss - gloss) <= CARD_LOSS_RTOL * abs(gloss) and aerr <= ACCUM_UPDATE_RMS,
          "gradient accumulation disagrees with the single step")

    _, rp, rl = bert_check_run("cuda", steps=2, has_rng=True, remat=True)
    _, np_, nl = bert_check_run("cuda", steps=2, has_rng=True)
    rerr, rname = update_errors(rp, np_, old)
    bitwise = rl == nl and all(torch.equal(rp[n], np_[n]) for n in rp)
    print(f"  remat vs no remat, dropout on (the same masks), 2 steps (card): losses {rl} vs {nl}; "
          f"worst update error {rerr:.2e} ({rname}, limit {REMAT_UPDATE_RMS:g}); bitwise equal: "
          f"{bitwise}")
    check(rerr <= REMAT_UPDATE_RMS and rl == nl, "remat changes the step")

    _, _, stock = bert_check_run("cuda", steps=3, opt=optim.adamw(2e-5))
    rec = global_recorder()
    for name in HOOKS:
        _, _, losses = bert_check_run("cuda", steps=3, opt=optim.adamw(2e-5),
                                      comm_hook=make_hook(name))
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, stock))
        progress = (losses[0] - losses[-1]) / (stock[0] - stock[-1])
        wire = sorted({e.dtype for e in rec.entries()[-20:] if e.op in ("all_to_all", "all_gather")})
        limit = (f"its loss drop {progress:.3f} of the stock hook's, limit >= {POWERSGD_PROGRESS}"
                 if name == "powerSGD_hook" else f"limit {HOOK_LOSS_RTOL:g}")
        print(f"  {name}: 3 adamw steps (card) losses {[round(v, 6) for v in losses]} vs "
              f"allreduce_hook's {[round(v, 6) for v in stock]}: worst rel diff {worst:.2e} "
              f"({limit})" + (f"; wire dtypes of its all_to_all / all_gather: {wire}"
                              if name == "blockwise_quant_hook" else ""))
        check(losses[0] == stock[0], f"{name} changed the first forward")
        if name == "powerSGD_hook":
            check(progress >= POWERSGD_PROGRESS, "PowerSGD does not train")
        else:
            check(worst <= HOOK_LOSS_RTOL, f"{name} moves the loss beyond {HOOK_LOSS_RTOL}")
        if name == "blockwise_quant_hook":
            check("int8" in wire, "the quantized hook's payload is not int8 on the wire")


def hook_wire(name, hook, shapes, world):
    """A rank's wire bytes for one reduction of the BERT gradient (the ring
    model of `ops.quant.allreduce_wire_bytes`)."""
    n = sum(int(np.prod(s)) for s in shapes.values())
    if name == "allreduce_hook":
        return quant.allreduce_wire_bytes(n, world, None)
    if name in ("bf16_compress_hook", "fp16_compress_hook"):
        return quant.allreduce_wire_bytes(n, world, "bf16")
    if name == "blockwise_quant_hook":
        return quant.allreduce_wire_bytes(n, world, "int8")
    ratio = hook.compression_ratio({k: torch.empty(s, device="meta") for k, s in shapes.items()})
    return int(quant.allreduce_wire_bytes(n, world, None) / ratio)


def hook_collective_ms(name, hook, model, world):
    """CUDA-event ms of the hook alone on random rank-stacked gradients of
    `model`'s shapes, as the train step hands them over (flat, or per leaf
    in the reference's layout), and its wire bytes."""
    pg = tdx.distributed._get_default_group()
    views = model.hook_views()
    shapes = {}
    for n, p in model.named_parameters():
        perm = views[n]
        shapes[n] = tuple(p.shape[i] for i in perm) if perm else tuple(p.shape)
    shapes = {n: shapes[n] for n in views}
    gen = torch.Generator("cuda").manual_seed(0)
    if not getattr(hook, "per_leaf", False) and not hasattr(hook, "apply"):
        N = sum(int(np.prod(s)) for s in shapes.values())
        flat = torch.randn((world, N), device="cuda", generator=gen)
        fn = lambda: hook(DistTensor.wrap(flat.clone(), pg), pg)  # noqa: E731
    else:
        leaves = [torch.randn((world,) + s, device="cuda", generator=gen) for s in shapes.values()]
        wrap = lambda: [DistTensor.wrap(l, pg) for l in leaves]  # noqa: E731
        if hasattr(hook, "apply"):
            local = hook.init({n: torch.empty(s, device="cuda") for n, s in shapes.items()})
            state = torch.utils._pytree.tree_map(
                lambda l: l.unsqueeze(0).expand((world,) + tuple(l.shape)).clone(), local)
            fn = lambda: hook.apply(state, wrap(), pg)  # noqa: E731
        else:
            fn = lambda: hook(wrap(), pg)  # noqa: E731
    fn()
    return timed_events(fn, 5), hook_wire(name, hook, shapes, world)


def bert_phase(card):
    """BERT-base fine-tune under driver-mode DDP at world 8: small float32
    card-vs-CPU checks (first step, grad accumulation, remat, each hook),
    then batch 16 x seq 128 a rank, adamw(2e-5), dropout 0.1, in float32
    and bf16, and each compressing hook in bf16. Returns the phase's flash
    launches by route (none may launch)."""
    t0 = time.perf_counter()
    bert_checks()
    print(f"  checks in {time.perf_counter() - t0:.1f} s")
    fa.reset_launch_counts()
    runs = [(torch.float32, "allreduce_hook"), (torch.bfloat16, "allreduce_hook")]
    runs += [(torch.bfloat16, name) for name in HOOKS]
    for dtype, name in runs:
        tdx.init_process_group(world_size=DDP8)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            hook = None if name == "allreduce_hook" else make_hook(name)
            # the bench's set-up and windows (`bench.bench_bert_finetune`),
            # then the same step by CUDA events and under the profiler
            call, samples, _ = bench.bert_finetune_call(batch_per_rank=BERT_BATCH, seq=BERT_SEQ,
                                                        dtype=dtype, comm_hook=hook)
            rates, _, loss = bench.timed_windows(call, torch.device("cuda"), samples=samples,
                                            **BERT_BENCH)
            rate = bench.steady_rate(rates)
            ms = timed_events(call, 2)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            model = BertForSequenceClassification(
                BertConfig(max_seq_len=BERT_SEQ, **bench.BERT_PRESETS["base"]), device="meta")
            cms, wire = hook_collective_ms(name, hook or comm_hooks.allreduce_hook, model, DDP8)
            dname = str(dtype).replace("torch.", "")
            print(f"  BERT-base world {DDP8} x {BERT_BATCH} x {BERT_SEQ}, {dname}, {name}: "
                  f"{rate:.1f} samples/s, {rate * BERT_SEQ:.0f} tokens/s per card (windows "
                  f"{[round(v, 1) for v in rates]}), step {ms:.2f} ms by CUDA events, final loss "
                  f"{float(loss):.4f}, peak memory {peak:.2f} GiB; the hook alone {cms:.3f} ms "
                  f"for {wire / 2 ** 20:.2f} MiB a rank on the wire  [{card}]")
            check(math.isfinite(float(loss)), f"non-finite BERT loss ({name})")
            device_profile(call, ms, card, f"BERT-base {dname} {name}")
        finally:
            tdx.destroy_process_group()
    routes = dict(fa.ROUTE_LAUNCHES)
    print(f"  flash launches on the bert path: {dict(fa.LAUNCHES)} (BERT's attention is dense)")
    check(sum(fa.LAUNCHES.values()) == 0, "a flash kernel launched on the bert path")
    torch.cuda.empty_cache()
    return routes


# the reference's multichip dry run (`__graft_entry__.py:88-217`) in driver
# mode: its five parts at its shapes, card against CPU (float32, TF32 off);
# the 3-D mesh step at CFG_1B; the pipeline at CFG_1B width
DRYRUN_N = 8
DRYRUN_DIMS = dryrun._factor_mesh(DRYRUN_N)  # (dp, fsdp, tp) = (2, 2, 2)
DRYRUN_TOL = dict(rtol=1e-5, atol_frac=1e-5)
PIPE_ARGV = SLICE_ARGV  # CFG_1B: its 16 blocks, 4 a stage over pp 4
PIPE_STAGES, PIPE_VIRTUAL = 4, 2
PIPE_MICRO, PIPE_MICRO_BIG = 8, 16  # microbatches of 1 x seq tokens
# GPipe's peak memory is read at M 4 and 8: each tick keeps ~3.2 GB for the
# backward (the stages' bf16 weight casts and activations), so M 16 (19
# ticks) would come near the card's 80 GB
PIPE_GPIPE_MEM = (4, 8)
PIPE_MEM_FLAT = 0.10  # 1F1B's peak memory at M 16 within 10% of M 8's


def dryrun_check():
    """(a) `dryrun_multichip(8)` on the card and on the CPU on the same
    weights (built on the CPU from seed 0): every part finite, the
    all_reduce 28, the card's float32 values within DRYRUN_TOL of the
    CPU's. Part 5's dropout masks come from each device's own generator,
    so its loss is compared with dropout off."""
    lm_params = TransformerLM(TransformerConfig(**dryrun.LM_KW), device="cpu",
                              generator=torch.Generator().manual_seed(0)).state_dict()
    cparams = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    out, devices = {}, (("card", "cuda"), ("cpu", "cpu"))
    for key, dev in devices:
        t0 = time.perf_counter()
        out[key] = dryrun.dryrun_multichip(DRYRUN_N, device=dev, lm_params=lm_params,
                                           convnet_params=cparams)
        print(f"  dryrun_multichip({DRYRUN_N}) on the {key}: {time.perf_counter() - t0:.2f} s")
    for key in ("loss", "ring", "moe_y", "moe_aux", "pipe"):
        got = torch.as_tensor(out["card"][key]).detach().cpu()
        want = torch.as_tensor(out["cpu"][key]).detach()
        err, rel, ok = compare(got, want, **DRYRUN_TOL)
        print(f"  part {key} {tuple(want.shape)}: card vs CPU max_abs_err={err:.3e} "
              f"(/max {rel:.3e}); within rtol 1e-5, atol 1e-5*max: {ok}")
        check(ok, f"the dry run's {key} on the card disagrees with the CPU's")
    check(out["card"]["all_reduce"] == out["cpu"]["all_reduce"] == 28.0,
          "the dry run's all_reduce is not 28")
    check(math.isfinite(float(out["card"]["ddp_loss"])), "non-finite DDP loss (has_rng)")
    d, losses = dryrun.draw_inputs(DRYRUN_N), {}
    for key, dev in devices:
        tdx.init_process_group(world_size=DRYRUN_N, device=dev)
        try:
            losses[key] = float(dryrun.ddp_step(DRYRUN_N, d["cx"], d["cy"], dev, cparams,
                                                has_rng=False))
        finally:
            tdx.destroy_process_group()
    print(f"  part 5 with dropout off: DDP loss {losses['card']:.7f} (card) vs "
          f"{losses['cpu']:.7f} (CPU); with has_rng on the card {float(out['card']['ddp_loss']):.7f}")
    check(abs(losses["card"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]),
          "the dry run's DDP step on the card disagrees with the CPU's (rtol 1e-5)")


def vmap_flash_check():
    """The flash Function under `torch.func` on the card: `vmap` over the
    pipeline's 4 stages folds into B*H, one launch of each kernel for all
    of them, bit for bit the per-stage loop; `vjp` of the vmap gives the
    loop's autograd gradients bit for bit (CFG_1B's attention: 1 x 1024
    tokens, 16 heads of 128, bf16, causal)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((PIPE_STAGES, 1, 1024, 16, 128), device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    flash = lambda a, b, c: fa.flash_attention(a, b, c, causal=True)  # noqa: E731
    fa.reset_launch_counts()
    (got, vjp_fn) = torch.func.vjp(torch.func.vmap(flash), q, k, v)
    grads = vjp_fn(do)
    launches = dict(fa.LAUNCHES)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.stack([flash(*(x[i] for x in leaves)) for i in range(PIPE_STAGES)])
    want.backward(do)
    same = [torch.equal(got, want)] + [torch.equal(g, x.grad) for g, x in zip(grads, leaves)]
    print(f"  vmap(flash) over {PIPE_STAGES} stages: launches {launches}; output, dQ, dK, dV "
          f"bitwise the per-stage loop: {same}")
    check(launches == {"flash_fwd": 1, "flash_dkdv": 1, "flash_dq": 1},
          f"vmap(flash) should launch each kernel once for all stages: {launches}")
    check(all(same), "vmap(flash) and its vjp are not bitwise the per-stage loop")


def block_stage_fn(cfg, per_stage, L):
    """stage_fn(params, x) running `per_stage` of the port's `Block`s on
    x (mb, L, d): params {"j.<name>": tensor} for block j of the stage."""
    template = Block(cfg, device="meta")
    names = [n for n, _ in template.named_parameters()]
    cos, sin = rope_freqs(cfg.head_dim, L, cfg.rope_theta, device="cuda")

    def stage(p, x):
        for j in range(per_stage):
            x = torch.func.functional_call(template, {n: p[f"{j}.{n}"] for n in names},
                                           (x, cos, sin))
        return x

    return stage


def stacked_blocks(model, per_stage):
    """The model's blocks as stage params stacked in stage order."""
    layers = model.layers
    return pp.stack_stage_params([
        {f"{j}.{n}": t.detach() for j in range(per_stage)
         for n, t in layers[s * per_stage + j].named_parameters()}
        for s in range(len(layers) // per_stage)])


def pipeline_run(fn, *args):
    """(result, seconds, peak bytes) of fn(*args) from a fresh peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def pipeline_check(card):
    """(c) CFG_1B's 16 blocks over pp 4 (4 a stage), bf16, flash on; M
    microbatches of 1 x seq tokens from the embedding; the loss the final
    norm, LM head and cross-entropy on the same weights. 1F1B's loss and
    stage gradients against the unpipelined blocks; GPipe against 1F1B;
    interleaved (8 stages of 2 over 4) against the sequential forward; the
    peak memory of 1F1B flat in M, GPipe's growing. Returns the flash
    routes of the timed 1F1B step."""
    args = lm.parse_args(PIPE_ARGV)
    cfg = lm.config_for(args)
    L, S, per = args.seq, PIPE_STAGES, cfg.n_layers // PIPE_STAGES
    model = TransformerLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    gen = np.random.default_rng(0)
    data = np.cumsum(gen.integers(1, 7, 200_000)) % cfg.vocab_size
    starts = gen.integers(0, len(data) - L, PIPE_MICRO_BIG)
    tokens = torch.from_numpy(np.stack([data[s_:s_ + L] for s_ in starts])).to(
        "cuda", torch.int64).view(PIPE_MICRO_BIG, 1, L)
    with torch.no_grad():
        hidden = model.tok_embed(tokens).to(cfg.dtype)  # (M, 1, L, d)
    norm_w, head_w = model.final_norm.weight.detach(), model.lm_head.weight.detach()

    def head_loss(y, t):
        h = torch.func.functional_call(model.final_norm, {"weight": norm_w}, (y,))
        return lm.loss_fn(torch.nn.functional.linear(h, head_w.to(cfg.dtype)).float(), t)

    mesh = tdx.DeviceMesh(["cuda"] * S, (S,), ("pp",))
    stage = block_stage_fn(cfg, per, L)
    params = stacked_blocks(model, per)
    M = PIPE_MICRO
    print(f"  config: CFG_1B blocks (d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.ffn_dim}, "
          f"{cfg.dtype}, flash), {cfg.n_layers} blocks as pp {S} x {per}; M {M} microbatches "
          f"of 1 x {L} tokens (and M {PIPE_MICRO_BIG} for the memory check); no cuts")
    # the unpipelined blocks on the same weights and tokens, a microbatch at a time
    cos, sin = rope_freqs(cfg.head_dim, L, cfg.rope_theta, device="cuda")
    want_loss = 0.0
    for m in range(M):
        x = hidden[m]
        for layer in model.layers:
            x = layer(x, cos, sin)
        loss_m = head_loss(x, tokens[m]) / M
        loss_m.backward()
        want_loss += float(loss_m.detach())
    want = {n: p.grad for n, p in model.named_parameters() if n.startswith("layers.")}
    for p in model.parameters():
        p.grad = None

    def stage_grads(grads):  # stacked (S, ...) -> {layers.i.name: grad}
        return {f"layers.{s * per + int(k.split('.', 1)[0])}.{k.split('.', 1)[1]}": g[s]
                for k, g in grads.items() for s in range(S)}

    def worst(grads, ref):
        return max((rel_rms(g, ref[n]), n) for n, g in stage_grads(grads).items())

    f1b = pp.make_pipeline_train_fn(stage, head_loss, mesh, schedule="1f1b")
    gpipe = pp.make_pipeline_train_fn(stage, head_loss, mesh, schedule="gpipe")
    (loss1, g1), s1, peak1 = pipeline_run(f1b, params, hidden[:M], tokens[:M])
    w1 = worst(g1, want)
    print(f"  1F1B M {M}: loss {float(loss1):.5f} vs {want_loss:.5f} unpipelined; largest "
          f"rms(grad diff)/rms(grad) {w1[0]:.3e} ({w1[1]}); {s1 * 1e3:.1f} ms with warm-up")
    check(abs(float(loss1) - want_loss) <= SHARDED_LOSS_TOL and w1[0] <= SHARDED_GRAD_RMS,
          f"1F1B disagrees with the unpipelined blocks (|dloss| <= {SHARDED_LOSS_TOL}, rms "
          f"ratio <= {SHARDED_GRAD_RMS})")
    del want
    (loss2, g2), s2, _ = pipeline_run(gpipe, params, hidden[:M], tokens[:M])
    w2 = worst(g2, stage_grads(g1))
    print(f"  GPipe M {M}: loss {float(loss2):.5f} vs 1F1B {float(loss1):.5f}; largest rms "
          f"ratio against 1F1B {w2[0]:.3e} ({w2[1]}); {s2 * 1e3:.1f} ms")
    check(abs(float(loss2) - float(loss1)) <= SHARDED_LOSS_TOL and w2[0] <= SHARDED_GRAD_RMS,
          "GPipe disagrees with 1F1B")
    del g1, g2
    # the timed 1F1B step (after one that warms the emptied allocator), its
    # launches counted; then each schedule's peak memory at M and at M2,
    # from a fresh peak with nothing else held
    torch.cuda.empty_cache()
    pipeline_run(f1b, params, hidden[:M], tokens[:M])
    fa.reset_launch_counts()
    peak = {}
    (loss_t, g_t), s_t, peak[("1f1b", M)] = pipeline_run(f1b, params, hidden[:M], tokens[:M])
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    del g_t
    ticks = M + 2 * S - 2
    print(f"  1F1B step, M {M}: {s_t * 1e3:.2f} ms, {M * L / s_t:.0f} tokens/s, peak memory "
          f"{peak[('1f1b', M)] / 2 ** 30:.2f} GiB  [{card}]; {ticks} ticks, launches "
          f"{launches} ({launches['flash_fwd'] / ticks:g} F, {launches['flash_dkdv'] / ticks:g} "
          f"KV, {launches['flash_dq'] / ticks:g} Q a tick)")
    check(math.isfinite(float(loss_t)), "non-finite 1F1B loss")
    # F: the forward half and the recompute; KV, Q: the backward; each once
    # a block of the stage a tick, for all S stages (the vmap fold)
    want_l = {"flash_fwd": 2 * per * ticks, "flash_dkdv": per * ticks, "flash_dq": per * ticks}
    check(launches == want_l, f"1F1B's launches should be {want_l}: {launches}")
    check(routes == {**{k: 0 for k in fa.ROUTE_LAUNCHES},
                     **{f"{k}:wgmma": n for k, n in want_l.items()}},
          f"1F1B's flash launches should all take the wgmma route: {routes}")
    print("[profile] one more 1F1B step under torch.profiler")
    profile_step(lambda: f1b(params, hidden[:M], tokens[:M]), s_t * 1e3)
    M2, secs = PIPE_MICRO_BIG, {}
    G1, G2 = PIPE_GPIPE_MEM
    for name, fn, ms in (("1f1b", f1b, (M2,)), ("gpipe", gpipe, PIPE_GPIPE_MEM)):
        for m in ms:
            torch.cuda.empty_cache()
            _, secs[(name, m)], peak[(name, m)] = pipeline_run(fn, params, hidden[:m],
                                                              tokens[:m])
    gib = {k: v / 2 ** 30 for k, v in peak.items()}
    print(f"  peak memory: 1F1B {gib[('1f1b', M)]:.2f} GiB at M {M}, {gib[('1f1b', M2)]:.2f} "
          f"at M {M2} ({peak[('1f1b', M2)] / peak[('1f1b', M)] - 1:+.1%}); GPipe "
          f"{gib[('gpipe', G1)]:.2f} at M {G1}, {gib[('gpipe', G2)]:.2f} at M {G2} "
          f"({peak[('gpipe', G2)] / peak[('gpipe', G1)] - 1:+.1%}, "
          f"{(gib[('gpipe', G2)] - gib[('gpipe', G1)]) / (G2 - G1):.2f} GiB a microbatch); "
          f"steps: 1F1B {secs[('1f1b', M2)] * 1e3:.1f} ms at M {M2}, GPipe "
          f"{secs[('gpipe', G1)] * 1e3:.1f} / {secs[('gpipe', G2)] * 1e3:.1f} ms at M {G1} / "
          f"{G2}  [{card}]")
    check(abs(peak[("1f1b", M2)] - peak[("1f1b", M)]) <= PIPE_MEM_FLAT * peak[("1f1b", M)],
          f"1F1B's peak memory should be flat in M (within {PIPE_MEM_FLAT:.0%})")
    check(peak[("gpipe", G2)] > peak[("gpipe", G1)] * (1 + PIPE_MEM_FLAT),
          "GPipe's peak memory should grow with M")
    torch.cuda.empty_cache()
    # interleaved: 8 stages of 2 blocks over the 4 pp ranks, forward
    V = PIPE_VIRTUAL
    per_v = cfg.n_layers // (V * S)
    with torch.no_grad():
        x = hidden[:M].clone()
        for layer in model.layers:
            x = layer(x.flatten(0, 1), cos, sin).view_as(x)
        fa.reset_launch_counts()
        (got, s_i, peak_i) = pipeline_run(
            pp.make_pipeline_fn(block_stage_fn(cfg, per_v, L), mesh, virtual_stages=V),
            stacked_blocks(model, per_v), hidden[:M])
        launches_i = dict(fa.LAUNCHES)
    r = rel_rms(got, x)
    print(f"  interleaved V {V} ({V * S} stages of {per_v} over pp {S}), M {M}: rms(diff)/rms "
          f"{r:.3e} against the sequential forward; {s_i * 1e3:.1f} ms, {M + V * S - 1} "
          f"ticks, F launches {launches_i['flash_fwd']}")
    check(r <= SHARDED_GRAD_RMS and got.shape == x.shape,
          "the interleaved pipeline disagrees with the sequential forward (rms ratio <= 3e-2)")
    del model, params, hidden
    torch.cuda.empty_cache()
    return routes


def dryrun_phase(card):
    """(a) the reference's dry run card vs CPU, the vmap fold on the card;
    (b) the ("dp", "fsdp", "tp") step at CFG_1B; (c) the pipeline at CFG_1B
    width. Returns the flash routes of (b)'s profiled step and (c)'s timed
    1F1B step, summed."""
    print("  (a) the reference's dry run, card vs CPU:")
    dryrun_check()
    vmap_flash_check()
    print(f"  (b) the mesh step over dp {DRYRUN_DIMS[0]} x fsdp {DRYRUN_DIMS[1]} x tp "
          f"{DRYRUN_DIMS[2]} at CFG_1B:")
    routes, _ = sharded_train(SLICE_ARGV, card, TIMED_STEPS, dims=DRYRUN_DIMS)
    print("  (c) the pipeline at CFG_1B width:")
    pipe_routes = pipeline_check(card)
    return {k: routes[k] + pipe_routes[k] for k in routes}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # 1. card
    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"[card] {kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _build.check_device(0)
    lib_path = _build.build("flash_attention")
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    lib = _build.load("flash_attention", fa._SIGNATURES)
    for name, regs, spills in ptxas_entries(_build.build_log("flash_attention")):
        smem = ""
        if "wgmma" in name:
            D = int(name.rsplit("D ", 1)[1].rstrip(">"))
            role = ("fwd", "dkdv", "dq").index(name.split("_")[1])
            smem = f"; {lib.flash_wgmma_smem_bytes(role, D)} bytes of dynamic shared memory"
            check(spills.startswith("0 bytes stack frame, 0 bytes spill stores"),
                  f"ptxas: {name} spills: {spills}")
        print(f"  ptxas: {name}: {regs}; {spills}{smem}")

    # 3. kernels against their plain versions
    print("[kernels]")
    results = {}
    BH, L, D = 4 * 16, 1024, 128
    results["resident"] = kernel_checks(BH, L, D, causal=True, timed=True)
    kernel_checks(BH, L, D, causal=False, timed=False)
    kernel_checks(BH, L, 64, causal=True, timed=False)
    kernel_checks(16, L, D, causal=True, timed=False, dtype=torch.float32)  # SIMT F, KV, Q

    # 4. the same in the reference's streamed regime, and the new head dims
    t0 = time.perf_counter()
    print("[kernels-long]")
    results["streamed"] = kernel_checks(16, 16384, 128, causal=True, timed=True, B=1,
                                        iters=3, plain_once=True)
    fwd_f32_out_check(16, 16384, 128, causal=False)
    for D_, dtype in ((32, torch.bfloat16), (96, torch.bfloat16), (256, torch.bfloat16),
                      (256, torch.float32)):
        kernel_checks(8, 512, D_, causal=True, timed=False, dtype=dtype)
    torch.cuda.empty_cache()
    print(f"  kernels-long in {time.perf_counter() - t0:.1f} s")

    # 5. small-input reference
    print("[reference]")
    reference_check()

    # 6. the slice: the ~1B train step
    print("[slice]")
    phase_launches = {"slice": train_phase(SLICE_ARGV, WARMUP_STEPS, TIMED_STEPS, card)}

    # 7. ring attention over 4 shards of 16384
    t0 = time.perf_counter()
    print("[ring]")
    phase_launches["ring"] = ring_phase()
    print(f"  ring in {time.perf_counter() - t0:.1f} s")

    # 8. the ~1B train step at seq 16384
    t0 = time.perf_counter()
    print("[long]")
    phase_launches["long"] = train_phase(LONG_ARGV, LONG_WARMUP_STEPS, LONG_TIMED_STEPS, card,
                                         check_layers=LONG_CHECK_LAYERS)
    print(f"  long in {time.perf_counter() - t0:.1f} s")

    # 9. the c10d core
    t0 = time.perf_counter()
    print("[c10d]")
    grad_params = sum(p.numel() for p in TransformerLM(
        lm.config_for(lm.parse_args(SLICE_ARGV)), device="meta").parameters())
    c10d_phase(card, grad_params)
    print(f"  c10d in {time.perf_counter() - t0:.1f} s")

    # 10. the reference workload: DDP-MNIST
    t0 = time.perf_counter()
    print("[mnist]")
    mnist_phase(card)
    print(f"  mnist in {time.perf_counter() - t0:.1f} s")

    # 11. sharded training: fsdp 2 x tp 2, dense and MoE
    t0 = time.perf_counter()
    print("[fsdp_tp]")
    phase_launches["fsdp_tp"] = fsdp_tp_phase(card)
    print(f"  fsdp_tp in {time.perf_counter() - t0:.1f} s")

    # 12. serving at CFG_1B width
    t0 = time.perf_counter()
    print("[serve]")
    serve_phase(card)
    torch.cuda.empty_cache()
    print(f"  serve in {time.perf_counter() - t0:.1f} s")

    # 13. serving across ranks and pools: tp decode, disagg, the router
    t0 = time.perf_counter()
    print("[serve_fleet]")
    phase_launches["serve_fleet"] = serve_fleet_phase(card)
    torch.cuda.empty_cache()
    print(f"  serve_fleet in {time.perf_counter() - t0:.1f} s")

    # 14. ResNet-18 / CIFAR-10 under DDP with SyncBN (BASELINE config #3)
    t0 = time.perf_counter()
    print("[cifar]")
    phase_launches["cifar"] = cifar_phase(card)
    print(f"  cifar in {time.perf_counter() - t0:.1f} s")

    # 15. BERT-base fine-tune under DDP (BASELINE config #4)
    t0 = time.perf_counter()
    print("[bert]")
    phase_launches["bert"] = bert_phase(card)
    print(f"  bert in {time.perf_counter() - t0:.1f} s")

    # 16. the reference's multichip dry run: the 3-D mesh step, the pipeline
    t0 = time.perf_counter()
    print("[dryrun]")
    phase_launches["dryrun"] = dryrun_phase(card)
    print(f"  dryrun in {time.perf_counter() - t0:.1f} s")

    # 17. report
    kernels = []
    for name, lowerings in REPLACES.items():
        for regime, replaces in lowerings.items():
            design = results[regime][name]["design"]
            by_phase = {ph: phase_launches[ph].get(f"{name}:{design}", 0)
                        for ph in PHASES[regime] + ("serve_fleet", "cifar", "bert")}
            kernels.append({"name": name, "route": "cuda",
                            "source": WGMMA_SOURCE if design == "wgmma" else SOURCE,
                            "replaces": replaces, "regime": regime,
                            "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                            **results[regime][name]})
    print(f"[done] in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
