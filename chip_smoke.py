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
7. ring: `make_cp_attention(4, "ring", causal=True)` (driver mode) over
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
12. report: one JSON line of kernels (each Hopper kernel once per Pallas
   lowering it replaces, with its design, "wgmma" or "simt", and its
   launches per phase), the card's name and power limit, then the `ok`
   line.
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
from pytorch_distributed_example_tpu_torch import bench, optim
from pytorch_distributed_example_tpu_torch.data import DataLoader, DistributedSampler, SyntheticMNIST
from pytorch_distributed_example_tpu_torch.examples import lm, mnist, toy
from pytorch_distributed_example_tpu_torch.models import ConvNet, TransformerConfig, TransformerLM
from pytorch_distributed_example_tpu_torch.ops import _build, dense_attention
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
PHASES = {"resident": ("slice", "fsdp_tp"), "streamed": ("ring", "long")}


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
)


def profile_step(model, opt, tokens, step_ms):
    """One train step under torch.profiler: device time by kernel group
    and the top kernels, and the device's busy share of the profiled
    step and of an unprofiled one (`step_ms`). Only device kernels are
    summed: an operator's row and a `record_function` range on the device
    (the optimizer's step) repeat their kernels' time. One stream, so the
    kernels do not overlap."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.train_step(model, opt, tokens)
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
                     "other (elementwise, norms, softmax, embedding)")
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
    profile_step(model, opt, next_tokens(), mean_s * 1e3)
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
    attention = cp.make_cp_attention(W, "ring", causal=True)
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


def sharded_first_step(argv, grads=True):
    """The trainer (`examples/lm.py`) over fsdp 2 x tp 2 in driver mode on
    cuda:0, from the weights of a single-card model: its first step's loss
    and every gathered gradient against that model's, held to the bf16
    tolerance (the gradients only with `grads`). Returns (the FSDPModule, its optimizer,
    next_tokens, args, param count, the first loss)."""
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
    mod = lm.shard(model, args.lr, FSDP_TP_WORLD, FSDP_TP_TP)
    opt = mod.step.init_opt_state(mod.params)
    print(f"  config: vocab {cfg.vocab_size}, d {cfg.d_model}, layers {cfg.n_layers}, heads "
          f"{cfg.n_heads}, d_ff {cfg.ffn_dim}, experts {cfg.n_experts}, seq {args.seq}, global "
          f"batch {args.batch_size}, {cfg.dtype}; {n_params / 1e6:.1f}M params; mesh fsdp "
          f"{mod.mesh.shape[0]} x tp {mod.mesh.shape[1]} (driver mode on {mod.mesh.device})")
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


def sharded_train(argv, card, timed_steps, grads=True):
    """`sharded_first_step`, then three steps with a finite, falling loss,
    `timed_steps` timed steps, and one profiled step whose launches are
    counted. Returns (routes of the profiled step, aux of the MoE layers or
    None)."""
    mod, opt, next_tokens, args, n_params, first = sharded_first_step(argv, grads)
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
    profile_step(mod, opt, next_tokens(), mean_s * 1e3)
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    print(f"  launches in the profiled step: {launches}; by route: {routes}")
    check(all(launches[n] == cfg.n_layers for n in REPLACES),
          f"F, KV and Q should launch once a layer for all {FSDP_TP_WORLD} ranks: {launches}")
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

    # 12. report
    kernels = []
    for name, lowerings in REPLACES.items():
        for regime, replaces in lowerings.items():
            design = results[regime][name]["design"]
            by_phase = {ph: phase_launches[ph][f"{name}:{design}"] for ph in PHASES[regime]}
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
