#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: drives it on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, exits non-zero and prints no `ok` line):

1. card: name, count, power limit; TF32 off, so the plain versions
   compute in full float32.
2. build: nvcc builds csrc/flash_attention.cu (with csrc/flash_wgmma.cuh
   and csrc/flash_tf32x3.cuh) for sm_90a; each instance's registers and
   spills from ptxas, and the tensor-core instances' dynamic shared memory,
   are printed. A wgmma or tf32x3 instance that spills, or asks for more
   than a block's 232,448 bytes of shared memory, fails the phase.
3. kernels: the forward (F), dK/dV (KV) and dQ (Q) kernels against their
   plain versions at the ~1B train step's shapes (B*H 64, L 1024, D 128,
   bf16, causal), plus a non-causal and a D=64 case; F also with float32
   output. `fa.kernel_route` names each kernel's instance by role: bf16
   takes the wgmma route at every head dim, held to its declared
   tolerance; float32 the tf32x3 forward, dK/dV and dQ (three TF32 passes
   on the tensor cores), held to the float32 tolerance. Timed
   by CUDA events beside the plain version, the bound (at the peak of
   the route's instructions: bf16 wgmma, or TF32 mma.sync over its three
   passes, with the bound at the float32 FMA peak beside it), and the
   library (timed here only; the port
   never calls it):
   for bf16 `scaled_dot_product_attention` for F and its flash backward
   for KV and Q together, for float32 the efficient backend's forward and
   backward (the flash backend refuses float32). Timed at the same work
   (B*H*D 8192, L 1024, causal): bf16 D 128, 32 (B*H 256) and 256 (B*H
   32) on wgmma, float32 D 128, 32, 64 and 256 on the float32 route.
4. kernels-long: F (bf16 and float32 output), KV and Q against their plain
   versions in the reference's streamed regime (B*H 16, L 16384, D 128,
   bf16, causal; L*D = 2.1M elements), timed as in phase 3 except that
   each plain version is timed once, by the call that checks it; F with
   float32 output (ring attention's partials) at the same shape,
   non-causal; bf16 D 32 and 256 at L 512 and 1024, causal and full, D 96
   (padded to 128), all on the wgmma route, and float32 at D 32, 64, 128
   and 256 (L 512, causal and full) on the float32 route. Then the float32
   forward (o and lse), dK/dV and dQ on heads scaled by 1 to 4 (B*H 8, L
   1024, every head dim, causal and full) against a float64 copy of the
   same arithmetic: within the float32 tolerance of it, and no farther
   from it than twice the plain float32 version.
5. reference: a small float32 TransformerLM on the card against the same
   weights on the CPU (the plain versions): logits, loss and grads; its
   launches on the card (head dim 128) must be one a layer of each role
   on the float32 routes.
6. slice: the trainer (`examples/lm.py`) at the ~1B configuration's full
   width (vocab 32000, d 2048, 16 layers, 16 heads, d_ff 5504, seq 1024,
   batch 4, bf16, AdamW): the first step's loss and logits against the
   dense path on the same weights, two warm-up steps, then 3 timed steps
   after which F, KV and Q must each show n_layers * 3 launches, all on
   the wgmma route (step time, tokens/s, MFU as bench.py counts it, peak
   memory); then one
   step under torch.profiler: device time by kernel group and the
   device's busy share of the step.
6b. headdims: the trainer at the other bf16 head dims, as the slice:
   (a) its own defaults with --bf16 (vocab 512, d 256, 4 layers, 8 heads
   of 32, seq 256, batch 16); (b) CFG_1B's width as 8 heads of 256 (its
   attention the slice's operations), the first-step check on 2 layers as
   in [long]. F, KV and Q on the wgmma route, n_layers * 3 launches each;
   (b)'s step beside the slice's from the same run.
6c. float32: the trainer at its own defaults without --bf16 (8 heads of
   32, 4 layers), as the slice: F, KV and Q on the tf32x3 route,
   n_layers * 3 launches each.
7. ring: `make_cp_attention(4, mode="ring", causal=True)` (driver mode) over
   4 shards of 16384 tokens (B 1, H 16, D 128, bf16), forward and
   backward: one untimed warm-up call, then two timed calls (their mean
   printed), each of which must launch exactly 4 each of F (float32
   output), KV and Q, all on the wgmma route; output and dQ/dK/dV
   against `flash_with_lse` over the whole 65536-token sequence on the
   same kernels, timed the same way. Then a small float32 ring (the tf32x3
   forward, dK/dV and dQ) against dense attention.
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
   after the first) at world 1 with steps_per_call 1 and 8 and at world 8
   with 8 ([bench] times world 8 at 1, at the bench's full depth), in
   samples/s per card; one profiled step at each world (device busy share,
   launches, top kernels) and the host's ms inside c10d dispatch over an
   unprofiled step; and the example, `examples.mnist.main(["--epochs",
   "1"])` (world 8 on the card).
10b. bench: the port's entry point as the reference's `bench.py` runs
   it, `bench.main([])` with BENCH_BREAKDOWN=1: DDP-MNIST at world 8,
   then the TransformerLM MFU step (vocab 32000, d 512, 8 layers, 8 heads
   of 64, L 512, B 8, bf16, AdamW 1e-3). Its one JSON line must show a
   rate above 0 on the "gpu" platform, 0 < mfu <= 1, the spec sheet's
   989 TFLOP/s on the H100 SXM, F, KV and Q 8 times each a step on
   wgmma (0 on tf32x3), hfu above 0, a breakdown with fwd < fwd_bwd and
   no error, and a finite final loss under ln 32000. Then the MFU model's
   first step with flash against dense on the same weights (|dloss| <=
   1e-2), its step by CUDA events and one profiled step. Phase 3 times
   the D 64 kernels at this step's shapes (B*H 64, L 512, causal).
11. fsdp_tp: the trainer over an ("fsdp", "tp") mesh of 2 x 2 in driver
   mode on cuda:0 (`examples/lm.py` with --tp 2 at 4 ranks: fully_shard by
   the reference's transformer rules, the batch split over fsdp, AdamW on
   the shards), at the slice's full width and global work, 4 layers. Its
   first step's loss and every gathered gradient against the single-card
   step on the same weights and tokens (|dloss| <= 1e-2, rms(diff)/rms <=
   3e-2), three steps with a finite, falling loss, two warm-up steps, 3
   timed steps (step time, tokens/s, MFU as the slice counts it, peak
   memory, per-rank bytes of params and optimizer state), then one
   profiled step in which F, KV and Q must launch once a layer for all
   four ranks, on the wgmma route. The MoE (8 experts, top-1) with its
   depth cut to 2 layers: its first step against the single card in
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
   Then CFG_1B at full width and 4 layers, max_seq_len 2048, bf16:
   prefill logits of 4 x 512 tokens through the decode path against the
   flash forward (rms(diff)/rms <= 3e-2); 24 requests of the bimodal
   new-token mix on
   prompts of 256 or 512 tokens with chunked prefill at 256, once with the
   full pool and once with 192 blocks, which must preempt, and every
   greedy stream identical across the two; the bimodal burst of
   `benchmarks/serve_bench.py` (its first 24 requests, prompts 8-64, 8 slots,
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
   byte the first (bf16 and int8 pools). Then CFG_1B at full width and
   4 layers, max_seq_len 2048, bf16, block 16: tp 2 prefill logits (4 x 512 through
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
   colocated run of the disagg construct). The MoE's tensor-parallel
   decode at MOE_ARGV's shape (d 2048, 2 layers, 8 experts, top-1) at tp
   2 against the single-card engine: float32 (TF32 off) prefill logits
   within rms 1e-4, bf16 within rms 3e-2, and so each decode step's
   logits with the single card's greedy tokens fed in (8 prompts of 48
   tokens, 32 steps); the bimodal burst's first 16 greedy streams' match
   reported. No flash kernel launches in the phase.
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
   launch counts on the 3-D mesh. (c) 8 of CFG_1B's blocks as a pp 4
   pipeline (2 a stage, bf16, flash), M 8 microbatches of 1 x 1024
   tokens from the embedding, the loss the final norm, LM head and
   cross-entropy: 1F1B's loss and stage gradients against the
   unpipelined blocks and GPipe's against 1F1B (|dloss| <= 1e-2, rms
   ratio <= 3e-2), the timed 1F1B step (launches: 4 F, 2 KV, 2 Q a
   tick) and its profile, 1F1B's peak memory at M 8 and 16 within 10%,
   GPipe's at M 4 and 8 growing by more than 10%, and the interleaved
   schedule (V 2: 8 stages of 1 block over pp 4) against the sequential
   forward (rms ratio <= 3e-2).
17. ckpt: checkpoints, after `[dryrun]`. CFG_1B's single-card trainer
   at 1 layer (`examples/lm.py` at the slice's width, f32 params, AdamW):
   2 steps, `save_checkpoint` (~2.2 GB: seconds and GB/s of the device->host
   copy, the npz write and the CRC + fsync, beside the free disk), step 3;
   a model and optimizer from another seed, `load_checkpoint` (CRC
   verify, npz read, host->device), and step 3 again: the loaded state
   bitwise the saved one on the card, step 3's loss and params bitwise
   the uninterrupted run's. Then the same over fsdp 2 x tp 2 after one
   step: `dcp_save` (each rank's shard its own DCP entry), `dcp_load`
   into the same layout and one step from that state against the live
   one, 4 -> 1 into `resharded_template`'s single-card layout (bitwise
   `redistribute_tree`'s global values; the load's peak host and device
   memory), all bitwise; `dcp_async_save` of the single-card state
   (foreground and durable seconds, a step taken while the write lands)
   and 1 -> 4 from it back, bitwise. The F, KV and
   Q launches of the phase's train steps are counted. Last, a byte
   flipped in `arrays.npz` and one in a DCP step's `.metadata` on card
   tensors: caught, quarantined, fallen back. Checkpoints go to
   `.ckpt_smoke/` in the checkout and are deleted after their checks.
18. train_utils: AMP, BERT-base at world 8 x 16 x 128 (adamw(2e-5),
   dropout off) under `get_policy("fp16")` with the GradScaler's
   cross-rank verdict and `clip_grad_norm_(1.0)`: 3 steps, each held
   against plain float32 torch on the same params (the loss within 1e-2,
   the all-reduced mean gradient unscaled and clipped within 5e-2 by
   relative norm, the verdict equal to isfinite over every rank's
   gradients); the float32 run against the port's DDP step with the same
   clip and adamw (|dloss| 1e-5); then an inf in one rank's gradients
   skips the step everywhere (params and adamw state bitwise, the scale
   halved), ms a step; `PostLocalSGDOptimizer` on the DDP-MNIST ConvNet
   at world 8 (period 4, warmup 2, 16 steps): replicas bitwise equal
   right after each averaging only; float32 card vs CPU within 1e-5
   over the warm-up steps and then within twice the CPU's own distance
   from a float64 run (+1e-6); float64 card vs CPU within 1e-12 at every
   step, which a planted fault (one replica left out of each average)
   must break; samples/s beside the DDP step's; Join (rank r with 12 - r
   batches, the weighted loss) card vs CPU within rtol 2e-4; the eager
   `Reducer` with `BlockwiseQuantHook(bits=8).for_reducer` over
   BERT-base's rank-stacked gradients at world 8: buckets and ms a pass
   beside the stock pass, and a `comm.quantize` fault at bucket 1 with a
   whole-pass retry bitwise the fault-free pass. No flash kernel may
   launch.
19. multiproc: the training parallelisms as process gangs that share
   cuda:0 over gloo (`backend="cuda:gloo"`; nccl refuses two ranks on
   one GPU), each rank a `python3 chip_smoke.py --worker PART RANK WORLD
   PORT BACKEND` process, the files they exchange under `.multiproc_smoke/`
   (removed after), each gang under a timeout; (a)-(d) are one gang of 4
   processes and (e) and (g) one of 2, whose processes run their parts in
   turn, each over a process group of its own: (a) CFG_1B dense at full
   width, 4 layers, over fsdp 2 x tp 2 as 4 processes: the first step
   against the single card on the same weights and tokens (|dloss| <=
   1e-2, every gathered gradient's rms ratio <= 3e-2, the worst printed),
   the three steps' losses within 1e-2 of `[fsdp_tp]`'s driver-mode ones,
   a warm-up and 2 timed steps (the bytes each process hands gloo, the
   host seconds inside the collectives, the backend's staged bytes and
   seconds), one step with its launches counted (4 each of F, KV, Q a
   process, wgmma; rank 0 under the profiler); (b) the ring (flash
   block) at `[ring]`'s shape as 4 processes, output and gradients
   against the driver-mode ring on the card under `RING_GRAD_TOL`,
   process r launching F, KV and Q r + 1 times a call, its sends staged
   through pinned memory; Ulysses (flash inside) against its driver-mode
   form; (c) 1F1B of 8 of CFG_1B's blocks at pp 4, M 8, a stage a process,
   loss and every stage's gradients against driver mode's 1F1B (the bf16
   tolerance above), each process's launches (2 F, 1 KV, 1 Q a block a
   microbatch, wgmma) and the peak memory of its timed step, the process
   holding its stage's blocks and the head's weights but no model; (d) `make_ep_moe` at 4
   ep ranks and 8 experts, `ep_moe_check`'s shapes in float32 (TF32 off),
   against driver mode (rtol 1e-4, atol 1e-5 of the largest entry); (e)
   `examples/cifar.main(... --init-method ...)` at world 2 x 128 images
   (ResNet-18, SyncBN, float32, `cudnn.deterministic`): the first step's
   loss, batch statistics and params against driver mode at world 2
   (rtol 1e-4, atol 1e-6); (f) (a)'s step at 4 layers as a world-1 nccl
   gang against the single card; (g) CFG_1B's width at 4 layers
   (max_seq_len 2048, bf16) served at tp 2 as 2 processes, a
   `ServeEngine(mesh=init_device_mesh(("tp",), (2,)))` a process: the
   bimodal burst's first 8 requests, the
   two processes' tokens the same; in float32 (TF32 off, float pool) the
   greedy streams token for token the driver-mode tp 2 engine's in the
   same call; in bf16 (float and int8 pools) the prefill logits (2 x 128)
   within rms 3e-2 of driver mode's and the streams' match reported; each
   decode step's logits with driver mode's greedy tokens fed in (8
   prompts of 48 tokens, 32 steps, every pool) within rms 3e-2 of driver
   mode's (float32 1e-5); a steady 8-slot bf16 decode step a process
   by CUDA events, on the host clock and inside the collectives, and its
   launches under the profiler.
20. planner: the collective planner and the p2p plane, after
   `[multiproc]`. (a) Driver mode at world 8 on cuda:0: a probe cache
   holding only a TPU's topology key must warn and be probed fresh; every
   candidate of all_reduce, all_gather and reduce_scatter timed by
   `plan.probe.probe_driver` (CUDA events) from 64 KiB to 64 MiB a rank
   in float32 and bf16, each argmin beside `c10d_bound_bytes`' HBM bound;
   the float32 table persisted and a second planner reading every choice
   from it without probing; each schedule against the stock collective
   at 1 MiB a rank (gathers bitwise; float32 rtol 1e-5, atol 1e-6 of the
   max; bf16 2^-6 and 2^-5), and the two-rank geometry through the
   dispatch seam bitwise. (b) `[fsdp_tp]`'s dense CFG_1B step with
   `TDX_COLLECTIVE_PLANNER=1` and `TDX_PLANNER_FORCE` ring, then rhd (its
   tp sums through `plan.traced`): first step against the single card,
   losses within 1e-2 of the stock step's, step ms beside the stock's,
   16 launches each of F, KV and Q in its profiled step. (c) DDP-MNIST's
   3 steps at world 8 through `planner_hook` (probed, then forced ring)
   against the stock step under `cudnn.deterministic` (rtol 1e-5). (d)
   Gangs on cuda:0 over "cuda:gloo": a 256 MiB bf16 CUDA tensor between 2
   processes through the p2p plane and through torch.distributed's
   staged gloo send (GB/s each, the plane's frames counted: a listener
   that published "none" fails); ring, rhd and hier all-reduces of 64
   MiB a rank over the plane at world 4 against gloo's all_reduce and
   bitwise against their re-execution; a skewed `TDX_PLANNER_FORCE` at
   world 2 (the bandwidth gang) must fail `plan.traced.prepare` on both
   processes naming eqn #1.
21. report: one JSON line of kernels (each Hopper kernel once per Pallas
   lowering it replaces at D 128, once for each of its bf16 D 32 and D 256
   instances with [headdims]' launches, once for its bf16 D 64 instance
   with [bench]'s, and once for each float32 instance
   at D 128 and 32 with [reference]'s and [float32]'s, with its design, "wgmma" or
   "tf32x3", and its launches per phase, `serve_fleet`, `cifar`, `bert`,
   `dryrun`, `ckpt`, `train_utils`, `multiproc` ((a)'s and (c)'s gang
   processes' counted launches, in the resident rows), `multiproc_ring`
   ((b)'s, in the streamed rows) and `planner` ((b)'s two profiled steps)
   among them),
   the card's name and power limit, then the `ok` line.

Every float32 card-vs-CPU check computes its CPU side under
`utils/cpu_reference.py`'s `cpu_reference()`.
"""

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import resource
import shutil
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import bench, dryrun, optim, p2p
from pytorch_distributed_example_tpu_torch import checkpoint_sharded as cs
from pytorch_distributed_example_tpu_torch.backends import process as bp
from pytorch_distributed_example_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
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
from pytorch_distributed_example_tpu_torch.models.transformer import Block, RMSNorm, rope_freqs
from pytorch_distributed_example_tpu_torch.ops import _build, dense_attention, quant
from pytorch_distributed_example_tpu_torch.parallel import comm_hooks, fully_shard
from pytorch_distributed_example_tpu_torch.parallel import pipeline as pp
from pytorch_distributed_example_tpu_torch.parallel.localsgd import PeriodicModelAverager
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.utils.flight_recorder import global_recorder
from pytorch_distributed_example_tpu_torch.dtensor import DTensor, redistribute_tree
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as cp
from pytorch_distributed_example_tpu_torch.parallel import expert_parallel as ep
from pytorch_distributed_example_tpu_torch.utils.cpu_reference import cpu_reference

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
SMEM_PER_BLOCK = 232448  # the most shared memory a block may use on the H100
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the peak rate of the instructions each kernel route does its products with:
# bf16 wgmma; TF32 mma.sync at 495 TFLOP/s dense, three passes to a
# float32-accurate product. "simt" is the float32 FMA peak of the CUDA
# cores, which no route uses: `fma_bound` prints a tf32x3 kernel's bound at
# it beside its own
ROUTE_PEAK_FLOPS = {"wgmma": 989e12, "simt": 67e12, "tf32x3": 495e12 / 3}
LONG_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "16",
             "--n-heads", "16", "--seq", "16384", "--batch-size", "1", "--bf16",
             "--lr", "1e-3"]
LONG_CHECK_LAYERS = 2  # the dense path's f32 scores take 17.2 GB a layer at L 16384
LONG_WARMUP_STEPS = 1
LONG_TIMED_STEPS = 2
RING_WORLD, RING_SHARD = 4, 16384
# the sharded trainer: fsdp 2 x tp 2 in driver mode on cuda:0, the slice's
# width and global work at 4 of its 16 layers (the full depth until the
# whole run neared its time limit; [slice] and [dryrun] keep all 16); the
# MoE at the same width, its depth cut to 2 layers (4 until then)
FSDP_TP_WORLD, FSDP_TP_TP = 4, 2
FSDP_TP_ARGV = SLICE_ARGV + ["--n-layers", "4", "--tp", str(FSDP_TP_TP)]
MOE_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "2", "--n-heads", "16",
            "--seq", "1024", "--batch-size", "4", "--bf16", "--lr", "1e-3",
            "--tp", str(FSDP_TP_TP), "--n-experts", "8"]
FSDP_TP_STEPS = 3  # checked steps, which warm up the timed ones
# bf16 against the single card: o/down's partial products are summed over
# tp where the single card sums in one matmul
SHARDED_LOSS_TOL, SHARDED_GRAD_RMS = 1e-2, 3e-2
EP_WORLD, EP_EXPERTS = 4, 8
# the file that holds each route's kernels (`csrc/flash_attention.cu` holds
# their C interface)
SOURCES = {"wgmma": "pytorch_distributed_example_tpu_torch/csrc/flash_wgmma.cuh",
           "tf32x3": "pytorch_distributed_example_tpu_torch/csrc/flash_tf32x3.cuh"}
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
PHASES = {"resident": ("slice", "fsdp_tp", "dryrun", "ckpt", "multiproc", "planner"),
          "streamed": ("ring", "long", "multiproc_ring")}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def cpu_side(device):
    """The CPU side of a float32 card-vs-CPU check runs primed
    (`utils/cpu_reference.py`: PyTorch's CPU build can compute a process's
    first float32 exp after an MKL batched matmul wrong); the card's side
    as it is."""
    return cpu_reference() if str(device) == "cpu" else contextlib.nullcontext()


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


def bound(kernel, BH, L, D, dtype, causal, route):
    """Least time on the card: each input read once, each output written
    once, over HBM; the products over the (causal) score matrix at the peak
    rate of the route's instructions (`ROUTE_PEAK_FLOPS`). Returns (ms,
    "bytes" | "operations", flops)."""
    es = dtype.itemsize
    pairs = L * (L + 1) // 2 if causal else L * L
    tile, rows = BH * L * D * es, BH * L * 4
    nbytes, flops = {
        "flash_fwd": (4 * tile + rows, 4 * D * pairs * BH),      # q k v -> o lse; QK^T, PV
        "flash_dkdv": (6 * tile + 2 * rows, 8 * D * pairs * BH),  # + dO lse delta -> dk dv; 4 products
        "flash_dq": (5 * tile + 2 * rows, 6 * D * pairs * BH),    # -> dq; 3 products
    }[kernel]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / ROUTE_PEAK_FLOPS[route]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            flops)


def fma_bound(kernel, BH, L, D, dtype, causal, route):
    """For a float32 route on the tensor cores, its bound at the float32 FMA
    peak beside it (", ... at 67 TFLOP/s"); else ""."""
    if route != "tf32x3":
        return ""
    ms = bound(kernel, BH, L, D, dtype, causal, "simt")[0]
    return f"; {ms:.4f} ms at the float32 FMA peak of 67 TFLOP/s"


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
# the wgmma route (F, KV and Q, bf16 operands at every head dim) also rounds
# P and dS to bf16: its tolerance is declared, with its reason, beside the route
WGMMA_TOL = fa.WGMMA_BF16_TOL


def tol_for(route):
    """The kernels' tolerance on a route: the declared one on wgmma (bf16
    operands), the float32 one on tf32x3 (float32 operands)."""
    return WGMMA_TOL if route == "wgmma" else F32_TOL


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
            m = re.search(r"\d(flash_[a-z]+(?:_[a-z0-9]+)*?_kernel)I(\w*?)Li(\d+)E", mangled)
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
                  plain_once=False, want_route=None):
    """Each kernel against its plain version on the same inputs, on the
    route `kernel_route` names for its role (which must be `want_route`'s,
    one route for all roles or a dict by role, where given).
    With `timed`, also each kernel's time (mean of `iters` launches), the
    plain version's (the checking call itself when `plain_once`, else a
    mean of 5), the bound, and the library's call on (B, BH/B, L, D): the
    flash backend for bf16, the efficient one for float32, which the flash
    backend refuses."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + causal)
    q, k, v, do = (torch.randn((BH, L, D), device="cuda", generator=gen,
                               dtype=dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)
    design = {name: fa.kernel_route(dtype, D, name) for name in REPLACES}
    if want_route is not None:
        want = want_route if isinstance(want_route, dict) else dict.fromkeys(REPLACES, want_route)
        check(design == want, f"{dtype} at D {D} takes the {design} routes, not {want}")
    tol = {name: tol_for(route) for name, route in design.items()}
    plain_ms = {}
    o, lse = fa._fwd_cuda(q, k, v, scale, causal)
    o32, _ = fa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    # one plain call gives both outputs: its bf16 o is its float32 o rounded
    (po32, plse), plain_ms["flash_fwd"] = timed_once(
        lambda: fa._fwd_plain(q, k, v, scale, causal, bq, bk, out_dtype=torch.float32))
    po = po32.to(dtype)
    tol32 = tol_for(design["flash_fwd"])
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
    aten = torch.ops.aten
    # The library has no dK/dV-only or dQ-only call: its backward computes
    # dQ, dK and dV together from its own forward's output and lse, so that
    # one call is the yardstick of KV and Q as a pair
    if dtype == torch.bfloat16:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_o, lib_lse, cum_q, cum_k, max_q, max_k, seed, offset = (
            aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal, False,
                                                     scale=scale)[:8])
        fwd_call = ("scaled_dot_product_attention", lambda: sdpa(q4, k4, v4, is_causal=causal))
        bwd_name = "aten._scaled_dot_product_flash_attention_backward (dQ, dK, dV)"

        def sdpa_backward():
            return aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, lib_o, lib_lse, cum_q, cum_k, max_q, max_k, 0.0, causal,
                seed, offset, scale=scale)
    else:
        def lib_forward():
            return aten._scaled_dot_product_efficient_attention(q4, k4, v4, None, True, 0.0,
                                                                causal, scale=scale)

        lib_o, lib_lse, seed, offset = lib_forward()
        fwd_call = ("aten._scaled_dot_product_efficient_attention", lib_forward)
        bwd_name = "aten._scaled_dot_product_efficient_attention_backward (dQ, dK, dV)"

        def sdpa_backward():
            return aten._scaled_dot_product_efficient_attention_backward(
                do4, q4, k4, v4, None, lib_o, lib_lse, seed, offset, 0.0,
                [True, True, True, False], causal, scale=scale)[:3]

    lib_rel = compare(lib_o.reshape(BH, L, D), po32, **tol["flash_fwd"])[1]
    lib_grads = [g.reshape(BH, L, D) for g in sdpa_backward()]
    lib_grel = max(compare(g, w, **tol["flash_dq"])[1]
                   for g, w in zip(lib_grads, (pdq, pdk, pdv)))
    print(f"  library vs the plain versions (timed only): {fwd_call[0]} "
          f"max_abs_err/max|plain| = {lib_rel:.3e}, {bwd_name.split(' ')[0]} {lib_grel:.3e}")
    del lib_grads
    library = {"flash_fwd": fwd_call, "flash_dkdv": (bwd_name, sdpa_backward),
               "flash_dq": (bwd_name, sdpa_backward)}
    lib_ms = {}
    for name in kern:
        r = results[name]
        r["shape"] = f"BH {BH}, L {L}, D {D}, {str(dtype)[6:]}, causal {causal}"
        r["ms"] = time_ms(kern[name], iters=iters, warmup=2 if iters > 5 else 1)
        r["plain_ms"] = (plain_ms[name] if plain_once
                         else time_ms(plain[name], iters=5, warmup=1))
        r["bound_ms"], r["bound_by"], flops = bound(name, BH, L, D, q.dtype, causal,
                                                    design[name])
        r["library_call"], lib_fn = library[name]
        if lib_fn not in lib_ms:
            lib_ms[lib_fn] = time_ms(lib_fn, iters=iters, warmup=2 if iters > 5 else 1)
        r["library_ms"] = lib_ms[lib_fn]
        print(f"  {name}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain"
              f"{' (one call)' if plain_once else ''}, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['ms'] / r['bound_ms']:.1f}x the bound, {flops / r['ms'] / 1e9:.1f} TFLOP/s"
              f"{fma_bound(name, BH, L, D, q.dtype, causal, design[name])}), "
              f"library {r['library_ms']:.4f} ms ({r['library_call']})")
    print(f"  backward pair: KV + Q {results['flash_dkdv']['ms'] + results['flash_dq']['ms']:.4f} "
          f"ms against the library's one call {lib_ms[sdpa_backward]:.4f} ms")
    return results


def fwd_f32_out_check(BH, L, D, causal):
    """F with float32 output from bf16 operands (the ring's per-step
    partials) against its plain version, at the declared tolerance of the
    wgmma route that serves bf16 (P is rounded)."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + 2)
    q, k, v = (torch.randn((BH, L, D), device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)
    o, lse = fa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    (po, plse), plain_ms = timed_once(
        lambda: fa._fwd_plain(q, k, v, scale, causal, bq, bk, out_dtype=torch.float32))
    check(o.dtype == torch.float32, f"flash_fwd returned {o.dtype} for out_dtype float32")
    route = fa.kernel_route(torch.bfloat16, D, "flash_fwd")
    tol = tol_for(route)
    (err, rel, ok), (lerr, _, lok) = compare(o, po, **tol), compare(lse, plse, **LSE_TOL)
    print(f"  flash_fwd [{route}] bf16 -> float32 output, BH={BH} L={L} D={D} causal={causal}: "
          f"max_abs_err={err:.3e} max_abs_err/max|plain|={rel:.3e}, lse {lerr:.3e}; within "
          f"tolerance ({tol_text(tol)}): {ok and lok}; plain {plain_ms:.1f} ms (one call)")
    check(ok and lok, f"flash_fwd with float32 output disagrees with its plain version "
                      f"at BH={BH} L={L} D={D} causal={causal}")


def f64_backward(q, k, v, do, lse, delta, scale, causal):
    """dK, dV and dQ by the plain versions' arithmetic in float64, from the
    same float32 lse and delta, over the whole sequence at once."""
    L = q.shape[1]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(1, 2) * scale
    if causal:
        above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, fa.NEG_INF)
    p = torch.exp(s - lse.double())
    ds = p * (do @ v.transpose(1, 2) - delta.double())
    return ds.transpose(1, 2) @ q * scale, p.transpose(1, 2) @ do, ds @ k * scale


def f64_forward(q, k, v, scale, causal):
    """o and lse by the plain forward's arithmetic in float64 (q scaled
    before q k^T), over the whole sequence at once."""
    L = q.shape[1]
    s = (q.double() * scale) @ k.double().transpose(1, 2)
    if causal:
        above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return p @ v.double() / l, m + torch.log(l)


def f32_large_logit_check(D, causal, BH=8, L=1024):
    """The float32 kernels on heads scaled by 1 to 4 (logits up to 16 times
    randn's), against a float64 copy of the same arithmetic: the forward's
    o and lse, and dK/dV and dQ from the plain forward's lse, each within
    the float32 tolerance of the copy, and no farther from it than twice
    the plain float32 version. On such logits the plain version itself may
    lie past the float32 tolerance from the copy, so the copy, not the
    plain version, is the reference here; how many entries of each lie
    past it is printed."""
    gen = torch.Generator(device="cuda").manual_seed(L + D + causal + 3)
    heads = (torch.arange(BH, device="cuda", dtype=torch.float32) % 4 + 1).view(BH, 1, 1)
    q, k, v, do = (torch.randn((BH, L, D), device="cuda", generator=gen) * heads
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    bq, bk = fa.resolved_block_sizes(L)
    o, lse = fa._fwd_plain(q, k, v, scale, causal, bq, bk)
    delta = (do * o).sum(-1, keepdim=True)
    got = (*fa._fwd_cuda(q, k, v, scale, causal),
           *fa._dkdv_cuda(q, k, v, do, lse, delta, scale, causal),
           fa._dq_cuda(q, k, v, do, lse, delta, scale, causal))
    plain = (o, lse, *fa._dkdv_plain(q, k, v, do, lse, delta, scale, causal, bq, bk),
             fa._dq_plain(q, k, v, do, lse, delta, scale, causal, bq, bk))
    exact = (*f64_forward(q, k, v, scale, causal),
             *f64_backward(q, k, v, do, lse, delta, scale, causal))
    routes = {n: fa.kernel_route(torch.float32, D, n) for n in REPLACES}
    out, text = {}, []
    for name, g, pl, ex in zip(("o", "lse", "dk", "dv", "dq"), got, plain, exact):
        top = float(ex.abs().max())
        allowed = F32_TOL["atol_frac"] * top + F32_TOL["rtol"] * ex.abs()
        errs = [(t.double() - ex).abs() for t in (g, pl)]
        (kerr, kpast), (perr, ppast) = ((float(e.max()) / top, int((e > allowed).sum()))
                                        for e in errs)
        out[name] = (kerr, perr)
        text.append(f"{name} {kerr:.3e} (plain {perr:.3e}; past {tol_text(F32_TOL)} of the "
                    f"copy: {kpast}, plain {ppast})")
        check(kpast == 0 and kerr <= 2 * perr,
              f"{name} at D {D} causal={causal} on large logits: {kpast} entries past the "
              f"float32 tolerance of the float64 copy, {kerr:.3e} of max from it against the "
              f"plain float32 version's {perr:.3e}")
    print(f"  large logits, {routes} BH={BH} L={L} D={D} float32 causal={causal}, heads x1..4, "
          f"max|err|/max|f64| against the float64 copy: " + "; ".join(text))
    return out


# the route of each role for float32 operands: the forward, dK/dV and dQ as
# three TF32 passes on the tensor cores
F32_ROUTES = dict.fromkeys(REPLACES, "tf32x3")


def want_routes(n, design="wgmma"):
    """ROUTE_LAUNCHES after n launches of each role, all on `design`, or
    each on its route in `design`, a dict by role."""
    routes = design if isinstance(design, dict) else dict.fromkeys(REPLACES, design)
    want = {name: 0 for name in fa.ROUTE_LAUNCHES}
    want.update({f"{name}:{routes[name]}": n for name in REPLACES})
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
    # the flash kernels' device time a launch inside the step, beside the
    # CUDA-event means of back-to-back launches in [kernels]
    for ms, n, key in rows:
        if any(w in key for w in KERNEL_GROUPS[0][1]):
            print(f"    flash {ms / n:.4f} ms a launch x{n}: {key[:90]}")
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
    fa.reset_launch_counts()  # the CPU side runs the plain versions: only the card's count
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = toks.to(next(model.parameters()).device)
        with cpu_side(name):
            logits = model(t)
            loss = lm.loss_fn(logits, t)
            loss.backward()
        out[name] = (logits.detach().cpu(), loss.item(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    routes = dict(fa.ROUTE_LAUNCHES)
    check(routes == want_routes(cfg.n_layers, F32_ROUTES),
          f"the float32 model should launch F, KV and Q once a layer on {F32_ROUTES}: {routes}")
    (cl, closs, cg), (gl, gloss, gg) = out["cpu"], out["cuda"]
    check(gl.shape == (2, 256, 256) and torch.isfinite(gl).all(), "bad logits on the card")
    lerr = float((gl - cl).abs().max())
    gerr = max(float((gg[n] - cg[n]).abs().max()) / float(cg[n].abs().max()) for n in cg)
    print(f"  f32 card vs CPU: logits max_abs_err={lerr:.3e}, loss {gloss:.6f} vs "
          f"{closs:.6f}, grads max err / max|grad| = {gerr:.3e}")
    # float32 throughout (TF32 off): only summation order differs
    check(lerr <= 1e-4 and abs(gloss - closs) <= 1e-5 and gerr <= 1e-4,
          "the port on the card disagrees with the CPU reference")
    print(f"  launches on the card (head dim 128, float32): {routes}")
    return routes


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


TRAIN_STEPS = {}  # argv -> (mean step ms, tokens/s, MFU) of its timed steps


def train_phase(argv, warmup_steps, timed_steps, card, check_layers=None, routes="wgmma"):
    """The trainer (`examples/lm.py`) built from `argv`: the first-step
    check (on the model itself, or on a `check_layers`-layer model of the
    same width), warm-up steps, timed steps whose kernel launches are
    counted (all on the wgmma route, or each role on its route in `routes`,
    a dict), then one profiled step. Returns the launches of the timed
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
    launches, got_routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    mean_s = sum(step_s) / len(step_s)
    tok_s = args.batch_size * args.seq / mean_s
    # bench.py's analytic model FLOPs per step (PaLM form), over the peak of
    # the step's dtype
    model_flops = ((6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model * args.seq)
                   * args.batch_size * args.seq)
    mfu = model_flops / mean_s / PEAK_FLOPS[cfg.dtype]
    TRAIN_STEPS[tuple(argv)] = (mean_s * 1e3, tok_s, mfu)
    print(f"  losses {losses}; step times (s) {step_s}")
    print(f"  mean step {mean_s * 1e3:.2f} ms, {tok_s:.0f} tokens/s, MFU {mfu:.4f} "
          f"({model_flops:.4g} model FLOPs per step over {PEAK_FLOPS[cfg.dtype] / 1e12:.0f} "
          f"TFLOP/s), "
          f"peak memory {peak / 2 ** 30:.2f} GiB  [{card}]")
    print(f"  launches in the timed steps: {launches}; by route: {got_routes}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    want = cfg.n_layers * timed_steps
    check(all(launches[n] == want for n in REPLACES),
          f"each kernel should have launched {want} times: {launches}")
    check(got_routes == want_routes(want, routes),
          f"F, KV and Q should have launched {want} times each on the {routes} route: "
          f"{got_routes}")
    print("[profile] one more step under torch.profiler")
    tokens = next_tokens()
    profile_step(lambda: lm.train_step(model, opt, tokens), mean_s * 1e3)
    del model, opt
    torch.cuda.empty_cache()
    return got_routes


# [headdims]: the trainer at the bf16 head dims beside the slice's 128: its
# own defaults (vocab 512, d 256, 4 layers, 8 heads of 32, seq 256, batch 16)
# and CFG_1B's full width as 8 heads of 256 (later flags win), whose
# attention does the slice's operations
HEADDIMS = (32, 256)
HEADDIMS_ARGV = {32: ["--bf16"], 256: SLICE_ARGV + ["--n-heads", "8"]}
HEADDIMS_CHECK_LAYERS = {32: None, 256: LONG_CHECK_LAYERS}  # None: the whole model


def headdims_phase(card):
    """`train_phase` at each of HEADDIMS, the first step checked on
    HEADDIMS_CHECK_LAYERS layers (CFG_1B's width on 2, as [long]'s); then
    that width's step beside [slice]'s from this run. Returns the timed
    steps' launches by head dim."""
    launches = {}
    for D in HEADDIMS:
        argv = HEADDIMS_ARGV[D]
        args = lm.parse_args(argv)
        check(args.d_model // args.n_heads == D,
              f"{argv} gives head dim {args.d_model // args.n_heads}, not {D}")
        print(f"  head dim {D}:")
        launches[f"headdims D {D}"] = train_phase(argv, WARMUP_STEPS, TIMED_STEPS, card,
                                                  check_layers=HEADDIMS_CHECK_LAYERS[D])
    (ms, tok_s, mfu), (s_ms, s_tok_s, s_mfu) = (TRAIN_STEPS[tuple(HEADDIMS_ARGV[256])],
                                               TRAIN_STEPS[tuple(SLICE_ARGV)])
    print(f"  CFG_1B width as 8 heads of 256: {ms:.2f} ms a step, {tok_s:.0f} tokens/s, "
          f"MFU {mfu:.4f}; as [slice]'s 16 heads of 128 in this run: {s_ms:.2f} ms, "
          f"{s_tok_s:.0f} tokens/s, MFU {s_mfu:.4f}  [{card}]")
    return launches


# [float32]: the trainer at its own defaults without --bf16 (vocab 512, d 256,
# 4 layers, 8 heads of 32, seq 256, batch 16): float32 operands, so the
# tf32x3 forward, dK/dV and dQ at head dim 32
FLOAT32_ARGV = []


def float32_phase(card):
    """`train_phase` at the trainer's float32 defaults, each role on its
    float32 route. Returns the timed steps' launches."""
    args = lm.parse_args(FLOAT32_ARGV)
    check(not args.bf16 and args.d_model // args.n_heads == 32,
          f"the trainer's defaults are no longer float32 at head dim 32: {args}")
    return train_phase(FLOAT32_ARGV, WARMUP_STEPS, TIMED_STEPS, card, routes=F32_ROUTES)


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
    check(dict(fa.ROUTE_LAUNCHES) == want_routes(W, F32_ROUTES),
          f"the small float32 ring did not run on the float32 routes {F32_ROUTES}: "
          f"{fa.ROUTE_LAUNCHES}")
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
MNIST_BREAKDOWN_ITERS = 20  # profile_breakdown's timed rounds
# profile_breakdown's clocks must nest: forward <= forward+backward <=
# the no-op step, each within this share of the larger one (PERF.md §6,
# PR 18: the spread of five repeats a world on the card)
MNIST_BREAKDOWN_SLACK = 0.10


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
    gloss, gparams = mnist_ddp_run("cuda", "auto", False)
    with cpu_reference():
        closs, cparams = mnist_ddp_run("cpu", "auto", False)
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


def mnist_coupled_run(mode):
    """MNIST_CHECK_STEPS steps at world 8 with optim.adafactor under
    `mode`, dropout off: (last loss, params on the host, the fallback
    warnings seen, whether the update ended sharded)."""
    tdx.init_process_group(world_size=MNIST_WORLD)
    try:
        ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
        opt = optim.adafactor(1e-3)
        step = ddp.make_train_step(opt, mnist.loss_fn, shard_weight_update=mode)
        x, y = mnist_batch(MNIST_WORLD, "cuda")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p, s = ddp.params, opt.init(ddp.params)
            for _ in range(MNIST_CHECK_STEPS):
                p, s, loss = step(p, s, x, y)
        warned = sum("does not commute" in str(w.message) for w in caught)
        return loss.cpu(), {n: t.cpu() for n, t in p.items()}, warned, step.weight_update_sharded
    finally:
        tdx.destroy_process_group()


def mnist_coupling_check():
    """ZeRO's guards at world 8: adafactor's factored state makes "auto"
    warn once and take the replicated update, whose params are the "off"
    run's bit for bit (deterministic cuDNN, as the auto-vs-off check);
    a chain of clip_by_global_norm and adamw warns when its step is
    built."""
    torch.backends.cudnn.deterministic = True
    try:
        aloss, aparams, awarned, asharded = mnist_coupled_run("auto")
        oloss, oparams, _, _ = mnist_coupled_run("off")
    finally:
        torch.backends.cudnn.deterministic = False
    bitwise = torch.equal(aloss, oloss) and all(torch.equal(aparams[n], oparams[n])
                                                for n in aparams)
    print(f"  adafactor under ZeRO auto at world {MNIST_WORLD}: {awarned} fallback warning(s), "
          f"sharded {asharded}, {MNIST_CHECK_STEPS} steps bitwise the 'off' run's: {bitwise} "
          f"(loss {float(aloss):.6f})")
    check(awarned == 1 and not asharded, "adafactor under ZeRO auto did not fall back once")
    check(bitwise and math.isfinite(float(aloss)), "the adafactor fallback differs from 'off'")

    tdx.init_process_group(world_size=MNIST_WORLD)
    try:
        ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step = ddp.make_train_step(optim.chain(optim.clip_by_global_norm(1.0),
                                                   optim.adamw(1e-3)), mnist.loss_fn)
    finally:
        tdx.destroy_process_group()
    built = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    print(f"  chain(clip_by_global_norm, adamw) step built (sharded {step.weight_update_sharded}) "
          f"with {len(built)} build-time warning(s): {built[0][:90] if built else None}...")
    check(len(built) == 1 and "clip_by_global_norm" in built[0],
          "the norm-coupled chain built without its warning")


def mnist_breakdown(world, card):
    """`profile_breakdown(..., iters=MNIST_BREAKDOWN_ITERS)` on the ConvNet
    at MNIST_BATCH a rank, beside the mean of as many unprofiled steps of
    the instance's own train step (the default: ZeRO at world > 1).
    Returns the five times."""
    ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
    opt = optim.sgd(0.01, momentum=0.5)
    x, y = mnist_batch(world, "cuda")
    step = ddp.make_train_step(opt, mnist.loss_fn)
    params, state = ddp.params, opt.init(ddp.params)
    for _ in range(2):
        params, state, _ = step(params, state, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MNIST_BREAKDOWN_ITERS):
        params, state, _ = step(params, state, x, y)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / MNIST_BREAKDOWN_ITERS
    before = {n: p.clone() for n, p in ddp.params.items()}
    t = ddp.profile_breakdown(opt, mnist.loss_fn, x, y, iters=MNIST_BREAKDOWN_ITERS)
    c = ddp.breakdown_clocks_s
    data = ddp.get_ddp_logging_data()
    print(f"  world {world}: profile_breakdown ({MNIST_BREAKDOWN_ITERS} rounds, 'off' steps) "
          + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in t.items())
          + f"; unprofiled step ({'ZeRO' if step.weight_update_sharded else 'replicated update'}) "
          f"{plain_ms:.4f} ms  [{card}]")
    print(f"  world {world}: clocks (medians) "
          + ", ".join(f"{k} {c[k] * 1e3:.4f}" for k in ("forward", "forward_backward",
                                                       "noop_step", "full_step"))
          + " ms; unclamped differences "
          + ", ".join(f"{k} {c[k] * 1e3:.4f}" for k in ("backward", "optimizer", "comm_exposed"))
          + " ms")
    check(all(math.isfinite(v) and v >= 0 for v in t.values()), "a non-finite or negative time")
    check(t["forward_s"] > 0 and t["full_step_s"] > 0, "profile_breakdown timed nothing")
    check(t["forward_s"] <= 1.5 * t["full_step_s"], "the forward outlasts the full step")
    keep = 1 - MNIST_BREAKDOWN_SLACK
    check(c["forward_backward"] >= keep * c["forward"]
          and c["noop_step"] >= keep * c["forward_backward"],
          f"profile_breakdown's clocks do not nest (forward <= forward+backward <= "
          f"no-op step, within {MNIST_BREAKDOWN_SLACK:.0%})")
    check(data["avg_forward_compute_time_s"] == t["forward_s"]
          and data["avg_backward_comm_time_s"] == t["comm_exposed_s"],
          "profile_breakdown did not fill the logger")
    check(all(torch.equal(before[n], ddp.params[n]) for n in before),
          "profile_breakdown changed the instance's params")
    return t


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
    mnist_coupling_check()
    mnist_train_check()
    for world in (1, MNIST_WORLD):
        tdx.init_process_group(world_size=world)
        try:
            # world 8 at one step a call is [bench]'s headline, at the bench's full depth
            for spc in (1, 8) if world == 1 else (8,):
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
            mnist_breakdown(world, card)
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


# [bench]: the port's entry point as the reference's `bench.py` runs it,
# `bench.main([])` with BENCH_BREAKDOWN=1: DDP-MNIST at world 8, then the
# TransformerLM MFU step (vocab 32000, d 512, 8 layers, 8 heads of 64, L 512,
# B 8, bf16) on the bf16 D 64 wgmma kernels, F, KV and Q 8 times each a step
BENCH_EVENT_STEPS = 10  # steps of the MFU model timed by CUDA events
BENCH_SPEC_PEAK = {"NVIDIA H100 80GB HBM3": 989.0}  # the H100 SXM's dense bf16 TFLOP/s


def bench_line(card, kind):
    """`bench.main([])` with BENCH_BREAKDOWN=1, its printed line checked
    against the one it returns and against what the card must show.
    Returns the line."""
    old = os.environ.get("BENCH_BREAKDOWN")
    os.environ["BENCH_BREAKDOWN"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            line = bench.main([])
    except SystemExit as e:
        raise SmokeFailure(f"bench.main exited {e.code}: {buf.getvalue().strip()[-2000:]}")
    finally:
        if old is None:
            del os.environ["BENCH_BREAKDOWN"]
        else:
            os.environ["BENCH_BREAKDOWN"] = old
    printed = buf.getvalue().strip().splitlines()[-1]
    print(f"  line: {printed}")
    check(json.loads(printed) == line, "bench.main printed another line than it returned")
    pc, bd = line["peak_calibration"], line.get("breakdown_ms", {})
    print(f"  DDP-MNIST {line['value']} samples/s per card at world {line['world']} "
          f"(vs_baseline {line['vs_baseline']}); MFU {line['mfu']} ({line['mfu_tflops']} "
          f"TFLOP/s), hfu {line['hfu']}, step {line['step_ms']:.3f} ms, final loss "
          f"{line['mfu_final_loss']:.4f}; peak {pc}; breakdown {bd}; tiles "
          f"{line['flash_block_q']} x {line['flash_block_k']}; launches a step "
          f"{line['flash_launches']}  [{kind}; {card}]")
    check(line["value"] > 0 and line["platform"] == "gpu" and line["device_kind"] == kind,
          f"bad DDP-MNIST part: value {line['value']}, platform {line['platform']}")
    check(0 < line["mfu"] <= 1, f"mfu {line['mfu']} outside (0, 1]")
    nominal = BENCH_SPEC_PEAK.get(card.split(",")[0].strip(), bench.peak_flops(kind) / 1e12)
    check(pc["nominal_peak_tflops"] == nominal and "calibration_error" not in pc,
          f"the peak's calibration {pc}, not the spec sheet's {nominal} TFLOP/s")
    check(line["flash_launches"] == want_routes(bench.MFU_MODEL["n_layers"]),
          f"the MFU step should launch F, KV and Q 8 times each on wgmma: "
          f"{line['flash_launches']}")
    check(line["hfu"] > 0, f"hfu {line['hfu']}")
    check("breakdown_error" not in line and 0 < bd.get("fwd", 0) < bd.get("fwd_bwd", 0),
          f"breakdown {bd}, error {line.get('breakdown_error')}")
    check(math.isfinite(line["mfu_final_loss"]) and line["mfu_final_loss"] < math.log(32000),
          f"MFU final loss {line['mfu_final_loss']}")
    check(math.isfinite(line["final_loss"]), f"DDP-MNIST final loss {line['final_loss']}")
    return line


def bench_phase(card, kind):
    """The bench's line (`bench_line`); the MFU model's first step with
    flash against dense on the same weights; its step by CUDA events and
    one profiled step. Returns the launches of `bench.main([])`."""
    fa.reset_launch_counts()
    line = bench_line(card, kind)
    launches = dict(fa.ROUTE_LAUNCHES)
    print(f"  launches in bench.main: {launches}")
    check(all(launches[f"{name}:wgmma"] > 0 for name in REPLACES),
          f"bench.main launched a kernel no time: {launches}")
    model, opt, tokens = bench.mfu_setup("cuda")
    first_step_check(model, tokens)

    def step():
        return lm.train_step(model, opt, tokens)

    step()
    event_ms = timed_events(step, BENCH_EVENT_STEPS)
    print(f"  MFU step by CUDA events: {event_ms:.3f} ms (mean of {BENCH_EVENT_STEPS}); "
          f"the line's host-clock step {line['step_ms']:.3f} ms  [{card}]")
    profile_step(step, event_ms)
    del model, opt
    torch.cuda.empty_cache()
    return launches


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


SHARDED_LOSSES = {}  # argv -> the driver-mode losses of its first FSDP_TP_STEPS steps
SHARDED_STEP_MS = {}  # argv -> the mean of its last timed steps, ms


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
    SHARDED_LOSSES[tuple(argv)] = losses  # [multiproc] holds its gang to these
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
    SHARDED_STEP_MS[tuple(argv)] = mean_s * 1e3
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
    """The sharded trainer, dense and MoE at CFG_1B's full width with 4
    layers, then the ep-sharded MoE. Returns the
    dense profiled step's routes."""
    print("  dense:")
    routes, _ = sharded_train(FSDP_TP_ARGV, card, TIMED_STEPS)
    print("  MoE (8 experts, top-1, capacity 1.25; depth cut to 2 layers), float32 first "
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
# CFG_1B (benchmarks/llama_scaled.py:33) at max_seq_len 2048, bf16, at 4 of
# its 16 layers (the full depth until the whole run neared its time limit;
# [elastic]'s serving gang keeps all 16)
SERVE_ARGV = ["--vocab-size", "32000", "--d-model", "2048", "--n-layers", "4",
              "--n-heads", "16", "--seq", "2048", "--bf16"]
SERVE_SLOTS, SERVE_BLOCK = 8, 16
SERVE_GATE = (4, 512)  # prompts x tokens for the decode-path logits gate
SERVE_RMS_TOL = 3e-2  # the flash-vs-dense gate of PERF.md section 2
SERVE_REQUESTS = 24  # the bimodal burst's first 24 (48 until [elastic] needed the time)
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
    width (4 layers) in bf16: the logits gate, token-identical greedy streams between
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
# the determinism construct's requests (prompts 256/512, chunk 256; 16
# until [elastic] needed the time)
FLEET_DET_REQUESTS = 8
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


SERVE_FORCED = (8, 48, 32)  # prompts x tokens, decode steps of the teacher-forced check


def forced_tokens():
    B, L, _ = SERVE_FORCED
    return np.random.default_rng(3).integers(0, 32000, (B, L)).astype(np.int32)


def forced_decode(eng, streams=None):
    """SERVE_FORCED's prompts prefilled through `eng`'s paged prefill
    program, then decoded together, a step at a time, through the engine's
    own decode forward: fed `streams` (B, steps), another engine's tokens
    (teacher forcing), or without them each step's greedy argmax. Returns
    (the tokens fed, (B, steps) int64 on the host; each step's logits,
    (steps, B, V) float32)."""
    B, L, steps = SERVE_FORCED
    fwd = eng.decoder or eng.model
    slots, first = [], []
    for row in forced_tokens():
        slot = eng.cache.allocate()
        check(eng.cache.ensure_blocks(slot, L - 1 + steps), "forced decode: pool too small")
        _, logits = eng._prefill_chunk(eng.cache.tree, row[None],
                                       eng.cache.block_tables[slot:slot + 1], 0)
        slots.append(slot)
        first.append(logits[L - 1].float())
    dev = first[0].device
    bt = torch.as_tensor(eng.cache.block_tables[slots], device=dev)
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    tok = torch.stack(first).argmax(-1)
    fed, out = [], []
    with torch.no_grad():
        for t in range(steps):
            if streams is not None:
                tok = torch.as_tensor(streams[:, t], device=dev)
            fed.append(tok.cpu())
            logits = fwd(tok[:, None].long(), decode=True, positions=pos, block_tables=bt,
                         cache=eng.cache.tree)[:, -1].float()
            out.append(logits)
            tok = logits.argmax(-1)
            pos = pos + 1
    for slot in slots:
        eng.cache.free(slot)
    return torch.stack(fed, 1).numpy(), torch.stack(out)


def forced_rms(got, want):
    """Each decode step's rms(diff)/rms: a list over the steps."""
    return [rel_rms(g, w) for g, w in zip(got, want)]


def fleet_bimodal(model, card, mesh=None):
    """The [serve] phase's bimodal burst (24 requests, 8 slots, unchunked)
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


MOE_TP_REQUESTS = 16
MOE_TP_F32_RMS = 1e-4  # float32 (TF32 off): the tp ranks' partial sums in another order


def fleet_moe_tp(card):
    """The MoE's tensor-parallel decode at MOE_ARGV's shape (d 2048, 2
    layers, 8 experts, top-1) in driver mode at tp 2, against the
    single-card engine on the same weights: the prefill logits through the
    paged programs, float32 (TF32 off) within MOE_TP_F32_RMS and bf16
    within SERVE_RMS_TOL; the greedy streams of the bimodal burst's first
    MOE_TP_REQUESTS requests, whose match is reported (the tp ranks' sums
    in another order can flip a near-tie, as 1 of 857 float32 tokens did
    on the H100, and in bf16 move a token to another expert); and each
    step's logits of the single card's greedy streams fed to the tp 2
    engine (`forced_decode`), within the prefill gate's limit."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    B, L = SERVE_GATE
    toks = np.random.default_rng(1).integers(0, 32000, (B, L)).astype(np.int32)
    kw = dict(slots=B, block_size=SERVE_BLOCK, min_bucket=8)
    for bf16 in (False, True):
        argv = MOE_ARGV if bf16 else [a for a in MOE_ARGV if a != "--bf16"]
        model = TransformerLM(lm.config_for(lm.parse_args(argv)), device="cuda",
                              generator=torch.Generator("cuda").manual_seed(0))
        name = "bf16" if bf16 else "float32"
        single = engine_prefill_logits(ServeEngine(model, **kw), toks)
        tp2 = engine_prefill_logits(ServeEngine(model, mesh=tp_mesh(FLEET_TP), **kw), toks)
        r, tol = rel_rms(tp2, single), (SERVE_RMS_TOL if bf16 else MOE_TP_F32_RMS)
        del single, tp2
        fkw = dict(slots=SERVE_FORCED[0], block_size=SERVE_BLOCK, min_bucket=8)
        streams, want = forced_decode(ServeEngine(model, **fkw))
        _, got = forced_decode(ServeEngine(model, mesh=tp_mesh(FLEET_TP), **fkw), streams)
        steps = forced_rms(got, want)
        del got, want
        outs = []
        for mesh in (None, tp_mesh(FLEET_TP)):
            eng, wall = serve_run(model, bimodal_traffic(MOE_TP_REQUESTS), slots=SERVE_SLOTS,
                                  block_size=SERVE_BLOCK, min_bucket=8, mesh=mesh)
            outs.append((completions(eng), wall))
            del eng
        same, total, reqs = match_rate(outs[0][0], outs[1][0])
        print(f"  MoE tp {FLEET_TP} decode ({name}, {model.cfg.n_experts} experts, "
              f"{model.cfg.n_layers} layers, d {model.cfg.d_model}): prefill logits vs the "
              f"single card rms(diff)/rms {r:.4e} (<= {tol:g}); {same} of {total} greedy "
              f"tokens equal, {reqs} of {MOE_TP_REQUESTS} requests whole; {outs[0][1]:.3f} s "
              f"at tp 1, {outs[1][1]:.3f} s at tp {FLEET_TP}  [{card}]")
        print(f"  MoE tp {FLEET_TP} decode ({name}), the single card's greedy tokens fed to "
              f"{SERVE_FORCED[0]} slots for {SERVE_FORCED[2]} steps: each step's logits "
              f"rms(diff)/rms at most {max(steps):.4e} (mean {sum(steps) / len(steps):.4e}, "
              f"<= {tol:g})")
        check(r <= tol, f"the MoE's tp decode logits stray from the single card ({name})")
        check(max(steps) <= tol, f"the MoE's tp decode-step logits stray from the single "
              f"card's ({name})")
        check(len(outs[1][0]) == MOE_TP_REQUESTS, "the MoE's tp 2 engine lost requests")
        del model
        torch.cuda.empty_cache()


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
    checks, then CFG_1B at full width (4 layers) in bf16: tensor-parallel decode,
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
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet_moe_tp(card)
    print(f"  MoE tp decode in {time.perf_counter() - t0:.1f} s")
    routes = dict(fa.ROUTE_LAUNCHES)
    print(f"  flash launches on the serve_fleet path: {dict(fa.LAUNCHES)}")
    check(sum(fa.LAUNCHES.values()) == 0, "a flash kernel launched on the serve_fleet path")
    return routes


# ---------------------------------------------------------------------------
# [cifar] and [bert]: the BASELINE's ResNet-18/CIFAR-10 and BERT-base
# fine-tune workloads under driver-mode DDP at world 8 on cuda:0
# ---------------------------------------------------------------------------

DDP8 = 8
CIFAR_BATCH = 128  # a rank, as the reference's benchmarks/resnet_ddp.py
CIFAR_CHECK_BATCH = 4  # a rank, for the card-vs-CPU step
CIFAR_BENCH = dict(warmup=3, steps=5, windows=2)  # 3 windows until [elastic]
BERT_BATCH, BERT_SEQ = 16, 128  # a rank, as the reference's benchmarks/bert_finetune.py
BERT_BENCH = dict(warmup=2, steps=3, windows=2)  # 3 windows until [elastic]
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
    with cpu_reference():
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
    with cpu_reference():
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
# CFG_1B's width at 8 of its 16 blocks, 2 a stage over pp 4 (the full depth
# until the whole run neared its time limit)
PIPE_ARGV = SLICE_ARGV + ["--n-layers", "8"]
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
        with cpu_side(dev):
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
            with cpu_side(dev):
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
    """(c) 8 of CFG_1B's blocks over pp 4 (2 a stage), bf16, flash on; M
    microbatches of 1 x seq tokens from the embedding; the loss the final
    norm, LM head and cross-entropy on the same weights. 1F1B's loss and
    stage gradients against the unpipelined blocks; GPipe against 1F1B;
    interleaved (8 stages of 1 over 4) against the sequential forward; the
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
          f"of 1 x {L} tokens (and M {PIPE_MICRO_BIG} for the memory check); depth cut "
          f"to {cfg.n_layers} of CFG_1B's 16 blocks")
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
    # interleaved: V * S stages over the 4 pp ranks, forward
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


# checkpoints: the rank-0 save/load of the CFG_1B trainer with bitwise
# resume, DCP over the fsdp 2 x tp 2 state, the integrity layer on the card
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ckpt_smoke")
CKPT_STEPS = 2  # steps before the save; the next one is taken live and resumed
CKPT_DISK_MARGIN = 2 ** 30


def dtensor_leaves(tree):
    """A tree's DTensors and tensors, in order (its Python leaves left out)."""
    return [l for l in torch.utils._pytree.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, DTensor)) if isinstance(l, (DTensor, torch.Tensor))]


def tree_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in (l._local if isinstance(l, DTensor) else l for l in dtensor_leaves(tree)))


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def bits(t):
    """A tensor's words, for bitwise comparison (-0.0 and NaN included)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and torch.equal(bits(a), bits(b)))


def need_disk(nbytes, what):
    free = shutil.disk_usage(os.path.dirname(CKPT_DIR)).free
    print(f"  free disk before {what}: {free} bytes; it writes ~{nbytes} bytes")
    check(free >= nbytes + CKPT_DISK_MARGIN,
          f"{what} needs {nbytes + CKPT_DISK_MARGIN} bytes of free disk, {free} are free")


def gbs(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds > 0 else float("inf")


def rank0_resume(card):
    """CFG_1B's single-card trainer (f32 params, AdamW): CKPT_STEPS steps,
    `save_checkpoint`, the next step; then a model and optimizer from
    another seed, `load_checkpoint`, and that step again. The loaded state
    must be bitwise the saved one (on the card, in its dtypes), and the
    resumed step's loss and params bitwise the uninterrupted one's.
    Returns the number of train steps taken."""
    args = lm.parse_args(CKPT_ARGV)
    model, opt, next_tokens = lm.build(args, world=1)
    cfg = model.cfg
    toks = [next_tokens() for _ in range(CKPT_STEPS + 1)]
    for t in toks[:CKPT_STEPS]:
        lm.train_step(model, opt, t)
    torch.cuda.synchronize()
    params, ostate = model.state_dict(), opt.state_dict()
    p_bytes, o_bytes = tree_bytes(params), tree_bytes(ostate["state"])
    print(f"  CFG_1B ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, f32, "
          f"AdamW): state {p_bytes} bytes of params + {o_bytes} of optimizer state")
    need_disk(p_bytes + o_bytes, "the rank-0 checkpoint")
    clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
    saved = (torch.utils._pytree.tree_map(clone, params),
             torch.utils._pytree.tree_map(clone, ostate))
    path = os.path.join(CKPT_DIR, "rank0")
    t0 = time.perf_counter()
    T = {}
    save_checkpoint(path, params, ostate, step=CKPT_STEPS, timings=T)
    save_s = time.perf_counter() - t0
    written = dir_bytes(path)
    print(f"  save: {save_s:.2f} s for {written} bytes written ({gbs(written, save_s):.2f} GB/s): "
          f"device->host {T['to_host']:.2f} s ({gbs(p_bytes + o_bytes, T['to_host']):.2f} GB/s), "
          f"npz write {T['write']:.2f} s ({gbs(written, T['write']):.2f} GB/s), CRC + fsync "
          f"{T['seal']:.2f} s ({gbs(written, T['seal']):.2f} GB/s)")
    del params, ostate
    want_loss = lm.train_step(model, opt, toks[CKPT_STEPS])
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model2 = TransformerLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    opt2 = lm.make_optimizer(model2, args.lr)
    t0 = time.perf_counter()
    T = {}
    params, ostate, step, _ = load_checkpoint(path, saved[0], saved[1], timings=T)
    load_s = time.perf_counter() - t0
    print(f"  load: {load_s:.2f} s ({gbs(written, load_s):.2f} GB/s): CRC verify {T['verify']:.2f} s "
          f"({gbs(written, T['verify']):.2f} GB/s), npz read {T['read']:.2f} s "
          f"({gbs(written, T['read']):.2f} GB/s), host->device {T['to_device']:.2f} s "
          f"({gbs(p_bytes + o_bytes, T['to_device']):.2f} GB/s)")
    pairs = list(zip(dtensor_leaves(saved), dtensor_leaves((params, ostate))))
    state_ok = step == CKPT_STEPS and len(pairs) == len(dtensor_leaves(saved)) and all(
        same_bits(a, b) for a, b in pairs)
    print(f"  the loaded state is bitwise the saved one ({len(pairs)} tensors, on their devices, "
          f"in their dtypes): {state_ok}")
    check(state_ok, "the rank-0 checkpoint did not load bitwise")
    del saved
    model2.load_state_dict(params)
    opt2.load_state_dict(ostate)
    del params, ostate
    got_loss = lm.train_step(model2, opt2, toks[CKPT_STEPS])
    resumed = same_bits(got_loss, want_loss) and all(
        same_bits(p.detach(), want[n]) for n, p in model2.named_parameters())
    peak = torch.cuda.max_memory_allocated()
    print(f"  step {CKPT_STEPS + 1}: loss {float(want_loss):.6f} uninterrupted, "
          f"{float(got_loss):.6f} resumed; loss and every param bitwise equal: {resumed}; "
          f"peak device memory of the resume {peak / 2 ** 30:.2f} GiB  [{card}]")
    check(resumed, "the resumed CFG_1B step is not bitwise the uninterrupted one")
    del model2, opt2, want
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    return CKPT_STEPS + 2


def fsdp_state_specs(mod, state):
    """Each leaf's spec: a param's, its optimizer moments' the same,
    scalars replicated."""
    specs = {"params": dict(mod.param_specs), "optim": {}}
    for name, st in state["optim"].items():
        specs["optim"][name] = {k: mod.param_specs[name] if isinstance(v, DTensor) else ()
                                for k, v in st.items()}
    return specs


def same_state(a, b):
    """Bitwise equal leaves and layouts of two DTensor trees."""
    la, lb = dtensor_leaves(a), dtensor_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, DTensor):
            if not (isinstance(y, DTensor) and x.placements == y.placements
                    and x.device_mesh == y.device_mesh and same_bits(x._local, y._local)):
                return False
        elif not same_bits(x, y):
            return False
    return True


# both checkpoints at CFG_1B's width and 1 layer (16 until [elastic], 8
# until the float32 large-logit checks, 4 until the whole run neared its
# time limit, 2 until [bench]): the disk's writes dominate the phase
CKPT_ARGV = SLICE_ARGV + ["--n-layers", "1"]
CKPT_SHARDED_ARGV = FSDP_TP_ARGV + ["--n-layers", "1"]


def sharded_ckpt(card):
    """CFG_1B's width at 1 layer over fsdp 2 x tp 2 after one step: `dcp_save` (each rank's
    shard its own entry); `dcp_load` into the same layout, bitwise, and a
    step from that restored state against the live step, bitwise; 4 -> 1
    into `resharded_template`'s single-card layout, bitwise
    `redistribute_tree`'s global values; `dcp_async_save` of that
    single-card state (foreground and durable seconds, a train step taken
    while the write lands against the step alone); 1 -> 4 from it back
    into fsdp 2 x tp 2, bitwise. Returns the number of train steps taken."""
    from torch.distributed.checkpoint import FileSystemReader

    args = lm.parse_args(CKPT_SHARDED_ARGV)
    mod, opt, next_tokens = lm.build(args, world=FSDP_TP_WORLD)
    lm.train_step(mod, opt, next_tokens())
    steps = 1
    state = mod.state_dict(opt)
    specs = fsdp_state_specs(mod, state)
    nbytes = tree_bytes(state)
    need_disk(nbytes, "the sharded checkpoints (one at a time)")
    p4 = os.path.join(CKPT_DIR, "fsdp_tp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tdx.dcp_save(state, p4)
    save_s = time.perf_counter() - t0
    written = dir_bytes(p4)
    md = FileSystemReader(p4).read_metadata()
    n_leaves = len(dtensor_leaves(state))
    print(f"  dcp_save of the fsdp 2 x tp 2 state ({nbytes} bytes, {n_leaves} leaves): "
          f"{save_s:.2f} s, {written} bytes written ({gbs(written, save_s):.2f} GB/s); "
          f"{len(md.state_dict_metadata)} DCP entries (one a rank's shard)")
    check(len(md.state_dict_metadata) > n_leaves, "the ranks' shards are not separate entries")
    t0 = time.perf_counter()
    stats = {}
    same = tdx.dcp_load(state, p4, stats=stats)
    print(f"  dcp_load into the same layout: {time.perf_counter() - t0:.2f} s "
          f"({gbs(stats['read_bytes'], stats['seconds']):.2f} GB/s, CRC verify "
          f"{stats['verify_s']:.2f} s); bitwise: {same_state(state, same)}")
    check(same_state(state, same), "dcp_load into the same layout is not bitwise")

    mesh1 = tdx.DeviceMesh(["cuda:0"], (1, 1), ("fsdp", "tp"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = {}
    one = tdx.dcp_load(tdx.resharded_template(state, mesh1, specs=specs), p4, stats=stats)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated() - base
    ok4 = True
    for (path, a), b in zip(_flat(state), dtensor_leaves(one)):
        if isinstance(a, DTensor):
            ok4 &= same_bits(redistribute_tree(a, mesh1, _spec_at(specs, path))._local, b._local)
        else:  # a scalar (AdamW's step count) lands on the mesh's device
            ok4 &= same_bits(a.cpu(), b.full_tensor().cpu())
    print(f"  4 -> 1 into resharded_template's single-card layout: {reshard_s:.2f} s; the global "
          f"values bitwise (redistribute_tree): {ok4}; peak host bytes held by the load "
          f"{stats['peak_host_bytes']} (of {nbytes}), process max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes; device memory "
          f"above the live state {dev_peak} bytes  [{card}]")
    check(ok4, "the 4 -> 1 reshard is not bitwise the global values")
    shutil.rmtree(p4)

    tokens = next_tokens()
    want_loss = lm.train_step(mod, opt, tokens)
    want = {k: v._local.detach().clone() for k, v in mod.params.items()}
    mod.load_state_dict(same, opt)
    got_loss = lm.train_step(mod, opt, tokens)
    steps += 2
    resumed = same_bits(got_loss, want_loss) and all(
        same_bits(v._local.detach(), want[k]) for k, v in mod.params.items())
    print(f"  one sharded step from the restored state against the live one: loss "
          f"{float(got_loss):.6f} vs {float(want_loss):.6f}; loss and params bitwise: {resumed}")
    check(resumed, "the sharded step from the restored state is not bitwise the live one")
    del want
    torch.cuda.empty_cache()

    def timed_step():
        batch = next_tokens()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.train_step(mod, opt, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    alone = [timed_step() for _ in range(2)]
    p1 = os.path.join(CKPT_DIR, "single")
    t0 = time.perf_counter()
    handle = cs.dcp_async_save(one, p1)
    fg_s = time.perf_counter() - t0
    del one
    during = timed_step()
    writing = not handle.done()
    handle.result()
    durable_s = handle.finished_at - t0
    steps += 3
    print(f"  dcp_async_save of the single-card state: foreground {fg_s:.2f} s, durable after "
          f"{durable_s:.2f} s; a train step while the write lands {during:.2f} ms (still "
          f"writing when it ended: {writing}) against {alone[-1]:.2f} ms alone "
          f"({[round(t, 2) for t in alone]})  [{card}]")
    four = tdx.dcp_load(state, p1)
    ok1 = same_state(same, four)
    print(f"  1 -> 4 from the single-card save into fsdp 2 x tp 2: bitwise: {ok1}")
    check(ok1, "the 1 -> 4 reshard is not bitwise the saved state")
    shutil.rmtree(p1)
    del mod, opt, state, same, four
    torch.cuda.empty_cache()
    return steps


def _flat(tree):
    return [(p, l) for p, l in torch.utils._pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, DTensor))[0]
        if isinstance(l, (DTensor, torch.Tensor))]


def _spec_at(specs, path):
    node = specs
    for k in path:
        node = node[k.key]
    return node


def ckpt_integrity(card):
    """A byte flipped in `arrays.npz` and one in a DCP step's `.metadata`:
    each is caught by the CRC, quarantined, and the load falls back to the
    last good copy, on card tensors."""
    import warnings

    tree = lambda v: {"w": torch.full((64, 3), v, device="cuda"),  # noqa: E731
                      "h": torch.full((8,), v, device="cuda").to(torch.bfloat16)}
    path = os.path.join(CKPT_DIR, "small")
    save_checkpoint(path, tree(1.0), step=1)
    save_checkpoint(path, tree(2.0), step=2)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, _, step, _ = load_checkpoint(path, tree(0.0))
    quarantined = [n for n in os.listdir(CKPT_DIR) if n.startswith("small.quarantine")]
    npz_ok = (step == 1 and float(got["w"][0, 0]) == 1.0 and got["w"].device.type == "cuda"
              and bool(quarantined) and any("corrupt" in str(x.message) for x in w))
    mgr = tdx.DCPCheckpointer(os.path.join(CKPT_DIR, "mgr"), max_to_keep=3)
    mesh = tdx.DeviceMesh(["cuda:0"] * 2, (2,), ("fsdp",))
    from pytorch_distributed_example_tpu_torch.dtensor import Shard, distribute_tensor

    dt = lambda v: {"w": distribute_tensor(torch.full((4, 3), v, device="cuda"),  # noqa: E731
                                           mesh, [Shard(0)])}
    mgr.save(0, dt(1.0))
    mgr.save(1, dt(2.0))
    with open(os.path.join(CKPT_DIR, "mgr", "1", ".metadata"), "r+b") as f:
        f.seek(0)
        f.write(b"\x00CORRUPT")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        restored = mgr.restore(template=dt(0.0))
    dcp_ok = (float(restored["w"].full_tensor()[0, 0]) == 1.0 and mgr.all_steps() == [0]
              and any("quarantine.step1" in n for n in os.listdir(CKPT_DIR))
              and any("corrupt" in str(x.message) for x in w))
    print(f"  integrity on the card: arrays.npz byte flip caught, quarantined, fell back to "
          f"step 1: {npz_ok}; DCP .metadata byte flip caught, step quarantined, fell back to "
          f"step 0: {dcp_ok}")
    check(npz_ok and dcp_ok, "the checkpoint integrity layer failed on the card")


def ckpt_phase(card):
    """Rank-0 resume of the CFG_1B trainer, the sharded checkpoint of the
    fsdp 2 x tp 2 state, the integrity layer. Returns the phase's flash
    launches by route (its train steps' F, KV and Q)."""
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    try:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        n1 = rank0_resume(card)
        print(f"  rank-0 resume in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        n4 = sharded_ckpt(card)
        print(f"  sharded checkpoint in {time.perf_counter() - t0:.1f} s")
        routes = dict(fa.ROUTE_LAUNCHES)
        want = (lm.config_for(lm.parse_args(CKPT_ARGV)).n_layers * n1
                + lm.config_for(lm.parse_args(CKPT_SHARDED_ARGV)).n_layers * n4)
        print(f"  flash launches in the phase's {n1} single-card and {n4} sharded steps: "
              f"{dict(fa.LAUNCHES)}; by route: {routes}")
        check(routes == want_routes(want),
              f"F, KV and Q should each launch {want} times on the wgmma route: {routes}")
        ckpt_integrity(card)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return routes


# the remaining training utilities: AMP (fp16 BERT-base), post-local SGD
# and Join on DDP-MNIST, the quantized hook through the eager Reducer
AMP_STEPS = 3
# each fp16 step against plain float32 torch on the same params: its loss
# within 1e-2; its all-reduced mean gradient, unscaled and then clipped,
# within 5e-2 by relative norm (on the H100 the first step reads 2.283e-2
# unscaled, 1.237e-2 clipped: random-init BERT-base's small gradient, norm
# 2.3, in fp16 throughout; 1.8e-3 at norm 54)
AMP_LOSS_TOL = 1e-2
AMP_GRAD_TOL = 5e-2
# the hand-written float32 step against the port's DDP step with the same
# clip and adamw, |dloss| (they agree bitwise on the H100)
AMP_WITNESS_TOL = 1e-5
AMP_TIMED = 3
LOCALSGD = dict(period=4, warmup_steps=2)
LOCALSGD_STEPS = 16
# the float32 card against the float32 CPU: within 1e-5 of a leaf's largest
# entry (and of the loss) over the warm-up steps; after them, within twice
# the CPU's own distance from a float64 run plus 1e-6. The float32 runs of
# either side part from float64 by up to 5e-2 of a leaf's largest entry
# over the 16 steps on the H100's host (a step's rounding moves a later
# step's routing through max-pool and ReLU), so no fixed float32 limit
# holds there. The float64 runs, card against CPU, are held to 1e-12 at
# every step (7.9e-16 at worst on the H100), and a planted fault (one
# replica left out of each average) must break that limit
LOCALSGD_EARLY_TOL = 1e-5
LOCALSGD_ENVELOPE, LOCALSGD_FLOOR = 2.0, 1e-6
LOCALSGD_F64_TOL = 1e-12
JOIN_BATCH, JOIN_MAX = 16, 12  # rank r holds JOIN_MAX - r batches of JOIN_BATCH
JOIN_TOL = dict(rtol=2e-4, atol=2e-5)
PR10_HOOK_MS = 58.99  # the int8 per-leaf hook inside PR 10's BERT DDP step (PERF.md)


def amp_bert(policy_name, steps, inject_rank=None, timed=0, reference=False):
    """BERT-base fine-tune at world 8 x 16 x 128 (dropout off, adamw(2e-5))
    under `policy_name`, written with the port's pieces: the rank vmap of
    grad of the scaled loss, GradScaler.unscale with the cross-rank verdict
    (the min over the rank dim), the c10d AVG all-reduce, clip_grad_norm_
    (1.0), adamw, where_finite and update. Returns a dict: each step's
    loss, verdict, scale and pre-clip gradient norm; with `reference`,
    each step held against plain float32 torch on the same params (its
    loss, its clipped mean gradient by relative norm and the adamw update
    that gradient gives, on a finite step) and the verdict against
    isfinite over every rank's gradients; ms of the timed steps; the
    inject step's (skipped bitwise, scale before, after)."""
    from torch.func import functional_call, grad_and_value, vmap

    from pytorch_distributed_example_tpu_torch import amp
    from pytorch_distributed_example_tpu_torch.nn.utils import clip_grad_norm_

    policy = amp.get_policy(policy_name)
    pg = tdx.init_process_group(world_size=DDP8)
    try:
        cfg = BertConfig(max_seq_len=BERT_SEQ, dtype=policy.compute_dtype, dropout=0.0,
                         **bench.BERT_PRESETS["base"])
        model = BertForSequenceClassification(cfg, num_labels=2, device="cpu",
                                              generator=torch.Generator().manual_seed(0)).cuda()
        params = policy.cast_to_param({n: p.detach() for n, p in model.named_parameters()})
        opt = optim.adamw(2e-5)
        state = opt.init(params)
        scaler = amp.GradScaler()
        sstate = scaler.init("cuda")
        xs, ys = amp_batch(cfg.vocab_size)

        def scaled_loss(p, x, y, s):
            logits = policy.cast_to_output(functional_call(model, p, (x,)))
            return scaler.scale(torch.nn.functional.cross_entropy(logits, y), s)

        per_rank = vmap(grad_and_value(scaled_loss), in_dims=(None, 0, 0, None))
        names = list(params)
        model32 = BertForSequenceClassification(
            dataclasses.replace(cfg, dtype=torch.float32), num_labels=2, device="meta")

        def f32_step(p):
            """Plain float32 torch on params `p`: the mean over the ranks of
            the loss and of the gradients, and those clipped to norm 1.0."""
            one = lambda p, x, y: torch.nn.functional.cross_entropy(  # noqa: E731
                functional_call(model32, p, (x,)), y)
            g, loss = vmap(grad_and_value(one), in_dims=(None, 0, 0))(p, xs, ys)
            mean = {n: g[n].mean(0) for n in names}
            return float(loss.mean()), mean, clip_plain(mean)

        def step(params, state, sstate, inject=None):
            grads, scaled = per_rank(params, xs, ys, sstate)
            if inject is not None:
                grads[names[0]][inject].view(-1)[0] = float("inf")
            every = all(bool(torch.isfinite(grads[n]).all()) for n in names) if reference else None
            grads, finite = scaler.unscale(grads, sstate, axis_name="ranks")
            flat = DistTensor.wrap(torch.cat([grads[n].reshape(DDP8, -1) for n in names], 1), pg)
            tdx.all_reduce(flat, tdx.ReduceOp.AVG, pg)
            mean, off = {}, 0
            for n in names:
                k = params[n].numel()
                mean[n] = flat.tensor[0, off:off + k].view(params[n].shape)
                off += k
            loss = DistTensor.wrap(scaled / sstate.scale, pg)
            tdx.all_reduce(loss, tdx.ReduceOp.AVG, pg)
            clipped, total = clip_grad_norm_(mean, 1.0)
            updates, new_state = opt.update(clipped, state, params)
            new_params = optim.apply_updates(params, updates)
            return (scaler.where_finite(finite, new_params, params),
                    scaler.where_finite(finite, new_state, state),
                    scaler.update(sstate, finite), loss.tensor[0], finite,
                    dict(mean=mean, clipped=clipped, updates=updates, norm=float(total),
                         every=every))

        out = dict(losses=[], finite=[], scales=[], norms=[], ref_losses=[], mean_rel=[],
                   grad_rel=[], update_rel=[], verdict_ok=[])
        for _ in range(steps):
            ref = f32_step(params) if reference else None
            prev = (params, state)
            params, state, sstate, loss, finite, seen = step(params, state, sstate)
            out["losses"].append(float(loss))
            out["finite"].append(bool(finite))
            out["scales"].append(float(sstate.scale))
            out["norms"].append(seen["norm"])
            if reference:
                out["ref_losses"].append(ref[0])
                out["verdict_ok"].append(seen["every"] == bool(finite))
                if bool(finite):
                    want_updates, _ = opt.update(ref[2], prev[1], prev[0])
                    out["mean_rel"].append(rel_norm(seen["mean"], ref[1]))
                    out["grad_rel"].append(rel_norm(seen["clipped"], ref[2]))
                    out["update_rel"].append(rel_norm(seen["updates"], want_updates))
                else:
                    for k in ("mean_rel", "grad_rel", "update_rel"):
                        out[k].append(None)
        if timed:
            times = []
            for _ in range(timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, sstate, loss, finite, _ = step(params, state, sstate)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["ms"] = times
        if inject_rank is not None:
            old = ({n: t.clone() for n, t in params.items()},
                   torch.utils._pytree.tree_map(torch.clone, state), float(sstate.scale))
            params, state, sstate, _, finite, seen = step(params, state, sstate,
                                                          inject=inject_rank)
            skipped = (not bool(finite) and seen["every"] is not True
                       and all(same_bits(params[n], old[0][n]) for n in names)
                       and all(same_bits(a, b) for a, b in zip(
                           torch.utils._pytree.tree_leaves(state),
                           torch.utils._pytree.tree_leaves(old[1]))))
            out["injected"] = (skipped, old[2], float(sstate.scale))
        return out
    finally:
        tdx.destroy_process_group()


def amp_batch(vocab):
    """The fine-tune's fixed batch: (8, 16, 128) token ids, (8, 16) labels."""
    gen = np.random.default_rng(0)
    xs = torch.from_numpy(gen.integers(0, vocab, (DDP8, BERT_BATCH, BERT_SEQ))).cuda()
    return xs, torch.from_numpy(gen.integers(0, 2, (DDP8, BERT_BATCH))).cuda()


def clip_plain(grads, max_norm=1.0):
    """`grads` scaled to a global 2-norm of at most `max_norm`, in plain
    torch (torch's clip_grad_norm_ formula)."""
    total = float(torch.stack([(g.double() ** 2).sum() for g in grads.values()]).sum()) ** 0.5
    return {n: g * min(1.0, max_norm / (total + 1e-6)) for n, g in grads.items()}


class ClippedAdamW:
    """adamw(2e-5) after a global-norm clip to 1.0 (optax's chain of
    clip_by_global_norm and adamw), for the DDP step's unsharded update."""

    def __init__(self):
        self.inner = optim.adamw(2e-5)

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        return self.inner.update(clip_plain(grads), state, params)


def rel_norm(a, b):
    """||a - b|| / ||b|| over every leaf of two trees of tensors, in float64."""
    num = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in b)
    return (num / sum(float((b[n].double() ** 2).sum()) for n in b)) ** 0.5


def amp_witness(steps):
    """The same fine-tune in float32 through the port's DDP step
    (`make_ddp_train_step`, ZeRO off, the clip in plain torch before
    adamw(2e-5), no scaler): its losses, a second witness of the
    hand-written float32 step's."""
    tdx.init_process_group(world_size=DDP8)
    try:
        cfg = BertConfig(max_seq_len=BERT_SEQ, dropout=0.0, **bench.BERT_PRESETS["base"])
        model = BertForSequenceClassification(cfg, num_labels=2, device="cpu",
                                              generator=torch.Generator().manual_seed(0)).cuda()
        ddp = tdx.DistributedDataParallel(model)
        opt = ClippedAdamW()
        step = ddp.make_train_step(opt, torch.nn.functional.cross_entropy,
                                   shard_weight_update="off")
        xs, ys = amp_batch(cfg.vocab_size)
        p, s, losses = ddp.params, opt.init(ddp.params), []
        for _ in range(steps):
            p, s, loss = step(p, s, xs.reshape(-1, BERT_SEQ), ys.reshape(-1))
            losses.append(float(loss))
        return losses
    finally:
        tdx.destroy_process_group()


def amp_check(card):
    f32 = amp_bert("f32", AMP_STEPS, timed=AMP_TIMED)
    witness = amp_witness(AMP_STEPS)
    fp16 = amp_bert("fp16", AMP_STEPS, inject_rank=3, timed=AMP_TIMED, reference=True)
    skipped, before, after = fp16["injected"]
    fmt = lambda v: "-" if v is None else f"{v:.3e}"  # noqa: E731
    loss_err = max(abs(a - b) for a, b in zip(fp16["losses"], fp16["ref_losses"]))
    grad_err = max([v for k in ("mean_rel", "grad_rel") for v in fp16[k] if v is not None],
                   default=0.0)
    witness_err = max(abs(a - b) for a, b in zip(f32["losses"], witness))
    print(f"  AMP fp16 BERT-base, world {DDP8} x {BERT_BATCH} x {BERT_SEQ}, adamw(2e-5), dropout "
          f"off: losses {fp16['losses']}, finite {fp16['finite']}, scales {fp16['scales']}, "
          f"pre-clip gradient norms {[round(v, 4) for v in fp16['norms']]}")
    print(f"  each fp16 step against plain float32 on the same params: loss "
          f"{fp16['ref_losses']} (worst |dloss| {loss_err:.3e}, limit {AMP_LOSS_TOL:g}); "
          f"mean gradient rel norm, unscaled {[fmt(v) for v in fp16['mean_rel']]} and clipped "
          f"{[fmt(v) for v in fp16['grad_rel']]} (limit {AMP_GRAD_TOL:g}; - a skipped step); "
          f"the adamw update from the same state, rel norm "
          f"{[fmt(v) for v in fp16['update_rel']]}; verdict = isfinite over every rank's "
          f"gradients: {fp16['verdict_ok']}")
    print(f"  the float32 run: losses {f32['losses']} (finite {f32['finite']}, pre-clip norms "
          f"{[round(v, 4) for v in f32['norms']]}); the port's DDP step in float32, the clip and "
          f"adamw(2e-5), on the same batch: {witness} (worst |dloss| {witness_err:.3e}, limit "
          f"{AMP_WITNESS_TOL:g})")
    print(f"  an inf in rank 3's gradients: every rank skipped, params and adamw state bitwise: "
          f"{skipped}; scale {before:g} -> {after:g}")
    print(f"  step times (ms): fp16 {[round(t, 2) for t in fp16['ms']]}, float32 "
          f"{[round(t, 2) for t in f32['ms']]}; PR 10's bf16 DDP step 157.08 ms  [{card}]")
    check(all(fp16["verdict_ok"]), "the cross-rank verdict disagrees with the ranks' gradients")
    check(loss_err <= AMP_LOSS_TOL, "an fp16 loss strays from float32 on the same params")
    check(any(fp16["finite"]) and grad_err <= AMP_GRAD_TOL,
          "the fp16 step's clipped gradient strays from float32's on the same params")
    check(witness_err <= AMP_WITNESS_TOL, "the float32 step disagrees with the port's DDP step")
    check(skipped and after == before / 2, "the overflowing step was not skipped everywhere")


def localsgd_run(device, timed=False, dtype=torch.float32, averager=None):
    """PostLocalSGDOptimizer over the DDP-MNIST ConvNet at world 8 (sgd
    0.01, momentum 0.5, period 4, warmup 2) on the fixed batch, with the
    averager class `averager` (the stock one by default): (each step's
    losses (8,) and replicas on the host in float64, replicas-equal flags
    after each step, samples/s a card of the timed steps or None)."""
    from torch.func import functional_call

    tdx.init_process_group(world_size=MNIST_WORLD, device=None if device == "cuda" else device)
    try:
        model = mnist_model(device).to(dtype)
        apply = lambda p, x: functional_call(model, p, (x,))  # noqa: E731
        opt = optim.PostLocalSGDOptimizer(
            optim.sgd(0.01, momentum=0.5), apply, mnist.loss_fn,
            averager=averager and averager(**LOCALSGD), **LOCALSGD)
        p, o = opt.init({n: t.detach() for n, t in model.named_parameters()})
        x, y = mnist_batch(MNIST_WORLD, device)
        x = x.to(dtype)
        hist, equal = [], []
        for _ in range(LOCALSGD_STEPS):
            p, o, loss = opt.step(p, o, x, y)
            hist.append((loss.double().cpu(), {n: t.double().cpu() for n, t in p.items()}))
            equal.append(all(bool((bits(t) == bits(t[:1])).all()) for t in p.values()))
        rate = None
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LOCALSGD_STEPS):
                p, o, loss = opt.step(p, o, x, y)
            torch.cuda.synchronize()
            rate = LOCALSGD_STEPS * MNIST_BATCH * MNIST_WORLD / (time.perf_counter() - t0)
        return hist, equal, rate
    finally:
        tdx.destroy_process_group()


def ddp_rate():
    """samples/s a card of the DDP step (ZeRO auto) on the same batch and
    step count as `localsgd_run`'s timed steps, in the same process."""
    tdx.init_process_group(world_size=MNIST_WORLD)
    try:
        ddp = tdx.DistributedDataParallel(mnist_model("cuda"))
        opt = optim.sgd(0.01, momentum=0.5)
        step = ddp.make_train_step(opt, mnist.loss_fn)
        x, y = mnist_batch(MNIST_WORLD, "cuda")
        p, s = ddp.params, opt.init(ddp.params)
        for _ in range(2):
            p, s, _ = step(p, s, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LOCALSGD_STEPS):
            p, s, _ = step(p, s, x, y)
        torch.cuda.synchronize()
        return LOCALSGD_STEPS * MNIST_BATCH * MNIST_WORLD / (time.perf_counter() - t0)
    finally:
        tdx.destroy_process_group()


class LeftOutAverager(PeriodicModelAverager):
    """A planted fault for the post-local SGD check: each averaging leaves
    the last replica out of the mean (every replica still gets the same
    values)."""

    def average_parameters(self, stacked):
        self.step += 1
        if self.step <= self.warmup_steps or self.step % self.period != 0:
            return stacked, False
        return {n: t[:-1].mean(0, keepdim=True).expand_as(t).clone()
                for n, t in stacked.items()}, True


def localsgd_errs(a, b):
    """Each step's (losses' largest relative error, params' largest error
    as a share of the leaf's largest entry) of run `a` against run `b`."""
    out = []
    for (la, pa), (lb, pb) in zip(a, b):
        out.append((float(((la - lb).abs() / lb.abs()).max()),
                    max(float((pa[n] - pb[n]).abs().max() / pb[n].abs().max()) for n in pb)))
    return out


def localsgd_check(card):
    card_hist, equal, rate = localsgd_run("cuda", timed=True)
    with cpu_reference():
        cpu_hist, cequal, _ = localsgd_run("cpu")
    f64_hist, _, _ = localsgd_run("cpu", dtype=torch.float64)
    card64, equal64, _ = localsgd_run("cuda", dtype=torch.float64)
    # the planted fault, in float64 and in float32 on the card
    bad64, _, _ = localsgd_run("cuda", dtype=torch.float64, averager=LeftOutAverager)
    bad32, _, _ = localsgd_run("cuda", averager=LeftOutAverager)
    averaged = [(i + 1) > LOCALSGD["warmup_steps"] and (i + 1) % LOCALSGD["period"] == 0
                for i in range(LOCALSGD_STEPS)]
    gc, cd = localsgd_errs(card_hist, cpu_hist), localsgd_errs(cpu_hist, f64_hist)
    g64, b64 = localsgd_errs(card64, f64_hist), localsgd_errs(bad64, f64_hist)
    b32 = localsgd_errs(bad32, cpu_hist)

    def in_envelope(errs):
        return [l <= LOCALSGD_ENVELOPE * lcd + LOCALSGD_FLOOR
                and p <= LOCALSGD_ENVELOPE * pcd + LOCALSGD_FLOOR
                for (l, p), (lcd, pcd) in zip(errs, cd)]

    within, bad_within = in_envelope(gc), in_envelope(b32)
    early = max(max(e) for e in gc[:LOCALSGD["warmup_steps"]])
    worst64 = max(max(e) for e in g64)
    bad64_worst = max(max(e) for e in b64)
    print(f"  post-local SGD, ConvNet at world {MNIST_WORLD} x {MNIST_BATCH}, period "
          f"{LOCALSGD['period']}, warmup {LOCALSGD['warmup_steps']}, {LOCALSGD_STEPS} steps: "
          f"replicas bitwise equal after steps {[i + 1 for i, e in enumerate(equal) if e]} "
          f"(averagings at {[i + 1 for i, a in enumerate(averaged) if a]})")
    print("  step: loss rel err, params |err| / max: float32 card vs CPU | CPU float32 vs "
          "float64 | float64 card vs CPU | planted fault (the last replica left out of each "
          "average): float64 card vs CPU, float32 card vs CPU")
    for i in range(LOCALSGD_STEPS):
        row = " | ".join(f"{e[i][0]:.2e} {e[i][1]:.2e}" for e in (gc, cd, g64, b64, b32))
        print(f"    {i + 1:2d}: {row}")
    print(f"  float32 card vs CPU over the steps before the first local drift (1-"
          f"{LOCALSGD['warmup_steps']}): {early:.3e} (limit {LOCALSGD_EARLY_TOL:g}); within "
          f"{LOCALSGD_ENVELOPE:g}x the CPU's distance from float64 (+{LOCALSGD_FLOOR:g}) at every "
          f"step: {all(within)}")
    print(f"  float64 card vs CPU at every step: worst {worst64:.3e} (limit {LOCALSGD_F64_TOL:g}); "
          f"the planted fault reads {bad64_worst:.3e} in float64, and its float32 run stays "
          f"inside the float32 envelope at {sum(bad_within)} of {LOCALSGD_STEPS} steps")
    ddp = ddp_rate()
    print(f"  {rate:.1f} samples/s a card local SGD against {ddp:.1f} for the DDP step (ZeRO "
          f"auto), the same batch and {LOCALSGD_STEPS} steps  [{card}]")
    check(equal == averaged and cequal == averaged and equal64 == averaged,
          "the replicas should agree right after each averaging and differ between")
    check(early <= LOCALSGD_EARLY_TOL, "post-local SGD's first steps on the card stray from the CPU")
    check(all(within), "post-local SGD on the card strays from the CPU beyond float32's own envelope")
    check(worst64 <= LOCALSGD_F64_TOL, "post-local SGD in float64 on the card strays from the CPU")
    check(bad64_worst > LOCALSGD_F64_TOL, "the float64 check does not see a replica left out")


def join_run(device):
    """DDP-MNIST at world 8 (sgd 0.01, momentum 0.5, ZeRO auto) on
    `join_batches` of rank r's JOIN_MAX - r batches, the weighted loss
    across the ranks: (losses, params, shadow rows a step)."""
    from pytorch_distributed_example_tpu_torch.parallel.join import join_batches, weighted_loss_fn

    gen = np.random.default_rng(5)
    streams = [[(gen.standard_normal((JOIN_BATCH, 28, 28, 1)).astype(np.float32),
                 gen.integers(0, 10, JOIN_BATCH).astype(np.int32))
                for _ in range(JOIN_MAX - r)] for r in range(MNIST_WORLD)]
    tdx.init_process_group(world_size=MNIST_WORLD, device=None if device == "cuda" else device)
    try:
        ddp = tdx.DistributedDataParallel(mnist_model(device))
        opt = optim.sgd(0.01, momentum=0.5)
        wl = weighted_loss_fn(lambda lg, y: torch.nn.functional.cross_entropy(
            lg, y, reduction="none"), world=MNIST_WORLD)
        step = ddp.make_train_step(opt, lambda lg, yw: wl(lg, yw[0], yw[1]))
        p, s = ddp.params, opt.init(ddp.params)
        losses, shadow = [], []
        for x, y, w in join_batches(streams):
            xt, yt = mnist.to_device(x, y, device)
            p, s, loss = step(p, s, xt, (yt, torch.from_numpy(w).to(device)))
            losses.append(float(loss))
            shadow.append(int((w == 0).sum()))
        return losses, {n: t.cpu() for n, t in p.items()}, shadow
    finally:
        tdx.destroy_process_group()


def join_check(card):
    gl, gp, shadow = join_run("cuda")
    with cpu_reference():
        cl, cp, _ = join_run("cpu")
    ok = np.allclose(gl, cl, **JOIN_TOL) and all(
        np.allclose(gp[n].numpy(), cp[n].numpy(), **JOIN_TOL) for n in cp)
    worst = max(float((gp[n] - cp[n]).abs().max()) for n in cp)
    print(f"  Join: rank r with {JOIN_MAX} - r batches of {JOIN_BATCH}, {len(gl)} steps, shadow "
          f"rows a step {shadow}: card vs CPU within rtol 2e-4 / atol 2e-5: {ok} (params max "
          f"|err| {worst:.3e}; losses {[round(v, 5) for v in gl]})")
    check(ok and shadow[-1] == (MNIST_WORLD - 1) * JOIN_BATCH,
          "the Join step on the card disagrees with the CPU")


def reducer_hook_check(card):
    """The eager Reducer over BERT-base's rank-stacked float32 gradients at
    world 8: the stock pass and `BlockwiseQuantHook(bits=8).for_reducer`
    at the default bucket cap (ms a pass by CUDA events); a comm.quantize
    fault at bucket 1 and a whole-pass retry bitwise the fault-free pass."""
    from pytorch_distributed_example_tpu_torch import faults
    from pytorch_distributed_example_tpu_torch.parallel import Reducer

    pg = tdx.init_process_group(world_size=DDP8)
    try:
        model = BertForSequenceClassification(
            BertConfig(max_seq_len=BERT_SEQ, **bench.BERT_PRESETS["base"]), device="meta")
        gen = torch.Generator("cuda").manual_seed(0)
        grads = {n: torch.randn((DDP8,) + tuple(p.shape), device="cuda", generator=gen)
                 for n, p in model.named_parameters()}
        nbytes = sum(g.numel() * 4 for g in grads.values())
        stock = Reducer(pg)
        stock.reduce(grads)
        stock_ms = timed_events(lambda: stock.reduce(grads), 3)
        make = lambda: comm_hooks.BlockwiseQuantHook(bits=8).for_reducer(pg)  # noqa: E731
        quant_red = Reducer(pg, comm_hook=make())
        quant_red.reduce(grads)
        quant_ms = timed_events(lambda: quant_red.reduce(grads), 3)
        clean = Reducer(pg, comm_hook=make())
        want = clean.reduce(grads)
        hook = make()
        faulted = Reducer(pg, comm_hook=hook)
        faults.install_plan([{"point": "comm.quantize", "action": "reset", "after": 2}],
                            export_env=False)
        try:
            faulted.reduce(grads)
            raised = False
        except ConnectionResetError:
            raised = True
        finally:
            faults.clear_plan()
        got = faulted.reduce(grads)
        same = raised and all(same_bits(got[n], want[n]) for n in grads) and all(
            same_bits(hook._errors[b], clean.comm_hook._errors[b]) for b in hook._errors)
        print(f"  Reducer over BERT-base's gradients at world {DDP8} ({nbytes} bytes f32): "
              f"{quant_red.stats['num_buckets']} buckets at the default cap; the int8 hook "
              f"{quant_ms:.2f} ms a pass against the stock pass {stock_ms:.2f} ms and PR 10's "
              f"per-leaf int8 hook in the DDP step {PR10_HOOK_MS} ms  [{card}]")
        print(f"  a comm.quantize fault at bucket 1, then a whole-pass retry: bitwise the "
              f"fault-free pass (values and error feedback): {same}")
        check(same, "the quantized Reducer's retry is not bitwise the fault-free pass")
    finally:
        tdx.destroy_process_group()
    torch.cuda.empty_cache()


def train_utils_phase(card):
    """AMP, post-local SGD, Join and the Reducer hook. Returns the phase's
    flash launches by route (none may launch)."""
    fa.reset_launch_counts()
    for fn in (amp_check, localsgd_check, join_check, reducer_hook_check):
        t0 = time.perf_counter()
        fn(card)
        print(f"  {fn.__name__} in {time.perf_counter() - t0:.1f} s")
    routes = dict(fa.ROUTE_LAUNCHES)
    check(sum(fa.LAUNCHES.values()) == 0, "a flash kernel launched on the train_utils path")
    torch.cuda.empty_cache()
    return routes


# multiproc mode: the training parallelisms as process gangs on cuda:0

MP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".multiproc_smoke")
MP_WORLD = 4
MP_BACKEND = "cuda:gloo"  # gloo carries the CUDA tensors: nccl refuses two ranks on one GPU
# (a)'s three checked steps warm the timed one up (the whole ran past
# 1000 s with [planner] at 1 warm-up and 2 timed steps)
MP_WARMUP_STEPS, MP_TIMED_STEPS = 0, 1
MP_NCCL_ARGV = SLICE_ARGV + ["--n-layers", "4"]  # (f): (a)'s width at 4 layers, a rank
MP_CIFAR_WORLD = 2
MP_CIFAR_TOL = dict(rtol=1e-4, atol=1e-6)
MP_EP_TOL = dict(rtol=1e-4, atol_frac=1e-5)  # F32_TOL: float32 in another order
# a gang's whole run, start-up and kernel load included (a hung gang fails)
MP_TIMEOUT_S = {"fsdp_tp": 600, "ring": 300, "pipeline": 300, "ep": 240, "cifar": 300,
                "nccl": 240, "serve_tp": 400, "plane": 240, "plan_exec": 300}


def mp_path(name):
    return os.path.join(MP_DIR, name)


def mp_gang(part, world=MP_WORLD, backend=MP_BACKEND):
    """Run `mp_worker(part, ...)` as ranks 0..world-1 of one gang, each a
    `python3 chip_smoke.py --worker ...` process on cuda:0. Prints rank 0's
    report (every rank's output when one fails) and returns each rank's
    JSON result. `part` may be a tuple of parts, which the same processes
    run one after another, each over a process group of its own (one
    start-up for all); the results then come as {part: [rank's result]}.
    A rank that fails or a gang past its timeout (the parts' summed) fails
    the phase; every process is ended either way."""
    parts = part if isinstance(part, tuple) else (part,)
    name = "+".join(parts)
    with contextlib.ExitStack() as stack:  # held together, so the ports differ
        socks = [stack.enter_context(socket.socket()) for _ in parts]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        ports = ",".join(str(sk.getsockname()[1]) for sk in socks)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for r in range(world):
        for p in parts:
            with contextlib.suppress(FileNotFoundError):
                os.remove(mp_path(f"{p}_{r}.json"))
    timeout = sum(MP_TIMEOUT_S[p] for p in parts)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               ",".join(parts), str(r), str(world), ports, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=root) for r in range(world)]
    outs, timed_out = [], False
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                outs.append(p.communicate(timeout=left)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    failed = timed_out or any(p.returncode for p in procs)
    for r, text in enumerate(outs):
        if r == 0 or failed:
            for line in text.splitlines():
                print(f"    [rank {r}] {line}" if failed else f"  {line}")
    check(not timed_out, f"[multiproc] {name}: the gang hung past {timeout} s")
    check(not failed, f"[multiproc] {name}: a rank failed (exit codes "
          f"{[p.returncode for p in procs]})")
    results = {}
    for p in parts:
        results[p] = []
        for r in range(world):
            with open(mp_path(f"{p}_{r}.json")) as f:
                results[p].append(json.load(f))
    print(f"  {name}: gang of {world} over {backend} in {time.perf_counter() - t0:.1f} s")
    return results if isinstance(part, tuple) else results[part]


def mp_init(rank, world, port, backend):
    tdx.init_process_group(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world, timeout=MP_TIMEOUT_S["fsdp_tp"])


def mp_reset_stats():
    bp.reset_stats()
    p2p.reset_stats()


def mp_stats():
    """The c10d transport's counters since the last reset (this process),
    with the p2p plane's staging of the CUDA rows it sent."""
    return {"bytes": dict(bp.STATS["bytes"]), "seconds": dict(bp.STATS["seconds"]),
            "staging_s": p2p.STAGING["seconds"], "staged_bytes": p2p.STAGING["bytes"]}


def mp_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# -- (a) CFG_1B over fsdp 2 x tp 2 --------------------------------------------


def mp_fsdp_tp_worker(rank, world):
    """The trainer's FSDP step as rank `rank`: its shards, its data rank's
    2 rows, the mesh's axis groups. The first step's gathered gradients
    against the single card's (rank 0), three checked steps, warm-up and
    timed steps, and one step with its launches counted (rank 0 under the
    profiler)."""
    args = lm.parse_args(FSDP_TP_ARGV)
    mod, opt, next_tokens = lm.build(args, world=world)
    check(mod.mesh.multiproc and mod.mesh.get_coordinate() is not None,
          "the gang's trainer should run over a multiproc mesh")
    q = mod.params["layers.0.attn.q_proj.weight"]._local
    losses = [float(lm.train_step(mod, opt, next_tokens()))]
    want = torch.load(mp_path("ref_grads.pt"), mmap=True) if rank == 0 else None
    worst, worst_name = 0.0, None
    for name, dt in mod.params.items():  # a collective: every rank, the same order
        got = DTensor(dt._local.grad, dt.device_mesh, dt.placements).full_tensor()
        if rank == 0:
            r = rel_rms(got, want[name].to(got.device))
            if r > worst:
                worst, worst_name = r, name
        del got
    del want
    for _ in range(FSDP_TP_STEPS - 1):
        losses.append(float(lm.train_step(mod, opt, next_tokens())))
    for _ in range(MP_WARMUP_STEPS):
        lm.train_step(mod, opt, next_tokens())
    torch.cuda.reset_peak_memory_stats()
    mp_reset_stats()
    step_s = []
    for _ in range(MP_TIMED_STEPS):
        batch = next_tokens()
        loss, secs = mp_timed(lambda: lm.train_step(mod, opt, batch))
        step_s.append(secs)
    stats = mp_stats()
    peak = torch.cuda.max_memory_allocated()
    fa.reset_launch_counts()
    batch = next_tokens()
    if rank == 0:
        print("[profile] rank 0's step under torch.profiler (the other ranks unprofiled)")
        profile_step(lambda: lm.train_step(mod, opt, batch), sum(step_s) / len(step_s) * 1e3)
    else:
        lm.train_step(mod, opt, batch)
    return {"losses": losses, "worst": worst, "worst_name": worst_name,
            "step_s": step_s, "stats": stats, "peak": peak, "local_q": list(q.shape),
            "launches": dict(fa.LAUNCHES), "routes": dict(fa.ROUTE_LAUNCHES),
            "loss_finite": math.isfinite(float(loss))}


def mp_driver_losses():
    """The driver-mode [fsdp_tp] losses of the first FSDP_TP_STEPS steps, or
    (when that phase did not run in this process) the same run here."""
    if tuple(FSDP_TP_ARGV) in SHARDED_LOSSES:
        return SHARDED_LOSSES[tuple(FSDP_TP_ARGV)]
    mod, opt, next_tokens, _, _, first = sharded_first_step(FSDP_TP_ARGV, grads=False)
    losses = [first] + [float(lm.train_step(mod, opt, next_tokens()))
                        for _ in range(FSDP_TP_STEPS - 1)]
    del mod, opt
    torch.cuda.empty_cache()
    return losses


def mp_fsdp_tp(card):
    """(a): the single card's first step on the same weights and tokens,
    its gradients saved for rank 0; the gang; its checks."""
    driver = mp_driver_losses()
    model, _, next_tokens = lm.build(lm.parse_args([*FSDP_TP_ARGV, "--tp", "1"]), world=1)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    tokens = next_tokens()
    loss1 = lm.loss_fn(model(tokens), tokens)
    loss1.backward()
    torch.save({n: p.grad.cpu() for n, p in model.named_parameters()}, mp_path("ref_grads.pt"))
    loss1 = float(loss1.detach())
    del model
    torch.cuda.empty_cache()
    print(f"  (a) CFG_1B dense (vocab {cfg.vocab_size}, d {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, seq {lm.parse_args(FSDP_TP_ARGV).seq}, global batch "
          f"{lm.parse_args(FSDP_TP_ARGV).batch_size}, {cfg.dtype}; {n_params / 1e6:.1f}M params) "
          f"over fsdp 2 x tp 2 as {MP_WORLD} processes on cuda:0 over {MP_BACKEND}")
    res = yield "fsdp_tp"
    os.remove(mp_path("ref_grads.pt"))
    r0 = res[0]
    losses = r0["losses"]
    print(f"  first step against the single card on the same weights and tokens: loss "
          f"{losses[0]:.5f} vs {loss1:.5f}; largest rms(grad diff)/rms(grad) {r0['worst']:.3e} "
          f"({r0['worst_name']})")
    check(abs(losses[0] - loss1) <= SHARDED_LOSS_TOL and r0["worst"] <= SHARDED_GRAD_RMS,
          f"the gang's step disagrees with the single card (|dloss| <= {SHARDED_LOSS_TOL}, "
          f"rms ratio <= {SHARDED_GRAD_RMS})")
    gap = max(abs(a - b) for a, b in zip(losses, driver))
    print(f"  losses of the first {FSDP_TP_STEPS} steps {losses} against driver mode's "
          f"{driver}: largest |diff| {gap:.3e}")
    check(all(r["losses"] == losses for r in res), "the ranks report different losses")
    check(gap <= SHARDED_LOSS_TOL, "the gang's losses stray from driver mode's beyond 1e-2")
    step = max(max(r["step_s"]) for r in res)
    mean = sum(sum(r["step_s"]) for r in res) / sum(len(r["step_s"]) for r in res)
    args = lm.parse_args(FSDP_TP_ARGV)
    print(f"  step times (s) by rank {[r['step_s'] for r in res]}; mean step {mean * 1e3:.1f} "
          f"ms (slowest {step * 1e3:.1f}), {args.batch_size * args.seq / mean:.0f} tokens/s; "
          f"peak memory by rank {[round(r['peak'] / 2 ** 30, 2) for r in res]} GiB  [{card}]")
    st = r0["stats"]
    per_step = {k: v // MP_TIMED_STEPS for k, v in st["bytes"].items()}
    coll_s = sum(st["seconds"].values()) / MP_TIMED_STEPS
    print(f"  rank 0 a step: collective bytes handed to gloo {per_step} "
          f"({sum(per_step.values()) / 2 ** 30:.2f} GiB), host seconds inside the collectives "
          f"{coll_s:.3f} ({coll_s / mean:.1%} of the step; gloo's own device<->host copies "
          f"included), staged through pinned memory by the p2p plane's sends "
          f"{st['staged_bytes']} bytes in {st['staging_s']:.4f} s")
    for r, rr in enumerate(res):
        check(rr["local_q"][:2] == [1, 1], f"rank {r} should hold one shard: {rr['local_q']}")
        check(rr["loss_finite"], "non-finite loss in a timed step")
        check(rr["launches"] == {n: cfg.n_layers for n in REPLACES}
              and rr["routes"] == want_routes(cfg.n_layers),
              f"rank {r}: F, KV and Q should launch once a layer on the wgmma route: "
              f"{rr['launches']} {rr['routes']}")
    print(f"  launches in the counted step, each rank: {r0['launches']} ({r0['routes']})")
    return sum_routes(res)


def sum_routes(results):
    out = {name: 0 for name in fa.ROUTE_LAUNCHES}
    for r in results:
        for k, v in r["routes"].items():
            out[k] += v
    return out


# -- (b) the ring and Ulysses at world 4 ---------------------------------------


def mp_ring_inputs():
    W, Ls, B, H, D = MP_WORLD, RING_SHARD, 1, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(W * Ls)
    return [torch.randn((B, W * Ls, H, D), device="cuda", generator=gen, dtype=torch.bfloat16)
            for _ in range(4)]


def mp_shards(x, W):
    B, L, H, D = x.shape
    return x.reshape(B, W, L // W, H, D).transpose(0, 1).contiguous()


def mp_ulysses_attn(q, k, v, causal=True, scale=None):
    from pytorch_distributed_example_tpu_torch.ops import flash_attention

    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                           scale=scale)


def mp_cp_call(fn, shards, do):
    xs = [x.clone().requires_grad_() for x in shards]
    o = fn(*xs)
    o.backward(do)
    return [o.detach()] + [x.grad for x in xs]


def mp_ring_worker(rank, world):
    mesh = tdx.init_device_mesh(("sp",), (world,))
    mine = [mp_shards(x, world)[rank:rank + 1] for x in mp_ring_inputs()]
    ring = lambda q, k, v: cp.ring_attention(q, k, v, causal=True, block_kernel="flash",  # noqa
                                             axis_name="sp")
    uly = lambda q, k, v: cp.ulysses_attention(q, k, v, attn_fn=mp_ulysses_attn,  # noqa
                                               causal=True, axis_name="sp")
    out = {}
    with mesh:
        mp_cp_call(ring, mine[:3], mine[3])  # warm-up
        fa.reset_launch_counts()
        mp_reset_stats()
        got, secs = mp_timed(lambda: mp_cp_call(ring, mine[:3], mine[3]))
        out["ring_launches"], out["routes"] = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
        out["ring_s"], out["ring_stats"] = secs, mp_stats()
        want = torch.load(mp_path(f"ring_{rank}.pt"))
        out["ring"] = [compare(g, w.to(g.device), **(BF16_TOL if i == 0 else RING_GRAD_TOL))
                       for i, (g, w) in enumerate(zip(got, want))]
        got, secs = mp_timed(lambda: mp_cp_call(uly, mine[:3], mine[3]))
        out["uly_s"] = secs
        want = torch.load(mp_path(f"ulysses_{rank}.pt"))
        out["ulysses"] = [compare(g, w.to(g.device), **(BF16_TOL if i == 0 else RING_GRAD_TOL))
                          for i, (g, w) in enumerate(zip(got, want))]
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def mp_ring(card):
    """(b): the driver-mode ring and Ulysses on the same card and inputs,
    each shard's output and gradients saved; the gang; its checks."""
    W = MP_WORLD
    q, k, v, do = mp_ring_inputs()
    stacked = [mp_shards(x, W) for x in (q, k, v, do)]
    del q, k, v, do
    drivers = {"ring": lambda a, b, c: cp.ring_attention(a, b, c, causal=True,
                                                          block_kernel="flash"),
               "ulysses": lambda a, b, c: cp.ulysses_attention(a, b, c, attn_fn=mp_ulysses_attn,
                                                               causal=True)}
    for name, fn in drivers.items():
        got = mp_cp_call(fn, stacked[:3], stacked[3])
        for r in range(W):
            torch.save([t[r:r + 1].cpu() for t in got], mp_path(f"{name}_{r}.pt"))
        del got
    del stacked
    torch.cuda.empty_cache()
    print(f"  (b) the ring (flash block) and Ulysses, {W} shards of {RING_SHARD} (B 1, H 16, "
          f"D 128, bf16, causal) as {W} processes, against driver mode on the card")
    res = yield "ring"
    for r, rr in enumerate(res):
        names = ("o", "dq", "dk", "dv")
        text = ", ".join(f"{n} {e:.2e} ({ok})" for n, (e, _, ok) in zip(names, rr["ring"]))
        utext = ", ".join(f"{n} {e:.2e} ({ok})" for n, (e, _, ok) in zip(names, rr["ulysses"]))
        st = rr["ring_stats"]
        print(f"  rank {r}: ring max |diff| {text}; launches {rr['ring_launches']}; "
              f"{rr['ring_s'] * 1e3:.1f} ms a call (forward and backward), "
              f"{sum(st['bytes'].values()) / 2 ** 20:.0f} MiB sent in "
              f"{sum(st['seconds'].values()):.3f} s, {st['staged_bytes'] / 2 ** 20:.0f} MiB "
              f"staged in {st['staging_s']:.3f} s; Ulysses max |diff| {utext}, "
              f"{rr['uly_s'] * 1e3:.1f} ms; peak {rr['peak'] / 2 ** 30:.2f} GiB  [{card}]")
        check(all(ok for _, _, ok in rr["ring"]) and all(ok for _, _, ok in rr["ulysses"]),
              f"rank {r}: the gang's ring or Ulysses disagrees with driver mode")
        check(rr["ring_launches"] == {n: r + 1 for n in REPLACES},
              f"rank {r} should launch each of F, KV and Q {r + 1} times a ring call (the "
              f"causal skip): {rr['ring_launches']}")
        check(st["staged_bytes"] > 0, "the ring's sends should be staged through host memory")
    for r in range(W):
        for name in drivers:
            os.remove(mp_path(f"{name}_{r}.pt"))
    return sum_routes(res)


# -- (c) the 1F1B pipeline of CFG_1B's blocks at pp 4 ---------------------------


def mp_pipeline_setup(M):
    """The config, stage function, head loss, stacked block params, hidden
    states and tokens of [dryrun]'s pipeline check. The model is not kept:
    the head loss holds only the final norm's and the LM head's weights."""
    args = lm.parse_args(PIPE_ARGV)
    cfg = lm.config_for(args)
    L, S = args.seq, PIPE_STAGES
    per = cfg.n_layers // S
    model = TransformerLM(cfg, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    gen = np.random.default_rng(0)
    data = np.cumsum(gen.integers(1, 7, 200_000)) % cfg.vocab_size
    starts = gen.integers(0, len(data) - L, PIPE_MICRO_BIG)
    tokens = torch.from_numpy(np.stack([data[s_:s_ + L] for s_ in starts])).to(
        "cuda", torch.int64).view(PIPE_MICRO_BIG, 1, L)[:M]
    with torch.no_grad():
        hidden = model.tok_embed(tokens).to(cfg.dtype)
    norm_w, head_w = model.final_norm.weight.detach(), model.lm_head.weight.detach()
    blocks = stacked_blocks(model, per)
    del model
    norm = RMSNorm(cfg.d_model, cfg.norm_eps, device="meta")

    def head_loss(y, t):
        h = torch.func.functional_call(norm, {"weight": norm_w}, (y,))
        return lm.loss_fn(torch.nn.functional.linear(h, head_w.to(cfg.dtype)).float(), t)

    return cfg, block_stage_fn(cfg, per, L), head_loss, blocks, hidden, tokens


def mp_pipeline_worker(rank, world):
    cfg, stage, head_loss, params, hidden, tokens = mp_pipeline_setup(PIPE_MICRO)
    mine = {k: v[rank:rank + 1].clone() for k, v in params.items()}  # not a view of all
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mesh = tdx.init_device_mesh(("pp",), (world,))
    f1b = pp.make_pipeline_train_fn(stage, head_loss, mesh, schedule="1f1b")
    f1b(mine, hidden, tokens)  # warm-up
    # the peak of the timed step over what the process holds: its stage's
    # blocks, the microbatches' hidden states and tokens, the head's weights
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    mp_reset_stats()
    (loss, grads), secs = mp_timed(lambda: f1b(mine, hidden, tokens))
    want_loss, want = torch.load(mp_path(f"pp_{rank}.pt"))
    worst = max((rel_rms(g, want[k].to(g.device)), k) for k, g in grads.items())
    return {"loss": float(loss), "want_loss": want_loss, "worst": worst, "step_s": secs,
            "peak": torch.cuda.max_memory_allocated(), "held": held, "stats": mp_stats(),
            "launches": dict(fa.LAUNCHES), "routes": dict(fa.ROUTE_LAUNCHES)}


def mp_pipeline(card):
    """(c): the driver-mode 1F1B on the same card, each stage's gradients
    saved; the gang, a stage a process; its checks."""
    M, S = PIPE_MICRO, PIPE_STAGES
    cfg, stage, head_loss, params, hidden, tokens = mp_pipeline_setup(M)
    mesh = tdx.DeviceMesh(["cuda"] * S, (S,), ("pp",))
    loss, grads = pp.make_pipeline_train_fn(stage, head_loss, mesh, schedule="1f1b")(
        params, hidden, tokens)
    for s in range(S):
        torch.save((float(loss), {k: g[s].cpu() for k, g in grads.items()}),
                   mp_path(f"pp_{s}.pt"))
    del params, grads, hidden, stage, head_loss
    torch.cuda.empty_cache()
    print(f"  (c) 1F1B of CFG_1B's {cfg.n_layers} blocks at pp {S}, M {M} microbatches of 1 x "
          f"{tokens.shape[-1]} tokens, bf16, as {S} processes (a stage each), against driver "
          f"mode's 1F1B on the card")
    res = yield "pipeline"
    per = cfg.n_layers // S
    want = {"flash_fwd": 2 * per * M, "flash_dkdv": per * M, "flash_dq": per * M}
    want_r = {**{k: 0 for k in fa.ROUTE_LAUNCHES}, **{f"{k}:wgmma": n for k, n in want.items()}}
    for r, rr in enumerate(res):
        st = rr["stats"]
        print(f"  stage {r}: loss {rr['loss']:.5f} vs {rr['want_loss']:.5f}; largest rms(grad "
              f"diff)/rms(grad) {rr['worst'][0]:.3e} ({rr['worst'][1]}); step "
              f"{rr['step_s'] * 1e3:.1f} ms; peak memory {rr['peak'] / 2 ** 30:.2f} GiB "
              f"({rr['held'] / 2 ** 30:.2f} GiB held before the step); "
              f"launches {rr['launches']}; {sum(st['bytes'].values()) / 2 ** 20:.0f} MiB "
              f"sent, staged in {st['staging_s']:.3f} s  [{card}]")
        check(abs(rr["loss"] - rr["want_loss"]) <= SHARDED_LOSS_TOL
              and rr["worst"][0] <= SHARDED_GRAD_RMS,
              f"stage {r}: the gang's 1F1B disagrees with driver mode's (|dloss| <= "
              f"{SHARDED_LOSS_TOL}, rms ratio <= {SHARDED_GRAD_RMS})")
        check(rr["launches"] == want and rr["routes"] == want_r,
              f"stage {r}: each of its {per} blocks should launch F twice (forward and "
              f"recompute), KV and Q once a microbatch, on the wgmma route: {rr['launches']} "
              f"{rr['routes']}")
    for s in range(S):
        os.remove(mp_path(f"pp_{s}.pt"))
    return sum_routes(res)


# -- (d) make_ep_moe at 4 ep ranks ---------------------------------------------


def mp_ep_inputs(T_=4096, D=2048, F_=5504, E=EP_EXPERTS):
    """ep_moe_check's shapes in float32 (routing is discrete)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(T_, D, device="cuda", generator=gen)
    up = torch.randn(E, D, F_, device="cuda", generator=gen) / math.sqrt(D)
    down = torch.randn(E, F_, D, device="cuda", generator=gen) / math.sqrt(F_)
    router = torch.randn(D, E, device="cuda", generator=gen) / math.sqrt(D)
    ct = torch.randn(T_, D, device="cuda", generator=gen)
    return x, up, down, router, ct


def mp_ep_run(mesh):
    """(y, aux, the router's gradient of sum(y * ct) + aux) of make_ep_moe."""
    x, up, down, router, ct = mp_ep_inputs()
    router.requires_grad_()
    y, aux = ep.make_ep_moe(mesh, "ep")(x, up, down, router)
    ((y * ct).sum() + aux).backward()
    return y.detach(), float(aux.detach()), router.grad


def mp_ep_worker(rank, world):
    mesh = tdx.init_device_mesh(("ep",), (world,))
    (y, aux, grad), secs = mp_timed(lambda: mp_ep_run(mesh))
    g = DistTensor.from_process_local(grad, mesh.get_group("ep"))
    tdx.all_reduce(g, group=mesh.get_group("ep"))  # each process's tokens' share
    want_y, want_aux, want_g = torch.load(mp_path("ep.pt"))
    return {"y": compare(y, want_y.to(y.device), **MP_EP_TOL), "aux": abs(aux - want_aux),
            "grad": compare(g.tensor[0], want_g.to(y.device), **MP_EP_TOL), "s": secs}


def mp_ep(card):
    mesh = tdx.DeviceMesh(["cuda"] * EP_WORLD, (EP_WORLD,), ("ep",))
    y, aux, grad = mp_ep_run(mesh)
    torch.save((y.cpu(), aux, grad.cpu()), mp_path("ep.pt"))
    del y, grad
    torch.cuda.empty_cache()
    print(f"  (d) make_ep_moe at {EP_WORLD} ep ranks, {EP_EXPERTS} experts, ep_moe_check's "
          f"shapes in float32 (TF32 off), as {EP_WORLD} processes against driver mode")
    res = yield "ep"
    for r, rr in enumerate(res):
        print(f"  rank {r}: y max |diff| {rr['y'][0]:.3e}, |daux| {rr['aux']:.3e}, the "
              f"router's summed gradient max |diff| {rr['grad'][0]:.3e}; {rr['s'] * 1e3:.1f} ms")
        check(rr["y"][2] and rr["grad"][2] and rr["aux"] <= 1e-6,
              f"rank {r}: the gang's make_ep_moe disagrees with driver mode (rtol 1e-4, atol "
              f"1e-5 of the largest entry; |daux| <= 1e-6)")
    os.remove(mp_path("ep.pt"))


# -- (e) ResNet-18 SyncBN through examples/cifar.main --------------------------


def mp_cifar_argv(world):
    return ["--world-size", str(world), "--epochs", "1", "--batch-size", str(CIFAR_BATCH),
            "--train-size", str(world * CIFAR_BATCH), "--test-size", "64"]


def mp_cifar_worker(rank, world, port, backend):
    torch.backends.cudnn.deterministic = True
    try:
        out = cifar.main(mp_cifar_argv(world) + ["--backend", backend, "--init-method",
                                                f"tcp://127.0.0.1:{port}", "--rank", str(rank)])
    finally:
        torch.backends.cudnn.deterministic = False
    if rank == 0:
        torch.save(({k: v.cpu() for k, v in out["params"].items()},
                    {k: v.cpu() for k, v in out["stats"].items()}), mp_path("cifar.pt"))
    return {"losses": out["losses"]}


def mp_cifar(card):
    """(e): one step of the example at world 2, driver mode here, then the
    gang through `--init-method`; float32, cuDNN's deterministic
    algorithms."""
    W = MP_CIFAR_WORLD
    torch.backends.cudnn.deterministic = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            want = cifar.main(mp_cifar_argv(W))
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  (e) ResNet-18 SyncBN, world {W} x {CIFAR_BATCH} images, one step of "
          f"`examples/cifar.main(... --init-method ...)` as {W} processes against driver "
          f"mode at world {W} (float32, cudnn.deterministic)")
    res = yield "cifar"
    params, stats = torch.load(mp_path("cifar.pt"))
    os.remove(mp_path("cifar.pt"))
    loss, want_loss = res[0]["losses"][0], want["losses"][0]

    def worst(got, ref):
        return max(float(((got[k] - ref[k].cpu()).abs()
                          / (MP_CIFAR_TOL["atol"] + MP_CIFAR_TOL["rtol"] * ref[k].cpu().abs())
                          ).max()) for k in ref)

    wp, ws = worst(params, want["params"]), worst(stats, want["stats"])
    print(f"  first step: loss {loss:.6f} vs {want_loss:.6f}; the largest |diff| over its "
          f"tolerance (rtol 1e-4, atol 1e-6): params {wp:.3f}, batch stats {ws:.3f}")
    check(res[0]["losses"] == res[1]["losses"], "the cifar ranks report different losses")
    check(abs(loss - want_loss) <= MP_CIFAR_TOL["atol"] + MP_CIFAR_TOL["rtol"] * abs(want_loss)
          and wp <= 1 and ws <= 1,
          "the SyncBN gang's first step disagrees with driver mode (rtol 1e-4, atol 1e-6)")


# -- (f) a world-1 nccl gang of (a)'s step at 4 layers ---------------------------


def mp_nccl_worker(rank, world):
    import torch.distributed as tdist

    args = lm.parse_args(MP_NCCL_ARGV)
    model, _, next_tokens = lm.build(args, world=1)
    tokens = next_tokens()
    with torch.no_grad():
        single = float(lm.loss_fn(model(tokens), tokens))
    mod = lm.shard(model, args.lr, 1, 1)
    opt = mod.step.init_opt_state(mod.params)
    mp_reset_stats()
    losses = [float(lm.train_step(mod, opt, tokens))]
    losses += [float(lm.train_step(mod, opt, next_tokens())) for _ in range(2)]
    return {"single": single, "losses": losses, "backend": str(tdist.get_backend()),
            "multiproc": mod.mesh.multiproc, "ops": sorted(mp_stats()["bytes"])}


def mp_nccl(card):
    res = (yield "nccl")[0]
    print(f"  (f) a world-1 nccl gang of (a)'s step at 4 layers: torch backend "
          f"{res['backend']}, collectives {res['ops']}; first loss {res['losses'][0]:.5f} vs "
          f"{res['single']:.5f} on the single card; losses {res['losses']}")
    check(res["backend"] == "nccl" and res["multiproc"] and "all_reduce" in res["ops"],
          "the world-1 gang should run the multiproc step over nccl")
    check(abs(res["losses"][0] - res["single"]) <= SHARDED_LOSS_TOL
          and all(math.isfinite(x) for x in res["losses"]),
          "the world-1 nccl gang's step disagrees with the single card")


# -- (g) CFG_1B tensor-parallel serving at tp 2 as a gang ----------------------

MP_SERVE_REQUESTS = 8  # (16 until [elastic] needed the time)
MP_SERVE_GATE = (2, 128)  # prompts x tokens of the gang's prefill-logits gate
MP_SERVE_F32_RMS = 1e-5  # float32 (TF32 off): the same sums in another kernel's order
MP_SERVE_FORCED_RMS = {"bf16": SERVE_RMS_TOL, "float32": MP_SERVE_F32_RMS}
# [serve]'s model: CFG_1B's width at 4 of its 16 layers (16 until
# [elastic], 8 until the whole run neared its time limit)
MP_SERVE_ARGV = SERVE_ARGV
MP_SERVE_RUNS = (("bf16", MP_SERVE_ARGV, (False, True)),
                 ("float32", [a for a in MP_SERVE_ARGV if a != "--bf16"], (False,)))


def mp_serve_gate_tokens():
    B, L = MP_SERVE_GATE
    return np.random.default_rng(1).integers(0, 32000, (B, L)).astype(np.int32)


def mp_serve_model(argv):
    return TransformerLM(lm.config_for(lm.parse_args(argv)), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))


def mp_serve_tp_worker(rank, world):
    """One tp rank's engine over the gang's ("tp", 2) mesh: for CFG_1B in
    bf16 (float and int8 pools) and in float32 (float pool), the bimodal
    burst, the prefill logits of MP_SERVE_GATE, and each decode step's
    logits with driver mode's greedy tokens fed in (`forced_decode`),
    against driver mode's (saved by the phase); then one steady 8-slot
    bf16 decode step timed
    (CUDA events over 10 engine steps, the host's ms inside the
    collectives) and its kernel launches counted under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    mesh = tdx.init_device_mesh(("tp",), (world,))
    out = {}
    for name, argv, pools in MP_SERVE_RUNS:
        model = mp_serve_model(argv)
        for quant in pools:
            eng, wall = serve_run(model, bimodal_traffic(MP_SERVE_REQUESTS), slots=SERVE_SLOTS,
                                  block_size=SERVE_BLOCK, min_bucket=8, mesh=mesh,
                                  kv_quant=quant)
            out[f"{name}_{int(quant)}"] = {"tokens": completions(eng), "wall": wall}
            out["pool_local"] = list(eng.cache.tree["layers_0"]["attn"]["k"]._local.shape)
            del eng
        got = engine_prefill_logits(ServeEngine(model, slots=MP_SERVE_GATE[0],
                                                block_size=SERVE_BLOCK, min_bucket=8,
                                                mesh=mesh), mp_serve_gate_tokens())
        want = torch.load(mp_path(f"serve_tp_{name}.pt")).cuda()
        out[f"{name}_logits"] = [rel_rms(got, want), float((got - want).abs().max())]
        del got, want
        for quant in pools:
            streams, want = torch.load(mp_path(f"serve_tp_forced_{name}_{int(quant)}.pt"))
            _, got = forced_decode(ServeEngine(model, slots=SERVE_FORCED[0],
                                               block_size=SERVE_BLOCK, min_bucket=8, mesh=mesh,
                                               kv_quant=quant), streams)
            out[f"{name}_{int(quant)}"]["forced"] = forced_rms(got, want.cuda())
            del got, want
        if name == "bf16":
            keep = model
        else:
            del model
    model = keep
    eng = ServeEngine(model, slots=SERVE_SLOTS, block_size=SERVE_BLOCK, min_bucket=8, mesh=mesh)
    gen = np.random.default_rng(2)
    for i in range(SERVE_SLOTS):
        eng.submit(gen.integers(0, 32000, 48).astype(np.int32), 200, rid=f"p{i}", seed=i)
    for _ in range(6):
        eng.step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mp_reset_stats()
    sync()
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        eng.step()
    end.record()
    sync()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / 10
    out["ev_ms"] = start.elapsed_time(end) / 10
    out["coll_ms"] = sum(bp.STATS["seconds"].values()) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        sync()
    out["launches"] = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.is_user_annotation and e.self_device_time_total > 0)
    out["decoding"] = len(eng._decoding)
    return out


def mp_serve_tp(card):
    """(g): CFG_1B at tp 2 as 2 processes, one engine a process, against
    the driver-mode tp 2 engine on the same card, weights and traffic:
    every process emits the same tokens; in float32 (TF32 off) they are
    the driver-mode engine's token for token; in bf16 the streams' match
    is reported, since the driver-mode engine batches the tp ranks' `down`
    projection, whose bf16 bits differ from a rank's alone, and the
    prefill logits and each decode step's logits, driver mode's greedy
    tokens fed to both pools (`forced_decode`), are held to
    SERVE_RMS_TOL."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    want = {}
    for name, argv, pools in MP_SERVE_RUNS:
        model = mp_serve_model(argv)
        for quant in pools:
            eng, wall = serve_run(model, bimodal_traffic(MP_SERVE_REQUESTS), slots=SERVE_SLOTS,
                                  block_size=SERVE_BLOCK, min_bucket=8, mesh=tp_mesh(2),
                                  kv_quant=quant)
            want[f"{name}_{int(quant)}"] = {str(k): v for k, v in completions(eng).items()}
            print(f"  driver-mode tp 2, {name}, {'int8' if quant else 'float'} pool: "
                  f"{MP_SERVE_REQUESTS} requests in {wall:.3f} s  [{card}]")
            del eng
            streams, logits = forced_decode(ServeEngine(
                model, slots=SERVE_FORCED[0], block_size=SERVE_BLOCK, min_bucket=8,
                mesh=tp_mesh(2), kv_quant=quant))
            torch.save((torch.from_numpy(streams), logits.cpu()),
                       mp_path(f"serve_tp_forced_{name}_{int(quant)}.pt"))
            del logits
        torch.save(engine_prefill_logits(
            ServeEngine(model, slots=MP_SERVE_GATE[0], block_size=SERVE_BLOCK, min_bucket=8,
                        mesh=tp_mesh(2)), mp_serve_gate_tokens()).cpu(),
            mp_path(f"serve_tp_{name}.pt"))
        del model
        torch.cuda.empty_cache()
    print(f"  (g) CFG_1B serving at tp 2 as 2 processes (a tp rank each, its KV-head shard of "
          f"the pool, the lanes replicated), {MP_SERVE_REQUESTS} requests of the bimodal burst, "
          f"bf16 (float and int8 pools) and float32, against the driver-mode tp 2 engine")
    res = yield "serve_tp"
    for key in want:
        check(res[0][key]["tokens"] == res[1][key]["tokens"],
              f"the gang's two processes emitted different tokens ({key})")
    for r, rr in enumerate(res):
        for key, w in want.items():
            got = rr[key]["tokens"]
            same, total, reqs = match_rate(w, got)
            print(f"  rank {r}, {key.replace('_0', ', float pool').replace('_1', ', int8 pool')}: "
                  f"{same} of {total} greedy tokens equal the driver-mode engine's, {reqs} of "
                  f"{len(w)} requests whole; {rr[key]['wall']:.3f} s")
            if key.startswith("float32"):
                check(got == w, f"rank {r}: the float32 gang's greedy streams differ from "
                      "driver mode's")
            steps, tol = rr[key]["forced"], MP_SERVE_FORCED_RMS[key.split("_")[0]]
            print(f"  rank {r}, {key.replace('_0', ', float pool').replace('_1', ', int8 pool')}: "
                  f"driver mode's greedy tokens fed to {SERVE_FORCED[0]} slots for "
                  f"{SERVE_FORCED[2]} steps, each step's logits rms(diff)/rms at most "
                  f"{max(steps):.4e} (mean {sum(steps) / len(steps):.4e}, <= {tol:g})")
            check(max(steps) <= tol, f"rank {r}: the gang's decode-step logits stray from "
                  f"driver mode's ({key})")
        for name, tol in (("bf16", SERVE_RMS_TOL), ("float32", MP_SERVE_F32_RMS)):
            r_, m_ = rr[f"{name}_logits"]
            print(f"  rank {r}, {name}: prefill logits of {MP_SERVE_GATE[0]} x "
                  f"{MP_SERVE_GATE[1]} against driver mode's rms(diff)/rms {r_:.4e} (<= {tol:g}),"
                  f" max |diff| {m_:.4e}")
            check(r_ <= tol, f"rank {r}: the gang's {name} logits stray from driver mode's")
        print(f"  rank {r}: 8-slot bf16 decode step {rr['ev_ms']:.4f} ms by CUDA events, "
              f"{rr['host_ms']:.4f} ms on the host, {rr['coll_ms']:.4f} ms of it inside the "
              f"collectives; {rr['launches']} kernel launches; pool shard "
              f"{rr['pool_local']}  [{card}]")
        check(rr["decoding"] == SERVE_SLOTS, "the gang's profiled engine is not at 8 slots")


# -- [planner]: the collective planner and the p2p plane ------------------------

PLAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".planner_smoke")
PLAN_WORLD = 8
PLAN_OPS = ("all_reduce", "all_gather", "reduce_scatter")
PLAN_BUCKETS = tuple((64 << 10) << (2 * i) for i in range(6))  # 64 KiB .. 64 MiB a rank
PLAN_CHECK_BYTES = 1 << 20  # a rank, for the planned-against-stock checks
# a planned reduction sums in another order than the stock fold: float32
# within rtol 1e-5, bf16 (rounded at every partial sum) within 2^-6 and
# 2^-5 of the largest entry; gathers are data movement, bitwise
PLAN_TOL = {torch.float32: dict(rtol=1e-5, atol_frac=1e-6),
            torch.bfloat16: dict(rtol=2 ** -6, atol_frac=2 ** -5)}
PLANE_BW_BYTES, PLANE_BW_REPS = 256 << 20, 3
PLAN_EXEC_WORLD, PLAN_EXEC_BYTES = 4, 64 << 20
PLAN_SKEW_TIMEOUT_S = 60.0
PLAN_TIMED_STEPS = 1


@contextlib.contextmanager
def planner_env(**env):
    """The planner's environment for the block (None unsets a name)."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plan_inputs(op, W, nbytes, dtype, seed=0):
    """A rank-stacked payload of `nbytes` a rank: (W, n), or (W, W, n/W)
    for reduce_scatter."""
    n = nbytes // dtype.itemsize
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(W, n, device="cuda", generator=gen).to(dtype)
    return x.reshape(W, W, n // W) if op == "reduce_scatter" else x


def plan_stock(op, x, group=None):
    """The stock collective on the stacked x (the planner off)."""
    dt = DistTensor.wrap(x.clone(), group)
    if op == "all_reduce":
        tdx.all_reduce(dt, group=group)
        return dt.tensor
    return getattr(tdx, op)(dt, group=group).tensor


def planner_probe(card):
    """(a) The probe table on cuda:0, driver mode at world 8; the cache a
    second planner reads without probing; every schedule against the
    stock collective."""
    import logging

    from pytorch_distributed_example_tpu_torch import plan
    from pytorch_distributed_example_tpu_torch.plan import driver as pdrv, probe as pprobe
    from pytorch_distributed_example_tpu_torch.plan.planner import CollectivePlanner

    cache_file = os.path.join(PLAN_DIR, "probe_cache.json")
    # a table measured on another platform (a TPU's topology key) is in
    # the file: this gang must not read it, but warn and probe fresh
    pprobe.ProbeCache(cache_file).update(f"w{PLAN_WORLD}/h{PLAN_WORLD}/tpu", "all_reduce",
                                         PLAN_BUCKETS[0], {"onepass": 1.0, "ring": 2.0})
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    log = logging.getLogger(pprobe.__name__)
    handler = Catch(logging.WARNING)
    log.addHandler(handler)
    pg = tdx.init_process_group(world_size=PLAN_WORLD)
    try:
        with planner_env(TDX_PLANNER_PROBE_CACHE=cache_file):
            pl = plan.planner_for_group(pg)
            topo = pl.topology.key()
            alg, source = pl.choose("all_reduce", PLAN_BUCKETS[0])
            print(f"  topology {topo}; a cache holding only a TPU's key: "
                  f"{len([w for w in warned if 'do not apply' in w])} stale-topology "
                  f"warning(s), choice ({alg}, {source})")
            check(source == "probe" and any("do not apply" in w for w in warned),
                  "a probe cache of another topology must warn and be probed fresh")
            winners = {}
            for op in PLAN_OPS:
                cands = pl.candidates(op)
                for dtype in (torch.float32, torch.bfloat16):
                    for b in PLAN_BUCKETS:
                        t = pprobe.probe_driver(pg.mesh, pdrv.AXIS, PLAN_WORLD, op, cands, b,
                                                dtype=dtype)
                        best = min(t, key=t.get)
                        if dtype == torch.float32:
                            pl.cache.update(topo, op, b, t)
                            winners[(op, b)] = best
                        bound = c10d_bound_bytes(op, PLAN_WORLD, b) / HBM_BYTES_S * 1e3
                        print(f"  {op} {str(dtype)[6:]} {b >> 10} KiB a rank: "
                              + ", ".join(f"{a} {v * 1e3:.4f} ms" for a, v in t.items())
                              + f"; argmin {best} ({t[best] * 1e3 / bound:.2f}x the HBM "
                              f"bound {bound:.4f} ms)  [{card}]")
            fresh = CollectivePlanner(
                pl.topology, mesh=pg.mesh, axis=pdrv.AXIS, cache=pprobe.ProbeCache(cache_file),
                probe_fn=lambda *a: (_ for _ in ()).throw(SmokeFailure("probed again")))
            read = {k: fresh.choose(k[0], k[1]) for k in winners}
            check(all(read[k] == (winners[k], "cache") for k in winners),
                  f"a second planner should read every choice from the cache: {read}")
            print(f"  a second planner read all {len(read)} float32 choices from "
                  f"{os.path.relpath(cache_file)} and probed nothing")
            worst = {}
            for op in PLAN_OPS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = plan_inputs(op, PLAN_WORLD, PLAN_CHECK_BYTES, dtype)
                    want = plan_stock(op, x)
                    for alg in pl.candidates(op)[1:]:
                        got = pdrv.compiled_body(op, alg, PLAN_WORLD)(x)
                        if op == "all_gather":
                            ok = torch.equal(got, want)
                            err = 0.0 if ok else float("inf")
                        else:
                            err, _, ok = compare(got, want, **PLAN_TOL[dtype])
                        worst[(op, alg, str(dtype)[6:])] = err
                        check(ok, f"{op} {alg} {dtype} differs from the stock collective")
            print(f"  planned against stock at {PLAN_CHECK_BYTES >> 20} MiB a rank, world "
                  f"{PLAN_WORLD} (gathers bitwise, sums under {tol_text_plan()}): max |diff| "
                  + ", ".join(f"{'/'.join(k)} {v:.3e}" for k, v in worst.items()))
            sub = tdx.new_group([0, 1])
            bitwise = {}
            for op, alg in (("all_reduce", "ring"), ("all_reduce", "rhd"),
                            ("reduce_scatter", "ring"), ("all_gather", "ring")):
                for dtype in (torch.float32, torch.bfloat16):
                    x = plan_inputs(op, 2, PLAN_CHECK_BYTES, dtype, seed=3)
                    plan.enable_for_group(sub, False)
                    want = plan_stock(op, x, sub)
                    plan.enable_for_group(sub, True)
                    with planner_env(TDX_PLANNER_FORCE=alg):
                        got = plan_stock(op, x, sub)
                    check(plan.planner_for_group(sub).last_choice[1] == alg,
                          f"the dispatch seam did not take {alg}")
                    bitwise[f"{op}/{alg}/{str(dtype)[6:]}"] = torch.equal(got, want)
            print(f"  the two-rank geometry through the dispatch seam, bitwise the stock "
                  f"collective: {bitwise}")
            check(all(bitwise.values()), "a two-rank planned collective is not bitwise stock")
    finally:
        log.removeHandler(handler)
        tdx.destroy_process_group()


def tol_text_plan():
    return "; ".join(f"{str(d)[6:]} rtol {t['rtol']:g}, atol {t['atol_frac']:g} of the max"
                     for d, t in PLAN_TOL.items())


def planner_fsdp_tp(card):
    """(b) CFG_1B over fsdp 2 x tp 2 with the planner on, its tp sums
    forced to the ring and then to rhd (`plan.traced`), against the stock
    step's losses of [fsdp_tp]; returns the profiled steps' routes."""
    from pytorch_distributed_example_tpu_torch.plan import driver as pdrv, traced

    key = tuple(FSDP_TP_ARGV)
    stock_losses, stock_ms = SHARDED_LOSSES[key], SHARDED_STEP_MS[key]
    total = {name: 0 for name in fa.ROUTE_LAUNCHES}
    bodies = []

    def counted(real):
        def body_for(*a, **k):
            bodies.append(a[:2])
            return real(*a, **k)
        return body_for

    try:
        for alg in ("ring", "rhd"):
            print(f"  TDX_COLLECTIVE_PLANNER=1 TDX_PLANNER_FORCE={alg}:")
            bodies.clear()
            traced.reset()
            with planner_env(TDX_COLLECTIVE_PLANNER="1", TDX_PLANNER_FORCE=alg), \
                    patched(pdrv, "body_for", counted):
                routes, _ = sharded_train(FSDP_TP_ARGV, card, PLAN_TIMED_STEPS)
            losses = SHARDED_LOSSES[key]
            diff = max(abs(a - b) for a, b in zip(losses, stock_losses))
            print(f"  {alg}: losses {losses} vs the stock step's {stock_losses} (max |diff| "
                  f"{diff:.3e}); step {SHARDED_STEP_MS[key]:.2f} ms vs stock {stock_ms:.2f} ms; "
                  f"{len(bodies)} planned tp sums  [{card}]")
            check(diff <= SHARDED_LOSS_TOL, f"the {alg} step's losses stray from the stock step")
            check(("all_reduce", alg) in bodies, f"the tp sums did not take {alg}")
            for k, v in routes.items():
                total[k] += v
    finally:
        SHARDED_LOSSES[key], SHARDED_STEP_MS[key] = stock_losses, stock_ms
        traced.reset()
    return total


def planner_mnist(card):
    """(c) DDP-MNIST at world 8 with the planner on: `plan.ddp_comm_hook`
    makes the step's default hook `planner_hook` (each leaf's mean through
    `plan.traced`, its buckets prepared on the host), unforced (probed)
    and forced to the ring, against the stock step under
    cudnn.deterministic."""
    hooks = []

    def counted(real):
        def planner_hook(*a, **k):
            hooks.append(1)
            return real(*a, **k)
        return planner_hook

    torch.backends.cudnn.deterministic = True
    try:
        stock, _ = mnist_ddp_run("cuda", "auto", False)
        for force in (None, "ring"):
            with planner_env(TDX_COLLECTIVE_PLANNER="1", TDX_PLANNER_FORCE=force,
                             TDX_PLANNER_PROBE_CACHE=os.path.join(PLAN_DIR, "mnist.json")), \
                    patched(comm_hooks, "planner_hook", counted):
                hooks.clear()
                got, _ = mnist_ddp_run("cuda", "auto", False)
            err = float(((got - stock).abs() / stock.abs()).max())
            print(f"  {MNIST_CHECK_STEPS} DDP-MNIST steps at world {MNIST_WORLD} through "
                  f"planner_hook ({force or 'probed'}): losses {got.tolist()} vs stock "
                  f"{stock.tolist()}, max rel err {err:.3e} (limit {MNIST_LOSS_RTOL:g})")
            check(hooks and err <= MNIST_LOSS_RTOL,
                  "the planner's DDP hook disagrees with the stock step")
    finally:
        torch.backends.cudnn.deterministic = False


def mp_plane_bw_worker(rank, world):
    """A 256 MiB bf16 CUDA tensor from rank 0 to rank 1, PLANE_BW_REPS times
    through the p2p plane, then through torch.distributed's gloo send of a
    pinned host copy; the receiver's seconds each."""
    import torch.distributed as tdist

    from pytorch_distributed_example_tpu_torch import distributed as dist

    gen = torch.Generator("cuda").manual_seed(11)
    x = torch.randn(PLANE_BW_BYTES // 2, device="cuda", generator=gen).to(torch.bfloat16)
    plane, pg = dist._p2p_plane, dist._get_default_group()
    out = {"listening": plane.listening, "plane_s": [], "gloo_s": []}
    buf = torch.empty_like(x)
    for _ in range(PLANE_BW_REPS):
        tdx.barrier()
        sync()
        t0 = time.perf_counter()
        if rank == 0:
            tdx.send(x, 1)
        else:
            tdx.recv(buf, 0)
        sync()
        out["plane_s"].append(time.perf_counter() - t0)
    out["equal"] = bool(torch.equal(buf, x)) if rank == 1 else True
    host = torch.empty(x.shape, dtype=torch.int16, pin_memory=True)
    for _ in range(PLANE_BW_REPS):
        tdx.barrier()
        sync()
        t0 = time.perf_counter()
        if rank == 0:
            staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            staged.copy_(x)
            tdist.send(staged.view(torch.int16), 1, group=pg.torch_group)
        else:
            tdist.recv(host, 0, group=pg.torch_group)
            buf.copy_(host.view(torch.bfloat16))
        sync()
        out["gloo_s"].append(time.perf_counter() - t0)
    out["gloo_equal"] = bool(torch.equal(buf, x)) if rank == 1 else True
    out["frames"] = [plane.frames_sent, plane.frames_received]
    out["bytes"] = [plane.bytes_sent, plane.bytes_received]
    return out


def mp_plan_exec_worker(rank, world):
    """ring, rhd and hier all-reduces of 64 MiB a rank over the p2p plane
    (the planner's multiproc plane, forced; `TDX_TOPOLOGY` gives two hosts
    so hier has leaders), each against the stock gloo all_reduce and
    against itself re-executed; a group a schedule, so each agrees its own
    choice."""
    from pytorch_distributed_example_tpu_torch import distributed as dist
    from pytorch_distributed_example_tpu_torch import plan

    os.environ.update(TDX_PLANNER_PROBE_CACHE="", TDX_TOPOLOGY="0,0,1,1")
    gen = torch.Generator("cuda").manual_seed(100 + rank)
    x = torch.randn(1, PLAN_EXEC_BYTES // 4, device="cuda", generator=gen)
    stock = DistTensor.wrap(x.clone(), dist._get_default_group())
    sync()
    t0 = time.perf_counter()
    tdx.all_reduce(stock)
    sync()
    out = {"stock_s": time.perf_counter() - t0}
    for alg in ("ring", "rhd", "hier"):
        g = tdx.new_group(list(range(world)))
        plan.enable_for_group(g, True)
        os.environ["TDX_PLANNER_FORCE"] = alg
        runs, secs = [], []
        for _ in range(2):
            dt = DistTensor.wrap(x.clone(), g)
            sync()
            t0 = time.perf_counter()
            tdx.all_reduce(dt, group=g)
            sync()
            secs.append(time.perf_counter() - t0)
            runs.append(dt.tensor)
        out[alg] = {"choice": list(plan.planner_for_group(g).last_choice),
                    "again": bool(torch.equal(runs[0], runs[1])),
                    "vs_stock": compare(runs[0], stock.tensor, **PLAN_TOL[torch.float32]),
                    "digest": int(runs[0].view(torch.int32).long().sum()), "s": secs}
    out["frames"] = dist._p2p_plane.frames_sent
    return out


def mp_plane_worker(rank, world):
    """The world-2 gang of [planner] (d): the plane's bandwidth, then the
    skewed force."""
    out = mp_plane_bw_worker(rank, world)
    out["skew"] = mp_plan_skew_worker(rank, world)
    return out


def mp_plan_skew_worker(rank, world):
    """A skewed TDX_PLANNER_FORCE (ring on rank 0, rhd on rank 1): prepare()
    must fail on both ranks, naming the first divergent eqn."""
    from pytorch_distributed_example_tpu_torch import distributed as dist
    from pytorch_distributed_example_tpu_torch.plan import traced
    from pytorch_distributed_example_tpu_torch.schedule import ProgramScheduleMismatchError

    os.environ.update(TDX_COLLECTIVE_PLANNER="1", TDX_PLANNER_PROBE_CACHE="",
                      TDX_PLANNER_FORCE=("ring", "rhd")[rank])
    t0 = time.perf_counter()
    try:
        traced.prepare(dist._get_default_group(), [("all_reduce", 1 << 20, "avg")],
                       timeout=PLAN_SKEW_TIMEOUT_S)
        return {"mismatch": None, "s": time.perf_counter() - t0}
    except ProgramScheduleMismatchError as e:
        return {"mismatch": str(e), "s": time.perf_counter() - t0}


def planner_gangs(card):
    """(d) Gangs sharing cuda:0 over "cuda:gloo": the plane's bandwidth, the
    executor's schedules, a skewed force."""
    res = mp_gang("plane", world=2)
    skew = [r["skew"] for r in res]
    gb = PLANE_BW_BYTES / 1e9
    recv = res[1]
    plane, gloo = min(recv["plane_s"]), min(recv["gloo_s"])
    print(f"  plane: {PLANE_BW_BYTES >> 20} MiB bf16 CUDA tensor rank 0 -> 1 over the p2p "
          f"plane: {recv['plane_s']} s, best {gb / plane:.3f} GB/s; the same through "
          f"torch.distributed's staged gloo send: {recv['gloo_s']} s, best "
          f"{gb / gloo:.3f} GB/s; frames sent {res[0]['frames'][0]} "
          f"({res[0]['bytes'][0]} bytes), received {recv['frames'][1]}  [{card}]")
    check(res[0]["listening"] and recv["listening"], "a plane is not listening")
    check(res[0]["frames"][0] >= PLANE_BW_REPS and recv["frames"][1] >= PLANE_BW_REPS,
          "the plane carried no frames: a listener published \"none\"")
    check(recv["equal"] and recv["gloo_equal"], "the received tensor differs from the sent one")
    res = mp_gang("plan_exec", world=PLAN_EXEC_WORLD)
    for alg in ("ring", "rhd", "hier"):
        digests = {r[alg]["digest"] for r in res}
        for r, rr in enumerate(res):
            got = rr[alg]
            print(f"  rank {r} {alg}: {PLAN_EXEC_BYTES >> 20} MiB a rank over the plane in "
                  f"{got['s']} s (stock gloo all_reduce {rr['stock_s']:.4f} s); against "
                  f"stock max |diff| {got['vs_stock'][0]:.3e} ({got['vs_stock'][2]}); "
                  f"re-executed bitwise {got['again']}  [{card}]")
            check(got["choice"] == ["all_reduce", alg, "force"], f"rank {r} did not run {alg}")
            check(got["again"] and got["vs_stock"][2], f"rank {r}: {alg} is not bitwise "
                  "re-executable or strays from the stock all_reduce")
        check(len(digests) == 1, f"{alg}: the ranks hold different results")
    check(all(r["frames"] > 0 for r in res), "the executor sent no frames over the plane")
    for r, rr in enumerate(skew):
        print(f"  skewed force, rank {r}: {('raised in %.2f s: ' % rr['s'])}"
              f"{(rr['mismatch'] or 'no error')[:160]}")
        check(rr["mismatch"] is not None and "#1" in rr["mismatch"]
              and rr["s"] < PLAN_SKEW_TIMEOUT_S,
              f"rank {r}: a skewed force must fail prepare() naming eqn #1")


def planner_phase(card):
    """The collective planner and the p2p plane: (a) the probe table, (b)
    the planner's fsdp 2 x tp 2 step, (c) DDP-MNIST through the planner's
    hook, (d) the gangs. Returns (b)'s launches by route."""
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    os.makedirs(PLAN_DIR)
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    try:
        for part in (planner_probe, planner_fsdp_tp, planner_mnist, planner_gangs):
            t0 = time.perf_counter()
            got = part(card)
            if part is planner_fsdp_tp:
                routes = got
            torch.cuda.empty_cache()
            print(f"  {part.__name__} in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(PLAN_DIR, ignore_errors=True)
        shutil.rmtree(MP_DIR, ignore_errors=True)
    return routes


MP_WORKERS = {"fsdp_tp": mp_fsdp_tp_worker, "ring": mp_ring_worker,
              "pipeline": mp_pipeline_worker, "ep": mp_ep_worker, "nccl": mp_nccl_worker,
              "serve_tp": mp_serve_tp_worker, "plane": mp_plane_worker,
              "plan_exec": mp_plan_exec_worker}


def mp_worker(argv):
    """`chip_smoke.py --worker PARTS RANK WORLD PORTS BACKEND`: one rank of a
    gang; runs each of the comma-separated PARTS in turn, over a process
    group of its own at the matching one of PORTS, and writes each part's
    result as JSON for the phase."""
    parts, rank, world = argv[0].split(","), int(argv[1]), int(argv[2])
    ports, backend = [int(p) for p in argv[3].split(",")], argv[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for part, port in zip(parts, ports, strict=True):
        torch.cuda.reset_peak_memory_stats()
        if part == "cifar":  # the example brings its gang up itself
            res = mp_cifar_worker(rank, world, port, backend)
        else:
            mp_init(rank, world, port, backend)
            try:
                res = MP_WORKERS[part](rank, world)
            finally:
                tdx.destroy_process_group()
        with open(mp_path(f"{part}_{rank}.json"), "w") as f:
            json.dump(res, f)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


# [multiproc]'s gangs: (parts, world, backend), each part a generator that
# sets up its driver-mode reference, yields its worker's name, takes the
# gang's results and checks them; a gang's processes run its parts in turn
MP_GANGS = (((("multiproc", mp_fsdp_tp), ("multiproc_ring", mp_ring),
              ("multiproc", mp_pipeline), (None, mp_ep)), MP_WORLD, MP_BACKEND),
            (((None, mp_cifar), (None, mp_serve_tp)), 2, MP_BACKEND),
            (((None, mp_nccl),), 1, "nccl"))


def multiproc_phase(card):
    """The training parallelisms as process gangs that share cuda:0, over
    gloo ("cuda:gloo"): (a) CFG_1B over fsdp 2 x tp 2, (b) the ring and
    Ulysses, (c) 1F1B at pp 4, (d) make_ep_moe, (e) SyncBN through the
    CIFAR example, (f) a world-1 nccl gang, (g) CFG_1B tensor-parallel
    serving at tp 2, an engine a process. (a)-(d) share one gang of 4
    processes and (e) and (g) one of 2. Returns the gangs' counted
    flash launches by route, by the regime each part puts the kernels in:
    (a)'s and (c)'s under "multiproc" (resident), (b)'s ring under
    "multiproc_ring" (streamed)."""
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    launches = {key: {name: 0 for name in fa.ROUTE_LAUNCHES}
                for key in ("multiproc", "multiproc_ring")}
    try:
        for parts, world, backend in MP_GANGS:
            runs = []
            for key, part in parts:
                t0 = time.perf_counter()
                run = part(card)
                runs.append((key, part.__name__, run, next(run)))
                print(f"  {part.__name__} set up in {time.perf_counter() - t0:.1f} s")
            res = mp_gang(tuple(name for _, _, _, name in runs), world=world, backend=backend)
            for key, fn_name, run, name in runs:
                t0 = time.perf_counter()
                try:
                    run.send(res[name])
                    check(False, f"[multiproc] {fn_name} asked for a second gang")
                except StopIteration as stop:
                    got = stop.value
                if key is not None:
                    for k, v in got.items():
                        launches[key][k] += v
                print(f"  {fn_name} checked in {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(MP_DIR, ignore_errors=True)
    print(f"  counted flash launches by regime: {launches}")
    return launches


# -- [elastic]: the elastic agent, the serve worker gang, pre-warm, the
# debug frontend and the elastic trainer --------------------------------------

EL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".elastic_smoke")
EL_SERVE_MODULE = "pytorch_distributed_example_tpu_torch.examples.serve_worker"
# [serve]'s geometry: CFG_1B in bf16, 8 slots of 16-token blocks (the
# engine's default, as the workers'), buckets from 8; unchunked prefill, so a request's program shapes do not depend on
# what shares its steps, and every incarnation replays it bit for bit
EL_SERVE_ARGV = ["--config", "CFG_1B", "--slots", str(SERVE_SLOTS), "--min-bucket", "8"]
EL_REQUESTS, EL_BUDGET = 16, 32
EL_WAVES = (6, 5, 5)  # before 2 -> 3, into the 3-wide gang, after the resize to 1
EL_DRAIN_S = 30.0
EL_DEVICE = "cuda"  # this process's reference, warm-pass check and replay
EL_ENV = {}  # added to every worker's environment
EL_TIMEOUT_S = 240.0  # a generation's forming, or the traffic's end (a hung gang fails)
# checkpoints at 15 and 30 only: the final save moves generation 0's
# step-15 checkpoint to `.prev`, the world-1 replay's starting point
EL_TRAIN = dict(steps=30, every=15, batch=32)
# world 2 against its replay: the replay computes both ranks' gradients in
# one rank-batched (vmapped) pass, whose convolutions reduce in other
# orders than one rank's pass in its own process (6e-08 apart after 10
# steps on the CPU); world 1 from the same params is held bitwise
EL_TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
EL_STAGES = (("spawn and imports", "decision", "start"), ("CUDA init", "start", "cuda_ready"),
             ("model build", "cuda_ready", "model_built"),
             ("engine and warm pass", "model_built", "engine_built"),
             ("restore and register", "engine_built", "registered"),
             ("first token", "registered", "first_token"))


def el_free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def el_serve_args():
    from pytorch_distributed_example_tpu_torch.examples import serve_worker

    return serve_worker, serve_worker.parse_args(EL_SERVE_ARGV)


def el_traffic():
    """16 of the bimodal burst's requests, each with a budget of 32."""
    return [(f"r{seed}", prompt, EL_BUDGET, seed)
            for prompt, _, seed in bimodal_traffic(EL_REQUESTS)]


def el_engine(model, args, **kw):
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    return ServeEngine(model, slots=args.slots, min_bucket=args.min_bucket, **kw)


def el_pool_state(eng):
    return ([buf.clone() for node in eng.cache.tree.values() for buf in node["attn"].values()],
            [t.clone() for t in (eng._dev_lengths, eng._dev_tokens, eng._dev_rngs)],
            eng.cache.block_tables.copy(), list(eng.cache._free_blocks), eng.queue.depth,
            eng.metrics.steps)


def el_reference(card):
    """The uninterrupted engine on cuda:0 from the workers' seed and
    geometry: its tokens are what every gang must emit. Then (b)'s warm
    pass on a live engine, mid-stream: the pool (sink included), lanes,
    tables, allocator, queue and step count bitwise as before, and the
    engine's streams still the reference's."""
    from pytorch_distributed_example_tpu_torch.serve import prewarm

    serve_worker, args = el_serve_args()
    model = serve_worker.build_model(args, torch.device(EL_DEVICE, 0))
    traffic = el_traffic()
    eng = el_engine(model, args)
    sync()
    t0 = time.perf_counter()
    for rid, prompt, budget, seed in traffic:
        eng.submit(prompt, budget, rid=rid, seed=seed)
    eng.run(max_steps=100000)
    sync()
    ref = {r: list(c.tokens) for r, c in eng.completions.items()}
    check(len(ref) == EL_REQUESTS and all(len(t) == EL_BUDGET for t in ref.values()),
          "[elastic] the reference engine did not finish its requests")
    print(f"  reference: CFG_1B bf16 on cuda:0, {EL_REQUESTS} bimodal requests x {EL_BUDGET} "
          f"tokens greedy, {args.slots} slots, block {eng.cache.block_size}, buckets from "
          f"{args.min_bucket}: {eng.metrics.steps} steps in {time.perf_counter() - t0:.2f} s")
    del eng
    live = el_engine(model, args)
    for rid, prompt, budget, seed in traffic:
        live.submit(prompt, budget, rid=rid, seed=seed)
    for _ in range(6):
        live.step()
    check(live.num_active > 0 and live.queue.depth > 0, "[elastic] the live engine is idle")
    before = el_pool_state(live)
    sync()
    t0 = time.perf_counter()
    timings = prewarm.prewarm_engine_programs(live)
    warm_s = time.perf_counter() - t0
    after = el_pool_state(live)
    same = (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
            and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
            and np.array_equal(before[2], after[2]) and before[3:] == after[3:])
    pool_bytes = sum(t.numel() * t.element_size() for t in before[0])
    print(f"  (b) warm pass on a live engine ({live.num_active} slots live, {live.queue.depth} "
          f"queued): {len(timings)} program calls in {warm_s:.3f} s; the pool ({pool_bytes} "
          f"bytes, the sink included), the lanes, tables, allocator, queue and steps bitwise "
          f"unchanged: {same}")
    check(same, "[elastic] the warm pass changed the live engine")
    del before, after
    live.run(max_steps=100000)
    check({r: list(c.tokens) for r, c in live.completions.items()} == ref,
          "[elastic] the warmed live engine's streams part from the cold engine's")
    print("  (b) the warmed live engine then finishes with the cold engine's tokens")
    del live, model
    torch.cuda.empty_cache()
    return traffic, ref


def el_logs(log_dir):
    """Each worker's `serve_worker timings` row from the agent's logs,
    keyed (generation, rank)."""
    rows = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            for line in f:
                if line.startswith("serve_worker timings "):
                    row = json.loads(line[len("serve_worker timings "):])
                    rows[(row["gen"], row["rank"])] = row
    return rows


def el_log_tail(log_dir, n=30):
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            lines = f.read().splitlines()[-n:]
        for line in lines:
            print(f"    [{name}] {line}")


def el_stages(rows, gen, decision):
    """Where a resize's seconds went: the decision (or the kill) to each
    stamp of the new generation's first worker to emit a token. None when
    no worker of `gen` logged a token (a worker killed before its exit
    logs nothing)."""
    mine = [r for (g, _), r in rows.items() if g == gen and r["first_token"] is not None]
    if not mine:
        return None
    stamps = dict(min(mine, key=lambda r: r["first_token"]), decision=decision)
    parts = [f"{name} {stamps[b] - stamps[a]:.2f}" for name, a, b in EL_STAGES]
    return stamps["first_token"] - decision, ", ".join(parts)


class ElasticGang:
    """A `LocalElasticAgent` on a thread of this process, its store client
    and a `GangRouter`; every worker ended on the way out."""

    def __init__(self, name, nproc, active, env, extra=()):
        from pytorch_distributed_example_tpu_torch.elastic import LocalElasticAgent, WorkerSpec
        from pytorch_distributed_example_tpu_torch.serve.worker import GangRouter
        from pytorch_distributed_example_tpu_torch.store import TCPStore

        self.port = el_free_port()
        self.log_dir = os.path.join(EL_DIR, f"logs_{name}")
        root = os.path.dirname(os.path.abspath(__file__))
        spec = WorkerSpec(
            entrypoint=[EL_SERVE_MODULE, *EL_SERVE_ARGV, *extra], module=True,
            nproc_per_node=nproc, min_nproc=1, master_port=self.port, max_restarts=4,
            monitor_interval_s=0.05, serve_drain_grace_s=EL_DRAIN_S,
            env={"OMP_NUM_THREADS": "1",
                 "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                 **EL_ENV, **env})
        self.agent = LocalElasticAgent(spec, log_dir=self.log_dir)
        self.agent.active_nproc = active
        self.result = {}
        self.thread = threading.Thread(target=lambda: self.result.update(run=self.agent.run()),
                                       daemon=True)
        self.thread.start()
        self.store = TCPStore("127.0.0.1", self.port, is_master=False, timeout=60.0)
        self.router = GangRouter(self.store)

    def formed(self, gen, n):
        from pytorch_distributed_example_tpu_torch.serve.worker import wait_registered

        try:
            return wait_registered(self.store, gen, n, timeout=EL_TIMEOUT_S)
        except Exception:
            el_log_tail(self.log_dir)
            raise

    def submit(self, reqs):
        return [self.router.submit(prompt, budget, rid=rid, seed=seed)
                for rid, prompt, budget, seed in reqs]

    def resize(self, n):
        from pytorch_distributed_example_tpu_torch.elastic import request_resize

        t = time.time()
        request_resize("127.0.0.1", self.port, n)
        return t

    def wait_gone(self, rows):
        """Until the agent has replaced the workers of a registration
        `rows` (it reaps them at its teardown, then spawns the next)."""
        pids = {int(r["pid"]) for r in rows}
        deadline = time.monotonic() + EL_TIMEOUT_S
        while any(w.proc is not None and w.proc.pid in pids for w in list(self.agent._workers)):
            check(time.monotonic() < deadline, "[elastic] the old generation did not exit")
            time.sleep(0.02)

    def finish(self, rids):
        try:
            out = self.router.wait_all(rids, timeout=EL_TIMEOUT_S)
        except Exception:
            el_log_tail(self.log_dir)
            raise
        self.router.shutdown()
        self.thread.join(timeout=EL_TIMEOUT_S)
        check(not self.thread.is_alive(), "[elastic] the agent did not end after shutdown")
        return out

    def close(self):
        if self.thread.is_alive():  # a failed check: end the gang
            with contextlib.suppress(Exception):
                self.router.shutdown(sweep=False)
            self.thread.join(timeout=60.0)
            for w in list(self.agent._workers):
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
        with contextlib.suppress(Exception):
            self.store.close()


def el_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read().decode())


def el_admitted(debug_port, world):
    """Until a worker's engine has admitted a request (its /serve)."""
    deadline = time.monotonic() + EL_TIMEOUT_S
    while True:
        with contextlib.suppress(OSError):
            if any(el_get(debug_port + r, "/serve")["engine"]["admitted"] for r in range(world)):
                return
        check(time.monotonic() < deadline, "[elastic] no worker admitted a request")
        time.sleep(0.01)


def el_debug_check(debug_port, world):
    """(d): rank 0's debug frontend: /world names the gang's size, /status
    its group, /flight_recorder the ring buffer, /serve the engine."""
    def get(path):
        return el_get(debug_port, path)

    w, st, fr, sv = get("/world"), get("/status"), get("/flight_recorder"), get("/serve")
    eng = sv["engine"]
    admitted = [el_get(debug_port + r, "/serve")["engine"]["admitted"] for r in range(world)]
    print(f"  (d) rank 0's debug frontend: /world mode {w['mode']}, process rank "
          f"{w['process_rank']}, default_pg size {w['groups']['default_pg']['size']} "
          f"({w['groups']['default_pg']['backend']}); /status {sorted(st)}; /flight_recorder "
          f"{len(fr.get('entries', []))} entries; /serve slots {eng['slots']}, submitted "
          f"{eng['submitted']}, admitted {eng['admitted']}, completed {eng['completed']}, "
          f"queue depth {eng.get('queue_depth')}; admitted by rank {admitted}")
    check(w["initialized"] and w["mode"] == "multiproc" and w["process_rank"] == 0
          and w["groups"]["default_pg"]["size"] == world, "[elastic] /world does not name the gang")
    check("default_pg" in st and "entries" in fr, "[elastic] /status or /flight_recorder is off")
    check(eng["slots"] == SERVE_SLOTS and sum(admitted) >= 1,
          "[elastic] /serve does not show the engine's metrics")


def el_serve_gang(card, traffic, ref):
    """(a) and (d): the CFG_1B gang at 2, resized 2 -> 3 mid-traffic, one
    worker SIGKILLed in the 3-wide generation (the agent re-forms at 2),
    then resized to 1; every completion the reference's. The workers
    pre-warm through TDX_PREWARM_DIR: generation 0 writes the manifest,
    the later ones warm from it."""
    import signal

    waves, at = [], 0
    for n in EL_WAVES:
        waves.append(traffic[at:at + n])
        at += n
    debug = el_free_port()
    gang = ElasticGang("a", 3, 2, {"TDX_PREWARM_DIR": os.path.join(EL_DIR, "prewarm")},
                       extra=("--debug-port", str(debug)))
    try:
        t0 = time.perf_counter()
        gang.formed(0, 2)
        print(f"  (a) generation 0: 2 workers registered in {time.perf_counter() - t0:.1f} s")
        rids = gang.submit(waves[0])
        el_admitted(debug, 2)  # mid-traffic: a request is in a slot
        t_grow = gang.resize(3)
        first_done = sum(1 for r in rids if gang.router.result(r))
        rows1 = gang.formed(1, 3)
        rids += gang.submit(waves[1])
        el_admitted(debug, 3)
        el_debug_check(debug, 3)
        done = sum(1 for r in rids if gang.router.result(r))
        # the busiest worker that is not the restore leader (the leader's
        # recovery row outlives the generation), its requests in flight
        leader = int(gang.store.get("serve/restored/gen1").decode())
        busy = {r: el_get(debug + r, "/serve")["engine"]["admitted"] for r in range(3)}
        killed = max((r for r in rows1 if int(r["rank"]) != leader),
                     key=lambda r: (busy[int(r["rank"])], r["rank"]))
        victim = int(killed["pid"])
        os.kill(victim, signal.SIGKILL)
        t_kill = time.time()
        print(f"  (a) 2 -> 3 requested with {len(waves[0]) - first_done} of {len(waves[0])} "
              f"requests unfinished; generation 1 formed at 3 (restore leader rank {leader}); SIGKILL rank {killed['rank']} (pid "
              f"{victim}, {busy[int(killed['rank'])]} requests admitted) with {done} of "
              f"{len(rids)} requests done")
        rows2 = gang.formed(2, 2)
        gang.router.wait_all(rids, timeout=EL_TIMEOUT_S)
        t_shrink = gang.resize(1)
        gang.wait_gone(rows2)
        rids += gang.submit(waves[2])
        gang.formed(3, 1)
        out = gang.finish(rids)
        run = gang.result.get("run")
        print(f"  (a) generations {gang.agent.restart_count + 1}, final width "
              f"{gang.agent.active_nproc}; the agent {run.state.value if run else None} after "
              f"{run.restarts if run else None} restarts")
        check(run is not None and run.state.value == "SUCCEEDED" and gang.agent.active_nproc == 1
              and gang.agent.restart_count == 3, "[elastic] the gang did not end at width 1")
        same = sum(out[r] == ref[r] for r in ref)
        print(f"  (a) {same} of {EL_REQUESTS} completions equal the uninterrupted engine's "
              f"token for token")
        check(out == ref, "[elastic] a gang's stream parts from the uninterrupted engine's")
        rows = el_logs(gang.log_dir)
        for (g, r), row in sorted(rows.items()):
            rec = row["recovery"] or {}
            print(f"  (a) gen {g} rank {r}: warm {row['warm_s']:.3f} s, restored "
                  f"{row['restored']}; recovery restores {rec.get('restores')}, requests_restored "
                  f"{rec.get('requests_restored')}, last_recovery_s "
                  f"{rec.get('last_recovery_s')}; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB")
        check(any((row["recovery"] or {}).get("requests_restored") for (g, _), row in rows.items()
                  if g >= 1), "[elastic] no generation restored sealed work")
        for gen, label, t in ((1, "2 -> 3", t_grow), (2, "kill -> 2", t_kill),
                              (3, "2 -> 1 (pre-warmed)", t_shrink)):
            got = el_stages(rows, gen, t)
            text = (f"{got[0]:.2f} s ({got[1]})" if got
                    else "not measured (no worker of it logged a token)")
            print(f"  (a) {label}: decision to first token {text}  [{card}]")
        warm = el_stages(rows, 3, t_shrink)
        check(warm is not None, "[elastic] the resize to 1 emitted no token")
        return warm
    finally:
        gang.close()


def el_cold_resize(card, traffic, ref, warm):
    """(b): the same resize, 2 -> 1 with the last wave, in a gang that does
    not pre-warm."""
    gang = ElasticGang("b", 2, 2, {})
    try:
        rows0 = gang.formed(0, 2)
        t_dec = gang.resize(1)
        gang.wait_gone(rows0)
        wave = traffic[-EL_WAVES[-1]:]
        rids = gang.submit(wave)
        gang.formed(1, 1)
        out = gang.finish(rids)
        check(out == {r: ref[r] for r in rids},
              "[elastic] the cold gang's streams part from the uninterrupted engine's")
        cold = el_stages(el_logs(gang.log_dir), 1, t_dec)
        check(cold is not None, "[elastic] the cold resize emitted no token")
        total, parts = cold
    finally:
        gang.close()
    print(f"  (b) 2 -> 1, cold: decision to first token {total:.2f} s ({parts})  [{card}]")
    print(f"  (b) 2 -> 1, pre-warmed: decision to first token {warm[0]:.2f} s ({warm[1]}); "
          f"the same {len(rids)} requests, equal tokens in both  [{card}]")


def el_replay(world, params, lo, hi, batch):
    """The trainer's steps lo..hi replayed here in driver mode at `world`
    (every rank's batch, rank-major), from `params` (None: the initial
    ones) with fresh momentum, under cuDNN's deterministic algorithms."""
    from pytorch_distributed_example_tpu_torch.examples import elastic as ex

    dev = torch.device(EL_DEVICE, 0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tdx.init_process_group(world_size=world, device=dev)
    try:
        model, p0 = ex.initial_params(dev)
        ddp = tdx.DistributedDataParallel(model, p0 if params is None else params)
        opt = optim.sgd(0.05, momentum=0.9)
        step = ddp.make_train_step(opt, ex.loss_fn)
        state = opt.init(ddp.params)
        xs, ys = zip(*(ex.rank_batch(r, batch, dev) for r in range(world)))
        x, y = torch.cat(xs), torch.cat(ys)
        out = ddp.params
        for _ in range(lo, hi):
            out, state, _ = step(out, state, x, y)
        return {n: p.clone() for n, p in out.items()}
    finally:
        tdx.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic


def el_trainer(card):
    """(c): `examples/elastic.py` at world 2 on cuda:0 over cuda:gloo, one
    worker killed after the first checkpoint; the run ends at world 1 at
    --steps; generation 0's checkpoint against a world-2 replay within
    EL_TRAIN_TOL, the final params bitwise a world-1 replay from it."""
    from pytorch_distributed_example_tpu_torch.elastic import LocalElasticAgent, WorkerSpec
    from pytorch_distributed_example_tpu_torch.examples import elastic as ex

    ckpt = os.path.join(EL_DIR, "train_ckpt")
    log_dir = os.path.join(EL_DIR, "logs_c")
    root = os.path.dirname(os.path.abspath(__file__))
    S, E, B = EL_TRAIN["steps"], EL_TRAIN["every"], EL_TRAIN["batch"]
    spec = WorkerSpec(
        entrypoint=["pytorch_distributed_example_tpu_torch.examples.elastic", "--steps", str(S),
                    "--ckpt-every", str(E), "--ckpt", ckpt, "--batch-size", str(B)],
        module=True, nproc_per_node=2, min_nproc=1, max_restarts=3, monitor_interval_s=0.05,
        env={"OMP_NUM_THREADS": "1",
             "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""), **EL_ENV})
    agent = LocalElasticAgent(spec, log_dir=log_dir)
    result = {}
    th = threading.Thread(target=lambda: result.update(run=agent.run()), daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        deadline = time.monotonic() + EL_TIMEOUT_S
        while not os.path.exists(os.path.join(ckpt, "meta.json")):
            check(time.monotonic() < deadline and th.is_alive(),
                  "[elastic] the trainer wrote no checkpoint")
            time.sleep(0.005)
        agent._workers[1].proc.kill()
        th.join(timeout=EL_TIMEOUT_S)
    finally:
        if th.is_alive():
            for w in list(agent._workers):
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
            th.join(timeout=30.0)
    run = result.get("run")
    resume = None
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            text = f.read()
        if name == "worker_0_attempt1.log":
            m = re.search(r"resuming at step (\d+)", text)
            resume = int(m.group(1)) if m else None
    meta = json.load(open(os.path.join(ckpt, "meta.json")))
    print(f"  (c) examples/elastic.py, ConvNet at world 2 x {B} on cuda:0 over cuda:gloo, "
          f"checkpoint every {E} of {S} steps: rank 1 killed after the first checkpoint; the "
          f"agent {run.state.value if run else None} after {run.restarts if run else None} "
          f"restarts at width {agent.active_nproc}; generation 1 resumed at step {resume}; the "
          f"final checkpoint at step {meta['step']} ({time.perf_counter() - t0:.1f} s)")
    if run is None or run.state.value != "SUCCEEDED":
        el_log_tail(log_dir)
    check(run is not None and run.state.value == "SUCCEEDED" and run.restarts >= 1
          and agent.active_nproc == 1 and meta["step"] == S and resume is not None,
          "[elastic] the trainer did not finish at world 1")
    from pytorch_distributed_example_tpu_torch.checkpoint import last_good_path

    w2 = el_replay(2, None, 0, resume, B)
    mid, _, mid_step, _ = load_checkpoint(last_good_path(ckpt), w2)
    err2 = max(float((mid[n] - w2[n]).abs().max()) for n in w2)
    close2 = all(torch.allclose(mid[n], w2[n], **EL_TRAIN_TOL) for n in w2)
    w1 = el_replay(1, mid, resume, S, B)
    final, _, _, _ = load_checkpoint(ckpt, w1)
    err1 = max(float((final[n] - w1[n]).abs().max()) for n in w1)
    bitwise1 = all(torch.equal(final[n], w1[n]) for n in w1)
    print(f"  (c) generation 0's checkpoint at step {mid_step} against the world-2 replay: max "
          f"|diff| {err2:.3e} (rtol {EL_TRAIN_TOL['rtol']}, atol {EL_TRAIN_TOL['atol']}: "
          f"{close2}); the final params against the world-1 replay from it: max |diff| "
          f"{err1:.3e}, bitwise {bitwise1}  [{card}]")
    check(mid_step == resume and close2, "[elastic] world 2 strays from its replay")
    check(bitwise1, "[elastic] world 1 is not bitwise its replay")


def elastic_phase(card):
    """The elastic agent on the card: (a) the CFG_1B serving gang resized
    2 -> 3 -> 1 under a SIGKILL, token for token the uninterrupted engine;
    (b) pre-warm: the warm pass leaves a live engine bitwise unchanged, and
    a fresh worker's decision to first token, cold and pre-warmed; (c) the
    elastic trainer killed to world 1 against its replay; (d) the debug
    frontend of a serving worker. Returns this process's flash launches
    (the workers run no flash kernel: dense decode, the ConvNet)."""
    shutil.rmtree(EL_DIR, ignore_errors=True)
    os.makedirs(EL_DIR)
    fa.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        traffic, ref = el_reference(card)
        print(f"  reference and warm-pass check in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        warm = el_serve_gang(card, traffic, ref)
        print(f"  serving gang in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        el_cold_resize(card, traffic, ref, warm)
        print(f"  cold resize in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        el_trainer(card)
        print(f"  trainer in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(EL_DIR, ignore_errors=True)
    launches = dict(fa.ROUTE_LAUNCHES)
    check(sum(launches.values()) == 0, "[elastic] a flash kernel launched")
    print(f"  flash launches in [elastic]: {dict(fa.LAUNCHES)}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--worker"]:  # one rank of a [multiproc] gang
        return mp_worker(sys.argv[2:])

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
        if "wgmma" in name or "tf32x3" in name:
            D = int(name.rsplit("D ", 1)[1].rstrip(">"))
            role = ("fwd", "dkdv", "dq").index(name.split("_")[1])
            smem_bytes = (lib.flash_wgmma_smem_bytes if "wgmma" in name
                          else lib.flash_tf32x3_smem_bytes)(role, D)
            smem = f"; {smem_bytes} bytes of dynamic shared memory"
            check(spills.startswith("0 bytes stack frame, 0 bytes spill stores"),
                  f"ptxas: {name} spills: {spills}")
            check(0 < smem_bytes <= SMEM_PER_BLOCK,
                  f"{name} asks for {smem_bytes} bytes of shared memory")
        print(f"  ptxas: {name}: {regs}; {spills}{smem}")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    print("[kernels]")
    results = {}
    BH, L, D = 4 * 16, 1024, 128
    results["resident"] = kernel_checks(BH, L, D, causal=True, timed=True)
    kernel_checks(BH, L, D, causal=False, timed=False)
    kernel_checks(BH, L, 64, causal=True, timed=False)
    # bf16 D 64 at the MFU step's shapes ([bench]: B 8 x 8 heads, L 512)
    results["resident D 64"] = kernel_checks(64, 512, 64, causal=True, timed=True, B=8,
                                             want_route="wgmma")
    # the other bf16 instances at the same work (B*H*D 8192): the trainer's
    # default head dim and the largest
    for D_ in HEADDIMS:
        results[f"resident D {D_}"] = kernel_checks(BH * D // D_, L, D_, causal=True, timed=True,
                                                    want_route="wgmma")
    # float32, the tf32x3 forward, dK/dV and dQ: CFG_1B's shape,
    # the trainer's head dim and the other two instances
    for D_ in (D, 32, 64, 256):
        results[f"float32 D {D_}"] = kernel_checks(BH * D // D_, L, D_, causal=True, timed=True,
                                                   dtype=torch.float32, want_route=F32_ROUTES)
    print(f"  kernels in {time.perf_counter() - t0:.1f} s")

    # 4. the same in the reference's streamed regime, and the new head dims
    t0 = time.perf_counter()
    print("[kernels-long]")
    results["streamed"] = kernel_checks(16, 16384, 128, causal=True, timed=True, B=1,
                                        iters=3, plain_once=True)
    fwd_f32_out_check(16, 16384, 128, causal=False)
    for D_ in HEADDIMS:
        for L_ in (512, 1024):
            for causal in (True, False):
                kernel_checks(8, L_, D_, causal=causal, timed=False, want_route="wgmma")
    kernel_checks(8, 512, 96, causal=True, timed=False, want_route="wgmma")  # padded to 128
    for D_ in fa.HEAD_DIMS:  # float32: every tf32x3 instance, causal and full
        for causal in (True, False):
            kernel_checks(8, 512, D_, causal=causal, timed=False, dtype=torch.float32,
                          want_route=F32_ROUTES)
            f32_large_logit_check(D_, causal)
    torch.cuda.empty_cache()
    print(f"  kernels-long in {time.perf_counter() - t0:.1f} s")

    # 5. small-input reference
    t0 = time.perf_counter()
    print("[reference]")
    phase_launches = {"reference": reference_check()}
    print(f"  reference in {time.perf_counter() - t0:.1f} s")

    # 6. the slice: the ~1B train step
    t0 = time.perf_counter()
    print("[slice]")
    phase_launches["slice"] = train_phase(SLICE_ARGV, WARMUP_STEPS, TIMED_STEPS, card)
    print(f"  slice in {time.perf_counter() - t0:.1f} s")

    # 6b. the trainer at head dims 32 and 256
    t0 = time.perf_counter()
    print("[headdims]")
    phase_launches.update(headdims_phase(card))
    print(f"  headdims in {time.perf_counter() - t0:.1f} s")

    # 6c. the trainer's float32 defaults: the float32 routes at head dim 32
    t0 = time.perf_counter()
    print("[float32]")
    phase_launches["float32"] = float32_phase(card)
    print(f"  float32 in {time.perf_counter() - t0:.1f} s")

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

    # 10b. the entry point: bench.py's one-line report, its MFU phase on D 64
    t0 = time.perf_counter()
    print("[bench]")
    phase_launches["bench"] = bench_phase(card, kind)
    print(f"  bench in {time.perf_counter() - t0:.1f} s")

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

    # 17. checkpoints: rank-0 resume of CFG_1B, DCP of the fsdp x tp state
    t0 = time.perf_counter()
    print("[ckpt]")
    phase_launches["ckpt"] = ckpt_phase(card)
    print(f"  ckpt in {time.perf_counter() - t0:.1f} s")

    # 18. AMP, post-local SGD, Join, the quantized hook through the Reducer
    t0 = time.perf_counter()
    print("[train_utils]")
    phase_launches["train_utils"] = train_utils_phase(card)
    print(f"  train_utils in {time.perf_counter() - t0:.1f} s")

    # 19. the training parallelisms in multiproc mode: process gangs on cuda:0
    t0 = time.perf_counter()
    print("[multiproc]")
    phase_launches.update(multiproc_phase(card))
    print(f"  multiproc in {time.perf_counter() - t0:.1f} s")

    # 20. the collective planner and the p2p plane
    t0 = time.perf_counter()
    print("[planner]")
    phase_launches["planner"] = planner_phase(card)
    print(f"  planner in {time.perf_counter() - t0:.1f} s")

    # 21. the elastic agent: the serving gang resized, pre-warm, the trainer
    t0 = time.perf_counter()
    print("[elastic]")
    phase_launches["elastic"] = elastic_phase(card)
    print(f"  elastic in {time.perf_counter() - t0:.1f} s")

    # 22. report
    kernels = []
    for name, lowerings in REPLACES.items():
        for regime, replaces in lowerings.items():
            design = results[regime][name]["design"]
            by_phase = {ph: phase_launches[ph].get(f"{name}:{design}", 0)
                        for ph in PHASES[regime] + ("serve_fleet", "cifar", "bert",
                                                    "train_utils", "elastic")}
            kernels.append({"name": name, "route": "cuda",
                            "source": SOURCES[design],
                            "replaces": replaces, "regime": regime, "head_dim": 128,
                            "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                            **results[regime][name]})
        # the same kernel's other bf16 instances, launched by [headdims]
        for D_ in HEADDIMS:
            n = phase_launches[f"headdims D {D_}"][f"{name}:wgmma"]
            kernels.append({"name": name, "route": "cuda", "source": SOURCES["wgmma"],
                            "replaces": lowerings["resident"], "regime": "resident",
                            "head_dim": D_, "launches": n, "launches_by_phase": {"headdims": n},
                            **results[f"resident D {D_}"][name]})
        # its bf16 D 64 instance, launched by [bench]'s MFU phase
        n = phase_launches["bench"][f"{name}:wgmma"]
        kernels.append({"name": name, "route": "cuda", "source": SOURCES["wgmma"],
                        "replaces": lowerings["resident"], "regime": "resident",
                        "head_dim": 64, "launches": n, "launches_by_phase": {"bench": n},
                        **results["resident D 64"][name]})
        # its float32 instances: D 128 launched by [reference], D 32 by [float32]
        for D_, phase in ((128, "reference"), (32, "float32")):
            design = F32_ROUTES[name]
            n = phase_launches[phase][f"{name}:{design}"]
            kernels.append({"name": name, "route": "cuda",
                            "source": SOURCES[design], "replaces": lowerings["resident"],
                            "regime": "resident", "head_dim": D_, "dtype": "float32",
                            "launches": n, "launches_by_phase": {phase: n},
                            **results[f"float32 D {D_}"][name]})
    print(f"[done] in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
