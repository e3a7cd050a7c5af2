"""TransformerLM training: the port of the reference's `examples/lm/main.py`
and of `bench.py`'s MFU step.

Run:  python -m pytorch_distributed_example_tpu_torch.examples.lm --steps 50
      python -m pytorch_distributed_example_tpu_torch.examples.lm \\
          --vocab-size 32000 --d-model 2048 --n-layers 16 --n-heads 16 \\
          --seq 1024 --batch-size 4 --bf16 --steps 10
      (the same width with --seq 16384 --batch-size 1 is the long-context
      step, in the reference's streamed flash regime)

A causal LM on the reference's Markov synthetic token stream (numpy seed
0). One step is the forward, cross-entropy of logits[:, :-1] against
tokens[:, 1:] (mean), the backward, and AdamW with optax.adamw's defaults.
It runs on cuda:0 and raises when there is no card; `--cpu` runs it on the
CPU with the kernels' plain versions.

As the reference's trainer it trains over an ("fsdp", "tp") mesh with
fsdp = W // tp: `fully_shard` by `transformer_sharding_rules("tp",
"fsdp")`, the batch split over fsdp, AdamW on the shards. W is the number
of ranks in driver mode, all of them on the one device: the
TDX_EXAMPLES_CPU_DEVICES variable (default 2), the count the reference
forces its host devices to under --cpu; here it is read on the card as
well. At W = 1 the step is the single-card one. `shard` also runs in a
multiproc gang (one process a rank), as `chip_smoke.py`'s `[multiproc]`
phase drives it. `--n-experts` switches
every MLP to the MoE.
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import distributed as dist
from ..mesh import DeviceMesh, init_device_mesh
from ..models import TransformerConfig, TransformerLM, transformer_sharding_rules
from ..parallel.fsdp import FSDPModule, fully_shard
from ..utils import spans


def batches(data: np.ndarray, batch: int, seq: int, seed: int):
    gen = np.random.default_rng(seed)
    while True:
        starts = gen.integers(0, len(data) - seq - 1, batch)
        yield np.stack([data[s : s + seq] for s in starts]).astype(np.int32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-kv-heads", type=int, default=None,
                    help="fewer than --n-heads is grouped-query attention")
    ap.add_argument("--n-experts", type=int, default=0,
                    help="> 0: every MLP is a top-1 MoE of this many experts")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks; the rest of the W ranks are fsdp")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def world_size() -> int:
    """The driver-mode rank count W: TDX_EXAMPLES_CPU_DEVICES, default 2."""
    return int(os.environ.get("TDX_EXAMPLES_CPU_DEVICES", "2"))


def device_for(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to train on the CPU")
    return torch.device("cuda", 0)


def config_for(args) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_experts=args.n_experts,
        max_seq_len=args.seq,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        use_flash=not args.no_flash,
        remat=args.remat,
    )


def loss_fn(logits, tokens):
    """Mean next-token cross-entropy, as optax's integer-label form (the
    span recorder's `loss` region)."""
    return spans.region("loss", _cross_entropy, logits, tokens)


def _cross_entropy(logits, tokens):
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V), tokens[:, 1:].reshape(-1))


def adamw(lr: float):
    """optax.adamw's defaults (torch's own weight decay default is 1e-2), as
    a callable taking the parameters."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_optimizer(model, lr: float) -> torch.optim.AdamW:
    return adamw(lr)(model.parameters())


def train_step(model, opt, tokens) -> torch.Tensor:
    """One step; returns the loss (on the model's device, not synchronised).
    `model` is a TransformerLM, or the FSDPModule of `build` at W > 1.

    The span recorder (`utils/spans.py`) sees the step as the phase `step`;
    on one card it holds `forward` (model and loss), `backward` and
    `optimizer` (zero_grad, then the update)."""
    dev = tokens.device
    with spans.phase("step", dev):
        if isinstance(model, FSDPModule):
            _, _, loss = model.step(model.params, opt, tokens, tokens)
            return loss
        with spans.phase("optimizer", dev):
            opt.zero_grad(set_to_none=True)
        with spans.phase("forward", dev):
            loss = loss_fn(model(tokens), tokens)
        with spans.phase("backward", dev):
            loss.backward()
        with spans.phase("optimizer", dev):
            opt.step()
    return loss.detach()


def shard(model, lr: float, world: int, tp: int) -> FSDPModule:
    """`model` fully sharded over an ("fsdp", "tp") mesh of `world` ranks on
    its device, as the reference's trainer wraps it, with its train step
    as `.step` (AdamW). The model's own copy of the weights moves to the
    meta device: the shards are the weights from here on. In a multiproc
    gang of `world` processes the mesh is the gang's (`init_device_mesh`):
    each process keeps its own shards and takes its data rank's rows."""
    if world % tp:
        raise ValueError(f"--tp {tp} does not divide the {world} ranks")
    device = next(model.parameters()).device
    if dist.is_initialized() and dist._world.mode == "multiproc":
        mesh = init_device_mesh(("fsdp", "tp"), (world // tp, tp))  # one rank a process
    else:
        mesh = DeviceMesh([device] * world, (world // tp, tp), ("fsdp", "tp"))
    mod = fully_shard(model, None, mesh, axis="fsdp",
                      rules=transformer_sharding_rules("tp", "fsdp"), data_axes=("fsdp",))
    model.to("meta")
    mod.step = mod.make_train_step(adamw(lr), loss_fn)
    return mod


def build(args, world=None):
    """(model, optimizer, next_tokens) for parsed `args` over `world` ranks
    (default `world_size()`); `next_tokens()` draws the next (batch, seq)
    int64 global batch onto the model's device. At world 1 the model is a
    TransformerLM and the optimizer torch's AdamW; above, the FSDPModule
    of `shard` and its optimizer state."""
    world = world_size() if world is None else world
    if world == 1 and args.tp != 1:
        raise ValueError(f"--tp {args.tp} needs that many ranks (TDX_EXAMPLES_CPU_DEVICES)")
    device = device_for(args)
    gen = np.random.default_rng(0)
    # Markovian synthetic stream so the LM has learnable structure
    data = np.cumsum(gen.integers(1, 7, 200_000)) % args.vocab_size
    # init seed 0, as the reference's PRNGKey(0); the bits differ
    init_gen = torch.Generator(device=device).manual_seed(0)
    model = TransformerLM(config_for(args), device=device, generator=init_gen)
    if world == 1:
        opt = make_optimizer(model, args.lr)
    else:
        model = shard(model, args.lr, world, args.tp)
        opt = model.step.init_opt_state(model.params)
    it = batches(data, args.batch_size, args.seq + 1, 1)
    next(it)  # the reference draws its init batch from the stream first

    def next_tokens():
        return torch.from_numpy(next(it)[:, : args.seq]).to(device, torch.int64)

    return model, opt, next_tokens


def main(argv=None) -> list:
    """Train for --steps steps; returns the per-step losses."""
    args = parse_args(argv)
    model, opt, next_tokens = build(args)
    if isinstance(model, FSDPModule):
        device = model.mesh.device
        n_params = sum(math.prod(p.shape) for p in model.params.values())
        print(f"devices={model.mesh.size} (driver mode on {device}) "
              f"mesh=fsdp{model.mesh.shape[0]}xtp{model.mesh.shape[1]}")
    else:
        device = next(model.parameters()).device
        n_params = sum(p.numel() for p in model.parameters())
    print(f"device={device} params={n_params / 1e6:.1f}M  starting {args.steps} steps")
    losses = []
    t0 = time.perf_counter()
    for i in range(1, args.steps + 1):
        losses.append(train_step(model, opt, next_tokens()))
        if i % args.log_every == 0 or i == args.steps:
            loss = float(losses[-1])  # waits for the device
            dt = time.perf_counter() - t0
            tok_s = i * args.batch_size * args.seq / dt
            print(f"step {i}/{args.steps}  loss {loss:.4f}  {tok_s:.0f} tok/s on {device}")
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
