"""TransformerLM training on one card: the port of the reference's
`examples/lm/main.py` (its single-chip path) and of `bench.py`'s MFU step.

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
CPU with the kernels' plain versions. `--tp` and `--n-experts` are refused:
the mesh/FSDP wrap is the identity on one card, and sharded training is a
later part of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import TransformerConfig, TransformerLM


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
    ap.add_argument("--n-experts", type=int, default=0, help="refused: not ported")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=1, help="refused above 1: not ported")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.error("--tp is not ported yet (ROADMAP.md, Queue 1, 'Sharded training')")
    if args.n_experts:
        ap.error("--n-experts is not ported yet (ROADMAP.md, Queue 1, 'Sharded training')")
    return args


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
        max_seq_len=args.seq,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        use_flash=not args.no_flash,
        remat=args.remat,
    )


def loss_fn(logits, tokens):
    """Mean next-token cross-entropy, as optax's integer-label form."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V), tokens[:, 1:].reshape(-1))


def make_optimizer(model, lr: float) -> torch.optim.AdamW:
    # optax.adamw's defaults; torch's own weight decay default is 1e-2
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_step(model, opt, tokens) -> torch.Tensor:
    """One step; returns the loss (on the model's device, not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model(tokens), tokens)
    loss.backward()
    opt.step()
    return loss.detach()


def build(args):
    """(model, optimizer, next_tokens) for parsed `args`; `next_tokens()`
    draws the next (batch, seq) int64 batch onto the model's device."""
    device = device_for(args)
    gen = np.random.default_rng(0)
    # Markovian synthetic stream so the LM has learnable structure
    data = np.cumsum(gen.integers(1, 7, 200_000)) % args.vocab_size
    # init seed 0, as the reference's PRNGKey(0); the bits differ
    init_gen = torch.Generator(device=device).manual_seed(0)
    model = TransformerLM(config_for(args), device=device, generator=init_gen)
    opt = make_optimizer(model, args.lr)
    it = batches(data, args.batch_size, args.seq + 1, 1)
    next(it)  # the reference draws its init batch from the stream first

    def next_tokens():
        return torch.from_numpy(next(it)[:, : args.seq]).to(device, torch.int64)

    return model, opt, next_tokens


def main(argv=None) -> list:
    """Train for --steps steps; returns the per-step losses."""
    args = parse_args(argv)
    model, opt, next_tokens = build(args)
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
