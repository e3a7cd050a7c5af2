"""Autoregressive generation with the KV-cache decode path: the port of the
reference's `examples/generate/main.py`.

Train-then-sample demo: fit a small TransformerLM on a repeating token
pattern (or the bytes of --data), then generate a continuation with the
prefill + decode loop of `models/generate.py`: greedy, or temperature and
top-k sampling, with an optional EOS stop, and the decode rate.

Run:  python -m pytorch_distributed_example_tpu_torch.examples.generate --steps 200 --new 48
      python -m pytorch_distributed_example_tpu_torch.examples.generate --temperature 0.8 --top-k 20

It runs on cuda:0 and raises when there is no card; `--cpu` runs it on the
CPU. The weights are drawn from torch's generator at --seed and the
training windows from numpy at --seed, so the run is not the reference's
draw for draw.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .. import prng
from ..models import TransformerConfig, TransformerLM, generate
from .lm import adamw, loss_fn


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200, help="train steps")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=32, help="tokens to generate")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--eos-id", type=int, default=None, help="stop a row at this token")
    ap.add_argument("--data", type=str, default=None, help="text file (bytes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device; pass --cpu to run on the CPU")

    if args.data:
        data = np.frombuffer(Path(args.data).read_bytes(), dtype=np.uint8).astype(np.int64)
        vocab = 256
        need = max(args.seq + 2, args.prompt_len + args.new + 1)
        if len(data) < need:
            raise SystemExit(f"--data has {len(data)} bytes; need >= {need} for --seq "
                             f"{args.seq} / --prompt-len {args.prompt_len} --new {args.new}")
    else:
        # a periodic pattern the model can nail, so the demo is legible
        base = np.arange(16, dtype=np.int64)
        data = np.tile(np.concatenate([base, base[::-1]]), 512)
        vocab = 32

    cfg = TransformerConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=4,
                            max_seq_len=args.prompt_len + args.new,
                            use_flash=False)
    model = TransformerLM(cfg, device=device,
                          generator=torch.Generator(device).manual_seed(args.seed))
    opt = adamw(3e-3)(model.parameters())
    gen = np.random.default_rng(args.seed)
    loss = float("nan")
    for i in range(args.steps):
        starts = gen.integers(0, len(data) - args.seq - 1, args.batch)
        toks = torch.as_tensor(np.stack([data[s:s + args.seq] for s in starts]), device=device)
        opt.zero_grad(set_to_none=True)
        step_loss = loss_fn(model(toks), toks)
        step_loss.backward()
        opt.step()
        if i % 50 == 0 or i == args.steps - 1:
            loss = float(step_loss.detach())
            print(f"step {i}: loss {loss:.4f}")

    # leave room for the whole ground-truth continuation after the prompt
    s = int(gen.integers(0, len(data) - args.prompt_len - args.new))
    prompt = torch.as_tensor(data[s:s + args.prompt_len], device=device)[None]
    model.eval()
    t0 = time.perf_counter()
    out = generate(model, prompt, args.new, temperature=args.temperature, top_k=args.top_k,
                   rng=prng.PRNGKey(args.seed + 1, device), eos_id=args.eos_id)
    cont = out[0].cpu().numpy()  # the one readback of the loop
    dt = time.perf_counter() - t0

    truth = data[s + args.prompt_len:s + args.prompt_len + args.new]
    acc = float((cont == truth[:len(cont)]).mean()) if not args.data else None
    print("prompt:     ", prompt[0].tolist())
    print("generated:  ", cont.tolist())
    print(f"{args.new} tokens in {dt * 1e3:.0f} ms ({args.new / dt:.1f} tok/s)")
    if acc is not None:
        print(f"pattern accuracy: {acc:.0%}")
    return {"loss": loss, "tokens": cont.tolist(), "accuracy": acc, "tok_s": args.new / dt}


if __name__ == "__main__":
    main()
