"""Autoregressive generation over the KV-cache decode path, the port of the
reference's `models/generate.py`.

One prefill (the whole prompt through the cache path), then a decode loop
of single tokens. Sampling, cache updates and EOS bookkeeping stay on the
model's device: nothing is read back per token, and the (B,
max_new_tokens) result is read once by the caller. The cache is (B,
max_seq_len) from the start and the output always (B, max_new_tokens),
EOS-padded, as the reference's static shapes.

Sampling: greedy (temperature 0), temperature softmax, optional top-k, on
the reference's key discipline (`prng.py`, jax's legacy threefry), so a
sampled stream gives the same tokens as the reference's on the same seed.
The model carries its weights: where the reference takes `(model, params,
...)`, the port takes `(model, ...)`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng

__all__ = ["sample_logits", "init_cache", "generate", "model_device"]


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def sample_logits(logits, rng, temperature: float, top_k: Optional[int]):
    """Greedy at temperature 0, else temperature softmax with optional
    top-k truncation; `logits` (..., vocab) float32. One key (2,) samples
    the whole batch as the reference's; a (B, 2) batch of keys samples
    each row from its own, as the reference's `vmap` over the slot rows."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        k = min(top_k, logits.shape[-1])  # clamp to the vocab, as the reference
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    return prng.categorical(rng, logits).to(torch.int32)


def init_cache(model, batch_size: int):
    """An empty dense KV cache for `model` on its device: per layer (B,
    max_seq_len, kv_heads, head_dim) K and V in `cfg.dtype` and the 0-d
    int32 `index`, keyed as the reference's cache tree."""
    cfg = model.cfg
    dev = model_device(model)
    shape = (batch_size, cfg.max_seq_len, cfg.kv_heads, cfg.head_dim)

    def one_layer():
        return {"attn": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                         "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                         "index": torch.zeros((), dtype=torch.int32, device=dev)}}

    return {f"layers_{i}": one_layer() for i in range(cfg.n_layers)}


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, rng=None, eos_id: Optional[int] = None):
    """`max_new_tokens` continuations of `prompt` (B, L_p) -> (B,
    max_new_tokens) int32 on the model's device. With `eos_id` a row
    freezes at EOS (the positions after it hold eos_id); the loop still
    runs its full length. `rng` is a (2,) key (`prng.PRNGKey`), key 0 by
    default."""
    cfg = model.cfg
    dev = model_device(model)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, L_p = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if L_p + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt ({L_p}) + max_new_tokens ({max_new_tokens}) exceeds "
                         f"max_seq_len ({cfg.max_seq_len})")
    rng = prng.PRNGKey(0, dev) if rng is None else torch.as_tensor(rng, device=dev).long()

    cache = init_cache(model, B)
    logits = model(prompt, decode=True, cache=cache)
    rng, sub = prng.split(rng)
    tok = sample_logits(logits[:, -1], sub, temperature, top_k)
    out = [tok]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_new_tokens - 1):
        logits = model(tok[:, None].long(), decode=True, cache=cache)
        rng, sub = prng.split(rng)
        nxt = sample_logits(logits[:, -1], sub, temperature, top_k)
        if eos_id is not None:
            done = done | (tok == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)
