"""The serve engine's programs, the port of the reference's
`serve/decode.py` (:52-283), as plain functions over tensors.

All mutable serving state, the cache tree and the per-slot (lengths,
last token, rng key) lanes, lives on the model's device and is updated in
place, where the reference donates it through each jitted program; the
only host traffic of a decode step is the (S,) next-token readback the
scheduler needs and the small (S, nb) block-table copy up. The model
carries its weights, so the programs take no `params`.

* `slot_programs(model, temperature, top_k)` -> (prefill, write_slot,
  step) over the dense slot cache.
* `paged_programs(model, temperature, top_k, forward=None)` ->
  (prefill_chunk, first_token, attach, step) over the paged pool
  (`serve/cache.py`); `forward` stands in for the model's own decode
  path (the engine's tensor-parallel decoder over a sharded pool).

Each request's stream is built from its seed as the reference's: key =
PRNGKey(seed); key, sub = split(key); the first token samples with sub
and the key rides in the slot's lane, split again on every step (as the
reference splits every lane every step, greedy or not).

Under `TDX_PROGLINT=1` each program is wrapped by the program plane's
register-on-first-call seam (`tools/proglint.py`), as the reference's
(:66-81): `serve.slot.*` and `serve.paged.*`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import prng
from ..models.generate import init_cache, model_device, sample_logits
from .cache import land_slot

__all__ = ["slot_programs", "paged_programs", "sync_slot_lanes", "carry_key"]


def carry_key(seed: int, device=None) -> torch.Tensor:
    """The carry key left in a slot's lane after its first token, a pure
    function of the seed: split(PRNGKey(seed))[0]."""
    return prng.split(prng.PRNGKey(seed, device))[0]


_DECODE_PATH = "pytorch_distributed_example_tpu_torch/serve/decode.py"


def _register_programs(family: str, **programs):
    """TDX_PROGLINT=1 register-on-first-call seam: wrap each serve program
    so its first call fingerprints the collectives it issues and (in a
    multiproc gang) agrees them across ranks before they dispatch
    (`tools/proglint.py`). Off by default: one env read per build,
    nothing per step."""
    if os.environ.get("TDX_PROGLINT", "0") != "1":
        return tuple(programs.values())
    from ..tools import proglint

    return tuple(
        proglint.instrument(f"serve.{family}.{key}", fn, path=_DECODE_PATH)
        for key, fn in programs.items()
    )


def sync_slot_lanes(lengths, tokens, rngs):
    """Step-boundary quiesce, the drain seam: wait until the device has
    finished everything queued before the lanes' last update (the pool
    writes included). Returns the lanes."""
    if lengths.is_cuda:
        torch.cuda.synchronize(lengths.device)
    return lengths, tokens, rngs


def _index(n: int, size: int) -> int:
    """`lax.dynamic_index_in_dim`'s clamped index."""
    return min(max(int(n), 0), size - 1)


def _first(logits_row, seed: int, temperature, top_k):
    """Sample a request's first token from its prompt-end logits row and
    return (first (), carry key (2,))."""
    key, sub = prng.split(prng.PRNGKey(seed, logits_row.device))
    first = sample_logits(logits_row[None], sub, temperature, top_k)[0]
    return first, key


def _step_rows(model, tokens, lengths, rngs, temperature, top_k, forward=None, **kw):
    """Advance every lane one token: per-lane key split, the decode path at
    per-row positions (`forward`, else the model's own), per-row
    sampling; lengths clamp at M - 1, where a parked lane stays."""
    split = prng.split(rngs)  # (S, 2, 2)
    subs, new_rngs = split[:, 0], split[:, 1]
    logits = (forward or model)(tokens[:, None].long(), decode=True, positions=lengths, **kw)
    nxt = sample_logits(logits[:, -1], subs, temperature, top_k)
    lengths = torch.clamp(lengths + 1, max=model.cfg.max_seq_len - 1)
    return lengths, nxt, new_rngs


def slot_programs(model, temperature: float, top_k: Optional[int]):
    """(prefill, write_slot, step) for the dense slot cache.

    * ``prefill(prompt (1, Lb), length, seed)`` -> (B=1 cache, first_logits
      (V,), first_token, carry_key): the logits row at the true prompt end.
    * ``write_slot(tree, lengths, tokens, rngs, pre, slot, length, first,
      key)`` lands the prefill into `slot` and sets its lanes, in place.
    * ``step(cache, lengths, tokens, rngs)`` -> (cache, lengths',
      next_tokens (S,), rngs')."""

    @torch.no_grad()
    def prefill(prompt, length, seed):
        cache = init_cache(model, 1)
        prompt = torch.as_tensor(prompt, device=model_device(model))
        logits = model(prompt.long(), decode=True, cache=cache)
        first_logits = logits[0, _index(length - 1, logits.shape[1])]
        first, key = _first(first_logits, seed, temperature, top_k)
        return cache, first_logits, first, key

    @torch.no_grad()
    def write_slot(tree, lengths, tokens, rngs, pre, slot, length, first, key):
        land_slot(tree, pre, slot)
        lengths[slot] = length
        tokens[slot] = first
        rngs[slot] = key
        return tree, lengths, tokens, rngs

    @torch.no_grad()
    def step(cache, lengths, tokens, rngs):
        lengths, nxt, rngs = _step_rows(model, tokens, lengths, rngs, temperature, top_k,
                                        cache=cache)
        return cache, lengths, nxt, rngs

    return _register_programs("slot", prefill=prefill, write_slot=write_slot, step=step)


def paged_programs(model, temperature: float, top_k: Optional[int], forward=None):
    """(prefill_chunk, first_token, attach, step) for the paged pool; the
    decode path is `forward` when given (same call as the model's), else
    the model.

    * ``prefill_chunk(tree, chunk (1, C), bt_row (1, nb), start)`` -> (tree,
      logits (C, V)): one prompt chunk at absolute offset `start` (nonzero
      for later chunks and after a prefix-cache attach).
    * ``first_token(chunk_logits, end, seed)`` -> (first, carry key): the
      sample at row `end` of the final chunk.
    * ``attach(lengths, tokens, rngs, slot, length, first, key)`` sets a
      finished prefill's lanes, in place.
    * ``step(tree, lengths, tokens, rngs, bt)`` -> (tree, lengths',
      next_tokens (S,), rngs'): every lane one token; parked lanes have
      all-invalid table rows, so their writes land in the sink."""
    dev = model_device(model)
    fwd = forward or model

    @torch.no_grad()
    def prefill_chunk(tree, chunk, bt_row, start):
        chunk = torch.as_tensor(chunk, device=dev)
        logits = fwd(chunk.long(), decode=True,
                       positions=torch.tensor([start], dtype=torch.int32, device=dev),
                       block_tables=torch.as_tensor(bt_row, device=dev), cache=tree)
        return tree, logits[0]

    @torch.no_grad()
    def first_token(chunk_logits, end, seed):
        return _first(chunk_logits[_index(end, chunk_logits.shape[0])], seed, temperature,
                      top_k)

    @torch.no_grad()
    def attach(lengths, tokens, rngs, slot, length, first, key):
        lengths[slot] = length
        tokens[slot] = torch.as_tensor(first, device=dev)
        rngs[slot] = key
        return lengths, tokens, rngs

    @torch.no_grad()
    def step(tree, lengths, tokens, rngs, bt):
        lengths, nxt, rngs = _step_rows(model, tokens, lengths, rngs, temperature, top_k,
                                        forward=forward,
                                        block_tables=torch.as_tensor(bt, device=dev),
                                        cache=tree)
        return tree, lengths, nxt, rngs

    return _register_programs("paged", prefill_chunk=prefill_chunk, first_token=first_token,
                              attach=attach, step=step)
