"""jax's legacy threefry PRNG in torch integer ops, bit for bit.

The reference's sampling streams are jax keys: `generate()` and the serve
engine draw every sampled token from `jax.random.PRNGKey(seed)`, `split`
and `categorical` under `jax_threefry_partitionable=False` (the legacy
stream the repo pins). This module computes the same streams, so a
sampled request gives the same tokens in both packages and a carry key
(`serve.decode.carry_key`) means the same thing in each.

Keys are `(..., 2)` int64 tensors holding uint32 values: a leading batch
of keys is a batch of independent streams (the serve engine's per-slot
lanes). Arithmetic runs in int64 masked to 32 bits, since torch's uint32
has few kernels on the card. Read off jax 0.9.0: `threefry_2x32`,
`_threefry_split_original` and `_threefry_random_bits_original` in
`jax/_src/prng.py`; `_uniform`, `_gumbel` (mode "low") and `_categorical`
in `jax/_src/random.py`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["PRNGKey", "threefry_2x32", "split", "random_bits", "uniform", "gumbel",
           "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` without x64: the high word is 0 and the
    low word the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def _hash(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 operands."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """jax's `threefry_2x32(keypair, count)` for a flat count vector:
    (..., 2) keys and (n,) counts -> (..., n) bits. The counts are split
    in halves (an odd count padded with a zero), hashed pairwise, and the
    two halves of the output concatenated."""
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    x0, x1 = count.reshape(2, -1)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    y0, y1 = _hash(k1, k2, x0, x1)
    return torch.cat([y0, y1], dim=-1)[..., :n]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (legacy): (..., 2) -> (..., num, 2)."""
    bits = threefry_2x32(key, torch.arange(2 * num, dtype=torch.int64, device=key.device))
    return bits.reshape(*key.shape[:-1], num, 2)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (legacy): (..., 2) -> (..., *shape)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= _MASK:
        raise ValueError(f"{size} draws from one key; jax splits past 2**32 - 1")
    bits = threefry_2x32(key, torch.arange(size, dtype=torch.int64, device=key.device))
    return bits.reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform draws in [minval, maxval): the top 23 bits become
    the mantissa of a float in [1, 2), less 1, then scaled. XLA fuses the
    scale and shift into one fused multiply-add (one rounding); the
    product of two float32s is exact in float64, so computing there and
    rounding once gives the same bits."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 Gumbel draws, jax's "low" mode."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)` for float32 logits:
    argmax of logits plus Gumbel noise of the logits' shape. With a batch
    of keys, (S, 2) against (S, V) logits, each row draws from its own
    key, as `vmap` over the rows does in the reference."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(f"keys {tuple(key.shape)} do not batch logits "
                             f"{tuple(logits.shape)}")
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
