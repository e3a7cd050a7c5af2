"""Prefill shape bucketing — bound the compile count under live traffic.

A copy of the reference's `serve/bucketing.py`. The port compiles no
program per shape; it keeps the buckets so that the engine computes on the
reference's shapes (and cuBLAS, which picks its algorithm by shape, sees a
bounded set of them).

Every distinct prompt shape jit-compiles its own prefill program; a
serving process fed arbitrary prompt lengths would recompile forever.
Prompts are therefore right-padded up to the next bucket (powers of two
from `min_bucket` to `max_seq_len`, with max_seq_len itself always the
last bucket), so at most log2(max/min)+1 prefill programs ever exist.
Padding is free in output terms: the first sampled token reads the
logits row at the TRUE prompt end, and padded cache positions are
masked (never attended) until real decode tokens overwrite them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["bucket_lengths", "bucket_for"]


def bucket_lengths(max_seq_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Powers of two in [min_bucket, max_seq_len], plus max_seq_len."""
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    out = []
    b = 1
    while b < min_bucket:
        b *= 2
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= length; raises when none fits."""
    for b in buckets:
        if b >= length:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket "
        f"{buckets[-1]} (max_seq_len)"
    )
