"""Reference (non-flash) attention: the numerics oracle for the kernels.

Dense softmax attention over (B, L, H, D), as the JAX package's
`ops/reference.py` computes it: float32 logits, masking with -1e30,
softmax in float32, and `p` cast to v's dtype for `p @ v`. The models use
it when flash is off or cannot tile the sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        L, Lk = s.shape[-2], s.shape[-1]
        mask = torch.ones(L, Lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
