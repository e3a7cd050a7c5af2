"""The KV-cache codec of the reference's `ops/quant.py` (:285-307): one
max-abs scale per (token, kv-head) over the head dim, the quantize-on-
scatter / dequant-on-gather pair of the int8 paged pool.

The rest of the reference module (the blockwise and fp8 codecs and
`quantized_all_reduce`) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from ..numerics import numerics_contract

__all__ = ["quantize_kv", "dequantize_kv"]


def _qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


@numerics_contract(
    "tolerance",
    note="per-(token, kv-head) int8 KV round-trip: |dq - x| <= vector "
    "amax / qmax; bitwise the reference's on equal inputs",
)
def quantize_kv(x: torch.Tensor, bits: int = 8):
    """x (..., Dh) -> (q int8 (..., Dh), scales float32 (...,)): one scale
    per leading index, so a token's write never requantizes its block's
    earlier tokens. `torch.round` rounds half to even, as `jnp.round`."""
    qmax = _qmax(bits)
    x32 = x.float()
    scales = x32.abs().amax(dim=-1).clamp_min(1e-30) / qmax
    q = torch.round(x32 / scales[..., None]).clamp(-qmax, qmax)
    return q.to(torch.int8), scales


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `quantize_kv`, cast to the attention math dtype."""
    return (q.float() * scales[..., None]).to(dtype)
