"""Operations, bytes and peaks: the yardstick of the rooflines and of MFU.

The peak table is the cards' data sheets (dense rates, no sparsity): it is
the denominator of every share, and a card it does not know gets no share.
The attention bounds are `chip_smoke.py`'s `bound()`: each input read once
and each output written once over HBM, the products over the causal score
matrix at the peak of the route; K and V (and dK, dV) are counted at the
configuration's KV heads, so a kernel that reads them once per KV head is
held to the same work. A model kind's step count lives in its module under
`perfbench/kinds/`, from the functions here.
"""

from __future__ import annotations

# (substring of torch.cuda.get_device_name(), dense bf16 FLOP/s, HBM bytes/s),
# most specific first
PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H100", 989e12, 3.35e12),
)


def peaks(device_name: str):
    """(bf16 FLOP/s, HBM bytes/s) of the card, or None for a card not in
    the table."""
    name = device_name.lower()
    for key, flops, hbm in PEAKS:
        if key.lower() in name:
            return flops, hbm
    return None


def causal_pairs(L: int) -> int:
    """Query-key pairs a causal mask keeps: L(L+1)/2."""
    return L * (L + 1) // 2


def attention_flops(B: int, H: int, L: int, D: int) -> int:
    """Model FLOPs of causal attention in one layer, forward and backward:
    QK^T and PV (2 products of 2·D FLOPs a pair) forward, twice that
    backward, no recompute."""
    return 3 * 4 * D * H * B * causal_pairs(L)


def attention_kernel_work(role: str, B: int, H: int, KV: int, L: int, D: int,
                          itemsize: int) -> tuple:
    """(bytes, FLOPs) a flash kernel's call needs at the least.

    `flash_fwd`: q, k, v in; o, lse out; QK^T and PV. `flash_dkdv`: q, k, v,
    dO, lse, delta in; dK, dV out; 4 products. `flash_dq`: q, k, v, dO, lse,
    delta in; dQ out; 3 products."""
    q_tile = B * H * L * D * itemsize  # q, o, dO, dQ
    kv_tile = B * KV * L * D * itemsize  # k, v, dK, dV
    rows = B * H * L * 4  # lse, delta (float32)
    pairs = causal_pairs(L) * B * H
    return {
        "flash_fwd": (2 * q_tile + 2 * kv_tile + rows, 4 * D * pairs),
        "flash_dkdv": (2 * q_tile + 4 * kv_tile + 2 * rows, 8 * D * pairs),
        "flash_dq": (3 * q_tile + 2 * kv_tile + 2 * rows, 6 * D * pairs),
    }[role]


def bound_ms(nbytes: float, flops: float, peak_flops: float, hbm_bytes_s: float) -> float:
    """The least time of a call: the larger of its bytes over HBM and its
    FLOPs at the peak."""
    return max(nbytes / hbm_bytes_s, flops / peak_flops) * 1e3
