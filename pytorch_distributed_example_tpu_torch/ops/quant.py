"""Block-scaled quantization: the port of the reference's `ops/quant.py`.

One codec used two ways, as the reference's:

* **Gradient plane**: `quantized_all_reduce`, an all-reduce whose wire
  bytes are ~8-bit in both phases (EQuARX, arxiv 2506.17615). Quantize,
  then an `all_to_all` of the int8 payload and its per-block float32
  scales (the reduce-scatter's data phase), dequantize and accumulate in
  float32, requantize the partial sums, then an `all_gather` of payload
  and scales, dequantize. Both collectives go through the port's c10d core
  in the wire dtype, so the flight recorder's entries show int8 (the
  reference pins the wire dtype by reading the jaxpr).
* **KV plane**: `quantize_kv` / `dequantize_kv`, one max-abs scale per
  (token, kv-head) over the head dim, the quantize-on-scatter /
  dequant-on-gather pair of the int8 paged pool.

Wire formats: ``"int8"`` (symmetric round-to-nearest onto [-qmax, qmax],
one float32 scale a `block_size` elements) and ``"fp8"`` (values snapped
to the float8_e4m3fn grid, shipped in a bfloat16 container, 2 bytes an
element, as the reference ships it). `torch.round` rounds half to even, as
`jnp.round`. Every function is plain torch ops: no kernel is owed
(`ROADMAP.md`, Queue 2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import distributed as dist
from ..numerics import numerics_contract
from ..tensor import DistTensor
from ..types import ReduceOp

__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "WIRE_FORMATS",
    "quantize_blockwise",
    "dequantize_blockwise",
    "quantize_blockwise_fp8",
    "dequantize_blockwise_fp8",
    "wire_itemsize",
    "allreduce_wire_bytes",
    "quantized_all_reduce",
    "quantized_all_reduce_many",
    "quantize_kv",
    "dequantize_kv",
]

DEFAULT_BLOCK_SIZE = 256
_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
WIRE_FORMATS = ("int8", "fp8")


def _qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def _blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """x (..., n) as float32 (..., n // block_size, block_size)."""
    if x.shape[-1] % block_size:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by block_size "
                         f"{block_size} (pad upstream)")
    return x.float().reshape(tuple(x.shape[:-1]) + (x.shape[-1] // block_size, block_size))


@numerics_contract(
    "tolerance",
    note="symmetric int8 round-trip: |dq - x| <= blockwise amax / qmax "
    "per element; bitwise the reference's on equal inputs",
)
def quantize_blockwise(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE, bits: int = 8):
    """Symmetric block-scaled quantization along the last dim.

    x (..., n), n % block_size == 0 -> (q int8 (..., n), scales float32
    (..., n // block_size)): scale = max(blockwise amax, 1e-30) / qmax,
    q = round(x / scale) clipped to [-qmax, qmax]. A zero block gets a
    tiny positive scale, so its dequant is exactly zero."""
    qmax = _qmax(bits)
    xb = _blocks(x, block_size)
    scales = xb.abs().amax(dim=-1).clamp_min(1e-30) / qmax
    q = torch.round(xb / scales[..., None]).clamp(-qmax, qmax)
    return q.to(torch.int8).reshape(x.shape), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """Inverse of `quantize_blockwise` (float32 out)."""
    return (_blocks(q, block_size) * scales[..., None]).reshape(q.shape)


def quantize_blockwise_fp8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE):
    """Block-scaled float8_e4m3fn values in a bfloat16 container: each block
    scaled into the e4m3 range, snapped to its grid by a float8 round trip,
    returned as bfloat16 with float32 scales a block."""
    xb = _blocks(x, block_size)
    scales = xb.abs().amax(dim=-1).clamp_min(1e-30) / _FP8_MAX
    snapped = (xb / scales[..., None]).to(torch.float8_e4m3fn)
    return snapped.to(torch.bfloat16).reshape(x.shape), scales


def dequantize_blockwise_fp8(q: torch.Tensor, scales: torch.Tensor,
                             block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """Inverse of `quantize_blockwise_fp8` (float32 out): the int8 path's
    scale multiply over the bfloat16 container."""
    return dequantize_blockwise(q, scales, block_size)


def _wire_encode(x, wire: str, block_size: int, bits: int = 8):
    if wire == "int8":
        return quantize_blockwise(x, block_size, bits=bits)
    if wire == "fp8":
        return quantize_blockwise_fp8(x, block_size)
    raise ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}")


def _wire_decode(q, scales, wire: str, block_size: int):
    if wire == "int8":
        return dequantize_blockwise(q, scales, block_size)
    if wire == "fp8":
        return dequantize_blockwise_fp8(q, scales, block_size)
    raise ValueError(f"unknown wire format {wire!r}; have {WIRE_FORMATS}")


def wire_itemsize(wire: str) -> int:
    """Bytes an element on the wire (fp8 ships in a bfloat16 container)."""
    return {"int8": 1, "fp8": 2}[wire]


def allreduce_wire_bytes(n: int, world: int, wire: Optional[str],
                         block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """A rank's wire bytes for one all-reduce of n elements under the ring
    model (2 (W-1)/W of the buffer): `wire` None or "f32" 4 bytes an
    element, "bf16" 2; a quantized format its `wire_itemsize` plus 4
    bytes of scale a block, in both phases."""
    if world <= 1:
        return 0
    if wire in (None, "f32"):
        per_elem, scale = 4.0, 0.0
    elif wire == "bf16":
        per_elem, scale = 2.0, 0.0
    else:
        per_elem, scale = float(wire_itemsize(wire)), 4.0 / block_size
    return int(2 * (world - 1) / world * n * (per_elem + scale))


@numerics_contract(
    "tolerance",
    rtol=5e-2,
    atol=5e-3,
    note="wire-quantized mean against the exact mean (EQuARX-style envelope); "
    "payload and scales bitwise the reference's, the float32 combine within "
    "1e-6 of it (tests/test_torch_comm_hooks.py)",
)
def quantized_all_reduce(x: torch.Tensor, group=None, *, wire: str = "int8",
                         block_size: int = DEFAULT_BLOCK_SIZE, bits: int = 8,
                         mean: bool = True, with_residual: bool = False):
    """Wire-quantized all-reduce of this process's ranks' rows of `x`.

    x is (n, *shape): row i is local rank i's tensor (all W rows in driver
    mode, one in multiproc mode). Each rank's buffer is flattened, padded
    to W * shard elements (`shard` a multiple of `block_size`) and viewed
    as W rows; every row is quantized, `all_to_all` sends row j to rank j
    (payload and scales), the W received rows are dequantized and summed
    in float32, the partial sum is requantized and `all_gather`ed, then
    dequantized, unpadded and reshaped. Returns the sum (or the mean) in
    x's dtype, and with `with_residual` also the local phase-1 residual
    ``x - dequant(quant(x))`` (float32, x's shape): the error-feedback
    carry. The phase-2 requantization error is not locally observable.

    A tiny buffer (n * 4 bytes below W * block_size) takes an exact
    float32 SUM all-reduce instead: padding would move more bytes than the
    dense buffer. Its residual is zero."""
    outs = quantized_all_reduce_many([x], group, wire=wire, block_size=block_size, bits=bits,
                                     mean=mean, with_residual=with_residual)
    return (outs[0][0], outs[1][0]) if with_residual else outs[0]


def quantized_all_reduce_many(xs: Sequence[torch.Tensor], group=None, *, wire: str = "int8",
                              block_size: int = DEFAULT_BLOCK_SIZE, bits: int = 8,
                              mean: bool = True, with_residual: bool = False):
    """`quantized_all_reduce` of every tensor of `xs`, each as its own
    buffer (its own padding, blocks and tiny-buffer test), with one
    collective a phase: the buffers' W-row layouts sit side by side, and
    as every shard is a whole number of blocks no block straddles two
    buffers, so each result is the one-buffer call's bit for bit. Returns
    the list of results (and with `with_residual` the list of residuals)."""
    if wire == "int8" and not 2 <= bits <= 8:
        raise ValueError(f"int8 wire carries 2..8 bit grids, got {bits}")
    g = dist._resolve(group)
    W = g.size()
    outs: list = [None] * len(xs)
    resids: list = [None] * len(xs)
    tiny, big = [], []
    for i, x in enumerate(xs):
        N = x[0].numel()
        (tiny if N * 4 < W * block_size else big).append(i)
    if tiny:  # padding would exceed the dense f32 wire: exact
        n_local = xs[tiny[0]].shape[0]
        dt = DistTensor.wrap(torch.cat([xs[i].reshape(n_local, -1).float() for i in tiny], 1), g)
        dist.all_reduce(dt, ReduceOp.SUM, g)
        total = dt.tensor / W if mean else dt.tensor
        off = 0
        for i in tiny:
            k = xs[i][0].numel()
            outs[i] = total[:, off:off + k].reshape(xs[i].shape).to(xs[i].dtype)
            resids[i] = torch.zeros(xs[i].shape, dtype=torch.float32, device=xs[i].device)
            off += k
    if big:
        n_local = xs[big[0]].shape[0]
        rows, sizes, shards = [], [], []
        for i in big:
            flat = xs[i].reshape(n_local, -1).float()
            N = flat.shape[1]
            shard = -(-N // (W * block_size)) * block_size
            if W * shard > N:
                flat = torch.nn.functional.pad(flat, (0, W * shard - N))
            rows.append(flat.view(n_local, W, shard))
            sizes.append(N)
            shards.append(shard)
        rows = torch.cat(rows, dim=2) if len(rows) > 1 else rows[0]  # (n, W, S)
        q, s = _wire_encode(rows, wire, block_size, bits)
        if with_residual:
            res = rows - _wire_decode(q, s, wire, block_size)
        if W > 1:
            q = dist.all_to_all(DistTensor.wrap(q, g), g).tensor
            s = dist.all_to_all(DistTensor.wrap(s, g), g).tensor
        part = _wire_decode(q, s, wire, block_size).sum(dim=1)  # (n, S) f32
        q2, s2 = _wire_encode(part, wire, block_size, bits)
        if W > 1:
            q2 = dist.all_gather(DistTensor.wrap(q2, g), g).tensor  # (n, W, S)
            s2 = dist.all_gather(DistTensor.wrap(s2, g), g).tensor
        else:
            q2, s2 = q2[:, None], s2[:, None]
        full = _wire_decode(q2, s2, wire, block_size)
        if mean:
            full = full / W
        off = 0
        for i, N, shard in zip(big, sizes, shards):
            out = full[:, :, off:off + shard].reshape(n_local, -1)[:, :N]
            outs[i] = out.reshape(xs[i].shape).to(xs[i].dtype)
            if with_residual:
                resids[i] = res[:, :, off:off + shard].reshape(n_local, -1)[:, :N].reshape(
                    xs[i].shape)
            off += shard
    return (outs, resids) if with_residual else outs


# ---------------------------------------------------------------------------
# the KV-cache codec (the reference's :285-307)
# ---------------------------------------------------------------------------


@numerics_contract(
    "tolerance",
    note="per-(token, kv-head) int8 KV round-trip: |dq - x| <= vector "
    "amax / qmax; bitwise the reference's on equal inputs",
)
def quantize_kv(x: torch.Tensor, bits: int = 8):
    """x (..., Dh) -> (q int8 (..., Dh), scales float32 (...,)): one scale
    per leading index, so a token's write never requantizes its block's
    earlier tokens."""
    qmax = _qmax(bits)
    x32 = x.float()
    scales = x32.abs().amax(dim=-1).clamp_min(1e-30) / qmax
    q = torch.round(x32 / scales[..., None]).clamp(-qmax, qmax)
    return q.to(torch.int8), scales


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `quantize_kv`, cast to the attention math dtype."""
    return (q.float() * scales[..., None]).to(dtype)
