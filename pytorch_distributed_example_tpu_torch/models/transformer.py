"""TransformerLM: the Llama-style decoder of the JAX package, train path.

RMSNorm + RoPE + SwiGLU + grouped-query attention; params float32,
activations cast to `cfg.dtype`, logits float32, as the reference's
`models/transformer.py`. Attention runs the Hopper flash kernels
(`ops/flash_attention.py`) when `use_flash` is set and the sequence tiles,
dense softmax attention otherwise.

Every projection computes like flax `Dense(dtype=cfg.dtype)`: input and
weight are cast to the compute dtype and `F.linear` forms the product. The
weights are `Linear`-shaped, (out, in); `models/convert.py` carries the
reference's (in, out) kernels across.

The single-card forward's pieces are regions of the span recorder
(`utils/spans.py`): `embed`, `norm`, `cast` and `gemm` (each `Dense`),
`rope`, `gqa_copy`, `attention`, `swiglu` and `loss` (the logits' float32
cast). Off, as by default, a region is its function after one flag check;
under a `torch.profiler` profile or `spans.recording()` it records its
device time, forward and backward.

`n_experts > 0` switches every MLP to the top-k MoE (`MoE`, routing in
`parallel/expert_parallel.py`) over all B*L tokens; its load-balance loss
is kept on the module as `aux` (the reference sows it, and its trainer's
loss leaves it out). `sharding_rules` is the reference's 2-D Megatron +
ZeRO layout on the port's names, and `sharded_forward` runs the model
over that layout, in driver mode or over a multiproc mesh (below).

`forward(tokens, decode=True, cache=...)` is the KV-cache path of the
reference's `Attention._decode` / `_decode_paged` (:153-364): the cache is
an explicit argument, a nested dict of tensors keyed as the reference's
flax "cache" collection (`layers_{i}` -> `attn` -> `k`, `v`, and `index`
for the dense cache or `k_scale`, `v_scale` for the int8 pool), which the
forward updates in place, as the reference's donated buffers are.
`models/generate.py::init_cache` and `serve/cache.py::init_paged_cache`
build it. Attention over the cache is dense (einsum, masked softmax,
einsum), as in the reference; no flash kernel runs on this path.
`TensorParallelDecoder` runs that paged path over a driver-mode ("tp",
T) mesh, for the serve engine's ``mesh=``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (dense_attention, flash_attention, gather_paged_kv, quantize_kv,
                   resolved_block_sizes)
from ..ops.flash_attention import NEG_INF
from ..nn import functional as nnf
from ..plan import traced as _traced
from ..utils import spans
from ..parallel.expert_parallel import moe_mlp


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None = MHA; < n_heads = GQA
    d_ff: Optional[int] = None  # None = 4 * d_model (SwiGLU sizes 2/3 * that)
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    causal: bool = True
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    use_flash: bool = True
    remat: bool = False
    n_experts: int = 0  # > 0 switches the MLP to a top-k MoE
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1  # 1 = Switch, 2 = GShard/Mixtral-style

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        # Llama convention: 2/3 * 4d rounded to a multiple of 128
        d = int(2 * 4 * self.d_model / 3)
        return (d + 127) // 128 * 128


class Dense(nn.Linear):
    """Bias-free `Linear` computing in `dtype`, like flax `Dense(dtype=...)`."""

    def __init__(self, in_features, out_features, dtype, device=None):
        super().__init__(in_features, out_features, bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        x, w = spans.region("cast", self._cast, x, self.weight)
        return spans.region("gemm", F.linear, x, w)

    def _cast(self, x, w):
        return x.to(self.compute_dtype), w.to(self.compute_dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return spans.region("norm", self._norm, x, self.weight)

    def _norm(self, x, weight):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        # scale in float32, then cast back
        return (y * weight).to(x.dtype)


def rope_freqs(head_dim: int, max_len: int, theta: float, device=None):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)  # (L, head_dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, L, H, D); rotate the interleaved pairs (x[..., 0::2],
    x[..., 1::2]) by the position angle, in float32."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope_batched(x, cos, sin):
    """x: (B, L, H, D); cos/sin: (B, L, D/2), each row at its own absolute
    positions (the serve engine's slot batch)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _window(start, L: int, M: int):
    """The positions a `lax.dynamic_slice_in_dim` / `dynamic_update_slice_in_dim`
    of length L at `start` covers in a dim of size M: XLA clamps the start
    to [0, M - L] so the window fits, where torch slicing would truncate.
    `start` is a device tensor of any shape (no host sync)."""
    base = start.clamp(0, M - L)
    return base.unsqueeze(-1) + torch.arange(L, device=start.device)


def _flash_ok(L: int, Dh: int) -> bool:
    # L must tile by the block sizes flash_attention will use; lengths
    # nothing tiles take dense attention instead of raising
    bq, bk = resolved_block_sizes(L)
    return L % bq == 0 and L % bk == 0 and Dh <= 256


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, Dh, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        self.q_proj = Dense(d, H * Dh, cfg.dtype, device)
        self.k_proj = Dense(d, KV * Dh, cfg.dtype, device)
        self.v_proj = Dense(d, KV * Dh, cfg.dtype, device)
        self.o_proj = Dense(H * Dh, d, cfg.dtype, device)

    def forward(self, x, cos, sin, cache=None, positions=None, block_tables=None):
        cfg = self.cfg
        B, L, _ = x.shape
        H, KV, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, L, H, Dh)
        k = self.k_proj(x).reshape(B, L, KV, Dh)
        v = self.v_proj(x).reshape(B, L, KV, Dh)
        scale = 1.0 / (Dh ** 0.5)
        if cache is not None:
            if block_tables is not None:
                if positions is None:
                    raise ValueError("block_tables requires positions")
                return self._decode_paged(q, k, v, cos, sin, scale, cache, positions,
                                          block_tables)
            return self._decode(q, k, v, cos, sin, scale, cache, positions)
        q = spans.region("rope", apply_rope, q, cos, sin)
        k = spans.region("rope", apply_rope, k, cos, sin)
        if KV != H:  # GQA: each kv head serves H/KV consecutive query heads
            k, v = spans.region("gqa_copy", lambda k, v: (
                torch.repeat_interleave(k, H // KV, dim=2),
                torch.repeat_interleave(v, H // KV, dim=2)), k, v)
        attend = flash_attention if cfg.use_flash and _flash_ok(L, Dh) else dense_attention
        o = spans.region("attention", lambda q, k, v: attend(
            q, k, v, causal=cfg.causal, scale=scale).reshape(B, L, H * Dh), q, k, v)
        return self.o_proj(o)

    def _decode(self, q, k, v, cos, sin, scale, cache, positions=None):
        """The dense KV-cache step (reference :153-263). `cache` holds k, v
        (B, M, KV, Dh) and the scalar `index` (a 0-d int32 tensor): this
        call's K/V land at the index, which advances by L; the queries
        attend every cached key at or before their absolute position.
        With `positions` ((B,) int) row b writes at positions[b] and attends
        keys at or before its own position, and the index is neither read
        nor advanced. Windows that would run past M clamp their start as
        XLA's dynamic slices do (`_window`)."""
        B, L, KV, Dh = k.shape
        M = self.cfg.max_seq_len
        ck, cv = cache["k"], cache["v"]
        key_pos = torch.arange(M, device=k.device)
        if positions is None:
            idx = cache["index"]
            win = _window(idx, L, M)  # (L,)
            c, s = cos[win], sin[win]
            q, k = apply_rope(q, c, s), apply_rope(k, c, s)
            ck.index_copy_(1, win, k.to(ck.dtype))
            cv.index_copy_(1, win, v.to(cv.dtype))
            q_pos = idx + torch.arange(L, device=k.device)  # the unclamped positions
            idx.add_(L)
            mask = (key_pos[None, :] <= q_pos[:, None])[None]  # (1, L, M)
        else:
            pos = positions.long()[:, None] + torch.arange(L, device=k.device)  # (B, L)
            # XLA's gather clamps an index past the table
            rp = pos.clamp(0, M - 1)
            c, s = cos[rp], sin[rp]
            q, k = apply_rope_batched(q, c, s), apply_rope_batched(k, c, s)
            rows = _window(positions.long(), L, M)  # (B, L)
            b = torch.arange(B, device=k.device)[:, None].expand(B, L)
            ck.index_put_((b, rows), k.to(ck.dtype))
            cv.index_put_((b, rows), v.to(cv.dtype))
            mask = key_pos[None, None, :] <= pos[:, :, None]  # (B, L, M)
        return self._attend(q, ck, cv, mask, scale)

    def _decode_paged(self, q, k, v, cos, sin, scale, cache, positions, block_tables):
        """The paged KV-cache step (reference :265-364) over one block pool
        shared by every row. The pool holds num_blocks + 1 blocks: the last
        is a sink that is never allocated (`serve/cache.py`). Token p of
        row b writes to flat row `block_tables[b, p // bs] * bs + p % bs`;
        a write through an unallocated entry (== num_blocks) or past the
        table lands in the sink, where the reference's `mode="drop"`
        scatter discards it. The gather reads the sink for unallocated
        entries where the reference reads a clamped real block; the causal
        mask hides both. An int8 pool (`k_scale`/`v_scale` present)
        quantizes on scatter and dequantizes in the gather."""
        cfg = self.cfg
        B, L, KV, Dh = k.shape
        M = cfg.max_seq_len
        ck, cv = cache["k"], cache["v"]
        nblk, bs = ck.shape[0] - 1, ck.shape[1]
        bt = torch.as_tensor(block_tables, device=k.device).long()
        nb = bt.shape[1]

        pos = positions.long()[:, None] + torch.arange(L, device=k.device)  # (B, L)
        safe = pos.clamp(0, M - 1)  # RoPE table bound; overshoot lands in the sink
        c, s = cos[safe], sin[safe]
        q, k = apply_rope_batched(q, c, s), apply_rope_batched(k, c, s)

        lb = pos // bs
        off = pos % bs
        phys = torch.gather(bt, 1, lb.clamp(0, nb - 1))  # == nblk when unallocated
        sink = nblk * bs + off
        flat = torch.where((lb < nb) & (phys < nblk), phys * bs + off, sink).reshape(B * L)

        def scatter(pool, upd):
            pool.view(-1, *pool.shape[2:]).index_copy_(0, flat, upd.reshape(B * L, *pool.shape[2:]))

        if "k_scale" in cache:
            qk, sk = quantize_kv(k)
            qv, sv = quantize_kv(v)
            scatter(ck, qk)
            scatter(cv, qv)
            scatter(cache["k_scale"], sk)
            scatter(cache["v_scale"], sv)
            kf, vf = gather_paged_kv(ck, cv, bt, k_scale=cache["k_scale"],
                                     v_scale=cache["v_scale"], out_dtype=cfg.dtype)
        else:
            scatter(ck, k.to(ck.dtype))
            scatter(cv, v.to(cv.dtype))
            kf, vf = gather_paged_kv(ck, cv, bt)
        key_pos = torch.arange(nb * bs, device=k.device)  # the span the tables cover
        mask = key_pos[None, None, :] <= pos[:, :, None]  # (B, L, nb*bs)
        return self._attend(q, kf, vf, mask, scale)

    def _attend(self, q, kf, vf, mask, scale):
        """Dense causal attention of q (B, L, H, Dh) over a cache (B, Mc, KV,
        Dh) under `mask` ((1 or B), L, Mc), with the query heads grouped
        over the un-repeated KV heads (GQA), as the reference."""
        B, L, H, Dh = q.shape
        KV = kf.shape[2]
        qg = q.reshape(B, L, KV, H // KV, Dh)
        s = torch.einsum("blkrd,bmkd->bkrlm", qg, kf) * scale  # (B, KV, rep, L, Mc)
        s = torch.where(mask[:, None, None], s.float(), NEG_INF)
        p = torch.softmax(s, dim=-1).to(vf.dtype)
        o = torch.einsum("bkrlm,bmkd->blkrd", p, vf).reshape(B, L, H * Dh)
        return self.o_proj(o)


class MLP(nn.Module):
    """SwiGLU."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_dim
        self.gate_proj = Dense(d, f, cfg.dtype, device)
        self.up_proj = Dense(d, f, cfg.dtype, device)
        self.down_proj = Dense(f, d, cfg.dtype, device)

    def forward(self, x):
        return self.down_proj(spans.region("swiglu", _swiglu, self.gate_proj(x), self.up_proj(x)))


def _swiglu(g, u):
    return F.silu(g) * u


class MoE(nn.Module):
    """Top-k MoE MLP: experts_up (E, D, F), experts_down (E, F, D), router
    (D, E), each in the reference's layout; the router computes in
    float32, the experts in `cfg.dtype` with the tanh GELU. Routes all
    B*L tokens at once; the last forward's load-balance loss is `aux`."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.ffn_dim
        self.experts_up = nn.Parameter(torch.empty(E, D, F_, device=device))
        self.experts_down = nn.Parameter(torch.empty(E, F_, D, device=device))
        self.router = nn.Parameter(torch.empty(D, E, device=device))
        self.aux = None

    def forward(self, x):
        cfg = self.cfg
        B, L, D = x.shape
        y, self.aux = moe_mlp(x.reshape(B * L, D).to(cfg.dtype),
                              self.experts_up.to(cfg.dtype), self.experts_down.to(cfg.dtype),
                              self.router, capacity_factor=cfg.moe_capacity_factor,
                              k=cfg.moe_top_k)
        return y.reshape(B, L, D)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MoE(cfg, device) if cfg.n_experts > 0 else MLP(cfg, device)

    def forward(self, x, cos, sin, cache=None, positions=None, block_tables=None):
        x = x + self.attn(self.attn_norm(x), cos, sin, cache, positions, block_tables)
        return x + self.mlp(self.mlp_norm(x))


def resolve_device(device=None) -> torch.device:
    """`device`, or cuda:0 when none is given; raises when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to build on the CPU")
    return torch.device("cuda", 0)


class TransformerLM(nn.Module):
    """tokens (B, L) int -> logits (B, L, vocab) float32.

    The model is built on `device`, cuda:0 by default (it raises without a
    card; pass device="cpu" for the CPU, where attention takes the kernels'
    plain versions). `generator` seeds the init (a `torch.Generator` on
    `device`). The init
    follows flax's distributions, not its bits: the embedding is normal
    with std 1/sqrt(d_model) (flax's `Embed` default), every projection
    lecun-normal truncated at two standard deviations, norm scales ones.
    Tests that compare with the reference load its params through
    `models.convert.from_flax` instead.
    """

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.tok_embed.weight, std=1.0 / math.sqrt(self.cfg.d_model),
                        generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                # flax lecun_normal: variance 1/fan_in after truncation at
                # +-2 std, hence the 0.8796 (std of a unit normal cut there)
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif isinstance(m, RMSNorm):
                nn.init.ones_(m.weight)
            elif isinstance(m, MoE):
                # flax lecun_normal on a stack: fan_in is the in-dim times
                # the leading (expert) dim
                E = self.cfg.n_experts
                for w, fan_in in ((m.experts_up, E * m.experts_up.shape[1]),
                                  (m.experts_down, E * m.experts_down.shape[1]),
                                  (m.router, m.router.shape[0])):
                    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)

    def forward(self, tokens, decode: bool = False, positions=None, block_tables=None,
                cache=None):
        """tokens (B, L) -> logits (B, L, vocab) float32.

        `decode=True` takes the KV-cache path over `cache` (see the module
        docstring), which it updates in place: once with the prompt
        (prefill), then a token at a time (`models/generate.py`).
        `positions` ((B,) int) gives each row its own cache position, the
        serve engine's slot batch; `block_tables` ((B, nb) int, with
        `positions`) switches the cache to the paged block pool."""
        cfg = self.cfg
        if decode:
            if not cfg.causal:
                raise ValueError("decode=True requires a causal model (the KV-cache step "
                                 "attends positions <= index)")
            if cache is None:
                raise ValueError("decode=True needs the cache: models.generate.init_cache "
                                 "or serve.cache.init_paged_cache")
        elif cache is not None or positions is not None or block_tables is not None:
            raise ValueError("cache, positions and block_tables apply with decode=True")
        x = spans.region("embed", self._embed, tokens, self.tok_embed.weight)
        cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len if decode else tokens.shape[1],
                              cfg.rope_theta, device=tokens.device)
        for i, layer in enumerate(self.layers):
            if decode:
                x = layer(x, cos, sin, cache[f"layers_{i}"]["attn"], positions, block_tables)
            elif cfg.remat:
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = self.final_norm(x)
        return spans.region("loss", torch.Tensor.float, self.lm_head(x))

    def _embed(self, tokens, weight):
        return F.embedding(tokens, weight).to(self.cfg.dtype)

    def sharded_forward(self, params, tokens, mesh, fsdp_axis: str = "fsdp",
                        tp_axis: str = "tp"):
        """`stacked_forward` with this model's config; the MoE layers'
        load-balance losses are kept as `sharded_aux`."""
        logits, self.sharded_aux = stacked_forward(self.cfg, params, tokens, mesh,
                                                   fsdp_axis, tp_axis)
        return logits


def sharding_rules(tp_axis: str = "tp", fsdp_axis: Optional[str] = "fsdp",
                   ep_axis: Optional[str] = None):
    """The reference's 2-D layout (`models/transformer.py:492-518`) on the
    port's names and (out, in) weights: q/k/v/gate/up colwise over
    ``tp`` (output features), o/down rowwise (input features), the other
    dim over ``fsdp``; the embedding's d_model and the LM head's vocab over
    ``tp``; expert stacks dim 0 over ``ep_axis`` (else ``fsdp_axis``);
    the router and norms replicated. ``fsdp_axis=None`` is pure TP."""
    f = fsdp_axis
    e = ep_axis or fsdp_axis
    return [
        (r"tok_embed\.weight$", (None, tp_axis)),
        (r"(q_proj|k_proj|v_proj)\.weight$", (tp_axis, f)),
        (r"o_proj\.weight$", (f, tp_axis)),
        (r"(gate_proj|up_proj)\.weight$", (tp_axis, f)),
        (r"down_proj\.weight$", (f, tp_axis)),
        (r"experts_up$", (e, None, tp_axis)),
        (r"experts_down$", (e, tp_axis, None)),
        (r"router$", ()),
        (r"lm_head\.weight$", (tp_axis, f)),
        (r"(attn_norm|mlp_norm|final_norm)\.weight$", (None,)),
        (r".*", ()),
    ]


# ---------------------------------------------------------------------------
# the model over an ("fsdp", "tp") mesh, in driver or multiproc mode
# ---------------------------------------------------------------------------


def _rms(x, w, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


def _gathered(p, tp_dim: Optional[int], dtype, tp_axis: str, T: int):
    """A parameter as its tp ranks compute with it: cast to `dtype` and
    gathered over the data axes (``dp``, ``fsdp``) by
    `DTensor.full_tensor` (one replica in driver mode: the all_gather's
    backward scatters the fsdp ranks' summed gradient, FSDP's
    reduce_scatter; over a multiproc mesh the forms that sum the data
    processes' cotangents); then (T, *its tp rank's part of dim `tp_dim`),
    or the whole tensor once where `tp_dim` is None. A dim the layout
    left whole (`spec_for` drops an axis that does not divide it) is split
    here. Over a multiproc mesh the leading tp dim is this process's tp
    rank (size 1). The mesh's last axis is ``tp``."""
    from ..dtensor import DTensor, Partial, Replicate, Shard

    mesh = p.device_mesh
    if len(p.placements) == 3 and not isinstance(p.placements[0], Replicate):
        raise ValueError(f"a parameter placed {p.placements[0]} over dp; the data-parallel "
                         "axis replicates")
    if any(isinstance(q, Partial) for q in p.placements):
        raise ValueError("a parameter with a pending Partial placement")
    a = DTensor(p._local.to(dtype), mesh, p.placements).full_tensor(
        data_axes=mesh.axis_names[:-1], keep=mesh.axis_names[-1:])  # (T or 1, *its tp part)
    pt = p.placements[-1]
    if isinstance(pt, Shard) and pt.dim == tp_dim:
        return a
    if isinstance(pt, Shard):  # sharded over tp on another dim: gather it whole
        a = nnf.all_gather(a, tp_axis, pt.dim, replica=True)
    else:
        a = a.squeeze(0)
    if tp_dim is None:
        return a
    if a.shape[tp_dim] % T:
        raise ValueError(f"dim {tp_dim} of size {a.shape[tp_dim]} does not split over "
                         f"{T} tp ranks")
    a = a.unflatten(tp_dim, (T, -1)).movedim(tp_dim, 0)
    if mesh.multiproc:  # this process's tp rank
        i = mesh.axis_index(tp_axis)
        a = a[i:i + 1]
    return a


def stacked_forward(cfg: TransformerConfig, params, tokens, mesh, fsdp_axis: str = "fsdp",
                    tp_axis: str = "tp"):
    """The model over a (``fsdp``, ``tp``) mesh, or one with a leading
    data axis (``dp``; `FSDPModule` decides that it is one): in driver
    mode every rank's work in one autograd graph on the mesh's device; over
    a multiproc mesh (`mesh.py`) this process's rank's work, its rank dims
    of size 1 (one data rank's rows, one tp rank's heads), the collectives
    those of the mesh's axis groups.

    `params` maps the port's parameter names to `DTensor`s (any layout;
    `sharding_rules` is the reference's; over dp they replicate, one copy
    held, so the one graph sums their gradients over the dp ranks, as
    GSPMD's all-reduce), `tokens` is (n, B, L): data rank d's rows of the
    global batch, the n = dp * fsdp data ranks dp-major. Each layer
    gathers its weights over ``fsdp`` (`_gathered`) and computes with the
    tp ranks as a leading
    dim: column-parallel projections (q/k/v, gate/up, the LM head, the
    experts' up) give every tp rank the replicated activation (f), the
    row-parallel ones (o, down, the experts' down) sum the tp ranks'
    float32 partial products into one replica (g), by the seams of
    `parallel/tensor_parallel.py` over `nn.functional`'s folds. The data ranks (dp and fsdp) fold into
    the rows of every matmul, and into B*H of attention, so F, KV and Q
    launch once a layer for all ranks. The MoE routes the global batch's tokens in
    order (the reference's trainer routes them all under GSPMD), its
    experts' hidden dim split over ``tp``; over a multiproc mesh each
    process gathers every data rank's tokens (dp-major) to route them,
    and keeps its own rows of the output. Returns (logits (F, B, L, V)
    float32 over the F data ranks this process holds, the MoE layers' aux
    losses)."""
    names = tuple(mesh.axis_names)
    if len(names) not in (2, 3) or names[-2:] != (fsdp_axis, tp_axis):
        raise ValueError(f"stacked_forward wants a ([dp,] {fsdp_axis!r}, {tp_axis!r}) mesh, "
                         f"got {mesh.axis_names}")
    if tokens.dim() != 3 or tokens.shape[0] != math.prod(mesh.local_shape[:-1]):
        raise ValueError(f"tokens {tuple(tokens.shape)} should be (data ranks, batch, seq)")
    T, Tl = mesh.shape[-1], mesh.local_shape[-1]
    H, KV, Dh, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    if H % T or KV % T:
        raise ValueError(f"{H} heads and {KV} kv heads must split over {T} tp ranks")
    H_l, KV_l = H // T, KV // T

    def w(name, tp_dim, dtype=cfg.dtype):
        return _gathered(params[name], tp_dim, dtype, tp_axis, T)

    with mesh:
        return _stacked_body(cfg, w, tokens, tp_axis, Tl, H_l, KV_l, mesh)


def _all_data_rows(h, mesh):
    """(every data rank's rows of h, dp-major, and the slice of them this
    process holds): h itself in driver mode; over a multiproc mesh the
    all_gathers of the data axes, whose backward sums the processes'
    cotangents."""
    if not mesh.multiproc:
        return h, slice(None)
    n = h.shape[0]
    for ax in reversed(mesh.axis_names[:-1]):  # the inner axis (fsdp) first
        h = nnf.all_gather(h.unsqueeze(0), ax, 0, axes=(ax,)).squeeze(0)
    d = mesh.flat_index(mesh.axis_names[:-1])
    return h, slice(d * n, (d + 1) * n)


def _stacked_body(cfg, w, tokens, tp_axis, T, H_l, KV_l, mesh):
    """`stacked_forward`'s layers; T is the tp ranks this process holds."""
    from ..parallel import tensor_parallel as tp
    from ..parallel.expert_parallel import (_topk_routing, capacity_for, combine, dispatch)

    H, KV, Dh, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    Fb, B, L = tokens.shape
    N = Fb * B * L
    dt, f32 = cfg.dtype, torch.float32

    def column(x, weight):  # x (N, in) replica, weight (T, out_l, in) -> (T, N, out_l)
        return tp.column_parallel(x, weight.transpose(-1, -2), tp_axis)

    def row(x, weight):  # x (T, N, in_l), weight (T, out, in_l) -> (N, out) replica
        return tp.row_parallel(x, weight.transpose(-1, -2), tp_axis)

    emb = w("tok_embed.weight", 1, f32)  # (T, V, D/T)
    x = nnf.all_gather(emb[:, tokens], tp_axis, -1, replica=True).to(dt)  # (F, B, L, D)
    cos, sin = rope_freqs(Dh, L, cfg.rope_theta, device=tokens.device)
    aux = []

    def layer(i, x):
        pre = f"layers.{i}."
        h = _rms(x, w(pre + "attn_norm.weight", None, f32), cfg.norm_eps).reshape(N, D)
        q = column(h, w(pre + "attn.q_proj.weight", 0)).reshape(T * Fb * B, L, H_l, Dh)
        k = column(h, w(pre + "attn.k_proj.weight", 0)).reshape(T * Fb * B, L, KV_l, Dh)
        v = column(h, w(pre + "attn.v_proj.weight", 0)).reshape(T * Fb * B, L, KV_l, Dh)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if KV != H:
            k = torch.repeat_interleave(k, H // KV, dim=2)
            v = torch.repeat_interleave(v, H // KV, dim=2)
        scale = 1.0 / (Dh ** 0.5)
        attend = flash_attention if cfg.use_flash and _flash_ok(L, Dh) else dense_attention
        o = attend(q, k, v, causal=cfg.causal, scale=scale).reshape(T, N, H_l * Dh)
        x = x + row(o, w(pre + "attn.o_proj.weight", 1)).reshape(Fb, B, L, D)
        h = _rms(x, w(pre + "mlp_norm.weight", None, f32), cfg.norm_eps).reshape(N, D)
        if cfg.n_experts > 0:
            E = cfg.n_experts
            hg, mine = _all_data_rows(h, mesh)  # the global batch's tokens, in order
            logits = hg.float() @ w(pre + "mlp.router", None, f32)
            C = capacity_for(hg.shape[0], E, cfg.moe_capacity_factor, cfg.moe_top_k)
            expert, gate, pos, keep, a = _topk_routing(logits, E, C, cfg.moe_top_k)
            aux.append(a)
            buf = dispatch(hg, expert, pos, keep, E, C)  # (E, C, D) replica
            up = tp.column_parallel(buf, w(pre + "mlp.experts_up", 2), tp_axis)
            y = tp.row_parallel(F.gelu(up, approximate="tanh"), w(pre + "mlp.experts_down", 1),
                                tp_axis)
            y = combine(y, expert, pos, gate, keep).to(dt)[mine]
        else:
            a = F.silu(column(h, w(pre + "mlp.gate_proj.weight", 0))) * column(
                h, w(pre + "mlp.up_proj.weight", 0))
            y = row(a, w(pre + "mlp.down_proj.weight", 1))
        return x + y.reshape(Fb, B, L, D)

    for i in range(cfg.n_layers):
        if cfg.remat:
            x = checkpoint(layer, i, x, use_reentrant=False)
        else:
            x = layer(i, x)
    h = _rms(x, w("final_norm.weight", None, f32), cfg.norm_eps).reshape(N, D)
    logits = column(h, w("lm_head.weight", 0)).float()  # (T, N, V/T)
    logits = nnf.all_gather(logits, tp_axis, -1, replica=True)
    return logits.reshape(Fb, B, L, -1), aux


# ---------------------------------------------------------------------------
# the paged decode path over a ("tp", T) mesh, in driver or multiproc mode
# ---------------------------------------------------------------------------


def _rope_ranked(x, c, s):
    """`apply_rope_batched` on a rank-leading x (T, B, L, heads, D) with
    the rows' angles c/s (B, L, D/2): the same float32 arithmetic per
    element."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = c[None, :, :, None, :]
    s = s[None, :, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# name pattern -> (tp dim of the (out, in) weight, keep float32)
_TP_LAYOUT = [
    (r"tok_embed\.weight$", 1, True),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", 0, False),
    (r"(o_proj|down_proj)\.weight$", 1, False),
    (r"lm_head\.weight$", 0, False),
    (r"(attn_norm|mlp_norm|final_norm)\.weight$", None, True),
    (r"experts_up$", 2, False),
    (r"experts_down$", 1, False),
    (r"router$", None, True),
]


class TensorParallelDecoder:
    """The paged KV-cache decode path (`Attention._decode_paged`) over a
    (``tp``, T) mesh, as `stacked_forward` runs training: in driver mode
    every tp rank's work on the mesh's one device, the ranks a leading
    dim; over a multiproc mesh (`mesh.py`, one process a tp rank) this
    process's rank's work, the leading dim of size 1, the collectives
    those of the tp group.

    The weights take their tp layout once, here (`sharding_rules(tp_axis,
    fsdp_axis=None)` through `_gathered`), cast to the compute dtype
    where the model casts them per call: q/k/v, gate/up and the LM head
    column-parallel (T, out/T, in), o and down row-parallel (T, out,
    in/T), the embedding split on d_model and kept float32, the norms
    whole; the MoE's experts_up (E, D, F/T) and experts_down (E, F/T, D)
    split on the hidden dim, the router whole in float32. `params` (name
    -> `DTensor` over `mesh`, e.g. from `dtensor.redistribute_for_serving`)
    replaces the model's own weights.

    A call is the model's decode call on the paged pool: `cache` holds
    the KV-head-sharded pool (`parallel.tensor_parallel.shard_kv_pool`),
    rank t's shard (T, num_blocks + 1, bs, KV/T, Dh) the heads [t·KV/T,
    (t+1)·KV/T). Each rank scatters its own heads' K/V and gathers them
    back; the table math, the sink routing, RoPE and the int8 codec are
    the single-card path's, computed once for all ranks. The row-parallel
    projections sum the ranks' float32 partial products and round once
    (`parallel.tensor_parallel.row_parallel`); bf16 partials would round
    twice. The MoE routes the step's B·L tokens globally with the
    replicated router, as the single-card path does, and every rank
    computes its F/T slice of every expert; the experts' down projection
    ends in one all-reduce of the float32 partials, as `stacked_forward`'s
    MoE. Returns float32 logits (B, L, V)."""

    def __init__(self, model, mesh, params=None, tp_axis: str = "tp"):
        import re

        from ..dtensor import DTensor, distribute_tensor, spec_to_placements
        from ..parallel.sharding import spec_for

        cfg = model.cfg
        if tuple(mesh.axis_names) != (tp_axis,):
            raise ValueError(f"tensor-parallel decode wants a ({tp_axis!r},) mesh, got "
                             f"{mesh.axis_names}")
        T = mesh.axis_size(tp_axis)
        if cfg.n_heads % T or cfg.kv_heads % T:
            raise ValueError(f"{cfg.n_heads} heads and {cfg.kv_heads} kv heads must split "
                             f"over {T} tp ranks")
        if cfg.n_experts > 0 and cfg.ffn_dim % T:
            raise ValueError(f"the experts' hidden dim {cfg.ffn_dim} must split over {T} "
                             "tp ranks")
        if not mesh.multiproc and len({str(d) for d in mesh.device_list()}) != 1:
            raise ValueError(f"a driver-mode tp mesh holds the model's device once a rank, got "
                             f"{mesh.device_list()}; tp ranks on distinct devices are a "
                             "multiproc mesh (init_device_mesh in a process gang)")
        dev, md = next(model.parameters()).device, torch.device(mesh.device)
        if (md.type, md.index or 0) != (dev.type, dev.index or 0):
            raise ValueError(f"the mesh holds {mesh.device}, the model {dev}")
        self.cfg, self.mesh, self.axis, self.T = cfg, mesh, tp_axis, T
        self.Tl = mesh.local_size(tp_axis)  # the tp ranks this process holds
        rules = sharding_rules(tp_axis=tp_axis, fsdp_axis=None)
        src = params if params is not None else model.state_dict()
        self.w = {}
        for name, t in src.items():
            for pat, tp_dim, f32 in _TP_LAYOUT:
                if re.search(pat, name):
                    break
            else:
                raise ValueError(f"no tensor-parallel layout for parameter {name!r}")
            if not isinstance(t, DTensor):
                spec = spec_for(name, tuple(t.shape), rules, mesh)
                t = distribute_tensor(t.detach(), mesh, spec_to_placements(spec, mesh))
            elif t.device_mesh != mesh:
                raise ValueError(f"{name} lies on {t.device_mesh}, not on the serve mesh")
            with mesh:
                self.w[name] = _gathered(t, tp_dim, torch.float32 if f32 else cfg.dtype,
                                         tp_axis, T).detach()

    @torch.no_grad()
    def __call__(self, tokens, decode: bool = True, positions=None, block_tables=None,
                 cache=None):
        if not decode or positions is None or block_tables is None or cache is None:
            raise ValueError("the tensor-parallel decoder runs the paged decode path: "
                             "decode=True with positions, block_tables and the pool")
        with self.mesh:  # over a multiproc mesh: the tp group's collectives
            return self._decode(tokens, positions, block_tables, cache)

    def _decode(self, tokens, positions, block_tables, cache):
        from ..dtensor import DTensor
        from ..parallel import tensor_parallel as tp
        from ..parallel.expert_parallel import _topk_routing, capacity_for, combine, dispatch

        cfg, axis, w = self.cfg, self.axis, self.w
        T, Tl = self.T, self.Tl
        B, L = tokens.shape
        N = B * L
        H_l, KV_l, Dh, D = cfg.n_heads // T, cfg.kv_heads // T, cfg.head_dim, cfg.d_model
        M, dt, dev = cfg.max_seq_len, cfg.dtype, tokens.device

        def column(x, weight):  # x (N, in) replica, weight (Tl, out_l, in) -> (Tl, N, out_l)
            return tp.column_parallel(x, weight.transpose(-1, -2), axis)

        def row(x, weight):  # x (Tl, N, in_l), weight (Tl, out, in_l) -> (N, out) replica
            return tp.row_parallel(x, weight.transpose(-1, -2), axis)

        x = nnf.all_gather(w["tok_embed.weight"][:, tokens], axis, -1, replica=True).to(dt)
        cos, sin = rope_freqs(Dh, M, cfg.rope_theta, device=dev)
        pos = positions.long()[:, None] + torch.arange(L, device=dev)  # (B, L)
        safe = pos.clamp(0, M - 1)
        c, s = cos[safe], sin[safe]
        # the table math of `_decode_paged`, once for every layer and rank
        bt = torch.as_tensor(block_tables, device=dev).long()
        nb = bt.shape[1]
        k0 = cache["layers_0"]["attn"]["k"]
        nblk, bs = k0.shape[0] - 1, k0.shape[1]
        lb, off = pos // bs, pos % bs
        phys = torch.gather(bt, 1, lb.clamp(0, nb - 1))
        flat = torch.where((lb < nb) & (phys < nblk), phys * bs + off,
                           nblk * bs + off).reshape(N)
        # the gather's clamp (the sink is in range), then each rank's
        # blocks addressed in the pool viewed (T * (nblk + 1), ...): a
        # gather on the leading dim, as the single-card path's
        idx = (bt.clamp(0, nblk).reshape(1, -1)
               + (nblk + 1) * torch.arange(Tl, device=dev)[:, None])  # (Tl, B*nb)
        mask = (torch.arange(nb * bs, device=dev)[None, None, :] <= pos[:, :, None])
        mask = mask.repeat(Tl, 1, 1)[:, None, None]  # (Tl*B, 1, 1, L, nb*bs)
        scale = 1.0 / (Dh ** 0.5)

        def local(a):
            return a._local if isinstance(a, DTensor) else a

        def scatter(pool, upd):  # pool (Tl, nblk+1, bs, ...), upd (Tl, B, L, ...)
            pool.view(Tl, -1, *pool.shape[3:]).index_copy_(1, flat,
                                                           upd.reshape(Tl, N, *pool.shape[3:]))

        def gather(pool, scl):  # -> (Tl*B, nb*bs, KV_l, Dh)
            g = pool.flatten(0, 1)[idx]  # (Tl, B*nb, bs, KV_l, Dh)
            if scl is not None:
                g = (g.float() * scl.flatten(0, 1)[idx][..., None]).to(dt)
            return g.reshape(Tl * B, nb * bs, KV_l, Dh)

        for i in range(cfg.n_layers):
            pre = f"layers.{i}."
            node = cache[f"layers_{i}"]["attn"]
            ck, cv = local(node["k"]), local(node["v"])
            h = _rms(x, w[pre + "attn_norm.weight"], cfg.norm_eps).reshape(N, D)
            q = column(h, w[pre + "attn.q_proj.weight"]).reshape(Tl, B, L, H_l, Dh)
            k = column(h, w[pre + "attn.k_proj.weight"]).reshape(Tl, B, L, KV_l, Dh)
            v = column(h, w[pre + "attn.v_proj.weight"]).reshape(Tl, B, L, KV_l, Dh)
            q, k = _rope_ranked(q, c, s), _rope_ranked(k, c, s)
            if "k_scale" in node:
                ks, vs = local(node["k_scale"]), local(node["v_scale"])
                qk, sk = quantize_kv(k)
                qv, sv = quantize_kv(v)
                scatter(ck, qk)
                scatter(cv, qv)
                scatter(ks, sk)
                scatter(vs, sv)
                kf, vf = gather(ck, ks), gather(cv, vs)
            else:
                scatter(ck, k.to(ck.dtype))
                scatter(cv, v.to(cv.dtype))
                kf, vf = gather(ck, None), gather(cv, None)
            qg = q.reshape(Tl * B, L, KV_l, H_l // KV_l, Dh)
            sc = torch.einsum("blkrd,bmkd->bkrlm", qg, kf) * scale
            sc = torch.where(mask, sc.float(), NEG_INF)
            p = torch.softmax(sc, dim=-1).to(vf.dtype)
            o = torch.einsum("bkrlm,bmkd->blkrd", p, vf).reshape(Tl, N, H_l * Dh)
            x = x + row(o, w[pre + "attn.o_proj.weight"]).reshape(B, L, D)
            h = _rms(x, w[pre + "mlp_norm.weight"], cfg.norm_eps).reshape(N, D)
            if cfg.n_experts > 0:  # the MoE: global routing, the experts' F split over tp
                E = cfg.n_experts
                C = capacity_for(N, E, cfg.moe_capacity_factor, cfg.moe_top_k)
                expert, gate, slot, keep, _ = _topk_routing(
                    h.float() @ w[pre + "mlp.router"], E, C, cfg.moe_top_k)
                buf = dispatch(h, expert, slot, keep, E, C)  # (E, C, D) replica
                up = tp.column_parallel(buf, w[pre + "mlp.experts_up"], axis)
                y = tp.row_parallel(F.gelu(up, approximate="tanh"),
                                    w[pre + "mlp.experts_down"], axis)
                y = combine(y, expert, slot, gate, keep).to(dt)
            else:
                a = F.silu(column(h, w[pre + "mlp.gate_proj.weight"])) * column(
                    h, w[pre + "mlp.up_proj.weight"])
                y = row(a, w[pre + "mlp.down_proj.weight"])
            x = x + y.reshape(B, L, D)
        h = _rms(x, w["final_norm.weight"], cfg.norm_eps).reshape(N, D)
        logits = column(h, w["lm_head.weight"]).float()  # (Tl, N, V/T)
        return _traced.all_gather(logits, axis, dim=-1, warn_missing=False,
                                  replica=True).reshape(B, L, -1)
