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

Not ported yet: the MoE MLP (`n_experts > 0`) and the KV-cache decode path
(`decode=True`) raise `NotImplementedError`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import dense_attention, flash_attention, resolved_block_sizes


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
    n_experts: int = 0  # > 0 is the MoE MLP, not ported yet

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
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        # scale in float32, then cast back
        return (y * self.weight).to(x.dtype)


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

    def forward(self, x, cos, sin):
        cfg = self.cfg
        B, L, _ = x.shape
        H, KV, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, L, H, Dh)
        k = self.k_proj(x).reshape(B, L, KV, Dh)
        v = self.v_proj(x).reshape(B, L, KV, Dh)
        scale = 1.0 / (Dh ** 0.5)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if KV != H:  # GQA: each kv head serves H/KV consecutive query heads
            k = torch.repeat_interleave(k, H // KV, dim=2)
            v = torch.repeat_interleave(v, H // KV, dim=2)
        if cfg.use_flash and _flash_ok(L, Dh):
            o = flash_attention(q, k, v, causal=cfg.causal, scale=scale)
        else:
            o = dense_attention(q, k, v, causal=cfg.causal, scale=scale)
        return self.o_proj(o.reshape(B, L, H * Dh))


class MLP(nn.Module):
    """SwiGLU."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_dim
        self.gate_proj = Dense(d, f, cfg.dtype, device)
        self.up_proj = Dense(d, f, cfg.dtype, device)
        self.down_proj = Dense(f, d, cfg.dtype, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.attn_norm(x), cos, sin)
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
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "n_experts > 0 (the MoE MLP) is not ported yet: ROADMAP.md, "
                "Queue 1, 'Sharded training'"
            )
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

    def forward(self, tokens, decode: bool = False):
        if decode:
            raise NotImplementedError(
                "decode=True (the KV-cache path) is not ported yet: "
                "ROADMAP.md, Queue 1, 'Generation and serving'"
            )
        cfg = self.cfg
        x = self.tok_embed(tokens).to(cfg.dtype)
        cos, sin = rope_freqs(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                              device=tokens.device)
        for layer in self.layers:
            if cfg.remat:
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = self.final_norm(x)
        return self.lm_head(x).float()
