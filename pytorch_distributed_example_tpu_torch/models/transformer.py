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

`n_experts > 0` switches every MLP to the top-k MoE (`MoE`, routing in
`parallel/expert_parallel.py`) over all B*L tokens; its load-balance loss
is kept on the module as `aux` (the reference sows it, and its trainer's
loss leaves it out). `sharding_rules` is the reference's 2-D Megatron +
ZeRO layout on the port's names, and `sharded_forward` runs the model
over that layout in driver mode (below). Not ported yet: the KV-cache
decode path (`decode=True` raises `NotImplementedError`).
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
from ..nn import functional as nnf
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
# the model over an ("fsdp", "tp") mesh, in driver mode
# ---------------------------------------------------------------------------


def _rms(x, w, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


def _gathered(p, tp_dim: Optional[int], dtype, fsdp_axis: str, tp_axis: str, T: int):
    """A parameter as its tp ranks compute with it: gathered over ``fsdp``
    (the differentiable all_gather, one replica: its backward scatters the
    fsdp ranks' summed gradient, FSDP's reduce_scatter) and cast to
    `dtype`; then (T, *its tp rank's part of dim `tp_dim`), or the whole
    tensor once where `tp_dim` is None. A dim the layout left whole
    (`spec_for` drops an axis that does not divide it) is split here."""
    from ..dtensor import Partial, Shard

    pf, pt = p.placements
    if isinstance(pf, Partial) or isinstance(pt, Partial):
        raise ValueError("a parameter with a pending Partial placement")
    a = p._local.to(dtype)  # (F or 1, T or 1, *local)
    if isinstance(pf, Shard):
        a = nnf.all_gather(a, fsdp_axis, pf.dim, axes=(fsdp_axis, tp_axis), replica=True)
    else:
        a = a.squeeze(0)
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
    return a.unflatten(tp_dim, (T, -1)).movedim(tp_dim, 0)


def stacked_forward(cfg: TransformerConfig, params, tokens, mesh, fsdp_axis: str = "fsdp",
                    tp_axis: str = "tp"):
    """The model over a (``fsdp``, ``tp``) mesh in driver mode: every rank's
    work in one autograd graph on the mesh's device.

    `params` maps the port's parameter names to `DTensor`s (any layout;
    `sharding_rules` is the reference's), `tokens` is (F, B, L): fsdp rank
    f's rows of the global batch. Each layer gathers its weights over
    ``fsdp`` (`_gathered`) and computes with the tp ranks as a leading
    dim: column-parallel projections (q/k/v, gate/up, the LM head, the
    experts' up) give every tp rank the replicated activation (f), the
    row-parallel ones (o, down, the experts' down) sum the tp ranks'
    float32 partial products into one replica (g), by the seams of
    `parallel/tensor_parallel.py` over `nn.functional`'s folds. The fsdp ranks fold into the rows of
    every matmul, and into B*H of attention, so F, KV and Q launch once a
    layer for all ranks. The MoE routes the global batch's tokens in
    order (the reference's trainer routes them all under GSPMD), its
    experts' hidden dim split over ``tp``. Returns (logits (F, B, L, V)
    float32, the MoE layers' aux losses)."""
    from ..parallel import tensor_parallel as tp
    from ..parallel.expert_parallel import (_topk_routing, capacity_for, combine, dispatch)

    if tuple(mesh.axis_names) != (fsdp_axis, tp_axis):
        raise ValueError(f"stacked_forward wants a ({fsdp_axis!r}, {tp_axis!r}) mesh, got "
                         f"{mesh.axis_names}")
    if tokens.dim() != 3 or tokens.shape[0] != mesh.shape[0]:
        raise ValueError(f"tokens {tuple(tokens.shape)} should be (fsdp ranks, batch, seq)")
    T = mesh.shape[1]
    H, KV, Dh, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    if H % T or KV % T:
        raise ValueError(f"{H} heads and {KV} kv heads must split over {T} tp ranks")
    H_l, KV_l = H // T, KV // T
    Fb, B, L = tokens.shape
    N = Fb * B * L
    dt, f32 = cfg.dtype, torch.float32

    def w(name, tp_dim, dtype=dt):
        return _gathered(params[name], tp_dim, dtype, fsdp_axis, tp_axis, T)

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
            logits = h.float() @ w(pre + "mlp.router", None, f32)
            C = capacity_for(N, E, cfg.moe_capacity_factor, cfg.moe_top_k)
            expert, gate, pos, keep, a = _topk_routing(logits, E, C, cfg.moe_top_k)
            aux.append(a)
            buf = dispatch(h, expert, pos, keep, E, C)  # (E, C, D) replica
            up = tp.column_parallel(buf, w(pre + "mlp.experts_up", 2), tp_axis)
            y = tp.row_parallel(F.gelu(up, approximate="tanh"), w(pre + "mlp.experts_down", 1),
                                tp_axis)
            y = combine(y, expert, pos, gate, keep).to(dt)
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
