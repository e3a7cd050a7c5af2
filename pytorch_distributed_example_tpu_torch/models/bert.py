"""BERT-style bidirectional encoder, the port of the reference's
`models/bert.py` (`BASELINE.json` config #4: BERT-base fine-tune under
8-rank DDP with a DistributedSampler).

Learned absolute position and token-type embeddings, post-LN blocks with
GELU MLPs, a tanh [CLS] pooler and a classification head; BERT-base is
12 layers, d 768, 12 heads, d_ff 3072. Attention is dense, as the
reference's (`models/bert.py:55-66`): no flash kernel sits on this path.

Where it follows the reference (flax) rather than torch defaults:
  - GELU is the tanh form (flax's `nn.gelu` defaults to approximate=True);
  - LayerNorm's eps is 1e-12, its statistics in float32;
  - the scores are scaled by 1/sqrt(Dh) cast to `cfg.dtype`, and the
    padding mask adds -1e30 in the scores' dtype on masked keys;
  - `pos_emb` is sliced to the sequence length, `token_type_ids` default
    to zeros;
  - `cfg.dtype` (float32 or bfloat16) is the compute dtype of every dense
    layer and embedding, the params stay float32 (flax's `dtype=`); the
    init is flax's (`lecun_normal` dense kernels, zero biases, embeddings
    normal with std 1/sqrt(d_model), `pos_emb` normal 0.02).

Dropout takes its keep masks as inputs (`dropout_masks(batch, generator)`)
so that `vmap` over ranks and a recomputed forward (remat) see the same
masks: 2 + 3 * n_layers sites, in this order: the embeddings, then each
layer's attention probabilities, attention output and MLP output, then
the pooled [CLS]. `forward(..., masks=None)` is dropout off (the
reference's `deterministic=True`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .convnet import _dropout, lecun_normal_
from .transformer import resolve_device


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    norm_eps: float = 1e-12  # BERT's LayerNorm epsilon
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _dense(x, layer: nn.Linear, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def _fit(mask, x):
    """A mask drawn at `max_seq_len`, cut to x's sequence length."""
    if mask.shape == x.shape:
        return mask
    return mask[tuple(slice(0, s) for s in x.shape)]


def _drop(x, masks, i: int, rate: float):
    if masks is None or rate == 0.0:
        return x
    return _dropout(x, _fit(masks[i], x), rate)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.query, self.key, self.value, self.output = (
            nn.Linear(D, D, device=device) for _ in range(4))

    def forward(self, x, mask=None, drop=None):
        cfg = self.cfg
        B, L, D = x.shape
        H, Dh, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
        q = _dense(x, self.query, dt).reshape(B, L, H, Dh)
        k = _dense(x, self.key, dt).reshape(B, L, H, Dh)
        v = _dense(x, self.value, dt).reshape(B, L, H, Dh)
        scale = torch.tensor(math.sqrt(Dh), dtype=dt, device=x.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        if mask is not None:  # (B, L) 1 attend, 0 pad: an additive bias on keys
            s = s + torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).to(s.dtype)
        p = torch.softmax(s, dim=-1)
        if drop is not None:
            p = drop(p)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, L, D)
        return _dense(o, self.output, dt)


class BertBlock(nn.Module):
    """Post-LN transformer block (the original BERT's order)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = BertSelfAttention(cfg, device)
        self.ln_attn = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps, device=device)
        self.mlp_up = nn.Linear(cfg.d_model, cfg.d_ff, device=device)
        self.mlp_down = nn.Linear(cfg.d_ff, cfg.d_model, device=device)
        self.ln_mlp = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps, device=device)

    def forward(self, x, mask, masks, base: int):
        cfg, dt, rate = self.cfg, self.cfg.dtype, self.cfg.dropout
        probs_drop = None
        if masks is not None and rate != 0.0:
            def probs_drop(p):
                return _dropout(p, _fit(masks[base], p), rate)
        h = self.attn(x, mask, probs_drop)
        h = _drop(h, masks, base + 1, rate)
        x = _layer_norm(x + h, self.ln_attn, dt)
        m = F.gelu(_dense(x, self.mlp_up, dt), approximate="tanh")
        m = _dense(m, self.mlp_down, dt)
        m = _drop(m, masks, base + 2, rate)
        return _layer_norm(x + m, self.ln_mlp, dt)


class BertEncoder(nn.Module):
    """Embeddings, N bidirectional blocks and the [CLS] pooler."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model, device=device))
        self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.d_model, device=device)
        self.ln_emb = nn.LayerNorm(cfg.d_model, eps=cfg.norm_eps, device=device)
        self.layers = nn.ModuleList(BertBlock(cfg, device) for _ in range(cfg.n_layers))
        self.pooler = nn.Linear(cfg.d_model, cfg.d_model, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, masks=None):
        cfg, dt = self.cfg, self.cfg.dtype
        L = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (F.embedding(input_ids, self.tok_emb.weight.to(dt))
             + self.pos_emb[:L][None].to(dt)
             + F.embedding(token_type_ids, self.type_emb.weight.to(dt)))
        x = _layer_norm(x, self.ln_emb, dt)
        x = _drop(x, masks, 0, cfg.dropout)
        for i, layer in enumerate(self.layers):
            x = layer(x, attention_mask, masks, 1 + 3 * i)
        pooled = torch.tanh(_dense(x[:, 0], self.pooler, dt))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """The fine-tune head config #4 runs: pooled [CLS] -> logits.

    `forward(input_ids, attention_mask=None, token_type_ids=None,
    masks=None)` -> logits (B, num_labels) in `cfg.dtype`. Built on
    `device`, cuda:0 by default (it raises without a card; pass
    device="cpu" for the CPU). `generator` seeds the init."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.num_labels = num_labels
        self.bert = BertEncoder(cfg, device)
        self.classifier = nn.Linear(cfg.d_model, num_labels, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, m.weight.shape[1], generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Embedding):
                    m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            self.bert.pos_emb.normal_(0.0, 0.02, generator=generator)

    @property
    def n_dropout_sites(self) -> int:
        return 2 + 3 * self.cfg.n_layers

    def dropout_shapes(self, batch: int, seq: int):
        cfg = self.cfg
        D, H = cfg.d_model, cfg.n_heads
        per_layer = [(batch, H, seq, seq), (batch, seq, D), (batch, seq, D)]
        return [(batch, seq, D)] + per_layer * cfg.n_layers + [(batch, D)]

    def dropout_masks(self, batch: int, generator: torch.Generator, seq: Optional[int] = None):
        """Keep masks for every dropout site of a batch of `batch`
        sequences of `seq` tokens (default: `cfg.max_seq_len`; a shorter
        input uses the leading part of each), drawn from `generator` on
        its device: True where an entry survives."""
        keep = 1.0 - self.cfg.dropout
        seq = self.cfg.max_seq_len if seq is None else seq
        return tuple(torch.rand(s, device=generator.device, generator=generator) < keep
                     for s in self.dropout_shapes(batch, seq))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, masks=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids, masks)
        pooled = _drop(pooled, masks, self.n_dropout_sites - 1, self.cfg.dropout)
        return _dense(pooled, self.classifier, self.cfg.dtype)

    def hook_views(self):
        """The params in the reference's flattened order and layout, for
        per-leaf comm hooks (`parallel/ddp.py`)."""
        from .convert import bert_hook_views

        return bert_hook_views(self)


def bert_sharding_rules(tp_axis: Optional[str] = "tp", fsdp_axis=None):
    """The reference's 2-D layout (`models/bert.py:bert_sharding_rules`) on
    the port's names and (out, in) weights: the Megatron dim over tp
    (query/key/value and mlp_up colwise: output features; output and
    mlp_down rowwise: input features), the other over fsdp; the token
    embedding's vocab over tp; everything else dim 0 over fsdp when
    given."""
    f = fsdp_axis
    rules = []
    if tp_axis:
        rules += [
            (r"attn\.(query|key|value)\.weight$", (tp_axis, f)),
            (r"attn\.output\.weight$", (f, tp_axis)),
            (r"mlp_up\.weight$", (tp_axis, f)),
            (r"mlp_down\.weight$", (f, tp_axis)),
            (r"tok_emb\.weight$", (tp_axis, f)),
        ]
    rules.append((r".*", (f,) if f else ()))
    return rules
