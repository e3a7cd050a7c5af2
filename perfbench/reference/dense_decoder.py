"""Plain float32 reference of a dense decoder's training step.

The Llama-style decoder written out: token embedding, then per layer
RMSNorm, attention (RoPE on interleaved pairs, grouped-query heads: query
head h reads KV head h // (H / KV), causal softmax), residual, RMSNorm,
SwiGLU, residual; a final RMSNorm and an untied head; the mean next-token
cross-entropy of logits[:, :-1] against tokens[:, 1:]; the backward by
autograd; AdamW written out (decoupled decay, bias-corrected moments).

Every product runs in float32 with TF32 off. It imports nothing of the port
and reads nothing it made: `readings` makes the weights and tokens again from
the seed, as the harness made them for the port (`layouts/dense_decoder.py`,
`feed.py`). It runs once the port's state is freed, and so that it fits
beside its float32 weights and AdamW moments at the timed sizes: each layer
keeps only its input and is recomputed in the backward (`checkpoint`);
attention runs in blocks of queries, each against the keys at or before it,
so the L x L scores never exist whole; the head and the loss run in blocks
of rows, so the float32 logits never exist whole either.

`precision="fp8"` is the control: every product's operands rounded to
float8 e4m3 in the forward and their gradients to e5m2 in the backward,
each with a per-tensor scale, as fp8 training does. `fault` plants a fault
in the reference: "half_batch" takes the loss over the first half of the
tokens only (the first half of the rows where there are two or more);
"frozen" leaves the weights unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import feed
from ..layouts import dense_decoder as layout

# bytes of one block's float32 scores: the query block is chosen to keep it
SCORE_BLOCK_BYTES = 1 << 30
# bytes of one block's float32 logits: the row block of the head is chosen to keep it
LOGIT_BLOCK_BYTES = 1 << 30


def _identity(x):
    return x


def _round(x, dtype, fmax):
    scale = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


CASTS = {"float32": _identity, "fp8": _Fp8.apply}


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    """Rotate the pairs (x[..., 2i], x[..., 2i+1]) of x (B, L, H, D) by
    position t times theta^(-2i/D)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)


def _attention_block(qb, k, v, q0, cast):
    """Queries q0.. of qb (B, n, KV, R, D) against keys 0..m-1 of k, v
    (B, m, KV, D), causal."""
    n, D = qb.shape[1], qb.shape[-1]
    s = torch.einsum("bqkrd,bmkd->bkrqm", cast(qb), cast(k)) / math.sqrt(D)
    qpos = q0 + torch.arange(n, device=qb.device)
    keep = torch.arange(k.shape[1], device=qb.device)[None, :] <= qpos[:, None]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bkrqm,bmkd->bqkrd", cast(p), cast(v))


def _attention(q, k, v, cast):
    B, L, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, L, KV, H // KV, D)
    n = max(16, min(L, SCORE_BLOCK_BYTES // (4 * B * H * L)))
    out = []
    for q0 in range(0, L, n):
        q1 = min(L, q0 + n)
        out.append(checkpoint(_attention_block, qg[:, q0:q1], k[:, :q1], v[:, :q1], q0, cast,
                              use_reentrant=False))
    return torch.cat(out, dim=1).reshape(B, L, H * D)


def _layer(x, w, m, cos, sin, cast):
    B, L, _ = x.shape
    hd = m["head_dim"]

    def mm(a, name):
        return cast(a) @ cast(w[name]).t()

    h = _rms(x, w["attn_norm.weight"], m["eps"])
    q = _rope(mm(h, "attn.q_proj.weight").reshape(B, L, m["heads"], hd), cos, sin)
    k = _rope(mm(h, "attn.k_proj.weight").reshape(B, L, m["kv_heads"], hd), cos, sin)
    v = mm(h, "attn.v_proj.weight").reshape(B, L, m["kv_heads"], hd)
    x = x + mm(_attention(q, k, v, cast), "attn.o_proj.weight")
    h = _rms(x, w["mlp_norm.weight"], m["eps"])
    return x + mm(F.silu(mm(h, "mlp.gate_proj.weight")) * mm(h, "mlp.up_proj.weight"),
                  "mlp.down_proj.weight")


def _head_block(h, head, targets):
    """Summed cross-entropy of rows `h` (already cast) against `targets`."""
    return F.cross_entropy(h @ head.t(), targets, reduction="sum")


def _loss(params, tokens, m, cast, fault):
    B, L = tokens.shape
    hd = m["head_dim"]
    inv = 1.0 / (m["theta"] ** (torch.arange(0, hd, 2, device=tokens.device,
                                             dtype=torch.float32) / hd))
    ang = torch.outer(torch.arange(L, device=tokens.device, dtype=torch.float32), inv)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x = params["tok_embed.weight"][tokens]
    for i in range(m["layers"]):
        w = {n[len(f"layers.{i}."):]: p for n, p in params.items()
             if n.startswith(f"layers.{i}.")}
        x = checkpoint(_layer, x, w, m, cos, sin, cast, use_reentrant=False)
    h = _rms(x[:, :-1], params["final_norm.weight"], m["eps"]).reshape(-1, m["d"])
    targets = tokens[:, 1:].reshape(-1)
    if fault == "half_batch":
        n = h.shape[0] // 2
        h, targets = h[:n], targets[:n]
    h, head = cast(h), cast(params["lm_head.weight"])
    rows = max(1, LOGIT_BLOCK_BYTES // (4 * m["vocab"]))
    total = sum(checkpoint(_head_block, h[r:r + rows], head, targets[r:r + rows],
                           use_reentrant=False) for r in range(0, h.shape[0], rows))
    return total / h.shape[0]


def train(m: dict, weights: dict, batches: list, opt: dict, precision: str = "float32",
          fault=None) -> dict:
    """Train from `weights` ({name: float32 tensor}, consumed) on `batches`
    (int64 numpy arrays), one AdamW step each. Returns the loss of each
    step, the gradient norm of each leaf at the first step, and the final
    weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cast = CASTS[precision]
    device = next(iter(weights.values())).device
    params = {n: w.detach().requires_grad_() for n, w in weights.items()}
    m1 = {n: torch.zeros_like(p) for n, p in params.items()}
    m2 = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], None
    for t, batch in enumerate(batches, start=1):
        tokens = torch.from_numpy(np.asarray(batch)).to(device, torch.int64)
        loss = _loss(params, tokens, m, cast, fault)
        loss.backward()
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {n: float(torch.linalg.vector_norm(p.grad)) for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad
                p.grad = None
                if fault == "frozen":
                    continue
                m1[n].mul_(b1).add_(g, alpha=1 - b1)
                m2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (m2[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.mul_(1 - lr * wd)
                p.addcdiv_(m1[n], denom, value=-lr / (1 - b1 ** t))
    del m1, m2
    return {"losses": losses, "grad_norms": grad_norms,
            "params": {n: p.detach() for n, p in params.items()}}


def readings(config: dict, traffic: dict, seed: int, device, precision: str = "float32",
             fault=None) -> dict:
    """The reference's readings of the traffic's first steps from the
    weights and batches of `seed`: the loss of each step, each leaf's
    gradient norm at the first, and each leaf's change over them."""
    m = layout.dims(config)
    out = train(m, layout.init_weights(m, seed, device),
                feed.first_batches(seed, traffic["batch"], traffic["seq"], m["vocab"],
                                   traffic["checked_steps"]),
                traffic["optimizer"], precision=precision, fault=fault)
    out["change_norms"] = layout.change_norms(out.pop("params"), m, seed, device)
    return out
