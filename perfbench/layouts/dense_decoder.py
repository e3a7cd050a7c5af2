"""The parameters of a dense decoder and the weights the harness makes for it.

Every matrix is one slice of a single normal draw of float32 on the device
(`torch.Generator` on the device, one call), at the configuration's
`initializer_range`, as the published models initialise their linear and
embedding weights; norm scales are ones. The port and the reference get the
same weights, made here from the seed alone, so the reference can make them
again after the port is gone and takes nothing the port made.
"""

from __future__ import annotations

import math

import torch


def dims(config: dict) -> dict:
    """The sizes of a dense decoder from its published configuration."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    return dict(
        vocab=config["vocab_size"],
        d=d,
        layers=config["num_hidden_layers"],
        heads=heads,
        kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or d // heads,
        ffn=config["intermediate_size"],
        theta=float(config["rope_theta"]),
        eps=float(config["rms_norm_eps"]),
        init_std=float(config["initializer_range"]),
    )


def leaves(m: dict) -> list:
    """(name, shape, init) of every parameter, in a fixed order; names as
    the port's `TransformerLM` names its parameters, weights (out, in)."""
    d, hd = m["d"], m["head_dim"]
    q, kv = m["heads"] * hd, m["kv_heads"] * hd
    out = [("tok_embed.weight", (m["vocab"], d), "normal")]
    for i in range(m["layers"]):
        p = f"layers.{i}."
        out += [
            (p + "attn_norm.weight", (d,), "ones"),
            (p + "attn.q_proj.weight", (q, d), "normal"),
            (p + "attn.k_proj.weight", (kv, d), "normal"),
            (p + "attn.v_proj.weight", (kv, d), "normal"),
            (p + "attn.o_proj.weight", (d, q), "normal"),
            (p + "mlp_norm.weight", (d,), "ones"),
            (p + "mlp.gate_proj.weight", (m["ffn"], d), "normal"),
            (p + "mlp.up_proj.weight", (m["ffn"], d), "normal"),
            (p + "mlp.down_proj.weight", (d, m["ffn"]), "normal"),
        ]
    out += [("final_norm.weight", (d,), "ones"), ("lm_head.weight", (m["vocab"], d), "normal")]
    return out


def init_weights(m: dict, seed: int, device) -> dict:
    """{name: float32 tensor} on `device`, the same for the same seed and
    device. The matrices are views of one flat draw."""
    spec = leaves(m)
    n = sum(math.prod(shape) for _, shape, init in spec if init == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(n, device=device).normal_(0.0, m["init_std"], generator=gen)
    out, off = {}, 0
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape)
            off += k
    return out


def change_norms(params: dict, m: dict, seed: int, device) -> dict:
    """{name: ||param - its initial value||} against the weights of `seed`,
    made again here."""
    init = init_weights(m, seed, device)
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(params[n].float() - init[n]))
                for n in init}
