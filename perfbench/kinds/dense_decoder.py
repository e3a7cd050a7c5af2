"""A dense decoder configuration on the port: `TransformerLM` trained by
`examples/lm.py`'s `train_step` with `make_optimizer`'s AdamW.

The model is the port's Llama-style decoder (RMSNorm, RoPE, SwiGLU, grouped
query attention through the Hopper flash kernels, untied embedding and
head), its parameters float32 and its compute in the configuration's
`precision.compute`. The harness hands it the weights of
`layouts/dense_decoder.py` and the token feed of `feed.py`; nothing here
changes the port.

What the runner calls: `build`, `feed`, `step`, `grad_norms`,
`change_norms` and `counts`.
"""

from __future__ import annotations

import math

import torch

from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.models import TransformerConfig, TransformerLM

from .. import feed as token_feed
from .. import flops
from ..layouts import dense_decoder as layout

# compute dtypes whose flash route the bounds know: bf16 runs wgmma at the bf16 peak
COMPUTE = {"bfloat16": torch.bfloat16}

# the step the window times: (model, optimizer, tokens on the device) -> loss
step = lm.train_step


def program_config(config: dict) -> TransformerConfig:
    m = layout.dims(config)
    cfg = TransformerConfig(
        vocab_size=m["vocab"], d_model=m["d"], n_layers=m["layers"], n_heads=m["heads"],
        n_kv_heads=m["kv_heads"], d_ff=m["ffn"],
        max_seq_len=config["max_position_embeddings"], rope_theta=m["theta"],
        norm_eps=m["eps"], dtype=COMPUTE[config["precision"]["compute"]],
    )
    if cfg.head_dim != m["head_dim"]:
        raise ValueError(f"the port's head dim {cfg.head_dim} is not the configuration's "
                         f"{m['head_dim']}")
    return cfg


def build(config: dict, traffic: dict, seed: int, device):
    """(model, optimizer): the port's model holding the weights of `seed`,
    and its AdamW at the traffic's learning rate."""
    model = TransformerLM(program_config(config), device="meta")
    model.to_empty(device=device)
    weights = layout.init_weights(layout.dims(config), seed, device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError("the port's parameters are not the harness's leaves: "
                           f"{sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    del weights
    return model, lm.make_optimizer(model, traffic["optimizer"]["lr"])


def feed(config: dict, traffic: dict, seed: int) -> token_feed.Tokens:
    """The window's batches: (batch, seq) ids over the vocabulary."""
    return token_feed.Tokens(seed, traffic["batch"], traffic["seq"], config["vocab_size"])


def grad_norms(model, opt, traffic: dict) -> dict:
    """{name: ||gradient||} of the first step, as the optimizer got it: after
    one step AdamW's first moment is (1 - beta1) times the gradient. A leaf
    the optimizer holds no moment for got none: 0."""
    beta1 = traffic["optimizer"]["betas"][0]
    out = {}
    for n, p in model.named_parameters():
        m1 = opt.state[p].get("exp_avg")
        out[n] = 0.0 if m1 is None else float(torch.linalg.vector_norm(m1)) / (1 - beta1)
    return out


def change_norms(model, config: dict, seed: int, device) -> dict:
    """{name: ||parameter - the weights of `seed`||}."""
    return layout.change_norms(dict(model.named_parameters()), layout.dims(config), seed, device)


def counts(config: dict, traffic: dict, peaks) -> dict:
    """Model FLOPs a step and each flash kernel's bound (ms a call) at
    `peaks` (bf16 FLOP/s, HBM bytes/s; None: no bounds).

    Model FLOPs: 6 x every projection's weights (`lm_head` in, the
    embedding, a lookup, out) x the tokens, plus each layer's causal
    attention (`flops.attention_flops`); no recompute."""
    m = layout.dims(config)
    B, L = traffic["batch"], traffic["seq"]
    dense = sum(math.prod(shape) for name, shape, init in layout.leaves(m)
                if init == "normal" and name != "tok_embed.weight")
    step_flops = 6 * dense * B * L + m["layers"] * flops.attention_flops(
        B, m["heads"], L, m["head_dim"])
    itemsize = COMPUTE[config["precision"]["compute"]].itemsize
    bounds = None if peaks is None else {
        role: flops.bound_ms(*flops.attention_kernel_work(
            role, B, m["heads"], m["kv_heads"], L, m["head_dim"], itemsize), *peaks)
        for role in ("flash_fwd", "flash_dkdv", "flash_dq")
    }
    return {"step_flops": step_flops, "kernel_bound_ms": bounds}
