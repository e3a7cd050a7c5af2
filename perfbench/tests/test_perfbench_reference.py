"""The plain reference against the port's `TransformerLM` on the CPU at a
tiny size, both in float32: the same loss, gradients and AdamW step."""

import math

import pytest
import torch

from perfbench import feed
from perfbench.layouts import dense_decoder as layout
from perfbench.reference import dense_decoder as ref
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.models import TransformerConfig, TransformerLM

OPT = {"lr": 3e-4, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 1e-4}


def tiny(kv_heads):
    return dict(vocab=97, d=64, layers=2, heads=4, kv_heads=kv_heads, head_dim=16, ffn=96,
                theta=1e4, eps=1e-5, init_std=0.02)


def port_model(m, weights):
    cfg = TransformerConfig(vocab_size=m["vocab"], d_model=m["d"], n_layers=m["layers"],
                            n_heads=m["heads"], n_kv_heads=m["kv_heads"], d_ff=m["ffn"],
                            max_seq_len=64, rope_theta=m["theta"], norm_eps=m["eps"],
                            dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


@pytest.mark.parametrize("kv_heads", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_reference_follows_the_port_in_float32(kv_heads):
    m = tiny(kv_heads)
    batches = feed.first_batches(7, 2, 48, m["vocab"], 2)
    model = port_model(m, layout.init_weights(m, 7, "cpu"))
    opt = lm.make_optimizer(model, OPT["lr"])
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(lm.train_step(model, opt, torch.from_numpy(b))))
        if i == 0:
            grads = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
    want = ref.train(m, layout.init_weights(m, 7, "cpu"), batches, OPT)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    for n, g in want["grad_norms"].items():
        assert grads[n] == pytest.approx(g, rel=1e-4, abs=1e-9), n
    # AdamW turns an element's gradient near zero into a step of about lr of
    # either sign, so a rare element may differ by up to 2 lr a step
    for n, p in model.named_parameters():
        diff = (p.detach() - want["params"][n]).abs()
        assert float(diff.max()) <= 2 * OPT["lr"] * len(batches), n
        assert float((diff > 1e-6).float().mean()) < 1e-3, n


def test_blocked_attention_is_the_whole_softmax(monkeypatch):
    m = tiny(2)
    torch.manual_seed(0)
    q = torch.randn(2, 40, 4, 16, dtype=torch.float64)
    k = torch.randn(2, 40, 2, 16, dtype=torch.float64)
    v = torch.randn(2, 40, 2, 16, dtype=torch.float64)
    whole = ref._attention(q, k, v, ref._identity)
    monkeypatch.setattr(ref, "SCORE_BLOCK_BYTES", 4 * 2 * 4 * 40 * 16)  # 16-row blocks
    blocked = ref._attention(q, k, v, ref._identity)
    kk = k.repeat_interleave(2, dim=2)
    vv = v.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(m["head_dim"])
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
    dense = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv).reshape(2, 40, 64)
    torch.testing.assert_close(whole, dense)
    torch.testing.assert_close(blocked, dense)


def test_blocked_head_is_the_whole_loss(monkeypatch):
    m = tiny(2)
    batches = feed.first_batches(5, 2, 32, m["vocab"], 1)
    whole = ref.train(m, layout.init_weights(m, 5, "cpu"), batches, OPT)
    monkeypatch.setattr(ref, "LOGIT_BLOCK_BYTES", 4 * m["vocab"] * 7)  # 7-row blocks
    blocked = ref.train(m, layout.init_weights(m, 5, "cpu"), batches, OPT)
    assert blocked["losses"] == pytest.approx(whole["losses"], rel=1e-6)
    for n, g in whole["grad_norms"].items():
        assert blocked["grad_norms"][n] == pytest.approx(g, rel=1e-5, abs=1e-12), n


def test_faults_and_control_move_the_readings():
    m = tiny(2)
    batches = feed.first_batches(3, 2, 32, m["vocab"], 2)
    clean = ref.train(m, layout.init_weights(m, 3, "cpu"), batches, OPT)
    frozen = ref.train(m, layout.init_weights(m, 3, "cpu"), batches, OPT, fault="frozen")
    init = layout.init_weights(m, 3, "cpu")
    assert all(torch.equal(frozen["params"][n], init[n]) for n in init)
    half = ref.train(m, layout.init_weights(m, 3, "cpu"), batches, OPT, fault="half_batch")
    assert half["losses"][0] != clean["losses"][0]
    fp8 = ref.train(m, layout.init_weights(m, 3, "cpu"), batches, OPT, precision="fp8")
    assert fp8["losses"][0] != clean["losses"][0]
