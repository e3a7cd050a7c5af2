"""The port's TransformerLM against the JAX package's, on the CPU.

Tiny model (vocab 64, d 64, 2 layers, 4 heads, L 32), params from the
reference's `model.init` carried across by `from_flax`, the reference's
flash in interpret mode. float32 logits agree to ~1e-6; 2e-5 covers two
layers of matmuls summing in another order. Gradients are compared
against their own largest entry (1e-5 of it), since small entries come
from long sums of cancelling terms.
"""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch.examples.lm import loss_fn
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr

LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-5


def _cfgs(gqa=False, use_flash=True, bf16=False, remat=False):
    kw = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2 if gqa else None, max_seq_len=32,
              use_flash=use_flash, remat=remat)
    jcfg = jtr.TransformerConfig(dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    tcfg = ttr.TransformerConfig(dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
    return jcfg, tcfg


def _tokens(seed=0, B=2, L=32):
    return np.random.default_rng(seed).integers(0, 64, (B, L)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _params(gqa):
    # float32 params whatever the compute dtype, so one init per topology
    jcfg, _ = _cfgs(gqa, use_flash=False)
    init = jax.jit(jtr.TransformerLM(jcfg).init)
    return init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))


def _pair(gqa=False, use_flash=True, bf16=False, remat=False):
    """(jax model, its params, the port's model with the same weights)."""
    jcfg, tcfg = _cfgs(gqa, use_flash, bf16, remat)
    jmodel = jtr.TransformerLM(jcfg)
    params = _params(gqa)
    tmodel = ttr.TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _jax_loss(jmodel, params, toks):
    logits = jmodel.apply(params, toks)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], toks[:, 1:]).mean()


def test_from_flax_covers_every_param_with_its_shape():
    jmodel, params, tmodel = _pair(gqa=True)
    sd = convert.from_flax(jax.tree.map(np.asarray, params))
    want = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    flat = flax.traverse_util.flatten_dict(params["params"], sep="/")
    assert len(flat) == len(want)
    np.testing.assert_array_equal(
        sd["layers.1.attn.k_proj.weight"].numpy(),
        np.asarray(flat["layers_1/attn/k_proj/kernel"]).T)


def test_from_flax_refuses_unknown_params():
    with pytest.raises(KeyError, match="experts_gate"):
        convert.from_flax({"layers_0": {"mlp": {"experts_gate": np.zeros((2, 3, 4))}}})


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("gqa", [False, True])
def test_logits_match_jax(gqa, use_flash):
    jmodel, params, tmodel = _pair(gqa, use_flash)
    toks = _tokens(1)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("gqa", [False, True])
def test_loss_and_grads_match_jax(gqa):
    jmodel, params, tmodel = _pair(gqa)
    toks = _tokens(2)
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, argnums=1),
                             static_argnums=0)
    jloss, jgrads = value_and_grad(jmodel, params, jnp.asarray(toks))
    t = torch.from_numpy(toks).long()
    loss = loss_fn(tmodel(t), t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = convert.from_flax(jax.tree.map(np.asarray, jgrads))
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)


def test_rope_rotates_interleaved_pairs():
    """Pair (x[2i], x[2i+1]) turns by position * theta**(-2i/D). Rotate-half
    would pair x[i] with x[i + D/2] instead."""
    D, L = 8, 3
    cos, sin = ttr.rope_freqs(D, L, 10000.0)
    x = torch.zeros(1, L, 1, D)
    x[..., 0] = 1.0  # the first pair's even element
    y = ttr.apply_rope(x, cos, sin)[0, :, 0]
    pos = torch.arange(L, dtype=torch.float32)
    torch.testing.assert_close(y[:, 0], torch.cos(pos))
    torch.testing.assert_close(y[:, 1], torch.sin(pos))
    assert not y[:, 2:].any()
    gen = np.random.default_rng(3)
    xr = gen.standard_normal((2, 16, 2, 32)).astype(np.float32)
    jc, js = jtr.rope_freqs(32, 16, 10000.0)
    want = np.asarray(jtr.apply_rope(jnp.asarray(xr), jc, js))
    got = ttr.apply_rope(torch.from_numpy(xr), *ttr.rope_freqs(32, 16, 10000.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bf16_logits_match_jax():
    """bf16 activations: both sides round every projection's output to
    bf16 (8 bits of mantissa), at other places inside softmax and SiLU.
    The logits reach |4|, where one bf16 ulp is 2**-6 ~ 0.016: the largest
    difference stays within 4 ulps there (measured 0.031-0.037 over three
    seeds), the mean within 1e-2 (measured ~0.006)."""
    jmodel, params, tmodel = _pair(bf16=True)
    toks = _tokens(4)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=6.25e-2)
    assert np.abs(got - want).mean() < 1e-2


def test_remat_gives_the_same_grads():
    """Checkpointing recomputes each block's forward identically on the
    CPU, so the grads are bitwise those of the plain run."""
    _, _, plain = _pair()
    remat = ttr.TransformerLM(dataclasses.replace(plain.cfg, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    t = torch.from_numpy(_tokens(5)).long()
    for m in (plain, remat):
        loss_fn(m(t), t).backward()
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_init_follows_flax_distributions():
    """Embedding std 1/sqrt(d) (flax Embed's default), projections
    lecun-normal truncated at 2 std, norm scales ones."""
    cfg = ttr.TransformerConfig(vocab_size=512, d_model=256, n_layers=1, n_heads=4)
    m = ttr.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    emb = m.tok_embed.weight
    assert abs(emb.std().item() * 16 - 1) < 0.02
    w = m.layers[0].mlp.gate_proj.weight  # fan_in 256
    assert abs(w.std().item() * 16 - 1) < 0.02
    assert w.abs().max().item() <= 2 / 16 / 0.87962566103423978 + 1e-6
    assert torch.equal(m.final_norm.weight, torch.ones(256))


@pytest.mark.parametrize("k", [1, 2])
def test_moe_model_matches_jax(k):
    """n_experts > 0: every MLP is the MoE; logits, the first layer's aux
    and the loss's gradients against the reference's on the same params."""
    kw = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, max_seq_len=32,
              n_experts=4, moe_top_k=k, use_flash=False)
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(**kw))
    toks = _tokens(3)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(toks))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(**kw), device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    logits, state = jax.jit(lambda p, t: jmodel.apply(p, t, mutable=["intermediates"]))(
        params, jnp.asarray(toks))
    t = torch.from_numpy(toks).long()
    got = tmodel(t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), **LOGIT_TOL)
    want_aux = state["intermediates"]["layers_0"]["mlp"]["moe_aux"][0]
    np.testing.assert_allclose(float(tmodel.layers[0].mlp.aux.detach()), float(want_aux),
                               rtol=1e-6)
    value, grads = jax.jit(jax.value_and_grad(_jax_loss, argnums=1),
                           static_argnums=0)(jmodel, params, jnp.asarray(toks))
    loss = loss_fn(got, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-5)
    want = convert.from_flax(jax.tree.map(np.asarray, grads))
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=name)


def test_unported_options_raise():
    cfg = ttr.TransformerConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.TransformerLM(cfg, device="cpu")(torch.zeros(1, 8, dtype=torch.long), decode=True)


def test_model_defaults_to_the_card_and_raises_without_one(monkeypatch):
    cfg = ttr.TransformerConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.TransformerLM(cfg)
    assert next(ttr.TransformerLM(cfg, device="cpu").parameters()).device.type == "cpu"
