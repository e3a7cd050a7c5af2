"""The port's trainer against the reference's train step, on the CPU.

Three AdamW steps of `examples.lm.train_step` against the step of the
reference's `bench.py` (`value_and_grad` + `optax.adamw(1e-3)`), from the
same converted params and the same tokens, in float32. Loss agrees to
1e-5 relative. AdamW's first steps move each weight by about lr * sign(g),
so a weight whose gradient is tiny (|g| near the rounding noise of the
other entries) can move differently on the two sides: params are held to
2e-6 absolute (0.2% of one lr step) over all but a handful of entries,
and every entry to one lr step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr

TINY = ["--vocab-size", "64", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--seq", "32", "--batch-size", "2"]
LR = 1e-3


def test_three_adamw_steps_match_jax():
    kw = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, max_seq_len=32)
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(**kw))
    toks = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(toks))
    opt = optax.adamw(LR)

    @jax.jit
    def step(params, opt_state, toks):
        def loss(p):
            logits = jmodel.apply(p, toks)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1], toks[:, 1:]).mean()

        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    tmodel = ttr.TransformerLM(ttr.TransformerConfig(**kw), device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    topt = lm.make_optimizer(tmodel, LR)
    t = torch.from_numpy(toks).long()

    opt_state = opt.init(params)
    for i in range(3):
        params, opt_state, jloss = step(params, opt_state, jnp.asarray(toks))
        loss = lm.train_step(tmodel, topt, t)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
    want = convert.from_flax(jax.tree.map(np.asarray, params))
    for name, p in tmodel.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert diff.max() <= LR, name
        assert (diff > 2e-6).sum() <= 4, (name, diff.max())


def test_main_on_cpu_returns_finite_losses():
    losses = lm.main(["--cpu", *TINY, "--steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main([*TINY, "--steps", "1"])


@pytest.mark.parametrize("experts", [[], ["--n-experts", "4"]], ids=["dense", "moe"])
def test_tp_and_experts_flags_train(monkeypatch, experts):
    """The reference's `--tp 2 [--n-experts 4]` drive: 4 driver-mode ranks
    as fsdp 2 x tp 2, two steps with a finite loss."""
    monkeypatch.setenv("TDX_EXAMPLES_CPU_DEVICES", "4")
    losses = lm.main(["--cpu", *TINY, "--tp", "2", *experts, "--steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_one_rank_is_the_single_card_step(monkeypatch):
    monkeypatch.setenv("TDX_EXAMPLES_CPU_DEVICES", "1")
    model, opt, _ = lm.build(lm.parse_args(["--cpu", *TINY]))
    assert isinstance(model, ttr.TransformerLM) and isinstance(opt, torch.optim.AdamW)
    with pytest.raises(ValueError, match="--tp 2"):
        lm.build(lm.parse_args(["--cpu", *TINY, "--tp", "2"]))
