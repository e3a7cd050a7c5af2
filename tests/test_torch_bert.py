"""The port's BERT (`models/bert.py`) against the reference's flax BERT.

A 2-layer BERT at d 64 (4 heads, d_ff 128, vocab 100, max_seq_len 16),
initialized by flax from `PRNGKey(0)` and carried over with
`bert_from_flax`; token ids, types and the padding mask from a numpy seed.
Dropout is off in the cross-package comparisons (`deterministic=True`
there, no masks here): the reference's threefry streams and torch's
generators differ. Float32 throughout; logits within rtol 1e-5, atol 1e-5
(the dense layers and the softmax sum in other orders). Three DDP steps of
`adamw(2e-5)` at world 2 (ZeRO "auto" in the port, as in the reference)
hold the losses within rtol 1e-5 and the params within rtol 1e-4, atol
1e-6; adam's normalized update makes a parameter's step about lr whatever
its gradient, so the params' tolerance is that of the DDP-MNIST test.
The attention key biases are the exception, held apart: their gradient
is zero in exact arithmetic (q . b_k adds one constant to every key's
score, which the softmax cancels), so each framework's adam turns its own
rounding noise into a step of about lr; both must stay within 3 steps of
lr of where they started.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu as jtdx
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.models import bert as jbert
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.models import (
    BertConfig,
    BertForSequenceClassification,
    bert_from_flax,
    bert_sharding_rules,
    bert_to_flax,
)

SMALL = dict(vocab_size=100, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=16)
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _data(B=4, L=12, seed=0):
    gen = np.random.default_rng(seed)
    ids = gen.integers(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    types = gen.integers(0, 2, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    mask[3, 3:] = 0
    return ids, types, mask


@pytest.fixture(scope="module")
def flax_params():
    model = jbert.BertForSequenceClassification(jbert.BertConfig(**SMALL), num_labels=3)
    ids, _, _ = _data()
    return jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1])))


def _port(flax_params, **cfg):
    model = BertForSequenceClassification(BertConfig(**{**SMALL, **cfg}), num_labels=3,
                                          device="cpu")
    model.load_state_dict(bert_from_flax(flax_params))
    return model


def test_logits_with_padding_and_token_types_match_flax(flax_params):
    ids, types, mask = _data()
    jmodel = jbert.BertForSequenceClassification(jbert.BertConfig(**SMALL), num_labels=3)
    model = _port(flax_params)
    for kw_j, kw_t in (({}, {}),
                       (dict(attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(types)),
                        dict(attention_mask=torch.from_numpy(mask).long(),
                             token_type_ids=torch.from_numpy(types).long()))):
        want = np.asarray(jmodel.apply(flax_params, jnp.asarray(ids), **kw_j))
        got = model(torch.from_numpy(ids).long(), **kw_t).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_converters_round_trip_in_flax_order(flax_params):
    state = bert_from_flax(flax_params)
    flat = jax.tree_util.tree_flatten_with_path(flax_params["params"])[0]
    assert len(state) == len(flat)
    back = bert_to_flax(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, flax_params["params"])
    model = _port(flax_params)
    views = model.hook_views()
    assert list(views) == list(state)  # both in the flax tree's flattened order
    assert views["bert.layers.0.attn.query.weight"] == (1, 0)
    assert views["bert.tok_emb.weight"] is None


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))  # flax's nn.gelu: approximate=True
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4  # not the exact form


def test_dropout_sites(flax_params):
    """2 + 3 * n_layers masks, each used: zeroing any one site's mask
    changes the logits; all masks kept scale every site by 1/(1-rate)."""
    model = _port(flax_params)
    ids = torch.from_numpy(_data()[0]).long()
    gen = torch.Generator().manual_seed(0)
    masks = model.dropout_masks(ids.shape[0], gen, seq=ids.shape[1])
    assert len(masks) == model.n_dropout_sites == 2 + 3 * SMALL["n_layers"]
    assert [tuple(m.shape) for m in masks] == [tuple(s) for s in model.dropout_shapes(4, 12)]
    full = model(ids, masks=masks)
    assert not torch.equal(full, model(ids))
    for i in range(len(masks)):
        cut = list(masks)
        cut[i] = torch.zeros_like(masks[i])
        assert not torch.allclose(model(ids, masks=tuple(cut)), full), i
    # masks drawn at max_seq_len serve a shorter input through their leading part
    long = model.dropout_masks(ids.shape[0], torch.Generator().manual_seed(1))
    assert long[1].shape[-1] == SMALL["max_seq_len"]
    assert torch.isfinite(model(ids, masks=long)).all()


def _jax_steps(flax_params, ids, y, world, steps):
    g = jtdx.new_group(ranks=list(range(world)))
    model = jbert.BertForSequenceClassification(jbert.BertConfig(**SMALL), num_labels=3)
    ddp = jtdx.DistributedDataParallel(model, flax_params, process_group=g)
    opt = optax.adamw(2e-5)

    def loss_fn(logits, yy):
        return optax.softmax_cross_entropy_with_integer_labels(logits, yy).mean()

    step = ddp.make_train_step(opt, loss_fn)
    p, s, losses = ddp.params, opt.init(ddp.params), []
    for _ in range(steps):
        p, s, loss = step(p, s, jnp.asarray(ids), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.device_get(p)


def test_three_adamw_ddp_steps_match_the_reference(world, flax_params):
    ids, _, _ = _data(B=8, L=12, seed=1)
    y = np.random.default_rng(2).integers(0, 3, 8).astype(np.int32)
    want_losses, want = _jax_steps(flax_params, ids, y, 2, 3)
    pg = tdx.init_process_group(world_size=2, device="cpu")
    try:
        model = _port(flax_params)
        ddp = tdx.DistributedDataParallel(model, bert_from_flax(flax_params))
        opt = optim.adamw(2e-5)
        step = ddp.make_train_step(opt, F.cross_entropy)
        assert step.weight_update_sharded
        p, s, losses = ddp.params, opt.init(ddp.params), []
        for _ in range(3):
            p, s, loss = step(p, s, torch.from_numpy(ids).long(), torch.from_numpy(y).long())
            losses.append(float(loss))
    finally:
        tdx.destroy_process_group()
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    got = bert_to_flax(p)
    start = flax_params["params"]["bert"]
    for i in range(SMALL["n_layers"]):
        for tree, src in ((got, "port"), (want["params"], "reference")):
            key = tree["bert"][f"layer_{i}"]["attn"]["key"]
            moved = np.abs(key.pop("bias") - start[f"layer_{i}"]["attn"]["key"]["bias"]).max()
            assert moved <= 3 * 2e-5 * 1.01, (src, i, moved)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **PARAM_TOL),
                           got, want["params"])


def test_dropout_on_trains_through_ddp(flax_params):
    """`make_train_step(has_rng=True)` draws every site's mask a rank."""
    pg = tdx.init_process_group(world_size=2, device="cpu")
    try:
        ddp = tdx.DistributedDataParallel(_port(flax_params))
        opt = optim.adamw(1e-3)
        step = ddp.make_train_step(opt, F.cross_entropy, has_rng=True)
        ids = torch.from_numpy(_data(B=4, L=16)[0]).long()
        y = torch.tensor([0, 1, 2, 0])
        p, s, l0 = step(ddp.params, opt.init(ddp.params), ids, y, 0)
        _, _, l1 = step(p, s, ids, y, 1)
    finally:
        tdx.destroy_process_group()
    assert torch.isfinite(l0) and torch.isfinite(l1)


def test_sharding_rules_name_the_port_params():
    from pytorch_distributed_example_tpu_torch.parallel.sharding import spec_for

    rules = bert_sharding_rules("tp", "fsdp")
    assert spec_for("bert.layers.0.attn.query.weight", (64, 64), rules) == ("tp", "fsdp")
    assert spec_for("bert.layers.1.attn.output.weight", (64, 64), rules) == ("fsdp", "tp")
    assert spec_for("bert.layers.1.mlp_down.weight", (64, 128), rules) == ("fsdp", "tp")
    assert spec_for("bert.tok_emb.weight", (100, 64), rules) == ("tp", "fsdp")
    assert spec_for("bert.ln_emb.bias", (64,), rules) == ("fsdp",)
    assert spec_for("classifier.bias", (3,), bert_sharding_rules(None)) == ()


@pytest.mark.parametrize("hook", [None, "bf16_compress_hook", "blockwise_quant_hook",
                                  "powerSGD_hook"])
def test_bench_bert_finetune_runs_on_a_cpu_group(hook):
    from pytorch_distributed_example_tpu_torch.bench import bench_bert_finetune
    from pytorch_distributed_example_tpu_torch.parallel import comm_hooks

    made = {None: None, "bf16_compress_hook": comm_hooks.bf16_compress_hook,
            "blockwise_quant_hook": comm_hooks.blockwise_quant_hook(),
            "powerSGD_hook": comm_hooks.powerSGD_hook(rank=2)}[hook]
    tdx.init_process_group(world_size=2, device="cpu")
    try:
        out = bench_bert_finetune(batch_per_rank=2, seq=16, warmup=1, steps=2, windows=2,
                                  comm_hook=made, preset_overrides=dict(
                                      vocab_size=100, d_model=64, n_layers=2, n_heads=4,
                                      d_ff=128))
    finally:
        tdx.destroy_process_group()
    assert out["weight_update_sharded"] and np.isfinite(out["final_loss"])
    assert out["tokens_per_s_per_device"] == out["samples_per_s_per_device"] * 16
    assert out["memory"]["opt_state_reduction_x"] > 1.9
