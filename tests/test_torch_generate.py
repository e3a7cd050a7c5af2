"""The port's KV-cache decode path, `gather_paged_kv`, the int8 KV codec and
`generate()` against the JAX package's, on the CPU.

Tiny float32 model (vocab 64, d 64, 2 layers, 4 heads, max_seq_len 32),
params from the reference's `model.init` carried across by `from_flax`,
caches by `cache_from_flax`. Logits are held to rtol 1e-5 and atol 1e-5 of
their largest entry. The paged pool of the port holds one block more than
the reference's, its sink: dropped writes land there, so the tests check
that every real block ends equal to the reference's and compare the rows
of live requests only (a parked row attends garbage in both packages).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.ops import quant as jquant
from pytorch_distributed_example_tpu.serve import cache as jcache
from pytorch_distributed_example_tpu_torch import prng
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.ops import gather_paged_kv, quant as tquant
from pytorch_distributed_example_tpu_torch.serve import cache as tcache

# the packages export the functions `generate` and `flash_attention` over
# their modules' names
jgen = importlib.import_module("pytorch_distributed_example_tpu.models.generate")
tgen = importlib.import_module("pytorch_distributed_example_tpu_torch.models.generate")
jfa = importlib.import_module("pytorch_distributed_example_tpu.ops.flash_attention")

RTOL, ATOL_FRAC = 1e-5, 1e-5
M = 32


def _cfgs(gqa=False):
    kw = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2 if gqa else None, max_seq_len=M, use_flash=False)
    return jtr.TransformerConfig(dtype=jnp.float32, **kw), \
        ttr.TransformerConfig(dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def _pair(gqa=False):
    jcfg, tcfg = _cfgs(gqa)
    jmodel = jtr.TransformerLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = ttr.TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (B, L)).astype(np.int32)


def _close(got, want, rows=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * np.abs(want).max())


def _japply(jmodel, params, cache, toks, **kw):
    logits, vars_ = jmodel.apply({"params": params["params"], "cache": cache},
                                 jnp.asarray(toks), decode=True, mutable=["cache"], **kw)
    return logits, vars_["cache"]


def _tapply(tmodel, cache, toks, **kw):
    with torch.no_grad():
        return tmodel(torch.as_tensor(toks).long(), decode=True, cache=cache, **kw)


def _caches_equal(tcache_, jcache_):
    got = convert.cache_to_flax(tcache_)
    want = jax.tree.map(np.asarray, jcache_)
    for layer in want:
        for name, w in want[layer]["attn"].items():
            g = got[layer]["attn"][name]
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w, err_msg=f"{layer}/{name}")
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_FRAC * np.abs(w).max(),
                                           err_msg=f"{layer}/{name}")


@pytest.mark.parametrize("gqa", [False, True])
def test_decode_scalar_index_path(gqa):
    jmodel, params, tmodel = _pair(gqa)
    jc = jgen.init_cache(jmodel, 2)
    tc = convert.cache_from_flax(jax.tree.map(np.asarray, jc))
    for toks in (_tokens(2, 8), _tokens(2, 1, 1), _tokens(2, 1, 2), _tokens(2, 3, 3)):
        want, jc = _japply(jmodel, params, jc, toks)
        got = _tapply(tmodel, tc, toks)
        _close(got, want)
    _caches_equal(tc, jc)
    assert int(tc["layers_0"]["attn"]["index"]) == 13


def test_decode_scalar_window_clamps_at_the_end():
    # index M - 2 with 4 tokens: XLA's dynamic slices clamp the start to
    # M - 4, so RoPE angles and cache rows shift back while the mask keeps
    # the unclamped positions
    jmodel, params, tmodel = _pair()
    jc = jgen.init_cache(jmodel, 1)
    _, jc = _japply(jmodel, params, jc, _tokens(1, M - 2))
    tc = convert.cache_from_flax(jax.tree.map(np.asarray, jc))
    want, jc = _japply(jmodel, params, jc, _tokens(1, 4, 5))
    got = _tapply(tmodel, tc, _tokens(1, 4, 5))
    _close(got, want)
    _caches_equal(tc, jc)


@pytest.mark.parametrize("gqa", [False, True])
def test_decode_positions_path(gqa):
    # per-row positions, one of them past the table (RoPE index clamped,
    # write window clamped to M - L)
    jmodel, params, tmodel = _pair(gqa)
    jc = jgen.init_cache(jmodel, 3)
    _, jc = _japply(jmodel, params, jc, _tokens(3, M, 7))  # fill every row
    tc = convert.cache_from_flax(jax.tree.map(np.asarray, jc))
    positions = np.array([0, 5, M - 2], np.int32)
    for L in (4, 1):
        want, jc = _japply(jmodel, params, jc, _tokens(3, L, L), positions=jnp.asarray(positions))
        got = _tapply(tmodel, tc, _tokens(3, L, L), positions=torch.as_tensor(positions))
        _close(got, want)
        _caches_equal(tc, jc)
        positions = positions + 1


def _paged_case(jmodel, quantized, nblk=12, bs=4):
    """A pool with three rows: row 0 holds blocks for positions 0..7 and
    writes 4 tokens at 4 (its table's tail unallocated); row 1 holds a full
    table and writes 4 tokens at M - 2, two of them past the table; row 2
    is parked (all-invalid table) at M - 1."""
    jc = jcache.init_paged_cache(jmodel, nblk, bs, quantized=quantized)
    nb = M // bs
    bt = np.full((3, nb), nblk, np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :] = [0, 1, 2, 4, 5, 6, 8, 9]
    return jc, bt


@pytest.mark.parametrize("gqa,quantized", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_decode_paged_path(gqa, quantized):
    jmodel, params, tmodel = _pair(gqa)
    jc, bt = _paged_case(jmodel, quantized)
    tc = convert.cache_from_flax(jax.tree.map(np.asarray, jc))
    # prefill rows 0 and 1 one row at a time, then the three-row step
    for row, toks, start in ((0, _tokens(1, 4, 1), 0), (1, _tokens(1, M - 2, 2), 0)):
        kw = dict(positions=np.array([start], np.int32), block_tables=bt[row:row + 1])
        want, jc = _japply(jmodel, params, jc, toks, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = _tapply(tmodel, tc, toks, **{k: torch.as_tensor(v) for k, v in kw.items()})
        _close(got, want)
    positions = np.array([4, M - 2, M - 1], np.int32)
    toks = _tokens(3, 4, 9)
    want, jc = _japply(jmodel, params, jc, toks, positions=jnp.asarray(positions),
                       block_tables=jnp.asarray(bt))
    got = _tapply(tmodel, tc, toks, positions=torch.as_tensor(positions),
                  block_tables=torch.as_tensor(bt))
    _close(got, want, rows=[0, 1])
    # every write through an unallocated entry or past the table went to
    # the sink: the real blocks equal the reference's, int8 payloads exactly
    _caches_equal(tc, jc)


def test_paged_pool_never_writes_real_blocks_for_dropped_positions():
    _, _, tmodel = _pair()
    tc = tcache.init_paged_cache(tmodel, 4, 4)
    bt = torch.full((2, M // 4), 4, dtype=torch.int32)  # all unallocated
    _tapply(tmodel, tc, _tokens(2, 3), positions=torch.tensor([0, M - 1]), block_tables=bt)
    for layer in tc.values():
        assert not layer["attn"]["k"][:4].any() and not layer["attn"]["v"][:4].any()
        assert layer["attn"]["k"][4].any()  # the sink took them


@pytest.mark.parametrize("scaled", [False, True])
def test_gather_paged_kv_matches_reference(scaled):
    gen = np.random.default_rng(3)
    nblk, bs, KV, Dh = 5, 4, 2, 8
    pk = gen.normal(size=(nblk, bs, KV, Dh)).astype(np.float32)
    pv = gen.normal(size=(nblk, bs, KV, Dh)).astype(np.float32)
    bt = np.array([[2, 0, nblk, nblk], [4, 1, 3, nblk]], np.int32)  # nblk: unallocated
    kw_j, kw_t = {}, {}
    if scaled:
        pk = gen.integers(-127, 128, pk.shape).astype(np.int8)
        pv = gen.integers(-127, 128, pv.shape).astype(np.int8)
        ks = gen.random((nblk, bs, KV)).astype(np.float32)
        vs = gen.random((nblk, bs, KV)).astype(np.float32)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), out_dtype=jnp.float32)
        kw_t = dict(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs), out_dtype=torch.float32)
    want = jfa.gather_paged_kv(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt), **kw_j)
    got = gather_paged_kv(torch.tensor(pk), torch.tensor(pv), torch.tensor(bt), **kw_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_kv_is_bitwise():
    gen = np.random.default_rng(4)
    x = (gen.normal(size=(3, 5, 2, 16)) * gen.random((3, 5, 2, 1)) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector: the 1e-30 floor
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round half to even
    qj, sj = jquant.quantize_kv(jnp.asarray(x))
    qt, st = tquant.quantize_kv(torch.tensor(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tquant.dequantize_kv(qt, st, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize_kv(qj, sj, jnp.float32)))


def _jgenerate(jmodel, params, prompt, n, **kw):
    seed = kw.pop("seed", 0)
    return np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt), n,
                                    rng=jax.random.PRNGKey(seed), **kw))


def _tgenerate(tmodel, prompt, n, **kw):
    seed = kw.pop("seed", 0)
    return tgen.generate(tmodel, torch.as_tensor(prompt), n, rng=prng.PRNGKey(seed),
                         **kw).numpy()


@pytest.mark.parametrize("gqa", [False, True])
def test_generate_greedy_is_token_exact(gqa):
    jmodel, params, tmodel = _pair(gqa)
    prompt = _tokens(3, 6, 11)
    want = _jgenerate(jmodel, params, prompt, 12)
    np.testing.assert_array_equal(_tgenerate(tmodel, prompt, 12), want)
    # EOS: a token the greedy stream emits, so rows freeze mid-stream
    eos = int(want[0, 3])
    want_eos = _jgenerate(jmodel, params, prompt, 12, eos_id=eos)
    got_eos = _tgenerate(tmodel, prompt, 12, eos_id=eos)
    np.testing.assert_array_equal(got_eos, want_eos)
    assert (got_eos[0, 4:] == eos).all()


@pytest.mark.parametrize("temperature,top_k,seed", [(1.0, None, 0), (0.8, 8, 1), (0.7, 3, 5),
                                                    (1.3, 100, 2)])
def test_generate_sampled_is_token_exact(temperature, top_k, seed):
    jmodel, params, tmodel = _pair()
    prompt = _tokens(2, 5, seed + 20)
    kw = dict(temperature=temperature, top_k=top_k, seed=seed)
    np.testing.assert_array_equal(_tgenerate(tmodel, prompt, 10, **kw),
                                  _jgenerate(jmodel, params, prompt, 10, **kw))


def test_init_cache_matches_the_reference_tree():
    jmodel, _, tmodel = _pair(True)
    want = jax.tree.map(np.asarray, jgen.init_cache(jmodel, 3))
    got = convert.cache_to_flax(tgen.init_cache(tmodel, 3))
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.shape == g.shape and w.dtype == g.dtype


def test_cache_converters_round_trip_the_paged_pool():
    jmodel, _, _ = _pair()
    jc = jax.tree.map(np.array, jcache.init_paged_cache(jmodel, 6, 4, quantized=True))
    jc["layers_1"]["attn"]["k"][2, 1] = 7
    tc = convert.cache_from_flax(jc)
    assert tc["layers_0"]["attn"]["k"].shape[0] == 7  # the sink
    back = convert.cache_to_flax(tc)
    for w, g in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)


def test_decode_needs_a_cache_and_a_causal_model():
    _, _, tmodel = _pair()
    with pytest.raises(ValueError, match="init_cache"):
        tmodel(torch.zeros(1, 4, dtype=torch.long), decode=True)
    cfg = ttr.TransformerConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=4, causal=False)
    with pytest.raises(ValueError, match="causal"):
        ttr.TransformerLM(cfg, device="cpu")(torch.zeros(1, 4, dtype=torch.long), decode=True,
                                             cache={})


def test_generate_rejects_overlong_requests():
    _, _, tmodel = _pair()
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(tmodel, torch.zeros(1, M - 2, dtype=torch.long), 3)
    with pytest.raises(ValueError, match=">= 1"):
        tgen.generate(tmodel, torch.zeros(1, 4, dtype=torch.long), 0)


def test_generate_example_on_the_cpu(capsys):
    from pytorch_distributed_example_tpu_torch.examples import generate as example

    out = example.main(["--cpu", "--steps", "60", "--new", "16", "--eos-id", "31"])
    assert len(out["tokens"]) == 16 and np.isfinite(out["loss"])
    assert "pattern accuracy" in capsys.readouterr().out


def test_generate_example_raises_without_a_card(monkeypatch):
    from pytorch_distributed_example_tpu_torch.examples import generate as example

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--steps", "1"])
