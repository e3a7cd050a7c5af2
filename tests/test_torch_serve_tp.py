"""The port's tensor-parallel serving against the JAX package's, on the CPU.

The engine's ``mesh=`` over a driver-mode ("tp", 2) mesh (both ranks on
the CPU) against the reference's TP 2 engine on two of the conftest's
virtual CPU devices, and against the port's own single engine: a tiny
float32 model (vocab 64, d 32, 2 layers, 4 heads over 2 KV heads,
max_seq_len 32, block size 4), the reference's params carried across by
`from_flax`, the same traffic, greedy tokens equal token for token, with
the int8 pool and prefix sharing too. Then the layout: the pool sharded
on its KV heads (`kv_pool_spec` against the reference's specs), the lanes
replicated, `export_blocks` giving the same bytes whatever T is,
`redistribute_for_serving` from an fsdp 2 x tp 2 layout, and
`restore_into` an engine of another TP degree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import faults as jfaults
from pytorch_distributed_example_tpu import serve as jserve
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import tensor_parallel as jtp
from pytorch_distributed_example_tpu_torch import dtensor
from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch.dtensor import DTensor, Replicate, Shard
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.parallel import sharding as shd
from pytorch_distributed_example_tpu_torch.parallel import tensor_parallel as ttp
from pytorch_distributed_example_tpu_torch.serve.elastic import (
    load_serve_state,
    restore_into,
    save_serve_state,
)
from pytorch_distributed_example_tpu_torch.store import HashStore

M, BS, V = 32, 4, 64
KW = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=M,
          use_flash=False)


@functools.lru_cache(maxsize=None)
def _pair():
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(dtype=jnp.float32, **KW))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(dtype=torch.float32, **KW), device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(autouse=True)
def no_fault_plan():
    for f in (faults, jfaults):
        f.clear_plan()
    yield
    for f in (faults, jfaults):
        f.clear_plan()


def _tmesh(T=2, axes=("tp",)):
    return DeviceMesh(["cpu"] * T, (T,), axes)


def _jmesh(T=2):
    return init_device_mesh(("tp",), (T,), devices=jax.devices()[:T])


def _prompts(*lens, seed=0, prefix=None):
    gen = np.random.default_rng(seed)
    out = [gen.integers(0, V, (n,)).astype(np.int32) for n in lens]
    if prefix is not None:
        out = [np.concatenate([prefix, p]) for p in out]
    return out


def _run(eng, prompts, budgets):
    rids = [eng.submit(p, b, rid=f"r{i}", seed=i) for i, (p, b) in enumerate(zip(prompts, budgets))]
    out = eng.run(max_steps=800)
    assert eng.metrics.completed == len(prompts)
    return [out[r].tokens for r in rids]


CASES = {
    "plain": dict(),
    "kv_quant": dict(kv_quant=True),
    "prefix_cache": dict(prefix_cache=True),
    "pressure": dict(slots=3, pool_blocks=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp2_engine_matches_reference_tp2_and_single(case):
    jmodel, params, tmodel = _pair()
    kw = dict(dict(slots=2, min_bucket=4, block_size=BS, prefill_chunk_tokens=4), **CASES[case])
    prefix = np.arange(9, dtype=np.int32) if case == "prefix_cache" else None
    prompts = _prompts(5, 7, 3, 6, prefix=prefix)
    budgets = [6, 4, 9, 5]
    want = _run(jserve.ServeEngine(jmodel, params, mesh=_jmesh(), **kw), prompts, budgets)
    single = _run(tserve.ServeEngine(tmodel, **kw), prompts, budgets)
    eng = tserve.ServeEngine(tmodel, mesh=_tmesh(), **kw)
    assert _run(eng, prompts, budgets) == want == single
    if case == "prefix_cache":
        assert eng.cache.cow_copies > 0
    if case == "pressure":
        assert eng.metrics.preempted > 0


def test_tp2_matches_single_device_generate():
    # the reference's acceptance case: TP 2 against single-device generate()
    from pytorch_distributed_example_tpu_torch.models.generate import generate

    _, _, tmodel = _pair()
    prompts = _prompts(5, 7, 3, 6)
    budgets = [6, 4, 9, 5]
    eng = tserve.ServeEngine(tmodel, slots=2, min_bucket=4, block_size=BS, mesh=_tmesh(),
                             prefill_chunk_tokens=4)
    for p, m, got in zip(prompts, budgets, _run(eng, prompts, budgets)):
        want = generate(tmodel, torch.as_tensor(p)[None], m)[0]
        assert got == want.tolist()


@pytest.mark.parametrize("quantized", [False, True])
def test_tp2_pool_sharded_on_kv_heads(quantized):
    _, _, tmodel = _pair()
    eng = tserve.ServeEngine(tmodel, slots=2, min_bucket=4, block_size=BS, pool_blocks=10,
                             mesh=_tmesh(), kv_quant=quantized)
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    for layer in eng.cache.tree.values():
        assert sorted(layer["attn"]) == sorted(names)
        for name in names:
            leaf = layer["attn"][name]
            assert isinstance(leaf, DTensor) and leaf.placements == (Shard(2),)
            # rank-leading: (T, num_blocks + 1 with the sink, bs, KV/T[, Dh])
            assert leaf._local.shape[:4] == (2, 11, BS, 1)
            assert leaf.shape[:3] == (11, BS, 2)
    # the lanes are replicated: held once, on the mesh's device
    assert eng._dev_lengths.shape == (2,) and eng._dev_rngs.shape == (2, 2)
    # the Megatron layout of the weights (spot checks)
    w = eng.decoder.w
    assert w["layers.0.attn.q_proj.weight"].shape == (2, 16, 32)
    assert w["layers.0.attn.o_proj.weight"].shape == (2, 32, 16)
    assert w["tok_embed.weight"].shape == (2, V, 16)
    assert w["final_norm.weight"].shape == (32,)


SPEC_SHAPES = [(9, 4, 2, 8), (9, 4, 2), (9, 4, 3, 8), (9, 4, 3), (9, 4), (5,), (9, 4, 4, 8, 2)]


@pytest.mark.parametrize("T", [2, 4])
def test_kv_pool_spec_matches_reference(T):
    jmesh = _jmesh(T)
    for shape in SPEC_SHAPES:
        want = tuple(jtp.kv_pool_spec(np.zeros(shape), jmesh, "tp"))
        while want and want[-1] is None:
            want = want[:-1]
        assert ttp.kv_pool_spec(torch.zeros(shape), _tmesh(T), "tp") == want, shape
    # shard_kv_pool places by the rule, replicate_tree replicates
    tree = {"a": {"k": torch.randn(9, 4, 4, 8), "s": torch.randn(9, 4, 3)}}
    placed = ttp.shard_kv_pool(tree, _tmesh(T))
    assert placed["a"]["k"].placements == (Shard(2),)
    assert placed["a"]["s"].placements == (Replicate(),)
    assert torch.equal(placed["a"]["k"].full_tensor(), tree["a"]["k"])
    lanes = ttp.replicate_tree((torch.zeros(3, dtype=torch.int32), torch.ones(3, 2)), _tmesh(T))
    assert all(x.placements == (Replicate(),) and x._local.shape[0] == 1 for x in lanes)


def test_export_blocks_give_the_same_bytes_whatever_tp():
    _, _, tmodel = _pair()
    pools = {T: tserve.PagedKVCache(tmodel, slots=1, num_blocks=8, block_size=BS, quantized=True)
             for T in (1, 2)}
    pools[2].tree = ttp.shard_kv_pool(pools[2].tree, _tmesh())
    gen = torch.Generator().manual_seed(0)
    for layer in pools[1].tree.values():
        for name, buf in layer["attn"].items():
            src = torch.randint(-127, 128, buf.shape, generator=gen) if buf.dtype == torch.int8 \
                else torch.rand(buf.shape, generator=gen)
            buf.copy_(src.to(buf.dtype))
    payload = pools[1].export_blocks([3, 1, 6])
    pools[2].import_blocks([0, 5, 2], payload)
    back = pools[2].export_blocks([0, 5, 2])
    for layer in payload:
        for name, t in payload[layer]["attn"].items():
            assert back[layer]["attn"][name].dtype == t.dtype
            assert torch.equal(back[layer]["attn"][name], t), (layer, name)
            # rank t's shard holds heads [t, t + 1) of each landed block
            local = pools[2].tree[layer]["attn"][name]._local
            assert torch.equal(local[1, 5], t[1][:, 1:2])
    with pytest.raises(TypeError, match="payload"):
        bad = {l: {"attn": {n: t.float() for n, t in node["attn"].items()}}
               for l, node in payload.items()}
        pools[2].import_blocks([0, 5, 2], bad)


def _fsdp_tp_params(tmodel):
    mesh = DeviceMesh(["cpu"] * 4, (2, 2), ("fsdp", "tp"))
    params, _ = shd.shard_params(tmodel, mesh, ttr.sharding_rules("tp", "fsdp"))
    return params


def test_redistribute_for_serving_from_fsdp_tp():
    jmodel, jparams, tmodel = _pair()
    params = _fsdp_tp_params(tmodel)
    serve_mesh = _tmesh()
    out = dtensor.redistribute_for_serving(params, serve_mesh)
    want, specs = shd.shard_params(tmodel, serve_mesh, ttr.sharding_rules("tp", fsdp_axis=None))
    for name, d in out.items():
        assert d.device_mesh == serve_mesh and d.placements == want[name].placements, name
        assert torch.equal(d._local, want[name]._local), name
    # the reference lays the same leaves out the same way
    jout = __import__("pytorch_distributed_example_tpu.dtensor", fromlist=["x"]) \
        .redistribute_for_serving(jparams, _jmesh())
    jq = jout["params"]["layers_0"]["attn"]["q_proj"]["kernel"].sharding.spec
    assert tuple(jq) == (None, "tp") and specs["layers.0.attn.q_proj.weight"] == ("tp",)
    # the flax-style wrapper is kept
    wrapped = dtensor.redistribute_for_serving({"params": params}, serve_mesh)
    assert set(wrapped) == {"params"} and set(wrapped["params"]) == set(out)
    # and an engine serving those weights gives the single engine's tokens
    prompts, budgets = _prompts(5, 7, 3), [5, 6, 4]
    kw = dict(slots=2, min_bucket=4, block_size=BS, prefill_chunk_tokens=4)
    single = _run(tserve.ServeEngine(tmodel, **kw), prompts, budgets)
    eng = tserve.ServeEngine(tmodel, mesh=serve_mesh, params=out, **kw)
    assert _run(eng, prompts, budgets) == single


def test_redistribute_tree_moves_shard_to_shard():
    mesh2 = DeviceMesh(["cpu"] * 4, (2, 2), ("fsdp", "tp"))
    x = torch.arange(48.0).reshape(4, 12)
    cases = [((Shard(0), Shard(1)), (None, "tp"), (Shard(1),)),
             ((Shard(1), Replicate()), ("tp",), (Shard(0),)),
             ((Replicate(), Shard(0)), (), (Replicate(),))]
    for src_pl, spec, dst_pl in cases:
        d = dtensor.distribute_tensor(x, mesh2, src_pl)
        got = dtensor.redistribute_tree({"w": d}, _tmesh(), {"w": spec})["w"]
        assert got.placements == dst_pl and torch.equal(got.full_tensor(), x)
    # tp 2 -> tp 4: another axis size, through the leaf's value
    got = dtensor.redistribute_tree(dtensor.distribute_tensor(x, _tmesh(), (Shard(1),)),
                                    _tmesh(4), ("tp",))
    assert got.placements == (Shard(0),) and torch.equal(got.full_tensor(), x)
    # a spec tuple, and a Partial source folded out
    part = DTensor.from_local(torch.stack([x, 2 * x]), DeviceMesh(["cpu"] * 2, (2,), ("fsdp",)),
                              [dtensor.Partial()])
    got = dtensor.redistribute_tree(part, _tmesh(), ("tp",))
    assert got.placements == (Shard(0),) and torch.equal(got.full_tensor(), 3 * x)


@pytest.mark.parametrize("first_tp,then_tp", [(1, 2), (2, 1)])
def test_restore_into_different_tp_degree(first_tp, then_tp):
    _, _, tmodel = _pair()
    prompts = _prompts(5, 7, 4, 6)
    kw = dict(slots=2, min_bucket=4, block_size=BS)

    def engine(T):
        return tserve.ServeEngine(tmodel, mesh=_tmesh(T) if T > 1 else None, **kw)

    def submit_all(eng):
        for i, p in enumerate(prompts):
            eng.submit(p, 5, rid=f"r{i}", seed=i)

    ref = engine(1)
    submit_all(ref)
    want = ref.run(max_steps=500)
    e1 = engine(first_tp)
    submit_all(e1)
    for _ in range(2):
        e1.step()
    done = dict(e1.completions)
    store = HashStore(timeout=1.0)
    save_serve_state(store, 0, e1.drain())
    st, g = load_serve_state(store)
    e2 = engine(then_tp)
    assert restore_into(e2, st, generation=g) == len(prompts) - len(done)
    merged = {**done, **e2.run(max_steps=500)}
    assert {r: c.tokens for r, c in merged.items()} == {r: c.tokens for r, c in want.items()}


def test_tp_engine_refusals():
    _, _, tmodel = _pair()
    with pytest.raises(ValueError, match="split"):
        tserve.ServeEngine(tmodel, mesh=_tmesh(4))  # 2 KV heads over 4 ranks
    with pytest.raises(ValueError, match="mesh"):
        tserve.ServeEngine(tmodel, mesh=_tmesh(2, ("dp",)))
    with pytest.raises(ValueError, match="needs"):
        tserve.ServeEngine(tmodel, params={})
