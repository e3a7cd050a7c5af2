"""The port's geometry pre-warm (`serve/prewarm.py`) and the engine's
``precompiled=``, against the reference's `serve/prewarm.py` on the CPU.

The manifest keeps the reference's file name, key format and merge; what
an entry records differs (a (program, shape) to warm, not an
executable), so a manifest the reference wrote is foreign here and loads
as {}. A warmed engine must serve the same tokens as a cold one and as
the reference's engine, and the warm pass must leave a live engine's
pool, lanes, tables, queue, allocator and metrics bit for bit as they
were, on one card's layout and on a tensor-parallel pool. The planning
helpers are held to the reference's on the same inputs.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu.serve import ServeEngine as RefEngine
from pytorch_distributed_example_tpu.serve import prewarm as jprewarm
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.ops import _build
from pytorch_distributed_example_tpu_torch.serve import ServeEngine
from pytorch_distributed_example_tpu_torch.serve import prewarm
from pytorch_distributed_example_tpu_torch.serve.autoscale import AutoscalePolicy
from pytorch_distributed_example_tpu.serve.autoscale import AutoscalePolicy as RefPolicy

M, BS, V = 32, 4, 64


@functools.lru_cache(maxsize=None)
def _pair():
    kw = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              max_seq_len=M, use_flash=False)
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _traffic(n=6, seed=0):
    gen = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(gen.integers(3, 14))
        out.append((f"r{i}", gen.integers(0, V, L).astype(np.int32),
                    int(gen.integers(2, 10)), i))
    return out


def _serve(eng, traffic):
    for rid, p, budget, seed in traffic:
        eng.submit(p, budget, rid=rid, seed=seed)
    return {r: list(c.tokens) for r, c in eng.run(max_steps=500).items()}


def _state(eng):
    """Everything the warm pass promises to leave alone."""
    pool = {f"{layer}/{name}": (buf._local if hasattr(buf, "_local") else buf).clone()
            for layer, node in eng.cache.tree.items() for name, buf in node["attn"].items()}
    return dict(
        pool=pool,
        lanes=(eng._dev_lengths.clone(), eng._dev_tokens.clone(), eng._dev_rngs.clone()),
        tables=eng.cache.block_tables.copy(),
        lengths=eng.cache.lengths.copy(),
        free_blocks=list(eng.cache._free_blocks),
        free_slots=list(eng.cache._free_slots),
        refcount=eng.cache._refcount.copy(),
        queue=eng.queue.depth,
        slots=[None if r is None else r.rid for r in eng._slot_req],
        tokens=[list(t) for t in eng._slot_tokens],
        # the counters (the snapshot also reads the wall clock)
        metrics={k: v for k, v in vars(eng.metrics).items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)},
        samples=json.dumps({k: v for k, v in vars(eng.metrics).items()
                            if isinstance(v, (list, dict)) and not k.startswith("_classes")},
                           sort_keys=True, default=str),
    )


def _same_state(a, b):
    assert a["pool"].keys() == b["pool"].keys()
    for k in a["pool"]:
        assert torch.equal(a["pool"][k], b["pool"][k]), k
    for x, y in zip(a["lanes"], b["lanes"]):
        assert torch.equal(x, y)
    for k in ("tables", "lengths", "refcount"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("free_blocks", "free_slots", "queue", "slots", "tokens", "metrics", "samples"):
        assert a[k] == b[k], k


ENGINES = {
    "unchunked": dict(slots=3, min_bucket=4, block_size=BS),
    "chunked": dict(slots=3, min_bucket=4, block_size=BS, prefill_chunk_tokens=8),
    "int8": dict(slots=2, min_bucket=4, block_size=BS, kv_quant=True),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_warm_pass_leaves_a_live_engine_unchanged(name):
    """Mid-stream (slots live, blocks written, requests queued), a warm
    pass over every program and width changes no pool byte — the sink
    included — and nothing of the bookkeeping; the engine then finishes
    with the cold engine's tokens."""
    _, _, tmodel = _pair()
    kw = ENGINES[name]
    traffic = _traffic(7, seed=1)
    want = _serve(ServeEngine(tmodel, **kw), traffic)
    eng = ServeEngine(tmodel, **kw)
    for rid, p, budget, seed in traffic:
        eng.submit(p, budget, rid=rid, seed=seed)
    for _ in range(4):
        eng.step()
    assert eng.num_active > 0 and eng.queue.depth > 0
    before = _state(eng)
    timings = prewarm.prewarm_engine_programs(eng)
    assert {p for p, _ in timings} == {"prefill_chunk", "first_token", "attach", "step"}
    _same_state(before, _state(eng))
    eng.run(max_steps=500)
    assert {r: list(c.tokens) for r, c in eng.completions.items()} == want


def test_warm_pass_on_a_tensor_parallel_pool():
    """A driver-mode tp 2 engine: the sharded pool's sink rows are saved
    and written back through the DTensor's local stack."""
    _, _, tmodel = _pair()
    mesh = DeviceMesh(["cpu"] * 2, (2,), ("tp",))
    kw = dict(slots=2, min_bucket=4, block_size=BS)
    traffic = _traffic(4, seed=2)
    want = _serve(ServeEngine(tmodel, **kw), traffic)
    eng = ServeEngine(tmodel, mesh=mesh, **kw)
    for rid, p, budget, seed in traffic:
        eng.submit(p, budget, rid=rid, seed=seed)
    for _ in range(3):
        eng.step()
    before = _state(eng)
    prewarm.prewarm_engine_programs(eng)
    _same_state(before, _state(eng))
    eng.run(max_steps=500)
    assert {r: list(c.tokens) for r, c in eng.completions.items()} == want


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_warmed_engine_serves_the_reference_tokens(tmp_path, name):
    """The first incarnation warms and writes the manifest; a later one
    loads it into ``precompiled=``, warms at construction, and serves
    token for token what a cold engine and the reference's engine
    serve."""
    jmodel, params, tmodel = _pair()
    kw = ENGINES[name]
    traffic = _traffic(6, seed=3)
    first = ServeEngine(tmodel, **kw)
    timings = prewarm.prewarm_engine_programs(first, save_dir=str(tmp_path))
    table = prewarm.load_precompiled(str(tmp_path))
    assert set(table) == set(timings)
    warm = ServeEngine(tmodel, precompiled=table, **kw)
    assert set(warm.prewarm_timings) == set(table)
    cold = _serve(ServeEngine(tmodel, **kw), traffic)
    assert _serve(warm, traffic) == cold
    assert _serve(RefEngine(jmodel, params, **kw), traffic) == cold


def test_manifest_keys_are_per_tp_and_merge(tmp_path):
    _, _, tmodel = _pair()
    d = str(tmp_path / "warm")
    eng = ServeEngine(tmodel, slots=2, min_bucket=8, block_size=BS)
    t1 = prewarm.prewarm_engine_programs(eng, save_dir=d)
    tp_eng = ServeEngine(tmodel, slots=2, min_bucket=8, block_size=BS,
                         mesh=DeviceMesh(["cpu"] * 2, (2,), ("tp",)))
    t2 = prewarm.prewarm_engine_programs(tp_eng, save_dir=d)
    with open(os.path.join(d, "prewarm-manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == ({f"{n}:{s}:tp1" for n, s in t1}
                             | {f"{n}:{s}:tp2" for n, s in t2})
    # every key parses the same with the reference's parser
    for key in manifest:
        assert prewarm._parse_manifest_key(key) == jprewarm._parse_manifest_key(key)
    assert set(prewarm.load_precompiled(d)) == set(t1)
    assert set(prewarm.load_precompiled(d, tp=2)) == set(t2)
    assert set(prewarm.load_precompiled(d, mesh=tp_eng.mesh)) == set(t2)
    assert prewarm.load_precompiled(d, tp=4) == {}
    # a re-warm of one degree rewrites only its own keys
    prewarm.prewarm_engine_programs(eng, save_dir=d)
    with open(os.path.join(d, "prewarm-manifest.json")) as f:
        assert set(json.load(f)) == set(manifest)
    assert not [n for n in os.listdir(d) if ".tmp" in n]


def test_stale_torn_or_foreign_dirs_load_empty(tmp_path):
    assert prewarm.load_precompiled(str(tmp_path / "missing")) == {}
    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / "prewarm-manifest.json").write_text('{"step:2:tp1": {"form')
    assert prewarm.load_precompiled(str(torn)) == {}
    # the reference's manifest names executables: foreign to an eager engine
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "prewarm-manifest.json").write_text(
        json.dumps({"step:2:tp1": "step-2-tp1.exe", "prefill_chunk:8": "p.exe"}))
    assert prewarm.load_precompiled(str(foreign)) == {}
    (foreign / "prewarm-manifest.json").write_text("[1, 2]")
    assert prewarm.load_precompiled(str(foreign)) == {}
    # an engine handed an empty or unmatched table serves as a cold one
    _, _, tmodel = _pair()
    eng = ServeEngine(tmodel, slots=2, min_bucket=4, block_size=BS,
                      precompiled={("step", 5): {}, ("prefill_chunk", 999): {}})
    assert eng.prewarm_timings == {}


@pytest.mark.parametrize("key", ["step:4:tp2", "prefill_chunk:16", "attach:8:tp1",
                                 "bad", "a:b", "x:3:pp2", "x:3:tpz", "x:1:2:3"])
def test_parse_manifest_key_matches_the_reference(key):
    assert prewarm._parse_manifest_key(key) == jprewarm._parse_manifest_key(key)


@pytest.mark.parametrize("world,horizon,tp", [(1, None, 1), (3, 1, 2), (4, 2, 1), (2, 0, 1)])
def test_reachable_geometries_match_the_reference(world, horizon, tp):
    kw = dict(min_replicas=1, max_replicas=5, max_step=2)
    got = prewarm.reachable_geometries(AutoscalePolicy(**kw), world, [16, 8, 32, 8],
                                       tp=tp, horizon=horizon)
    want = jprewarm.reachable_geometries(RefPolicy(**kw), world, [16, 8, 32, 8],
                                         tp=tp, horizon=horizon)
    assert [(g.world, g.tp, g.bucket) for g in got] == \
        [(g.world, g.tp, g.bucket) for g in want]


def test_enable_compile_cache_moves_the_build_dir(tmp_path):
    old = _build.BUILD_DIR
    try:
        assert prewarm.enable_compile_cache(str(tmp_path)) == str(tmp_path)
        assert str(_build.BUILD_DIR) == str(tmp_path)
    finally:
        _build.BUILD_DIR = old
