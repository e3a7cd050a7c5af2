"""The port's serve plane against the JAX package's, on the CPU.

Tiny float32 model (vocab 64, d 32, 2 layers, 4 heads over 2 KV heads,
max_seq_len 32, block size 4), params carried across by `from_flax`. Both
engines get the same traffic, submitted at the same steps on the same fake
clock, and must give the same completions token for token (the reference's
`token_exact` contract on `ServeEngine.step`) with the same admission,
requeue and preemption counts. Then the paged pool's bookkeeping under a
seeded sequence of calls, the slot programs, the options that raise, and a
few of the reference's own cases run on the port's copies of
`serve/{bucketing,queue,metrics,prefix}.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import faults
from pytorch_distributed_example_tpu import serve as jserve
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.serve import decode as jdecode
from pytorch_distributed_example_tpu.serve import metrics as jmetrics
from pytorch_distributed_example_tpu_torch import prng
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.serve import decode as tdecode
from pytorch_distributed_example_tpu_torch.serve import metrics as tmetrics

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


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


class _FakeClock:
    """Advances one tick a call, the same in both engines."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _trace(n, seed=0, lens=(3, 20), budgets=(2, 12), klass=None, prefix=None):
    """n requests (rid, prompt, max_new_tokens, seed, klass), prompts drawn
    from seeded numpy; `prefix` is a shared preamble."""
    gen = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(gen.integers(*lens))
        p = gen.integers(0, V, L).astype(np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        budget = min(int(gen.integers(*budgets)), M - len(p))
        out.append(dict(rid=f"r{seed}-{i}", prompt=p, max_new_tokens=budget, seed=i,
                        klass=klass if isinstance(klass, str) or klass is None
                        else klass[i % len(klass)]))
    return out


def _drive(engine, schedule, max_steps=2000):
    """Submit each request at its step ({step: [request, ...]}) and step the
    engine until everything has completed."""
    step = 0
    last = max(schedule)
    while True:
        for r in schedule.get(step, []):
            kw = {k: v for k, v in r.items() if k != "klass" or v is not None}
            engine.submit(kw.pop("prompt"), kw.pop("max_new_tokens"), **kw)
        more = engine.step()
        step += 1
        if not more and step > last:
            return engine.completions
        assert step < max_steps, "engine did not drain"


def _both(schedule, **kw):
    jmodel, params, tmodel = _pair()
    jeng = jserve.ServeEngine(jmodel, params, clock=_FakeClock(), **kw)
    teng = tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw)
    return jeng, _drive(jeng, schedule), teng, _drive(teng, schedule)


COUNTS = ("submitted", "admitted", "completed", "requeued", "preempted", "class_preempted",
          "shed", "tokens_completed")


def _same(jeng, jout, teng, tout):
    assert sorted(tout) == sorted(jout)
    for rid, want in jout.items():
        got = tout[rid]
        assert got.tokens == want.tokens, rid
        assert (got.finish_reason, got.requeues) == (want.finish_reason, want.requeues), rid
    for name in COUNTS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), name
    assert teng.cache.cow_copies == jeng.cache.cow_copies


ENGINE_CASES = {
    "unchunked": dict(slots=3),
    "chunked": dict(slots=3, prefill_chunk_tokens=8),
    "pressure_unchunked": dict(slots=3, pool_blocks=10),
    "pressure_chunked": dict(slots=4, pool_blocks=9, prefill_chunk_tokens=8),
    "kv_quant": dict(slots=3, pool_blocks=10, prefill_chunk_tokens=8, kv_quant=True),
    "sampled": dict(slots=3, pool_blocks=10, temperature=0.8, top_k=8),
    "eos": dict(slots=3, prefill_chunk_tokens=4, eos_id=7),
    "conservative": dict(slots=3, pool_blocks=12, conservative_admission=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_is_token_exact_with_the_reference(case):
    kw = dict(block_size=BS, min_bucket=4, **ENGINE_CASES[case])
    trace = _trace(10, seed=1)
    jeng, jout, teng, tout = _both({0: trace[:6], 3: trace[6:]}, **kw)
    _same(jeng, jout, teng, tout)
    if "pressure" in case or case == "kv_quant":
        assert teng.metrics.preempted > 0
    if case == "conservative":
        assert teng.metrics.preempted == 0


CLASSES = {"gold": dict(priority=0, weight=4), "bronze": dict(priority=1, weight=1)}


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_class_preemption(chunk):
    jmodel, params, tmodel = _pair()
    bronze, gold = _trace(4, seed=2, klass="bronze"), _trace(3, seed=3, klass="gold")
    schedule = {0: bronze, 2: gold}
    kw = dict(slots=2, block_size=BS, min_bucket=4, prefill_chunk_tokens=chunk)
    jeng = jserve.ServeEngine(jmodel, params, clock=_FakeClock(), **kw, classes={
        k: jserve.ClassSpec(**v) for k, v in CLASSES.items()})
    teng = tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw, classes={
        k: tserve.ClassSpec(**v) for k, v in CLASSES.items()})
    _same(jeng, _drive(jeng, schedule), teng, _drive(teng, schedule))
    assert teng.metrics.class_preempted > 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_prefix_cache_on_and_off(kv_quant):
    preamble = np.random.default_rng(9).integers(0, V, 10).astype(np.int32)
    trace = _trace(8, seed=4, lens=(2, 8), budgets=(2, 8), prefix=preamble)
    schedule = {0: trace[:3], 4: trace[3:]}
    kw = dict(slots=3, block_size=BS, min_bucket=4, prefill_chunk_tokens=8,
              pool_blocks=14, kv_quant=kv_quant)
    jeng, jout, teng, tout = _both(schedule, prefix_cache=True, **kw)
    _same(jeng, jout, teng, tout)
    assert teng.prefix.stats() == jeng.prefix.stats()
    assert teng.prefix.stats()["hits"] > 0
    _, _, teng_off, tout_off = _both(schedule, **kw)
    for rid, c in tout_off.items():  # sharing on or off: the same tokens
        assert tout[rid].tokens == c.tokens, rid


def test_engine_drain_then_resubmit_the_snapshot():
    jmodel, params, tmodel = _pair()
    trace = _trace(8, seed=5)
    kw = dict(slots=3, block_size=BS, min_bucket=4, prefill_chunk_tokens=8, pool_blocks=12)
    uninterrupted = _drive(tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw), {0: trace})
    states = []
    for pkg, model, extra in ((jserve, jmodel, (params,)), (tserve, tmodel, ())):
        eng = pkg.ServeEngine(model, *extra, clock=_FakeClock(), **kw)
        for r in trace:
            eng.submit(r["prompt"], r["max_new_tokens"], rid=r["rid"], seed=r["seed"])
        for _ in range(6):
            eng.step()
        done = dict(eng.completions)
        state = eng.drain()
        assert eng.num_active == 0
        states.append((done, state))
    (jdone, jstate), (tdone, tstate) = states
    assert sorted(tdone) == sorted(jdone)
    assert tstate["emitted"] == jstate["emitted"]
    assert [r["rid"] for r in tstate["requests"] + tstate["queued"]] == \
        [r["rid"] for r in jstate["requests"] + jstate["queued"]]
    fresh = tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw)
    for st in tstate["requests"] + tstate["queued"]:
        r = tserve.Request.from_state(st)
        fresh.submit(r.prompt, r.max_new_tokens, rid=r.rid, seed=r.seed, tenant=r.tenant,
                     klass=r.klass)
    out = {**tdone, **fresh.run(max_steps=2000)}
    assert sorted(out) == sorted(uninterrupted)
    for rid, c in uninterrupted.items():
        assert out[rid].tokens == c.tokens, rid


def test_engine_fault_requeue_replays_exactly():
    _, _, tmodel = _pair()
    trace = _trace(5, seed=6)
    kw = dict(slots=2, block_size=BS, min_bucket=4)
    clean = _drive(tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw), {0: trace})
    from pytorch_distributed_example_tpu_torch import faults as tfaults

    tfaults.install_plan([{"point": "serve.step", "action": "reset", "after": 3}],
                         export_env=False)
    try:
        eng = tserve.ServeEngine(tmodel, clock=_FakeClock(), **kw)
        out = _drive(eng, {0: trace})
    finally:
        tfaults.clear_plan()
    assert eng.metrics.requeued > 0
    for rid, c in clean.items():
        assert out[rid].tokens == c.tokens


def _cache_state(c):
    return (list(c._free_blocks), c._refcount.tolist(), c.block_tables.tolist(),
            list(c._cached_blocks), sorted(c._indexed), c.cow_copies, list(c._free_slots))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_cache_bookkeeping_matches_the_reference(seed):
    jmodel, _, tmodel = _pair()
    gen = np.random.default_rng(seed)
    jc = jserve.PagedKVCache(jmodel, slots=4, num_blocks=14, block_size=BS)
    tc = tserve.PagedKVCache(tmodel, slots=4, num_blocks=14, block_size=BS)
    jix, tix = jserve.PrefixIndex(jc), tserve.PrefixIndex(tc)
    # distinct pool contents, so a copy-on-write that moves the wrong block
    # shows in the final comparison
    pool = {layer: {"attn": {name: gen.normal(size=buf.shape).astype(np.float32)
                             for name, buf in node["attn"].items()}}
            for layer, node in jax.tree.map(np.asarray, jc.tree).items()}
    jc.tree = jax.tree.map(jnp.asarray, pool)
    tc.tree = convert.cache_from_flax(pool)
    prompts = {}
    for _ in range(60):
        op = gen.integers(0, 6)
        active = tc.active_slots
        if op == 0:
            s = tc.allocate()
            assert jc.allocate() == s
            if s is not None:
                prompts[s] = []
        elif op == 1 and active:
            s = int(gen.choice(active))
            pos = int(gen.integers(0, M))
            assert tc.ensure_blocks(s, pos) == jc.ensure_blocks(s, pos)
        elif op == 2 and active:
            s = int(gen.choice(active))
            pos = int(gen.integers(0, M))
            assert tc.cow_block(s, pos) == jc.cow_block(s, pos)
        elif op == 3 and active:
            s = int(gen.choice(active))
            tc.free(s), jc.free(s)
        elif op == 4 and active:  # index a slot's blocks under a prompt
            s = int(gen.choice(active))
            n = len(tc.slot_blocks(s)) * BS
            if n:
                toks = gen.integers(0, 3, n).tolist()
                prompts[s] = toks
                assert tix.insert("t", toks, tc.slot_blocks(s)) == \
                    jix.insert("t", toks, jc.slot_blocks(s))
        elif op == 5:  # a fresh slot attaches a matched prefix
            s = tc.allocate()
            assert jc.allocate() == s
            if s is not None:
                toks = gen.integers(0, 3, 12).tolist()
                tb, tm = tix.match("t", toks)
                jb, jm = jix.match("t", toks)
                assert (tb, tm) == (jb, jm)
                if tm:
                    tc.attach_prefix(s, tb), jc.attach_prefix(s, jb)
        assert _cache_state(tc) == _cache_state(jc)
    got = convert.cache_to_flax(tc.tree)
    for layer, node in jax.tree.map(np.asarray, jc.tree).items():
        for name, want in node["attn"].items():
            np.testing.assert_array_equal(got[layer]["attn"][name], want)
    for attr in ("free_blocks", "live_blocks", "shared_blocks", "bytes_deduplicated",
                 "pool_utilization", "bytes_per_block", "dense_bytes_per_request",
                 "effective_slots", "wire_dtype"):
        assert getattr(tc, attr) == getattr(jc, attr), attr


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_cache_accounting_leaves_out_the_sink(quantized):
    jmodel, _, tmodel = _pair()
    jc = jserve.PagedKVCache(jmodel, slots=2, num_blocks=9, block_size=BS, quantized=quantized)
    tc = tserve.PagedKVCache(tmodel, slots=2, num_blocks=9, block_size=BS, quantized=quantized)
    for attr in ("num_blocks", "free_blocks", "bytes_per_block", "scale_bytes_per_block",
                 "wire_dtype", "effective_slots", "pool_utilization"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert tc.tree["layers_0"]["attn"]["k"].shape[0] == 10  # the sink


def test_export_import_blocks_round_trip():
    _, _, tmodel = _pair()
    src = tserve.PagedKVCache(tmodel, slots=1, num_blocks=8, block_size=BS, quantized=True)
    for buf in (b for n in src.tree.values() for b in n["attn"].values()):
        buf.copy_(torch.arange(buf.numel()).reshape(buf.shape).to(buf.dtype))
    payload = src.export_blocks([3, 1])
    dst = tserve.PagedKVCache(tmodel, slots=1, num_blocks=8, block_size=BS, quantized=True)
    dst.import_blocks([0, 5], payload)
    for layer, node in dst.tree.items():
        for name, buf in node["attn"].items():
            want = src.tree[layer]["attn"][name]
            assert torch.equal(buf[0], want[3]) and torch.equal(buf[5], want[1])


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.9, 5)])
def test_slot_programs_match_the_reference(temperature, top_k):
    jmodel, params, tmodel = _pair()
    p = params["params"]
    jpre, jwrite, jstep = jdecode.slot_programs(jmodel, temperature, top_k)
    tpre, twrite, tstep = tdecode.slot_programs(tmodel, temperature, top_k)
    S = 3
    jtree = jserve.SlotKVCache(jmodel, S).tree
    ttree = tserve.SlotKVCache(tmodel, S).tree
    jl, jt, jr = jnp.zeros(S, jnp.int32), jnp.zeros(S, jnp.int32), jnp.zeros((S, 2), jnp.uint32)
    tl, tt, tr = torch.zeros(S, dtype=torch.int32), torch.zeros(S, dtype=torch.int32), \
        torch.zeros(S, 2, dtype=torch.int64)
    for slot, (L, seed) in enumerate([(5, 3), (9, 4), (2, 5)]):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :L] = np.random.default_rng(seed).integers(0, V, L)
        jc, jlog, jfirst, jkey = jpre(p, jnp.asarray(padded), L, seed)
        tc, tlog, tfirst, tkey = tpre(torch.as_tensor(padded), L, seed)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(jlog)).max())
        assert int(tfirst) == int(jfirst)
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
        jtree, jl, jt, jr = jwrite(jtree, jl, jt, jr, jc, slot, L, jfirst, jkey)
        ttree, tl, tt, tr = twrite(ttree, tl, tt, tr, tc, slot, L, tfirst, tkey)
    for _ in range(4):
        jtree, jl, jt, jr = jstep(p, jtree, jl, jt, jr)
        ttree, tl, tt, tr = tstep(ttree, tl, tt, tr)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_carry_key_matches_the_reference():
    for seed in (0, 7, 12345):
        np.testing.assert_array_equal(tdecode.carry_key(seed).numpy(),
                                      np.asarray(jdecode.carry_key(seed)))


def test_parked_lane_writes_land_in_the_sink():
    # a retired lane parks at M - 1 with an all-invalid table row: its
    # step must leave every real block as it was
    _, _, tmodel = _pair()
    c = tserve.PagedKVCache(tmodel, slots=2, num_blocks=8, block_size=BS)
    prefill_chunk, _, _, step = tdecode.paged_programs(tmodel, 0.0, None)
    before = {k: v.clone() for k, v in c.tree["layers_0"]["attn"].items()}
    lanes = (torch.tensor([M - 1, M - 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
             torch.zeros(2, 2, dtype=torch.int64))
    step(c.tree, *lanes, c.block_tables)
    for k, v in c.tree["layers_0"]["attn"].items():
        assert torch.equal(v[:-1], before[k][:-1])


# a driver-mode mesh over distinct devices: tp ranks on distinct devices
# are a multiproc mesh (tests/test_torch_serve_tp_multiproc.py serves one)
_SPREAD = DeviceMesh(["cpu", "meta"], (2,), ("tp",))


@pytest.mark.parametrize("kw,err,match", [
    pytest.param(dict(mesh=_SPREAD), ValueError, "multiproc mesh",
                 id="kw0-ValueError-multiproc mesh"),
    pytest.param(dict(role="prefill", mesh=_SPREAD), ValueError, "multiproc mesh",
                 id="kw2-ValueError-multiproc mesh"),
    pytest.param(dict(role="bogus"), ValueError, "role", id="kw4-ValueError-role"),
])
def test_unported_engine_options_raise(kw, err, match):
    _, _, tmodel = _pair()
    with pytest.raises(err, match=match):
        tserve.ServeEngine(tmodel, **kw)


# precompiled= (serve/prewarm.py's table) warms at construction and leaves
# the engine serving as a cold one: the same tokens as generate()
_TABLE = {("prefill_chunk", 8): {}, ("first_token", 8): {}, ("attach", 2): {},
          ("step", 2): {}, ("step", 7): {}}


@pytest.mark.parametrize("kw", [dict(), dict(role="decode")], ids=["both", "decode"])
def test_precompiled_engine_option_warms(kw):
    _, _, tmodel = _pair()
    eng = tserve.ServeEngine(tmodel, slots=2, block_size=BS, min_bucket=8,
                             precompiled=_TABLE, **kw)
    assert set(eng.prewarm_timings) == {("prefill_chunk", 8), ("first_token", 8),
                                        ("attach", 2), ("step", 2)}
    assert all(t >= 0.0 for t in eng.prewarm_timings.values())
    if kw:
        return
    cold = tserve.ServeEngine(tmodel, slots=2, block_size=BS, min_bucket=8)
    for e in (eng, cold):
        for r in _trace(4, seed=3):
            e.submit(r["prompt"], r["max_new_tokens"], rid=r["rid"], seed=r["seed"])
    got = {r: c.tokens for r, c in eng.run(max_steps=200).items()}
    assert got == {r: c.tokens for r, c in cold.run(max_steps=200).items()}


def test_submit_validation_matches_the_reference():
    jmodel, params, tmodel = _pair()
    for eng in (jserve.ServeEngine(jmodel, params, slots=2, block_size=BS, pool_blocks=8),
                tserve.ServeEngine(tmodel, slots=2, block_size=BS, pool_blocks=8)):
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.zeros(0, np.int32), 2)
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            eng.submit(np.zeros(30, np.int32), 3)


def test_engine_runs_on_the_models_device():
    _, _, tmodel = _pair()
    eng = tserve.ServeEngine(tmodel, slots=2, block_size=BS)
    assert eng._dev_lengths.device == eng.cache.tree["layers_0"]["attn"]["k"].device == \
        next(tmodel.parameters()).device


def test_step_contract_is_token_exact():
    from pytorch_distributed_example_tpu_torch.numerics import contract_of

    assert contract_of(tserve.ServeEngine.step)["tier"] == "token_exact"


# -- the reference's own cases on the port's copies ---------------------------

PACKAGES = {"reference": jserve, "port": tserve}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_bucketing(pkg):
    s = PACKAGES[pkg]
    bs = s.bucket_lengths(48, min_bucket=8)
    assert bs == (8, 16, 32, 48)
    assert s.bucket_for(5, bs) == 8 and s.bucket_for(16, bs) == 16
    assert s.bucket_for(33, bs) == 48
    with pytest.raises(ValueError, match="exceeds"):
        s.bucket_for(49, bs)
    assert s.bucket_lengths(64, min_bucket=16) == (16, 32, 64)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_percentile(pkg):
    percentile = {"reference": jmetrics, "port": tmetrics}[pkg].percentile
    assert percentile([], 99) == 0.0
    assert percentile([3.0], 50) == 3.0
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 99) == pytest.approx(99.01)


def _req(s, klass="", rid=""):
    r = s.Request(prompt=np.ones(4, np.int32), max_new_tokens=2, rid=rid, klass=klass)
    r.arrival_time = 0.0
    return r


def _classes(s):
    return {"gold": s.ClassSpec(priority=0, weight=6, ttft_slo_s=1.0),
            "silver": s.ClassSpec(priority=1, weight=3),
            "bronze": s.ClassSpec(priority=2, weight=1)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_queue_swrr_and_shed(pkg):
    s = PACKAGES[pkg]
    q = s.RequestQueue(classes=_classes(s))
    for i in range(30):
        for k in ("gold", "silver", "bronze"):
            q.put(_req(s, k, f"{k[0]}{i}"))
    first20 = [q.pop().rid for _ in range(20)]
    assert [sum(r.startswith(k) for r in first20) for k in "gsb"] == [12, 6, 2]
    q = s.RequestQueue(max_depth=3, classes=_classes(s))
    for k, rid in (("bronze", "b0"), ("bronze", "b1"), ("silver", "s0")):
        q.put(_req(s, k, rid))
    assert q.put(_req(s, "gold", "g0")).rid == "b1"
    with pytest.raises(s.QueueFullError):
        q.put(_req(s, "bronze", "b2"))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_queue_requeue_and_state(pkg):
    s = PACKAGES[pkg]
    q = s.RequestQueue(max_depth=1, classes=_classes(s))
    q.put(_req(s, "bronze", "b0"))
    q.requeue_front(_req(s, "bronze", "i0"))
    assert q.depth == 2
    assert q.put(_req(s, "gold", "g0")).rid == "b0"
    assert sorted(q.pop().rid for _ in range(2)) == ["g0", "i0"]
    r = _req(s, "gold", "x")
    r.tenant, r.seed, r.requeues = "acme", 17, 2
    r2 = s.Request.from_state(r.to_state())
    assert (r2.rid, r2.klass, r2.tenant, r2.seed, r2.requeues) == ("x", "gold", "acme", 17, 2)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_copy_prefix_index(pkg):
    s = PACKAGES[pkg]
    jmodel, _, tmodel = _pair()
    c = s.PagedKVCache(jmodel if pkg == "reference" else tmodel, slots=4, num_blocks=16,
                       block_size=BS)
    ix = s.PrefixIndex(c)
    toks = list(range(1, 11))  # 2 full blocks + a tail of 2
    slot = c.allocate()
    c.ensure_blocks(slot, len(toks) - 1)
    blocks = c.slot_blocks(slot)
    assert ix.insert("t", toks, blocks) == 3
    assert ix.match("t", toks) == (blocks, 9)
    assert ix.match("t", toks + [11, 12]) == (blocks, 10)
    assert ix.match("t", [1, 2, 3, 4, 5, 6, 99, 98]) == (blocks[:2], 6)
    assert ix.match("u", toks) == ([], 0)
    st = ix.stats()
    assert (st["hits"], st["misses"]) == (3, 1)


def test_prng_keys_ride_the_lanes_as_int64():
    # the engine's rng lanes hold uint32 values in int64, as prng's keys
    _, _, tmodel = _pair()
    eng = tserve.ServeEngine(tmodel, slots=2, block_size=BS, temperature=1.0)
    eng.submit(np.arange(5, dtype=np.int32), 3, seed=11)
    eng.run(max_steps=50)
    assert eng._dev_rngs.dtype == torch.int64
    assert int(eng._dev_rngs.max()) <= 0xFFFFFFFF and int(eng._dev_rngs.min()) >= 0
    assert prng.PRNGKey(11).tolist() == [0, 11]
