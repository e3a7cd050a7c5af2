"""The port's disaggregated serving against the JAX package's, on the CPU.

A tiny float32 model (vocab 64, d 32, 2 layers, 4 heads, max_seq_len 32),
the reference's params carried across by `from_flax`. The reference's
colocated engine gives the completions; the port's `DisaggRouter` (prefill
pool -> KV migration through a `HashStore` -> decode pool) must give them
token for token, greedy, sampled and int8, through capacity refusals,
decode-pool preemption, migration faults, a crashed gang and pool scaling,
with the pools at TP 1 or 2 (driver mode). Then the migration plane's
three moves (publish byte for byte again, refuse a torn publication,
reclaim chunks without a manifest), the raw bf16 payload encoding, and
`plan/transfer.py` against the reference's plans.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import faults as jfaults
from pytorch_distributed_example_tpu import plan as jplan
from pytorch_distributed_example_tpu import serve as jserve
from pytorch_distributed_example_tpu.serve import disagg as jdisagg
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch import plan as tplan
from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.serve.disagg import (
    DisaggRouter,
    gc_migration,
    migrate,
    migrate_request,
    pending_rids,
    recv_migration,
    send_handoff,
)
from pytorch_distributed_example_tpu_torch.store import HashStore

V = 64


@functools.lru_cache(maxsize=None)
def _pair():
    kw = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, max_seq_len=32, use_flash=False)
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(autouse=True)
def no_fault_plan():
    for f in (faults, jfaults):
        f.clear_plan()
    yield
    for f in (faults, jfaults):
        f.clear_plan()


def _prompts(*lens, seed=0):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, V, (n,)).astype(np.int32) for n in lens]


def _jobs(prompts, budget=5, seed0=11):
    return [(f"r{i}", p, budget, seed0 + i) for i, p in enumerate(prompts)]


def _defaults(kw):
    kw = dict(kw)
    kw.setdefault("slots", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("pool_blocks", 64)
    kw.setdefault("prefill_chunk_tokens", 8)
    return kw


@functools.lru_cache(maxsize=None)
def _reference(lens, budget=5, **kw):
    """The reference's colocated completions for `_jobs(_prompts(*lens))`."""
    jmodel, params, _ = _pair()
    eng = jserve.ServeEngine(jmodel, params, role="both", **_defaults(kw))
    for rid, p, b, seed in _jobs(_prompts(*lens), budget):
        eng.submit(p, b, rid=rid, seed=seed)
    eng.run(max_steps=4096)
    return {rid: c.tokens for rid, c in eng.completions.items()}


def _engine(role="both", tp=1, **kw):
    _, _, tmodel = _pair()
    mesh = DeviceMesh(["cpu"] * tp, (tp,), ("tp",)) if tp > 1 else None
    return tserve.ServeEngine(tmodel, role=role, mesh=mesh, **_defaults(kw))


def _disagg(store=None, prefill=1, decode=1, p_tp=1, d_tp=1, decode_kw=None, **kw):
    d_kw = dict(kw, **(decode_kw or {}))
    return DisaggRouter(
        store if store is not None else HashStore(),
        lambda i: _engine("prefill", p_tp, **kw),
        lambda i: _engine("decode", d_tp, **d_kw),
        prefill_replicas=prefill, decode_replicas=decode, chunk_blocks=2,
    )


def _run(router, jobs):
    for rid, p, b, seed in jobs:
        router.submit(p, b, rid=rid, seed=seed)
    return {rid: c.tokens for rid, c in router.run(max_steps=4096).items()}


# -- parity with the reference's colocated engine -----------------------------

PARITY = {
    "greedy_2x2": dict(prefill=2, decode=2),
    "sampled_2x2": dict(prefill=2, decode=2, temperature=0.8, top_k=8),
    "kv_quant": dict(kv_quant=True),
    "kv_quant_2x2": dict(prefill=2, decode=2, kv_quant=True),
    "prefill_tp2": dict(p_tp=2),
    "decode_tp2_kv_quant": dict(d_tp=2, kv_quant=True),
    "tp2_both_sampled": dict(p_tp=2, d_tp=2, temperature=0.8, top_k=8),
}
ENGINE_KW = ("temperature", "top_k", "kv_quant")


@pytest.mark.parametrize("case", sorted(PARITY))
def test_disagg_matches_reference_colocated(case):
    kw = PARITY[case]
    lens = (5, 9, 13, 7) if "2x2" in case else (5, 9, 13)
    jobs = _jobs(_prompts(*lens))
    ref = _reference(lens, **{k: v for k, v in kw.items() if k in ENGINE_KW})
    router = _disagg(**kw)
    assert _run(router, jobs) == ref
    assert router.migrations == len(jobs)


def test_decode_capacity_refusal_retries_until_landed():
    lens = (5, 9, 13)
    router = _disagg(decode_kw=dict(slots=1))
    assert _run(router, _jobs(_prompts(*lens))) == _reference(lens)
    assert router.migration_retries > 0


def test_decode_preemption_replays_through_prefill():
    # finals 21 and 25 tokens -> 6 + 7 blocks in a pool of 8: the migrants
    # overlap in decode and one runs out of pool
    lens = (9, 13)
    jobs = _jobs(_prompts(*lens), budget=12)
    store = HashStore()
    router = _disagg(store=store, decode_kw=dict(pool_blocks=8))
    assert _run(router, jobs) == _reference(lens, budget=12)
    assert router.replays > 0
    assert router.migrations > len(jobs)  # the replay migrated again
    assert pending_rids(store, [j[0] for j in jobs]) == []


def test_completion_metrics_span_pools():
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]

    router = DisaggRouter(HashStore(), lambda i: _engine("prefill", clock=clock),
                          lambda i: _engine("decode", clock=clock), clock=clock)
    (prompt,) = _prompts(9)
    router.submit(prompt, 5, rid="r0", seed=1)
    t_submit = t[0]
    comp = router.run(max_steps=4096)["r0"]
    assert 0 < comp.ttft_s < comp.e2e_s <= t[0] - t_submit + 0.011


def test_mis_roled_factories_rejected():
    with pytest.raises(ValueError, match="prefill"):
        DisaggRouter(HashStore(), lambda i: _engine("both"), lambda i: _engine("decode"))
    with pytest.raises(ValueError, match="decode"):
        DisaggRouter(HashStore(), lambda i: _engine("prefill"), lambda i: _engine("both"))


@pytest.mark.parametrize("point", ["serve.migrate.send", "serve.migrate.recv"])
def test_transient_migration_fault_absorbed_token_exact(point):
    lens = (5, 9)
    faults.install_plan([{"point": point, "action": "reset", "times": 2}], export_env=False)
    router = _disagg()
    got = _run(router, _jobs(_prompts(*lens)))
    assert got == _reference(lens)
    assert router.migration_retries >= 1


def test_crash_mid_migration_reforms_token_exact():
    lens = (5, 9, 13)
    jobs = _jobs(_prompts(*lens))
    rids = [j[0] for j in jobs]
    store = HashStore()
    faults.install_plan([{"point": "serve.migrate.recv", "action": "reset", "times": -1}],
                        export_env=False)
    doomed = _disagg(store=store)
    for rid, p, b, seed in jobs:
        doomed.submit(p, b, rid=rid, seed=seed)
    for _ in range(64):
        doomed.step()
    assert pending_rids(store, rids) and doomed.migrations == 0
    faults.clear_plan()
    del doomed
    reformed = _disagg(store=store)
    assert _run(reformed, jobs) == _reference(lens)
    assert pending_rids(store, rids) == []


def test_scale_faults_are_pool_tagged():
    router = _disagg()
    faults.install_plan([{"point": "serve.scale_out", "action": "reset", "times": 1}],
                        export_env=False)
    with pytest.raises(ConnectionResetError):
        router.prefill.add_replica()
    router.decode.add_replica()
    assert (router.prefill.num_replicas, router.decode.num_replicas) == (1, 2)


@pytest.mark.parametrize("pool", ["decode", "prefill"])
def test_pool_scaling_mid_flight_token_exact(pool):
    lens = (5, 9, 13, 7) if pool == "decode" else (5, 9, 13, 7, 6, 8)
    budget = 6 if pool == "decode" else 5
    jobs = _jobs(_prompts(*lens), budget=budget)
    router = _disagg(decode=2 if pool == "decode" else 1)
    for rid, p, b, seed in jobs:
        router.submit(p, b, rid=rid, seed=seed)
    if pool == "decode":
        for _ in range(8):
            router.step()
        victim = router.decode.remove_replica()
    else:
        router.prefill.add_replica()
        for _ in range(4):
            router.step()
        victim = router.prefill.remove_replica()
    got = {rid: c.tokens for rid, c in router.run(max_steps=4096).items()}
    assert got == _reference(lens, budget=budget)
    evs = [e for e in getattr(router, pool).events if e.kind == "remove"]
    assert evs and evs[0].replica_id == victim
    with pytest.raises(ValueError, match="last"):
        getattr(router, pool).remove_replica()


def test_pool_windows_carry_their_own_signal():
    classes = {"": tserve.ClassSpec(priority=0, ttft_slo_s=60.0, tpot_slo_s=60.0)}
    jobs = _jobs(_prompts(5, 9))
    router = _disagg(classes=classes)
    _run(router, jobs)
    pre = router.prefill.window_view(window_s=1e9)["classes"][""]
    dec = router.decode.window_view(window_s=1e9)["classes"][""]
    assert (pre["slo_n"], pre["tpot_slo_n"]) == (len(jobs), 0)
    assert dec["tpot_slo_n"] == len(jobs) and dec["tpot_attainment"] == 1.0


# -- the migration plane -------------------------------------------------------


def _handoff(eng, prompt, budget=5, seed=3, rid="m0"):
    eng.submit(prompt, budget, rid=rid, seed=seed)
    for _ in range(64):
        eng.step()
        hs = eng.pop_handoffs()
        if hs:
            return hs[0]
    raise AssertionError("prefill never froze a handoff")


@pytest.mark.parametrize("src_tp,dst_tp", [(1, 1), (2, 1), (1, 2)])
def test_send_recv_roundtrip_token_exact(src_tp, dst_tp):
    (prompt,) = _prompts(9)
    jmodel, params, _ = _pair()
    jeng = jserve.ServeEngine(jmodel, params, **_defaults({}))
    jeng.submit(prompt, 5, rid="m0", seed=3)
    want = jeng.run(max_steps=64)["m0"].tokens
    store = HashStore()
    src, dst = _engine("prefill", src_tp), _engine("decode", dst_tp)
    h = _handoff(src, prompt)
    n = send_handoff(store, src, h, prefill_world=src_tp, decode_world=dst_tp, chunk_blocks=2)
    assert n >= 1 and store.check(["serve/migrate/m0"])
    slot = recv_migration(store, "m0", dst)
    assert slot is not None
    # the landed blocks are the prefill pool's, bit for bit, whatever the TPs
    got = dst.cache.export_blocks(dst.cache.slot_blocks(slot))
    sent = src.cache.export_blocks(src.cache.slot_blocks(h.slot))
    for layer in sent:
        for name, t in sent[layer]["attn"].items():
            assert torch.equal(got[layer]["attn"][name], t), (layer, name)
    src.release_handoff(h)
    assert gc_migration(store, "m0") == n + 1
    assert not store.check(["serve/migrate/m0"])
    dst.run(max_steps=64)
    assert dst.completions["m0"].tokens == want
    assert src.cache.active_slots == []


def test_manifest_is_the_references():
    # the same handoff published by both packages: the manifests agree
    # key for key, the plan fingerprint included, and the chunk keys too
    (prompt,) = _prompts(9)
    jmodel, params, _ = _pair()
    stores = {}
    for pkg, eng in (("ref", jserve.ServeEngine(jmodel, params, role="prefill",
                                                **_defaults({}))),
                     ("port", _engine("prefill"))):
        h = _handoff(eng, prompt)
        h.req.first_token_time = 1.5  # clocks differ; the stamp rides as given
        store = HashStore()
        (jdisagg.send_handoff if pkg == "ref" else send_handoff)(store, eng, h, chunk_blocks=2)
        stores[pkg] = store
    want = json.loads(stores["ref"].get("serve/migrate/m0"))
    got = json.loads(stores["port"].get("serve/migrate/m0"))
    want["req"].pop("arrival_time")
    got["req"].pop("arrival_time")
    assert got == want
    for i in range(got["n_chunks"]):
        assert stores["port"].check([f"serve/migrate/m0/chunk{i}"])
        head = lambda s: json.loads(s.get(f"serve/migrate/m0/chunk{i}").partition(b"\n")[0])
        assert {k: v for k, v in head(stores["port"]).items() if k not in ("crc32", "size")} \
            == {k: v for k, v in head(stores["ref"]).items() if k not in ("crc32", "size")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_republication_is_byte_identical(dtype):
    _, _, tmodel = _pair()
    if dtype == "bfloat16":
        model = ttr.TransformerLM(dataclasses.replace(tmodel.cfg, dtype=torch.bfloat16),
                                  device="cpu")
        model.load_state_dict(tmodel.state_dict())
        src = tserve.ServeEngine(model, role="prefill", **_defaults({}))
    else:
        src = _engine("prefill", kv_quant=dtype == "int8")
    (prompt,) = _prompts(9)
    store = HashStore()
    h = _handoff(src, prompt)
    n = send_handoff(store, src, h, chunk_blocks=2)
    keys = ["serve/migrate/m0"] + [f"serve/migrate/m0/chunk{i}" for i in range(n)]
    before = {k: store.get(k) for k in keys}
    assert send_handoff(store, src, h, chunk_blocks=2) == n
    assert {k: store.get(k) for k in keys} == before
    # and the chunks carry the pool's own bytes
    payload = src.cache.export_blocks(src.cache.slot_blocks(h.slot))
    landed = {}
    for i in range(n):
        meta, blob = migrate._unseal_chunk(store.get(f"serve/migrate/m0/chunk{i}"))
        landed[meta["off"]] = migrate._unpack_tree(blob)
    for name, t in payload["layers_1"]["attn"].items():
        joined = torch.cat([landed[o]["layers_1"]["attn"][name] for o in sorted(landed)])
        assert joined.dtype == t.dtype and torch.equal(joined, t), name


def test_raw_words_keep_bfloat16_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": {"k": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
                  "k_scale": torch.rand(3, generator=gen)},
            "b": torch.arange(6, dtype=torch.int8)}
    blob = migrate._pack_tree(tree)
    assert blob == migrate._pack_tree(tree)
    back = migrate._unpack_tree(blob)
    assert back["a"]["k"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["k"].view(torch.int16), tree["a"]["k"].view(torch.int16))
    assert torch.equal(back["a"]["k_scale"], tree["a"]["k_scale"])
    assert torch.equal(back["b"], tree["b"])


def test_recv_refuses_torn_publication():
    (prompt,) = _prompts(9)
    store = HashStore()
    src, dst = _engine("prefill"), _engine("decode")
    assert recv_migration(store, "m0", dst) is None  # no manifest yet
    h = _handoff(src, prompt)
    n = send_handoff(store, src, h, chunk_blocks=2)
    store.delete_key("serve/migrate/m0/chunk0")
    assert recv_migration(store, "m0", dst) is None
    assert dst.cache.active_slots == []  # nothing mutated
    assert gc_migration(store, "m0") == n  # n - 1 chunks + the manifest
    assert not store.check(["serve/migrate/m0"])


def test_gc_reclaims_chunks_without_manifest():
    (prompt,) = _prompts(13)
    store = HashStore()
    src = _engine("prefill")
    h = _handoff(src, prompt)
    n = send_handoff(store, src, h, chunk_blocks=2)
    store.delete_key("serve/migrate/m0")
    assert pending_rids(store, ["m0"]) == []
    assert gc_migration(store, "m0") == n
    assert not store.check(["serve/migrate/m0/chunk0"])


def test_release_handoff_ignores_stale_records():
    (prompt,) = _prompts(9)
    src = _engine("prefill")
    h = _handoff(src, prompt)
    src.requeue_inflight()  # the record went stale
    before = src.cache.free_blocks
    src.release_handoff(h)
    assert src.cache.free_blocks == before


def test_migrate_request_refusal_keeps_payload_and_slot():
    (prompt,) = _prompts(9)
    store = HashStore()
    src, dst = _engine("prefill"), _engine("decode", slots=1)
    dst.cache.allocate()  # the only slot is taken
    h = _handoff(src, prompt)
    assert migrate_request(store, src, dst, h, chunk_blocks=2) is None
    assert store.check(["serve/migrate/m0"]) and src.cache.active_slots == [h.slot]
    from pytorch_distributed_example_tpu_torch.numerics import contract_of

    assert contract_of(migrate_request)["tier"] == "token_exact"


def test_decode_engine_admits_only_migrations():
    eng = _engine("decode")
    (prompt,) = _prompts(5)
    eng.submit(prompt, 3, rid="q")
    for _ in range(3):
        eng.step()
    assert eng.num_active == 0 and eng.queue.depth == 1
    with pytest.raises(Exception, match="prefill-pool"):
        _engine("prefill").attach_migrated(None, 1, 0, {})


# -- plan/transfer.py against the reference ------------------------------------

GRID = [(b, p, d, c) for b in (0, 1, 7, 16) for p in (1, 2, 3) for d in (1, 2, 4)
        for c in (1, 2, 4)]


@pytest.mark.parametrize("blocks,pw,dw,chunk", GRID[::3] + GRID[1::7])
def test_plan_fingerprint_and_spans_match_reference(blocks, pw, dw, chunk):
    a = tplan.schedule_migration(blocks, pw, dw, chunk_blocks=chunk)
    b = jplan.schedule_migration(blocks, pw, dw, chunk_blocks=chunk)
    assert a.fingerprint() == b.fingerprint()
    assert a.artifact() == b.artifact()
    assert list(tplan.chunk_spans(a)) == list(jplan.chunk_spans(b))


def test_transfer_plan_shape():
    plan = tplan.schedule_migration(10, 2, 3, chunk_blocks=4)
    assert (plan.op, plan.world, plan.topology_key) == ("kv_migrate", 5, "prefill2xdecode3")
    covered = []
    for _rnd, src, dst, off, n in tplan.chunk_spans(plan):
        assert 0 <= src < 2 and 2 <= dst < 5
        covered.extend(range(off, off + n))
    assert covered == list(range(10))
    by_round = {}
    for rnd, src, dst, _o, _n in tplan.chunk_spans(tplan.schedule_migration(16, 2, 3, 2)):
        by_round.setdefault(rnd, []).append((src, dst))
    assert len(by_round) == 4
    for links in by_round.values():
        assert len({s for s, _ in links}) == len(links) == len({d for _, d in links})
    assert tplan.schedule_migration(0, 1, 1).rounds == ()
    for bad in ((4, 0, 1), (4, 1, 1, 0), (-1, 1, 1)):
        with pytest.raises(ValueError):
            tplan.schedule_migration(*bad)


def test_frozen_slot_evicted_under_pressure_replays_through_prefill():
    # A (26 tokens, 7 blocks) and B (5 tokens) in a pool of 8 blocks: B
    # freezes first (shortest remaining), then A's growth evicts the
    # youngest, B's frozen slot; its handoff goes with it and B prefills
    # again once A's slot is released. The reference's engine does the same.
    a, b = _prompts(26, 5)
    jmodel, params, _ = _pair()
    kw = _defaults(dict(pool_blocks=8))
    logs = {}
    for pkg, eng in (("ref", jserve.ServeEngine(jmodel, params, role="prefill", **kw)),
                     ("port", _engine("prefill", pool_blocks=8))):
        eng.submit(a, 4, rid="A", seed=1)
        eng.submit(b, 4, rid="B", seed=2)
        for _ in range(8):
            eng.step()
        first = eng.pop_handoffs()
        log = [[h.req.rid for h in first], eng.metrics.preempted, eng.queue.depth]
        for h in first:
            eng.release_handoff(h)
        for _ in range(8):
            eng.step()
        again = eng.pop_handoffs()
        log.append([(h.req.rid, h.length, h.first) for h in again])
        logs[pkg] = log
    assert logs["port"] == logs["ref"]
    assert logs["port"][0] == ["A"] and logs["port"][1] >= 1
    assert [r for r, _, _ in logs["port"][3]] == ["B"]
