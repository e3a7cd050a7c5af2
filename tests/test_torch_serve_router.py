"""The port's replica router, autoscaler and serve-state checkpoints
against the JAX package's, on the CPU.

Both packages' `ServeRouter`s front engines over the same tiny float32
model (vocab 64, d 32, 2 layers, 4 heads, max_seq_len 32; the reference's
params carried across by `from_flax`) on the same fake clock and the same
scale script: routing (prefix-scope affinity and its rebalancing), scale
in and out, `lose_replica` replay and the sealed drain snapshots must
agree, replica for replica and token for token. The `Autoscaler` replays
a seeded open-loop trace (`benchmarks/load_harness.py`) on both and must
log the same decisions, and a scripted stub holds its controller edges.
The checkpoints (`serve/elastic.py`) are byte for byte the reference's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.load_harness import make_trace, replay
from pytorch_distributed_example_tpu import faults as jfaults
from pytorch_distributed_example_tpu import serve as jserve
from pytorch_distributed_example_tpu import store as jstore
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.serve import autoscale as jautoscale
from pytorch_distributed_example_tpu.serve import elastic as jelastic
from pytorch_distributed_example_tpu.serve import router as jrouter
from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch import store as tstore
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.serve import autoscale as tautoscale
from pytorch_distributed_example_tpu_torch.serve import elastic as telastic
from pytorch_distributed_example_tpu_torch.serve import router as trouter

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


PKG = {
    "ref": dict(serve=jserve, router=jrouter, elastic=jelastic, autoscale=jautoscale,
                store=jstore, faults=jfaults),
    "port": dict(serve=tserve, router=trouter, elastic=telastic, autoscale=tautoscale,
                 store=tstore, faults=faults),
}


def _classes(pkg):
    spec = PKG[pkg]["serve"].ClassSpec
    return {"gold": spec(priority=0, weight=4, ttft_slo_s=1.0), "bronze": spec(priority=1, weight=1)}


def _router(pkg, t, replicas=1, store=None, **kw):
    jmodel, params, tmodel = _pair()
    mod = PKG[pkg]["serve"]
    classes = _classes(pkg)

    def factory(rid):
        metrics = mod.ServeMetrics(clock=lambda: t[0], slots=2, classes=classes, window_s=10.0)
        args = (jmodel, params) if pkg == "ref" else (tmodel,)
        return mod.ServeEngine(*args, slots=2, min_bucket=4, classes=classes,
                               clock=lambda: t[0], prefix_cache=True, metrics=metrics)

    return PKG[pkg]["router"].ServeRouter(factory, replicas=replicas, classes=classes,
                                          clock=lambda: t[0], store=store, **kw)


def _prompts(*lens, seed=0):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, V, (n,)).astype(np.int32) for n in lens]


def _homes(r):
    return {rid: rep for rid, (rep, _) in r._outstanding.items()}


def _drain(r, t):
    while r.step():
        t[0] += 0.5
    return {k: v.tokens for k, v in r.completions.items()}


def _affinity(pkg):
    t = [0.0]
    r = _router(pkg, t, replicas=3)
    p = _prompts(5, 5, 5, 5)
    for i in range(4):
        r.submit(p[i], 2, rid=f"a{i}", tenant="acme", klass="gold")
        r.submit(p[i], 2, rid=f"b{i}", tenant="bobco", klass="gold")
    homes = _homes(r)
    return dict(homes=homes, out=_drain(r, t), rebinds=r.rebinds)


def _rebalance(pkg):
    t = [0.0]
    r = _router(pkg, t, replicas=1, rebalance_backlog=3)
    p = _prompts(*([5] * 12))
    for i in range(6):
        r.submit(p[i], 4, rid=f"x{i}", tenant="acme", klass="bronze")
    r.add_replica()
    for i in range(6, 12):
        r.submit(p[i], 4, rid=f"x{i}", tenant="acme", klass="bronze")
    homes = _homes(r)
    return dict(homes=homes, rebinds=r.rebinds, out=_drain(r, t))


def _scale_in(pkg):
    t = [0.0]
    store = PKG[pkg]["store"].HashStore(timeout=1.0)
    r = _router(pkg, t, replicas=2, store=store)
    prompts, budgets = _prompts(5, 6, 4, 7, 5, 6), [4, 5, 3, 4, 5, 3]
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        r.submit(p, b, rid=f"r{i}", seed=i, tenant=f"ten{i % 2}", klass="gold")
    for _ in range(2):
        r.step()
        t[0] += 0.5
    victim = r.remove_replica()
    blob = store.get(f"serve/replica{victim}/gen1")
    state, gen = PKG[pkg]["elastic"].load_serve_state(store, key_prefix=f"serve/replica{victim}")
    for d in state["requests"] + state["queued"]:
        d.pop("arrival_time")  # the clocks are the same; the float's bytes are not compared
    return dict(victim=victim, homes=_homes(r), state=state, gen=gen, blob_len=len(blob),
                out=_drain(r, t), events=[(e.kind, e.replica_id, e.replicas_after)
                                          for e in r.events],
                chip_seconds=r.chip_seconds)


def _lose(pkg):
    t = [0.0]
    r = _router(pkg, t, replicas=2)
    prompts, budgets = _prompts(5, 6, 4, 7, 5, 6), [4, 5, 3, 4, 5, 3]
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        r.submit(p, b, rid=f"r{i}", seed=i, tenant=f"ten{i % 2}", klass="gold")
    for _ in range(2):
        r.step()
        t[0] += 0.5
    lost = r.replica_ids()[0]
    moved = r.lose_replica(lost)
    homes = _homes(r)
    out = _drain(r, t)
    assert all(rep in r.replica_ids() for rep in r._affinity.values())
    return dict(moved=moved, homes=homes, out=out, ids=r.replica_ids(),
                window=r.window_view(window_s=100.0)["classes"]["gold"]["completed"])


SCENARIOS = {"affinity": _affinity, "rebalance": _rebalance, "scale_in": _scale_in,
             "lose_replica": _lose}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_matches_reference(name):
    want, got = SCENARIOS[name]("ref"), SCENARIOS[name]("port")
    assert got == want
    if name == "rebalance":
        assert got["rebinds"] >= 1 and len(set(got["homes"].values())) == 2
    if name == "affinity":
        assert len({got["homes"][f"a{i}"] for i in range(4)}) == 1


def test_scale_in_and_lose_are_token_exact_against_one_engine():
    _, _, tmodel = _pair()
    eng = tserve.ServeEngine(tmodel, slots=2, min_bucket=4, classes=_classes("port"))
    for i, (p, b) in enumerate(zip(_prompts(5, 6, 4, 7, 5, 6), [4, 5, 3, 4, 5, 3])):
        eng.submit(p, b, rid=f"r{i}", seed=i, klass="gold")
    want = {k: v.tokens for k, v in eng.run(max_steps=800).items()}
    assert _scale_in("port")["out"] == want
    assert _lose("port")["out"] == want


@pytest.mark.parametrize("point,op", [("serve.scale_out", "add_replica"),
                                      ("serve.scale_in", "remove_replica")])
def test_scale_fault_points_fire_where_the_references_do(point, op):
    outcomes = {}
    for pkg in ("ref", "port"):
        t = [0.0]
        r = _router(pkg, t, replicas=2)
        for i, p in enumerate(_prompts(5, 6, 4)):
            r.submit(p, 3, rid=f"r{i}", seed=i, tenant=f"ten{i}", klass="gold")
        r.step()
        PKG[pkg]["faults"].install_plan([{"point": point, "action": "reset", "times": 1}],
                                        export_env=False)
        with pytest.raises(ConnectionResetError):
            getattr(r, op)()
        assert r.num_replicas == 2  # the aborted resize left the gang as it was
        getattr(r, op)()  # the rule is spent: the retry goes through
        PKG[pkg]["faults"].clear_plan()
        outcomes[pkg] = (r.num_replicas, _drain(r, t))
    assert outcomes["port"] == outcomes["ref"]


# -- the autoscaler ------------------------------------------------------------


def _policy(pkg, **kw):
    base = dict(target_class="gold", queue_high=2.0, queue_low=0.5, occupancy_low=0.6,
                breach_polls=1, cooldown_out_s=0.5, cooldown_in_s=2.0, max_replicas=3)
    return PKG[pkg]["autoscale"].AutoscalePolicy(**dict(base, **kw))


def _swing(pkg):
    events = make_trace(3, 12.0, 8.0, 120, 3, V)
    t = [0.0]
    r = _router(pkg, t, replicas=1)
    a = PKG[pkg]["autoscale"].Autoscaler(r, _policy(pkg), clock=lambda: t[0], window_s=3.0)
    replay(events, r, t, 0.05, autoscaler=a, poll_every_s=0.25)
    snap = a.snapshot()
    return dict(decisions=snap["decisions"], resizes=snap["resizes"],
                events=[(e.kind, e.replica_id, e.replicas_after) for e in r.events],
                out={k: v.tokens for k, v in r.completions.items()})


def test_autoscaler_decision_log_matches_reference():
    want, got = _swing("ref"), _swing("port")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    kinds = {e[0] for e in got["events"]}
    assert "add" in kinds and "remove" in kinds


class _Stub:
    """Scripted window views and counted scale ops (the controller's
    contract surface)."""

    def __init__(self, views, replicas=2):
        self.views, self.i, self.n, self.adds, self.removes = views, 0, replicas, 0, 0

    def window_view(self, window_s=None, now=None):
        v = self.views[min(self.i, len(self.views) - 1)]
        self.i += 1
        return {"window_s": window_s or 5.0, "now": now, "replicas": self.n,
                "classes": {"gold": {"completed": 10, "shed": 0, "slo_met": 0, "slo_n": 0,
                                     "slo_attainment": v.get("att"),
                                     "tpot_attainment": v.get("tpot")}},
                "queue_depth_mean": v.get("q", 0.0) * self.n,
                "queue_depth_mean_per_replica": v.get("q", 0.0),
                "occupancy_mean": v.get("occ", 0.0), "pool_utilization_mean": 0.0}

    def add_replica(self):
        self.adds += 1
        self.n += 1

    def remove_replica(self):
        self.removes += 1
        self.n -= 1

    @property
    def num_replicas(self):
        return self.n


OK = {"att": 1.0, "q": 1.0, "occ": 0.7, "tpot": 1.0}
BREACH = {"att": 0.5, "q": 1.0, "occ": 0.9, "tpot": 1.0}
IDLE = {"att": 1.0, "q": 0.0, "occ": 0.1, "tpot": 1.0}
TPOT_BREACH = {"att": 1.0, "q": 1.0, "occ": 0.7, "tpot": 0.5}
SCRIPTS = {
    "blip": ([OK, BREACH, OK, BREACH, OK, OK], dict(breach_polls=2)),
    "sustained": ([BREACH] * 6, dict(breach_polls=2, cooldown_out_s=10.0)),
    "flap": ([BREACH if i % 2 == 0 else OK for i in range(40)],
             dict(cooldown_out_s=10.0, max_replicas=50)),
    "scale_in": ([IDLE] * 8, dict(breach_polls=3, min_replicas=1)),
    "max_step": ([{"att": 1.0, "q": 40.0, "occ": 1.0}] * 3, dict(max_step=2,
                                                                 cooldown_out_s=10.0)),
    "tpot_signal": ([TPOT_BREACH] * 4, dict(signal="tpot", breach_polls=2)),
    "ttft_signal": ([TPOT_BREACH] * 4, dict(signal="ttft", breach_polls=2)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_edges_match_reference(name):
    views, kw = SCRIPTS[name]
    logs = {}
    for pkg in ("ref", "port"):
        stub = _Stub(list(views))
        t = [0.0]
        a = PKG[pkg]["autoscale"].Autoscaler(stub, _policy(pkg, queue_high=4.0, **kw),
                                             clock=lambda: t[0])
        for _ in views:
            a.poll()
            t[0] += 1.0
        logs[pkg] = (stub.adds, stub.removes, a.snapshot())
    assert logs["port"] == logs["ref"]


def test_force_override_matches_reference(monkeypatch):
    assert tautoscale.FORCE_ENV == jautoscale.FORCE_ENV == "TDX_AUTOSCALE_FORCE"
    logs = {}
    for pkg in ("ref", "port"):
        stub = _Stub([OK] * 4)
        t = [0.0]
        a = PKG[pkg]["autoscale"].Autoscaler(stub, _policy(pkg, max_step=2, max_replicas=8),
                                             clock=lambda: t[0])
        got = []
        for raw in ("out:5", "replicas:2", "hold"):
            monkeypatch.setenv(tautoscale.FORCE_ENV, raw)
            d = a.poll()
            got.append((d.forced, d.action, d.amount, d.reason, stub.n))
        monkeypatch.setenv(tautoscale.FORCE_ENV, "garbage:x")
        with pytest.warns(RuntimeWarning, match="malformed"):
            d = a.poll()
        got.append((d.forced, d.action))
        logs[pkg] = got
    assert logs["port"] == logs["ref"]
    assert logs["port"][0][:3] == (True, "scale_out", 2)
    with pytest.raises(ValueError, match="signal"):
        tautoscale.AutoscalePolicy(signal="latency")


# -- serve-state checkpoints ---------------------------------------------------


def _state():
    return {"version": 1, "checkpoint_time": 12.5, "emitted": {"r0": 3, "r1": 0},
            "requests": [{"rid": "r0", "prompt": [1, 2, 3], "max_new_tokens": 4, "seed": 7,
                          "tenant": "acme", "klass": "gold", "arrival_time": 1.25,
                          "requeues": 1}],
            "queued": [{"rid": "r1", "prompt": [5], "max_new_tokens": 2, "seed": 0,
                        "tenant": "", "klass": "", "arrival_time": 2.0, "requeues": 0}]}


def test_sealed_checkpoints_are_the_references_bytes():
    assert telastic._seal(_state()) == jelastic._seal(_state())
    blobs = {}
    for pkg in ("ref", "port"):
        store = PKG[pkg]["store"].HashStore(timeout=1.0)
        el = PKG[pkg]["elastic"]
        for gen in range(3):
            el.save_serve_state(store, gen, dict(_state(), checkpoint_time=float(gen)))
        blobs[pkg] = [store.get(f"serve/ckpt/gen{g}") for g in range(3)] + [
            store.get("serve/ckpt/latest")]
        # corrupt the newest: the chain falls back to the one before
        store.set("serve/ckpt/gen2", b'{"crc32": 1, "size": 2}\n{}')
        with pytest.warns(RuntimeWarning):
            st, gen = el.load_serve_state(store)
        assert gen == 1 and st["checkpoint_time"] == 1.0
        assert el.gc_serve_state(store, 1, keep=0) == 1
        assert not store.check(["serve/ckpt/gen0"])
        el.signal_drain(store, 4)
        assert el.drain_requested(store, 4) and not el.drain_requested(store, 3)
    assert blobs["port"] == blobs["ref"]
    assert telastic.SERVE_DRAIN_PREFIX == "serve/drain"
    assert telastic._unseal(telastic._seal(_state())) == _state()
    assert telastic._unseal(b"garbage") is None


def test_restore_into_replays_the_snapshot():
    _, _, tmodel = _pair()
    prompts = _prompts(5, 7, 4, 6)
    t = [0.0]

    def engine():
        return tserve.ServeEngine(tmodel, slots=2, min_bucket=4, clock=lambda: t[0])

    ref = engine()
    for i, p in enumerate(prompts):
        ref.submit(p, 5, rid=f"r{i}", seed=i)
    want = {k: v.tokens for k, v in ref.run(max_steps=500).items()}
    e1 = engine()
    for i, p in enumerate(prompts):
        e1.submit(p, 5, rid=f"r{i}", seed=i)
    e1.step()
    t[0] = 1.5
    store = tstore.HashStore(timeout=1.0)
    telastic.save_serve_state(store, 3, e1.drain())
    st, g = telastic.load_serve_state(store)
    e2 = engine()
    assert telastic.restore_into(e2, st, generation=g) == len(prompts)
    t[0] = 5.5
    got = {k: v.tokens for k, v in e2.run(max_steps=500).items()}
    assert got == want
    rec = e2.metrics.snapshot()["recovery"]
    assert rec["restores"] == 1 and rec["restored_generation"] == 3
    assert rec["last_recovery_s"] == pytest.approx(4.0)
