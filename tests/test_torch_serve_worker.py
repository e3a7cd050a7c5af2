"""The port's serve worker daemon, held to the reference's
`tests/test_serve_worker.py`: the process-level drain → seal → resize →
restore → re-register lifecycle.

The port's workers serve with `from_flax` weights of the reference's
model, and every completion must equal the reference engine's tokens on
the same traffic (the JAX package's `ServeEngine`, uninterrupted). One
case crosses the packages on the store: a reference `GangRouter` feeds
port workers over one `TCPStore`.

Three tiers:

* in-process unit tests — `ServeWorker` + `GangRouter` on a
  `HashStore` with deterministic interleaving (no processes, fast);
* chaos tests — fault plans at the three worker lifecycle points
  (`serve.worker.start`, `serve.worker.register`,
  `serve.restore_geometry`): transient faults are absorbed in place,
  exhausted retries escalate so the agent re-forms the gang at the
  SAME size with the ledger intact;
* slow process tests — a real `LocalElasticAgent` gang of
  `examples/serve_worker.py` daemons (the port's own weights, held to
  the port's uninterrupted engine): a 2→3→1 resize under live
  router traffic with a SIGKILL mid-resize, and a wedged worker that
  ignores drain and is SIGTERM'd at grace expiry without wedging the
  resize. Token identity against an uninterrupted single-engine
  reference is the acceptance oracle throughout.
"""

import functools
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu_torch import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRYPOINT = "pytorch_distributed_example_tpu_torch.examples.serve_worker"


@pytest.fixture()
def no_fault_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


@functools.lru_cache(maxsize=None)
def _pair(max_seq_len=32):
    """The reference's model and params, and the port's model carrying
    the same weights (`from_flax`)."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_example_tpu.models import transformer as jtr
    from pytorch_distributed_example_tpu_torch.models import convert
    from pytorch_distributed_example_tpu_torch.models import transformer as ttr

    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              max_seq_len=max_seq_len, use_flash=False)
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = ttr.TransformerLM(
        ttr.TransformerConfig(dtype=torch.float32, **kw), device="cpu"
    )
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _model(max_seq_len=32):
    """The port's model (the reference's weights) and the pair it came from."""
    jmodel, params, tmodel = _pair(max_seq_len)
    return tmodel, (jmodel, params)


def _prompts(*lens, seed=0, vocab=64):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _engine(model, params, slots=4):
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    return ServeEngine(model, slots=slots, min_bucket=4)


def _reference(model, params, prompts, budget=4, slots=4):
    """Uninterrupted single-engine run of the REFERENCE's engine — what
    every gang/resize/chaos schedule of port workers must reproduce
    token for token."""
    from pytorch_distributed_example_tpu.serve import ServeEngine

    jmodel, jparams = params
    ref = ServeEngine(jmodel, jparams, slots=slots, min_bucket=4)
    for i, p in enumerate(prompts):
        ref.submit(p, budget, rid=f"r{i}", seed=i)
    return {r: list(c.tokens) for r, c in ref.run(100_000).items()}


def _pump(router, workers, rids, loops=600):
    """Deterministic interleaving: one serve loop per worker per round
    until every rid has a published completion."""
    for _ in range(loops):
        for w in workers:
            w.serve_forever(max_loops=1)
        if all(router.result(r) is not None for r in rids):
            return
    missing = [r for r in rids if router.result(r) is None]
    raise AssertionError(f"unfinished after {loops} rounds: {missing}")


class TestServeWorkerUnit:
    def test_two_worker_gang_token_identity(self, no_fault_plan):
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
            wait_registered,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        model, params = _model()
        prompts = _prompts(5, 7, 4, 6, 8, 5)
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        workers = [
            ServeWorker(
                store,
                _engine(model, params),
                rank=r,
                gen=0,
                claim_depth=2,  # shallow: forces work to distribute
            ).start()
            for r in range(2)
        ]
        rows = wait_registered(store, 0, 2, timeout=2.0)
        assert sorted(r["rank"] for r in rows) == [0, 1]
        assert all(r["pid"] == os.getpid() for r in rows)

        rids = [
            router.submit(p, 4, rid=f"r{i}", seed=i)
            for i, p in enumerate(prompts)
        ]
        _pump(router, workers, rids)
        out = router.wait_all(timeout=5.0)
        assert out == _reference(model, params, prompts)
        # both workers pulled from the shared ledger (work distributed)
        assert all(len(w._claimed) > 0 for w in workers)
        # the live metrics rows merge into the autoscaler's view shape
        view = router.window_view()
        assert view["replicas"] == 2
        assert "queue_depth_mean_per_replica" in view

    def test_resize_2_to_3_restore_token_identity(self, no_fault_plan):
        """The tentpole seam at unit scale: drain a 2-gang mid-flight,
        re-form at width 3, and the NEW generation finishes everything
        token-identically (leader-elected merge of both sealed
        planes + generation-scoped re-claims)."""
        from pytorch_distributed_example_tpu_torch.serve.elastic import (
            signal_drain,
        )
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        model, params = _model()
        prompts = _prompts(5, 7, 4, 6, 8, 5, 6, 4)
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        gen0 = [
            ServeWorker(
                store, _engine(model, params, slots=2), rank=r, gen=0
            ).start()
            for r in range(2)
        ]
        rids = [
            router.submit(p, 4, rid=f"r{i}", seed=i)
            for i, p in enumerate(prompts)
        ]
        for _ in range(4):  # partway: claims spread, some mid-decode
            for w in gen0:
                w.serve_forever(max_loops=1)
        signal_drain(store, 0)
        assert [w.serve_forever(max_loops=50) for w in gen0] == [
            "drained",
            "drained",
        ]
        # both per-rank planes sealed
        assert store.check(["serve/ckpt/w0/latest"])
        assert store.check(["serve/ckpt/w1/latest"])

        gen1 = [
            ServeWorker(
                store, _engine(model, params, slots=2), rank=r, gen=1
            ).start()
            for r in range(3)
        ]
        assert sum(w.is_leader for w in gen1) == 1
        leader = next(w for w in gen1 if w.is_leader)
        done_before = sum(
            1 for r in rids if router.result(r) is not None
        )
        # leader adopted exactly the sealed in-flight work
        assert leader.restored == len(prompts) - done_before
        _pump(router, gen1, rids)
        assert router.wait_all(timeout=5.0) == _reference(
            model, params, prompts, slots=2
        )

    def test_head_bump_before_item_write_is_not_lost(
        self, no_fault_plan
    ):
        """The front door bumps the ledger head BEFORE the item body
        lands (two store ops); a worker scanning inside that gap must
        grace-wait, not conclude the seq was swept — otherwise the
        request is silently lost forever (found by the real-process
        gang harness)."""
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
            _item_key,
            _rid_key,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        model, params = _model()
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        w = ServeWorker(store, _engine(model, params), rank=0, gen=0)
        w.start()
        # simulate a mid-submit peer: head moved, item not yet visible
        seq = store.add("serve/work/head", 1)
        for _ in range(3):
            w.serve_forever(max_loops=1)
        assert seq not in w._claimed  # not skipped, not claimed: waiting
        assert w._cursor == seq
        # the body lands; the worker claims and serves it
        from pytorch_distributed_example_tpu_torch.serve.queue import Request

        req = Request(
            prompt=np.arange(1, 6, dtype=np.int32),
            max_new_tokens=3,
            rid="late",
            seed=0,
        )
        store.set(_item_key(seq), json.dumps(req.to_state()).encode())
        store.set(_rid_key("late"), str(seq).encode())
        router._rids.append("late")
        _pump(router, [w], ["late"])
        assert router.result("late")["tokens"]
        # and a NEVER-written seq is eventually abandoned (grace
        # expiry) without stalling later items behind it
        w2 = ServeWorker(store, _engine(model, params), rank=1, gen=0)
        w2._missing_grace_s = 0.05
        w2.start()
        ghost = store.add("serve/work/head", 1)
        time.sleep(0.06)
        rid2 = router.submit(
            np.arange(1, 5, dtype=np.int32), 2, rid="after-ghost"
        )
        _pump(router, [w2], [rid2])
        assert ghost not in w2._claimed

    def test_duplicate_service_is_invisible(self, no_fault_plan):
        """Two generations claiming the same rid (the double-serve race
        a crashed restore leader can open) publish byte-identical
        completions — the done-write is idempotent by construction."""
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        model, params = _model()
        prompts = _prompts(5, 6)
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        rids = [
            router.submit(p, 3, rid=f"r{i}", seed=i)
            for i, p in enumerate(prompts)
        ]
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            _done_key,
        )

        w0 = ServeWorker(store, _engine(model, params), rank=0, gen=0)
        w0.start()
        _pump(router, [w0], rids)
        first = router.wait_all(timeout=5.0)
        # erase the done keys: to a later generation the rids now look
        # in-flight (exactly what a crashed leader's window produces),
        # so it claims and serves them AGAIN from their seeds
        for rid in rids:
            store.delete_key(_done_key(rid))
        w1 = ServeWorker(store, _engine(model, params), rank=0, gen=1)
        w1.start()  # different generation: claims don't collide
        _pump(router, [w1], rids)
        assert router.wait_all(timeout=5.0) == first


class TestAcrossPackages:
    def test_reference_router_feeds_port_workers(self, no_fault_plan):
        """A reference `GangRouter` publishes into the ledger of a port
        `TCPStore` daemon through a reference client; two port workers
        claim, serve and publish; the reference router reads completions
        equal to the reference engine's tokens."""
        from pytorch_distributed_example_tpu.serve.worker import (
            GangRouter as RefRouter,
        )
        from pytorch_distributed_example_tpu.store import TCPStore as RefStore
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            ServeWorker,
            wait_registered,
        )
        from pytorch_distributed_example_tpu_torch.store import TCPStore

        model, params = _model()
        prompts = _prompts(5, 7, 4, 6, 8)
        daemon = TCPStore("127.0.0.1", 0, is_master=True, timeout=10.0)
        client = RefStore("127.0.0.1", daemon.port, is_master=False, timeout=10.0)
        try:
            router = RefRouter(client)
            workers = [
                ServeWorker(daemon, _engine(model, params, slots=2), rank=r,
                            gen=0, claim_depth=2).start()
                for r in range(2)
            ]
            rows = wait_registered(client, 0, 2, timeout=5.0)
            assert sorted(r["rank"] for r in rows) == [0, 1]
            rids = [
                router.submit(p, 4, rid=f"r{i}", seed=i)
                for i, p in enumerate(prompts)
            ]
            _pump(router, workers, rids)
            assert router.wait_all(timeout=5.0) == _reference(
                model, params, prompts, slots=2
            )
            assert all(len(w._claimed) > 0 for w in workers)
            router.shutdown()
            assert [w.serve_forever(max_loops=5) for w in workers] == [
                "shutdown", "shutdown"]
        finally:
            client.close()
            daemon.close()


class TestWorkerChaos:
    """Fault plans at the worker lifecycle points: transient faults
    retry in place (consistent gang size), exhausted budgets escalate."""

    @pytest.mark.parametrize(
        "point",
        [
            "serve.worker.start",
            "serve.worker.register",
            "serve.restore_geometry",
        ],
    )
    def test_transient_fault_absorbed_token_exact(self, point):
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
            wait_registered,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        model, params = _model()
        prompts = _prompts(5, 7, 4)
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        rids = [
            router.submit(p, 4, rid=f"r{i}", seed=i)
            for i, p in enumerate(prompts)
        ]
        faults.install_plan(
            [{"point": point, "action": "reset", "times": 2}],
            export_env=False,
        )
        try:
            # single worker is always the restore leader, so all three
            # points fire on its start() path
            w = ServeWorker(store, _engine(model, params), rank=0, gen=0)
            w.start()
        finally:
            faults.clear_plan()
        rows = wait_registered(store, 0, 1, timeout=2.0)
        assert len(rows) == 1  # same gang size: fault absorbed in place
        _pump(router, [w], rids)
        assert router.wait_all(timeout=5.0) == _reference(
            model, params, prompts
        )

    def test_exhausted_transients_escalate_to_dist_error(self):
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            ServeWorker,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore
        from pytorch_distributed_example_tpu_torch.types import DistError

        model, params = _model()
        faults.install_plan(
            [
                {
                    "point": "serve.worker.start",
                    "action": "reset",
                    "times": -1,
                }
            ],
            export_env=False,
        )
        try:
            with pytest.raises(DistError, match="serve.worker.start"):
                ServeWorker(
                    HashStore(timeout=1.0),
                    _engine(model, params),
                    rank=0,
                    gen=0,
                ).start()
        finally:
            faults.clear_plan()

    def test_crashed_leader_defers_work_to_next_generation(self):
        """A leader that dies mid-restore (fault AT the point: nothing
        republished yet) leaves the marker claimed but never done; the
        NEXT generation's leader re-walks the planes and nothing is
        lost."""
        from pytorch_distributed_example_tpu_torch.serve.elastic import (
            signal_drain,
        )
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            ServeWorker,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore
        from pytorch_distributed_example_tpu_torch.types import DistError

        model, params = _model()
        prompts = _prompts(5, 7, 4, 6)
        store = HashStore(timeout=1.0)
        router = GangRouter(store)
        rids = [
            router.submit(p, 4, rid=f"r{i}", seed=i)
            for i, p in enumerate(prompts)
        ]
        gen0 = ServeWorker(store, _engine(model, params), rank=0, gen=0)
        gen0.start()
        for _ in range(2):
            gen0.serve_forever(max_loops=1)
        signal_drain(store, 0)
        assert gen0.serve_forever(max_loops=10) == "drained"

        faults.clear_plan()
        faults.install_plan(
            [
                {
                    "point": "serve.restore_geometry",
                    "action": "reset",
                    "times": -1,
                }
            ],
            export_env=False,
        )
        try:
            with pytest.raises(DistError):
                ServeWorker(
                    store, _engine(model, params), rank=0, gen=1
                ).start()
        finally:
            faults.clear_plan()
        # gen2 leader restores what gen1's crashed leader never did
        gen2 = ServeWorker(store, _engine(model, params), rank=0, gen=2)
        gen2.start()
        assert gen2.is_leader and gen2.restored > 0
        _pump(router, [gen2], rids)
        assert router.wait_all(timeout=5.0) == _reference(
            model, params, prompts
        )


class TestResizeKeyHardening:
    """`agent/resize_target` edge cases: duplicate (replayed) stamps,
    stale stamps, legacy bare-int values, and malformed garbage must
    all degrade to no-ops — never a surprise second resize."""

    def _agent(self, nproc=3):
        from pytorch_distributed_example_tpu_torch.elastic import (
            LocalElasticAgent,
            WorkerSpec,
        )
        from pytorch_distributed_example_tpu_torch.store import HashStore

        agent = LocalElasticAgent(
            WorkerSpec(
                entrypoint=["unused.py"],
                nproc_per_node=nproc,
                min_nproc=1,
            )
        )
        agent._store = HashStore(timeout=1.0)  # duck-typed store surface
        return agent, agent._store

    @staticmethod
    def _consumed(store):
        """Retired = absent OR the CAS tombstone (b"") — consume is a
        guarded compare_set, not a delete, so a NEWER stamp published
        mid-teardown can never be destroyed with the old one."""
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
        )

        return (
            not store.check([_RESIZE_KEY])
            or store.get(_RESIZE_KEY) == b""
        )

    def test_stamped_request_parses_and_clamps(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _stamp_resize,
        )

        agent, store = self._agent(nproc=3)
        seq = _stamp_resize(store, 2)
        assert seq == 1
        assert store.get(_RESIZE_KEY) == b"2@1"
        assert agent._resize_target() == 2
        # over-capacity target clamps to nproc_per_node
        agent.active_nproc = 2
        _stamp_resize(store, 99)
        assert agent._resize_target() == 3

    def test_duplicate_stamp_replay_is_noop(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _stamp_resize,
        )

        agent, store = self._agent(nproc=3)
        seq = _stamp_resize(store, 2)
        raw = store.get(_RESIZE_KEY)
        # the agent acts on it (monitor loop equivalent)
        assert agent._resize_target() == 2
        agent._mark_resize_done(store, seq)
        agent._consume_resize_key(store, raw)
        # a replayed duplicate of the SAME stamp (e.g. key duplicated
        # across a generation bump) is consumed as a no-op
        store.set(_RESIZE_KEY, raw)
        assert agent._resize_target() is None
        assert self._consumed(store)
        # ...even for an agent that restarted in between (the high-water
        # is persisted in the store, not agent memory)
        agent2, _ = self._agent(nproc=3)
        agent2._store = store
        store.set(_RESIZE_KEY, raw)
        assert agent2._resize_target() is None

    def test_legacy_bare_int_accepted_without_advancing_highwater(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _parse_resize,
        )

        agent, store = self._agent(nproc=3)
        assert _parse_resize(b"2") == (2, None)
        store.set(_RESIZE_KEY, b"2")
        assert agent._resize_target() == 2
        agent._mark_resize_done(store, None)  # legacy: no seq to mark
        assert agent._resize_done_seq(store) == 0

    def test_malformed_values_consumed_as_met(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _parse_resize,
        )

        agent, store = self._agent(nproc=3)
        assert _parse_resize(b"\xff\xfe") == (None, None)
        assert _parse_resize(b"two@1") == (None, None)
        # a garbled stamp poisons the whole value: a target whose
        # staleness cannot be verified must not trigger a resize
        assert _parse_resize(b"2@x") == (None, None)
        for garbage in (b"\xff\xfe", b"junk", b"2@x", b"@@", b""):
            store.set(_RESIZE_KEY, garbage)
            assert agent._resize_target() is None
            assert self._consumed(store)  # no spin on the garbage

    def test_newer_target_survives_consume_of_older(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _stamp_resize,
        )

        agent, store = self._agent(nproc=3)
        _stamp_resize(store, 2)
        acted_on = store.get(_RESIZE_KEY)
        _stamp_resize(store, 2)  # same nproc, NEWER stamp, mid-teardown
        newer = store.get(_RESIZE_KEY)
        agent._consume_resize_key(store, acted_on)
        assert store.get(_RESIZE_KEY) == newer  # not destroyed

    def test_satisfied_target_consumed_and_marked(self):
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            _RESIZE_KEY,
            _stamp_resize,
        )

        agent, store = self._agent(nproc=3)
        seq = _stamp_resize(store, 3)  # already the active size
        assert agent._resize_target() is None
        assert self._consumed(store)
        assert agent._resize_done_seq(store) == seq


EXAMPLE_ARGS = ("--slots", "2", "--min-bucket", "4")


def _example_reference(prompts, budget):
    """The example's model (the port's own torch-seeded weights) on one
    uninterrupted port engine of the workers' geometry."""
    from pytorch_distributed_example_tpu_torch.examples import serve_worker
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    args = serve_worker.parse_args(list(EXAMPLE_ARGS))
    ref = ServeEngine(serve_worker.build_model(args, torch.device("cpu")),
                      slots=args.slots, min_bucket=args.min_bucket)
    for i, p in enumerate(prompts):
        ref.submit(p, budget, rid=f"r{i}", seed=i)
    return {r: list(c.tokens) for r, c in ref.run(100_000).items()}


def _spawn_agent(spec):
    from pytorch_distributed_example_tpu_torch.elastic import LocalElasticAgent

    agent = LocalElasticAgent(spec)
    res = {}
    th = threading.Thread(
        target=lambda: res.update(run=agent.run()), daemon=True
    )
    return agent, th, res


@pytest.mark.slow
class TestWorkerGangProcess:
    """Real elastic-agent gangs of `examples/serve_worker/main.py`."""

    def _store(self, port):
        from pytorch_distributed_example_tpu_torch.store import TCPStore

        return TCPStore(
            "127.0.0.1", port, is_master=False, timeout=60.0
        )

    def _free_port(self):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def test_process_resize_2_3_1_with_chaos_kill(self, no_fault_plan):
        """The acceptance walk: live traffic across a 2→3→1 process-
        level resize, a SIGKILL mid-resize (the gang re-forms at the
        surviving width — consistent, ledger intact), and end-to-end
        token identity."""
        from pytorch_distributed_example_tpu_torch.elastic import WorkerSpec
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            request_resize,
        )
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            wait_registered,
        )

        port = self._free_port()
        spec = WorkerSpec(
            entrypoint=[ENTRYPOINT, *EXAMPLE_ARGS],
            module=True,
            nproc_per_node=3,  # capacity ceiling
            min_nproc=1,
            master_port=port,
            max_restarts=10,
            serve_drain_grace_s=10.0,
            env={"TDX_SERVE_CPU": "1", "OMP_NUM_THREADS": "1"},
        )
        agent, th, res = _spawn_agent(spec)
        agent.active_nproc = 2  # form at 2 of 3: headroom both ways
        th.start()
        try:
            store = self._store(port)
            wait_registered(store, 0, 2, timeout=120.0)
            router = GangRouter(store)
            prompts = _prompts(5, 7, 4, 6, 8, 5, 6, 4, 7, 5)
            rids = [
                router.submit(p, 3, rid=f"r{i}", seed=i)
                for i, p in enumerate(prompts[:4])
            ]
            # scale OUT 2→3 while those are in flight
            request_resize("127.0.0.1", port, 3)
            rows = wait_registered(store, 1, 3, timeout=120.0)
            rids += [
                router.submit(p, 3, rid=f"r{i + 4}", seed=i + 4)
                for i, p in enumerate(prompts[4:7])
            ]
            # chaos: SIGKILL a just-re-formed worker mid-service — the
            # agent re-forms at a CONSISTENT size (elastic policy:
            # the surviving width) with the ledger intact
            os.kill(int(rows[-1]["pid"]), signal.SIGKILL)
            wait_registered(store, 2, 2, timeout=120.0)
            # scale IN →1
            request_resize("127.0.0.1", port, 1)
            wait_registered(store, 3, 1, timeout=120.0)
            rids += [
                router.submit(p, 3, rid=f"r{i + 7}", seed=i + 7)
                for i, p in enumerate(prompts[7:])
            ]
            out = router.wait_all(timeout=180.0)
            router.shutdown()
            th.join(timeout=60.0)
            assert out == _example_reference(prompts, budget=3)
            run = res.get("run")
            assert run is not None and "SUCCEEDED" in str(run.state)
        finally:
            if th.is_alive():  # the agent's store is up only while it runs
                try:
                    GangRouter(self._store(port)).shutdown(sweep=False)
                except Exception:
                    pass
                th.join(timeout=30.0)

    def test_drain_grace_expiry_sigterm_unwedges_resize(
        self, no_fault_plan
    ):
        """A worker that wedges on the drain signal (TDX_SERVE_WEDGE_GEN
        chaos knob) is SIGTERM'd at grace expiry; the resize completes
        anyway and the next generation replays the wedged worker's
        claims from the router's ledger, token-exactly."""
        from pytorch_distributed_example_tpu_torch.elastic import WorkerSpec
        from pytorch_distributed_example_tpu_torch.elastic.agent import (
            request_resize,
        )
        from pytorch_distributed_example_tpu_torch.serve.worker import (
            GangRouter,
            wait_registered,
        )

        port = self._free_port()
        spec = WorkerSpec(
            entrypoint=[ENTRYPOINT, *EXAMPLE_ARGS],
            module=True,
            nproc_per_node=2,
            min_nproc=1,
            master_port=port,
            max_restarts=10,
            serve_drain_grace_s=2.0,  # short: the test waits it out
            env={"TDX_SERVE_CPU": "1", "TDX_SERVE_WEDGE_GEN": "0",
                 "OMP_NUM_THREADS": "1"},
        )
        agent, th, res = _spawn_agent(spec)
        th.start()
        try:
            store = self._store(port)
            wait_registered(store, 0, 2, timeout=120.0)
            router = GangRouter(store)
            prompts = _prompts(5, 7, 4, 6, 8, 5)
            rids = [
                router.submit(p, 3, rid=f"r{i}", seed=i)
                for i, p in enumerate(prompts)
            ]
            time.sleep(1.0)  # let gen0 claim (and partially serve) work
            t0 = time.monotonic()
            request_resize("127.0.0.1", port, 1)
            # gen0 never drains (wedged 3600s) — the agent must SIGTERM
            # it at the 2s grace and form gen1 regardless
            wait_registered(store, 1, 1, timeout=120.0)
            assert time.monotonic() - t0 < 90.0  # resize did not wedge
            out = router.wait_all(timeout=180.0)
            router.shutdown()
            th.join(timeout=60.0)
            # wedged workers sealed NOTHING — replay is pure ledger
            assert out == _example_reference(prompts, budget=3)
        finally:
            if th.is_alive():  # the agent's store is up only while it runs
                try:
                    GangRouter(self._store(port)).shutdown(sweep=False)
                except Exception:
                    pass
                th.join(timeout=30.0)
