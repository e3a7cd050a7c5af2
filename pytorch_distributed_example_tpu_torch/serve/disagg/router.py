"""Two-pool disaggregated serve router + per-pool scale surface.

`PoolRouter` is ONE pool's replica set behind the exact scale surface
the autoscale controller drives (`add_replica` /
`remove_replica` / `num_replicas` / `window_view`) — so TWO
`serve/autoscale.py::Autoscaler` instances, one per pool, steer the
two pools INDEPENDENTLY on their own signals: the prefill pool's
policy watches TTFT attainment (prefill latency IS time-to-first-token
here — the pool records `record_first_token` at handoff), the decode
pool's watches TPOT attainment (``AutoscalePolicy(signal="tpot")``).
A prefill burst that would crater TTFT grows the prefill pool; decode
steady-state pressure grows the decode pool; neither resize disturbs
the other — the two-signals/two-pools contract.

`DisaggRouter` is the front door over both pools and the owner of the
migration loop:

  submit → least-pending PREFILL engine → chunked prefill →
  frozen Handoff → publish (store, planner-ordered chunks) →
  land on least-pending DECODE engine (attach_migrated) →
  release the frozen source slot → reclaim the store keys →
  decode to completion.

Everything in that chain is idempotent or replayable: a transient
fault at `serve.migrate.send`/`serve.migrate.recv` retries the same
bytes next step; an eviction of a frozen slot (pool pressure on the
prefill engine) invalidates the pending migration by REQUEST IDENTITY
and the request replays from seed through prefill again; a decode-pool
preemption parks the migrant in the decode engine's queue, which the
router sweeps back into the prefill pool — replay-from-seed, token
-identical, exactly the engine's preemption contract stretched across two
pools. A crash mid-migration leaves store orphans that
`gc_migration` sweeps when the re-formed gang completes (or re-routes)
the request.

Token-exactness end to end is the `disagg_migration` numlint subject's
contract; the chaos tests in `tests/test_disagg.py` prove the
kill/replay half.

A copy of the reference's `serve/disagg/router.py`, re-pointed at the
port's `faults`, `serve.queue`, `serve.router` and migration plane.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ... import faults
from ..queue import DEFAULT_CLASS, Completion, Request
from ..router import ScaleEvent
from .migrate import gc_migration, recv_migration, send_handoff

__all__ = ["PoolRouter", "DisaggRouter"]

_TRANSIENT = (ConnectionResetError, faults.FaultTimeout)


@dataclass
class _PendingMigration:
    """One handoff mid-flight: popped from its prefill engine (slot
    still frozen there), not yet landed on a decode engine.
    `published` flips once the store holds the full payload+manifest —
    from then on retries skip the export and go straight to landing."""

    h: object
    src: object
    published: bool = False


class PoolRouter:
    """One pool's replicas behind the autoscaler's scale surface.

    Deliberately simpler than `serve/router.py::ServeRouter`: no
    prefix-affinity (the disagg front door routes least-pending — a
    prefill engine's warmth matters for one chunked prefill, not a
    session) and no loss ledger (process-level recovery is the worker
    ledger's job; in-process scale-in drains token-exact through the
    drain seam). `redistribute(state)` receives every drained victim's
    snapshot — the `DisaggRouter` lands BOTH pools' drained work back
    in the prefill pool, because a decode-pool resident request can
    only re-enter through prefill (its KV died with the drain)."""

    def __init__(
        self,
        name: str,
        engine_factory: Callable[[int], object],
        replicas: int = 1,
        clock=time.monotonic,
        redistribute: Optional[Callable[[Dict], int]] = None,
    ):
        if name not in ("prefill", "decode"):
            raise ValueError(f"unknown pool name {name!r}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.name = name
        self.clock = clock
        self._factory = engine_factory
        self._redistribute = redistribute
        self._engines: Dict[int, object] = {}
        self._next_id = 0
        self.events: List[ScaleEvent] = []
        self.chip_seconds = 0.0
        self._last_accrue = float(clock())
        for _ in range(replicas):
            self._add_entry()

    def _add_entry(self) -> int:
        rid = self._next_id
        self._next_id += 1
        self._engines[rid] = self._factory(rid)
        return rid

    def engines(self) -> List[Tuple[int, object]]:
        return sorted(self._engines.items())

    def least_pending(self):
        """The engine new work lands on — least pending, deterministic
        tie-break by id (trace replays re-derive the routing)."""
        rid = min(
            sorted(self._engines),
            key=lambda r: (self._engines[r].pending, r),
        )
        return self._engines[rid]

    def _accrue(self, now: float) -> None:
        self.chip_seconds += max(now - self._last_accrue, 0.0) * len(
            self._engines
        )
        self._last_accrue = now

    def step(self) -> bool:
        self._accrue(float(self.clock()))
        busy = False
        for _, eng in self.engines():
            busy = eng.step() or busy
        return busy

    # -- scale surface (serve/autoscale.py drives these) -------------------
    def add_replica(self) -> int:
        """Scale this pool out by one. ``serve.scale_out`` fires FIRST
        (pool-tagged) — a transient chaos fault aborts with the pool
        unchanged."""
        faults.fire(
            "serve.scale_out", replicas=len(self._engines), pool=self.name
        )
        rid = self._add_entry()
        now = float(self.clock())
        self._accrue(now)
        self.events.append(
            ScaleEvent(now, "add", rid, len(self._engines))
        )
        return rid

    def remove_replica(self, replica_id: Optional[int] = None) -> int:
        """Scale this pool in by one, token-exact: ``serve.scale_in``
        fires first (transient fault aborts, victim untouched), the
        victim `drain()`s at a step boundary — frozen handoffs and
        device lanes included — and the snapshot's requests re-enter
        through the `redistribute` callback (the disagg router lands
        them in the prefill pool). The last replica is never removable:
        a pool of zero would strand its plane."""
        if len(self._engines) <= 1:
            raise ValueError(
                f"cannot remove the last {self.name} replica"
            )
        victim = (
            replica_id if replica_id is not None else self._victim()
        )
        if victim not in self._engines:
            raise KeyError(f"no {self.name} replica {victim}")
        eng = self._engines[victim]
        faults.fire(
            "serve.scale_in",
            replica=victim,
            pending=eng.pending,
            pool=self.name,
        )
        state = eng.drain()
        del self._engines[victim]
        moved = (
            self._redistribute(state)
            if self._redistribute is not None
            else 0
        )
        now = float(self.clock())
        self._accrue(now)
        self.events.append(
            ScaleEvent(now, "remove", victim, len(self._engines), moved)
        )
        return victim

    def _victim(self) -> int:
        """Least pending work (cheapest drain), ties to the highest id
        (newest replica — coldest compile/prefix state)."""
        return min(
            sorted(self._engines),
            key=lambda r: (self._engines[r].pending, -r),
        )

    @property
    def num_replicas(self) -> int:
        return len(self._engines)

    @property
    def pending(self) -> int:
        return sum(eng.pending for eng in self._engines.values())

    def window_view(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """This POOL's merged rolling window — what its own autoscaler
        steers on. The prefill pool's TTFT rows come from
        `record_first_token` at handoff; the decode pool's TPOT rows
        from completions. One merge definition for every router
        (`metrics.merge_window_views`)."""
        from ..metrics import merge_window_views

        if now is None:
            now = float(self.clock())
        views = [
            eng.metrics.window_view(window_s=window_s, now=now)
            for _, eng in self.engines()
        ]
        return merge_window_views(views, now, window_s=window_s)


class DisaggRouter:
    def __init__(
        self,
        store,
        prefill_factory: Callable[[int], object],
        decode_factory: Callable[[int], object],
        prefill_replicas: int = 1,
        decode_replicas: int = 1,
        chunk_blocks: int = 4,
        clock=time.monotonic,
    ):
        """`prefill_factory(i)` must build engines with
        ``role="prefill"``, `decode_factory(i)` with ``role="decode"``
        (enforced here — a mis-roled engine would silently colocate).
        `store` carries the migration payloads (any `store.py` surface,
        `HashStore` in the deterministic tests); `chunk_blocks` is the
        migration chunking knob (`plan/transfer.py`)."""
        self.store = store
        self.clock = clock
        self.chunk_blocks = int(chunk_blocks)
        self.prefill = PoolRouter(
            "prefill",
            prefill_factory,
            prefill_replicas,
            clock=clock,
            redistribute=self._absorb_into_prefill,
        )
        self.decode = PoolRouter(
            "decode",
            decode_factory,
            decode_replicas,
            clock=clock,
            redistribute=self._absorb_into_prefill,
        )
        for _, eng in self.prefill.engines():
            if getattr(eng, "role", "both") != "prefill":
                raise ValueError(
                    "prefill_factory must build role='prefill' engines"
                )
        for _, eng in self.decode.engines():
            if getattr(eng, "role", "both") != "decode":
                raise ValueError(
                    "decode_factory must build role='decode' engines"
                )
        self._pending: List[_PendingMigration] = []
        self.completions: Dict[str, Completion] = {}
        self.migrations = 0  # landed
        self.migration_retries = 0  # landing deferred (capacity/fault)
        self.replays = 0  # migrants swept back to prefill (preemption)

    # -- front door --------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        rid: Optional[str] = None,
        seed: int = 0,
        arrival_time: Optional[float] = None,
        tenant: str = "",
        klass: str = DEFAULT_CLASS,
    ) -> str:
        """Route one request into the prefill pool (least pending).
        ``router.route`` fires before any state changes, pool-tagged."""
        faults.fire(
            "router.route", rid=rid, tenant=tenant, klass=klass,
            pool="prefill",
        )
        return self.prefill.least_pending().submit(
            prompt,
            max_new_tokens,
            rid=rid,
            seed=seed,
            arrival_time=arrival_time,
            tenant=tenant,
            klass=klass,
        )

    # -- the migration loop ------------------------------------------------
    def _still_frozen(self, m: _PendingMigration) -> bool:
        """A pending migration is valid only while its source slot
        still holds ITS request — an eviction (pool pressure on the
        prefill engine, a drain) requeued the request for a fresh
        replay, making the record stale."""
        return m.src._slot_req[m.h.slot] is m.h.req

    def _migrate_tick(self) -> None:
        worlds = (self.prefill.num_replicas, self.decode.num_replicas)
        for m in list(self._pending):
            if not self._still_frozen(m):
                # the request replays through prefill from seed; any
                # half-published payload is stale — reclaim now
                self._pending.remove(m)
                if m.published:
                    gc_migration(self.store, m.h.req.rid)
                self.replays += 1
                continue
            try:
                if not m.published:
                    send_handoff(
                        self.store,
                        m.src,
                        m.h,
                        prefill_world=worlds[0],
                        decode_world=worlds[1],
                        chunk_blocks=self.chunk_blocks,
                    )
                    m.published = True
                landed = None
                for _, eng in sorted(
                    self.decode.engines(),
                    key=lambda kv: (kv[1].pending, kv[0]),
                ):
                    landed = recv_migration(
                        self.store, m.h.req.rid, eng
                    )
                    if landed is not None:
                        break
            except _TRANSIENT:
                # send: nothing (or everything, idempotently) is
                # published; recv: nothing landed. Retry next tick.
                self.migration_retries += 1
                continue
            if landed is None:
                self.migration_retries += 1  # pool full: stay pending
                continue
            m.src.release_handoff(m.h)
            gc_migration(self.store, m.h.req.rid)
            self._pending.remove(m)
            self.migrations += 1

    def _sweep_decode_queues(self) -> None:
        """Preempted migrants park in their decode engine's queue
        (decode engines never self-admit); sweep them back into the
        prefill pool for a full replay from seed."""
        for _, eng in self.decode.engines():
            while True:
                head = eng.queue.peek()
                if head is None:
                    break
                if not eng.queue.pop_specific(head):
                    break
                self.prefill.least_pending().queue.requeue_front(head)
                self.replays += 1
                # a requeued migrant's half-landed payload is stale
                gc_migration(self.store, head.rid)

    def _collect(self) -> None:
        for pool in (self.prefill, self.decode):
            for _, eng in pool.engines():
                if eng.completions:
                    done = eng.completions
                    eng.completions = {}
                    self.completions.update(done)
                    # completed-migration orphan sweep: a landing that
                    # crashed between attach and reclaim left keys
                    for rid in done:
                        gc_migration(self.store, rid)

    def _absorb_into_prefill(self, state: Dict) -> int:
        """A drained replica's snapshot (EITHER pool) re-enters through
        the prefill pool: accepted work at the head (bounds-exempt),
        backlog at the sheddable tail. Decode-side residents replay
        from seed — their migrated KV died with the drain, and their
        published migration keys are reclaimed on the sweep that
        requeued them."""
        accepted = [
            Request.from_state(d) for d in state.get("requests", [])
        ]
        backlog = [Request.from_state(d) for d in state.get("queued", [])]
        for req in reversed(accepted):
            gc_migration(self.store, req.rid)
            self.prefill.least_pending().queue.requeue_front(req)
        for req in backlog:
            self.prefill.least_pending().queue.restore_tail(req)
        return len(accepted) + len(backlog)

    def step(self) -> bool:
        """One disagg iteration: prefill pool steps (chunked prefill →
        frozen handoffs), handoffs enter the migration loop, published
        payloads land on decode engines, the decode pool steps (one
        token per active migrant), completions collect, preempted
        migrants sweep back to prefill. Returns True while any pool or
        the migration loop holds work."""
        busy = self.prefill.step()
        for _, eng in self.prefill.engines():
            for h in eng.pop_handoffs():
                self._pending.append(_PendingMigration(h, eng))
        self._migrate_tick()
        busy = self.decode.step() or busy
        self._sweep_decode_queues()
        self._collect()
        return busy or bool(self._pending)

    def run(
        self, max_steps: Optional[int] = None
    ) -> Dict[str, Completion]:
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(
                    f"disagg router did not drain within {max_steps} "
                    f"steps (pending_migrations={len(self._pending)}, "
                    f"prefill_pending={self.prefill.pending}, "
                    f"decode_pending={self.decode.pending})"
                )
        return self.completions

    # -- introspection -----------------------------------------------------
    @property
    def pending(self) -> int:
        return (
            self.prefill.pending
            + self.decode.pending
            + len(self._pending)
        )

    def window_view(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """BOTH pools merged — the global dashboard view. Autoscalers
        do NOT read this one: each pool's controller reads its own
        `PoolRouter.window_view` (TTFT evidence lives in the prefill
        pool's windows, TPOT evidence in the decode pool's)."""
        from ..metrics import merge_window_views

        if now is None:
            now = float(self.clock())
        views = [
            eng.metrics.window_view(window_s=window_s, now=now)
            for pool in (self.prefill, self.decode)
            for _, eng in pool.engines()
        ]
        return merge_window_views(views, now, window_s=window_s)

    def snapshot(self) -> Dict:
        now = float(self.clock())
        return {
            "pools": {
                pool.name: {
                    "replicas": pool.num_replicas,
                    "pending": pool.pending,
                    "chip_seconds": round(pool.chip_seconds, 6),
                    "events": [e.to_state() for e in pool.events[-16:]],
                }
                for pool in (self.prefill, self.decode)
            },
            "pending_migrations": len(self._pending),
            "migrations": self.migrations,
            "migration_retries": self.migration_retries,
            "replays": self.replays,
            "completions": len(self.completions),
            "window": self.window_view(now=now),
        }
