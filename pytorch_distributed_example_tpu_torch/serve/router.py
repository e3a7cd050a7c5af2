"""Data-parallel serve router — one front door over N engine replicas.

One `ServeEngine` saturates at its slot count; the serve plane scales
past that by running REPLICAS of the whole engine (params replicated,
each with its own paged pool and queue) behind a router. This module is
that router, plus the scale seams the autoscale controller
(`serve/autoscale.py`) drives. Three properties matter:

* **Session affinity on prefix scopes — sticky until it hurts.**
  Requests are routed by the SAME scope key the radix prefix cache
  shares on (`serve.prefix.prefix_scope` — per-tenant, or the global
  scope for `share_prefix` classes). A tenant's requests therefore
  land on ONE replica, where its cached preamble blocks stay hot;
  spraying a tenant across replicas would re-prefill (and re-store)
  the shared prefix once per replica, turning the prefix-sharing dedup win back
  into N copies. A scope's first request binds it to the least-loaded
  replica (deterministic tie-break by replica id). Affinity is a
  PREFERENCE, not a pin: when the bound replica's backlog exceeds the
  least-loaded replica's by more than `rebalance_backlog`, the scope
  REBINDS there — one cold preamble re-prefill costs milliseconds, the
  queue it escapes costs seconds, and without this a gang that scales
  out from width 1 would leave every scope pinned to replica 0 and the
  new capacity idle.

* **Replica loss degrades, never fails.** The router tracks every
  outstanding request (rid -> replayable `Request`) per replica. When a
  replica is LOST (`lose_replica` — process gone, nothing to drain),
  its scopes are unbound and its outstanding work is resubmitted to
  surviving replicas, where it replays token-identically from its seed
  against a COLD prefix cache (the first replayed request of each scope
  rebuilds the shared preamble, the rest hit it again). The tenant sees
  latency, not errors.

* **Scale events ride the engine's drain/restore seams.** `remove_replica`
  fires ``serve.scale_in`` BEFORE touching the victim (a transient
  chaos fault aborts the resize with the gang at a consistent size and
  every request intact), then `drain()`s it — the step-boundary
  quiesce + requeue seam — optionally seals the snapshot into the
  coordination store (`serve/elastic.py`, per-replica key prefix), and
  redistributes the snapshot's requests into survivors by affinity:
  engine-accepted work re-enters through `requeue_front` (exempt from
  bounds), the never-admitted backlog through `restore_tail` (still
  sheddable). `add_replica` fires ``serve.scale_out`` before
  constructing the new engine. Either event replays token-exact
  mid-swing because every request carries its seed.

Chip-seconds accounting: `step()` integrates `replicas x wall-time`
(the router's clock — a virtual clock in the load harness makes the
integral deterministic), which is the figure the autoscale bench
compares against static peak provisioning.

Threading: single-owner like the engine — ONE thread calls `submit` /
`step` / scale methods. `_lock` exists for the concurrent READERS
(`snapshot`, `window_view` from the debug HTTP frontend): every access
to the replica/affinity/outstanding tables and the event log holds it;
compiled-program execution (`engine.step`) runs outside it on a
copied replica list.

A copy of the reference's `serve/router.py`, re-pointed at the port's
`faults`, `serve.elastic`, `serve.prefix` and `serve.queue`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import faults
from .elastic import save_serve_state
from .prefix import prefix_scope
from .queue import DEFAULT_CLASS, ClassSpec, Completion, Request

__all__ = ["ServeRouter", "ScaleEvent"]

# transient taxonomy (mirrors the engine): injected resets/drops abort
# the current operation cleanly; real errors propagate
_TRANSIENT = (ConnectionResetError, faults.FaultTimeout)


@dataclass
class ScaleEvent:
    """One applied scale event — the router's own audit line (the
    controller keeps the richer decision log with the metric view)."""

    t: float
    kind: str  # "add" | "remove" | "lose"
    replica_id: int
    replicas_after: int
    redistributed: int = 0  # requests moved off the leaving replica

    def to_state(self) -> Dict:
        return {
            "t": self.t,
            "kind": self.kind,
            "replica_id": self.replica_id,
            "replicas_after": self.replicas_after,
            "redistributed": self.redistributed,
        }


class ServeRouter:
    def __init__(
        self,
        engine_factory: Callable[[int], object],
        replicas: int = 1,
        classes: Optional[Dict[str, ClassSpec]] = None,
        clock=time.monotonic,
        store=None,
        ckpt_prefix: str = "serve/replica",
        rebalance_backlog: int = 8,
        max_events: int = 512,
    ):
        """`engine_factory(replica_id) -> ServeEngine` builds one decode
        replica (the factory owns model/params/mesh placement; replicas
        must share the router's `classes` so affinity scopes and class
        semantics agree). `store`, when given, receives a CRC-sealed
        snapshot of every drained replica under
        ``{ckpt_prefix}{id}/...`` before its work is redistributed —
        the snapshot exists even if redistribution is interrupted."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._factory = engine_factory
        self.classes = dict(classes) if classes else None
        self.clock = clock
        self.store = store
        self.ckpt_prefix = ckpt_prefix
        self.rebalance_backlog = rebalance_backlog
        self.rebinds = 0  # affinity moves under load skew
        self._lock = threading.Lock()
        self._replicas: Dict[int, object] = {}
        self._next_id = 0
        # session affinity: prefix scope -> replica id (sticky until the
        # replica leaves; rebinding is lazy, at the next submit)
        self._affinity: Dict[object, int] = {}
        # rid -> (replica id, replayable Request) for every accepted,
        # not-yet-collected request — the loss-recovery ledger — plus
        # the incrementally-maintained per-replica outstanding COUNT
        # (routing reads it on every submit and redistribution moves
        # whole snapshots through it; rescanning the ledger per lookup
        # would make one scale-in O(outstanding^2) under the lock)
        self._outstanding: Dict[str, tuple] = {}
        self._load: Dict[int, int] = {}
        self.completions: Dict[str, Completion] = {}
        self.events: List[ScaleEvent] = []
        self._max_events = max_events
        self.chip_seconds = 0.0
        self._last_accrue = float(clock())
        self._gen = 0  # per-router scale-event sequence (checkpoint gens)
        for _ in range(replicas):
            self._add_replica_locked_entry()

    # -- construction helpers ---------------------------------------------
    def _add_replica_locked_entry(self) -> int:
        """Build + register one replica (constructor path: no fault
        point — the initial gang is not a scale event)."""
        eng = self._factory(self._next_id)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._replicas[rid] = eng
            self._load[rid] = 0
        return rid

    # -- outstanding ledger (caller holds the lock) ------------------------
    def _track_locked(self, rid: str, rep: int, req: Request) -> None:
        self._untrack_locked(rid)  # a re-route replaces, never double-counts
        self._outstanding[rid] = (rep, req)
        if rep in self._load:
            self._load[rep] += 1

    def _untrack_locked(self, rid: str) -> None:
        ent = self._outstanding.pop(rid, None)
        if ent is not None and ent[0] in self._load:
            self._load[ent[0]] -= 1

    # -- routing -----------------------------------------------------------
    def _scope_of(self, klass: str, tenant: str):
        return prefix_scope(self.classes, klass, tenant)

    def _replica_for_locked(self, scope) -> int:
        """Scope->replica binding: sticky (warm prefix blocks) until
        the bound replica's outstanding backlog exceeds the least-
        loaded replica's by more than `rebalance_backlog`, then the
        scope REBINDS to the least-loaded replica (a cold preamble
        rebuild beats the queue). Unbound/orphaned scopes bind
        least-loaded. All choices deterministic (ties to the lowest
        id) — a trace replay re-derives the same routing."""
        load = self._load
        coldest = min(sorted(self._replicas), key=lambda r: (load[r], r))
        rid = self._affinity.get(scope)
        if rid is not None and rid in self._replicas:
            if load[rid] - load[coldest] <= self.rebalance_backlog:
                return rid
            self.rebinds += 1  # skew exceeded: pay the cold rebuild
        self._affinity[scope] = coldest
        return coldest

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
        """Route one request to its affinity replica and submit it.
        ``router.route`` fires BEFORE any state changes: a transient
        chaos fault propagates with nothing routed (the caller retries
        and the replay routes identically). `QueueFullError` propagates
        from the target replica — a shed is a shed, counted in that
        replica's per-class metrics."""
        scope = self._scope_of(klass, tenant)
        faults.fire("router.route", rid=rid, tenant=tenant, klass=klass)
        with self._lock:
            target = self._replica_for_locked(scope)
            eng = self._replicas[target]
        out_rid = eng.submit(
            prompt,
            max_new_tokens,
            rid=rid,
            seed=seed,
            arrival_time=arrival_time,
            tenant=tenant,
            klass=klass,
        )
        # the loss-recovery ledger tracks a replayable copy: same
        # prompt/seed/budget/class as the accepted request, so a
        # resubmit after replica loss replays token-identically
        tracked = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            rid=out_rid,
            seed=seed,
            tenant=tenant,
            klass=klass,
        )
        tracked.arrival_time = (
            float(self.clock()) if arrival_time is None else arrival_time
        )
        with self._lock:
            self._track_locked(out_rid, target, tracked)
        return out_rid

    # -- stepping ----------------------------------------------------------
    def _accrue_locked(self, now: float) -> None:
        self.chip_seconds += max(now - self._last_accrue, 0.0) * len(
            self._replicas
        )
        self._last_accrue = now

    def step(self) -> bool:
        """Advance every replica one engine step (data-parallel: real
        deployments step replicas concurrently on their own chips, so
        one router step costs ONE step-time regardless of width — the
        chip-seconds integral, not the step count, is what width
        changes). Collects finished completions. Returns True while any
        replica holds or queues work."""
        with self._lock:
            self._accrue_locked(float(self.clock()))
            replicas = list(self._replicas.values())
        busy = False
        for eng in replicas:
            busy = eng.step() or busy
        self._collect()
        return busy

    def _settle_engine(self, eng) -> None:
        """Merge one engine's finished completions and its class-shed
        victims out, settling the outstanding ledger. MUST run against
        a replica before it leaves the tables (scale-in, loss): a shed
        request lives in neither the drain snapshot's "requests" nor
        its "queued" (it never ran and never will), so skipping this
        would strand its ledger entry forever — `pending` never reaches
        zero — and a loss would even re-serve work already reported
        shed."""
        done: Dict[str, Completion] = {}
        if eng.completions:
            done = eng.completions
            eng.completions = {}
        shed = list(eng.shed_requests)
        for srid in shed:
            eng.shed_requests.pop(srid)
        if done or shed:
            with self._lock:
                self.completions.update(done)
                for crid in done:
                    self._untrack_locked(crid)
                for srid in shed:
                    self._untrack_locked(srid)

    def _collect(self) -> None:
        with self._lock:
            replicas = list(self._replicas.values())
        for eng in replicas:
            self._settle_engine(eng)

    def run(self, max_steps: Optional[int] = None) -> Dict[str, Completion]:
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(
                    f"serve router did not drain within {max_steps} steps "
                    f"(outstanding={len(self._outstanding)})"
                )
        return self.completions

    # -- scale seams (driven by serve/autoscale.py) ------------------------
    def add_replica(self) -> int:
        """Scale out by one replica. ``serve.scale_out`` fires FIRST: a
        transient chaos fault aborts with the gang unchanged. The new
        replica starts cold (empty pool, empty prefix index) and takes
        load as new scopes bind to it — existing scopes stay put, so a
        scale-out never disturbs a warm tenant."""
        with self._lock:
            n = len(self._replicas)
        faults.fire("serve.scale_out", replicas=n)
        rid = self._add_replica_locked_entry()
        with self._lock:
            now = float(self.clock())
            self._accrue_locked(now)
            self._note_event_locked(
                ScaleEvent(now, "add", rid, len(self._replicas))
            )
        return rid

    def remove_replica(self, replica_id: Optional[int] = None) -> int:
        """Scale in by one replica, token-exact: fire ``serve.scale_in``
        (transient fault => abort, victim untouched), `drain()` the
        victim at a step boundary (the drain seam — device lanes quiesced,
        in-flight requeued, JSON snapshot cut), seal the snapshot into
        the store when one is attached, then redistribute every
        checkpointed request into the survivors by affinity. The last
        replica is never removable — un-drained work must always have a
        live replica to land on. Returns the removed id."""
        with self._lock:
            if len(self._replicas) <= 1:
                raise ValueError(
                    "cannot remove the last replica (its un-drained work "
                    "would have nowhere to live)"
                )
            victim = (
                replica_id
                if replica_id is not None
                else self._victim_locked()
            )
            if victim not in self._replicas:
                raise KeyError(f"no replica {victim}")
            eng = self._replicas[victim]
        faults.fire(
            "serve.scale_in", replica=victim, pending=eng.pending
        )
        state = eng.drain()
        self._gen += 1
        if self.store is not None:
            # the snapshot outlives even an interrupted redistribution
            save_serve_state(
                self.store,
                self._gen,
                state,
                key_prefix=f"{self.ckpt_prefix}{victim}",
            )
        self._settle_engine(eng)  # finished + shed leave the ledger
        with self._lock:
            now = float(self.clock())
            self._accrue_locked(now)
            del self._replicas[victim]
            self._load.pop(victim, None)
            for scope in [
                s for s, r in self._affinity.items() if r == victim
            ]:
                del self._affinity[scope]
            moved = self._redistribute_locked(state)
            self._note_event_locked(
                ScaleEvent(
                    now, "remove", victim, len(self._replicas), moved
                )
            )
        return victim

    def _victim_locked(self) -> int:
        """Scale-in victim choice: the replica with the least pending
        work (cheapest drain), ties to the HIGHEST id — the newest
        replica has the coldest prefix cache, so removing it forfeits
        the least warmth."""
        return min(
            sorted(self._replicas),
            key=lambda r: (self._replicas[r].pending, -r),
        )

    def _redistribute_locked(self, state: Dict) -> int:
        """Land a drained replica's snapshot in the survivors (caller
        holds the lock; the victim is already out of the tables so
        affinity rebinding cannot pick it). Engine-accepted work
        (snapshot "requests", arrival order) re-enters through the
        survivors' `requeue_front` in reverse — bounds must not shed
        it; the never-admitted backlog ("queued") re-enters through
        `restore_tail`, staying sheddable. Returns requests moved."""
        accepted = [Request.from_state(d) for d in state.get("requests", [])]
        backlog = [Request.from_state(d) for d in state.get("queued", [])]
        for req in reversed(accepted):
            target = self._replica_for_locked(
                self._scope_of(req.klass, req.tenant)
            )
            self._replicas[target].queue.requeue_front(req)
            self._track_locked(req.rid, target, req)
        for req in backlog:
            target = self._replica_for_locked(
                self._scope_of(req.klass, req.tenant)
            )
            self._replicas[target].queue.restore_tail(req)
            self._track_locked(req.rid, target, req)
        return len(accepted) + len(backlog)

    def lose_replica(self, replica_id: int) -> int:
        """Abrupt replica LOSS (no drain possible — the process is
        gone): unbind its scopes and resubmit its outstanding work to
        survivors from the router-side ledger. Each request replays
        from its seed, token-identically, against a cold prefix cache
        on its new replica. Returns the number of requests re-routed."""
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"no replica {replica_id}")
            if len(self._replicas) <= 1:
                raise ValueError(
                    "lost the last replica: nothing to re-route to"
                )
            eng = self._replicas[replica_id]
        # completions the dead replica already delivered stand, and its
        # shed victims stay shed (resubmitting them would re-serve work
        # already reported displaced)
        self._settle_engine(eng)
        with self._lock:
            now = float(self.clock())
            self._accrue_locked(now)
            del self._replicas[replica_id]
            self._load.pop(replica_id, None)
            for scope in [
                s for s, r in self._affinity.items() if r == replica_id
            ]:
                del self._affinity[scope]
            orphans = sorted(
                (
                    req
                    for (r, req) in self._outstanding.values()
                    if r == replica_id
                ),
                key=lambda q: q.arrival_time,
            )
            for req in orphans:
                req.requeues += 1
                req.first_token_time = None
                target = self._replica_for_locked(
                    self._scope_of(req.klass, req.tenant)
                )
                self._replicas[target].queue.requeue_front(req)
                self._track_locked(req.rid, target, req)
            self._note_event_locked(
                ScaleEvent(
                    now,
                    "lose",
                    replica_id,
                    len(self._replicas),
                    len(orphans),
                )
            )
            return len(orphans)

    def _note_event_locked(self, ev: ScaleEvent) -> None:
        self.events.append(ev)
        if len(self.events) > self._max_events:
            del self.events[: len(self.events) - self._max_events]

    # -- introspection -----------------------------------------------------
    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._outstanding)

    def replica_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    def window_view(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """Gang-wide rolling window: the per-replica `ServeMetrics`
        windows merged EXACTLY by `metrics.merge_window_views` (sums of
        raw slo_met/slo_n counts, not averages of ratios; queue depth
        sums, occupancy/pool pressure average). The controller steers
        on this view — the SAME merge the disaggregated pools use, so
        one- and two-pool controllers read identical evidence."""
        from .metrics import merge_window_views

        if now is None:
            now = float(self.clock())
        with self._lock:
            replicas = dict(self._replicas)
        views = [
            eng.metrics.window_view(window_s=window_s, now=now)
            for _, eng in sorted(replicas.items())
        ]
        return merge_window_views(views, now, window_s=window_s)

    def snapshot(self) -> Dict:
        """JSON for the debug HTTP frontend — register the router like
        a metrics object (`register_serve_metrics("router", router)`)
        and ``/serve`` shows the gang: per-replica gauges, the affinity
        table size, scale events, and the chip-seconds integral."""
        with self._lock:
            now = float(self.clock())
            self._accrue_locked(now)
            replicas = dict(self._replicas)
            out = {
                "replicas": {
                    str(r): {
                        "pending": eng.pending,
                        "queue_depth": eng.queue.depth,
                        "slots_active": eng.num_active,
                        "completed": eng.metrics.completed,
                        # affinity evidence: hot scopes show up as hits
                        "prefix_hits": eng.metrics.prefix_hits,
                        "prefix_misses": eng.metrics.prefix_misses,
                    }
                    for r, eng in sorted(replicas.items())
                },
                "num_replicas": len(replicas),
                "outstanding": len(self._outstanding),
                "affinity_scopes": len(self._affinity),
                "rebinds": self.rebinds,
                "completions": len(self.completions),
                "chip_seconds": round(self.chip_seconds, 6),
                "events": [e.to_state() for e in self.events[-32:]],
            }
        out["window"] = self.window_view(now=now)
        return out
