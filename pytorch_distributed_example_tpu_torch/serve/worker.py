"""Serve worker daemon — the process-level half of elastic serving.

A copy of the reference's `serve/worker.py`, re-pointed at the port's
`faults`, `store`, `types`, `serve.elastic`, `serve.queue` and elastic
agent. Its store keys and the JSON of its ledger items and completion
rows are the reference's byte for byte, so a reference `GangRouter` can
feed port workers over one store, and back.

The autoscaler (`serve/autoscale.py`) closes the scaling loop
in-process; this module closes it at PROCESS granularity: one `ServeWorker` per elastic-
agent gang member runs a `ServeEngine` loop against a shared work
ledger in the agent's store, and the full drain → seal → resize →
restore → re-register lifecycle survives real process death.

The store contract (all keys live on the agent's rendezvous store):

* **ledger** — the front door (`GangRouter.submit`) allocates a
  sequence from the ``serve/work/head`` counter and publishes the
  request under ``serve/work/item/{seq}`` (plus a ``serve/work/rid/
  {rid}`` → seq index). Items are retained until their completion is
  published — the ledger IS the replay authority: a worker SIGKILLed
  mid-request leaves the item in place, and the next generation serves
  it again from its seed, token-identically.
* **claims** — workers race ``compare_set`` on ``serve/work/claim/
  gen{g}/{seq}``. Claims are GENERATION-scoped: a re-formed gang
  (any width) rescans the ledger and re-claims everything not yet
  done, which is exactly how work redistributes across a resize —
  W_old planes fan out over W_new claimants with no coordinator.
* **completions** — ``serve/done/{rid}`` holds the completion's token
  ids. Done-before-claim checks make duplicate service impossible to
  observe (and greedy replay-from-seed makes the rare double-serve
  race emit byte-identical tokens anyway).
* **drain/seal** — on ``serve/drain/gen{g}`` (the agent's resize/
  restart teardown signal) each worker drains its engine at a step
  boundary and seals the snapshot into its own per-rank plane
  ``serve/ckpt/w{rank}`` through `serve/elastic.py` (CRC manifest,
  newest-verified fallback), then exits 0 inside
  ``serve_drain_grace_s``.
* **restore** — at the NEW generation a restore leader (the
  ``compare_set`` winner on ``serve/restored/gen{g}``) fires
  ``serve.restore_geometry``, walks every per-rank plane with
  `load_serve_state` (corrupt newest generations fall back), adopts
  the merged in-flight work into ITS engine via `restore_into` (the
  recovery-time window closes at its first post-restore token), marks
  the adopted rids claimed at this generation, then reclaims dead
  snapshot generations with `gc_serve_state`. Followers wait for the
  leader's done-marker (bounded — a crashed leader defers its adopted
  work to the NEXT generation's rescan, never loses it).
* **registration** — ``serve/worker/gen{g}/rank{r}`` (pid + geometry
  JSON) is the router's membership view; `wait_registered` is how
  tests and the front door await a formed generation.
* **pool roles** — ``serve/role/gen{g}/rank{r}`` is a worker's
  disaggregated pool membership (prefill/decode/both, `serve/disagg/`)
  as a generation-scoped CAS claim (`claim_role`): replays adopt the
  generation's recorded role, resizes change roles only by changing
  generation, `pool_members` reads the topology, and the same
  `gc_worker_state` sweep that retires a generation's registration
  rows retires its role claims.

Fault surface (all in `faults.KNOWN_POINTS`): ``serve.worker.start``
fires at process start before any store key is touched — a transient
fault retries in place, a crash re-forms the gang at a consistent
size (elastic agents shrink to the surviving width) with the ledger
intact. ``serve.worker.register`` fires before the
generation-scoped registration write (idempotent retry).
``serve.restore_geometry`` fires before the leader walks the planes —
nothing has been republished yet, so transient faults retry and a
crash defers restore to the next generation's leader.

Autoscaler wiring: `GangRouter.window_view` merges the per-rank live
metrics rows into exactly the shape `serve/autoscale.py` steers on,
and `ElasticGangScaler` adapts the controller's ``add_replica`` /
``remove_replica`` calls onto `elastic.request_resize` — so the
autoscaler's policy drives REAL gang re-formation with no controller changes.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

from .. import faults
from ..elastic.agent import request_resize
from ..store import TCPStore
from ..types import DistError
from .elastic import (
    drain_requested,
    gc_serve_state,
    load_serve_state,
    restore_into,
    save_serve_state,
)
from .queue import DEFAULT_CLASS, Request

__all__ = [
    "ServeWorker",
    "GangRouter",
    "ElasticGangScaler",
    "wait_registered",
    "worker_store_from_env",
    "claim_role",
    "pool_members",
]

# Store keys. Ledger items/claims carry their scope in the key (seq /
# gen); rid-addressed keys are reclaimed by `GangRouter.shutdown`'s
# sweep (the project-wide delete for their prefixes).
_HEAD_KEY = "serve/work/head"
_SHUTDOWN_KEY = "serve/shutdown"
_PLANE_FMT = "serve/ckpt/w{rank}"
# How many per-rank snapshot planes / metrics rows a scan visits: the
# widest gang any single-node agent can form (nproc_per_node is far
# below this in practice).
_MAX_RANKS = 64

# Transient taxonomy shared with the engine/autoscaler retry layers.
_TRANSIENT = (ConnectionResetError, faults.FaultTimeout)

# Chaos knob for the drain-grace tests: a worker whose generation
# matches this env var ignores the drain request (simulating a wedged
# checkpoint) and must be SIGTERM'd by the agent at grace expiry.
_WEDGE_ENV = "TDX_SERVE_WEDGE_GEN"


def _item_key(seq: int) -> str:
    return f"serve/work/item/{seq}"


def _rid_key(rid: str) -> str:
    return f"serve/work/rid/{rid}"


def _claim_key(gen: int, seq: int) -> str:
    return f"serve/work/claim/gen{gen}/{seq}"


def _done_key(rid: str) -> str:
    return f"serve/done/{rid}"


def _reg_key(gen: int, rank: int) -> str:
    return f"serve/worker/gen{gen}/rank{rank}"


def _role_key(gen: int, rank: int) -> str:
    return f"serve/role/gen{gen}/rank{rank}"


def _fire_with_retry(point: str, attempts: int = 5, **ctx) -> None:
    """Fire a fault point, absorbing TRANSIENT faults with a short
    backoff — the worker's lifecycle seams must survive a flaky store,
    not die on the first reset. Exhausted retries escalate to
    `DistError`: the process exits nonzero and the agent re-forms the
    gang at the same size (the ledger replays everything)."""
    for i in range(attempts):
        try:
            faults.fire(point, **ctx)
            return
        except _TRANSIENT:
            time.sleep(0.05 * (i + 1))
    raise DistError(f"{point}: transient faults exhausted {attempts} retries")


def worker_store_from_env(timeout: float = 60.0) -> TCPStore:
    """Connect a store client from the elastic agent's worker env
    (`TDX_AGENT_STORE`="host:port") — the contract `elastic/agent.py`
    exports to every spawned gang member."""
    ep = os.environ.get("TDX_AGENT_STORE", "")
    host, _, port = ep.rpartition(":")
    if not host or not port.isdigit():
        raise DistError(
            f"TDX_AGENT_STORE missing or malformed ({ep!r}) — ServeWorker "
            f"must run under the elastic agent (or pass a store directly)"
        )
    return TCPStore(host, int(port), is_master=False, timeout=timeout)


def wait_registered(
    store, gen: int, n: int, timeout: float = 30.0
) -> List[Dict]:
    """Block until `n` workers of generation `gen` have registered;
    returns their registration rows (pid + geometry). The front door
    and the process-level tests use this to await a formed gang."""
    deadline = time.monotonic() + timeout
    while True:
        rows = []
        for r in range(n):
            try:
                if store.check([_reg_key(gen, r)]):
                    rows.append(json.loads(store.get(_reg_key(gen, r))))
            except Exception:
                rows = []
                break
        if len(rows) >= n:
            return rows
        if time.monotonic() > deadline:
            raise DistError(
                f"gen{gen}: {len(rows)}/{n} workers registered within "
                f"{timeout}s"
            )
        time.sleep(0.02)


def claim_role(store, gen: int, rank: int, role: str = "both") -> str:
    """Publish this worker's pool membership (`prefill`/`decode`/
    `both`) as a GENERATION-SCOPED CLAIM — a CAS on
    `serve/role/gen{g}/rank{r}` — and return the role that WON. The CAS
    makes role assignment idempotent across replays: a restarted worker
    (or a planner re-issuing assignments after a transient fault)
    adopts whatever role the generation already recorded for this rank,
    so the two pools' geometry cannot flap mid-generation; a RESIZE
    changes roles only by changing generation. `serve.pool.assign`
    fires BEFORE the claim — a transient fault there retries with
    nothing claimed, and a crash leaves the rank unclaimed for the
    re-formed gang to claim afresh."""
    if role not in ("both", "prefill", "decode"):
        raise DistError(f"unknown worker role {role!r}")
    _fire_with_retry("serve.pool.assign", rank=rank, gen=gen, role=role)
    key = _role_key(gen, rank)
    try:
        won = store.compare_set(key, b"", role.encode())
    except Exception:
        return role  # store hiccup: run the requested role, claim is
        #              re-attempted by the next generation's entry
    try:
        return (won or role.encode()).decode()
    except Exception:
        return role


def pool_members(store, gen: int, n: int) -> Dict[str, List[int]]:
    """Read generation `gen`'s claimed pool topology: role → sorted
    ranks, for up to `n` ranks (the router/autoscaler's view of which
    workers form the prefill pool vs the decode pool). Unclaimed ranks
    are reported under "both" — a colocated worker serves either
    plane."""
    out: Dict[str, List[int]] = {"prefill": [], "decode": [], "both": []}
    for r in range(n):
        role = "both"
        try:
            if store.check([_role_key(gen, r)]):
                role = store.get(_role_key(gen, r)).decode()
        except Exception:
            pass
        out.setdefault(role, []).append(r)
    return out


def gc_worker_state(store, gen: int, keep: int = 2, back: int = 16) -> int:
    """Reclaim per-generation coordination rows from retired gangs:
    worker registration rows (`serve/worker/gen{g}/rank{r}`) and
    leader-election restore markers (`serve/restored/gen{g}`[+`/done`])
    older than the newest `keep` generations, plus retired generations'
    pool-role claims (`serve/role/gen{g}/rank{r}` — a role claim is
    meaningful only while its generation serves, so the sweep that
    retires the registration rows retires the roles with them). Without
    this every resize leaked one marker pair plus rows per rank for the
    store daemon's lifetime (storelint S005). Called by the restore
    leader —
    exactly one walker per generation, and by the time gen G's leader
    runs, nothing can still poll a scope older than G-1 (followers of
    a LIVE generation poll only their own marker). Returns the number
    of keys deleted; best-effort, a partial sweep is retried by the
    next generation's leader."""
    _fire_with_retry("serve.worker.gc", gen=gen)
    deleted = 0
    floor = gen - keep + 1
    for g in range(max(0, gen - back), max(0, floor)):
        try:
            for r in range(_MAX_RANKS):
                if store.delete_key(_reg_key(g, r)):
                    deleted += 1
                if store.delete_key(_role_key(g, r)):
                    deleted += 1
            if store.delete_key(f"serve/restored/gen{g}"):
                deleted += 1
            if store.delete_key(f"serve/restored/gen{g}/done"):
                deleted += 1
        except Exception:
            return deleted
    return deleted


class ServeWorker:
    """One gang member's serve daemon: claim → serve → publish, with
    the drain/seal/restore lifecycle at generation boundaries.

    Single-owner like the engine it drives: construct and `start()` it
    once per process (the examples entrypoint), or in-process for the
    deterministic unit tests (any store object with the `store.py`
    surface works, including `HashStore`)."""

    def __init__(
        self,
        store,
        engine,
        rank: int,
        gen: int = 0,
        poll_interval_s: float = 0.005,
        metrics_interval_s: float = 0.25,
        claim_depth: Optional[int] = None,
        leader_wait_s: float = 10.0,
        clock=time.time,
        role: str = "both",
    ):
        self.store = store
        self.engine = engine
        self.rank = int(rank)
        self.gen = int(gen)
        # requested pool membership; the GENERATION's claim wins at
        # start() (claim_role CAS) and is mirrored onto the engine
        self.role = role
        self.poll_interval_s = poll_interval_s
        self.metrics_interval_s = metrics_interval_s
        # how much queued-but-unserved work this worker will hold: claim
        # ahead of the slots so admission never starves, but leave the
        # rest of the ledger for peers (work-stealing balance)
        self.claim_depth = (
            claim_depth
            if claim_depth is not None
            else max(2 * len(engine._slot_req), 8)
        )
        self.leader_wait_s = leader_wait_s
        self.clock = clock
        self.is_leader = False
        self.restored = 0
        self._cursor = 1  # next ledger seq to examine
        self._claimed: set = set()  # seqs this PROCESS claimed
        self._published: set = set()  # rids whose done key we wrote
        self._missing: dict = {}  # seq -> first time seen headless
        self._missing_grace_s = 5.0
        self._last_metrics = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServeWorker":
        """Run the generation-entry protocol: the start fault point,
        the pool-role claim (disagg — the generation's CAS'd role wins
        over the requested one and is mirrored onto the engine), then
        leader-elected geometry restore and registration."""
        _fire_with_retry(
            "serve.worker.start", rank=self.rank, gen=self.gen
        )
        self.role = claim_role(self.store, self.gen, self.rank, self.role)
        if getattr(self.engine, "role", self.role) != self.role:
            self.engine.role = self.role
        self._restore_geometry()
        self._register()
        return self

    def _restore_geometry(self) -> None:
        """Leader-elected restore at the NEW geometry. Exactly one
        worker per generation walks the per-rank snapshot planes; the
        rest wait (bounded) for its done-marker so they don't race it
        to the ledger."""
        marker = f"serve/restored/gen{self.gen}"
        mine = str(self.rank).encode()
        try:
            won = self.store.compare_set(marker, b"", mine)
        except Exception:
            won = None
        if won != mine:
            # follower: bounded wait — a crashed leader's adopted work
            # is deferred to the NEXT generation's rescan, not lost
            deadline = time.monotonic() + self.leader_wait_s
            while time.monotonic() < deadline:
                try:
                    if self.store.check([f"{marker}/done"]):
                        break
                except Exception:
                    pass
                time.sleep(0.02)
            return
        self.is_leader = True
        _fire_with_retry(
            "serve.restore_geometry", rank=self.rank, gen=self.gen
        )
        merged: Dict = {"requests": [], "queued": [], "emitted": {}}
        anchor = 0.0
        newest = -1
        for r in range(_MAX_RANKS):
            plane = _PLANE_FMT.format(rank=r)
            try:
                if not self.store.check([f"{plane}/latest"]):
                    continue
            except Exception:
                continue
            state, vgen = load_serve_state(self.store, key_prefix=plane)
            if state is None:
                continue
            for field in ("requests", "queued"):
                for d in state.get(field, []):
                    if not self._is_done(d.get("rid", "")):
                        merged[field].append(d)
            merged["emitted"].update(state.get("emitted", {}))
            anchor = max(anchor, float(state.get("checkpoint_time", 0.0)))
            newest = max(newest, vgen)
            # snapshot-generation GC: sealed blobs older than the
            # newest-VERIFIED generation minus the fallback margin
            gc_serve_state(self.store, vgen, keep=2, key_prefix=plane)
        if merged["requests"] or merged["queued"]:
            merged["checkpoint_time"] = anchor
            self.restored = restore_into(self.engine, merged, newest)
            # adopted rids are claimed at THIS generation so peers skip
            # them on the ledger rescan (their items stay until done)
            for d in merged["requests"] + merged["queued"]:
                self._claim_restored(d.get("rid", ""))
        try:
            self.store.set(f"{marker}/done", b"1")
        except Exception:
            pass  # followers fall through their bounded wait
        try:
            gc_worker_state(self.store, self.gen)
        except Exception:
            pass  # reclaim is deferred to the next generation's leader

    def _claim_restored(self, rid: str) -> None:
        """Stamp this generation's claim for a snapshot-adopted rid (via
        the rid → seq index) so the ledger rescan skips it."""
        if not rid:
            return
        try:
            if not self.store.check([_rid_key(rid)]):
                return
            seq = int(self.store.get(_rid_key(rid)).decode())
        except Exception:
            return
        try:
            self.store.set(  # storelint: disable=S005 -- generation-scoped claims must outlive their gen for replay dedup; every historical gen would need sweeping, so only store death reclaims them
                _claim_key(self.gen, seq), str(self.rank).encode()
            )
            self._claimed.add(seq)
        except Exception:
            pass  # worst case a peer double-serves; done-write idempotent

    def _register(self) -> None:
        """Announce this (gen, rank) membership row — the router's view
        of the formed gang. Idempotent, so transient faults just retry."""
        _fire_with_retry(
            "serve.worker.register", rank=self.rank, gen=self.gen
        )
        row = json.dumps(
            {
                "pid": os.getpid(),
                "rank": self.rank,
                "gen": self.gen,
                "world": int(os.environ.get("WORLD_SIZE", "0") or 0),
                "slots": len(self.engine._slot_req),
                "role": self.role,
                "t": float(self.clock()),
            }
        ).encode()
        for i in range(5):
            try:
                self.store.set(_reg_key(self.gen, self.rank), row)
                return
            except _TRANSIENT:
                time.sleep(0.05 * (i + 1))
        raise DistError(
            f"rank{self.rank}: registration kept failing at gen{self.gen}"
        )

    def _deregister(self) -> None:
        """Terminal-exit counterpart of `_register`: remove this
        worker's membership row and live metrics row so a shut-down
        plane leaves no stale gang view behind (drained generations
        instead leave the rows for `gc_worker_state`, because the NEXT
        generation's restore wants the old geometry visible)."""
        for key in (
            _reg_key(self.gen, self.rank),
            f"serve/metrics/rank{self.rank}",
        ):
            try:
                self.store.delete_key(key)
            except Exception:
                return  # best-effort: the router's sweep also covers us

    # -- ledger ------------------------------------------------------------
    def _is_done(self, rid: str) -> bool:
        try:
            return bool(rid) and bool(self.store.check([_done_key(rid)]))
        except Exception:
            return False

    def _claim_available(self) -> int:
        """Scan the ledger from this worker's cursor, claiming items
        (generation-scoped CAS) until the engine is claim_depth deep.
        Returns how many requests were newly admitted."""
        try:
            head = self.store.add(_HEAD_KEY, 0)  # distlint: disable=R007 -- value-managed counter; items carry the seq scope
        except Exception:
            return 0
        admitted = 0
        mine = str(self.rank).encode()
        while (
            self._cursor <= head
            and self.engine.queue.depth < self.claim_depth
        ):
            seq = self._cursor
            self._cursor += 1
            if seq in self._claimed:
                continue
            key = _item_key(seq)
            try:
                if not self.store.check([key]):
                    # the front door bumps head BEFORE the item body
                    # lands (two store ops) — a scanning worker can
                    # observe the gap. Grace-wait before concluding the
                    # item was swept, or the request is lost forever.
                    first = self._missing.setdefault(seq, self.clock())
                    if self.clock() - first < self._missing_grace_s:
                        self._cursor = seq
                        break
                    continue  # swept (already completed + cleaned)
                self._missing.pop(seq, None)
                state = json.loads(self.store.get(key))
            except Exception:
                self._cursor = seq  # store hiccup: retry this seq later
                break
            rid = state.get("rid", "")
            if self._is_done(rid):
                continue
            try:
                got = self.store.compare_set(
                    _claim_key(self.gen, seq), b"", mine
                )
            except Exception:
                self._cursor = seq
                break
            if got != mine:
                continue  # a peer won this item
            self._claimed.add(seq)
            req = Request.from_state(state)
            self.engine.submit(
                req.prompt,
                req.max_new_tokens,
                rid=req.rid,
                seed=req.seed,
                arrival_time=req.arrival_time,
                tenant=req.tenant,
                klass=req.klass,
            )
            admitted += 1
        return admitted

    def _publish_completions(self) -> int:
        """Write `serve/done/{rid}` for every newly finished request —
        the write that releases the ledger item (rid-addressed; swept
        by `GangRouter.shutdown`)."""
        n = 0
        for rid, comp in list(self.engine.completions.items()):
            if rid in self._published:
                continue
            blob = json.dumps(
                {
                    "rid": rid,
                    "tokens": [int(t) for t in comp.tokens],
                    "finish_reason": comp.finish_reason,
                    "rank": self.rank,
                    "gen": self.gen,
                }
            ).encode()
            try:
                self.store.set(_done_key(rid), blob)
            except Exception:
                continue  # retry next loop; item stays claimed
            self._published.add(rid)
            n += 1
        return n

    def _publish_metrics(self, force: bool = False) -> None:
        """Refresh this rank's live metrics row (engine window view +
        queue/slot occupancy) — the rows `GangRouter.window_view`
        merges for the autoscaler. Overwritten in place; readers filter
        staleness by the embedded wall-clock timestamp."""
        now = time.monotonic()
        if not force and now - self._last_metrics < self.metrics_interval_s:
            return
        self._last_metrics = now
        row = json.dumps(
            {
                "t": float(self.clock()),
                "gen": self.gen,
                "rank": self.rank,
                "view": self.engine.metrics.window_view(),
            }
        ).encode()
        try:
            self.store.set(f"serve/metrics/rank{self.rank}", row)
        except Exception:
            pass

    # -- main loop ---------------------------------------------------------
    def serve_forever(self, max_loops: Optional[int] = None) -> str:
        """Claim/serve/publish until the agent asks this generation to
        drain (seal + exit) or the plane is shut down. Never exits on
        an idle ledger — an all-zero gang exit would read as SUCCEEDED
        to the agent and tear the deployment down. Returns the exit
        reason ("drained" | "shutdown" | "max_loops")."""
        loops = 0
        while True:
            loops += 1
            if max_loops is not None and loops > max_loops:
                return "max_loops"
            try:
                if self.store.check([_SHUTDOWN_KEY]):
                    self._publish_completions()
                    self._publish_metrics(force=True)
                    self._deregister()
                    return "shutdown"
            except Exception:
                pass
            if drain_requested(self.store, self.gen):
                if os.environ.get(_WEDGE_ENV, "") == str(self.gen):
                    # chaos knob: simulate a wedged checkpoint — the
                    # agent must SIGTERM us at grace expiry and the
                    # ledger must replay our claims next generation
                    time.sleep(3600.0)
                self._drain_and_seal()
                return "drained"
            self._claim_available()
            had_work = self.engine.step()
            self._publish_completions()
            self._publish_metrics()
            if not had_work:
                time.sleep(self.poll_interval_s)

    def _drain_and_seal(self) -> None:
        """The teardown half of the lifecycle: stop at a step boundary,
        seal the drain snapshot into this rank's plane, leave. Runs
        inside `serve_drain_grace_s` — the agent SIGTERMs laggards."""
        self._publish_completions()
        state = self.engine.drain()
        save_serve_state(
            self.store,
            self.gen,
            state,
            key_prefix=_PLANE_FMT.format(rank=self.rank),
        )
        self._publish_metrics(force=True)


# ---------------------------------------------------------------------------
# Front door + autoscaler adapter
# ---------------------------------------------------------------------------


class GangRouter:
    """Client-side front door for a worker gang: publishes requests
    into the store ledger, collects completions, and merges the
    per-rank live metrics rows into the exact window shape the
    autoscaler steers on (`ServeRouter.window_view` parity: sums of
    raw slo counts, summed queue depth, averaged occupancy/pool).

    Runs in the CONTROLLER process (load harness, tests, operators) —
    workers never see this class, only the store keys it writes."""

    def __init__(self, store, clock=time.time, stale_s: float = 10.0):
        self.store = store
        self.clock = clock
        self.stale_s = stale_s
        self._rids: List[str] = []
        self._next = 0

    # -- submission --------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        rid: Optional[str] = None,
        seed: int = 0,
        tenant: str = "",
        klass: str = DEFAULT_CLASS,
    ) -> str:
        """Publish one request into the ledger; returns its rid. The
        item key carries the allocated seq; the rid index lets the
        restore leader map snapshots back to ledger entries."""
        if rid is None:
            rid = f"g{os.getpid()}-{self._next}"
            self._next += 1
        req = Request(
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            rid=rid,
            seed=int(seed),
            tenant=tenant,
            klass=klass,
        )
        req.arrival_time = float(self.clock())
        seq = self.store.add(_HEAD_KEY, 1)  # distlint: disable=R007 -- value-managed counter; items carry the seq scope
        self.store.set(
            _item_key(seq), json.dumps(req.to_state()).encode()
        )
        self.store.set(_rid_key(rid), str(int(seq)).encode())
        self._rids.append(rid)
        return rid

    # -- results -----------------------------------------------------------
    def result(self, rid: str) -> Optional[Dict]:
        """The completion row for `rid`, or None while in flight."""
        try:
            if not self.store.check([_done_key(rid)]):
                return None
            return json.loads(self.store.get(_done_key(rid)))
        except Exception:
            return None

    def wait_all(
        self, rids: Optional[List[str]] = None, timeout: float = 60.0
    ) -> Dict[str, List[int]]:
        """Block until every rid (default: all submitted through this
        router) has a published completion; returns rid → token ids."""
        want = list(rids if rids is not None else self._rids)
        deadline = time.monotonic() + timeout
        out: Dict[str, List[int]] = {}
        while len(out) < len(want):
            for rid in want:
                if rid in out:
                    continue
                row = self.result(rid)
                if row is not None:
                    out[rid] = [int(t) for t in row["tokens"]]
            if len(out) >= len(want):
                break
            if time.monotonic() > deadline:
                missing = [r for r in want if r not in out]
                raise DistError(
                    f"{len(missing)}/{len(want)} requests unfinished "
                    f"after {timeout}s (e.g. {missing[:3]})"
                )
            time.sleep(0.02)
        return out

    # -- autoscaler view ---------------------------------------------------
    def _live_rows(self, now: float) -> List[Dict]:
        rows = []
        for r in range(_MAX_RANKS):
            key = f"serve/metrics/rank{r}"
            try:
                if not self.store.check([key]):
                    continue
                row = json.loads(self.store.get(key))
            except Exception:
                continue
            if now - float(row.get("t", 0.0)) <= self.stale_s:
                rows.append(row)
        return rows

    @property
    def num_replicas(self) -> int:
        return len(self._live_rows(float(self.clock())))

    def window_view(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """`ServeRouter.window_view` parity over the store rows: raw
        slo_met/slo_n sums (10/10 + 0/1 must read 10/11), queue depth
        summed (total backlog), occupancy/pool averaged (per-chip
        pressure). The controller steers on this merged view."""
        if now is None:
            now = float(self.clock())
        views = [r["view"] for r in self._live_rows(now)]
        classes: Dict[str, Dict] = {}
        for v in views:
            for k, row in v.get("classes", {}).items():
                agg = classes.setdefault(
                    k,
                    {"completed": 0, "shed": 0, "slo_met": 0, "slo_n": 0},
                )
                agg["completed"] += row["completed"]
                agg["shed"] += row["shed"]
                agg["slo_met"] += row["slo_met"]
                agg["slo_n"] += row["slo_n"]
        for row in classes.values():
            row["slo_attainment"] = (
                round(row["slo_met"] / row["slo_n"], 4)
                if row["slo_n"]
                else None
            )
        n = max(len(views), 1)
        qd = sum(v["queue_depth_mean"] for v in views)
        return {
            "window_s": views[0]["window_s"] if views else window_s,
            "now": now,
            "replicas": len(views),
            "classes": classes,
            "queue_depth_mean": round(qd, 3),
            "queue_depth_mean_per_replica": round(qd / n, 3),
            "occupancy_mean": round(
                sum(v["occupancy_mean"] for v in views) / n, 4
            ),
            "pool_utilization_mean": round(
                sum(v["pool_utilization_mean"] for v in views) / n, 4
            ),
        }

    def members(self, gen: int) -> List[Dict]:
        """The registration rows of generation `gen` — the controller's
        view of a formed gang (pid, rank, slots, geometry) without the
        blocking semantics of `wait_registered`."""
        rows: List[Dict] = []
        for r in range(_MAX_RANKS):
            key = _reg_key(gen, r)
            try:
                if not self.store.check([key]):
                    continue
                rows.append(json.loads(self.store.get(key)))
            except Exception:
                continue
        return rows

    # -- teardown ----------------------------------------------------------
    def shutdown(self, sweep: bool = True) -> None:
        """Terminal: ask every worker to exit 0 (the agent then reads
        the all-zero gang as SUCCEEDED) and sweep this router's
        rid-addressed keys — the reclaim half of the `serve/done`,
        `serve/work/rid`, `serve/work/item` and `serve/metrics`
        namespaces (item seqs resolved through the rid index BEFORE the
        index rows are dropped)."""
        try:
            self.store.set(_SHUTDOWN_KEY, b"1")  # distlint: disable=R007 -- terminal shutdown sentinel; outliving the last generation is the point
        except Exception:
            pass
        if not sweep:
            return
        for rid in self._rids:
            try:
                if self.store.check([_rid_key(rid)]):
                    seq = int(self.store.get(_rid_key(rid)).decode())
                    self.store.delete_key(_item_key(seq))
                self.store.delete_key(_done_key(rid))
                self.store.delete_key(_rid_key(rid))
            except Exception:
                break
        for r in range(_MAX_RANKS):
            try:
                self.store.delete_key(f"serve/metrics/rank{r}")
            except Exception:
                break


class ElasticGangScaler:
    """Adapter from the autoscaler's replica verbs onto process-level
    gang re-formation: `add_replica`/`remove_replica` publish a
    seq-stamped `request_resize` target at the agent's store endpoint,
    and the agent executes the drain → seal → respawn boundary. Duck-
    compatible with what `Autoscaler` needs from a router (window_view
    + num_replicas come from the wrapped `GangRouter`), so the
    controller drives real resizes unchanged.

    Tracks the requested TARGET (not the live width) so a burst of
    decisions inside one re-formation window composes monotonically
    instead of re-reading a mid-resize replica count."""

    def __init__(self, router: GangRouter, master_addr: str, master_port: int):
        self.router = router
        self.master_addr = master_addr
        self.master_port = int(master_port)
        self._target: Optional[int] = None

    @property
    def num_replicas(self) -> int:
        if self._target is None:
            live = self.router.num_replicas
            self._target = max(live, 1)
        return self._target

    def window_view(self, **kw) -> Dict:
        return self.router.window_view(**kw)

    def add_replica(self) -> int:
        target = self.num_replicas + 1
        faults.fire("serve.scale_out", target=target)
        request_resize(self.master_addr, self.master_port, target)
        self._target = target
        return target

    def remove_replica(self, replica_id: Optional[int] = None) -> int:
        target = max(self.num_replicas - 1, 1)
        faults.fire("serve.scale_in", target=target)
        request_resize(self.master_addr, self.master_port, target)
        self._target = target
        return target
