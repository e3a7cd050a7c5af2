"""Elastic agent: spawn, monitor, and restart a gang of workers.

A copy of the reference's `elastic/agent.py`, re-pointed at the port's
`faults` and `store`. The one divergence: the reference also exports a
JAX coordinator endpoint (``TDX_JAX_COORDINATOR``) to each worker and
reserves the port beside a standby store for it; the port's workers
bring up no JAX, so neither is here.

Parity surface: torchelastic's
`SimpleElasticAgent` (`elastic/agent/server/api.py:455`) — worker spawn,
`_monitor_workers` poll loop (`:499,:924`), gang restart on failure up to
`max_restarts` (`:952-970`, default 3 `:96`), and `LocalElasticAgent`
(`local_elastic_agent.py:118`) which runs workers as local subprocesses.

Per-worker env (the contract the reference's env:// rendezvous reads,
torch `rendezvous.py:258-274`): RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, plus TDX_RESTART_COUNT / TORCHELASTIC_RESTART_COUNT.

The agent hosts the rendezvous TCPStore (native C++ daemon when built) and
re-keys it per restart generation so re-rendezvous is clean.
"""

from __future__ import annotations

import enum
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .. import faults
from ..store import TCPStore


class WorkerState(enum.Enum):
    INIT = "INIT"
    HEALTHY = "HEALTHY"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    # agent-internal: a joiner is waiting and the gang has headroom —
    # re-form at the next generation boundary (torchelastic's
    # num_nodes_waiting poll, elastic/agent/server/api.py:952-970)
    SCALE_UP = "SCALE_UP"
    # agent-internal: a controller published an explicit local gang
    # size (`request_resize` — the serve autoscaler's out-of-process
    # path); re-form at that size at the next generation boundary
    RESIZE = "RESIZE"


@dataclass
class WorkerSpec:
    """What to run — torchelastic WorkerSpec equivalent."""

    entrypoint: Sequence[str]  # argv after `python`, or full argv if raw_cmd
    nproc_per_node: int = 1
    max_restarts: int = 3  # torchelastic default (api.py:96)
    monitor_interval_s: float = 0.1
    master_addr: str = "127.0.0.1"
    master_port: int = 0  # 0 = pick free port (single-node only)
    raw_cmd: bool = False  # entrypoint is a full argv, not a python script
    module: bool = False  # entrypoint is a module name (python -m ...)
    nnodes: int = 1  # torchrun --nnodes
    node_rank: int = 0  # torchrun --node-rank; node 0 hosts the store
    peer_done_timeout_s: float = 600.0  # max finish-time skew across nodes
    # Dynamic world size (torchrun --nnodes=MIN:MAX semantics,
    # run.py:410), at two granularities:
    #
    # * `min_nproc` — the LOCAL worker group is elastic (single node):
    #   `nproc_per_node` is the MAX; a worker failure re-forms the gang
    #   at the surviving size as long as it stays >= min_nproc, and late
    #   joiners (`request_join`) are admitted at the next generation
    #   boundary up to the max.
    # * `min_nnodes` — NODE-level elastic (torchelastic's real --nnodes
    #   semantics): `nnodes` is the MAX node count; agents heartbeat
    #   through the store, a stale peer heartbeat re-forms the gang with
    #   the surviving nodes (>= min_nnodes), node ranks are reassigned
    #   by membership order each generation, and an agent that starts
    #   late (or missed a generation) is admitted at the next boundary.
    #   Node 0 hosts the rendezvous store and is therefore NOT
    #   survivable — the same single-point rendezvous host torch's c10d
    #   rendezvous backend has (torch rendezvous.py:196: rank 0 binds).
    min_nproc: Optional[int] = None
    min_nnodes: Optional[int] = None
    node_settle_s: float = 2.0  # membership settle window per generation
    heartbeat_timeout_s: float = 5.0  # stale-heartbeat node-loss threshold
    quorum_grace_s: float = 60.0  # keep re-forming below min for this long
    # Rendezvous store FAILOVER (beyond torch parity — torch's rank-0
    # TCPStore host is a hard SPOF, rendezvous.py:196): every
    # node-elastic agent runs a cold-standby store daemon and gossips
    # its endpoint inside heartbeats; when the primary store dies,
    # survivors walk the cached endpoints in permanent-node-id order
    # and re-form the gang on the first reachable standby. Store STATE
    # is not replicated — none is needed, a fresh generation rebuilds
    # it — only rendezvous capability moves. Limitation: an agent
    # STARTED after a failover has no gossip cache and must be pointed
    # at the adopted endpoint explicitly (it is printed on stderr at
    # promotion time); survivors need nothing.
    store_failover: bool = True  # node-elastic only
    advertise_addr: Optional[str] = None  # this agent's dialable host
    failover_grace_s: Optional[float] = None  # default 2x heartbeat timeout
    # Serve-aware drain: before tearing a gang down for
    # a restart/resize, publish the generation-scoped drain key
    # (`serve/drain/gen{g}`) on the store and give serve loops up to
    # this long to drain at a step boundary and checkpoint their queue +
    # in-flight request state (serve/elastic.py) before SIGTERM. 0 (the
    # default) keeps the plain teardown: no signal, no wait.
    serve_drain_grace_s: float = 0.0
    env: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.min_nproc is not None and self.min_nnodes is not None:
            raise ValueError(
                "combine min_nproc with min_nnodes is ambiguous; "
                "pick ONE elastic granularity"
            )
        if self.min_nproc is not None:
            if self.nnodes != 1:
                raise ValueError(
                    "elastic worker range (min_nproc) is single-node only"
                )
            if not 1 <= self.min_nproc <= self.nproc_per_node:
                raise ValueError(
                    f"min_nproc {self.min_nproc} must be in "
                    f"[1, nproc_per_node={self.nproc_per_node}]"
                )
        if self.min_nnodes is not None:
            if not 1 <= self.min_nnodes <= self.nnodes:
                raise ValueError(
                    f"min_nnodes {self.min_nnodes} must be in "
                    f"[1, nnodes={self.nnodes}]"
                )
            if self.master_port == 0:
                raise ValueError(
                    "node-elastic launch needs an explicit master/rdzv "
                    "port (peers and joiners must find the store)"
                )
            if self.nnodes < 2:
                raise ValueError(
                    "node-elastic (min_nnodes) needs nnodes (the MAX) "
                    ">= 2; for a single-node worker range use min_nproc"
                )
            if not 0 <= self.node_rank < self.nnodes:
                raise ValueError(
                    f"node_rank {self.node_rank} out of range for "
                    f"nnodes={self.nnodes} (membership scans cover "
                    f"0..{self.nnodes - 1})"
                )

    @property
    def elastic(self) -> bool:
        return self.min_nproc is not None

    @property
    def node_elastic(self) -> bool:
        return self.min_nnodes is not None

    @property
    def world_size(self) -> int:
        return self.nnodes * self.nproc_per_node


@dataclass
class _Worker:
    local_rank: int
    proc: Optional[subprocess.Popen] = None
    state: WorkerState = WorkerState.INIT


class _AgentAborted(Exception):
    """Internal: raised inside the monitor when `abort()` simulated a
    crashed agent; unwinds run() without any store writes."""


@dataclass
class RunResult:
    state: WorkerState
    restarts: int
    return_codes: Dict[int, int]


_JOIN_KEY = "agent/join_waiting"  # NOT generation-namespaced: must survive re-forms
# Controller-requested gang size (request_resize): a single overwritten
# target the agent consumes (deletes) at the generation boundary that
# satisfies it — latest write wins, stale targets cannot replay.
# Each write is stamped "nproc@seq" with a store-allocated monotonic
# sequence; the agent persists the highest seq it ACTED on, so a
# consumed key replayed after a generation bump (retrying proxy, torn
# controller, duplicated set) is recognized as already-satisfied and
# consumed as a no-op instead of driving a second resize.
_RESIZE_KEY = "agent/resize_target"
_RESIZE_SEQ_KEY = "agent/resize_seq"
_RESIZE_DONE_KEY = "agent/resize_done_seq"
_FATAL_KEY = "agent/fatal"

# Agent -> serve-loop drain contract: the agent sets
# f"{SERVE_DRAIN_PREFIX}/gen{g}" before a restart/resize teardown;
# serve workers poll it between steps (serve/elastic.py imports this
# constant: the agent owns the contract, so the dependency points THIS
# way).
SERVE_DRAIN_PREFIX = "serve/drain"


def _mark_fatal(ctrl) -> None:
    """Poison-pill the whole supervision tree: every agent polls
    `_FATAL_KEY` and gives up. Deliberately neither generation-scoped nor
    ever deleted — fatal is terminal for this store; no later generation
    may form on it."""
    ctrl.set(_FATAL_KEY, b"1")  # distlint: disable=R007 -- terminal poison-pill: outliving every generation is the point

def _join_add(store, amount: int) -> int:
    """All access to the join counter. The key is value-managed, not
    key-managed: admits subtract exactly what they consumed, so a nonzero
    remainder is LIVE state (joiners queued for the next generation) —
    deleting the key would silently drop them."""
    return store.add(_JOIN_KEY, amount)  # distlint: disable=R007 -- value-managed counter; admits decrement what they consume


def request_join(master_addr: str, master_port: int, timeout: float = 30.0) -> int:
    """Ask a running elastic agent to admit one more worker at its next
    generation boundary (torchelastic: a new node entering the dynamic
    rendezvous, elastic/agent/server/api.py:952-970). Returns the number
    of joiners now waiting (including this one).

    The endpoint is the agent's store: `agent.join_endpoint`, also
    announced on stderr at elastic start (ephemeral-port standalone runs
    bind an OS-assigned port, so the spec's port 0 is NOT connectable)."""
    if master_port <= 0:
        raise ValueError(
            "request_join needs the agent's BOUND store port (spec port 0 "
            "is ephemeral) — read agent.join_endpoint or the 'elastic "
            "join endpoint' line the agent prints at start"
        )
    s = TCPStore(master_addr, master_port, is_master=False, timeout=timeout)
    try:
        return _join_add(s, 1)
    finally:
        s.close()


def _stamp_resize(store, nproc: int) -> int:
    """Publish a resize target stamped with a fresh store-allocated
    sequence number. The counter is value-managed (monotonic allocator,
    never reset); the stamped target key itself is consumed by the
    agent at the generation boundary that satisfies it. Returns the
    sequence assigned to this request."""
    seq = store.add(_RESIZE_SEQ_KEY, 1)  # distlint: disable=R007 -- value-managed monotonic allocator; stamped targets carry the scope
    store.set(_RESIZE_KEY, f"{int(nproc)}@{int(seq)}".encode())  # distlint: disable=R007 -- consumed by CAS-tombstone (compare_set to b"" in _consume_resize_key), not delete_key: the unguarded delete was a stamp-destroying TOCTOU
    return int(seq)


def _parse_resize(raw: bytes):
    """Decode a resize target -> (nproc, seq), either side None when
    absent/garbage. Accepts the legacy unstamped form (a bare int,
    seq None) for controllers predating the stamp."""
    try:
        text = raw.decode()
    except (UnicodeDecodeError, AttributeError):
        return None, None
    target, sep, seq = text.partition("@")
    try:
        nproc = int(target)
    except ValueError:
        return None, None
    if not sep:
        return nproc, None
    try:
        return nproc, int(seq)
    except ValueError:
        return None, None  # torn/malformed stamp: treat whole value as garbage


def request_resize(
    master_addr: str, master_port: int, nproc: int, timeout: float = 30.0
) -> None:
    """Ask a running single-node ELASTIC agent (``min_nproc`` set) to
    re-form its worker gang at exactly `nproc` workers at the next
    generation boundary — the serve autoscaler's out-of-process scale
    path. The agent clamps the target to its
    ``[min_nproc, nproc_per_node]`` range, gives serve loops the
    ``serve_drain_grace_s`` window to checkpoint (serve/elastic.py), fires
    the ``agent.resize`` fault point on the world change, and respawns.
    Latest request wins — the key is a single overwritten target."""
    if master_port <= 0:
        raise ValueError(
            "request_resize needs the agent's BOUND store port — read "
            "agent.join_endpoint or the 'elastic join endpoint' stderr "
            "line"
        )
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    s = TCPStore(master_addr, master_port, is_master=False, timeout=timeout)
    try:
        _stamp_resize(s, nproc)
    finally:
        s.close()


class LocalElasticAgent:
    def __init__(self, spec: WorkerSpec, log_dir: Optional[str] = None):
        self.spec = spec
        self.log_dir = log_dir
        self._store: Optional[TCPStore] = None
        self._ctrl: Optional[TCPStore] = None
        self._workers: List[_Worker] = []
        self.restart_count = 0
        # elastic mode: current gang size (<= spec.nproc_per_node) and the
        # failure budget, tracked separately so join admissions don't
        # consume max_restarts
        self.active_nproc = spec.nproc_per_node
        self._failure_restarts = 0
        # (host, bound_port) of the store once hosting starts — the
        # address request_join callers need (standalone specs say port 0)
        self.join_endpoint: Optional[tuple] = None
        # node-elastic membership: permanent node ids currently in the
        # gang (sorted) and this node's position in it (the per-
        # generation GROUP_RANK). Fixed-size gangs never change these.
        self.members: List[int] = list(range(spec.nnodes))
        self.group_rank: int = spec.node_rank
        self._local_failure = False
        self._quorum_deadline: Optional[float] = None
        # store failover state: the CURRENTLY adopted rendezvous
        # endpoint (changes when a standby is promoted), this agent's
        # cold-standby daemon, and the gossiped peer standby endpoints
        # (node id -> (host, port)) harvested from fresh heartbeats
        self._active_master: tuple = (spec.master_addr, spec.master_port)
        self._standby: Optional[TCPStore] = None
        self._peer_endpoints: Dict[int, tuple] = {}
        self._store_host_node = 0  # owner of the ACTIVE store endpoint
        self._advertise = self._compute_advertise()
        self.failovers = 0
        self._prev_world: Optional[int] = None  # agent.resize detector
        # highest resize stamp acted on (lazy-loaded from the store so a
        # restarted agent process still refuses replayed stamps)
        self._resize_done: Optional[int] = None

    # -- store hosting -----------------------------------------------------
    def _ensure_store(self) -> Optional[TCPStore]:
        """Node 0's agent hosts the rendezvous store; other nodes only
        point their workers at it (torchrun: the c10d rdzv backend lives
        on the --rdzv-endpoint host)."""
        if self.spec.nnodes > 1 and self.spec.master_port == 0:
            raise ValueError(
                "multi-node launch needs an explicit master/rdzv port "
                "(port 0 cannot be discovered by other nodes)"
            )
        if self.spec.node_rank != 0:
            return None
        if self._store is None:
            self._store = TCPStore(
                self.spec.master_addr,
                self.spec.master_port,
                world_size=self.spec.world_size,
                is_master=True,
                timeout=300.0,
            )
        return self._store

    def _control(self) -> Optional[TCPStore]:
        """Agent-to-agent control plane (restart propagation) — a client
        handle into the shared store. Multi-node only."""
        if self.spec.nnodes <= 1:
            return None
        if self._ctrl is None:
            if self.spec.node_rank == 0:
                self._ctrl = self._ensure_store()  # daemon handle doubles as client
            else:
                self._ctrl = TCPStore(
                    self.spec.master_addr,
                    self.spec.master_port,
                    world_size=self.spec.world_size,
                    is_master=False,
                    timeout=300.0,
                )
        return self._ctrl

    @staticmethod
    def _peek(store: TCPStore, key: str) -> Optional[bytes]:
        try:
            if store.check([key]):
                return store.get(key)
        except Exception:
            pass
        return None

    # -- spawn -------------------------------------------------------------
    def _start_workers(self) -> None:
        self._gc_drain_keys()
        if self.spec.node_elastic and self._active_master != (
            self.spec.master_addr, self.spec.master_port
        ):
            # a standby was promoted: workers must rendezvous at the
            # ADOPTED endpoint, not the dead original
            master_addr, port = self._active_master
        else:
            store = self._ensure_store()
            master_addr = self.spec.master_addr
            port = store.port if store is not None else self.spec.master_port
        if self.spec.elastic and self.join_endpoint is None:
            # announce the BOUND port: standalone runs use port 0 in the
            # spec, which request_join callers cannot connect to
            self.join_endpoint = (self.spec.master_addr, port)
            print(
                f"tpurun: elastic join endpoint "
                f"{self.spec.master_addr}:{port}",
                file=sys.stderr,
            )
        self._workers = []
        # elastic gangs spawn the CURRENT size (shrunk/grown across
        # generations); fixed-size gangs always spawn the spec size
        nproc = self.active_nproc if self.spec.elastic else self.spec.nproc_per_node
        if self.spec.node_elastic:
            # per-generation membership: world spans the CURRENT members,
            # ranks keyed by this node's membership index
            world = len(self.members) * nproc
            grank = self.group_rank
        else:
            world = nproc if self.spec.elastic else self.spec.world_size
            grank = self.spec.node_rank
        if self._prev_world is not None and world != self._prev_world:
            # "agent.resize" fault point: the gang is about to respawn at
            # a CHANGED world size (elastic shrink/grow, node join/loss).
            # Chaos plans target the resize boundary itself — e.g. crash
            # the agent mid-resize, or delay to widen the recovery window.
            faults.fire(
                "agent.resize",
                rank=self.spec.node_rank,
                old_world=self._prev_world,
                new_world=world,
                gen=self.restart_count,
            )
        self._prev_world = world
        for r in range(nproc):
            global_rank = grank * nproc + r
            env = {
                **os.environ,
                **self.spec.env,
                "RANK": str(global_rank),
                "LOCAL_RANK": str(r),
                "GROUP_RANK": str(grank),
                "TDX_NODE_ID": str(self.spec.node_rank),  # permanent id
                "LOCAL_WORLD_SIZE": str(nproc),
                "WORLD_SIZE": str(world),
                "MASTER_ADDR": master_addr,
                "MASTER_PORT": str(port),
                "TDX_RESTART_COUNT": str(self.restart_count),
                "TORCHELASTIC_RESTART_COUNT": str(self.restart_count),
                # the probe torch's is_torchelastic_launched() reads
                "TORCHELASTIC_RUN_ID": os.environ.get(
                    "TORCHELASTIC_RUN_ID", f"tdx-{os.getpid()}"
                ),
                "TDX_AGENT_STORE": f"{master_addr}:{port}",
                # env:// rendezvous must CONNECT to the agent's store, not
                # bind MASTER_PORT itself (torchelastic's
                # TORCHELASTIC_USE_AGENT_STORE contract)
                "TDX_USE_AGENT_STORE": "1",
                "TORCHELASTIC_USE_AGENT_STORE": "True",
            }
            if self.spec.raw_cmd:
                argv = list(self.spec.entrypoint)
            elif self.spec.module:
                argv = [sys.executable, "-m"] + list(self.spec.entrypoint)
            else:
                argv = [sys.executable] + list(self.spec.entrypoint)
            stdout = stderr = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                stdout = open(
                    os.path.join(
                        self.log_dir, f"worker_{r}_attempt{self.restart_count}.log"
                    ),
                    "w",
                )
                stderr = subprocess.STDOUT
            proc = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)
            self._workers.append(_Worker(r, proc, WorkerState.HEALTHY))

    def _gc_drain_keys(self, back: int = 8) -> None:
        """Reclaim drain signals from retired generations. A drain key
        is consumed the moment its generation's workers exit, but the
        row itself outlived the gang (one leaked key per resize/restart
        for the store-daemon lifetime — flagged by storelint S005).
        Swept when the NEXT generation's workers start: by then nothing
        can still poll the old scope. Bounded back-scan; node 0 and
        peers deleting the same keys is an idempotent race."""
        if self.restart_count <= 0:
            return
        store = self._ctrl if self._ctrl is not None else self._store
        if store is None:
            return
        for g in range(max(0, self.restart_count - back), self.restart_count):
            try:
                store.delete_key(f"{SERVE_DRAIN_PREFIX}/gen{g}")
            except Exception:
                return  # store unreachable: the next start retries

    def _signal_drain(self) -> None:
        """Serve-aware teardown: publish the generation-scoped drain key
        and wait (up to `serve_drain_grace_s`) for serve loops to
        checkpoint and exit on their own. Workers that are not serve
        loops, or that ignore the signal, just get the normal SIGTERM
        when the grace lapses — this only ever DELAYS the teardown, it
        cannot block it."""
        grace = self.spec.serve_drain_grace_s
        if grace <= 0:
            return
        if not any(
            w.proc is not None and w.proc.poll() is None
            for w in self._workers
        ):
            return  # nothing left alive to drain
        store = self._ctrl if self._ctrl is not None else self._store
        if store is None:
            return
        try:
            store.set(
                f"{SERVE_DRAIN_PREFIX}/gen{self.restart_count}", b"1"
            )
        except Exception:
            return  # store gone: nowhere to checkpoint anyway
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if all(
                w.proc is None or w.proc.poll() is not None
                for w in self._workers
            ):
                return  # every worker drained and exited early
            time.sleep(min(self.spec.monitor_interval_s, 0.05))

    def _stop_workers(self) -> None:
        for w in self._workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.monotonic() + 5
        for w in self._workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait(5)

    # -- monitor (api.py:499) ---------------------------------------------
    def _monitor(self) -> WorkerState:
        """Poll local workers AND (multi-node) the agent control plane: a
        peer node's failure must restart THIS node's workers too — they
        are blocked in collectives that can never complete. torchelastic
        achieves the same via its dynamic rendezvous round; here the
        shared store carries a monotonic restart-generation key."""
        ctrl = self._control()
        while True:
            time.sleep(self.spec.monitor_interval_s)
            codes = {w.local_rank: w.proc.poll() for w in self._workers}
            if any(c is not None and c != 0 for c in codes.values()):
                # elastic shrink needs the count of PERMANENTLY lost
                # workers (exited nonzero / killed) at observation time —
                # the rest are healthy and only torn down for re-rendezvous
                self._observed_failed = sum(
                    1 for c in codes.values() if c is not None and c != 0
                )
                if ctrl is not None:
                    try:
                        # the generation POINTER itself: overwritten (never
                        # appended) each re-form, so it cannot accumulate
                        ctrl.set("agent/restart_gen", str(self.restart_count + 1))  # distlint: disable=R007 -- single overwritten pointer key, the incarnation scope others hang off
                    except Exception:
                        pass  # store host may be gone; barrier will decide
                return WorkerState.FAILED
            if all(c == 0 for c in codes.values()):
                return WorkerState.SUCCEEDED
            if (
                self.spec.elastic
                and self.active_nproc < self.spec.nproc_per_node
                and self._join_waiting() > 0
            ):
                return WorkerState.SCALE_UP
            if self.spec.elastic and self._resize_target() is not None:
                return WorkerState.RESIZE
            if ctrl is not None:
                g = self._peek(ctrl, "agent/restart_gen")
                if g is not None and int(g) > self.restart_count:
                    return WorkerState.FAILED  # peer-signaled restart
                if self._peek(ctrl, _FATAL_KEY) is not None:
                    return WorkerState.FAILED

    def _join_waiting(self) -> int:
        """How many joiners are queued on the store (add(0) = atomic read)."""
        store = self._ensure_store()
        if store is None:
            return 0
        try:
            return _join_add(store, 0)
        except Exception:
            return 0

    def _resize_target(self) -> Optional[int]:
        """The controller-requested LOCAL gang size, clamped to
        [min_nproc, nproc_per_node]; None when absent, already
        satisfied, or a STALE replay (stamp at or below the persisted
        acted-on high-water — a consumed key duplicated after a
        generation bump must be a no-op, not a second resize). A
        satisfied, stale, or unparseable target is consumed here so the
        monitor cannot spin on it."""
        store = self._ensure_store()
        if store is None:
            return None
        raw = self._peek(store, _RESIZE_KEY)
        if raw is None or raw == b"":
            return None  # absent, or a consumed-stamp tombstone
        nproc, seq = _parse_resize(raw)
        if seq is not None and seq <= self._resize_done_seq(store):
            self._consume_resize_key(store, raw)  # replayed duplicate
            return None
        target = self._clamp_resize(nproc)
        if target == self.active_nproc:
            self._consume_resize_key(store, raw)
            self._mark_resize_done(store, seq)
            return None
        return target

    def _clamp_resize(self, nproc: Optional[int]) -> int:
        if nproc is None:
            nproc = self.active_nproc  # garbage target: treat as met
        return max(
            self.spec.min_nproc or 1,
            min(nproc, self.spec.nproc_per_node),
        )

    def _resize_done_seq(self, store) -> int:
        """Highest resize stamp this supervision tree has acted on.
        Persisted in the store (not just agent memory) so an agent
        process that itself restarted still refuses replays of stamps
        it satisfied in a previous life. Lazy-loaded once, then cached."""
        if self._resize_done is None:
            raw = self._peek(store, _RESIZE_DONE_KEY)
            try:
                self._resize_done = int(raw) if raw is not None else 0
            except ValueError:
                self._resize_done = 0
        return self._resize_done

    def _mark_resize_done(self, store, seq: Optional[int]) -> None:
        """Advance the acted-on high-water mark (monotonic; unstamped
        legacy targets carry no seq and advance nothing)."""
        if seq is None or seq <= self._resize_done_seq(store):
            return
        self._resize_done = int(seq)
        try:
            store.set(_RESIZE_DONE_KEY, str(int(seq)).encode())  # distlint: disable=R007 -- single overwritten monotonic high-water; scope lives in the stamped values it tracks
        except Exception:
            pass  # in-memory mark still guards this process's lifetime

    def _consume_resize_key(self, store, acted_on: bytes) -> None:
        """Retire the resize target ONLY while it still holds the value
        just acted on — latest-write-wins means a NEWER target published
        meanwhile (the teardown window is seconds wide) must survive
        for the next monitor tick, not be destroyed with the old one.
        Stamped values make the exact-match test robust even when two
        requests name the SAME nproc: their seqs differ.

        Atomic via `compare_set` to an empty tombstone (the old
        peek-then-delete pair had a window where a stamp published
        between the two ops was destroyed — found by the storelint
        resize interleaving scenario). `_resize_target` treats the
        empty value as absent, so the tombstone never reaches the
        parser."""
        try:
            store.compare_set(_RESIZE_KEY, acted_on, b"")  # storelint: disable=S006 -- one-shot by contract: losing this race means a newer stamp landed and must survive
        except Exception:
            pass  # best-effort GC; re-read next tick is harmless

    def _admit_joiners(self, survivors: int) -> int:
        """Consume queued join requests up to the spec max; returns the
        new gang size. Decrements the counter only by what was admitted —
        joiners beyond max stay queued for a later generation."""
        store = self._ensure_store()
        if store is None:
            return survivors
        try:
            waiting = _join_add(store, 0)
            new = min(survivors + waiting, self.spec.nproc_per_node)
            admitted = new - survivors
            if admitted:
                _join_add(store, -admitted)
            return new
        except Exception:
            return survivors

    def _await_peers_done(self) -> str:
        """Multi-node success path: a node whose workers exited 0 must not
        tear down (node 0 would close the shared store) while peers still
        run — their late failure needs this node back for the restart.
        Returns "done" | "restart" | "fatal"."""
        ctrl = self._control()
        if ctrl is None:
            return "done"
        gen = self.restart_count
        try:
            ctrl.set(f"agent/done/gen{gen}/node{self.spec.node_rank}", b"1")  # storelint: disable=S005 -- final-generation teardown handshake; the rank-0 store daemon dies right after
        except Exception:
            return "fatal"
        deadline = time.monotonic() + self.spec.peer_done_timeout_s
        while time.monotonic() < deadline:
            if self._peek(ctrl, _FATAL_KEY) is not None:
                return "fatal"
            g = self._peek(ctrl, "agent/restart_gen")
            if g is not None and int(g) > self.restart_count:
                return "restart"
            if all(
                self._peek(ctrl, f"agent/done/gen{gen}/node{n}") is not None
                for n in range(self.spec.nnodes)
            ):
                # two-phase: the store HOST must outlive every peer's
                # observation of the done keys — node 0 returning first
                # would close the daemon while others still poll it
                try:
                    ctrl.set(  # storelint: disable=S005 -- two-phase teardown ack; nothing outlives the daemon these rows protect
                        f"agent/done_ack/gen{gen}/node{self.spec.node_rank}",
                        b"1",
                    )
                except Exception:
                    pass
                if self.spec.node_rank == 0:
                    try:
                        ctrl.wait(
                            [
                                f"agent/done_ack/gen{gen}/node{n}"
                                for n in range(self.spec.nnodes)
                            ],
                            60.0,
                        )
                    except Exception:
                        pass  # a peer died post-done; nothing left to protect
                return "done"
            time.sleep(self.spec.monitor_interval_s)
        try:
            _mark_fatal(ctrl)
        except Exception:
            pass
        return "fatal"

    def _restart_barrier(self) -> bool:
        """Multi-node: agree on the new generation before respawning, so
        every node's workers re-rendezvous under the same restart scope.
        Returns False if the gang must give up (budget exhausted anywhere)."""
        ctrl = self._control()
        if ctrl is None:
            return True
        if self._peek(ctrl, _FATAL_KEY) is not None:
            return False
        g = self._peek(ctrl, "agent/restart_gen")
        target = max(int(g) if g is not None else 0, self.restart_count + 1)
        if target > self.spec.max_restarts:
            _mark_fatal(ctrl)
            return False
        self.restart_count = target
        ctrl.set(f"agent/gen{target}/ready/{self.spec.node_rank}", b"1")  # storelint: disable=S005 -- restart rendezvous rows; straggler nodes re-read old generations, so only daemon death reclaims them
        try:
            ctrl.wait(
                [
                    f"agent/gen{target}/ready/{n}"
                    for n in range(self.spec.nnodes)
                ],
                120.0,
            )
        except Exception:
            _mark_fatal(ctrl)
            return False
        return self._peek(ctrl, _FATAL_KEY) is None

    # -- node-level elastic (torchelastic --nnodes=MIN:MAX) ----------------
    def abort(self) -> None:
        """Simulate abrupt agent death (SIGKILL of the agent process):
        stop heartbeating and coordinating entirely; `run()` returns
        FAILED without writing to the store. Peers learn of the loss the
        only way they can for a real crash — heartbeat staleness. Used
        by fault-injection tests."""
        self._aborted = True

    def _check_abort(self) -> None:
        # every node-elastic wait loop must observe abort(), not just the
        # monitor — an aborted agent must stop ALL store coordination
        if getattr(self, "_aborted", False):
            raise _AgentAborted()

    @staticmethod
    def _hb_key(node: int) -> str:
        return f"agent/hb/node{node}"

    # heartbeat values are "ts|host:standby_port" — the timestamp is the
    # liveness signal, the endpoint is the standby-store gossip the
    # failover path dials. Plain-float values (older peers) still parse.
    @staticmethod
    def _hb_parse(v: bytes):
        """(ts, endpoint_or_None); raises ValueError on garbage ts."""
        s = v.decode()
        ts_s, _, ep = s.partition("|")
        ts = float(ts_s)
        if ep and ":" in ep:
            host, _, port = ep.rpartition(":")
            return ts, (host, int(port))
        return ts, None

    def _compute_advertise(self) -> Optional[str]:
        """The address peers dial for THIS agent's standby store —
        computed ONCE (a per-heartbeat DNS lookup would block the
        monitor loop that doubles as the node-loss detector). None =
        don't gossip an endpoint at all: on a multi-host gang with
        broken name resolution, advertising a loopback fallback would
        hand peers a self-referential address to dial."""
        if self.spec.advertise_addr:
            return self.spec.advertise_addr
        if self.spec.master_addr in ("127.0.0.1", "localhost", "::1"):
            return "127.0.0.1"  # whole gang on one machine
        import socket

        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return None

    def _ensure_standby(self) -> None:
        if not (self.spec.node_elastic and self.spec.store_failover):
            return
        if self._standby is not None or self._advertise is None:
            return
        try:
            self._standby = TCPStore("0.0.0.0", 0, is_master=True, timeout=300.0)
        except Exception:
            return  # failover simply unavailable here

    def _heartbeat(self, ctrl) -> None:
        if getattr(self, "_aborted", False):
            return
        try:
            # "agent.heartbeat" fault point, node-targeted via rank=:
            # any injected raise (reset/drop) is a MISSED beat — peers
            # then see this node as stale, exactly like a real loss;
            # "delay" makes beats late; "crash" kills the agent outright
            faults.fire("agent.heartbeat", rank=self.spec.node_rank)
        except Exception:
            return
        val = str(time.time())
        if self._standby is not None and self._advertise is not None:
            me = (self._advertise, self._standby.port)
            self._peer_endpoints[self.spec.node_rank] = me
            val += f"|{me[0]}:{me[1]}"
        try:
            ctrl.set(self._hb_key(self.spec.node_rank), val)  # storelint: disable=S005 -- per-node heartbeat row overwritten in place; staleness IS the liveness signal, deletion would erase it
        except Exception:
            pass  # store host gone; staleness/fatal paths will decide

    def _stale_peers(self, ctrl) -> List[int]:
        """Current members whose heartbeat is older than the threshold —
        the node-loss detector (torchelastic learns this from its
        rendezvous keep-alive the same way). Fresh heartbeats also feed
        the standby-endpoint cache the store-failover path dials."""
        now = time.time()
        out = []
        for m in self.members:
            if m == self.spec.node_rank:
                continue
            v = self._peek(ctrl, self._hb_key(m))
            fresh = False
            try:
                if v is not None:
                    ts, ep = self._hb_parse(v)
                    fresh = now - ts <= self.spec.heartbeat_timeout_s
                    if fresh and ep is not None:
                        self._peer_endpoints[m] = ep
            except ValueError:
                fresh = False
            if not fresh:
                out.append(m)
        return out

    def _store_alive(self, endpoint: tuple, timeout: float = 1.5) -> bool:
        try:
            probe = TCPStore(
                endpoint[0], endpoint[1], is_master=False, timeout=timeout
            )
            probe.check(["agent/ping"])
            probe.close()
            return True
        except Exception:
            return False

    def _try_store_failover(self):
        """Promote a surviving standby store after primary loss.

        Every agent walks the SAME candidate order — current members'
        gossiped standby endpoints sorted by permanent node id — and
        adopts the first reachable one, so survivors converge on one
        endpoint without any out-of-band channel. Two split-brain
        guards: (a) the primary must stay unreachable for the whole
        failover grace window (a transiently slow store is not a dead
        one); (b) a node missing gossip for a LOWER-id member (other
        than the dead store's own host) refuses to fail over — it
        cannot rule out that member promoting a standby it has never
        heard of, and a refused failover just fails THIS agent while
        the well-informed survivors re-form. Returns the new ctrl
        handle or None. Store state is NOT carried over: the adopter
        bumps the generation on the new store and the normal membership
        machinery re-forms the gang there."""
        if not (self.spec.node_elastic and self.spec.store_failover):
            return None
        if getattr(self, "_aborted", False):
            return None
        grace = self.spec.failover_grace_s
        if grace is None:
            grace = 2.0 * self.spec.heartbeat_timeout_s
        deadline = time.monotonic() + grace
        while True:
            if self._store_alive(self._active_master):
                return None  # not a store loss; let the normal paths decide
            if getattr(self, "_aborted", False):
                return None
            if time.monotonic() >= deadline:
                break
            time.sleep(min(0.5, self.spec.monitor_interval_s * 2))
        dead = self._active_master
        me = self.spec.node_rank
        for node in sorted(set(self.members) | {me}):
            ep = self._peer_endpoints.get(node)
            if ep is None:
                if node == self._store_host_node:
                    continue  # the dead host; peers skip or probe it alike
                if node < me:
                    return None  # guard (b): incomplete gossip below me
                continue
            if ep == dead:
                continue
            if node == me:
                new = self._standby  # adopt OWN standby (daemon handle
                if new is None:  # doubles as a connected client)
                    continue
            else:
                try:
                    new = TCPStore(ep[0], ep[1], is_master=False, timeout=2.0)
                    new.check(["agent/ping"])
                except Exception:
                    continue
            print(
                f"tpurun[node {me}]: rendezvous store "
                f"{dead[0]}:{dead[1]} lost; failing over to standby "
                f"{ep[0]}:{ep[1]} (node {node})",
                file=sys.stderr,
            )
            old = self._ctrl
            self._ctrl = new
            self._active_master = ep
            self._store_host_node = node
            self.failovers += 1
            if old is not None and old is not self._standby:
                try:
                    old.close()
                except Exception:
                    pass
            if self._store is not None and self._store is not new:
                try:
                    self._store.close()
                except Exception:
                    pass
                self._store = None
            # open the next generation on the NEW store so every
            # survivor (at different restart counts mid-teardown) meets
            # at one membership barrier there
            self._bump_gen(new, self.restart_count + 1)
            self._heartbeat(new)
            return new
        return None

    def _peeked_gen(self, ctrl) -> int:
        g = self._peek(ctrl, "agent/restart_gen")
        return int(g) if g is not None else 0

    def _bump_gen(self, ctrl, target: int) -> None:
        # monotonic: concurrent bumpers must never move the counter
        # BACKWARDS (two live generations would form simultaneously);
        # compare-and-set loop instead of a blind write
        try:
            for _ in range(16):
                cur = self._peek(ctrl, "agent/restart_gen")
                cur_i = int(cur) if cur is not None else 0
                if cur_i >= target:
                    return
                expected = cur if cur is not None else b""
                got = ctrl.compare_set(
                    "agent/restart_gen", expected, str(target).encode()
                )
                if got == str(target).encode():
                    return
        except Exception:
            pass

    def _fresh_hb_nodes(self, ctrl) -> List[int]:
        now = time.time()
        out = []
        for n in range(self.spec.nnodes):
            v = self._peek(ctrl, self._hb_key(n))
            if v is None:
                continue
            try:
                ts, ep = self._hb_parse(v)
                if now - ts <= self.spec.heartbeat_timeout_s:
                    out.append(n)
                    if ep is not None:
                        self._peer_endpoints[n] = ep
            except ValueError:
                pass
        return out

    def _form_membership(self, ctrl, target: int) -> str:
        """Generation barrier with DYNAMIC membership: every present node
        writes a ready key, the settle window closes, and the first node
        to publish wins the members list (store compare-and-set). The
        proposal is ready nodes UNION fresh-heartbeat nodes, so an
        incumbent slow through a long worker teardown cannot be evicted
        by a joiner racing the settle window. Node ranks are reassigned
        by membership order. Returns "ok" (member), "wait" (missed this
        generation — rejoin at the next), "retry" (below min quorum —
        re-form while the quorum grace lasts), or "fatal"."""
        me = self.spec.node_rank
        self._check_abort()
        self._heartbeat(ctrl)
        try:
            ctrl.set(f"agent/gen{target}/ready/{me}", b"1")
        except Exception:
            return "fatal"
        time.sleep(self.spec.node_settle_s)
        self._check_abort()
        self._heartbeat(ctrl)
        ready = {
            n
            for n in range(self.spec.nnodes)
            if self._peek(ctrl, f"agent/gen{target}/ready/{n}") is not None
        }
        proposal_set = sorted(ready | set(self._fresh_hb_nodes(ctrl)))
        proposal = ",".join(str(n) for n in proposal_set).encode()
        try:
            published = ctrl.compare_set(  # storelint: disable=S005,S006 -- one-shot election per generation: losers ADOPT the published proposal (no rescan by design), and the row must stay readable for the whole gen
                f"agent/gen{target}/members", b"", proposal
            )
        except Exception:
            return "fatal"
        members = [int(x) for x in published.decode().split(",") if x]
        if me not in members:
            return "wait"
        if len(members) < (self.spec.min_nnodes or 1):
            # below min: not instantly fatal — peers may be mid-teardown.
            # Keep re-forming for the quorum grace window (torchelastic
            # waits a join timeout for min nodes the same way).
            if self._quorum_deadline is None:
                self._quorum_deadline = (
                    time.monotonic() + self.spec.quorum_grace_s
                )
            if time.monotonic() < self._quorum_deadline:
                self.restart_count = target
                return "retry"
            try:
                _mark_fatal(ctrl)
            except Exception:
                pass
            return "fatal"
        self._quorum_deadline = None
        self.members = members
        self.group_rank = members.index(me)
        self.restart_count = target
        for n in members:  # these join requests are now honored
            try:
                ctrl.delete_key(f"agent/join_node/{n}")
            except Exception:
                pass
        return "ok"

    def _monitor_node_elastic(self, ctrl) -> WorkerState:
        """Monitor loop for node-elastic gangs: local worker exits, peer
        generation bumps, stale peer heartbeats (node loss), and — on the
        leader (lowest member) — queued node joins."""
        leader = self.members[0] == self.spec.node_rank
        while True:
            time.sleep(self.spec.monitor_interval_s)
            if getattr(self, "_aborted", False):
                raise _AgentAborted()
            self._heartbeat(ctrl)
            codes = {w.local_rank: w.proc.poll() for w in self._workers}
            if any(c is not None and c != 0 for c in codes.values()):
                self._observed_failed = sum(
                    1 for c in codes.values() if c is not None and c != 0
                )
                self._local_failure = True
                self._bump_gen(ctrl, self.restart_count + 1)
                return WorkerState.FAILED
            if all(c == 0 for c in codes.values()):
                return WorkerState.SUCCEEDED
            if self._peek(ctrl, _FATAL_KEY) is not None:
                return WorkerState.FAILED
            if self._peeked_gen(ctrl) > self.restart_count:
                return WorkerState.FAILED  # peer-signaled membership change
            if self._stale_peers(ctrl):
                self._bump_gen(ctrl, self.restart_count + 1)
                return WorkerState.FAILED
            if leader:
                for n in range(self.spec.nnodes):
                    if n in self.members:
                        continue
                    v = self._peek(ctrl, f"agent/join_node/{n}")
                    if v is None:
                        continue
                    # join keys carry the joiner's timestamp and are
                    # refreshed while it waits: a stale key is a joiner
                    # that crashed before admission — drop it instead of
                    # re-forming the gang forever
                    try:
                        fresh = (
                            time.time() - float(v)
                            <= self.spec.heartbeat_timeout_s
                        )
                    except ValueError:
                        fresh = False
                    if not fresh:
                        try:
                            ctrl.delete_key(f"agent/join_node/{n}")
                        except Exception:
                            pass
                        continue
                    self._bump_gen(ctrl, self.restart_count + 1)
                    return WorkerState.FAILED

    def _await_members_done(self, ctrl) -> str:
        """Success path over the CURRENT membership (the fixed-size
        `_await_peers_done` ranges over all spec nodes)."""
        gen = self.restart_count
        me = self.spec.node_rank
        try:
            ctrl.set(f"agent/done/gen{gen}/node{me}", b"1")
        except Exception:
            return "fatal"
        deadline = time.monotonic() + self.spec.peer_done_timeout_s
        while time.monotonic() < deadline:
            self._check_abort()
            self._heartbeat(ctrl)
            if self._peek(ctrl, _FATAL_KEY) is not None:
                return "fatal"
            if self._peeked_gen(ctrl) > self.restart_count:
                return "restart"
            # a member dying between its workers' success and its done
            # key would otherwise block everyone for the full
            # peer_done_timeout: treat it as the node loss it is
            stale = self._stale_peers(ctrl)
            if stale:
                not_done = [
                    n
                    for n in stale
                    if self._peek(ctrl, f"agent/done/gen{gen}/node{n}")
                    is None
                ]
                if not_done:
                    self._bump_gen(ctrl, self.restart_count + 1)
                    return "restart"
            if all(
                self._peek(ctrl, f"agent/done/gen{gen}/node{n}") is not None
                for n in self.members
            ):
                # two-phase: the CURRENT store host (node 0 originally,
                # the adopted-standby owner after a failover) must
                # outlive every peer's observation of the done keys —
                # returning first would close the daemon under the
                # others' final polls
                try:
                    ctrl.set(f"agent/done_ack/gen{gen}/node{me}", b"1")
                except Exception:
                    pass
                if self.spec.node_rank == self._store_host_node:
                    try:
                        ctrl.wait(
                            [
                                f"agent/done_ack/gen{gen}/node{n}"
                                for n in self.members
                            ],
                            60.0,
                        )
                    except Exception:
                        pass  # a peer died post-done; nothing to protect
                return "done"
            time.sleep(self.spec.monitor_interval_s)
        try:
            _mark_fatal(ctrl)
        except Exception:
            pass
        return "fatal"

    def _codes(self) -> Dict[int, int]:
        return {
            w.local_rank: (w.proc.returncode if w.proc else None)
            for w in self._workers
        }

    def _run_node_elastic(self) -> RunResult:
        try:
            return self._run_node_elastic_inner()
        except _AgentAborted:
            # crashed-agent simulation: die without store coordination
            self._stop_workers()
            return RunResult(
                WorkerState.FAILED, self.restart_count, self._codes()
            )

    def _run_node_elastic_inner(self) -> RunResult:
        ctrl = self._control()
        if ctrl is None:  # unreachable given spec validation (nnodes >= 2)
            raise RuntimeError("node-elastic requires the shared store")
        self._ensure_standby()
        target = self._peeked_gen(ctrl)
        join_deadline = None
        while True:
            verdict = self._form_membership(ctrl, target)
            if verdict == "fatal":
                # distinguish "the JOB is fatal" from "the STORE died":
                # the latter fails over to a surviving standby and
                # re-forms there (beyond-torch: rank-0 rendezvous host
                # loss is survivable)
                new = self._try_store_failover()
                if new is not None:
                    ctrl = new
                    target = max(self._peeked_gen(ctrl), self.restart_count + 1)
                    continue
                return RunResult(
                    WorkerState.FAILED, self.restart_count, self._codes()
                )
            if verdict == "retry":
                # below min quorum within the grace window: open the next
                # generation and re-form (peers mid-teardown will make it)
                target = max(self._peeked_gen(ctrl), target + 1)
                self._bump_gen(ctrl, target)
                continue
            if verdict == "wait":
                # missed this generation: announce as joiner (timestamped,
                # refreshed — the leader drops stale keys from crashed
                # joiners) and wait for the next generation to open
                if join_deadline is None:
                    join_deadline = time.monotonic() + 300.0
                while True:
                    self._check_abort()
                    try:
                        ctrl.set(
                            f"agent/join_node/{self.spec.node_rank}",
                            str(time.time()),
                        )
                    except Exception:
                        new = self._try_store_failover()
                        if new is not None:
                            ctrl = new
                            target = max(
                                self._peeked_gen(ctrl), self.restart_count + 1
                            )
                            break
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            self._codes(),
                        )
                    g = self._peeked_gen(ctrl)
                    if g > target:
                        target = g
                        break
                    if (
                        self._peek(ctrl, _FATAL_KEY) is not None
                        or time.monotonic() > join_deadline
                    ):
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            self._codes(),
                        )
                    time.sleep(self.spec.monitor_interval_s)
                continue
            join_deadline = None
            self._start_workers()
            state = self._monitor_node_elastic(ctrl)
            if state is WorkerState.SUCCEEDED:
                done = self._await_members_done(ctrl)
                if done == "done":
                    return RunResult(
                        WorkerState.SUCCEEDED,
                        self.restart_count,
                        self._codes(),
                    )
                if done == "fatal":
                    new = self._try_store_failover()
                    if new is None:
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            self._codes(),
                        )
                    ctrl = new  # store died at success time: re-form on
                    # the standby and let the re-run finish from ckpt
                # "restart": rejoin the gang for the next generation
            # bracket the (potentially slow) teardown with heartbeats so
            # a SIGTERM-ignoring worker's kill wait cannot make THIS node
            # look dead to its peers. Serve drains ride inside the
            # bracket — keep serve_drain_grace_s below heartbeat_timeout_s
            # on node-elastic gangs or the drain wait reads as node loss.
            self._heartbeat(ctrl)
            self._signal_drain()
            self._stop_workers()
            self._heartbeat(ctrl)
            if self._peek(ctrl, _FATAL_KEY) is not None:
                return RunResult(
                    WorkerState.FAILED, self.restart_count, self._codes()
                )
            if self._local_failure:
                # only REAL local failures consume the budget; membership
                # changes (node loss/join re-forms) are free, as in
                # torchelastic
                self._local_failure = False
                self._failure_restarts += 1
                if self._failure_restarts > self.spec.max_restarts:
                    try:
                        _mark_fatal(ctrl)
                    except Exception:
                        pass
                    return RunResult(
                        WorkerState.FAILED, self.restart_count, self._codes()
                    )
            target = max(self._peeked_gen(ctrl), self.restart_count + 1)

    # -- run with restarts (api.py:952-970) -------------------------------
    def run(self) -> RunResult:
        try:
            if self.spec.node_elastic:
                return self._run_node_elastic()
            self._start_workers()
            while True:
                state = self._monitor()
                if state is WorkerState.SUCCEEDED:
                    verdict = self._await_peers_done()
                    if verdict == "done":
                        return RunResult(
                            state,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    if verdict == "fatal":
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    # "restart": a peer failed after our success — rejoin
                    # the gang for the next generation
                if state is WorkerState.SCALE_UP:
                    # generation boundary for a join: healthy workers are
                    # re-rendezvoused at the grown size (torchelastic
                    # restarts the worker group when a node joins)
                    self._signal_drain()
                    self._stop_workers()
                    self.active_nproc = self._admit_joiners(self.active_nproc)
                    self.restart_count += 1
                    self._start_workers()
                    continue
                if state is WorkerState.RESIZE:
                    # controller-requested resize (request_resize — the
                    # serve autoscaler's path): re-form the local gang
                    # at the clamped target. Serve loops get the drain
                    # grace to checkpoint; _start_workers fires
                    # agent.resize on the world change. ONE raw read
                    # drives both the act and the consume — a NEWER
                    # target published during the seconds-wide teardown
                    # must survive for the next monitor tick.
                    store = self._ensure_store()
                    raw = (
                        self._peek(store, _RESIZE_KEY)
                        if store is not None
                        else None
                    )
                    if raw is not None:
                        nproc, seq = _parse_resize(raw)
                        stale = (
                            seq is not None
                            and seq <= self._resize_done_seq(store)
                        )
                        target = self._clamp_resize(nproc)
                        if not stale and target != self.active_nproc:
                            self._signal_drain()
                            self._stop_workers()
                            self.active_nproc = target
                            self._consume_resize_key(store, raw)
                            self._mark_resize_done(store, seq)
                            self.restart_count += 1
                            self._start_workers()
                        else:
                            # stale replay, garbage, or already met:
                            # consume without re-forming the gang
                            self._consume_resize_key(store, raw)
                            if not stale:
                                self._mark_resize_done(store, seq)
                    continue
                # failure: tear down the whole gang and re-rendezvous —
                # surviving serve loops get the drain grace to checkpoint
                # their queue state before SIGTERM
                n_failed = getattr(self, "_observed_failed", 1)
                self._signal_drain()
                self._stop_workers()
                if self.spec.elastic:
                    if self._failure_restarts >= self.spec.max_restarts:
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    # --nnodes=MIN:MAX semantics: re-form at the surviving
                    # size (plus any queued joiners); below MIN the gang
                    # cannot meet quorum and the job fails
                    survivors = max(self.active_nproc - n_failed, 0)
                    new_size = self._admit_joiners(survivors)
                    if new_size < (self.spec.min_nproc or 1):
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    self._failure_restarts += 1
                    self.restart_count += 1
                    self.active_nproc = new_size
                    # the store stays up across generations: its endpoint
                    # must remain stable for request_join callers; workers
                    # namespace their keys by TDX_RESTART_COUNT
                    self._start_workers()
                    continue
                if self.spec.nnodes > 1:
                    if not self._restart_barrier():
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    # store stays up (peers reconnect); workers namespace
                    # their keys by TDX_RESTART_COUNT so generations can't
                    # collide
                else:
                    if self.restart_count >= self.spec.max_restarts:
                        return RunResult(
                            WorkerState.FAILED,
                            self.restart_count,
                            {w.local_rank: w.proc.returncode for w in self._workers},
                        )
                    self.restart_count += 1
                    # fresh store per generation: stale barrier/worker-count
                    # keys from the failed generation must not leak into the
                    # new one
                    if self._store is not None:
                        self._store.close()
                        self._store = None
                self._start_workers()
        finally:
            self._stop_workers()
            if self._ctrl is not None and self._ctrl is not self._store:
                if self._ctrl is not self._standby:
                    try:
                        self._ctrl.close()
                    except Exception:
                        pass
                self._ctrl = None
            if self._store is not None:
                self._store.close()
                self._store = None
            if self._standby is not None:
                try:
                    self._standby.close()
                except Exception:
                    pass
                self._standby = None
