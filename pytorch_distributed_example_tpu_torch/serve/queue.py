"""Request queue — admission buffer between callers and the engine.

A copy of the reference's `serve/queue.py`, re-pointed at the port's
`types.DistError`.

Thread-safe queue of `Request`s, now CLASS-AWARE: requests carry a
tenant id and a priority class, and the queue schedules across classes
by smooth weighted round-robin (SWRR — the nginx balancer's scheme:
deterministic, starvation-free, proportional to the class weights)
while staying FIFO within a class. A queue constructed without classes
is the single-class FIFO, bit-for-bit.

Two ingress paths with DIFFERENT bounding rules (the requeue-vs-shed
determinism fix):

* `put()` — new work. Bounded when `max_depth` is set; under overload
  the victim is chosen by CLASS, not arrival: the lowest-priority
  request present is shed (the newest arrival of the worst class —
  possibly the incoming request itself, which raises `QueueFullError`;
  a queued victim is returned to the caller for metrics). High-class
  traffic therefore displaces low-class backlog instead of the whole
  queue collapsing FIFO-style.
* `requeue_front(req)` — fault/preemption recovery for work the engine
  already accepted. Lands in a separate UNBOUNDED per-class head deque
  that `put()`'s depth check never reads, so whether a racing `put()`
  sheds is independent of how many preemption-storm requeues landed
  first — requeue-vs-shed ordering is deterministic under a full queue
  (the head deque holds at most the engine's slot count: only admitted
  work is ever requeued).

Pop order: the SWRR-selected class's requeued work first (it was
admitted earlier — arrival order within the class is preserved), then
its submitted tail.
"""

from __future__ import annotations

import itertools
import os
import threading
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import DistError

__all__ = [
    "Request",
    "Completion",
    "RequestQueue",
    "QueueFullError",
    "ClassSpec",
    "DEFAULT_CLASS",
]

DEFAULT_CLASS = ""


class QueueFullError(DistError):
    """Bounded admission shed: the queue is at `max_depth` and this
    request was REJECTED (never enqueued). Callers retry later or give
    up; the engine's metrics count every shed."""

_ids = itertools.count()
# Auto-rid namespace: unique per process INCARNATION, not just per
# process — a restored engine runs in a fresh process whose bare counter
# would restart at 0 and mint rids colliding with checkpointed requests
# from the previous life (two live requests sharing a rid means one
# caller silently receives the other's tokens).
_rid_ns = f"{os.getpid():x}-{uuid.uuid4().hex[:6]}"


@dataclass(frozen=True)
class ClassSpec:
    """One priority class. `priority` orders classes (0 = most
    important — sheds last, preempts first); `weight` is the SWRR
    admission share; `ttft_slo_s` is the class's TTFT objective,
    reported as SLO attainment in the metrics (advisory — admission
    is driven by priority/weight, not by the target); `tpot_slo_s` is
    the per-decoded-token objective the DECODE pool of a disaggregated
    deployment steers on (`serve/disagg`) — TTFT attainment drives the
    prefill pool, TPOT attainment the decode pool, so the two SLOs get
    independent fields. `share_prefix`
    opts the class's requests into the CROSS-TENANT prefix-cache scope
    (default off: a tenant's cached prompt prefixes serve only its own
    later requests; on, requests share one global scope with every
    other opted-in class — see `ServeEngine._prefix_scope`. Either
    way, only PROMPT blocks are ever indexed, so decoded tokens cannot
    leak across tenants)."""

    priority: int
    weight: int = 1
    ttft_slo_s: Optional[float] = None
    share_prefix: bool = False
    tpot_slo_s: Optional[float] = None

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(f"class weight must be >= 1, got {self.weight}")


@dataclass
class Request:
    """One generation request. `seed` pins the sampling stream so a
    requeued (fault-interrupted or preempted) request replays
    deterministically; `tenant`/`klass` are the multi-tenant admission
    metadata that also rides the elastic serve checkpoint."""

    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    rid: str = ""
    seed: int = 0
    tenant: str = ""
    klass: str = DEFAULT_CLASS
    arrival_time: float = 0.0  # stamped by the engine's clock at submit
    first_token_time: Optional[float] = None
    requeues: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if not self.rid:
            self.rid = f"req-{_rid_ns}-{next(_ids)}"
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )

    def to_state(self) -> Dict:
        """JSON-able form for the elastic serve checkpoint: everything a
        re-formed gang needs to replay this request token-identically
        (prompt + seed) and account for it (tenant/class/arrival)."""
        return {
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": int(self.max_new_tokens),
            "rid": self.rid,
            "seed": int(self.seed),
            "tenant": self.tenant,
            "klass": self.klass,
            "arrival_time": float(self.arrival_time),
            "requeues": int(self.requeues),
        }

    @classmethod
    def from_state(cls, d: Dict) -> "Request":
        req = cls(
            prompt=np.asarray(d["prompt"], np.int32),
            max_new_tokens=int(d["max_new_tokens"]),
            rid=d["rid"],
            seed=int(d.get("seed", 0)),
            tenant=d.get("tenant", ""),
            klass=d.get("klass", DEFAULT_CLASS),
        )
        req.arrival_time = float(d.get("arrival_time", 0.0))
        req.requeues = int(d.get("requeues", 0))
        return req


@dataclass
class Completion:
    rid: str
    tokens: List[int]
    prompt_len: int
    finish_reason: str  # "eos" | "length"
    ttft_s: float
    tpot_s: float  # mean seconds/token after the first
    e2e_s: float
    requeues: int = 0
    tenant: str = ""
    klass: str = DEFAULT_CLASS


class RequestQueue:
    def __init__(
        self,
        max_depth: Optional[int] = None,
        classes: Optional[Dict[str, ClassSpec]] = None,
    ):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.classes: Dict[str, ClassSpec] = dict(
            classes or {DEFAULT_CLASS: ClassSpec(priority=0)}
        )
        # per-class FIFO tails (bounded ingress) + requeue heads
        # (unbounded recovery path), plus the SWRR credit per class
        self._tail: Dict[str, deque] = {k: deque() for k in self.classes}
        self._head: Dict[str, deque] = {k: deque() for k in self.classes}
        self._credit: Dict[str, int] = {k: 0 for k in self.classes}
        self._lock = threading.Lock()

    def _check_class(self, req: Request) -> None:
        if req.klass not in self.classes:
            raise ValueError(
                f"request {req.rid} names unknown class {req.klass!r} "
                f"(have {sorted(self.classes)})"
            )

    # -- ingress -----------------------------------------------------------
    def put(self, req: Request) -> Optional[Request]:
        """Enqueue new work. Bounded: when the SUBMITTED backlog (the
        requeue heads never count — see module docstring) is at
        `max_depth`, shed by class — evict the newest request of the
        lowest-priority class present if it ranks strictly below `req`
        (returned for metrics), else reject `req` itself
        (`QueueFullError`). Returns the displaced victim or None."""
        self._check_class(req)
        with self._lock:
            if (
                self.max_depth is None
                or sum(len(q) for q in self._tail.values()) < self.max_depth
            ):
                self._tail[req.klass].append(req)
                return None
            victim_klass = self._shed_candidate()
            if (
                victim_klass is None
                or self.classes[victim_klass].priority
                <= self.classes[req.klass].priority
            ):
                # incoming request is the worst (or ties the worst)
                # class present: it is the victim — FIFO-compatible for
                # the single-class queue, and ties never churn the
                # backlog (displacing an equal-priority request would
                # just trade one shed for another)
                raise QueueFullError(
                    f"queue full (max_depth={self.max_depth}); "
                    f"request {req.rid} shed"
                )
            victim = self._tail[victim_klass].pop()  # newest of worst class
            self._tail[req.klass].append(req)
            return victim

    def _shed_candidate(self) -> Optional[str]:
        """Lowest-priority class with submitted work (requeued work is
        engine-accepted and never shed by the queue)."""
        worst = None
        for k, q in self._tail.items():
            if q and (
                worst is None
                or self.classes[k].priority > self.classes[worst].priority
            ):
                worst = k
        return worst

    def requeue_front(self, req: Request) -> None:
        """Return engine-accepted work to its class head (fault recovery
        and preemption path). Unbounded and invisible to `put()`'s depth
        check: recovery must never shed, and its timing must never
        change what `put()` sheds."""
        self._check_class(req)
        with self._lock:
            self._head[req.klass].appendleft(req)

    # -- scheduling --------------------------------------------------------
    def _nonempty(self) -> List[str]:
        return [
            k
            for k in self.classes
            if self._head[k] or self._tail[k]
        ]

    def _select(self, commit: bool) -> Optional[str]:
        """SWRR over non-empty classes: every candidate earns its
        weight, the highest credit wins and pays back the total. Ties
        break by priority then name (deterministic). `commit=False`
        previews without advancing credits (peek)."""
        live = self._nonempty()
        if not live:
            return None
        credit = self._credit if commit else dict(self._credit)
        total = sum(self.classes[k].weight for k in live)
        for k in live:
            credit[k] += self.classes[k].weight
        pick = min(
            live,
            key=lambda k: (
                -credit[k],
                self.classes[k].priority,
                k,
            ),
        )
        if commit:
            credit[pick] -= total
        return pick

    def pop(self) -> Optional[Request]:
        with self._lock:
            k = self._select(commit=True)
            if k is None:
                return None
            return (
                self._head[k].popleft()
                if self._head[k]
                else self._tail[k].popleft()
            )

    def peek(self) -> Optional[Request]:
        """The request the next `pop()` would return (None when empty),
        without advancing the round-robin state."""
        with self._lock:
            k = self._select(commit=False)
            if k is None:
                return None
            return self._head[k][0] if self._head[k] else self._tail[k][0]

    def class_heads(self) -> Dict[str, Request]:
        """Head-of-line request per non-empty class — the engine's
        admission loop walks these when the SWRR choice cannot acquire
        resources but a higher class could preempt its way in."""
        with self._lock:
            return {
                k: (self._head[k][0] if self._head[k] else self._tail[k][0])
                for k in self._nonempty()
            }

    def pop_specific(self, req: Request) -> bool:
        """Remove exactly `req` (the engine admits the candidate it
        acquired resources FOR — a plain pop() could re-select a request
        this admission just preempted, and churn forever). Charges the
        SWRR credits as if `req`'s class had been selected, so weighted
        fairness accounting survives the targeted removal. False when
        the request is no longer queued."""
        with self._lock:
            for dq in (self._head[req.klass], self._tail[req.klass]):
                try:
                    dq.remove(req)
                except ValueError:
                    continue
                live = self._nonempty()
                total = sum(self.classes[k].weight for k in live) + (
                    0
                    if req.klass in live
                    else self.classes[req.klass].weight
                )
                for k in set(live) | {req.klass}:
                    self._credit[k] += self.classes[k].weight
                self._credit[req.klass] -= total
                return True
            return False

    # -- introspection / drain ---------------------------------------------
    def snapshot_split(self) -> Tuple[List[Request], List[Request]]:
        """(requeued, submitted): the head-lane work (engine-accepted,
        restored exempt from bounds) and the submitted-tail backlog
        (restored into the BOUNDED, class-sheddable tails — never-
        admitted work must stay displaceable after a restore, or a
        restored bronze backlog would be immune to gold's overload
        shed). Class-grouped, queue untouched — the elastic drain path
        serializes this."""
        with self._lock:
            heads: List[Request] = []
            tails: List[Request] = []
            for k in sorted(
                self.classes, key=lambda k: (self.classes[k].priority, k)
            ):
                heads.extend(self._head[k])
                tails.extend(self._tail[k])
            return heads, tails

    def snapshot_requests(self) -> List[Request]:
        """Every queued request (requeue heads then submitted tails)."""
        heads, tails = self.snapshot_split()
        return heads + tails

    def restore_tail(self, req: Request) -> None:
        """Re-enter a checkpointed submitted-tail request after an
        elastic restore: appended to its class tail IN ORDER, bypassing
        the depth bound once (it was accepted before the restart; the
        bound gates NEW work) — but fully visible to future depth
        checks and class-ordered shedding, unlike `requeue_front`."""
        self._check_class(req)
        with self._lock:
            self._tail[req.klass].append(req)

    def depth_of(self, klass: str) -> int:
        with self._lock:
            return len(self._head[klass]) + len(self._tail[klass])

    def class_depths(self) -> Dict[str, Tuple[int, int]]:
        """{class: (requeued, submitted)} — the overload controller's
        and /serve's view of the backlog."""
        with self._lock:
            return {
                k: (len(self._head[k]), len(self._tail[k]))
                for k in self.classes
            }

    @property
    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._head.values()) + sum(
                len(q) for q in self._tail.values()
            )

    def __bool__(self) -> bool:
        return self.depth > 0

    def __len__(self) -> int:
        return self.depth
