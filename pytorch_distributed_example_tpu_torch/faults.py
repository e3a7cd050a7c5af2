"""Deterministic fault injection — scriptable failures for chaos testing.

Production collective stacks treat injectable faults as first-class
(PCCL's process-group-aware fault handling; torch's own
`torch/distributed/elastic` tests script failures the same way): every
recovery path in this package (elastic re-form, store failover, retrying
clients, checkpoint fallback) needs a way to be *provoked on purpose*,
deterministically, from a multiprocess test. This module is that seam.

A **fault plan** is a list of rules, declared either via the
`TDX_FAULT_PLAN` environment variable (JSON — inherited by spawned
workers, so elastic gangs can script failures without code changes) or
via `install_plan()`. Each rule:

    {"point": "store.get",      # injection point name (glob * suffix ok)
     "action": "reset",         # what to do when it fires
     "rank": 1,                 # only this RANK (omit/null = every rank)
     "after": 3,                # fire on the 3rd matching call (1-based)
     "times": 1,                # how many consecutive firings (-1 = forever)
     "delay_s": 0.05,           # for action=delay: sleep length
     "prob": 0.5, "seed": 7,    # probabilistic firing (seeded => deterministic)
     "restart_lt": 1}           # only while TDX_RESTART_COUNT < 1 — "fail the
                                # first elastic generation, then recover"

"rank 1, 3rd store GET, reset connection" is exactly
`{"point": "store.get", "rank": 1, "after": 3, "action": "reset"}`.

Named injection points wired in this package:

    store.get / store.set / store.add / store.check / store.compare_set /
    store.delete / store.num_keys / store.ping /
    store.wait / store.connect                     (store client ops)
    rendezvous.join                                (rendezvous handlers)
    p2p.connect / p2p.send                         (direct data plane)
    collective.dispatch                            (eager collective path)
    comm.quantize                                  (before each quantized
                                                    bucket reduction — the
                                                    wire-quantized reduce-
                                                    scatter dispatch in the
                                                    Reducer's blockwise-quant
                                                    adapter; fired before any
                                                    error-feedback commit, so
                                                    a transient fault + retry
                                                    replays exactly)
    schedule.mismatch                              (TDX_SCHEDULE_CHECK
                                                    fingerprint; action
                                                    "corrupt" perturbs the
                                                    firing rank's schedule
                                                    fingerprint so the next
                                                    checkpoint reports a
                                                    divergence — schedule.py)
    plan.probe                                     (collective planner: before
                                                    each probe measurement of
                                                    a candidate algorithm —
                                                    plan/probe.py)
    plan.step                                      (collective planner: before
                                                    each synthesized schedule
                                                    round executes on the p2p
                                                    plane; action "corrupt"
                                                    perturbs the firing rank's
                                                    per-step fingerprint so
                                                    the verifier names the
                                                    first divergent planner
                                                    step — plan/executor.py)
    proglint.agree                                 (TDX_PROGLINT compiled-
                                                    program agreement: before
                                                    a rank publishes one
                                                    program fingerprint
                                                    through the group store;
                                                    action "corrupt" perturbs
                                                    the published digest so
                                                    EVERY rank raises
                                                    ProgramScheduleMismatch-
                                                    Error at compile time
                                                    instead of hanging in the
                                                    first dispatch —
                                                    schedule.agree_program)
    agent.heartbeat                                (node-elastic heartbeats)
    checkpoint.write / checkpoint.finalize         (integrity layer)
    serve.admit / serve.step                       (serve engine: before each
                                                    request admission / each
                                                    continuous-batching decode
                                                    step — transient faults
                                                    requeue in-flight work)
    serve.prefill_chunk                            (before each paged prefill
                                                    chunk — a transient fault
                                                    requeues the half-prefilled
                                                    request, frees its blocks,
                                                    and it replays from seed)
    serve.prefix_attach                            (before a prefix-cache
                                                    lookup/attach at admission
                                                    — fired with zero blocks
                                                    attached, so a transient
                                                    fault requeues cleanly and
                                                    the replay re-attaches the
                                                    same shared blocks)
    serve.drain                                    (before an elastic drain
                                                    snapshot is cut — fired
                                                    with the engine untouched,
                                                    so a transient fault
                                                    aborts the drain cleanly)
    serve.restore                                  (before a serve-state
                                                    checkpoint is read back on
                                                    the re-formed gang)
    serve.scale_out / serve.scale_in               (DP serve router, before a
                                                    replica is added / before a
                                                    scale-in victim is drained
                                                    — both fire with the gang
                                                    untouched, so a transient
                                                    fault aborts the resize at
                                                    a consistent size and
                                                    every in-flight request
                                                    replays token-exact)
    router.route                                   (before a request is routed
                                                    to its affinity replica —
                                                    fired with nothing routed,
                                                    so a retried submit routes
                                                    identically)
    agent.resize                                   (elastic agent, before
                                                    respawning a gang at a
                                                    CHANGED world size —
                                                    shrink, grow, or node-
                                                    membership change)
    serve.worker.start                             (serve worker daemon:
                                                    process start, before any
                                                    store key is touched — a
                                                    transient fault retries in
                                                    place; a crash respawns
                                                    the gang at the same size
                                                    and the store-backed work
                                                    queue replays)
    serve.worker.register                          (before the worker writes
                                                    its generation-scoped
                                                    registration key — fired
                                                    with nothing registered,
                                                    so a retried registration
                                                    is idempotent)
    serve.restore_geometry                         (before the re-formed
                                                    gang's restore leader
                                                    walks the per-rank
                                                    snapshot planes and
                                                    republishes them at the
                                                    NEW geometry — fired with
                                                    nothing republished, so a
                                                    transient fault retries
                                                    and a crash defers to the
                                                    next generation's leader)
    serve.worker.gc                                (before the restore leader
                                                    sweeps retired-generation
                                                    registration rows and
                                                    restore markers — fired
                                                    with nothing deleted, so
                                                    a retried or abandoned
                                                    sweep is idempotent; the
                                                    next leader re-walks it)
    serve.migrate.send                             (disagg KV migration,
                                                    before a finished
                                                    prefill's paged blocks
                                                    are published under
                                                    serve/migrate/{rid} —
                                                    fired with the prefill
                                                    slot still frozen and
                                                    nothing published, so a
                                                    transient fault retries
                                                    the IDENTICAL payload
                                                    and a crash replays the
                                                    request from seed)
    serve.migrate.recv                             (before a decode-pool
                                                    engine lands a migrated
                                                    request's blocks — fired
                                                    with nothing landed and
                                                    the store payload
                                                    intact, so a retried
                                                    receive re-lands the
                                                    same bytes idempotently)
    serve.pool.assign                              (before a worker writes
                                                    its generation-scoped
                                                    prefill/decode role
                                                    claim — fired with
                                                    nothing claimed; the
                                                    claim itself is a CAS,
                                                    so a retry adopts
                                                    whatever role won)
    train.step                                     (for worker scripts; fired
                                                    by user training loops)

Actions:

    delay    sleep `delay_s` (default 0.05) then proceed — slow peer /
             straggler simulation
    hang     sleep `delay_s` (default 3600) — wedge; the watchdog's business
    reset    raise ConnectionResetError — transient connection loss, the
             retry layer's business
    drop     raise FaultTimeout (a TimeoutError) — request silently dropped
    stale    signal the call site to serve a stale read (store GET)
    corrupt  signal the call site to corrupt the payload (NaN injection,
             checkpoint bit-flips, schedule-fingerprint perturbation)
    error    raise DistError(rule["message"])
    crash    os._exit(rule.get("exit_code", 13)) — rank crash mid-step

`delay`/`hang`/`reset`/`drop`/`error`/`crash` are *generic*: `fire()`
executes them directly. `stale`/`corrupt` are *advisory*: `fire()`
returns the matched rule and the call site implements the corruption
(only it knows the payload). Trigger counts are per-process and
per-(rule, point), so plans behave identically across reruns; the only
nondeterminism permitted is the explicitly seeded `prob` rule form.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import traceguard
from .types import DistError

__all__ = [
    "FaultRule",
    "FaultPlan",
    "FaultTimeout",
    "KNOWN_POINTS",
    "fire",
    "install_plan",
    "clear_plan",
    "active_plan",
]

_ENV_VAR = "TDX_FAULT_PLAN"

# The registry of injection points wired in this package — the STATIC
# contract between fault plans and `fire()` call sites, enforced at lint
# time: distlint's R008 validates every fire() literal, fault-plan dict,
# and embedded JSON plan string against this frozen set (globs in plans
# must match at least one entry), so a typo'd point can never make a
# chaos test pass vacuously. Keep it in sync with the docstring above.
# There is deliberately NO runtime validation or extension hook: plans
# may name arbitrary points (unit tests fire synthetic ones), and R008
# only reads this literal.
KNOWN_POINTS = frozenset({
    "store.set",
    "store.get",
    "store.add",
    "store.check",
    "store.compare_set",
    "store.delete",
    "store.num_keys",
    "store.ping",
    "store.wait",
    "store.connect",
    "rendezvous.join",
    "p2p.connect",
    "p2p.send",
    "collective.dispatch",
    "comm.quantize",
    "schedule.mismatch",
    "plan.probe",
    "plan.step",
    "proglint.agree",
    "agent.heartbeat",
    "checkpoint.write",
    "checkpoint.finalize",
    "serve.admit",
    "serve.prefix_attach",
    "serve.prefill_chunk",
    "serve.step",
    "serve.drain",
    "serve.restore",
    "serve.scale_out",
    "serve.scale_in",
    "router.route",
    "agent.resize",
    "serve.worker.start",
    "serve.worker.register",
    "serve.restore_geometry",
    "serve.worker.gc",
    "serve.migrate.send",
    "serve.migrate.recv",
    "serve.pool.assign",
    "train.step",
})


class FaultTimeout(DistError, TimeoutError):
    """An injected 'request dropped' fault — looks like a network timeout
    to the caller, so the retry layer treats it as transient."""


_GENERIC_ACTIONS = ("delay", "hang", "reset", "drop", "error", "crash")
_ADVISORY_ACTIONS = ("stale", "corrupt")


@dataclass
class FaultRule:
    point: str
    action: str
    rank: Optional[int] = None
    after: int = 1  # 1-based index of the first matching call that fires
    times: int = 1  # consecutive firings; -1 = forever
    # only fire while TDX_RESTART_COUNT < restart_lt: per-process trigger
    # counters reset when the elastic agent respawns a worker, so a plan
    # meaning "fail the first generation, succeed after the restart"
    # needs this gate (gated calls are not counted against `after`)
    restart_lt: Optional[int] = None
    delay_s: Optional[float] = None
    prob: Optional[float] = None
    seed: int = 0
    message: str = "injected fault"
    exit_code: int = 13
    # per-rule state (never serialized)
    _calls: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultRule":
        known = {
            "point", "action", "rank", "after", "times", "delay_s",
            "prob", "seed", "message", "exit_code", "restart_lt",
        }
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"fault rule has unknown fields {sorted(unknown)}: {d}"
            )
        if "point" not in d or "action" not in d:
            raise ValueError(f"fault rule needs 'point' and 'action': {d}")
        action = d["action"]
        if action not in _GENERIC_ACTIONS + _ADVISORY_ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (valid: "
                f"{_GENERIC_ACTIONS + _ADVISORY_ACTIONS})"
            )
        return cls(
            point=d["point"],
            action=action,
            rank=d.get("rank"),
            after=int(d.get("after", 1)),
            times=int(d.get("times", 1)),
            delay_s=d.get("delay_s"),
            prob=d.get("prob"),
            seed=int(d.get("seed", 0)),
            message=d.get("message", "injected fault"),
            exit_code=int(d.get("exit_code", 13)),
            restart_lt=d.get("restart_lt"),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"point": self.point, "action": self.action}
        for k, default in (
            ("rank", None), ("after", 1), ("times", 1), ("delay_s", None),
            ("prob", None), ("seed", 0), ("message", "injected fault"),
            ("exit_code", 13), ("restart_lt", None),
        ):
            v = getattr(self, k)
            if v != default:
                out[k] = v
        return out

    def _matches_rank(self, rank: Optional[int]) -> bool:
        if self.rank is None:
            return True
        if rank is None:
            return False
        return int(rank) == int(self.rank)

    def consider(self, point: str, rank: Optional[int]) -> bool:
        """Count this call against the rule; True if the rule fires."""
        if not fnmatch.fnmatchcase(point, self.point):
            return False
        if not self._matches_rank(rank):
            return False
        if self.restart_lt is not None:
            try:
                rc = int(os.environ.get("TDX_RESTART_COUNT", "0") or 0)
            except ValueError:
                rc = 0
            if rc >= self.restart_lt:
                return False
        self._calls += 1
        if self.times >= 0 and self._fired >= self.times:
            return False
        if self._calls < self.after:
            return False  # `after` gates deterministic AND prob rules
        if self.prob is not None:
            # seeded per-rule stream: identical across reruns of the same
            # plan, independent across rules (seed defaults differ only
            # if declared — declare distinct seeds for distinct streams)
            if self._rng is None:
                self._rng = random.Random(
                    (self.seed, self.point, self.rank).__repr__()
                )
            if self._rng.random() >= self.prob:
                return False
        self._fired += 1
        return True


class FaultPlan:
    """A parsed plan plus its per-process trigger state."""

    def __init__(self, rules: List[FaultRule]):
        self.rules = rules
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"{_ENV_VAR} is not valid JSON: {e}") from e
        if isinstance(doc, dict):
            doc = [doc]
        if not isinstance(doc, list):
            raise ValueError(
                f"{_ENV_VAR} must be a rule object or list of rules"
            )
        return cls([FaultRule.from_dict(d) for d in doc])

    def to_json(self) -> str:
        return json.dumps([r.to_dict() for r in self.rules])

    def match(self, point: str, rank: Optional[int]) -> Optional[FaultRule]:
        with self._lock:
            for r in self.rules:
                if r.consider(point, rank):
                    return r
        return None


# Module state: the plan is loaded lazily from the env exactly once per
# process (workers inherit the env across spawn) or installed via API.
_plan: Optional[FaultPlan] = None
_plan_loaded = False
_plan_error: Optional[Exception] = None
_state_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """The installed/env plan, or None. A malformed TDX_FAULT_PLAN
    raises on EVERY call (the parse error is cached), never silently
    degrading to no-plan — a chaos test must not pass vacuously because
    of a JSON typo."""
    global _plan, _plan_loaded, _plan_error
    with _state_lock:
        if not _plan_loaded:
            raw = os.environ.get(_ENV_VAR)
            if raw:
                try:
                    _plan = FaultPlan.parse(raw)
                except Exception as e:
                    _plan_error = e
            _plan_loaded = True
        if _plan_error is not None:
            raise _plan_error
        return _plan


def enabled() -> bool:
    """Cheap check for call sites that keep optional state only to serve
    injected faults (e.g. the store client's stale-read cache): True iff
    a plan is active. Never raises — a malformed plan reads as enabled
    so the eventual fire() surfaces the parse error."""
    if not _plan_loaded:
        return bool(os.environ.get(_ENV_VAR))
    return _plan is not None or _plan_error is not None


def install_plan(plan, *, export_env: bool = True) -> FaultPlan:
    """Install a plan for this process; with `export_env` (default) the
    plan is also written to `TDX_FAULT_PLAN` so spawned workers inherit
    it. Accepts a FaultPlan, a list of rule dicts, or a JSON string."""
    global _plan, _plan_loaded
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    elif isinstance(plan, list):
        plan = FaultPlan([FaultRule.from_dict(d) for d in plan])
    elif not isinstance(plan, FaultPlan):
        raise TypeError(f"cannot install fault plan from {type(plan)}")
    global _plan_error
    with _state_lock:
        _plan = plan
        _plan_loaded = True
        _plan_error = None
    if export_env:
        os.environ[_ENV_VAR] = plan.to_json()
    return plan


def clear_plan() -> None:
    global _plan, _plan_loaded, _plan_error
    with _state_lock:
        _plan = None
        _plan_loaded = True
        _plan_error = None
    os.environ.pop(_ENV_VAR, None)


def _current_rank() -> Optional[int]:
    r = os.environ.get("RANK")
    if r is None:
        return None
    try:
        return int(r)
    except ValueError:
        return None


def fire(point: str, rank: Optional[int] = None, **ctx) -> Optional[FaultRule]:
    """Evaluate the active plan at a named injection point.

    Generic actions execute here (sleep / raise / exit). Advisory actions
    (`stale`, `corrupt`) return the matched rule for the call site to
    implement. Returns None when nothing fires — the overwhelmingly
    common case costs one None check plus (with a plan installed) one
    lock acquisition; with no plan it is a single global read."""
    # TDX_TRACE_GUARD: every injection point is a host-side effect, and
    # every blocking store/rendezvous/dispatch op fires through here —
    # one check covers the whole R011 surface with the op's own name.
    # The raw point string keeps the no-guard fast path allocation-free.
    traceguard.check(point)
    plan = (
        _plan
        if _plan_loaded and _plan_error is None
        else active_plan()
    )
    if plan is None:
        return None
    rule = plan.match(point, rank if rank is not None else _current_rank())
    if rule is None:
        return None
    if rule.action == "delay":
        time.sleep(rule.delay_s if rule.delay_s is not None else 0.05)
        return None
    if rule.action == "hang":
        time.sleep(rule.delay_s if rule.delay_s is not None else 3600.0)
        return None
    if rule.action == "reset":
        raise ConnectionResetError(
            f"injected connection reset at {point} ({ctx or ''})"
        )
    if rule.action == "drop":
        raise FaultTimeout(f"injected dropped request at {point} ({ctx or ''})")
    if rule.action == "error":
        raise DistError(f"{rule.message} (injected at {point})")
    if rule.action == "crash":
        os._exit(rule.exit_code)
    return rule  # advisory: stale / corrupt
