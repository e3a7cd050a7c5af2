"""Closed-loop SLO autoscaler — the control plane over the DP router.

Everything reactive already existed (class-ordered shedding, preemption,
drain/restore at any world size, `agent.resize`); this module CLOSES
the loop: a controller polls the gang's ROLLING-WINDOW
metrics (`ServeMetrics.window_view` merged across replicas by
`ServeRouter.window_view` — never lifetime aggregates, which can
neither see a fresh breach nor forgive an old one) and drives
`add_replica` / `remove_replica`, which ride the engine's
`snapshot_state()`/`drain()` seams so every resize is token-exact
mid-swing.

Stability over twitchiness — the mechanisms, and why each exists:

* **Hysteresis bands.** Scale OUT when the target class's windowed SLO
  attainment falls below `slo_floor` or the queue backlog per replica
  exceeds `queue_high`; scale IN only when attainment sits at
  `slo_ceiling` AND the gang is demonstrably idle (queue below
  `queue_low`, occupancy below `occupancy_low`). The dead band between
  the two means a gang sitting near either edge holds instead of
  flapping.
* **Breach streaks.** A band must hold for `breach_polls` CONSECUTIVE
  polls before the controller acts — a chaos-induced metric blip (one
  bad window after an injected fault, a restore-time cold start)
  shorter than the streak cannot trigger a resize.
* **Cooldowns.** After an applied resize the controller refuses further
  moves in the same direction for `cooldown_out_s` / `cooldown_in_s` —
  a resize's own transient (cold replica compiling, drained work
  replaying) must not be read as fresh pressure. Scale-in cooldown is
  deliberately the longer one: adding capacity late costs SLO, removing
  it early costs a re-add.
* **Max-step clamp.** No single decision moves the gang by more than
  `max_step` replicas, whatever the pressure reads — a corrupted metric
  cannot empty or explode the gang in one poll.

Every decision is LOGGED with the exact metric view that justified it
(`Decision.view`), making the control path deterministic and
replayable: feed the same views on the same fake clock and the same
resizes come out. ``TDX_AUTOSCALE_FORCE`` overrides the decision for
operators (runbook: ``hold`` pins the gang, ``out[:n]`` / ``in[:n]``
force a move, ``replicas:N`` steers toward an explicit size) — forced
moves skip bands/streaks/cooldowns but still respect min/max replica
bounds and the max-step clamp.

A copy of the reference's `serve/autoscale.py`, re-pointed at the
port's `faults`.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from .. import faults

__all__ = ["AutoscalePolicy", "Autoscaler", "Decision"]

FORCE_ENV = "TDX_AUTOSCALE_FORCE"

_TRANSIENT = (ConnectionResetError, faults.FaultTimeout)


@dataclass(frozen=True)
class AutoscalePolicy:
    """Controller knobs. Defaults are the bench's diurnal-swing tuning;
    real deployments should size the window to a few multiples of the
    target class's TTFT SLO."""

    target_class: str = ""
    # which windowed attainment the controller steers on: "ttft"
    # (first-token latency — the colocated default, and the PREFILL
    # pool of a disaggregated deployment) or "tpot" (per-decoded-token
    # latency — the DECODE pool's signal; `ClassSpec.tpot_slo_s` sets
    # the objective). Two pools each running their own Autoscaler with
    # their own signal is exactly the serve/disagg control plane.
    signal: str = "ttft"
    slo_floor: float = 0.99  # scale-out band: windowed attainment below
    slo_ceiling: float = 1.0  # scale-in needs attainment AT the ceiling
    queue_high: float = 4.0  # mean queued/replica forcing scale-out
    queue_low: float = 0.5  # mean queued/replica permitting scale-in
    occupancy_low: float = 0.5  # mean slot occupancy permitting scale-in
    breach_polls: int = 2  # consecutive in-band polls before acting
    cooldown_out_s: float = 2.0
    cooldown_in_s: float = 10.0
    max_step: int = 1  # replicas moved per decision, hard clamp
    min_replicas: int = 1
    max_replicas: int = 8

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if self.max_step < 1:
            raise ValueError(f"max_step must be >= 1, got {self.max_step}")
        if self.breach_polls < 1:
            raise ValueError(
                f"breach_polls must be >= 1, got {self.breach_polls}"
            )
        if self.signal not in ("ttft", "tpot"):
            raise ValueError(
                f"signal must be 'ttft' or 'tpot', got {self.signal!r}"
            )


@dataclass
class Decision:
    """One controller poll, with the evidence: the action taken, why,
    and the exact windowed metric view it steered on. `outcome` is
    "applied", "held", or "aborted: ..." (a transient chaos fault at
    the scale seam — the gang stayed at `replicas_before` and the
    streak survives, so the controller simply retries next poll)."""

    t: float
    action: str  # "scale_out" | "scale_in" | "hold"
    amount: int
    replicas_before: int
    replicas_after: int
    reason: str
    outcome: str
    forced: bool = False
    view: Dict = field(default_factory=dict)

    def to_state(self) -> Dict:
        return asdict(self)


def _parse_force(raw: str):
    """``hold``/``off`` | ``out[:n]`` | ``in[:n]`` | ``replicas:N`` ->
    (mode, n) or None for unset/malformed (malformed warns — a typo'd
    operator override must not crash the serve loop, and must not
    silently pin the gang either)."""
    raw = raw.strip().lower()
    if not raw:
        return None
    head, _, arg = raw.partition(":")
    try:
        if head in ("hold", "off"):
            return ("hold", 0)
        if head in ("out", "in"):
            return (head, int(arg) if arg else 1)
        if head == "replicas":
            return ("replicas", int(arg))
    except ValueError:
        pass
    warnings.warn(
        f"{FORCE_ENV}={raw!r} is malformed (want hold | out[:n] | "
        f"in[:n] | replicas:N); ignoring",
        RuntimeWarning,
        stacklevel=2,
    )
    return None


class Autoscaler:
    def __init__(
        self,
        router,
        policy: AutoscalePolicy,
        clock=time.monotonic,
        window_s: Optional[float] = None,
        max_decisions: int = 1024,
    ):
        self.router = router
        self.policy = policy
        self.clock = clock
        self.window_s = window_s  # None: the metrics' own default
        self._lock = threading.Lock()
        self.decisions: deque = deque(maxlen=max_decisions)
        self._out_streak = 0
        self._in_streak = 0
        self._last_out = -float("inf")
        self._last_in = -float("inf")
        self.resizes = 0

    # -- decision ----------------------------------------------------------
    def _pressure(self, view: Dict) -> Dict:
        """The scalar signals one poll steers on, extracted from the
        merged window view (kept on the Decision for replay)."""
        row = view["classes"].get(self.policy.target_class, {})
        att_key = (
            "tpot_attainment"
            if self.policy.signal == "tpot"
            else "slo_attainment"
        )
        return {
            "signal": self.policy.signal,
            "attainment": row.get(att_key),
            "queue_per_replica": view["queue_depth_mean_per_replica"],
            "occupancy": view["occupancy_mean"],
            "pool_utilization": view["pool_utilization_mean"],
            "replicas": view["replicas"],
        }

    def _decide(self, p: Dict, now: float, n: int):
        """(action, amount, reason) from the pressure signals — pure
        function of its inputs plus the streak/cooldown state, no
        clock reads, no randomness."""
        pol = self.policy
        att = p["attainment"]
        qpr = p["queue_per_replica"]
        out_band = (att is not None and att < pol.slo_floor) or (
            qpr > pol.queue_high
        )
        in_band = (
            (att is None or att >= pol.slo_ceiling)
            and qpr < pol.queue_low
            and p["occupancy"] < pol.occupancy_low
        )
        self._out_streak = self._out_streak + 1 if out_band else 0
        self._in_streak = self._in_streak + 1 if in_band else 0
        if out_band:
            if n >= pol.max_replicas:
                return "hold", 0, "out-band but at max_replicas"
            if self._out_streak < pol.breach_polls:
                return (
                    "hold",
                    0,
                    f"out-band streak {self._out_streak}/"
                    f"{pol.breach_polls}",
                )
            if now - self._last_out < pol.cooldown_out_s:
                return "hold", 0, "out-band but in scale-out cooldown"
            # pressure-proportional request, hard-clamped: a queue at
            # k x queue_high asks for k replicas, never more than
            # max_step per decision
            want = max(1, int(qpr // max(pol.queue_high, 1e-9)))
            amount = min(want, pol.max_step, pol.max_replicas - n)
            return (
                "scale_out",
                amount,
                f"attainment={att} < floor {pol.slo_floor}"
                if att is not None and att < pol.slo_floor
                else f"queue/replica={qpr} > high {pol.queue_high}",
            )
        if in_band:
            if n <= pol.min_replicas:
                return "hold", 0, "in-band but at min_replicas"
            if self._in_streak < pol.breach_polls:
                return (
                    "hold",
                    0,
                    f"in-band streak {self._in_streak}/{pol.breach_polls}",
                )
            if now - self._last_in < pol.cooldown_in_s:
                return "hold", 0, "in-band but in scale-in cooldown"
            amount = min(pol.max_step, n - pol.min_replicas)
            return (
                "scale_in",
                amount,
                f"idle: attainment={att}, queue/replica={qpr}, "
                f"occupancy={p['occupancy']}",
            )
        return "hold", 0, "inside the dead band"

    def _forced_decision(self, force, n: int):
        pol = self.policy
        mode, k = force
        if mode == "hold":
            return "hold", 0, f"forced hold ({FORCE_ENV})"
        if mode == "replicas":
            k = max(pol.min_replicas, min(k, pol.max_replicas))
            if k > n:
                mode, k = "out", k - n
            elif k < n:
                mode, k = "in", n - k
            else:
                return "hold", 0, f"forced replicas target met ({n})"
        if mode == "out":
            amount = min(k, pol.max_step, pol.max_replicas - n)
            if amount <= 0:
                return "hold", 0, "forced out but at max_replicas"
            return "scale_out", amount, f"forced scale_out ({FORCE_ENV})"
        amount = min(k, pol.max_step, n - pol.min_replicas)
        if amount <= 0:
            return "hold", 0, "forced in but at min_replicas"
        return "scale_in", amount, f"forced scale_in ({FORCE_ENV})"

    # -- the loop body -----------------------------------------------------
    def poll(self) -> Decision:
        """One control iteration: read the merged window, decide, act.
        Call it from the serve loop every poll interval (the bench uses
        a virtual clock; real loops use wall time). Transient chaos
        faults at the scale seams abort the resize cleanly — the
        decision records the abort and the next poll retries."""
        now = float(self.clock())
        view = self.router.window_view(window_s=self.window_s, now=now)
        n = view["replicas"]
        p = self._pressure(view)
        force = _parse_force(os.environ.get(FORCE_ENV, ""))
        if force is not None:
            action, amount, reason = self._forced_decision(force, n)
        else:
            action, amount, reason = self._decide(p, now, n)
        outcome = "held"
        applied = 0
        if action == "scale_out":
            outcome, applied = self._apply(self.router.add_replica, amount)
            if applied:
                self._last_out = now
                self._out_streak = 0
        elif action == "scale_in":
            outcome, applied = self._apply(
                self.router.remove_replica, amount
            )
            if applied:
                self._last_in = now
                self._in_streak = 0
        dec = Decision(
            t=now,
            action=action,
            amount=applied if action != "hold" else 0,
            replicas_before=n,
            replicas_after=self.router.num_replicas,
            reason=reason,
            outcome=outcome,
            forced=force is not None,
            view=dict(p, window_s=view["window_s"]),
        )
        with self._lock:
            self.decisions.append(dec)
            if applied:
                self.resizes += 1
        return dec

    def _apply(self, op, amount: int):
        """Run one scale op `amount` times; a transient injected fault
        stops the batch with whatever already applied (each unit is
        individually consistent — the router's seams fire BEFORE any
        mutation)."""
        applied = 0
        for _ in range(amount):
            try:
                op()
            except _TRANSIENT as e:
                return (
                    f"aborted after {applied}/{amount}: "
                    f"{type(e).__name__}",
                    applied,
                )
            applied += 1
        return "applied", applied

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON for the debug HTTP frontend: the recent decision log
        (with the metric views that justified each) plus streak /
        cooldown state — the replay surface."""
        with self._lock:
            recent = [d.to_state() for d in list(self.decisions)[-32:]]
            return {
                "policy": asdict(self.policy),
                "resizes": self.resizes,
                "decisions": recent,
                "out_streak": self._out_streak,
                "in_streak": self._in_streak,
                "replicas": self.router.num_replicas,
            }
