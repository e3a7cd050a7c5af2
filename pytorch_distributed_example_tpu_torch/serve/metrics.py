"""ServeMetrics — the engine's observability block.

A copy of the reference's `serve/metrics.py`.

Tracks queue depth, slot occupancy, TTFT / TPOT / end-to-end latency
percentiles, tokens/s goodput (completed-request tokens only — a
request killed mid-stream contributes nothing until its replay
finishes, which is what makes the number "goodput" rather than raw
throughput), bounded-admission sheds, and PAGED CACHE POOL utilization
(live blocks / total blocks, live cache bytes per live request vs the
dense per-slot layout's constant — the runtime-observable form of the
paged cache's memory claim). A `clock` injection point keeps the
accounting testable with a fake clock; `snapshot()` returns plain JSON
for the debug HTTP frontend (`utils/debug_http.py` route ``/serve``).

Multi-tenant serving adds PER-CLASS breakdowns (completed / shed /
preempted / TTFT percentiles / SLO attainment per priority class — the
evidence that the overload controller protects the high class while the
low class absorbs the sheds) and a RECOVERY block: every elastic
restore records how long the serving plane was dark (drain/death →
first token on the re-formed gang), how many requests the checkpoint
carried back, and how many already-emitted tokens had to replay.

The PREFIX_CACHE block is the sharing evidence: hit rate
and prefix tokens reused (prefill compute + pool writes skipped),
shared / copy-on-write-copied block counts, and pool bytes
deduplicated vs a no-sharing layout (current gauge + peak).

ROLLING WINDOWS: the autoscale controller must steer on
what the engine did RECENTLY, not on lifetime aggregates — a lifetime
SLO-attainment figure diluted by an hour of healthy traffic cannot see
a breach that started thirty seconds ago, and a lifetime figure
poisoned by one old incident never recovers, so a controller reading
either would scale late in both directions. Every completion, step,
and pool observation therefore also lands a TIMESTAMPED sample in a
bounded deque, and `window_view(window_s)` reduces only the samples
inside the trailing window: per-class completed / shed / SLO
attainment / TTFT percentiles, queue-depth mean+max, slot occupancy,
and pool utilization. `snapshot()` exposes the default-window view
under ``window`` so ``/serve`` shows the controller's own evidence.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

from .queue import DEFAULT_CLASS, ClassSpec

__all__ = ["ServeMetrics", "merge_window_views", "percentile"]


def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) — numpy-free so a
    snapshot never allocates device memory."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1 - frac) + xs[hi] * frac)


def merge_window_views(views, now, window_s=None) -> Dict:
    """Merge per-engine `ServeMetrics.window_view` dicts into one
    pool-wide view — EXACT merging (sums of raw slo_met/slo_n and
    tpot_slo_met/tpot_slo_n counts, never averages of ratios — two
    replicas at 10/10 and 0/1 must read 10/11, not 0.5). Queue depth
    sums across members (total backlog); occupancy and pool pressure
    average (per-chip pressure is what admission feels).

    The ONE definition of the merge, shared by the DP `ServeRouter`
    and each pool of the disaggregated router (`serve/disagg`)
    — both controllers must steer on identically-shaped evidence."""
    views = list(views)
    classes: Dict[str, Dict] = {}
    for v in views:
        for k, row in v["classes"].items():
            agg = classes.setdefault(
                k,
                {
                    "completed": 0, "shed": 0, "slo_met": 0, "slo_n": 0,
                    "tpot_slo_met": 0, "tpot_slo_n": 0,
                },
            )
            agg["completed"] += row["completed"]
            agg["shed"] += row["shed"]
            agg["slo_met"] += row["slo_met"]
            agg["slo_n"] += row["slo_n"]
            agg["tpot_slo_met"] += row.get("tpot_slo_met", 0)
            agg["tpot_slo_n"] += row.get("tpot_slo_n", 0)
    for row in classes.values():
        row["slo_attainment"] = (
            round(row["slo_met"] / row["slo_n"], 4)
            if row["slo_n"]
            else None
        )
        row["tpot_attainment"] = (
            round(row["tpot_slo_met"] / row["tpot_slo_n"], 4)
            if row["tpot_slo_n"]
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


class ServeMetrics:
    def __init__(
        self,
        clock=time.monotonic,
        slots: int = 0,
        max_latency_samples: int = 2048,
        classes: Optional[Dict[str, ClassSpec]] = None,
        window_s: float = 30.0,
    ):
        self.clock = clock
        self.slots = slots
        self.window_s = window_s  # default trailing window for views
        self._lock = threading.Lock()
        self._max_latency_samples = max_latency_samples
        self.submitted = 0
        self.admitted = 0  # admission ATTEMPTS (a requeued request re-admits)
        self.completed = 0
        self.requeued = 0
        self.shed = 0  # bounded-admission rejections (never enqueued)
        self.preempted = 0  # pool-pressure evictions (requeued, will replay)
        self.class_preempted = 0  # cross-CLASS evictions (priority inversion)
        # per-class breakdowns; classes may also appear lazily (a request
        # naming a class the snapshot has not seen simply opens one)
        self._classes: Dict[str, ClassSpec] = dict(classes or {})
        self._by_class: Dict[str, Dict] = {}
        for k in self._classes:
            self._class_state(k)
        # elastic recovery: restores into THIS engine incarnation
        self.restores = 0
        self.requests_restored = 0
        self.tokens_replayed = 0
        self.last_recovery_s = 0.0
        self.restored_generation = -1
        self._queue_class_depths: Dict[str, int] = {}
        self.steps = 0
        # paged-pool gauges (last observation) + time-mean accumulators
        self.pool_blocks_live = 0
        self.pool_blocks_total = 0
        self.pool_bytes_per_block = 0
        self.dense_bytes_per_request = 0
        self.cache_wire_dtype = ""  # pool storage dtype (int8 when quantized)
        self.scale_bytes_per_block = 0  # quantized pools: scale-plane bytes
        self.effective_slots = 0  # worst-case requests the pool can hold
        # prefix-cache plane: attach counters accumulate,
        # block-level figures are per-step gauges from the pool
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.prefix_blocks_attached = 0
        self.prefix_shared_blocks = 0  # gauge: blocks refcounted > 1
        self.prefix_cached_blocks = 0  # gauge: refcount-0 index-kept blocks
        self.prefix_index_nodes = 0  # gauge: radix entries
        self.cow_copies = 0  # cumulative copy-on-write block copies
        self.bytes_deduplicated = 0  # gauge: pool bytes sharing saves now
        self.peak_bytes_deduplicated = 0
        self.peak_slots_active = 0  # max concurrent in-flight requests seen
        self._pool_util_sum = 0.0
        self._pool_samples = 0
        self._bytes_per_req_sum = 0.0
        self._bytes_per_req_samples = 0
        self.tokens_completed = 0
        self.queue_depth = 0
        self.slots_active = 0
        self._occupancy_steps = 0.0  # sum of per-step occupancy fractions
        # bounded windows: a long-lived serving process must not grow
        # (or re-sort under the lock) an unbounded history per /serve poll
        self.ttft_s: deque = deque(maxlen=max_latency_samples)
        self.tpot_s: deque = deque(maxlen=max_latency_samples)
        self.e2e_s: deque = deque(maxlen=max_latency_samples)
        # rolling-window sample streams: timestamped so a
        # trailing-window reduction needs no extra bookkeeping at
        # record time. Bounded like the latency deques — a window wider
        # than what maxlen samples span simply reports what it has.
        self._step_win: deque = deque(maxlen=2 * max_latency_samples)
        self._pool_win: deque = deque(maxlen=2 * max_latency_samples)
        self._first_submit: Optional[float] = None
        self._last_complete: Optional[float] = None

    def _class_state(self, klass: str) -> Dict:
        """Per-class accumulator (caller holds the lock or is __init__)."""
        st = self._by_class.get(klass)
        if st is None:
            st = {
                "submitted": 0,
                "completed": 0,
                "shed": 0,
                "preempted": 0,
                "tokens": 0,
                "slo_met": 0,
                "ttft": deque(maxlen=self._max_latency_samples),
                "e2e": deque(maxlen=self._max_latency_samples),
                # (t, ttft_s, slo_ok-or-None) first-token samples for
                # the trailing-window reduction; (t,) shed samples and
                # (t, tpot_s, tpot_ok-or-None) completion-time TPOT
                # samples likewise. TTFT samples land at FIRST TOKEN
                # (completion for a colocated engine, prefill handoff
                # for a disaggregated prefill pool) and TPOT samples at
                # completion — the two pools of a disagg deployment
                # steer on their own stream.
                "win": deque(maxlen=self._max_latency_samples),
                "shed_win": deque(maxlen=self._max_latency_samples),
                "tpot_win": deque(maxlen=self._max_latency_samples),
            }
            self._by_class[klass] = st
        return st

    # -- recording hooks (engine-driven) -----------------------------------
    def record_submit(self, t: float, klass: str = DEFAULT_CLASS) -> None:
        with self._lock:
            self.submitted += 1
            self._class_state(klass)["submitted"] += 1
            if self._first_submit is None:
                self._first_submit = t

    def record_admit(self) -> None:
        with self._lock:
            self.admitted += 1

    def record_step(
        self,
        queue_depth: int,
        slots_active: int,
        class_depths: Optional[Dict] = None,
    ) -> None:
        with self._lock:
            self.steps += 1
            self.queue_depth = queue_depth
            self.slots_active = slots_active
            if class_depths is not None:
                self._queue_class_depths = {
                    k: int(sum(v)) for k, v in class_depths.items()
                }
            self.peak_slots_active = max(self.peak_slots_active, slots_active)
            self._step_win.append((self.clock(), queue_depth, slots_active))
            if self.slots:
                self._occupancy_steps += slots_active / self.slots

    def record_requeue(self, n: int = 1) -> None:
        with self._lock:
            self.requeued += n

    def record_shed(self, klass: str = DEFAULT_CLASS) -> None:
        """One overload shed: a bounded-admission rejection OR a queued
        low-class request displaced by higher-class work."""
        with self._lock:
            self.shed += 1
            st = self._class_state(klass)
            st["shed"] += 1
            st["shed_win"].append(self.clock())

    def record_preempt(self, n: int = 1, klass: str = DEFAULT_CLASS) -> None:
        """Pool-pressure evictions: requests requeued to free blocks."""
        with self._lock:
            self.preempted += n
            self._class_state(klass)["preempted"] += n

    def record_class_preempt(self, klass: str = DEFAULT_CLASS) -> None:
        """A cross-class eviction: a low-class in-flight request gave
        its slot/blocks to waiting higher-class work (it requeues and
        replays token-identically, like any preemption)."""
        with self._lock:
            self.class_preempted += 1
            self._class_state(klass)["preempted"] += 1

    def record_recovery(
        self,
        recovery_s: float,
        requests_restored: int,
        tokens_replayed: int,
        generation: int,
    ) -> None:
        """One elastic restore landed: the re-formed gang served its
        first post-restore token `recovery_s` after the checkpoint was
        cut (shared-timebase clocks on both sides — the drain stamps the
        checkpoint, the restored engine's first completed step closes
        the window)."""
        with self._lock:
            self.restores += 1
            self.requests_restored += requests_restored
            self.tokens_replayed += tokens_replayed
            self.last_recovery_s = recovery_s
            self.restored_generation = generation

    def record_pool(
        self,
        blocks_live: int,
        blocks_total: int,
        bytes_per_block: int,
        live_requests: int,
        dense_bytes_per_request: int,
        wire_dtype: str = "",
        scale_bytes_per_block: int = 0,
        effective_slots: int = 0,
        shared_blocks: int = 0,
        cached_free_blocks: int = 0,
        cow_copies: int = 0,
        bytes_deduplicated: int = 0,
        prefix_stats: Optional[Dict] = None,
    ) -> None:
        """Per-step paged-pool observation. Gauges keep the LAST value;
        utilization and bytes-per-live-request also accumulate a
        time-mean (bytes/request samples only when requests are live,
        so idle steps don't dilute the memory claim). `wire_dtype` /
        `scale_bytes_per_block` / `effective_slots` describe the pool's
        storage format (int8 pools report their scale-plane overhead
        and the capacity-in-worst-case-requests figure). The prefix-
        sharing figures land on the `/serve` prefix_cache block:
        `shared_blocks`/`cached_free_blocks`/`bytes_deduplicated`
        gauges plus the cumulative `cow_copies` come from the cache,
        and `prefix_stats` is `PrefixIndex.stats()` verbatim — the
        index is the ONE place hit/miss/reuse counting lives, so the
        two surfaces can never drift."""
        with self._lock:
            self.pool_blocks_live = blocks_live
            self.pool_blocks_total = blocks_total
            self.pool_bytes_per_block = bytes_per_block
            self.dense_bytes_per_request = dense_bytes_per_request
            self.cache_wire_dtype = wire_dtype
            self.scale_bytes_per_block = scale_bytes_per_block
            self.effective_slots = effective_slots
            self.prefix_shared_blocks = shared_blocks
            self.prefix_cached_blocks = cached_free_blocks
            self.cow_copies = cow_copies
            self.bytes_deduplicated = bytes_deduplicated
            self.peak_bytes_deduplicated = max(
                self.peak_bytes_deduplicated, bytes_deduplicated
            )
            if prefix_stats is not None:
                self.prefix_hits = prefix_stats["hits"]
                self.prefix_misses = prefix_stats["misses"]
                self.prefix_tokens_reused = prefix_stats[
                    "prefix_tokens_reused"
                ]
                self.prefix_blocks_attached = prefix_stats[
                    "blocks_attached"
                ]
                self.prefix_index_nodes = prefix_stats["nodes"]
            if blocks_total:
                self._pool_util_sum += blocks_live / blocks_total
                self._pool_samples += 1
                self._pool_win.append(
                    (self.clock(), blocks_live / blocks_total)
                )
            if live_requests > 0:
                self._bytes_per_req_sum += (
                    blocks_live * bytes_per_block / live_requests
                )
                self._bytes_per_req_samples += 1

    def record_complete(
        self,
        t: float,
        n_tokens: int,
        ttft_s: float,
        tpot_s: float,
        e2e_s: float,
        klass: str = DEFAULT_CLASS,
    ) -> None:
        """All latency samples land here, at COMPLETION — an admission
        attempt aborted by a mid-stream requeue leaves no sample, so the
        percentiles describe only requests that actually finished."""
        with self._lock:
            self.completed += 1
            self.tokens_completed += n_tokens
            self.ttft_s.append(ttft_s)
            self.tpot_s.append(tpot_s)
            self.e2e_s.append(e2e_s)
            st = self._class_state(klass)
            st["completed"] += 1
            st["tokens"] += n_tokens
            st["ttft"].append(ttft_s)
            st["e2e"].append(e2e_s)
            spec = self._classes.get(klass)
            slo_ok = None
            if spec is not None and spec.ttft_slo_s is not None:
                slo_ok = ttft_s <= spec.ttft_slo_s
                st["slo_met"] += int(slo_ok)
            st["win"].append((t, ttft_s, slo_ok))
            # TPOT verdicts only for multi-token requests: a 1-token
            # completion has no inter-token interval, and its 0.0 would
            # read as a free SLO pass diluting the decode-pool signal
            if n_tokens > 1:
                tpot_ok = None
                if spec is not None and spec.tpot_slo_s is not None:
                    tpot_ok = tpot_s <= spec.tpot_slo_s
                st["tpot_win"].append((t, tpot_s, tpot_ok))
            self._last_complete = t

    def record_first_token(
        self, t: float, ttft_s: float, klass: str = DEFAULT_CLASS
    ) -> None:
        """A first token served WITHOUT a completion on this engine —
        the disaggregated prefill pool's handoff path (`serve/disagg`):
        the request's decode (and its completion sample) happens on the
        decode pool, but the TTFT evidence — and its SLO verdict — is
        this pool's product, so the window sample lands here, where the
        prefill autoscaler is looking."""
        with self._lock:
            st = self._class_state(klass)
            st["ttft"].append(ttft_s)
            spec = self._classes.get(klass)
            slo_ok = None
            if spec is not None and spec.ttft_slo_s is not None:
                slo_ok = ttft_s <= spec.ttft_slo_s
                st["slo_met"] += int(slo_ok)
            st["win"].append((t, ttft_s, slo_ok))

    # -- reporting ---------------------------------------------------------
    def _window_view_locked(
        self, window_s: float, now: float
    ) -> Dict:
        """Trailing-window reduction (caller holds the lock). The shape
        the autoscale controller steers on: per-class attainment over
        samples with a defined SLO verdict (None when the window holds
        no verdict — "no evidence" must be distinguishable from "SLO
        perfect", or an idle trough would read as healthy forever),
        plus queue/occupancy/pool-pressure means over the same window.
        Bounded on BOTH sides — a replay with a historical `now` must
        see exactly what the controller saw then, not samples from its
        future."""
        cutoff = now - window_s
        by_class: Dict[str, Dict] = {}
        for k, st in sorted(self._by_class.items()):
            samples = [s for s in st["win"] if cutoff <= s[0] <= now]
            verdicts = [s[2] for s in samples if s[2] is not None]
            ttfts = [s[1] for s in samples]
            tpots = [s for s in st["tpot_win"] if cutoff <= s[0] <= now]
            tpot_verdicts = [s[2] for s in tpots if s[2] is not None]
            by_class[k] = {
                "completed": len(samples),
                "shed": sum(
                    1 for t in st["shed_win"] if cutoff <= t <= now
                ),
                # raw counts ride along so a multi-replica merger can
                # sum them exactly instead of averaging ratios
                "slo_met": sum(bool(v) for v in verdicts),
                "slo_n": len(verdicts),
                "slo_attainment": (
                    round(sum(verdicts) / len(verdicts), 4)
                    if verdicts
                    else None
                ),
                "ttft_p50_ms": round(percentile(ttfts, 50) * 1e3, 3),
                "ttft_p99_ms": round(percentile(ttfts, 99) * 1e3, 3),
                # the decode-pool plane: per-token latency samples with
                # their own SLO verdicts (`ClassSpec.tpot_slo_s`) —
                # same raw-count discipline for exact merging
                "tpot_slo_met": sum(bool(v) for v in tpot_verdicts),
                "tpot_slo_n": len(tpot_verdicts),
                "tpot_attainment": (
                    round(sum(tpot_verdicts) / len(tpot_verdicts), 4)
                    if tpot_verdicts
                    else None
                ),
                "tpot_p50_ms": round(
                    percentile([s[1] for s in tpots], 50) * 1e3, 3
                ),
                "tpot_p99_ms": round(
                    percentile([s[1] for s in tpots], 99) * 1e3, 3
                ),
            }
        steps = [s for s in self._step_win if cutoff <= s[0] <= now]
        pools = [s for s in self._pool_win if cutoff <= s[0] <= now]
        n_steps = len(steps)
        return {
            "window_s": window_s,
            "now": now,
            "classes": by_class,
            "steps": n_steps,
            "queue_depth_mean": round(
                sum(s[1] for s in steps) / n_steps, 3
            ) if n_steps else 0.0,
            "queue_depth_max": max((s[1] for s in steps), default=0),
            "occupancy_mean": round(
                sum(s[2] for s in steps) / (n_steps * self.slots), 4
            ) if n_steps and self.slots else 0.0,
            "pool_utilization_mean": round(
                sum(u for _, u in pools) / len(pools), 4
            ) if pools else 0.0,
            "pool_utilization_max": round(
                max((u for _, u in pools), default=0.0), 4
            ),
        }

    def window_view(
        self,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """Rolling-window view over the trailing `window_s` seconds
        (default: the instance's `window_s`). `now` defaults to the
        metrics clock — pass it explicitly to replay a recorded
        decision against the exact snapshot that justified it."""
        with self._lock:
            return self._window_view_locked(
                self.window_s if window_s is None else float(window_s),
                self.clock() if now is None else float(now),
            )

    def goodput_tokens_per_sec(self) -> float:
        """Completed-request tokens over the first-submit → last-complete
        window. 0 until at least one request completed."""
        with self._lock:
            if (
                self._first_submit is None
                or self._last_complete is None
                or self._last_complete <= self._first_submit
            ):
                return 0.0
            return self.tokens_completed / (
                self._last_complete - self._first_submit
            )

    def snapshot(self) -> Dict:
        with self._lock:
            lat = {
                name: {
                    "p50_ms": round(percentile(xs, 50) * 1e3, 3),
                    "p90_ms": round(percentile(xs, 90) * 1e3, 3),
                    "p99_ms": round(percentile(xs, 99) * 1e3, 3),
                    "n": len(xs),
                }
                for name, xs in (
                    ("ttft", self.ttft_s),
                    ("tpot", self.tpot_s),
                    ("e2e", self.e2e_s),
                )
            }
            occupancy = (
                self._occupancy_steps / self.steps if self.steps else 0.0
            )
            mean_util = (
                self._pool_util_sum / self._pool_samples
                if self._pool_samples else 0.0
            )
            mean_bpr = (
                self._bytes_per_req_sum / self._bytes_per_req_samples
                if self._bytes_per_req_samples else 0.0
            )
            by_class = {}
            for k, st in sorted(self._by_class.items()):
                spec = self._classes.get(k)
                row = {
                    "queue_depth": self._queue_class_depths.get(k, 0),
                    "submitted": st["submitted"],
                    "completed": st["completed"],
                    "shed": st["shed"],
                    "preempted": st["preempted"],
                    "tokens_completed": st["tokens"],
                    "ttft_p50_ms": round(
                        percentile(st["ttft"], 50) * 1e3, 3
                    ),
                    "ttft_p99_ms": round(
                        percentile(st["ttft"], 99) * 1e3, 3
                    ),
                    "e2e_p99_ms": round(percentile(st["e2e"], 99) * 1e3, 3),
                }
                if spec is not None:
                    row["priority"] = spec.priority
                    row["weight"] = spec.weight
                    if spec.ttft_slo_s is not None:
                        row["ttft_slo_ms"] = round(spec.ttft_slo_s * 1e3, 3)
                        row["slo_attainment"] = round(
                            st["slo_met"] / st["completed"], 4
                        ) if st["completed"] else 0.0
                by_class[k] = row
            snap = {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "completed": self.completed,
                "requeued": self.requeued,
                "shed": self.shed,
                "preempted": self.preempted,
                "class_preempted": self.class_preempted,
                "classes": by_class,
                "recovery": {
                    "restores": self.restores,
                    "requests_restored": self.requests_restored,
                    "tokens_replayed": self.tokens_replayed,
                    "last_recovery_s": round(self.last_recovery_s, 6),
                    "restored_generation": self.restored_generation,
                },
                "steps": self.steps,
                "queue_depth": self.queue_depth,
                "slots": self.slots,
                "slots_active": self.slots_active,
                "peak_slots_active": self.peak_slots_active,
                "mean_occupancy": round(occupancy, 4),
                "tokens_completed": self.tokens_completed,
                # the controller's evidence, on the same surface it
                # polls — lifetime aggregates above, trailing window here
                "window": self._window_view_locked(
                    self.window_s, self.clock()
                ),
                "latency": lat,
                "cache_pool": {
                    "blocks_live": self.pool_blocks_live,
                    "blocks_total": self.pool_blocks_total,
                    "utilization": round(
                        self.pool_blocks_live / self.pool_blocks_total, 4
                    ) if self.pool_blocks_total else 0.0,
                    "mean_utilization": round(mean_util, 4),
                    "bytes_live": (
                        self.pool_blocks_live * self.pool_bytes_per_block
                    ),
                    "bytes_per_live_request_mean": round(mean_bpr, 1),
                    "dense_bytes_per_request": self.dense_bytes_per_request,
                    "dense_reduction_x": round(
                        self.dense_bytes_per_request / mean_bpr, 2
                    ) if mean_bpr else 0.0,
                    # storage format: int8 pools report their wire dtype,
                    # the scale-plane overhead, and how many worst-case
                    # requests the pool holds (slots-per-chip capacity)
                    "wire_dtype": self.cache_wire_dtype,
                    "scale_overhead_bytes": (
                        self.scale_bytes_per_block * self.pool_blocks_total
                    ),
                    "effective_slots": self.effective_slots,
                },
                # prefix sharing: hit rate + tokens whose
                # prefill compute/pool writes were skipped, block-level
                # sharing gauges, CoW copies, and the pool bytes
                # deduplicated vs a no-sharing layout
                "prefix_cache": {
                    "hits": self.prefix_hits,
                    "misses": self.prefix_misses,
                    "hit_rate": round(
                        self.prefix_hits
                        / (self.prefix_hits + self.prefix_misses),
                        4,
                    ) if (self.prefix_hits + self.prefix_misses) else 0.0,
                    "prefix_tokens_reused": self.prefix_tokens_reused,
                    "blocks_attached": self.prefix_blocks_attached,
                    "shared_blocks": self.prefix_shared_blocks,
                    "cached_blocks": self.prefix_cached_blocks,
                    "index_nodes": self.prefix_index_nodes,
                    "cow_copies": self.cow_copies,
                    "bytes_deduplicated": self.bytes_deduplicated,
                    "peak_bytes_deduplicated": (
                        self.peak_bytes_deduplicated
                    ),
                },
            }
        snap["goodput_tokens_per_sec"] = round(
            self.goodput_tokens_per_sec(), 3
        )
        return snap
