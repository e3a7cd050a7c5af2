"""Watchdog + HeartbeatMonitor — hang detection for outstanding collectives.

Parity surface (SURVEY.md §2.2 N10, §5.3): torch ProcessGroupNCCL's
`Watchdog` thread scanning `workMetaList_` for timed-out work
(`ProcessGroupNCCL.hpp:676,701,1387`) with flight-recorder dump on timeout
(`TORCH_NCCL_DUMP_ON_TIMEOUT`), and the `HeartbeatMonitor` that kills the
process if the watchdog itself wedges (`:596-608`,
`TORCH_NCCL_HEARTBEAT_TIMEOUT_SEC`).

On the port, outstanding work = collectives whose `TensorWork` event has
not fired yet, plus dispatches that have not returned (a gloo collective
blocks inside dispatch when a peer never joins). A hung collective leaves
its Work unready past the group timeout; the watchdog then dumps the
flight recorder and invokes the abort callback.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from typing import Callable, List, Optional, Tuple

from .flight_recorder import DebugInfoWriter, FlightRecorder, global_recorder


class Watchdog:
    """Background scanner over registered in-flight Works."""

    def __init__(
        self,
        timeout_s: float = 1800.0,
        poll_interval_s: float = 1.0,
        on_timeout: Optional[Callable] = None,
        recorder: Optional[FlightRecorder] = None,
        writer: Optional[DebugInfoWriter] = None,
        dump_on_timeout: bool = True,
    ):
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s
        self.on_timeout = on_timeout
        self.recorder = recorder or global_recorder()
        self.writer = writer or DebugInfoWriter()
        self.dump_on_timeout = dump_on_timeout
        self._work: List[Tuple[float, str, object]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_heartbeat = time.monotonic()
        self.tripped: Optional[str] = None

    # -- registration ------------------------------------------------------
    def register(self, work, desc: str = "") -> None:
        # strong reference: the sync path discards its Work immediately, and
        # a weakref would die before the first scan — completed entries are
        # dropped every poll, so retention is bounded by the poll interval.
        with self._lock:
            self._work.append((time.monotonic(), desc, work))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        """Idempotent while running; restartable after stop() (including
        a stop() that timed out on a wedged callback — once that thread
        dies the next start() replaces it)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()  # fresh: a reused set() event
        self.last_heartbeat = time.monotonic()  # would kill the new thread
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tdx-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Signal and join the scanner. A scan wedged inside a timeout
        callback can outlive the 5s join grace — the thread reference is
        kept so a still-running scanner is never orphaned into a leak
        (start() refuses to double-spawn while it lives)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
            if not t.is_alive():
                self._thread = None

    def _run(self) -> None:
        stop = self._stop
        while not stop.wait(self.poll_interval_s):
            self.last_heartbeat = time.monotonic()
            self._scan()

    def _scan(self) -> None:
        now = time.monotonic()
        with self._lock:
            alive = []
            expired = []
            for t0, desc, w in self._work:
                if w.is_completed():
                    continue
                if now - t0 > self.timeout_s:
                    expired.append((t0, desc, w))
                else:
                    alive.append((t0, desc, w))
            self._work = alive
        for t0, desc, w in expired:
            self.tripped = desc
            # a raising dump/abort callback must not kill the scanner:
            # other in-flight works still need their timeouts observed
            # (and a double-abort dumps BOTH, to numbered files)
            try:
                path = ""
                if self.dump_on_timeout:
                    path = self.writer.write(
                        self.recorder, reason=f"watchdog timeout: {desc}"
                    )
                if self.on_timeout is not None:
                    self.on_timeout(desc, w, path)
            except Exception:
                logging.getLogger(__name__).exception(
                    "watchdog timeout handler failed for %r "
                    "(abort/dump did NOT complete)", desc
                )


class HeartbeatMonitor:
    """Aborts the process if the watchdog itself stops beating — torch
    HeartbeatMonitor (`ProcessGroupNCCL.hpp:596`). Killing is opt-in
    (`kill_process=True` ≈ TORCH_NCCL_HEARTBEAT_TIMEOUT_SEC behavior)."""

    def __init__(
        self,
        watchdog: Watchdog,
        heartbeat_timeout_s: float = 60.0,
        kill_process: bool = False,
        on_stuck: Optional[Callable] = None,
    ):
        self.watchdog = watchdog
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.kill_process = kill_process
        self.on_stuck = on_stuck
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stuck = False

    def start(self) -> "HeartbeatMonitor":
        """Idempotent while running; restartable after a stuck trip (the
        monitor thread returns once it fires — after the watchdog
        recovers, `start()` arms a fresh monitor and clears `stuck`)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self.stuck = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tdx-heartbeat"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
            if not t.is_alive():
                self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(min(self.heartbeat_timeout_s / 4, 5.0)):
            age = time.monotonic() - self.watchdog.last_heartbeat
            if age > self.heartbeat_timeout_s:
                self.stuck = True
                if self.on_stuck is not None:
                    self.on_stuck(age)
                if self.kill_process:
                    os._exit(1)
                return
