"""FlightRecorder — ring buffer of recent collectives, dumped on fault.

Parity surface: torch c10d `FlightRecorder.hpp:24-70` (SURVEY.md §2.2 N15):
a bounded ring of per-collective entries (seq, op, sizes, dtypes, state,
stack), a versioned dump schema, and a pluggable `DebugInfoWriter` invoked
on watchdog trips (`TORCH_NCCL_DUMP_ON_TIMEOUT`). Dump format here is JSON
(schema version "tdx-1.0") rather than pickle.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = "tdx-1.0"
DEFAULT_CAPACITY = 2048


@dataclass
class Entry:
    seq: int
    op: str
    group: str
    shape: tuple
    dtype: str
    numel: int
    state: str  # "enqueued" | "completed" | "failed"
    time_created: float
    time_completed: Optional[float] = None
    stack: List[str] = field(default_factory=list)


class FlightRecorder:
    """Ring buffer of collective records.

    Backed by the native C++ ring (csrc/flight_recorder.cpp — the direct
    N15 equivalent) when the native library builds; otherwise a thread-safe
    pure-Python deque. Stack capture (`record_stacks`) forces the Python
    backend (stacks are a Python-side artifact).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, record_stacks: bool = False):
        self.capacity = capacity
        self.record_stacks = record_stacks
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._by_seq: Dict[tuple, Entry] = {}
        self._native = None
        if not record_stacks and os.environ.get("TDX_FR_NATIVE", "1") == "1":
            try:
                from .. import _native

                if _native.available():
                    self._native = _native.NativeFlightRecorder(capacity)
            except Exception:
                self._native = None

    @property
    def native(self) -> bool:
        return self._native is not None

    def record(self, seq: int, op: str, group: str, shape, dtype, numel: int) -> Optional[Entry]:
        if self._native is not None:
            self._native.record(
                seq, op, group, tuple(int(s) for s in shape), dtype, numel, time.time()
            )
            return None
        stack: List[str] = []
        if self.record_stacks:
            stack = [
                f"{f.filename}:{f.lineno}:{f.name}"
                for f in traceback.extract_stack(limit=12)[:-2]
            ]
        e = Entry(
            seq=seq,
            op=op,
            group=group,
            shape=tuple(int(s) for s in shape),
            dtype=str(dtype),
            numel=int(numel),
            state="enqueued",
            time_created=time.time(),
            stack=stack,
        )
        with self._lock:
            self._buf.append(e)
            self._by_seq[(group, seq)] = e
            # keep the index bounded alongside the ring
            if len(self._by_seq) > self.capacity * 2:
                live = {(x.group, x.seq) for x in self._buf}
                self._by_seq = {k: v for k, v in self._by_seq.items() if k in live}
        return e

    def complete(self, seq: int, group: str, failed: bool = False) -> None:
        if self._native is not None:
            self._native.complete(seq, group, failed, time.time())
            return
        with self._lock:
            e = self._by_seq.get((group, seq))
            if e is not None:
                e.state = "failed" if failed else "completed"
                e.time_completed = time.time()

    def entries(self) -> List[Entry]:
        if self._native is not None:
            import ast

            return [
                Entry(
                    seq=d["seq"],
                    op=d["op"],
                    group=d["group"],
                    shape=ast.literal_eval(d["shape"]) if isinstance(d["shape"], str) else d["shape"],
                    dtype=d["dtype"],
                    numel=d["numel"],
                    state=d["state"],
                    time_created=d["time_created"],
                    time_completed=d.get("time_completed"),
                )
                for d in self._native.dump_entries()
            ]
        with self._lock:
            return list(self._buf)

    def dump(self) -> Dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "backend": "native" if self._native is not None else "python",
            "entries": [asdict(e) for e in self.entries()],
        }

    def dump_json(self) -> str:
        return json.dumps(self.dump())


class DebugInfoWriter:
    """Pluggable dump sink — torch `DebugInfoWriter` (FlightRecorder.hpp:70).
    Default writes `tdx_flight_<pid>.json` into TDX_DEBUG_DIR or cwd."""

    # process-global dump sequence: every writer instance shares it, so
    # two Watchdogs (world + a subgroup) tripping in one process cannot
    # both claim the unnumbered first-dump name
    _dump_seq = itertools.count()

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.environ.get("TDX_DEBUG_DIR", ".")

    def write(self, recorder: FlightRecorder, reason: str = "") -> str:
        """First dump in the PROCESS keeps the stable
        `tdx_flight_<pid>.json` name (tooling contract); later dumps
        from any writer (double abort, repeated watchdog trips, multiple
        groups) get a numbered suffix instead of silently overwriting
        the first one's evidence."""
        os.makedirs(self.directory, exist_ok=True)
        n = next(DebugInfoWriter._dump_seq)
        name = (
            f"tdx_flight_{os.getpid()}.json"
            if n == 0
            else f"tdx_flight_{os.getpid()}_{n}.json"
        )
        path = os.path.join(self.directory, name)
        payload = recorder.dump()
        payload["reason"] = reason
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


_global: Optional[FlightRecorder] = None


def global_recorder() -> FlightRecorder:
    global _global
    if _global is None:
        _global = FlightRecorder(
            capacity=int(os.environ.get("TDX_FR_CAPACITY", DEFAULT_CAPACITY)),
            record_stacks=os.environ.get("TDX_FR_STACKS", "0") == "1",
        )
    return _global
