"""What the metrics' readers read: the window's host clocks, the card's
allocator peak and the profiler's trace of the profiled steps.

The trace is `torch.profiler`'s Chrome trace (CPU and CUDA activity). The
profiled steps sit inside one `perfbench.profiled` annotation that opens
after a synchronise and closes after another, so its span holds all of
their device work. Device operations are the kernels, copies and sets in
that span.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

MARKER = "perfbench.profiled"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Window:
    """The window's unprofiled steps, timed by the host clock."""

    steps: int
    wall_s: float
    host_step_s: list  # host time of each `train_step` call
    tokens_per_step: int


@dataclass
class Profile:
    """The profiled steps: device operations (name, start µs, length µs)
    and host operations in the span [t0, t1] µs."""

    steps: int
    t0: float
    t1: float
    device_ops: list
    host_ops: list = field(default_factory=list)

    @property
    def span_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_ms(self, keep) -> float:
        """Summed length of the device operations whose name `keep` accepts."""
        return sum(dur for name, _, dur in self.device_ops if keep(name)) * 1e-3

    def busy_intervals(self) -> list:
        """The union of device operations, as merged (start, end) µs."""
        merged = []
        for _, ts, dur in sorted(self.device_ops, key=lambda op: op[1]):
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """(start, end) µs of each stretch of the span with nothing on the device."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at `t` µs."""
        best = None
        for name, ts, dur in self.host_ops:
            if ts <= t < ts + dur and name != MARKER and (best is None or ts > best[1]):
                best = (name, ts)
        return best[0] if best else "no host operation"


@dataclass
class Run:
    """What a reader gets. `profile` is None in an untraced run;
    `kernel_bound_ms` maps a kernel's role to its bound a call; `setup_s` is
    the process's age when the window opened; `peak_bytes` the card's
    allocator peak over the window."""

    window: Window
    profile: Profile | None
    step_flops: float
    peak_flops: float | None
    kernel_bound_ms: dict | None
    setup_s: float | None = None
    peak_bytes: int | None = None


def load_profile(path: str, steps: int) -> Profile:
    """The profiled steps from a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return profile_from_events(events, steps)


def profile_from_events(events: list, steps: int) -> Profile:
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == MARKER and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"the trace holds {len(spans)} '{MARKER}' spans, not one")
    t0, t1 = spans[0]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = (e["name"], float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATS and t0 <= op[1] < t1:
            dev.append(op)
        elif e.get("cat") in HOST_CATS and op[1] < t1 and op[1] + op[2] > t0:
            host.append(op)
    return Profile(steps=steps, t0=float(t0), t1=float(t1), device_ops=dev, host_ops=host)


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each named by the host operation running at its
    start, in seconds."""
    by_name: dict = {}
    for name, _, dur in p.device_ops:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(p.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:160], s] for name, s in ops],
        "idle_gaps": [[p.host_op_at(a), (b - a) * 1e-6] for a, b in gaps],
    }
