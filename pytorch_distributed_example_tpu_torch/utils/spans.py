"""Device time by model region: the port's span recorder.

The training path marks its parts. `region(name, fn, *tensors)` wraps one
piece of the model (`models/transformer.py`: `embed`, `norm`, `cast`,
`gemm`, `rope`, `gqa_copy`, `attention`, `swiglu`, `loss`; `lm.loss_fn`
enters `loss` too) and `phase(name)` one part of a step (`examples/lm.py`
`train_step`: `step` around `forward`, `backward` and `optimizer`).

Off, the default, a region is `fn(*tensors)` after one flag check and a
phase does nothing: no event, no profiler range, no autograd node.

The recorder is on while a `torch.profiler` profile is active, or inside
`recording()`. Under a `torch.func` transform or `torch.compile`
(`traceguard.under_tracing`) a region or phase passes through unrecorded.
While on:

- under a profile, a region's forward and every phase run inside
  `record_function("tdx.<name>")`, so the trace shows them, on the same
  clock as the kernels;
- identity autograd functions mark a region's inputs that carry a gradient,
  and its outputs. In the backward, the outputs' mark opens the region's
  backward bracket (under a profile, a `tdx.<name>.backward` range) and the
  inputs' mark closes it. The autograd engine runs ready nodes by
  descending sequence number, so a region's backward runs as one unbroken
  bracket, in the reverse of the forward's order. A region whose inputs
  carry no gradient records its forward only;
- each boundary (a span opening or closing, in either direction) records a
  CUDA event on the current stream, or reads the host clock on the CPU,
  whose ops are synchronous. The stream time between two boundaries is
  charged to the innermost span open on that stream. One stack of open
  spans a stream is shared by the calling thread and the autograd engine's
  device thread, so the leaf regions and each phase's own remainder
  (residual adds, RoPE's tables) partition the step. Under activation
  checkpointing the recompute is charged to the regions it re-runs.

`summary()` gives the totals since the last `reset()`:

    {"steps": n, "spans": {"tdx.<name>": {"calls", "forward_ms",
                                          "backward_ms", "inclusive_ms"}}}

`calls` counts forward entries; `forward_ms` and `backward_ms` are the
span's own stream time (nested spans left out) in its forward and in its
backward bracket; `inclusive_ms` is all the time it was open, nested spans
in. A phase has no backward bracket: its own time is its `forward_ms`, its
length its `inclusive_ms`. `steps` counts the `step` phases completed while
on. Totals are kept by name, not by call; events are folded in as they
complete, at each step's close, and all of them (after a synchronise) in
`summary()`.

Device time a step by region, for a run of steps:

    spans.reset()
    with spans.recording():
        for _ in range(n):
            lm.train_step(model, opt, next_tokens())
    s = spans.summary()
    ms = {k: (v["forward_ms"] + v["backward_ms"]) / s["steps"]
          for k, v in s["spans"].items()}
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

from ..traceguard import under_tracing

FORWARD, BACKWARD = "forward", "backward"


class _HostMark:
    """A boundary on the CPU, where ops run synchronously: the host clock,
    with a CUDA event's interface."""

    __slots__ = ("t",)

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class _Open:
    """One opening of a span: its name, its direction, and the names open
    while it is (its own and its parents', each once)."""

    __slots__ = ("name", "direction", "names")

    def __init__(self, name: str, direction: str, parent):
        self.name, self.direction = name, direction
        up = () if parent is None else parent.names
        self.names = up if name in up else up + (name,)


def _totals(totals: dict, name: str) -> list:
    """[calls, forward_ms, backward_ms, inclusive_ms] of `name`."""
    t = totals.get(name)
    if t is None:
        t = totals[name] = [0, 0.0, 0.0, 0.0]
    return t


class _Stream:
    """A stream's open spans (innermost last) and its boundaries not yet
    folded: (mark, the innermost span open before the boundary, or None).
    The first boundary is the last one folded, where the next stretch
    starts."""

    def __init__(self, stream):
        self.stream = stream  # None on the CPU
        self.stack: list = []
        self.marks: list = []
        self.free: list = []  # folded events, to record again

    def boundary(self) -> None:
        if self.free:
            m = self.free.pop()
        else:
            m = _HostMark() if self.stream is None else torch.cuda.Event(enable_timing=True)
        m.record(self.stream)
        self.marks.append((m, self.stack[-1] if self.stack else None))

    def fold(self, totals: dict) -> None:
        """Charge every stretch whose closing boundary has completed."""
        marks, i = self.marks, 1
        while i < len(marks) and marks[i][0].query():
            inner = marks[i][1]
            if inner is not None:
                ms = marks[i - 1][0].elapsed_time(marks[i][0])
                _totals(totals, inner.name)[1 if inner.direction == FORWARD else 2] += ms
                for name in inner.names:
                    _totals(totals, name)[3] += ms
            i += 1
        if i > 1:
            self.free.extend(m for m, _ in marks[:i - 1])
            del marks[:i - 1]


class _Recorder:
    def __init__(self):
        self.depth = 0  # recording() contexts entered
        self.lock = threading.Lock()
        self.streams: dict = {}
        self.totals: dict = {}  # name -> [calls, forward_ms, backward_ms, inclusive_ms]
        self.steps = 0

    def stream(self, device: torch.device) -> _Stream:
        key = None
        if device.type == "cuda":  # (stream id, device index, device type)
            key = torch._C._cuda_getCurrentStream(
                torch.cuda.current_device() if device.index is None else device.index)
        st = self.streams.get(key)
        if st is None:
            st = self.streams[key] = _Stream(None if key is None else torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2]))
        return st

    def open(self, device, name: str, direction: str) -> _Open:
        with self.lock:
            st = self.stream(device)
            entry = _Open(name, direction, st.stack[-1] if st.stack else None)
            t = _totals(self.totals, name)
            if direction == FORWARD:
                t[0] += 1
            st.boundary()
            st.stack.append(entry)
        return entry

    def close(self, device, entry: _Open) -> None:
        """Close `entry` and any span left open inside it."""
        with self.lock:
            st = self.stream(device)
            st.boundary()
            for i in range(len(st.stack) - 1, -1, -1):
                if st.stack[i] is entry:
                    del st.stack[i:]
                    break

    def fold(self, synchronize: bool) -> None:
        with self.lock:
            for st in self.streams.values():
                if synchronize and st.stream is not None:
                    st.stream.synchronize()
                st.fold(self.totals)


_REC = _Recorder()


def enabled() -> bool:
    """Whether regions and phases record: inside `recording()`, or while a
    `torch.profiler` profile is active."""
    return bool(_REC.depth or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record regions and phases inside this block, profiler or not."""
    with _REC.lock:
        _REC.depth += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.depth -= 1


class _Bracket:
    """A region's backward: opened by its outputs' mark, closed by its
    inputs'."""

    __slots__ = ("name", "device", "entry", "handle")

    def __init__(self, name: str, device):
        self.name, self.device, self.handle = name, device, None

    def open(self) -> None:
        if _profiler._is_profiler_enabled:
            self.handle = torch.ops.profiler._record_function_enter_new(
                f"tdx.{self.name}.backward", None)
        self.entry = _REC.open(self.device, self.name, BACKWARD)

    def close(self) -> None:
        _REC.close(self.device, self.entry)
        if self.handle is not None:
            with torch._C.DisableTorchFunctionSubclass():
                torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
            self.handle = None


class _Mark(torch.autograd.Function):
    """The identity on `tensors`; its backward passes the gradients on."""

    @staticmethod
    def forward(ctx, bracket, *tensors):
        ctx.bracket = bracket
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)


class _InMark(_Mark):
    @staticmethod
    def backward(ctx, *grads):
        ctx.bracket.close()
        return (None, *grads)


class _OutMark(_Mark):
    @staticmethod
    def backward(ctx, *grads):
        ctx.bracket.open()
        return (None, *grads)


def _mark(fn, bracket, values):
    """`values` (a tensor or a tuple) with the tensors that carry a gradient
    passed through `fn`'s identity."""
    one = isinstance(values, torch.Tensor)
    vals = (values,) if one else tuple(values)
    idx = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor) and v.requires_grad]
    if not idx:
        return values
    out = list(vals)
    for i, m in zip(idx, fn.apply(bracket, *(vals[i] for i in idx))):
        out[i] = m
    return out[0] if one else tuple(out)


def _ranged(name: str):
    """A `tdx.<name>` profiler range while a profile is active (only a
    profiler reads one)."""
    if _profiler._is_profiler_enabled:
        return record_function(f"tdx.{name}")
    return contextlib.nullcontext()


def region(name: str, fn, *tensors):
    """`fn(*tensors)`, recorded as the region `name` while the recorder is
    on. Pass every tensor `fn` reads that carries a gradient (weights too):
    the backward bracket closes when the gradients of these have been
    formed."""
    if not (_REC.depth or _profiler._is_profiler_enabled) or under_tracing():
        return fn(*tensors)
    device = tensors[0].device
    bracket = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        bracket = _Bracket(name, device)
        tensors = _mark(_InMark, bracket, tensors)
    with _ranged(name):
        entry = _REC.open(device, name, FORWARD)
        try:
            out = fn(*tensors)
        finally:
            _REC.close(device, entry)
    return out if bracket is None else _mark(_OutMark, bracket, out)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Record the block as the phase `name` on `device`'s current stream
    (default: the current CUDA device once CUDA is initialised, else the
    CPU). Closing a `step` phase counts a step and folds the events that
    have completed."""
    if not (_REC.depth or _profiler._is_profiler_enabled) or under_tracing():
        yield
        return
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_initialized() else torch.device("cpu"))
    device = torch.device(device)
    with _ranged(name):
        entry = _REC.open(device, name, FORWARD)
        try:
            yield
        finally:
            _REC.close(device, entry)
    if name == "step":
        with _REC.lock:
            _REC.steps += 1
        _REC.fold(synchronize=False)


def summary() -> dict:
    """The totals since the last `reset()`, every event folded in (this
    synchronises the streams recorded on)."""
    _REC.fold(synchronize=True)
    with _REC.lock:
        return {"steps": _REC.steps, "spans": {
            f"tdx.{name}": {"calls": c, "forward_ms": f, "backward_ms": b, "inclusive_ms": i}
            for name, (c, f, b, i) in _REC.totals.items()}}


def reset() -> None:
    """Drop the totals, the step count and the boundaries not yet folded;
    spans open now stay open."""
    with _REC.lock:
        _REC.totals.clear()
        _REC.steps = 0
        for st in _REC.streams.values():
            st.marks.clear()
