"""Observability: per-group collective status and DDP logging data.

Parity surface (the reference's `utils/logger.py`):
  - `ProcessGroupStatus` ≈ torch `ProcessGroupStatus` (`logger.hpp:12-40`):
    the last enqueued, started and completed collective of a group.
  - `DDPLogger` ≈ torch's DDP `Logger` + `DDPLoggingData` (`logger.hpp:42-90`;
    `_get_ddp_logging_data`, `nn/parallel/distributed.py:2552`):
    construction-time facts (world size, bucket layout) and per-step wall
    times.
The reference's `exception_logger` / `time_logger` decorators have no
caller there and are not ported, nor are the component times its
`profile_breakdown` fills (ROADMAP).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class ProcessGroupStatus:
    """Last-collective bookkeeping — torch logger.hpp:12-40."""

    last_enqueued_seq: int = -1
    last_enqueued_op: str = ""
    last_enqueued_numel: int = 0
    last_started_seq: int = -1
    last_started_op: str = ""
    last_completed_seq: int = -1
    last_completed_op: str = ""
    last_completed_numel: int = 0

    def record_enqueue(self, seq: int, op: str, numel: int) -> None:
        self.last_enqueued_seq = seq
        self.last_enqueued_op = op
        self.last_enqueued_numel = numel
        # a collective's kernels start as soon as they are enqueued on the
        # device's stream: enqueue == start
        self.last_started_seq = seq
        self.last_started_op = op

    def record_complete(self, seq: int, op: str, numel: int) -> None:
        self.last_completed_seq = seq
        self.last_completed_op = op
        self.last_completed_numel = numel

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class DDPLogger:
    """Runtime stats for a DDP instance — torch Logger/DDPLoggingData.

    With `enable_step_timing()` the train step records its wall time: it
    synchronizes the card after each step, trading the host running ahead
    for true step times, which is what a profiling run wants."""

    def __init__(self, ddp) -> None:
        self._ddp = ddp
        self.step_times: list = []
        self._step_start: Optional[float] = None
        self.timing_enabled: bool = False

    def enable_step_timing(self, enabled: bool = True) -> None:
        self.timing_enabled = enabled

    def step_begin(self) -> None:
        self._step_start = time.perf_counter()

    def step_end(self) -> None:
        if self._step_start is not None:
            self.step_times.append(time.perf_counter() - self._step_start)
            self._step_start = None

    def profiler_trace(self, logdir: str):
        """A `torch.profiler` context writing a TensorBoard trace to
        `logdir`: the host's ops and, on a card, its kernels, collectives
        included — the reference's `jax.profiler.trace`."""
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))

    def get_ddp_logging_data(self) -> Dict[str, Any]:
        g = self._ddp.process_group
        red = self._ddp.reducer
        times = self.step_times[-100:]
        return {
            "world_size": g.size(),
            "rank": g.rank(),
            "backend_name": g.backend_name,
            "bucket_cap_bytes": int(red.bucket_cap_bytes),
            "first_bucket_bytes": int(red.first_bucket_bytes),
            "num_buckets": red.stats["num_buckets"],
            "bucket_sizes": list(red.stats["bucket_sizes"]),
            "rebuilds": red.stats["rebuilds"],
            "reduce_calls": red.stats["reduce_calls"],
            "avg_step_time_s": (sum(times) / len(times)) if times else 0.0,
            "num_steps": len(self.step_times),
            "find_unused_parameters": self._ddp.find_unused_parameters,
        }
