"""Observability: per-group collective status.

Parity surface (the reference's `utils/logger.py`): `ProcessGroupStatus` ≈
torch `ProcessGroupStatus` (`logger.hpp:12-40`), the last enqueued,
started and completed collective of a group. The reference's `DDPLogger`
comes with the port's DDP; its `exception_logger` / `time_logger`
decorators have no caller there and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict


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
