"""FakeBackend — no-communication backend for single-process testing.

Parity surface: torch `FakeProcessGroup.hpp` + registration in
`torch/testing/_internal/distributed/fake_pg.py:30-35` (the reference's
`backends/fake.py`): a backend that "hallucinates" communication — returns
immediately without communicating, numerically wrong by design — used to
exercise orchestration/tracing logic.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

from ..mesh import DeviceMesh
from ..types import CompletedWork, OpType, ReduceOp, Work
from .base import Backend


class FakeBackend(Backend):
    name = "fake"

    def __init__(self, mesh: DeviceMesh, rank: int, world_size: int, timeout: float = 1800.0):
        super().__init__(mesh, rank, world_size, timeout)

    def _identity(self, x, op_type: OpType) -> Tuple[Any, Work]:
        return x, CompletedWork(x, op_type)

    def allreduce(self, x, op: Any = ReduceOp.SUM):
        return self._identity(x, OpType.ALLREDUCE)

    def broadcast(self, x, src: int):
        return self._identity(x, OpType.BROADCAST)

    def reduce(self, x, dst: int, op: Any = ReduceOp.SUM):
        return self._identity(x, OpType.REDUCE)

    def allgather(self, x):
        # shape-correct hallucination: tile own value W times
        out = x.unsqueeze(1).expand((x.shape[0], self.world_size) + tuple(x.shape[1:]))
        return out, CompletedWork(out, OpType.ALLGATHER)

    def gather(self, x, dst: int):
        return self.allgather(x)

    def scatter(self, x, src: int):
        out = x[:, 0] if x.ndim >= 2 else x
        return out, CompletedWork(out, OpType.SCATTER)

    def reduce_scatter(self, x, op: Any = ReduceOp.SUM):
        out = x[:, 0] if x.ndim >= 2 else x
        return out, CompletedWork(out, OpType.REDUCE_SCATTER)

    def alltoall(self, x):
        return self._identity(x, OpType.ALLTOALL)

    def permute(self, x, perm: Sequence[Tuple[int, int]]):
        return self._identity(x, OpType.SEND)

    def barrier(self) -> Work:
        return CompletedWork(None, OpType.BARRIER)
