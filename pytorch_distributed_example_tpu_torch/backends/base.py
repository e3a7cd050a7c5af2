"""Abstract communication backend.

Parity surface: torch c10d `Backend.hpp:34-577` (the reference's
`backends/base.py`) — the abstract transport class each concrete backend
subclasses: the collective set (`Backend.hpp:158-404`), capability probes
(`supportsSplitting` `:91`, `supportsCoalescing` `:95`), lifecycle
(`abort`/`shutdown` `:525-529`) and error query (`getError` `:495`).

A backend here operates on the tensor of a `DistTensor`: in driver mode the
whole rank-stacked `(world, *t)` tensor, in multiproc mode this process's
`(1, *t)` row.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from ..mesh import DeviceMesh
from ..types import DistBackendError, ReduceOp, Work


class BackendError(DistBackendError):
    pass


class Backend:
    """Abstract backend over a 1-D group mesh."""

    name = "undefined"

    def __init__(self, mesh: DeviceMesh, rank: int, world_size: int, timeout: float):
        self.mesh = mesh
        self.rank = rank
        self.world_size = world_size
        self.timeout = timeout
        self._error: Optional[BaseException] = None
        self._sequence_number = 0
        self._shut_down = False

    # -- capability probes (Backend.hpp:91-101) ----------------------------
    def supports_splitting(self) -> bool:
        return True

    def supports_coalescing(self) -> bool:
        return False

    def supports_time_estimation(self) -> bool:
        return False

    # -- sequence numbers (c10d sequence_num.hpp) --------------------------
    def next_sequence_number(self) -> int:
        self._sequence_number += 1
        return self._sequence_number

    def get_sequence_number_for_group(self) -> int:
        return self._sequence_number

    # -- lifecycle (Backend.hpp:525-529) -----------------------------------
    def abort(self) -> None:
        self._shut_down = True

    def shutdown(self) -> None:
        self._shut_down = True

    def get_error(self) -> Optional[BaseException]:
        return self._error

    # -- collectives (DistTensor tensors in, (tensor, Work) out) -----------
    def allreduce(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        raise NotImplementedError

    def broadcast(self, x, src: int) -> Tuple[Any, Work]:
        raise NotImplementedError

    def reduce(self, x, dst: int, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        raise NotImplementedError

    def allgather(self, x) -> Tuple[Any, Work]:
        raise NotImplementedError

    def gather(self, x, dst: int) -> Tuple[Any, Work]:
        raise NotImplementedError

    def scatter(self, x, src: int) -> Tuple[Any, Work]:
        raise NotImplementedError

    def reduce_scatter(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        raise NotImplementedError

    def alltoall(self, x) -> Tuple[Any, Work]:
        raise NotImplementedError

    def permute(self, x, perm: Sequence[Tuple[int, int]]) -> Tuple[Any, Work]:
        """ppermute: list of (src, dst) pairs; non-receiving ranks keep input."""
        raise NotImplementedError

    def barrier(self) -> Work:
        raise NotImplementedError
